"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (MQA kv=1) d_ff=12288,
vocab=256000 (arXiv:2402.19427).  RG-LRU recurrent blocks + 2048-window
local attention in a 2:1 pattern; GeGLU MLP everywhere; gemma norms.
Windowed attention + O(1) recurrent state -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    ffn_kind="geglu",
    norm_offset=1.0,
    embed_scale=True,
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    tied_embeddings=True,
    fsdp=True,
)
