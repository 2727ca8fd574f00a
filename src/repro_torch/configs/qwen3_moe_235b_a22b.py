"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (kv=4) d_ff=1536/expert,
vocab=151936, MoE 128 experts top-8 (hf:Qwen/Qwen3-* lineage).

qwen3 specifics: head_dim=128 (explicit), per-head q/k RMS-norm, no qkv
bias, untied embeddings.  KAN-FFN applies inside experts (DESIGN.md Sec. 5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    qk_norm=True,
    rope_base=1e6,
    tied_embeddings=False,
    fsdp=True,
)
