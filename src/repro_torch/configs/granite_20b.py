"""granite-20b [dense]: 52L d=6144 48H (MQA kv=1) d_ff=24576 (4x gelu MLP),
vocab=49152, code model (arXiv:2405.04324; gpt_bigcode lineage).

LayerNorm + biased gelu-MLP per the bigcode arch; positions are RoPE here
(the original uses learned absolute -- adaptation noted in DESIGN.md).
The most MLP-dominated assigned arch -> the paper-representative KAN-FFN
hillclimb cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    norm="ln",
    ffn_kind="mlp",
    act="gelu",
    ffn_bias=True,
    qkv_bias=True,
    tied_embeddings=True,
    fsdp=True,
)
