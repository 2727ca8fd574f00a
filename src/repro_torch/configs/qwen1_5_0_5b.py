"""qwen1.5-0.5b [dense]: 24L d=1024 16H (kv=16, MHA) d_ff=2816,
vocab=151936, QKV bias (hf:Qwen/Qwen1.5-0.5B)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope_base=1e6,
    tied_embeddings=True,
)
