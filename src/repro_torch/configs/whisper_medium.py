"""whisper-medium [audio]: enc-dec, 24+24L d=1024 16H (MHA) d_ff=4096,
vocab=51865 (arXiv:2212.04356).  The conv audio frontend is a STUB per the
assignment: input_specs provides 1500 precomputed frame embeddings.
LayerNorm + biased gelu-MLP; RoPE replaces the original's
sinusoidal/learned positions (adaptation noted in DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm="ln",
    ffn_kind="mlp",
    act="gelu",
    ffn_bias=True,
    qkv_bias=True,
    enc_dec=True,
    n_enc_layers=24,
    frontend="audio",
    n_frontend_tokens=1500,
    tied_embeddings=True,
)
