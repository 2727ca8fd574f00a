"""paligemma-3b [vlm]: 18L d=2048 8H (MQA kv=1) d_ff=16384, vocab=257216
(arXiv:2407.07726).  Gemma decoder (GeGLU, RMSNorm(1+scale), sqrt(d) embed
scaling) with a prefix-LM mask over 256 SigLIP patch tokens.  The SigLIP
frontend is a STUB per the assignment: input_specs provides precomputed
patch embeddings; a learnable linear adapter maps them in.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    ffn_kind="geglu",
    norm_offset=1.0,
    embed_scale=True,
    frontend="vision",
    n_frontend_tokens=256,
    prefix_lm=True,
    tied_embeddings=True,
)
