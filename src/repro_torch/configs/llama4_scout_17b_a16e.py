"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (kv=8) d_ff=8192/expert,
vocab=202048, MoE 16 experts top-1 + shared expert (early fusion).

The vision early-fusion frontend is out of the assigned scope (LM shapes
only); routed + shared expert structure is the llama4 signature kept here.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    shared_expert=True,
    rope_base=500000.0,
    tied_embeddings=False,
    fsdp=True,
)
