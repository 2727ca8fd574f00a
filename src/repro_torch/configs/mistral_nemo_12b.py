"""mistral-nemo-12b [dense]: 40L d=5120 32H (kv=8) d_ff=14336,
vocab=131072, 128k context (hf:mistralai/Mistral-Nemo-Base-2407).

head_dim=128 explicit (32*128=4096 != d_model -- nemo's signature).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_base=1e6,
    tied_embeddings=False,
    fsdp=True,
)
