"""xlstm-125m [ssm]: sLSTM + mLSTM blocks, no FFN (arXiv:2405.04517).

12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.  Blocks alternate
mLSTM/sLSTM 1:1 (ratio choice documented in DESIGN.md Sec. 5).  Constant
per-token state -> runs long_500k.  The paper's KAN-FFN technique is N/A
(no FFN to replace) -- documented inapplicability; pattern sparsity still
applies to projection matrices via pattern_rate if desired.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    tied_embeddings=True,
    ffn_kind="swiglu",          # unused: d_ff == 0
)
