"""Architecture registry: ``--arch <id>`` resolution for every launcher.

Counterpart of ``repro/configs/registry.py``: the same ``ARCHS``,
``KANFFN_ARCHS`` and lookups, with the same names and fields."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.configs import (
    granite_20b,
    llama4_scout_17b_a16e,
    mistral_nemo_12b,
    paligemma_3b,
    qwen1_5_0_5b,
    qwen2_0_5b,
    qwen3_moe_235b_a22b,
    recurrentgemma_9b,
    whisper_medium,
    xlstm_125m,
)

_MODULES = (
    xlstm_125m, qwen3_moe_235b_a22b, llama4_scout_17b_a16e,
    mistral_nemo_12b, qwen1_5_0_5b, qwen2_0_5b, granite_20b,
    paligemma_3b, whisper_medium, recurrentgemma_9b,
)

ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# KAN-FFN hybrids (DESIGN.md Sec. 17): zoo archs re-tiled with per-layer
# ``ffn_kinds`` so their FFNs route through the fused VIKIN kernels.  Kept
# OUT of ARCHS on purpose -- they are serving-path variants of existing zoo
# entries, not new dry-run grid cells (runnable_cells stays pinned).
# Validation happens at construction (ArchConfigError), so a typo'd kinds
# tuple fails HERE, not deep inside block_init.
KANFFN_ARCHS: Dict[str, ArchConfig] = {
    # qwen2-0.5b with every other FFN routed through the KAN kernels
    "qwen2-0.5b-kanffn": dataclasses.replace(
        qwen2_0_5b.CONFIG,
        name="qwen2-0.5b-kanffn",
        ffn_kinds=tuple("kan" if i % 2 == 0 else "mlp"
                        for i in range(qwen2_0_5b.CONFIG.n_layers)),
        scan_layers=False,
    ),
    # xlstm-125m-class CI variant: small enough to serve train-free in the
    # smoke lane, mixed kinds so the ModePlan has real flips to pin
    "kanffn-ci": ArchConfig(
        name="kanffn-ci", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        ffn_kinds=("mlp", "kan", "mlp"), scan_layers=False,
        dtype="float32", remat=False, loss_chunks=1,
    ),
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_serving_config(name: str) -> Tuple[str, object]:
    """Resolve a serving ``--arch``: ("vikin", PaperModelConfig) for the
    KAN/MLP feed-forward backend, ("transformer", ArchConfig) otherwise
    (kan-ffn hybrids resolve as transformers; the backend routes their
    FFN layers through the VIKIN kernels)."""
    if name in VIKIN_ARCHS:
        return "vikin", VIKIN_ARCHS[name]
    if name in KANFFN_ARCHS:
        return "transformer", KANFFN_ARCHS[name]
    if name in ARCHS:
        return "transformer", ARCHS[name]
    raise KeyError(
        f"unknown arch {name!r}; transformer archs: {sorted(ARCHS)}; "
        f"kan-ffn archs: {sorted(KANFFN_ARCHS)}; "
        f"vikin archs: {sorted(VIKIN_ARCHS)}")


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def runnable_cells(include_skipped: bool = False) -> List[tuple]:
    """All (arch, shape) cells; long_500k only for sub-quadratic archs
    (the documented skip, DESIGN.md Sec. 5)."""
    cells = []
    for aname, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            skipped = (sname == "long_500k" and not cfg.subquadratic)
            if skipped and not include_skipped:
                continue
            cells.append((aname, sname))
    return cells
