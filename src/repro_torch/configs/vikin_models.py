"""The paper's own benchmark models (Table I) as configs and ``--arch
vikin-*`` ids.

Counterpart of ``repro/configs/vikin_models.py``.  Four models on the
Traffic 72h->96h forecasting task -- MLP-4 [72,304,304,96], MLP-3
[72,304,96], KAN-3 [72,32,96], KAN-2 [72,96] (``PAPER_MODELS``, which
``benchmarks/table1_models.py`` trains) -- plus a mixed KAN/MLP stack and
a CI-sized smoke model.  ``kinds`` gives a per-layer KAN/MLP assignment,
so one workload can exercise the host's mode-switch schedule
(core/modes.ModePlan).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.engine import LayerWork
from repro_torch.core.modes import LayerKind
from repro_torch.core.splines import SplineSpec


@dataclasses.dataclass(frozen=True)
class PaperModelConfig:
    name: str
    kind: str                      # "mlp" | "kan" | "mixed" (see ``kinds``)
    sizes: Tuple[int, ...]
    grid: int = 4
    order: int = 3
    pattern_rate: float = 0.0      # Table II deployment rates
    # per-layer kind override; required for kind == "mixed", else derived
    kinds: Optional[Tuple[str, ...]] = None

    def __post_init__(self) -> None:
        if self.kinds is not None and len(self.kinds) != self.n_layers:
            raise ValueError(
                f"{self.name}: kinds has {len(self.kinds)} entries for "
                f"{self.n_layers} layers")
        if self.kind == "mixed" and self.kinds is None:
            raise ValueError(f"{self.name}: kind='mixed' requires kinds")

    @property
    def spec(self) -> SplineSpec:
        return SplineSpec(self.grid, self.order)

    @property
    def n_layers(self) -> int:
        return len(self.sizes) - 1

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """One "kan"/"mlp" entry per layer."""
        if self.kinds is not None:
            return self.kinds
        return (self.kind,) * self.n_layers

    def layer_kind_enums(self) -> List[LayerKind]:
        return [LayerKind(k) for k in self.layer_kinds]

    def param_count(self) -> int:
        n = 0
        for kind, a, b in zip(self.layer_kinds, self.sizes, self.sizes[1:]):
            if kind == "mlp":
                n += a * b + b
            else:
                n += a * b * (1 + self.spec.n_bases)
        return n

    def layer_works(self, nnz_rates: Optional[Sequence[float]] = None,
                    pattern_rates: Optional[Sequence[float]] = None,
                    ) -> List[LayerWork]:
        """Per-layer LayerWork entries for the cycle model (core/engine).

        ``nnz_rates[i]`` is layer i's input-activation density (MLP
        zero-skip, default dense); ``pattern_rates[i]`` overrides the
        config-level stage-2 rate with a measured per-layer one.  Without
        an override the config rate applies to KAN layers and to hidden
        MLP inputs only -- the raw feature input is never masked.
        """
        nnz = list(nnz_rates) if nnz_rates is not None else [1.0] * self.n_layers
        out = []
        for i, (kind, a, b) in enumerate(
                zip(self.layer_kinds, self.sizes, self.sizes[1:])):
            if pattern_rates is not None:
                pr = float(pattern_rates[i])
            else:
                pr = self.pattern_rate if (kind == "kan" or i > 0) else 0.0
            if kind == "kan":
                out.append(LayerWork(LayerKind.KAN, a, b, spec=self.spec,
                                     pattern_rate=pr))
            else:
                out.append(LayerWork(LayerKind.MLP, a, b,
                                     in_nnz_rate=nnz[i], pattern_rate=pr))
        return out

    def reduce(self, **over: object) -> "PaperModelConfig":
        """The reference's ``ArchConfig.reduce()`` interface; the paper
        models are already small, so this only replaces fields."""
        return dataclasses.replace(self, **over)


MLP4 = PaperModelConfig("mlp-4layer", "mlp", (72, 304, 304, 96))
MLP3 = PaperModelConfig("mlp-3layer", "mlp", (72, 304, 96))
KAN3 = PaperModelConfig("kan-3layer", "kan", (72, 32, 96))
KAN2 = PaperModelConfig("kan-2layer", "kan", (72, 96))

PAPER_MODELS = {m.name: m for m in (MLP4, MLP3, KAN3, KAN2)}

# Table II deployment configuration
TABLE2_KAN = dataclasses.replace(KAN2, pattern_rate=0.5)
TABLE2_MLP = dataclasses.replace(MLP3, pattern_rate=0.25)

# Alternating MLP -> KAN -> MLP stack: two mode switches per inference.
MIXED = PaperModelConfig("vikin-mixed", "mixed", (72, 304, 32, 96),
                         kinds=("mlp", "kan", "mlp"), pattern_rate=0.5)

# CI-sized smoke workload: one switch, both kernel families, stage-2 mask.
SMALL = PaperModelConfig("vikin-small", "mixed", (16, 32, 8),
                         kinds=("mlp", "kan"), pattern_rate=0.5)

VIKIN_ARCHS: Dict[str, PaperModelConfig] = {
    "vikin-kan2": dataclasses.replace(TABLE2_KAN, name="vikin-kan2"),
    "vikin-kan3": dataclasses.replace(KAN3, name="vikin-kan3"),
    "vikin-mlp3": dataclasses.replace(TABLE2_MLP, name="vikin-mlp3"),
    "vikin-mlp4": dataclasses.replace(MLP4, name="vikin-mlp4"),
    "vikin-mixed": MIXED,
    "vikin-small": SMALL,
}
