"""ArchConfig: one declarative description drives model build, smoke
tests and serving for every assigned architecture.

Counterpart of ``repro/configs/base.py``: the same fields, defaults,
construction-time validation (``ArchConfigError``, with the same
messages), sub-config builders, ``reduce`` and ``SHAPES``.
``param_dtype`` is a torch dtype.  The execution fields the reference's
JAX lowering reads (``scan_layers``, ``remat``, ``fsdp``) are kept so
the registry's configs are the reference's field for field; the port
reads ``scan_layers`` only through the params' layout (stacked
``"units"`` against per-layer ``"extra"``), and ``remat`` as the
reference does: each stacked unit and encoder layer of a train step is
checkpointed (``models/transformer.forward``, ``encode``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.models.attention import AttnConfig
from repro_torch.models.ffn import FFNConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.rglru import RGLRUConfig
from repro_torch.models.xlstm import XLSTMConfig


class ArchConfigError(ValueError):
    """Invalid ArchConfig field combination, raised at CONSTRUCTION time.

    Bad per-layer ``ffn_kinds`` used to surface as a shape-mismatch crash
    deep inside ``models/transformer.block_init``; validating here turns
    that into a named, actionable error at registry/config build."""


FFN_LAYER_KINDS = ("kan", "mlp", "moe")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention
    qkv_bias: bool = False
    rope_base: float = 10000.0
    window: Optional[int] = None       # sliding window for 'attn' blocks
    logit_softcap: Optional[float] = None
    qk_norm: bool = False
    # norms / ffn / embedding
    norm: str = "rms"                  # rms | ln
    norm_offset: float = 0.0           # gemma-style (1 + scale)
    ffn_kind: str = "swiglu"           # swiglu | geglu | mlp | kan
    act: str = "gelu"                  # for ffn_kind == mlp
    ffn_bias: bool = False
    tied_embeddings: bool = True
    embed_scale: bool = False          # gemma multiplies by sqrt(d)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # layer pattern for hybrid stacks; None => all-attention
    block_pattern: Optional[Tuple[str, ...]] = None  # attn|rec|mlstm|slstm
    # modality frontends (STUBS: input_specs provides embeddings)
    frontend: Optional[str] = None     # None | audio | vision
    n_frontend_tokens: int = 0         # 1500 whisper frames / 256 patches
    enc_dec: bool = False
    n_enc_layers: int = 0
    prefix_lm: bool = False            # bidirectional prefix (paligemma)
    # the paper's technique (VIKIN) knobs
    pattern_rate: float = 0.0          # stage-2 m-of-4 sparsity
    kan_grid: int = 4
    kan_order: int = 3
    kan_hidden: Optional[int] = None
    # per-layer FFN kinds for KAN-FFN hybrids (DESIGN.md Sec. 17):
    # "kan" routes that layer's FFN through the fused KAN kernel +
    # pattern-matmul, "mlp" keeps the config's ffn_kind, "moe" passes
    # through to the MoE block.  None = homogeneous stack (status quo).
    ffn_kinds: Optional[Tuple[str, ...]] = None
    ffn_impl: str = "auto"             # kernel dispatch for kan-ffn layers
    # per-layer calibrated masks for "kan" entries: None | a
    # (basis_keep tuple | None, hidden_keep tuple | None) pair per layer
    ffn_masks: Optional[Tuple] = None
    # execution
    scan_layers: bool = True
    remat: bool = True
    fsdp: bool = False          # ZeRO-3-style param sharding over 'data'
    kv_quant: bool = False      # int8 KV cache (beyond-paper, decode)
    dtype: str = "bfloat16"
    loss_chunks: int = 4               # unrolled CE chunks (no (B,S,V) blob)
    # extra cache slots beyond seq_len; 16 keeps cache seq lengths divisible
    # by the model-axis size so KV caches stay sequence-shardable
    decode_margin: int = 16

    # ------------------------------------------------------------ validate
    def __post_init__(self):
        if self.ffn_kinds is None:
            if self.ffn_masks is not None:
                raise ArchConfigError(
                    f"{self.name}: ffn_masks requires ffn_kinds")
            return
        if len(self.ffn_kinds) != self.n_layers:
            raise ArchConfigError(
                f"{self.name}: ffn_kinds has {len(self.ffn_kinds)} entries "
                f"for n_layers={self.n_layers}")
        bad = [k for k in self.ffn_kinds if k not in FFN_LAYER_KINDS]
        if bad:
            raise ArchConfigError(
                f"{self.name}: unknown ffn_kinds entries {bad!r} "
                f"(must be one of {FFN_LAYER_KINDS})")
        if "moe" in self.ffn_kinds and not self.is_moe:
            raise ArchConfigError(
                f"{self.name}: ffn_kinds uses 'moe' but n_experts == 0")
        if "kan" in self.ffn_kinds and self.d_ff <= 0:
            raise ArchConfigError(
                f"{self.name}: ffn_kinds uses 'kan' but d_ff == 0")
        if self.scan_layers:
            # per-layer FFN shapes cannot be stacked into scan units
            raise ArchConfigError(
                f"{self.name}: ffn_kinds requires scan_layers=False "
                "(per-layer param trees are not stackable)")
        if self.ffn_masks is not None:
            if len(self.ffn_masks) != self.n_layers:
                raise ArchConfigError(
                    f"{self.name}: ffn_masks has {len(self.ffn_masks)} "
                    f"entries for n_layers={self.n_layers}")
            for i, (m, k) in enumerate(zip(self.ffn_masks, self.ffn_kinds)):
                if m is None:
                    continue
                if k != "kan":
                    raise ArchConfigError(
                        f"{self.name}: ffn_masks[{i}] set on a {k!r} layer")
                if len(m) != 2:
                    raise ArchConfigError(
                        f"{self.name}: ffn_masks[{i}] must be a "
                        "(basis_keep, hidden_keep) pair")

    # ---------------------------------------------------------------- props
    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern or ("attn",)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k? (constant/windowed per-token state)"""
        kinds = set(self.pattern)
        quadratic_attn = "attn" in kinds and self.window is None
        return not quadratic_attn

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            qkv_bias=self.qkv_bias, rope_base=self.rope_base,
            window=self.window, logit_softcap=self.logit_softcap,
            qk_norm=self.qk_norm, causal=True, kv_quant=self.kv_quant)

    def enc_attn_cfg(self) -> AttnConfig:
        return dataclasses.replace(self.attn_cfg(), causal=False,
                                   window=None)

    def layer_ffn_kind(self, layer: int) -> str:
        """Per-layer FFN routing: "kan" | "mlp" | "moe" | "none"."""
        if self.ffn_kinds is not None:
            return self.ffn_kinds[layer]
        if self.is_moe:
            return "moe"
        return "mlp" if self.d_ff > 0 else "none"

    def ffn_cfg(self, layer: int = 0) -> FFNConfig:
        if self.layer_ffn_kind(layer) == "kan":
            bk, hk = (None, None)
            if self.ffn_masks is not None and self.ffn_masks[layer]:
                bk, hk = self.ffn_masks[layer]
            return FFNConfig(
                d_model=self.d_model, d_ff=self.d_ff, kind="kanffn",
                act=self.act, bias=self.ffn_bias,
                pattern_rate=self.pattern_rate, kan_grid=self.kan_grid,
                kan_order=self.kan_order, kan_hidden=self.kan_hidden,
                kan_impl=self.ffn_impl,
                basis_keep=None if bk is None else tuple(bk),
                hidden_keep=None if hk is None else tuple(hk))
        return FFNConfig(
            d_model=self.d_model, d_ff=self.d_ff, kind=self.ffn_kind,
            act=self.act, bias=self.ffn_bias,
            pattern_rate=self.pattern_rate, kan_grid=self.kan_grid,
            kan_order=self.kan_order, kan_hidden=self.kan_hidden)

    def moe_cfg(self) -> MoEConfig:
        # ffn_kind="kan" turns every expert into a KAN stack -- the paper's
        # technique inside MoE experts (DESIGN.md Sec. 5)
        return MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            top_k=self.top_k, capacity_factor=self.capacity_factor,
            shared_expert=self.shared_expert,
            ffn_kind="kan" if self.ffn_kind == "kan" else "swiglu",
            kan_grid=self.kan_grid, kan_order=self.kan_order)

    def xlstm_cfg(self) -> XLSTMConfig:
        return XLSTMConfig(d_model=self.d_model, n_heads=self.n_heads)

    def rglru_cfg(self) -> RGLRUConfig:
        return RGLRUConfig(d_model=self.d_model)

    # ------------------------------------------------------------- reduce
    def reduce(self, **over) -> "ArchConfig":
        """Smoke-test-sized variant of the same family (CPU-runnable)."""
        pattern = self.pattern
        n_layers = max(len(pattern), 2)
        if self.block_pattern is not None:
            n_layers = len(pattern)  # one pattern unit
        defaults = dict(
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16 if self.head_dim else None,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=min(self.window, 32) if self.window else None,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
            n_enc_layers=2 if self.enc_dec else 0,
            dtype="float32",
            remat=False,
            loss_chunks=1,
        )
        defaults.update(over)
        if self.ffn_kinds is not None:
            nl = defaults.get("n_layers", self.n_layers)
            if "ffn_kinds" not in defaults:
                kinds = tuple((self.ffn_kinds * nl)[:nl])
                if "kan" in self.ffn_kinds and "kan" not in kinds:
                    kinds = kinds[:-1] + ("kan",)
                defaults["ffn_kinds"] = kinds
            # calibrated masks are width-specific; a reduced arch is dense
            defaults.setdefault("ffn_masks", None)
        return dataclasses.replace(self, **defaults)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (all 10 archs share these).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
