"""Shared neural building blocks of the transformer models (functional,
params as nested dicts of tensors).

Counterpart of ``repro/models/layers.py``, in the reference's numerics:
norms run in f32 and cast back to x's dtype; ``dense`` multiplies the
widened operands in f32 (a product of two bf16 values is exact in f32),
adds the bias in f32 and rounds once to x's dtype, as the reference's
``preferred_element_type=f32`` dot; ``unembed`` returns f32 logits.
On the card these f32 products refuse TF32, as the port's plain
versions do.  ``gelu`` is the tanh form (``jax.nn.gelu`` defaults to
``approximate=True``).

Initialisers draw from an explicit ``torch.Generator`` on the
generator's device (the CPU for ``None``) and cast to the params' dtype;
the draws are not ``jax.random``'s (parity tests carry the reference's
weights across with ``convert.py``).  The
reference's ``shard_hint`` is a mesh sharding hint that means nothing on
one device, and has no counterpart; its mixed-precision ``DTypePolicy``
is unused by the models and has none either.

Tensor parallelism (the reference's GSPMD over ``model``): a ``Shard``
tells a sub-layer that its leaves are this rank's ``model`` shards; it
computes an f32 partial output and ``Shard.out`` sums it over ``model``
in rank order (``collectives.combine``, or under sequence parallelism
``scatter_seq`` into the rank's chunk), then adds the bias once and
rounds once to x's dtype.  ``embed`` with a ``Shard`` is the
vocab-parallel lookup: the rank's rows, zeros for an id outside them,
summed over ``model`` -- one non-zero and zeros add exactly, so it is
bitwise the dense lookup.

``remat`` is the reference's ``jax.checkpoint``: the backward recomputes
a function's forward instead of keeping what it saved.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as CK

from repro_torch.kernels.grad import grad_wanted, ieee_matmul
from repro_torch.launch import collectives as COLL
from repro_torch.launch.mesh import ProcessMesh, current_context, use_context

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Shard:
    """A tensor-parallel sub-layer's place on ``mesh``: its leaves are this
    rank's shards along ``model`` (``index`` of ``m``); ``sp``: the
    residual stream is sequence-sharded, so the output leaves as this
    rank's chunk."""
    mesh: ProcessMesh
    sp: bool = False

    @property
    def m(self) -> int:
        return self.mesh.axis_size("model")

    @property
    def index(self) -> int:
        return self.mesh.index_over("model")

    def local(self, width: int, whole: int, what: str) -> int:
        """The first of this rank's ``width`` units of ``whole``; raises
        unless ``width`` is ``whole``'s share of one rank."""
        if width * self.m != whole:
            raise ValueError(f"{what}: a shard of {width} of {whole} over "
                             f"{self.m} model ranks")
        return self.index * width

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor read by rank-local work: its cotangent is
        summed over ``model``."""
        return COLL.enter(x, self.mesh)

    def out(self, partial: torch.Tensor, dtype: torch.dtype,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The f32 ``partial`` summed over ``model`` in rank order (this
        rank's chunk of it under ``sp``), + ``bias`` once, in ``dtype``."""
        if self.sp:
            y = COLL.scatter_seq(partial, self.mesh)
            bias = None if bias is None else self.enter(bias)
        else:
            y = COLL.combine(partial, self.mesh)
        if bias is not None:
            y = y + bias.to(torch.float32)
        return y.to(dtype)


def remat(fn: Callable[..., Any], *args: Any) -> Any:
    """``fn(*args)``; checkpointed when autograd records and a tensor of
    ``args`` requires a gradient: the forward keeps only ``args`` and
    the backward runs ``fn`` once more, whole, to get what its ops saved
    -- the same ops on the same inputs, so the same bits.  Otherwise (a
    serve path under ``no_grad`` or ``inference_mode``) it calls ``fn``.

    Non-reentrant (checkpoints nest, and the kernels' and collectives'
    ``autograd.Function``s run inside).  The recompute runs whole (no
    early stop): every rank re-issues all of ``fn``'s collectives, in
    order, and each kernel's launch and counted work (``kernels/work``)
    comes once more, never cut off inside a wrapper.  It runs in the
    mesh context ``fn``'s forward ran in (``launch/mesh.use_context``).
    No model function draws random numbers, so the RNG state is not
    saved and restored (which would also call the RNG of the meta
    device, which has none)."""
    if not grad_wanted(*(a for a in args if isinstance(a, torch.Tensor))):
        return fn(*args)
    ctx = current_context()

    def body(*a: Any) -> Any:
        with use_context(ctx):
            return fn(*a)

    with CK.set_checkpoint_early_stop(False):
        return CK.checkpoint(body, *args, use_reentrant=False,
                             preserve_rng_state=False)


def gen_device(generator: Optional[torch.Generator]) -> torch.device:
    """Where ``generator`` draws: its own device, the CPU for None."""
    return torch.device("cpu") if generator is None else generator.device


def randn(generator: Optional[torch.Generator],
          shape: Tuple[int, ...]) -> torch.Tensor:
    """f32 N(0, 1) of ``shape`` drawn on the generator's device."""
    return torch.randn(shape, generator=generator,
                       device=gen_device(generator))


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of the operands widened to f32, in IEEE f32 (refused on
    the card while TF32 is allowed)."""
    return ieee_matmul(a.to(torch.float32), b.to(torch.float32))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype: torch.dtype = torch.float32) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6,
            offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in f32 (gemma-style optional +1 offset via ``offset=1``)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (params["scale"].to(torch.float32) + offset)).to(x.dtype)


def layernorm_init(dim: int, dtype: torch.dtype = torch.float32) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype),
            "bias": torch.zeros((dim,), dtype=dtype)}


def layernorm(params: Params, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = (y * params["scale"].to(torch.float32)
         + params["bias"].to(torch.float32))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / embedding
# ---------------------------------------------------------------------------

def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               *, bias: bool = False, dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    p = {"kernel": (randn(generator, (d_in, d_out))
                    * float(scale)).to(dtype)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype,
                                device=gen_device(generator))
    return p


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ kernel (+ bias)``, f32 accumulation, one rounding to x's
    dtype."""
    y = f32_matmul(x, params["kernel"])
    if "bias" in params:
        y = y + params["bias"].to(torch.float32)
    return y.to(x.dtype)


def embed_init(generator: Optional[torch.Generator], vocab: int, dim: int,
               dtype: torch.dtype = torch.float32) -> Params:
    return {"table": (randn(generator, (vocab, dim)) * 0.02).to(dtype)}


def embed(params: Params, tokens: torch.Tensor,
          shard: Optional[Shard] = None) -> torch.Tensor:
    """Rows of the table; with ``shard`` the vocab-parallel lookup of the
    rank's rows, bitwise the dense one, whole on every rank."""
    table = params["table"]
    if shard is None:
        return table[tokens.long()]
    n = table.shape[0]
    ids = tokens.long() - shard.index * n
    inside = (ids >= 0) & (ids < n)
    rows = table[torch.clamp(ids, 0, n - 1)]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return COLL.combine(rows, shard.mesh)


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: f32 logits = x @ table^T (a rank's vocab columns
    from its rows of a vocab-parallel table)."""
    return f32_matmul(x, params["table"].t())


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, base: float = 10000.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / torch.pow(base, exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, base, x.device)
    angles = positions[..., None].to(torch.float32) * freqs   # (...,S,hd/2)
    angles = angles[..., None, :]                              # head axis
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACT_FNS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "gelu": gelu,
    "silu": F.silu,
}


def count_params(tree: Any) -> int:
    """Elements over every tensor or array leaf of a nest of dicts and
    lists."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return int(math.prod(tree.shape))
