"""int8 gradient compression with error feedback.

Counterpart of ``repro/optim/compression.py``.  Each gradient leaf is
quantized to int8 with one per-tensor scale after adding the residual
the last step left, and the quantization error is carried in f32 state
to the next step (error-feedback SGD): quantize -> dequantize, with the
residual kept per leaf.  The same f32 ops in the same order as the
reference's; ``torch.round`` and ``jnp.round`` both round half to even,
so the codes, scales and residuals are its bits on the CPU.

On one card there is nothing to all-reduce: ``axis_name`` (the
reference's collective over a mesh axis, inside ``shard_map``/``pmap``)
raises until the multi-process (``torch.distributed`` process group)
design exists (``ROADMAP.md``, queue 1, item 4).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.utils import leaf_paths, tree_map, tree_map_with_path

Tree = Any
CompressionState = Tree  # residual tree, f32


def init_compression(params: Tree) -> CompressionState:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: returns (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compressed_allreduce(grads: Tree, residual: CompressionState,
                         axis_name: Optional[str] = None
                         ) -> Tuple[Tree, CompressionState]:
    """Error-feedback int8 round trip of a gradient tree: returns (the
    dequantized gradients in each leaf's dtype, the new f32 residuals)."""
    if axis_name is not None:
        raise NotImplementedError(
            f"compressed_allreduce(axis_name={axis_name!r}): the int32 "
            f"all-reduce across cards waits for the multi-process design "
            f"(ROADMAP.md, queue 1, item 4); one card has nothing to reduce")
    out = {}

    def one(path: str, g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        g32 = g.to(torch.float32) + r
        deq = decompress_int8(*compress_int8(g32))
        out[path] = g32 - deq
        return deq.to(g.dtype)

    res = dict(leaf_paths(residual))
    deq = tree_map_with_path(lambda path, g: one(path, g, res[path]), grads)
    return deq, tree_map_with_path(lambda path, _: out[path], residual)
