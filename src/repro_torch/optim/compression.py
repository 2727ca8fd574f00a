"""int8 gradient compression with error feedback.

Counterpart of ``repro/optim/compression.py``.  Each gradient leaf is
quantized to int8 with one per-tensor scale after adding the residual
the last step left, and the quantization error is carried in f32 state
to the next step (error-feedback SGD): quantize -> dequantize, with the
residual kept per leaf.  The same f32 ops in the same order as the
reference's; ``torch.round`` and ``jnp.round`` both round half to even,
so the codes, scales and residuals are its bits on the CPU.

``axis_name`` is the reference's collective over a mesh axis (inside
its ``shard_map``): on a ``launch/mesh.ProcessMesh`` (``mesh``, or the
active one) each rank quantizes its own gradient and residual, then,
in the reference's order, the int32 sum of the codes over the axis
(``collectives.psum_int32``, exact in any order), the rank count n (the
reference's ``psum`` of ones: the axis size), ``scale = pmax(scale)``,
``deq = acc.f32 * scale / n.f32`` and ``new_r = g32 - deq``.  Every rank
gets the same dequantized gradient.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.launch import collectives as COLL
from repro_torch.launch.mesh import ProcessMesh, current_mesh
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
                         axis_name: Optional[str | Tuple[str, ...]] = None,
                         mesh: Optional[ProcessMesh] = None
                         ) -> Tuple[Tree, CompressionState]:
    """Error-feedback int8 all-reduce of a gradient tree: returns (the
    dequantized gradients in each leaf's dtype, the new f32 residuals).
    Without ``axis_name`` a quantize/dequantize round trip; with it the
    int32 all-reduce over that axis of ``mesh`` (default: the active
    mesh), the mean of the ranks' gradients."""
    if axis_name is not None:
        mesh = mesh if mesh is not None else current_mesh()
        if mesh is None:
            raise ValueError(
                f"compressed_allreduce(axis_name={axis_name!r}) needs a "
                f"process mesh: pass mesh= or run under launch.mesh."
                f"set_mesh")
        n = torch.tensor(mesh.axis_size(axis_name), dtype=torch.int32)
    out = {}

    def one(path: str, g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        g32 = g.to(torch.float32) + r
        q, scale = compress_int8(g32)
        if axis_name is not None:
            acc = COLL.psum_int32(q.to(torch.int32), mesh, axis_name)
            # scales differ per rank; the max scale is conservative
            scale = COLL.pmax(scale, mesh, axis_name)
            deq = (acc.to(torch.float32) * scale
                   / n.to(device=g.device, dtype=torch.float32))
        else:
            deq = decompress_int8(q, scale)
        out[path] = g32 - deq
        return deq.to(g.dtype)

    res = dict(leaf_paths(residual))
    deq = tree_map_with_path(lambda path, g: one(path, g, res[path]), grads)
    return deq, tree_map_with_path(lambda path, _: out[path], residual)
