"""Small shared utilities (counterpart of ``repro/utils.py``)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n``, with a floor of 1."""
    return 1 << max(0, int(n) - 1).bit_length()


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device an entry point runs on.

    A CUDA device is refused when CUDA is missing: entry points never
    carry on on the CPU unless the caller asked for ``"cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev


def host_f32(a: Any) -> np.ndarray:
    """A tensor (on any device) or array-like as a host f32 numpy array."""
    if torch.is_tensor(a):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every tensor or array in a nest of lists, tuples and
    dicts, in the JAX package's leaf order (a list index, then a sorted
    dict key), each path written as ``jax.tree_util.keystr`` writes it:
    ``[0]['w_b']``.  Checkpoint keys and AdamW's decay mask read them."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaf_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """``fn(path, leaf)`` for every leaf of ``tree`` (paths as
    ``leaf_paths`` writes them), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees ``rest`` of
    the same structure, which the result keeps."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
