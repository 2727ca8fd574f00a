"""Small shared utilities (counterpart of ``repro/utils.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple, Type

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


# numpy has no bf16: a bf16 array is ml_dtypes' bfloat16 (JAX's leaves)
# or, saved and loaded back through npz, a 2-byte void array of the same
# bytes
BF16_NP = np.dtype("V2")


def leaf_from_numpy(a: Any) -> torch.Tensor:
    """An array as a CPU tensor of the same dtype and bits; a bf16 array
    (either form above, which ``torch.from_numpy`` refuses) crosses
    through its 16-bit patterns."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_NP:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# Dataclasses whose instances are tree nodes (``optim.OptState``): their
# fields are the children, in order, each written ``[<flat index i>]`` as
# ``keystr`` writes the children of a node the reference registers without
# keys (its ``OptState``'s mu, nu and count).
_NODES: set = set()


def register_node(cls: Type) -> Type:
    """Make instances of the dataclass ``cls`` tree nodes (see ``_NODES``);
    returns ``cls``, so it can decorate the class."""
    _NODES.add(cls)
    return cls


def _children(tree: Any) -> List[Any]:
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)]


def leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every tensor or array in a nest of lists, tuples,
    dicts and registered dataclasses, in the JAX package's leaf order (a
    list index, then a sorted dict key), each path written as
    ``jax.tree_util.keystr`` writes it: ``[0]['w_b']``,
    ``['opt'][<flat index 0>]['embed']``.  Checkpoint keys and AdamW's
    decay mask read them."""
    if type(tree) in _NODES:
        return [kv for i, v in enumerate(_children(tree))
                for kv in leaf_paths(v, f"{prefix}[<flat index {i}>]")]
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
    if type(tree) in _NODES:
        return type(tree)(*(tree_map_with_path(fn, v,
                                               f"{prefix}[<flat index {i}>]")
                            for i, v in enumerate(_children(tree))))
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
    if type(tree) in _NODES:
        rests = [_children(r) for r in rest]
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rests))
                            for i, v in enumerate(_children(tree))))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
