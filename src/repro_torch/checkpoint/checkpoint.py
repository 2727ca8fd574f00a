"""Restore the reference's checkpoints into the port: params, masks, scales.

Counterpart of the read half of ``repro/checkpoint/checkpoint.py``; the
on-disk layout is the reference's, so the port serves what the
reference's trainer saved:

    <dir>/step_<N>/manifest.json   step, leaf shapes and dtypes, extra,
                                   and which masks / scales are present
    <dir>/step_<N>/arrays.npz      one array per leaf, keyed by its path
                                   (``jax.tree_util.keystr``: ``[0]['w']``)
    <dir>/step_<N>/masks.npz       ``mask_<i>``: bool keep array of layer i
    <dir>/step_<N>/scales.npz      ``x_<i>``, and ``w_<i>`` (mlp) or
                                   ``wb_<i>`` + ``t_<i>`` (kan)

Restore works into a target of the port's shape -- a list of per-layer
dicts of tensors or arrays -- whose leaf paths are written the way
``keystr`` writes them (a list index as ``[i]``, a dict key as
``[repr(key)]``).  Every mismatch (missing leaf, shape, dtype) is named
in one ``CheckpointMismatchError``.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import LayerScales, StackScales
from repro_torch.core.sparsity import PatternMask

_STEP_RE = re.compile(r"^step_(\d+)$")
_MASK_FILE = "masks.npz"
_SCALE_FILE = "scales.npz"


class CheckpointMismatchError(ValueError):
    """A checkpoint does not fit the restore target's tree structure."""


def _leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) of every tensor or array in a nest of lists,
    tuples and dicts, in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaf_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _np_dtype(leaf: Any) -> np.dtype:
    if torch.is_tensor(leaf):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _rebuild(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _unflatten_into(target: Any, flat: Dict[str, np.ndarray],
                    ctx: str = "checkpoint", cast: bool = False) -> Any:
    """Rebuild ``target``'s structure from ``flat``; every incompatibility
    (missing leaves, shape and dtype mismatches) is collected and raised as
    ONE CheckpointMismatchError naming each offending key.  ``cast=True``
    coerces saved leaves to the target's dtypes instead of refusing."""
    paths = _leaf_paths(target)
    problems: List[str] = []
    for key, leaf in paths:
        shape = tuple(leaf.shape)
        if key not in flat:
            problems.append(f"missing leaf {key} (target wants shape {shape})")
        elif tuple(flat[key].shape) != shape:
            problems.append(
                f"shape mismatch at {key}: checkpoint has "
                f"{tuple(flat[key].shape)}, target wants {shape}")
        elif not cast and flat[key].dtype != _np_dtype(leaf):
            problems.append(
                f"dtype mismatch at {key}: checkpoint has {flat[key].dtype}, "
                f"target wants {_np_dtype(leaf)} (pass cast=True to coerce "
                f"deliberately)")
    if problems:
        keys = {k for k, _ in paths}
        extras = sorted(k for k in flat if k not in keys)
        if extras:
            problems.append(
                "checkpoint-only leaves (fine on their own, listed for "
                "diagnosis): " + ", ".join(extras[:8])
                + (" ..." if len(extras) > 8 else ""))
        raise CheckpointMismatchError(
            f"{ctx} does not match the restore target "
            f"({len(problems)} problem(s)):\n  " + "\n  ".join(problems))
    leaves = {}
    for key, leaf in paths:
        a = flat[key].astype(_np_dtype(leaf)) if cast else flat[key]
        leaves[key] = (torch.from_numpy(np.array(a)).to(leaf.device)
                       if torch.is_tensor(leaf) else np.array(a))
    return _rebuild(target, leaves)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]) -> Tuple[str, int, dict]:
    """(directory, step, manifest) of ``step``, or of the latest one."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        return d, step, json.load(f)


def restore_checkpoint(ckpt_dir: str, target: Any, *,
                       step: Optional[int] = None, cast: bool = False
                       ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore into ``target``'s structure (tensor leaves come back as
    tensors on the target leaf's device, array leaves as arrays).

    ``cast``: False (default) raises CheckpointMismatchError naming every
    leaf whose saved dtype differs from the target's; True coerces.
    Returns (tree, step, extra).
    """
    d, step, manifest = _step_dir(ckpt_dir, step)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten_into(target, flat, ctx=f"checkpoint {d}", cast=cast)
    return tree, step, manifest.get("extra", {})


def restore_masks(ckpt_dir: str, *, step: Optional[int] = None
                  ) -> Optional[List[Optional[PatternMask]]]:
    """The per-layer PatternMask list saved with the params, bit-exact, or
    None when the checkpoint carries no masks (a dense model)."""
    d, _, manifest = _step_dir(ckpt_dir, step)
    meta = manifest.get("masks")
    if meta is None:
        return None
    masks: List[Optional[PatternMask]] = [None] * int(meta["n_layers"])
    with np.load(os.path.join(d, _MASK_FILE)) as z:
        for i in meta["present"]:
            masks[i] = PatternMask(np.asarray(z[f"mask_{i}"], np.bool_))
    return masks


def restore_scales(ckpt_dir: str, *,
                   step: Optional[int] = None) -> Optional[StackScales]:
    """The StackScales saved with the params, or None when the checkpoint
    carries no scales.  A malformed entry (missing key, wrong rank,
    non-positive scale) raises CheckpointMismatchError naming its npz
    key."""
    d, _, manifest = _step_dir(ckpt_dir, step)
    meta = manifest.get("scales")
    if meta is None:
        return None

    def get(z: Any, key: str, scalar: bool) -> np.ndarray:
        if key not in z.files:
            raise CheckpointMismatchError(
                f"scales in {d} are malformed: missing key {key}")
        a = np.asarray(z[key], np.float32)
        if scalar and a.ndim != 0:
            raise CheckpointMismatchError(
                f"scales in {d} are malformed: {key} should be a scalar, "
                f"has shape {tuple(a.shape)}")
        if not scalar and a.ndim != 1:
            raise CheckpointMismatchError(
                f"scales in {d} are malformed: {key} should be 1-D, "
                f"has shape {tuple(a.shape)}")
        if not np.all(a > 0):
            raise CheckpointMismatchError(
                f"scales in {d} are malformed: {key} contains "
                "non-positive entries")
        return a

    out = []
    with np.load(os.path.join(d, _SCALE_FILE)) as z:
        for i, kind in enumerate(meta["kinds"]):
            x = float(get(z, f"x_{i}", scalar=True))
            if kind == "mlp":
                out.append(LayerScales(kind="mlp", x=x,
                                       w=get(z, f"w_{i}", scalar=False)))
            else:
                out.append(LayerScales(
                    kind="kan", x=x,
                    w_b=float(get(z, f"wb_{i}", scalar=True)),
                    t=get(z, f"t_{i}", scalar=False)))
    return StackScales(tuple(out))
