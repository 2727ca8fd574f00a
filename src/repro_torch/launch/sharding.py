"""Parameter, optimizer-state, batch and cache sharding rules.

Counterpart of ``repro/launch/sharding.py`` (DESIGN.md Sec. 6).  The
rules are the reference's, matched against each leaf's ``keystr`` path
(``utils.leaf_paths``) with the same regexes, first match wins, and each
function returns the reference's ``PartitionSpec`` entry for entry: a
``P`` per leaf whose entries are an axis name, a tuple of names or None.

  * batch over ("pod", "data");
  * attention heads, FFN hidden and vocab over "model";
  * MoE experts over "model", their d_ff over "data";
  * ``fsdp=True``: every leaf of more than 2**20 entries also over
    "data" on its first divisible replicated dim;
  * ZeRO-1: the AdamW moments additionally over "data" on their first
    divisible replicated dim;
  * KV caches: batch over (pod, data), sequence over "model" when long.

``_fit`` pads a rule's spec on the left for a stacked leaf's leading
``n_units`` dim and drops an axis that does not divide its dim.

Storage follows the specs (``launch/steps``): ``shard_leaf`` cuts this
rank's block of a whole leaf on a ``ProcessMesh`` and ``gather_leaf``
rebuilds the whole (or gathers only some axes) with
``launch/collectives.gather_cat``; ``shard_caches`` and
``gather_caches`` do the same for the serve steps' caches, whose
sequence-sharded entries a rank holds slots ``cache_slots`` of.

Compute follows ``tp_unit``: a leaf whose ``model`` shard is a whole
unit of its layer's work (whole attention heads, whole FFN hidden lanes,
whole KAN outputs or inputs, whole recurrence lanes, whole vocab rows)
is computed from the shard (Megatron tensor parallelism); any other leaf
is gathered whole.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import ProcessMesh, data_axes
from repro_torch.utils import tree_map, tree_map_with_path

Tree = Any
Entry = Optional[str | Tuple[str, ...]]


class P:
    """A partition spec: one entry a dim (an axis name, a tuple of
    names, or None), the reference's ``PartitionSpec``, which writes a
    1-tuple of names as the name.  A tree leaf (not a tuple, which trees
    descend into); iterates and compares as the tuple of its entries."""
    __slots__ = ("parts",)

    def __init__(self, *parts: Entry) -> None:
        def norm(p: Any) -> Entry:
            if isinstance(p, (list, tuple)):
                p = tuple(p)
                return p[0] if len(p) == 1 else (p or None)
            return p
        self.parts: Tuple[Entry, ...] = tuple(norm(p) for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i: int) -> Entry:
        return self.parts[i]

    def __eq__(self, other: object) -> bool:
        if isinstance(other, P):
            return self.parts == other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"P{self.parts!r}"

    def axes(self) -> Tuple[str, ...]:
        """Every axis the spec names, in order."""
        return tuple(a for e in self.parts if e is not None
                     for a in ((e,) if isinstance(e, str) else e))


# (keypath regex, spec) -- first match wins.
# Keypaths look like: ['units']['slot0']['attn']['wq']['kernel']
_RULES: Tuple[Tuple[str, P], ...] = (
    # embeddings / lm head: vocab over model
    (r"\['embed'\]\['table'\]$", P("model", None)),
    (r"\['lm_head'\]\['kernel'\]$", P(None, "model")),
    # attention projections
    (r"\['(wq|wk|wv)'\]\['kernel'\]$", P(None, "model")),
    (r"\['(wq|wk|wv)'\]\['bias'\]$", P("model")),
    (r"\['wo'\]\['kernel'\]$", P("model", None)),
    (r"\['wo'\]\['bias'\]$", P()),
    # MoE: experts over model (EP) + FSDP over data on the d_ff dim
    (r"\['router'\]", P()),
    (r"\['experts'\]\['(gate|up)'\]$", P("model", None, "data")),
    (r"\['experts'\]\['down'\]$", P("model", "data", None)),
    (r"\['experts'\]\[.*\]\['(w_b|t)'\]$", P("model", None, None)),
    # FFN / GLU
    (r"\['ffn'\]\['(gate|up)'\]\['kernel'\]$", P(None, "model")),
    (r"\['ffn'\]\['(gate|up)'\]\['bias'\]$", P("model")),
    (r"\['ffn'\]\['down'\]\['kernel'\]$", P("model", None)),
    (r"\['ffn'\]\['down'\]\['bias'\]$", P()),
    # KAN-FFN: up shards n_out, down shards n_in (t is (n_in, nb, n_out))
    (r"\['kan_up'\]\['w_b'\]$", P(None, "model")),
    (r"\['kan_up'\]\['t'\]$", P(None, None, "model")),
    (r"\['kan_down'\]\['w_b'\]$", P("model", None)),
    (r"\['kan_down'\]\['t'\]$", P("model", None, None)),
    # xLSTM / RG-LRU inner projections: shard the inner width
    (r"\['(up|in_x|in_gate|wx|wif|wa)'\]\['kernel'\]$", P(None, "model")),
    (r"\['(up|in_x|in_gate|wx|wif|wa)'\]\['bias'\]$", P("model")),
    (r"\['(down|out)'\]\['kernel'\]$", P("model", None)),
    (r"\['(down|out)'\]\['bias'\]$", P()),
    (r"\['conv'\]$", P(None, "model")),
    (r"\['lambda'\]$", P("model")),
    (r"\['r'\]$", P()),                       # sLSTM recurrent (small)
    (r"\['frontend_proj'\]\['kernel'\]$", P(None, "model")),
    # norms and anything else small: replicated
    (r".*", P()),
)


def _spec_for_path(path_str: str, ndim: int, shape: Iterable[int],
                   mesh: ProcessMesh) -> P:
    for pat, spec in _RULES:
        if re.search(pat, path_str):
            return _fit(spec, ndim, shape, mesh, path_str)
    return P()


def _fit(spec: P, ndim: int, shape: Iterable[int], mesh: ProcessMesh,
         path_str: str) -> P:
    """Adjust a rule spec to the leaf's rank (a stacked leaf's leading
    dim) and drop an axis whose size does not divide its dim."""
    parts = list(spec)
    while len(parts) < ndim:
        parts.insert(0, None)
    parts = parts[:ndim]
    sizes = mesh.sizes
    out = []
    for dim, ax in zip(shape, parts):
        if ax is not None and dim % sizes.get(ax, 1) != 0:
            ax = None                    # not divisible -> replicate
        out.append(ax)
    return P(*out)


def param_shardings(params: Tree, mesh: ProcessMesh,
                    fsdp: bool = False) -> Tree:
    """A ``P`` per leaf of a parameter tree (meta tensors too).

    ``fsdp=True`` also shards every leaf of more than 2**20 entries over
    'data' on its first divisible replicated dim."""
    dsize = mesh.sizes.get("data", 1)

    def one(path: str, leaf: torch.Tensor) -> P:
        shape = tuple(leaf.shape)
        spec = _spec_for_path(path, len(shape), shape, mesh)
        if fsdp and math.prod(shape) > 2 ** 20:
            parts = list(spec) + [None] * (len(shape) - len(spec))
            if "data" not in parts:
                for i, (dim, ax) in enumerate(zip(shape, parts)):
                    if ax is None and dim % dsize == 0 and dim >= dsize:
                        parts[i] = "data"
                        break
                spec = P(*parts)
        return spec

    return tree_map_with_path(one, params)


def zero1_shardings(opt_moments: Tree, base: Tree,
                    mesh: ProcessMesh) -> Tree:
    """ZeRO-1: each moment's param spec with 'data' added on its first
    still-replicated divisible dim."""
    dsize = mesh.sizes.get("data", 1)

    def one(leaf: torch.Tensor, sh: P) -> P:
        spec = list(sh) + [None] * (len(leaf.shape) - len(sh))
        if "data" in spec:            # already data-sharded (FSDP params)
            return P(*spec)
        for i, (dim, ax) in enumerate(zip(leaf.shape, spec)):
            if ax is None and dim % dsize == 0 and dim >= dsize:
                spec[i] = "data"
                break
        return P(*spec)

    return tree_map(one, opt_moments, base)


# A block's prefix: a stacked decoder unit's slot, an "extra" decoder
# layer, or the encoder's stacked blocks
_BLOCK = (r"^(?:\['units'\]\['slot\d+'\]|\['extra'\]\[(?P<extra>\d+)\]"
          r"|\['encoder'\]\['units'\])")
_TP_ATTN = re.compile(
    _BLOCK + r"\['(?:attn|cross)'\]\['(?P<leaf>wq|wk|wv|wo)'\]\[")
_TP_FFN = re.compile(
    _BLOCK + r"\['ffn'\]\['(?P<leaf>gate|up|down|kan_up|kan_down)'\]\[")
_TP_REC = re.compile(
    _BLOCK + r"\['rec'\]\['(in_x|in_gate|wa|wx|out|conv|lambda)'\]")
_TP_MLSTM = re.compile(_BLOCK + r"\['mlstm'\]\['(wq|wk|wv|down)'\]\[")
_TP_SHARED = re.compile(
    _BLOCK + r"\['moe'\]\['shared'\]\['(up|down)'\]\[")
_TP_VOCAB = re.compile(r"^(\['embed'\]\['table'\]|\['lm_head'\]\['kernel'\])$")


def tp_unit(path: str, spec: P, cfg: Any, mesh: ProcessMesh) -> bool:
    """Whether the leaf at ``path`` (spec ``spec`` under ``_RULES``) is
    computed from its ``model`` shard: its shard is a whole unit of its
    layer's work.

    * ``wq`` (+ bias) and ``wo`` of a decoder block's self-attention,
      of its cross-attention and of an encoder block's attention: whole
      heads (``n_heads % model == 0``); ``wk``/``wv``: whole kv heads too
      (``n_kv_heads % model == 0``); else they are gathered and a rank
      takes the kv heads its q heads use;
    * a decoder or encoder block's FFN ``gate``/``up``/``down``: whole
      hidden lanes, in groups of 4 when a hidden mask compacts them;
      ``kan_up``: whole KAN outputs; ``kan_down``: whole KAN inputs
      (``"kanffn"``: ``kan_up`` only, its hidden lanes in groups of 4
      under a hidden mask);
    * the RG-LRU's ``in_x``/``in_gate``/``wa``/``wx`` columns,
      ``conv``/``lambda`` lanes and ``out`` rows: whole recurrence lanes
      (the scan is elementwise over them);
    * the mLSTM's ``wq``/``wk``/``wv`` columns and ``down`` rows: whole
      heads (``n_heads % model == 0``);
    * the shared expert's ``up`` columns and ``down`` rows: whole hidden
      lanes (its ``gate`` is replicated by the rules, and a rank slices
      its columns);
    * ``embed.table`` / ``lm_head``: whole vocab rows or columns.

    Gathered whole, though the rules shard them:

    * the MoE's routed experts (expert parallel, their own rule);
    * the mLSTM's ``up`` (its columns are ``[z | gate]``: a contiguous
      shard is half of one of them), ``wif`` (reshaped to (2, heads): a
      shard is all input or all forget gates) and ``conv`` (z feeds every
      head's q and k whole);
    * the sLSTM's ``wx`` (its columns are (4 gates, heads, head dim): a
      shard is two gates of every head), ``up`` (``[a | b]``) and
      ``down``: the block runs whole;
    * ``frontend_proj``: its output is read whole by replicated work, so
      a rank's columns would be all-gathered at every call, B x T x d / m
      entries a rank against the leaf's d x d / m once a step (whisper's
      1500 frames at 4 rows: 5.9x the bytes), and the serve steps gather
      the leaf once, in ``compute_params``.

    A pure function of the arch, the spec and the mesh's shape."""
    m = mesh.axis_size("model")
    if m <= 1 or "model" not in spec.axes():
        return False
    if _TP_VOCAB.match(path) or _TP_REC.match(path) \
            or _TP_SHARED.match(path):
        return True
    if _TP_MLSTM.match(path):
        return cfg.n_heads % m == 0
    attn = _TP_ATTN.match(path)
    if attn:
        heads = cfg.n_heads % m == 0
        return heads and (attn.group("leaf") not in ("wk", "wv")
                          or cfg.n_kv_heads % m == 0)
    ffn = _TP_FFN.match(path)
    if not ffn:
        return False
    if ffn.group("extra") is None:         # stacked units, the encoder:
        layer = 0                          # layer 0's FFN
    else:                                  # as models/transformer lays out
        units = 0 if cfg.ffn_kinds is not None else (
            cfg.n_layers // len(cfg.pattern))
        layer = units * len(cfg.pattern) + int(ffn.group("extra"))
    fcfg = cfg.ffn_cfg(layer)
    if fcfg.kind == "kan":
        return True
    if fcfg.kind == "kanffn":
        if ffn.group("leaf") != "kan_up":
            return False
        width, mask = fcfg.kanffn_hidden, fcfg.kanffn_hidden_mask()
    else:
        width, mask = fcfg.d_ff, fcfg.hidden_mask
    return mask is None or (width // m) % 4 == 0


# ---------------------------------------------------------------------------
# Batch / activation / cache shardings
# ---------------------------------------------------------------------------

def dp_axes(mesh: ProcessMesh) -> Tuple[str, ...]:
    return data_axes(mesh)


def _dp_size(mesh: ProcessMesh) -> int:
    return mesh.axis_size(dp_axes(mesh))


def batch_shardings(batch: Tree, mesh: ProcessMesh) -> Tree:
    """tokens/(frames|patches): batch dim over (pod, data), rest
    replicated."""
    axes = dp_axes(mesh)
    total = _dp_size(mesh)

    def one(leaf: torch.Tensor) -> P:
        if leaf.shape and axes and leaf.shape[0] % total == 0:
            return P(axes, *([None] * (len(leaf.shape) - 1)))
        return P()

    return tree_map(one, batch)


def cache_shardings(caches: Tree, mesh: ProcessMesh,
                    seq_axis_min: int = 1024) -> Tree:
    """KV caches: batch over (pod, data) + sequence over model when long.
    Recurrent states / mLSTM matrix memory: batch over (pod, data)
    only."""
    axes = dp_axes(mesh)
    total = _dp_size(mesh)
    msize = mesh.sizes.get("model", 1)

    def one(ps: str, leaf: torch.Tensor) -> P:
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if not shape:
            return P()
        # a stacked cache (under ['units']) carries a leading (n_units,)
        # dim: the batch dim is right after it, never dim 0
        batch_dim = 1 if "['units']" in ps else 0
        if (batch_dim < len(shape) and axes
                and shape[batch_dim] % total == 0
                and shape[batch_dim] >= total):
            spec[batch_dim] = axes
        else:
            batch_dim = -1
        if (re.search(r"\['(k|v|ck|cv|k_scale|v_scale)'\]$", ps)
                and len(shape) >= 3):
            seq_dim = batch_dim + 1 if batch_dim >= 0 else None
            if (seq_dim is not None
                    and shape[seq_dim] >= seq_axis_min
                    and shape[seq_dim] % msize == 0):
                spec[seq_dim] = "model"      # sequence-sharded KV
        return P(*spec)

    return tree_map_with_path(one, caches)


def replicated(mesh: Optional[ProcessMesh] = None) -> P:
    return P()


def cache_slots(n_slots: int, mesh: ProcessMesh,
                coords: Optional[Dict[str, int]] = None) -> Tuple[int, int]:
    """``[lo, hi)``: the slots of a sequence-sharded cache of ``n_slots``
    slots that this rank (the rank at ``coords``) holds: rank r of
    ``model`` holds ``[r * S / m, (r + 1) * S / m)``."""
    m = mesh.axis_size("model")
    if n_slots % m:
        raise ValueError(f"{n_slots} slots do not split over {m} model "
                         f"ranks")
    size = n_slots // m
    lo = mesh.index_over("model", coords) * size
    return lo, lo + size


def local_shape(shape: Iterable[int], spec: P,
                mesh: ProcessMesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape`` by ``spec``."""
    parts = _parts(spec, len(tuple(shape)), None)
    return tuple(d // mesh.axis_size(ax) for d, ax in zip(shape, parts))


def shard_caches(caches: Tree, specs: Tree, mesh: ProcessMesh) -> Tree:
    """This rank's pieces of whole caches by their specs
    (``cache_shardings``)."""
    return shard_tree(caches, specs, mesh)


def gather_caches(caches: Tree, specs: Tree, mesh: ProcessMesh) -> Tree:
    """The whole caches from every rank's pieces (``shard_caches``'
    inverse; comparisons, checkpoints): every rank gets them."""
    return tree_map(lambda x, s: gather_leaf(x, s, mesh), caches, specs)


# ---------------------------------------------------------------------------
# Storage: cut and rebuild a leaf by its spec
# ---------------------------------------------------------------------------

def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _parts(spec: P, ndim: int, axes: Optional[Iterable[str]]
           ) -> Tuple[Tuple[str, ...], ...]:
    """Each dim's axes, padded to ``ndim``, keeping only ``axes`` (all
    when None)."""
    keep = None if axes is None else set(axes)
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple(tuple(a for a in _entry_axes(e) if keep is None or a in keep)
                 for e in entries)


def shard_leaf(x: torch.Tensor, spec: P, mesh: ProcessMesh,
               axes: Optional[Iterable[str]] = None,
               coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's block of ``x`` by ``spec`` (cut only along ``axes``
    when given; the block of the rank at ``coords`` when given), a
    contiguous copy."""
    for dim, ax in enumerate(_parts(spec, x.dim(), axes)):
        n = mesh.axis_size(ax)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.index_over(ax, coords) * size, size)
    return x.contiguous().clone()


def gather_leaf(x: torch.Tensor, spec: P, mesh: ProcessMesh,
                axes: Optional[Iterable[str]] = None) -> torch.Tensor:
    """The whole leaf from this rank's block ``x`` (only ``axes``
    gathered when given): ``shard_leaf``'s inverse, bitwise."""
    for dim, ax in enumerate(_parts(spec, x.dim(), axes)):
        if mesh.axis_size(ax) > 1:
            x = C.gather_cat(x, mesh, ax, dim)
    return x


def shard_tree(tree: Tree, specs: Tree, mesh: ProcessMesh,
               axes: Optional[Iterable[str]] = None) -> Tree:
    return tree_map(lambda x, s: shard_leaf(x, s, mesh, axes), tree, specs)

