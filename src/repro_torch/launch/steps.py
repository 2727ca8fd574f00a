"""Train and serve steps: the LM train step with its options and state,
and a prefill step and a decode step, each returning (greedy token,
caches), on one device or on a process mesh.

Counterpart of ``repro/launch/steps.py``.  The train step
(``make_train_step``) runs ``T.forward`` with no held ``ffns`` -- the
weights change every step, so the KAN FFNs fuse their weights inside
autograd -- then ``T.lm_loss`` + ``aux_weight * aux``, the gradients
(autograd through the kernels' Functions, ``kernels/grad.py``), optional
int8 error-feedback compression (``optim/compression``) and
``adamw_update`` at the reference's cosine schedule.  On a CUDA device it
runs under ``torch.use_deterministic_algorithms(True)`` (no NaN fill of
``torch.empty``), so two runs of a step give the same bits.  The
model checkpoints where the reference's does (``models/layers.remat``):
each stacked unit and encoder layer when ``cfg.remat`` (``MeshTrainStep``
too: the reference reads the config, no ``StepOptions`` field), each
loss chunk and each flash-attention block always; the backward
recomputes their forwards, with the same bits, launches and
collectives once more.  The serve steps run without autograd and take
no checkpoint.  ``scan_layers`` is read only through the params'
layout.

With ``mesh=`` (a ``launch/mesh.ProcessMesh``, one process a chip) the
step keeps the reference's storage layout and its sharded == dense
result, with the same program on every rank:

* each rank stores only its shard of every leaf: params by
  ``sharding.param_shardings`` (``fsdp`` where ``cfg.fsdp``), the AdamW
  moments by ``zero1_shardings`` (``train_state_shardings``);
* each rank computes Megatron tensor parallelism over ``model``, the
  reference's baseline schedule: a leaf whose ``model`` shard is a whole
  unit of work (``sharding.tp_unit``: the heads of self-attention,
  cross-attention, the encoder's attention and the mLSTM, the hidden
  lanes of the decoder's and the encoder's FFNs and of the shared
  expert, KAN outputs or inputs, the RG-LRU's recurrence lanes, vocab
  rows) is not gathered along ``model``; the rank computes its heads,
  lanes and vocab columns, and ``collectives.combine`` sums the partial
  outputs over ``model`` in rank order in f32 at each such sub-layer's
  exit and in the vocab-parallel embedding and cross-entropy
  (``collectives.enter`` sums the input's cotangent).  Every other leaf
  (the sLSTM's, the mLSTM's ``up``/``wif``/``conv``, ``frontend_proj``,
  any leaf whose shard is not whole heads) is all-gathered along
  ``model`` and computed whole; the choice is made once, when the step
  is built (``_tp_paths``);
* ``StepOptions.activation_mode="sp"`` splits the residual stream's
  sequence over ``model`` between sub-layers: norms run on a rank's
  chunk (their weights' cotangents summed over ``model``), a
  tensor-parallel sub-layer gathers the chunks at its entry and
  reduce-scatters its partial output at its exit
  (``collectives.gather_seq``, ``scatter_seq``), a gathered one runs on
  the whole sequence and keeps the rank's chunk, and the final norm's
  chunks are gathered for the loss (the reference's ``P(dp, "model",
  None)`` constraint on the final hidden); the encoder runs with its
  activations replicated;
* every leaf is all-gathered along ``data`` before use, and each rank
  runs the model on its ``data`` rows of the batch;
* each rank gets only its ZeRO-1 slice of the gradients averaged over
  the ``data`` ranks: cut along ``model`` at home (a tensor-parallel
  leaf's gradient is its ``model`` shard already), then the data ranks'
  chunks reduce-scattered and summed in rank order in f32
  (``collectives.reduce_scatter_over``; under ``grad_compression`` the
  int32 all-reduce of the whole, ``compressed_allreduce(axis_name=...)``,
  then the slice); the global norm adds the slices' sums of squares in
  rank order (within f32 rounding of the whole gradient's, its bits
  only on one rank); AdamW is elementwise, so a rank updates only its
  slice of params and moments and all-gathers the params' slices over
  ``data``;
* SwiGLU experts are not gathered along ``model``: each ``model`` rank
  runs its own (``models/moe``'s expert parallelism) and keeps their
  gradients;
* the loss, and the aux loss inside it, is averaged over the ``data``
  ranks.

``deterministic()`` sets ``CUBLAS_WORKSPACE_CONFIG`` in every rank
before its first product.  ``gather_state`` rebuilds the whole state
(checkpoints, comparisons).

The serve steps reach every arch of the zoo, the encoder-decoder and
frontend ones too (a batch carries ``frames`` or ``patches`` beside its
tokens), which token-only serving (``runtime/server.Server``) refuses,
as the reference's does.  ``ffns`` (``models/transformer.ffn_modules``)
and ``enc_ffns`` (``encoder_ffn_modules``) hold the KAN FFNs' weights
fused once; without them each step rebuilds them, with the same bits.  A
serve step runs without autograd.

With ``mesh=`` the serve steps are the reference's ``jitted_serve_step``
on a process mesh, the same program on every rank:

* the params are the rank's ``compute_params``: its ``model`` shard of
  every tensor-parallel leaf (the train step's ``_tp_paths``) and of the
  SwiGLU experts, every other leaf gathered; the rank computes its
  heads (self-attention, the encoder's, cross-attention's, the mLSTM's),
  lanes (FFNs, KAN, the RG-LRU, the shared expert) and vocab columns
  (``serve_mesh`` hands the model the context, and ``ffn_modules`` and
  ``encoder_ffn_modules`` built inside it hold their shards);
* the prefill step takes the global batch and keeps the rank's ``data``
  rows (``local_batch``);
* the rank holds its piece of each cache as the reference's
  ``cache_shardings`` lays it out (``cache_layout``): the batch over
  ``data``; the sequence of ``k``, ``v``, ``ck``, ``cv`` and the int8
  scales over ``model`` from 1024 slots that split evenly (rank r holds
  slots ``[r * S / m, (r + 1) * S / m)``, every kv head), every other
  cache replicated over ``model``; recurrent and mLSTM state over
  ``data`` only, so replicated over ``model``: a rank reads its lanes
  (the RG-LRU's) or heads (the mLSTM's) of it, and their new values are
  all-gathered along ``model`` after each block, so every ``model`` rank
  holds the same whole state.  ``ck``/``cv`` hold every kv head: a rank
  computes its kv heads' keys and values over every frame, and they
  cross as the self-attention caches' do.  The decode step is built
  with that layout: which
  caches are sequence-sharded is fixed by the arch, the batch and the
  prompt, never guessed from a rank's shapes;
* each step returns the rank's greedy tokens (the argmax over ``model``
  of a vocab-parallel head) and its pieces of the caches.
  ``sharding.gather_caches`` rebuilds the whole caches.

A 1x1 mesh is bitwise the step without one.

Run a prefill step and decode steps of any arch on seeded tokens (and
seeded ``0.1 * N(0, 1)`` frames or patches in the params' dtype):

  PYTHONPATH=src python -m repro_torch.launch.steps --arch whisper-medium \
      --ffn kan --pattern 0.5 --device cpu      # reduce()d (--scale smoke)
  PYTHONPATH=src python -m repro_torch.launch.steps --arch paligemma-3b \
      --scale full                              # on the card, bf16

A run is ``BATCH`` requests of ``PROMPT`` tokens, then ``NEW_TOKENS``
decode steps, drawn from seed ``SEED``.  Training runs through
``runtime/trainer.Trainer`` (``launch/train.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.deterministic as torch_det

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import _build
from repro_torch.launch import collectives as COLL
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import ACTIVATION_MODES, ProcessMesh, set_mesh
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Ffns
from repro_torch.optim import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    compressed_allreduce,
    cosine_schedule,
    init_compression,
)
from repro_torch.utils import (
    leaf_paths,
    resolve_device,
    tree_map,
    tree_map_with_path,
)

Params = Any
MODALITIES = ("frames", "patches")
BATCH, PROMPT, NEW_TOKENS, SEED = 2, 8, 4, 0
# torch's deterministic mode takes a cuBLAS product only under one of
# cuBLAS's deterministic workspace settings, read once a process (set it
# before the first product under that mode)
CUBLAS_WORKSPACE = ":4096:8"


@dataclasses.dataclass(frozen=True)
class StepOptions:
    lr: float = 3e-4
    total_steps: int = 10000
    warmup: int = 200
    aux_weight: float = 0.01
    # the residual stream over "model" on a mesh: replicated | sp
    # (sequence parallel between sub-layers; launch/mesh.MeshContext)
    activation_mode: str = "replicated"
    # int8 error-feedback gradient compression (optim/compression.py)
    grad_compression: bool = False

    def __post_init__(self) -> None:
        if self.activation_mode not in ACTIVATION_MODES:
            raise ValueError(
                f"StepOptions.activation_mode={self.activation_mode!r}: "
                f"expected one of {ACTIVATION_MODES}")


def default_opt_cfg(opts: StepOptions) -> AdamWConfig:
    return AdamWConfig(lr=cosine_schedule(opts.lr, opts.total_steps,
                                          opts.warmup))


def init_train_state(cfg: ArchConfig, opts: StepOptions = StepOptions(),
                     generator: Optional[torch.Generator] = None,
                     device: Optional[torch.device | str] = None, *,
                     params: Optional[Params] = None,
                     mesh: Optional[ProcessMesh] = None) -> Dict[str, Any]:
    """``{"params", "opt", "step"}`` (+ ``"ef_residual"`` under
    ``grad_compression``) on ``device``: params drawn from ``generator``
    (``T.init_params``), or ``params`` carried over (e.g. the reference's,
    ``convert.transformer_params_from_jax``), each leaf copied.  Without
    ``device``, the carried params' device (drawn ones: the CPU).  With
    ``mesh`` the whole state is drawn or carried, then this rank keeps its
    shards (``train_state_shardings``); its ``ef_residual`` is its own,
    in the gathered shapes it computes gradients in."""
    if params is None:
        params = T.init_params(cfg, generator, device or "cpu")
    else:
        to = device or leaf_paths(params)[0][1].device
        params = tree_map(lambda a: a.detach().to(to, copy=True), params)
    if mesh is not None:
        return _shard_state(cfg, opts, params, mesh)
    device = leaf_paths(params)[0][1].device
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if opts.grad_compression:
        state["ef_residual"] = init_compression(params)
    return state


def train_state_shardings(cfg: ArchConfig, mesh: ProcessMesh
                          ) -> Dict[str, Any]:
    """The reference's tree of specs of the train state: params by
    ``param_shardings`` (``fsdp`` where ``cfg.fsdp``), ``opt.mu`` and
    ``opt.nu`` by ZeRO-1, ``count`` and ``step`` replicated.  Built once
    per arch and mesh shape (not to be changed in place)."""
    return _state_shardings(cfg, mesh.axis_names, mesh.shape)


@functools.lru_cache(maxsize=8)
def _state_shardings(cfg: ArchConfig, axis_names: Tuple[str, ...],
                     shape: Tuple[int, ...]) -> Dict[str, Any]:
    mesh = ProcessMesh(axis_names, shape, abstract=True)
    st = SP.state_specs(cfg)
    psh = SH.param_shardings(st["params"], mesh, fsdp=cfg.fsdp)
    return {
        "params": psh,
        "opt": OptState(mu=SH.zero1_shardings(st["opt"].mu, psh, mesh),
                        nu=SH.zero1_shardings(st["opt"].nu, psh, mesh),
                        count=SH.replicated(mesh)),
        "step": SH.replicated(mesh),
    }


def _ep_paths(cfg: ArchConfig, mesh: ProcessMesh,
              pspecs: Params) -> set:
    """Paths of the SwiGLU expert leaves that stay on their ``model``
    rank (expert parallelism; ``models/moe``)."""
    if (mesh.axis_size("model") <= 1 or cfg.ffn_kind != "swiglu"
            or not cfg.n_experts):
        return set()
    return {k for k, spec in leaf_paths(pspecs)
            if "['experts']" in k and "model" in spec.axes()}


def _tp_paths(cfg: ArchConfig, mesh: ProcessMesh,
              pspecs: Params) -> frozenset:
    """Paths of the leaves computed from their ``model`` shard (tensor
    parallelism; ``sharding.tp_unit``)."""
    return frozenset(k for k, spec in leaf_paths(pspecs)
                     if SH.tp_unit(k, spec, cfg, mesh))


def _compute_axes(path: str, spec: SH.P, local: set) -> Tuple[str, ...]:
    """The axes a leaf is gathered along before use: all its spec's, but
    ``model`` for a leaf a rank computes from its ``model`` shard (its
    own experts, a tensor-parallel leaf)."""
    return tuple(a for a in spec.axes()
                 if not (a == "model" and path in local))


def compute_params(shards: Params, cfg: ArchConfig,
                   mesh: ProcessMesh) -> Params:
    """The params a rank computes with, from its stored shards: every
    leaf gathered whole, but the SwiGLU experts (the rank's ``E / model``
    experts) and the tensor-parallel leaves (``_tp_paths``) only over
    ``data``, as ``MeshTrainStep.gathered``."""
    pspecs = train_state_shardings(cfg, mesh)["params"]
    specs = dict(leaf_paths(pspecs))
    local = _ep_paths(cfg, mesh, pspecs) | _tp_paths(cfg, mesh, pspecs)
    return tree_map_with_path(
        lambda k, x: SH.gather_leaf(x, specs[k], mesh,
                                    _compute_axes(k, specs[k], local)),
        shards)


def shard_params(params: Params, cfg: ArchConfig,
                 mesh: ProcessMesh) -> Params:
    """This rank's shards of whole params (``param_shardings``)."""
    pspecs = train_state_shardings(cfg, mesh)["params"]
    return SH.shard_tree(params, pspecs, mesh)


def _shard_state(cfg: ArchConfig, opts: StepOptions, params: Params,
                 mesh: ProcessMesh) -> Dict[str, Any]:
    specs = train_state_shardings(cfg, mesh)
    device = leaf_paths(params)[0][1].device

    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def zero_shards(spec: Any) -> Any:
        return tree_map(lambda p, s: zeros(SH.shard_leaf(p, s, mesh)),
                        params, spec)

    state = {
        "params": SH.shard_tree(params, specs["params"], mesh),
        "opt": OptState(
            mu=zero_shards(specs["opt"].mu), nu=zero_shards(specs["opt"].nu),
            count=torch.zeros((), dtype=torch.int32, device=device)),
        "step": torch.zeros((), dtype=torch.int32, device=device)}
    if opts.grad_compression:
        local = (_ep_paths(cfg, mesh, specs["params"])
                 | _tp_paths(cfg, mesh, specs["params"]))
        pspecs = dict(leaf_paths(specs["params"]))
        state["ef_residual"] = tree_map_with_path(
            lambda k, p: zeros(SH.shard_leaf(p, pspecs[k], mesh, ("model",))
                               if k in local else p), params)
    return state


def gather_state(state: Dict[str, Any], cfg: ArchConfig,
                 mesh: ProcessMesh,
                 device: Optional[torch.device | str] = None
                 ) -> Dict[str, Any]:
    """The whole ``{"params", "opt", "step"}`` from every rank's shards
    (every rank gets it, each leaf moved to ``device`` as it is gathered
    when given; the rank-local ``ef_residual`` is left out)."""
    specs = train_state_shardings(cfg, mesh)
    to = (lambda a: a) if device is None else (lambda a: a.to(device))

    def whole(tree: Any, spec: Any) -> Any:
        return tree_map(lambda x, s: to(SH.gather_leaf(x, s, mesh)), tree,
                        spec)

    return {"params": whole(state["params"], specs["params"]),
            "opt": OptState(mu=whole(state["opt"].mu, specs["opt"].mu),
                            nu=whole(state["opt"].nu, specs["opt"].nu),
                            count=to(state["opt"].count)),
            "step": to(state["step"])}


def local_batch(batch: Dict[str, Any], mesh: ProcessMesh) -> Dict[str, Any]:
    """This rank's rows of a global batch (``batch_shardings``: the
    batch dim over (pod, data) where it divides, else whole)."""
    specs = SH.batch_shardings(batch, mesh)
    return {k: SH.shard_leaf(v, specs[k], mesh) for k, v in batch.items()}


def _split_batch(cfg: ArchConfig, batch: Dict
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    kw = {k: batch[k] for k in MODALITIES if k in batch}
    tokens = batch["tokens"]
    return tokens[:, :-1], tokens[:, 1:], kw


@contextlib.contextmanager
def deterministic(device: torch.device) -> Iterator[None]:
    """On a CUDA device, torch's deterministic algorithms (refusing any op
    without a deterministic form) with no NaN fill of ``torch.empty``;
    the previous settings come back on exit.  The CPU runs as it is."""
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch_det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch_det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch_det.fill_uninitialized_memory = before[2]


def value_and_grad(cfg: ArchConfig, opts: StepOptions, params: Params,
                   batch: Dict, *,
                   ffns_of: Optional[Callable[[Params], Ffns]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """(total loss, cross-entropy, gradients shaped like ``params``) of
    one batch: the loss the reference's ``train_step`` differentiates.
    A leaf the loss does not reach gets a zero gradient, as from
    ``jax.grad``.  ``ffns_of(params)``, given the params being
    differentiated, returns ``T.forward``'s ``ffns`` (e.g. plain
    versions to hold the kernels against); None runs the model's own."""
    inputs, labels, kw = _split_batch(cfg, batch)
    leaves = leaf_paths(params)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    h, aux = T.forward(live, cfg, inputs, **kw,
                       ffns=None if ffns_of is None else ffns_of(live))
    ce = T.lm_loss(live, cfg, h[:, -labels.shape[1]:], labels)
    total = ce + opts.aux_weight * aux
    live_leaves = [p for _, p in leaf_paths(live)]
    grads = torch.autograd.grad(total, live_leaves, allow_unused=True)
    by_path = {k: (torch.zeros_like(p) if g is None else g)
               for (k, p), g in zip(leaves, grads)}
    return (total.detach(), ce.detach(),
            tree_map_with_path(lambda k, _: by_path[k], params))


def make_train_step(cfg: ArchConfig, opts: StepOptions = StepOptions(),
                    mesh: Optional[ProcessMesh] = None
                    ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """``step(state, batch) -> (new state, metrics)``: metrics ``loss``
    (cross-entropy), ``total_loss`` (+ ``aux_weight * aux``),
    ``grad_norm`` (before the clip) and ``lr``, 0-d tensors on the
    state's device; the input state is left as it was.  With ``mesh``
    the state is this rank's shards (``init_train_state(mesh=)``), the
    batch its rows (``local_batch``), and the metrics the mesh's."""
    if mesh is not None:
        return MeshTrainStep(cfg, opts, mesh)
    opt_cfg = default_opt_cfg(opts)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        with deterministic(state["step"].device):
            total, ce, grads = value_and_grad(cfg, opts, state["params"],
                                              batch)
            new_state = {"step": state["step"] + 1}
            if opts.grad_compression:
                grads, residual = compressed_allreduce(
                    grads, state["ef_residual"])
                new_state["ef_residual"] = residual
            new_params, new_opt, metrics = adamw_update(
                grads, state["opt"], state["params"], opt_cfg)
        new_state.update({"params": new_params, "opt": new_opt})
        return new_state, {"loss": ce, "total_loss": total, **metrics}

    return train_step


def _zero1_delta(zspec: SH.P, pspec: SH.P) -> SH.P:
    """The axes ZeRO-1 adds to a param's spec, dim by dim."""
    pp = list(pspec) + [None] * (len(zspec) - len(pspec))
    return SH.P(*(tuple(a for a in SH._entry_axes(z)
                        if a not in SH._entry_axes(p)) or None
                  for z, p in zip(zspec, pp)))


class MeshTrainStep:
    """The train step on a process mesh (module docstring): ``grads``
    gives this rank's ZeRO-1 slices of the mesh's mean gradients,
    ``apply`` the AdamW update of the rank's shards from them, and a
    call both; ``gather_grads`` rebuilds the whole mean gradients."""

    def __init__(self, cfg: ArchConfig, opts: StepOptions,
                 mesh: ProcessMesh) -> None:
        self.cfg, self.opts, self.mesh = cfg, opts, mesh
        self.opt_cfg = dataclasses.replace(default_opt_cfg(opts),
                                           grad_clip_norm=None)
        self.clip = default_opt_cfg(opts).grad_clip_norm
        specs = train_state_shardings(cfg, mesh)
        self.pspecs = dict(leaf_paths(specs["params"]))
        self.zspecs = dict(leaf_paths(specs["opt"].mu))
        self.ep = _ep_paths(cfg, mesh, specs["params"])
        self.tp = _tp_paths(cfg, mesh, specs["params"])
        # leaves a rank computes from its model shard
        self.local = self.ep | self.tp
        self.dp = SH.dp_axes(mesh)
        self.n_dp = mesh.axis_size(self.dp)
        # a leaf's ZeRO-1 slice, cut from the gradient a rank computes
        # (a rank's experts and tensor-parallel leaves are already cut
        # along model)
        self.cut = {k: tuple(a for a in z.axes()
                             if not (a == "model" and k in self.local))
                    for k, z in self.zspecs.items()}
        self.delta = {k: _zero1_delta(self.zspecs[k], self.pspecs[k])
                      for k in self.zspecs}
        # the ranks holding a leaf's distinct slices (coordinate 0 off
        # the axes it is cut along), in rank order
        coords = [mesh.coords_of(mesh.axis_names, r)
                  for r in range(mesh.size)]
        self.holders = {
            k: [r for r, c in enumerate(coords)
                if all(c[a] == 0 for a in mesh.axis_names
                       if a not in self.cut[k]
                       and not (a == "model" and k in self.local))]
            for k in self.zspecs}

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data ranks, summed in rank order in f32."""
        if self.n_dp == 1:
            return x
        acc = COLL.reduce_over(x, self.mesh, self.dp, torch.float32)
        return (acc / self.n_dp).to(x.dtype)

    def _slice_mean(self, k: str, g: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 slice of the mean of ``g`` over the data
        ranks: cut off the data axes here, then each data rank's chunk
        reduce-scattered and summed in rank order in f32 (the bits
        ``_mean`` gives each element)."""
        spec, mesh = self.zspecs[k], self.mesh
        off = [a for a in self.cut[k] if a not in self.dp]
        g = SH.shard_leaf(g, spec, mesh, off)
        if self.n_dp == 1:
            return g
        on = [a for a in self.cut[k] if a in self.dp]
        chunks = ([SH.shard_leaf(g, spec, mesh, on,
                                 mesh.coords_of(self.dp, j))
                   for j in range(self.n_dp)] if on else [g] * self.n_dp)
        acc = COLL.reduce_scatter_over(chunks, mesh, self.dp, torch.float32)
        return (acc / self.n_dp).to(g.dtype)

    def zero1_slices(self, grads: Params) -> Params:
        """This rank's ZeRO-1 slice of every gradient (no reduction)."""
        return tree_map_with_path(
            lambda k, g: SH.shard_leaf(g, self.zspecs[k], self.mesh,
                                       self.cut[k]), grads)

    def gather_grads(self, slices: Params) -> Params:
        """The whole gradients from every rank's slices (experts too)."""
        return tree_map_with_path(
            lambda k, g: SH.gather_leaf(g, self.zspecs[k], self.mesh),
            slices)

    def gathered(self, params: Params) -> Params:
        """The params this rank computes with: every leaf gathered, but
        its experts and tensor-parallel leaves only along ``data``."""
        return tree_map_with_path(
            lambda k, x: SH.gather_leaf(
                x, self.pspecs[k], self.mesh,
                _compute_axes(k, self.pspecs[k], self.local)), params)

    def rank_value_and_grad(self, params: Params, batch: Dict
                            ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
        """``value_and_grad`` of this rank's rows from its stored shards,
        under the mesh's context (its tensor-parallel leaves, the
        activation mode): the gradients of the params it computes with
        (``gathered``), not yet reduced over the mesh."""
        with set_mesh(self.mesh, activation_mode=self.opts.activation_mode,
                      tp=self.tp):
            return value_and_grad(self.cfg, self.opts, self.gathered(params),
                                  batch)

    def grads(self, state: Dict, batch: Dict
              ) -> Tuple[torch.Tensor, torch.Tensor, Params, Dict]:
        """(total, ce, gradient slices, new residuals or {}): the mesh's
        means, each rank's ZeRO-1 slices of the gradients."""
        total, ce, grads = self.rank_value_and_grad(state["params"], batch)
        extra = {}
        if self.opts.grad_compression:
            grads, extra["ef_residual"] = compressed_allreduce(
                grads, state["ef_residual"], axis_name=self.dp,
                mesh=self.mesh)
            grads = self.zero1_slices(grads)
        else:
            grads = tree_map_with_path(self._slice_mean, grads)
        return self._mean(total), self._mean(ce), grads, extra

    def global_norm(self, slices: Params) -> torch.Tensor:
        """``optim.global_norm`` of the whole gradients from the slices:
        the slices' sums of squares all-gathered over the mesh, each
        leaf's added in rank order over the ranks that hold its distinct
        slices, the leaves in the reference's order."""
        leaves = leaf_paths(slices)
        sq = torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                          for _, g in leaves])
        parts = COLL.all_gather_shards(sq, self.mesh, self.mesh.axis_names)
        total = 0
        for i, (k, _) in enumerate(leaves):
            held = self.holders[k]
            leaf = parts[held[0]][i]
            for r in held[1:]:
                leaf = leaf + parts[r][i]
            total = total + leaf
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))

    def apply(self, state: Dict, slices: Params
              ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """The clip on the whole gradients' norm, then AdamW on this
        rank's ZeRO-1 slices; the params' slices gathered back over
        ``data``."""
        mesh = self.mesh
        gnorm = self.global_norm(slices)
        if self.clip is not None:
            scale = torch.clamp(self.clip / (gnorm + 1e-9), max=1.0)
            slices = tree_map(lambda g: g * scale, slices)
        p_sl = tree_map_with_path(
            lambda k, p: SH.shard_leaf(p, self.delta[k], mesh),
            state["params"])
        new_sl, new_opt, metrics = adamw_update(slices, state["opt"], p_sl,
                                                self.opt_cfg)
        new_params = tree_map_with_path(
            lambda k, p: SH.gather_leaf(p, self.delta[k], mesh), new_sl)
        return ({"params": new_params, "opt": new_opt},
                {"grad_norm": gnorm, "lr": metrics["lr"]})

    def __call__(self, state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        with deterministic(state["step"].device):
            total, ce, grads, extra = self.grads(state, batch)
            upd, metrics = self.apply(state, grads)
        new_state = {"step": state["step"] + 1, **extra, **upd}
        return new_state, {"loss": ce, "total_loss": total, **metrics}


def cache_layout(cfg: ArchConfig, mesh: ProcessMesh,
                 batch: Dict[str, Any]) -> Any:
    """The reference's specs of the whole caches that a prefill of the
    global ``batch`` (``{"tokens", ["frames" | "patches"]}``) builds and
    the decode steps after it carry (``sharding.cache_shardings``): the
    batch over the data axes, the sequence of ``k``/``v``/``ck``/``cv``
    and their int8 scales over ``model`` from 1024 slots that split."""
    B, S = batch["tokens"].shape
    if "patches" in batch:                 # a prefix-LM's image tokens
        S += batch["patches"].shape[1]
    whole = T.init_caches(cfg, B, S + cfg.decode_margin, "meta")
    return SH.cache_shardings(whole, mesh)


@contextlib.contextmanager
def serve_mesh(cfg: ArchConfig, mesh: Optional[ProcessMesh],
               layout: Any = None) -> Iterator[None]:
    """The serve steps' context: ``mesh`` active with its tensor-parallel
    leaves (``_tp_paths``, the train step's) and the caches' specs
    ``layout`` (``cache_layout``).  ``T.ffn_modules`` of a rank's
    ``compute_params`` built inside it hold their shards.  None: no
    mesh."""
    with set_mesh(mesh, **_serve_context(cfg, mesh, layout)):
        yield


def _serve_context(cfg: ArchConfig, mesh: Optional[ProcessMesh],
                   layout: Any) -> Dict[str, Any]:
    """``set_mesh``'s tensor-parallel leaves and caches' specs of a serve
    step (none without a mesh)."""
    if mesh is None:
        return {}
    pspecs = train_state_shardings(cfg, mesh)["params"]
    return {"tp": _tp_paths(cfg, mesh, pspecs),
            "caches": None if layout is None else dict(leaf_paths(layout))}


def make_prefill_step(cfg: ArchConfig, *, ffns: Ffns = None,
                      enc_ffns: Ffns = None,
                      mesh: Optional[ProcessMesh] = None
                      ) -> Callable[[Params, Dict], Tuple[torch.Tensor, Any]]:
    """``step(params, {"tokens", ["frames" | "patches"]})`` -> ((B, 1)
    int32 greedy token, caches of the prompt + ``cfg.decode_margin``).

    With ``mesh`` (the reference's ``jitted_serve_step``): the params are
    a rank's ``compute_params`` (``ffns`` built from them inside
    ``serve_mesh``), the batch is the global one, of which the step takes
    the rank's rows (``local_batch``); it returns the rank's greedy tokens
    and its pieces of the caches in ``cache_layout(cfg, mesh, batch)``."""
    def prefill_step(params: Params, batch: Dict) -> Tuple[torch.Tensor, Any]:
        layout = None
        if mesh is not None:
            layout = cache_layout(cfg, mesh, batch)
            batch = local_batch(batch, mesh)
        kw = {k: batch[k] for k in MODALITIES if k in batch}
        with torch.no_grad(), serve_mesh(cfg, mesh, layout):
            logits, caches = T.prefill(params, cfg, batch["tokens"],
                                       ffns=ffns, enc_ffns=enc_ffns, **kw)
            return T.greedy_token(logits, cfg), caches

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, ffns: Ffns = None,
                     mesh: Optional[ProcessMesh] = None, layout: Any = None
                     ) -> Callable[[Params, Dict], Tuple[torch.Tensor, Any]]:
    """``step(params, {"token": (B, 1), "caches"})`` -> (next greedy
    token, caches); the input caches are left as they were.  With
    ``mesh``: the params as ``make_prefill_step``'s, the token and caches
    the rank's (its prefill's outputs), ``layout`` the caches' specs
    (``cache_layout`` of the prefill's batch; needed on more than one
    ``model`` rank)."""
    if (mesh is not None and mesh.axis_size("model") > 1
            and layout is None):
        raise ValueError("a decode step on more than one model rank needs "
                         "its caches' layout (cache_layout)")

    context = _serve_context(cfg, mesh, layout)

    def decode_step(params: Params, batch: Dict) -> Tuple[torch.Tensor, Any]:
        with torch.no_grad(), set_mesh(mesh, **context):
            logits, caches = T.decode_step(params, cfg, batch["token"],
                                           batch["caches"], ffns=ffns)
            return T.greedy_token(logits, cfg), caches

    return decode_step


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(
        description="A prefill step and greedy decode steps of a zoo arch "
                    "on seeded inputs (launch/steps)")
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"],
                    help="smoke: the arch's reduce()d width; full: the "
                         "registry's")
    ap.add_argument("--ffn", default=None,
                    help="override ffn_kind (kan: the reference's KAN "
                         "drop-in)")
    ap.add_argument("--pattern", type=float, default=None,
                    help="stage-2 pattern sparsity rate of the FFNs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels; refused without CUDA) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.scale == "smoke":
        cfg = cfg.reduce()
    over = {"ffn_kind": args.ffn, "pattern_rate": args.pattern}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in over.items()
                                      if v is not None})
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = T.init_params(cfg, gen, device)
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32),
        device=device)}
    if cfg.frontend is not None:
        stub = 0.1 * torch.randn(
            (BATCH, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
            device=device)
        batch["frames" if cfg.enc_dec else "patches"] = stub.to(
            cfg.param_dtype)
    ffns = T.ffn_modules(params, cfg)
    enc = T.encoder_ffn_modules(params, cfg) if cfg.enc_dec else None
    prefill = make_prefill_step(cfg, ffns=ffns, enc_ffns=enc)
    decode = make_decode_step(cfg, ffns=ffns)
    launches = dict(_build.LAUNCHES)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    tok, caches = prefill(params, batch)
    sync()
    t1 = time.perf_counter()
    toks = [tok]
    for _ in range(NEW_TOKENS):
        tok, caches = decode(params, {"token": tok, "caches": caches})
        toks.append(tok)
    sync()
    t2 = time.perf_counter()
    out = {"tokens": torch.cat(toks, dim=1).cpu().tolist(),
           "prefill_ms": (t1 - t0) * 1e3,
           "decode_ms": (t2 - t1) * 1e3 / NEW_TOKENS,
           "launches": {k: v - launches[k] for k, v in _build.LAUNCHES.items()
                        if v != launches[k]}}
    stub_text = "".join(f" + {k} {tuple(v.shape)}" for k, v in batch.items()
                        if k in MODALITIES)
    print(f"{cfg.name} ({cfg.dtype}, ffn {cfg.ffn_kind}) on {device}: a "
          f"prefill step of {BATCH} x {PROMPT} tokens{stub_text} "
          f"in {out['prefill_ms']:.1f} ms, {NEW_TOKENS} decode steps "
          f"at {out['decode_ms']:.1f} ms each; kernel launches "
          f"{out['launches']}")
    for i, row in enumerate(out["tokens"]):
        print(f"request {i}: {row}")
    return out


if __name__ == "__main__":
    main()
