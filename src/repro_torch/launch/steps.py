"""Train and serve steps: the LM train step with its options and state,
and a prefill step and a decode step, each returning (greedy token,
caches).

Counterpart of ``repro/launch/steps.py``, with no ``mesh`` argument: one
card runs a step whole.  The train step (``make_train_step``) runs
``T.forward`` with no held ``ffns`` -- the weights change every step, so
the KAN FFNs fuse their weights inside autograd -- then ``T.lm_loss`` +
``aux_weight * aux``, the gradients (autograd through the kernels'
Functions, ``kernels/grad.py``), optional int8 error-feedback
compression (``optim/compression``) and ``adamw_update`` at the
reference's cosine schedule.  On a CUDA device it runs under
``torch.use_deterministic_algorithms(True)`` (no NaN fill of
``torch.empty``), so two runs of a step give the same bits.  The
reference's ``remat`` and ``scan_layers`` change no number and are not
read; its ``activation_mode`` only names a sharding constraint and waits
with the sharding wrappers (``train_state_shardings``, ``jitted_*``,
``lower_cell``) for the multi-card plans (``ROADMAP.md``, queue 1, item
4).

The serve steps reach every arch of the zoo, the encoder-decoder and
frontend ones too (a batch carries ``frames`` or ``patches`` beside its
tokens), which token-only serving (``runtime/server.Server``) refuses,
as the reference's does.  ``ffns`` (``models/transformer.ffn_modules``)
and ``enc_ffns`` (``encoder_ffn_modules``) hold the KAN FFNs' weights
fused once; without them each step rebuilds them, with the same bits.  A
serve step runs without autograd.

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
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.deterministic as torch_det

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import _build
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Ffns
from repro_torch.optim import (
    AdamWConfig,
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
    # int8 error-feedback gradient compression (optim/compression.py)
    grad_compression: bool = False


def default_opt_cfg(opts: StepOptions) -> AdamWConfig:
    return AdamWConfig(lr=cosine_schedule(opts.lr, opts.total_steps,
                                          opts.warmup))


def init_train_state(cfg: ArchConfig, opts: StepOptions = StepOptions(),
                     generator: Optional[torch.Generator] = None,
                     device: torch.device | str = "cpu", *,
                     params: Optional[Params] = None) -> Dict[str, Any]:
    """``{"params", "opt", "step"}`` (+ ``"ef_residual"`` under
    ``grad_compression``) on ``device``: params drawn from ``generator``
    (``T.init_params``), or ``params`` carried over (e.g. the reference's,
    ``convert.transformer_params_from_jax``), each leaf copied."""
    if params is None:
        params = T.init_params(cfg, generator, device)
    else:
        params = tree_map(lambda a: a.detach().to(device, copy=True), params)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if opts.grad_compression:
        state["ef_residual"] = init_compression(params)
    return state


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


def make_train_step(cfg: ArchConfig, opts: StepOptions = StepOptions()
                    ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """``step(state, batch) -> (new state, metrics)``: metrics ``loss``
    (cross-entropy), ``total_loss`` (+ ``aux_weight * aux``),
    ``grad_norm`` (before the clip) and ``lr``, 0-d tensors on the
    state's device; the input state is left as it was."""
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


def make_prefill_step(cfg: ArchConfig, *, ffns: Ffns = None,
                      enc_ffns: Ffns = None
                      ) -> Callable[[Params, Dict], Tuple[torch.Tensor, Any]]:
    """``step(params, {"tokens", ["frames" | "patches"]})`` -> ((B, 1)
    int32 greedy token, caches of the prompt + ``cfg.decode_margin``)."""
    def prefill_step(params: Params, batch: Dict) -> Tuple[torch.Tensor, Any]:
        kw = {k: batch[k] for k in MODALITIES if k in batch}
        with torch.no_grad():
            logits, caches = T.prefill(params, cfg, batch["tokens"],
                                       ffns=ffns, enc_ffns=enc_ffns, **kw)
            return T.greedy_token(logits), caches

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, ffns: Ffns = None
                     ) -> Callable[[Params, Dict], Tuple[torch.Tensor, Any]]:
    """``step(params, {"token": (B, 1), "caches"})`` -> (next greedy
    token, caches); the input caches are left as they were."""
    def decode_step(params: Params, batch: Dict) -> Tuple[torch.Tensor, Any]:
        with torch.no_grad():
            logits, caches = T.decode_step(params, cfg, batch["token"],
                                           batch["caches"], ffns=ffns)
            return T.greedy_token(logits), caches

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
