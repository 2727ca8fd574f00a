"""The serve steps: a prefill step and a decode step, each returning
(greedy token, caches).

Counterpart of the serving half of ``repro/launch/steps.py``, with no
``mesh`` argument: one card runs the step whole.  The steps reach every
arch of the zoo, the encoder-decoder and frontend ones too (a batch
carries ``frames`` or ``patches`` beside its tokens), which token-only
serving (``runtime/server.Server``) refuses, as the reference's does.
``ffns`` (``models/transformer.ffn_modules``) and ``enc_ffns``
(``encoder_ffn_modules``) hold the KAN FFNs' weights fused once; without
them each step rebuilds them, with the same bits.  A step runs without
autograd (the bf16 kernels refuse a gradient).

Run a prefill step and decode steps of any arch on seeded tokens (and
seeded ``0.1 * N(0, 1)`` frames or patches in the params' dtype):

  PYTHONPATH=src python -m repro_torch.launch.steps --arch whisper-medium \
      --ffn kan --pattern 0.5 --device cpu      # reduce()d (--scale smoke)
  PYTHONPATH=src python -m repro_torch.launch.steps --arch paligemma-3b \
      --scale full                              # on the card, bf16

A run is ``BATCH`` requests of ``PROMPT`` tokens, then ``NEW_TOKENS``
decode steps, drawn from seed ``SEED``.  The reference's train step and
its options (``StepOptions``, ``default_opt_cfg``, ``_split_batch``,
``init_train_state``, ``make_train_step``) wait for LM training, and its
sharding wrappers (``train_state_shardings``, ``jitted_*``,
``lower_cell``) for the multi-card plans (``ROADMAP.md``, queue 1, items
4-5).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import _build
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Ffns
from repro_torch.utils import resolve_device

Params = Any
MODALITIES = ("frames", "patches")
BATCH, PROMPT, NEW_TOKENS, SEED = 2, 8, 4, 0


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
