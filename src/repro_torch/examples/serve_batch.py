"""Batched serving demo: slot-based continuous batching with KV caches.

Counterpart of ``examples/serve_batch.py``.  A burst of requests with
different prompt lengths goes to ``runtime/server.Server``: the engine
admits them into free cache slots, decodes one token a tick for every
active slot in one batched step, and recycles slots as requests finish.
The model is ``qwen2-0.5b`` cut to 4 layers, 128 wide, weights from seed
0.  Then the same engine serves a VIKIN stack (``vikin-mixed``) through
``VikinBackend``: one-shot KAN/MLP inference through the fused kernels,
with simulated VIKIN cycles next to the host clock.

Run (from the repository root, with ``PYTHONPATH=src``; on the card by
default)::

    python -m repro_torch.examples.serve_batch [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.models import transformer as T
from repro_torch.models.ffn import vikin_stack_init
from repro_torch.runtime.backends import VikinBackend
from repro_torch.runtime.server import Engine, Server


def transformer_demo(device: str) -> None:
    cfg = get_config("qwen2-0.5b").reduce(n_layers=4, d_model=128,
                                          d_ff=256, vocab_size=512)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    srv = Server(cfg, params, n_slots=4, max_len=128, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12, 3, 9, 7, 15)]   # 6 requests, 4 slots
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=12) for p in prompts]
    out = srv.run_until_done()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in out.values())
    for rid, p in zip(rids, prompts):
        print(f"req {rid}: prompt[{len(p):2d}] -> {out[rid]}")
    print(f"\n{len(prompts)} requests over 4 slots, {total_tokens} tokens "
          f"in {dt:.2f} s ({total_tokens / dt:.1f} tok/s on "
          f"{srv.backend.device})")


def vikin_demo(device: str) -> None:
    """Same engine, another backend: one-shot KAN/MLP inference through
    the fused kernels, simulated VIKIN cycles beside the host clock."""
    model = VIKIN_ARCHS["vikin-mixed"]
    params = vikin_stack_init(model, torch.Generator().manual_seed(0))
    eng = Engine(VikinBackend(model, params, device=device), n_slots=4)
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.random(model.sizes[0], dtype=np.float32))
            for _ in range(6)]
    out = eng.run_until_done()
    s = eng.stats
    print(f"\nvikin-mixed: {len(rids)} requests in {int(s['ticks'])} "
          f"batches, {s['sim_cycles']:.0f} simulated cycles "
          f"({int(s['mode_switches'])} mode switches); "
          f"out[0] mean={float(out[rids[0]].mean()):+.4f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    args = ap.parse_args()
    transformer_demo(args.device)
    vikin_demo(args.device)


if __name__ == "__main__":
    main()
