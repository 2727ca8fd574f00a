"""Kernel bench of the PyTorch/CUDA port: agreement, counts and card times.

Counterpart of ``benchmarks/kernel_bench.py``, with the same sections:

* ``spline_basis`` -- the spline-basis kernels at G4K3, G16K3 and G8K2
  on n = 4096 inputs, f32 and bf16 (rows ``*_bfloat16``): the error
  against the plain version (bitwise on the card) and the dense f32
  oracle (1e-4 in f32, 2e-2 in bf16), the SPU and dense op counts per
  input, bytes in and out, and the time on the card;
* ``kan_fused`` -- the v1 and v2 KAN kernels at 256x72->96 (no mask and
  ``(1,0,1,0)``) and 256x128->128 ``(1,0,0,0)``, in f32 and, as the JAX
  bench's ``*_bfloat16`` rows, in bf16: each against its plain version,
  v1 against v2, v2 against ``kan_reference_dense``, the contraction
  sizes, weight bytes and both times.  The bf16 rows hold the JAX
  bench's bars: the f32 accumulator (``out_dtype=f32``) within 1e-4 of
  the plain version, and within 5e-2 of the dense f32 oracle; their
  times are of the served form, bf16 out;
* ``pattern_matmul`` -- the compacted matmul at rates 0, 0.5 and 0.75 on
  128x512->256 against the dense masked oracle;
* ``tuning`` -- a ``tune_spline_basis`` search (``block_n``, inputs a
  block), a ``tune_pattern_matmul``
  search (8192x72->304 relu, vikin-mixed's first layer at a large batch)
  and two ``tune_kan_fused`` searches (8x304->32, vikin-mixed's KAN layer
  at the served bucket 8), of the version-2 and of the version-1 kernel,
  each round-tripped through a fresh
  ``AutotuneCache`` on a temporary file, and each tuned knob shown to
  change no bit of the result.

Run (from the repository root, with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.kernel_bench [--device cpu] [--out PATH]

On the card (the default) every kernel is launched, and every ``ms`` is
device time (calls replayed from a CUDA graph).  On the CPU the wrappers
run the plain versions, so the run checks the sweep, the oracle
agreement and the counts, and times nothing: every ``ms`` is null.  The
bench asserts its tolerances as the JAX bench does, so a non-zero exit is
a fault.  It writes JSON to ``--out`` (``chiprun_out/kernel_bench.json``
at the repository root by default), never to ``BENCH_kernels.json`` or
``experiments/``.

Left out: the JAX field ``mxu_dispatches_per_step`` counts ``dot_general``
calls in a TPU jaxpr; the CUDA kernels issue no MXU contractions and
PyTorch traces no jaxpr, so it has no counterpart on the card.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.kan import KANConfig, kan_init, kan_reference_dense
from repro_torch.core.sparsity import sparsity_to_pattern, tiled_mask
from repro_torch.core.splines import (
    SplineSpec,
    dense_eval_op_count,
    spu_op_count,
)
from repro_torch.kernels import autotune
from repro_torch.kernels.kan_fused import ops as kan_ops
from repro_torch.kernels.kan_fused.ops import (
    flatten_t,
    fuse_wt,
    kan_fused_v1,
    kan_fused_v2,
    slot_table,
)
from repro_torch.kernels.kan_fused.ref import (
    kan_fused_v1_ref,
    kan_fused_v2_ref,
)
from repro_torch.kernels.pattern_matmul.ops import (
    default_blocks,
    matmul_compact,
)
from repro_torch.kernels.pattern_matmul.ref import pattern_matmul_ref
from repro_torch.kernels.spline_basis.ops import (
    DEFAULT_BLOCK_N,
    spline_basis,
)
from repro_torch.kernels.spline_basis.ref import (
    spline_basis_plain,
    spline_basis_ref,
)
from repro_torch.utils import resolve_device

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT = ROOT / "chiprun_out" / "kernel_bench.json"
SCHEMA = 1


def _check(cond: bool, *what: object) -> None:
    """The bench's asserts: raise (also under ``python -O``)."""
    if not cond:
        raise AssertionError(f"kernel_bench: {what}")


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())


def _time_ms(fn: Callable[[], object], dev: torch.device, iters: int = 20,
             reps: int = 5) -> Optional[float]:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    after a warm-up call, each replay timed by CUDA events, the median of
    ``reps`` replays over ``iters``.  The host's launch overhead, which
    paces back-to-back calls of a small kernel, drops out.  None off the
    card (nothing measured)."""
    if dev.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bench_spline_basis(dev: torch.device) -> Dict:
    out = {}
    for (g, k), dtype in itertools.product(((4, 3), (16, 3), (8, 2)),
                                           (torch.float32, torch.bfloat16)):
        spec = SplineSpec(g, k)
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            -0.99, 0.99, 4096).astype(np.float32)).to(dev, dtype)
        got = spline_basis(x, spec)
        plain = spline_basis_plain(x, spec)
        err_ref = _max_abs(got, spline_basis_ref(x.to(torch.float32), spec))
        bf16 = dtype == torch.bfloat16
        out[f"G{g}K{k}" + ("_bfloat16" if bf16 else "")] = {
            "max_err": err_ref,
            "max_err_plain": _max_abs(got, plain),
            "bitwise_plain": bool(torch.equal(got, plain)),
            "ms": _time_ms(lambda: spline_basis(x, spec), dev),
            "spu_ops_per_input": spu_op_count(spec),
            "dense_ops_per_input": dense_eval_op_count(spec),
            "zero_free_saving": 1 - spu_op_count(spec)
            / dense_eval_op_count(spec),
            "bytes_in": x.numel() * x.element_size(),
            "bytes_out": x.numel() * spec.n_bases * x.element_size(),
        }
        _check(torch.equal(got, plain), g, k, dtype, "kernel != plain")
        _check(err_ref < (2e-2 if bf16 else 1e-4), g, k, dtype, err_ref)
    return out


def bench_kan_fused(dev: torch.device) -> Dict:
    """v1 and v2 at the JAX bench's shapes and dtypes: in f32 each within
    1e-4 of its plain version, of the other and of the dense oracle; in
    bf16 the f32 accumulator (``out_dtype=f32``) within 1e-4 of the plain
    versions and of the other version, and within 5e-2 of the dense f32
    oracle, as the JAX bench holds its bf16 rows."""
    out = {}
    B = 256
    spec = SplineSpec(4, 3)
    for (n_in, n_out, pat), dtype in itertools.product(
            ((72, 96, None), (72, 96, (1, 0, 1, 0)),
             (128, 128, (1, 0, 0, 0))), (torch.float32, torch.bfloat16)):
        cfg = KANConfig(n_in, n_out, spec, pattern=pat)
        params = {k: v.to(dev, dtype) for k, v in kan_init(
            cfg, torch.Generator().manual_seed(0)).items()}
        x = torch.randn((B, n_in), generator=torch.Generator().manual_seed(
            1)).to(dev, dtype)
        f32 = torch.float32
        kb = cfg.kb if cfg.kb is not None else tuple(range(spec.n_bases))
        nbk = len(kb)
        w_b = params["w_b"]
        t_flat = flatten_t(params["t"], cfg.kb).contiguous()
        wt = fuse_wt(w_b, t_flat, nbk)
        # built once, outside the timed (graph-captured) calls
        slot = slot_table(kb, spec.n_bases, dev)
        # the f32 accumulator: out_dtype=f32 (a no-op in f32)
        v1 = kan_fused_v1(x, w_b, t_flat, spec, kb, slot, out_dtype=f32)
        v2 = kan_fused_v2(x, wt, spec, kb, slot, out_dtype=f32)
        dense = kan_reference_dense(
            {k: v.to(f32) for k, v in params.items()}, x.to(f32), cfg)
        errs = {
            "max_err_v1": _max_abs(v1, kan_fused_v1_ref(
                x, w_b, t_flat, spec, kb, f32)),
            "max_err_v2": _max_abs(v2, kan_fused_v2_ref(x, wt, spec, kb,
                                                        f32)),
            "max_err_v1_v2": _max_abs(v1, v2),
            "max_err_dense_ref": _max_abs(v2, dense),
        }
        key = (f"{n_in}x{n_out}" + (f"_p{pat.count(0) * 25}" if pat else "")
               + "_" + str(dtype).removeprefix("torch."))
        out[key] = {
            **errs,
            "max_err": errs["max_err_v2"],
            "contraction_full": n_in * spec.n_bases,
            "contraction_kept": n_in * nbk,
            "contraction_fused_v2": n_in * (nbk + 1),
            "basis_saving": 1 - nbk / spec.n_bases,
            "bytes_weights_v1": (w_b.numel() + t_flat.numel())
            * wt.element_size(),
            "bytes_weights_v2": wt.numel() * wt.element_size(),
            "bytes_act_in": x.numel() * x.element_size(),
            "ms_v1": _time_ms(
                lambda: kan_fused_v1(x, w_b, t_flat, spec, kb, slot), dev),
            "ms_v2": _time_ms(
                lambda: kan_fused_v2(x, wt, spec, kb, slot), dev),
        }
        for name, err in errs.items():
            tol = (5e-2 if name == "max_err_dense_ref" and dtype != f32
                   else 1e-4)
            _check(err <= tol, key, name, err)
    return out


def bench_pattern_matmul(dev: torch.device) -> Dict:
    out = {}
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((128, 512), generator=gen).to(dev)
    w = torch.randn((512, 256), generator=gen).to(dev)
    for rate in (0.0, 0.5, 0.75):
        mask = tiled_mask(512, sparsity_to_pattern(rate))
        idx = torch.as_tensor(mask.indices(), dtype=torch.long, device=dev)
        xc = x.index_select(1, idx).contiguous()
        wc = w.index_select(0, idx).contiguous()
        err = _max_abs(matmul_compact(xc, wc), pattern_matmul_ref(x, w, mask))
        out[f"rate{rate}"] = {
            "max_err": err,
            "k_dim": int(xc.shape[1]),
            "flop_saving": rate,
            "bytes_weights": wc.numel() * 4,
            "ms": _time_ms(lambda: matmul_compact(xc, wc), dev),
        }
        _check(err < 1e-2, rate, err)
    return out


def bench_tuning(dev: torch.device) -> Dict:
    """A ``tune_spline_basis`` search at vikin-mixed's KAN input (1024
    rows of 304 features, flattened) and a ``tune_pattern_matmul`` search
    at its first MLP layer (8192x72->304 relu), each in a temporary cache
    file reloaded by a fresh ``AutotuneCache``; the tuned knobs change no
    result.  Off the card the matmul search times the plain version once
    a candidate."""
    spec = SplineSpec(4, 3)
    n = 1024 * 304
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1.5, 1.5, n).astype(np.float32)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        cache = autotune.AutotuneCache(os.path.join(tmp, "autotune.json"))
        best = autotune.tune_spline_basis(x, spec, cache=cache)
        key = autotune.cache_key("spline_basis", (n, spec.n_bases),
                                 x.dtype, dev)
        fresh = autotune.AutotuneCache(cache.path)
        round_trip = fresh.lookup(key) == best
        hit = autotune.lookup_blocks("spline_basis", (n, spec.n_bases),
                                     x.dtype, dev, cache=fresh)
    _check(round_trip and hit == best, key, best, hit)
    _check(torch.equal(spline_basis(x, spec, block_n=best["block_n"]),
                       spline_basis(x, spec, block_n=DEFAULT_BLOCK_N)),
           "the tuned block_n changed the result")
    return {
        "n": n,
        "candidates": autotune.candidates_spline_basis(n, spec.n_bases),
        "tuned_blocks": best,
        "default_blocks": {"block_n": DEFAULT_BLOCK_N},
        "cache_key": key,
        "cache_round_trip": round_trip,
        "ms_default": _time_ms(
            lambda: spline_basis(x, spec, block_n=DEFAULT_BLOCK_N), dev),
        "ms_tuned": _time_ms(
            lambda: spline_basis(x, spec, block_n=best["block_n"]), dev),
        "pattern_matmul": bench_tuning_matmul(dev),
        "kan_fused": bench_tuning_kan(dev),
        "kan_fused_v1": bench_tuning_kan(dev, version=1),
    }


def bench_tuning_matmul(dev: torch.device) -> Dict:
    M, K, N = 8192, 72, 304
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((M, K), generator=gen).to(dev)
    w = (torch.randn((K, N), generator=gen) * 0.1).to(dev)
    b = torch.randn((N,), generator=gen).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        cache = autotune.AutotuneCache(os.path.join(tmp, "autotune.json"))
        best = autotune.tune_pattern_matmul(
            x, w, b, act="relu", reps=10 if dev.type == "cuda" else 1,
            cache=cache)
        key = autotune.cache_key("pattern_matmul", (M, K, N), x.dtype, dev)
        fresh = autotune.AutotuneCache(cache.path)
        round_trip = fresh.lookup(key) == best
        hit = autotune.lookup_blocks("pattern_matmul", (M, K, N), x.dtype,
                                     dev, cache=fresh)
    _check(round_trip and hit == best, key, best, hit)
    default = default_blocks(M, K, x.dtype)
    knob = {k: (v["bm"], v["bk"], v["bn"])
            for k, v in (("tuned", best), ("default", default))}
    _check(torch.equal(
        matmul_compact(x, w, b, "relu", blocks=knob["tuned"]),
        matmul_compact(x, w, b, "relu", blocks=knob["default"])),
        "the tuned (bm, bk, bn) changed the result")
    return {
        "shape": [M, K, N], "act": "relu",
        "candidates": len(autotune.candidates_pattern_matmul(M, K, N,
                                                             x.dtype)),
        "tuned_blocks": best,
        "default_blocks": default,
        "cache_key": key,
        "cache_round_trip": round_trip,
        "ms_default": _time_ms(
            lambda: matmul_compact(x, w, b, "relu", blocks=knob["default"]),
            dev),
        "ms_tuned": _time_ms(
            lambda: matmul_compact(x, w, b, "relu", blocks=knob["tuned"]),
            dev),
    }


def bench_tuning_kan(dev: torch.device, version: int = 2) -> Dict:
    """A ``tune_kan_fused`` search of the version-2 (fused ``wt``) or the
    version-1 (``w_b`` and ``t_flat``) kernel at 8x304->32, round-tripped
    through a temporary cache; the tuned knob changes no bit."""
    B, n_in, n_out, kb = 8, 304, 32, (0, 2, 4, 5, 6)
    nbk = len(kb)
    spec = SplineSpec(4, 3)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((B, n_in), generator=gen).to(dev)
    wt = (torch.randn((n_in * (nbk + 1), n_out), generator=gen)
          * 0.05).to(dev)
    slot = slot_table(kb, spec.n_bases, dev)
    dims = (B, n_in, n_out, nbk)
    kernel = f"kan_fused_v{version}"
    if version == 1:
        w3 = wt.reshape(n_in, nbk + 1, n_out)
        w_b = w3[:, 0].contiguous()
        t_flat = w3[:, 1:].reshape(n_in * nbk, n_out).contiguous()
        weights, extra = w_b, {"t_flat": t_flat}

        def run(knob):
            return kan_fused_v1(x, w_b, t_flat, spec, kb, slot, blocks=knob)
    else:
        weights, extra = wt, {}

        def run(knob):
            return kan_fused_v2(x, wt, spec, kb, slot, blocks=knob)
    with tempfile.TemporaryDirectory() as tmp:
        cache = autotune.AutotuneCache(os.path.join(tmp, "autotune.json"))
        best = autotune.tune_kan_fused(
            x, weights, spec, kb, version=version,
            reps=10 if dev.type == "cuda" else 1, cache=cache, **extra)
        key = autotune.cache_key(kernel, dims, x.dtype, dev)
        fresh = autotune.AutotuneCache(cache.path)
        round_trip = fresh.lookup(key) == best
        hit = autotune.lookup_blocks(kernel, dims, x.dtype, dev,
                                     cache=fresh)
    _check(round_trip and hit == best, key, best, hit)
    default = kan_ops.default_blocks(*dims, x.dtype, version)
    knob = {k: (v["bm"], v["bi"], v["bn"])
            for k, v in (("tuned", best), ("default", default))}
    _check(torch.equal(run(knob["tuned"]), run(knob["default"])),
           f"the tuned (bm, bi, bn) of {kernel} changed the result")
    return {
        "shape": [B, n_in, n_out], "kb": list(kb), "version": version,
        "candidates": len(autotune.candidates_kan_fused(*dims, x.dtype,
                                                        version)),
        "tuned_blocks": best,
        "default_blocks": default,
        "cache_key": key,
        "cache_round_trip": round_trip,
        "ms_default": _time_ms(lambda: run(knob["default"]), dev),
        "ms_tuned": _time_ms(lambda: run(knob["tuned"]), dev),
    }


def run(device: str = "cuda", out: Optional[str | Path] = None) -> Dict:
    """Run every section on ``device``, write the JSON to ``out`` (default
    ``DEFAULT_OUT``) and return it; raises on any fault."""
    dev = resolve_device(device)
    # the plain versions run torch.matmul on the card: hold them to IEEE
    # f32, as the kernels are (and a bf16 product to f32 accumulation)
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        results = {
            "schema": SCHEMA,
            "device": autotune.device_tag(dev),
            "torch": torch.__version__,
            "spline_basis": bench_spline_basis(dev),
            "kan_fused": bench_kan_fused(dev),
            "pattern_matmul": bench_pattern_matmul(dev),
            "tuning": bench_tuning(dev),
        }
    finally:
        (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved
    path = Path(out) if out is not None else DEFAULT_OUT
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1))
    for section in ("spline_basis", "kan_fused", "pattern_matmul"):
        for case, r in results[section].items():
            ms = {k: v for k, v in r.items() if k.startswith("ms")}
            print(f"{section:15s} {case:20s} max_err={r['max_err']:.2e} "
                  f"{ms}", flush=True)
    t = results["tuning"]
    print(f"{'tuning':15s} n={t['n']} tuned={t['tuned_blocks']} "
          f"round_trip={t['cache_round_trip']}", flush=True)
    tm = t["pattern_matmul"]
    print(f"{'tuning':15s} matmul {tm['shape']} tuned={tm['tuned_blocks']} "
          f"round_trip={tm['cache_round_trip']} ms default/tuned "
          f"{tm['ms_default']}/{tm['ms_tuned']}", flush=True)
    for tk in (t["kan_fused"], t["kan_fused_v1"]):
        print(f"{'tuning':15s} kan v{tk['version']} {tk['shape']} tuned="
              f"{tk['tuned_blocks']} round_trip={tk['cache_round_trip']} "
              f"ms default/tuned {tk['ms_default']}/{tk['ms_tuned']}",
              flush=True)
    print(f"wrote {path} ({results['device']})", flush=True)
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: launch the kernels) or cpu (the "
                         "plain versions, nothing timed)")
    ap.add_argument("--out", default=None,
                    help=f"JSON output path (default {DEFAULT_OUT})")
    args = ap.parse_args()
    run(args.device, args.out)


if __name__ == "__main__":
    main()
