"""Table II on the port: the overall single-instance VIKIN evaluation.

Counterpart of ``benchmarks/table2_overall.py``.  Deployment per the
paper: KAN-2 at 50% pattern sparsity, MLP-3 at 25%, FP16 (proxied by a
bf16 round trip of the params, as the reference does), against the
analytical Jetson Xavier NX model ``core/engine.EdgeGPU`` (21 TOPS peak;
DESIGN.md Sec. 8 documents its assumptions).

Reported per model: the accuracy change from mask and cast, the VIKIN
cycle model's latency, throughput and energy efficiency, and the ratios
to the edge GPU.  Cycles, latencies and GOPS/W are model outputs (of the
cycle model and of ``EdgeGPU``), not times measured on any device; the
training and evaluation run on ``--device``.

Run (from the repository root, with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.table2_overall [--epochs N] \\
        [--device cpu] [--out-dir DIR]

It reads (or first trains) Table I's weights from ``--out-dir`` and
writes ``table2.json`` there.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.benchmarks.table1_models import (
    DEFAULT_OUT_DIR,
    Params,
    apply_model,
    ensure_trained,
    load_trained,
    out_path,
    to_device,
    train_step,
)
from repro_torch.core.engine import (
    EdgeGPU,
    VikinHW,
    kan_layers,
    mlp_layers,
    run_model,
)
from repro_torch.core.sparsity import magnitude_mask
from repro_torch.core.splines import SplineSpec
from repro_torch.data.traffic import (
    TrafficConfig,
    batches,
    load_traffic,
    mse,
    rse,
)
from repro_torch.optim import AdamWConfig, adamw_init, constant_schedule
from repro_torch.utils import host_f32, resolve_device

DEPLOY = {"kan-2layer": 0.5, "mlp-3layer": 0.25}


def _build_masks(cfg, params: Params,
                 rate: float) -> List[Optional[torch.Tensor]]:
    """Magnitude m-of-4 masks per layer (None where not applicable), as
    f32 tensors on the params' device; the saliencies are summed in host
    f32, as the reference sums them."""
    keep = int(round(4 * (1 - rate)))
    masks: List[Optional[torch.Tensor]] = []
    if cfg.kind == "kan":
        for p in params:
            t = host_f32(p["t"])                   # (n_in, nb, n_out)
            sal = np.abs(t).sum(-1).reshape(-1)    # (n_in*nb,)
            m = magnitude_mask(sal, keep).keep.reshape(t.shape[:2])
            masks.append(torch.from_numpy(
                m[..., None].astype(np.float32)).to(p["t"].device))
    else:
        masks.append(None)                         # input layer unmasked
        for p in params[1:]:
            w = host_f32(p["w"])
            m = magnitude_mask(np.abs(w).sum(-1), keep).keep
            masks.append(torch.from_numpy(
                m[:, None].astype(np.float32)).to(p["w"].device))
    return masks


def _project(cfg, params: Params,
             masks: List[Optional[torch.Tensor]]) -> Params:
    out = []
    for p, m in zip(params, masks):
        p = dict(p)
        if m is not None:
            key = "t" if cfg.kind == "kan" else "w"
            p[key] = p[key] * m
        out.append(p)
    return out


def _masked_quantized_eval(name: str, rate: float, data,
                           ft_epochs: int = 20, *,
                           device: str | torch.device = "cuda",
                           out_dir: Optional[str | Path] = None
                           ) -> Dict[str, float]:
    """Paper protocol: the mask is defined DURING training ([23,24]), so
    after magnitude masking the model is fine-tuned with the mask
    projected back after every update (sparsity-aware training), then
    evaluated with its params rounded through bf16 (FP16 proxy), in f32
    through the same kernels.  Returns the test MSE and RSE."""
    dev = resolve_device(device)
    cfg, params = load_trained(name, out_dir)
    params = to_device(params, dev)
    masks = _build_masks(cfg, params, rate)
    params = _project(cfg, params, masks)

    opt_cfg = AdamWConfig(lr=constant_schedule(3e-4), weight_decay=0.0,
                          grad_clip_norm=None)
    state = adamw_init(params)
    for ep in range(ft_epochs):
        for xb, yb in batches(data["train_x"], data["train_y"], 512,
                              seed=777 + ep):
            params, state, _ = train_step(
                params, state, torch.from_numpy(xb).to(dev),
                torch.from_numpy(yb).to(dev), cfg, opt_cfg)
            params = _project(cfg, params, masks)   # keep masked-out at 0

    qparams = [{k: v.to(torch.bfloat16).to(torch.float32)
                for k, v in p.items()} for p in params]
    with torch.no_grad():
        pred, _ = apply_model(qparams, torch.from_numpy(data["test_x"]).to(
            dev), cfg)
    pred = pred.cpu().numpy().astype(np.float32)
    return {"mse": mse(pred, data["test_y"]),
            "rse": rse(pred, data["test_y"])}


def run(epochs: int = 100, data_cfg: TrafficConfig = TrafficConfig(), *,
        device: str | torch.device = "cuda",
        out_dir: Optional[str | Path] = None) -> Dict:
    """Table II from Table I's weights (trained on ``data_cfg`` first
    unless ``out_dir`` holds them from such a run); writes ``table2.json``.
    The cycle-model and ``EdgeGPU`` fields are model outputs from Table
    I's nnz rates, exact on any host."""
    t1 = ensure_trained(epochs, data_cfg=data_cfg, device=device,
                        out_dir=out_dir)
    data = load_traffic(data_cfg)
    hw, gpu = VikinHW(), EdgeGPU()
    spec = SplineSpec(4, 3)
    out = {}
    for name, rate in DEPLOY.items():
        if name.startswith("kan"):
            layers = kan_layers([72, 96], spec, pattern_rate=rate)
        else:
            nnz = [1.0] + t1[name]["nnz_rates"]
            layers = mlp_layers([72, 304, 96], nnz, pattern_rate=rate)
        rep = run_model(layers, hw)
        grep = gpu.report(layers)
        err = _masked_quantized_eval(name, rate, data, device=device,
                                     out_dir=out_dir)
        base_mse = t1[name]["mse"]
        out[name] = {
            "pattern_rate": rate,
            "mse": err["mse"],
            "mse_delta_pct": 100 * (err["mse"] / base_mse - 1),
            "rse": err["rse"],
            "latency_us": rep.latency_s * 1e6,
            "cycles": rep.cycles,
            "gops": rep.gops,
            "gops_per_w": rep.gops_per_w,
            "gpu_latency_us": grep["latency_s"] * 1e6,
            "speedup_vs_gpu": grep["latency_s"] / rep.latency_s,
            "energy_ratio_vs_gpu": rep.gops_per_w / grep["gops_per_w"],
        }
        o = out[name]
        print(f"{name:12s} lat {o['latency_us']:.2f}us "
              f"({o['cycles']:.0f} cyc) {o['gops_per_w']:.1f} GOPS/W  "
              f"vs GPU: {o['speedup_vs_gpu']:.2f}x speed, "
              f"{o['energy_ratio_vs_gpu']:.2f}x energy  "
              f"MSE +{o['mse_delta_pct']:.1f}% (cycle-model and EdgeGPU "
              f"outputs; MSE on {t1[name].get('device', 'unknown')})",
              flush=True)
    k, m = out["kan-2layer"], out["mlp-3layer"]
    print(f"KAN replaces MLP: {(1 - k['latency_us']/m['latency_us'])*100:.0f}%"
          f" latency reduction (paper 22%); paper points: 1.25x/4.87x KAN, "
          f"0.72x/2.20x MLP")
    path = out_path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    (path / "table2.json").write_text(json.dumps(out, indent=1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=100,
                    help="Table I epochs, if its weights must be trained")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    ap.add_argument("--out-dir", default=None,
                    help=f"output directory (default {DEFAULT_OUT_DIR})")
    args = ap.parse_args()
    run(args.epochs, device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
