"""Table I on the port: train the paper's four benchmark models.

Counterpart of ``benchmarks/table1_models.py``.  Trains MLP-4, MLP-3,
KAN-3 and KAN-2 on the seeded Traffic surrogate (72h -> 96h,
channel-independent, 7:2:1 split, Adam lr 1e-3, batch 512, 100 epochs:
the paper's protocol, in the reference's own epoch loop) and reports test
MSE / RSE / MAE, parameter counts and the measured post-ReLU densities of
the MLPs' hidden layers.

KAN layers run through ``core/kan.kan_apply``: on a CUDA tensor under
grad that is the f32 ``kan_fused_v2`` kernel with its autograd Function,
whose backward launches the ``spline_basis`` kernel.  MLP layers are a
plain ``h @ w + b`` in IEEE f32, as the reference leaves them to XLA.
``--device cpu`` runs the kernels' plain versions; there is no fallback
from the card to the CPU.

Run (from the repository root, with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.table1_models [--epochs N] \\
        [--device cpu] [--out-dir DIR]

It writes ``table1.json`` (metrics, nnz rates, per-step losses and the
run that made them: ``run_record``) and ``paper_models.npz`` (the trained weights, in the reference's key layout
``{name}/{i}/{k}``: ``convert.paper_npz_entries``) into ``--out-dir``
(default ``chiprun_out/paper`` at the repository root), never into
``experiments/``, which holds the reference's.  The downstream scripts
reuse these files only for a request with the same epochs, seed, data
config and device (``ensure_trained``), and train them anew otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.vikin_models import PAPER_MODELS, PaperModelConfig
from repro_torch.convert import paper_npz_entries, paper_params_from_npz
from repro_torch.core.kan import KANConfig, kan_apply, kan_init
from repro_torch.data.traffic import (
    TrafficConfig,
    batches,
    load_traffic,
    mae,
    mse,
    rse,
)
from repro_torch.kernels.autotune import device_tag
from repro_torch.kernels.grad import ieee_matmul
from repro_torch.optim import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    constant_schedule,
)
from repro_torch.utils import resolve_device

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT_DIR = ROOT / "chiprun_out" / "paper"

Params = List[Dict[str, torch.Tensor]]


def out_path(out_dir: Optional[str | Path]) -> Path:
    """The directory the paper scripts write into: ``out_dir``, or
    ``DEFAULT_OUT_DIR``.  The reference's ``experiments/`` is refused."""
    path = Path(out_dir) if out_dir is not None else DEFAULT_OUT_DIR
    if path.resolve() in ((ROOT / "experiments").resolve(),
                          Path("experiments").resolve()):
        raise ValueError(f"{path}: experiments/ holds the reference's "
                         f"results; pass another --out-dir")
    return path


def run_record(epochs: int, seed: int, data_cfg: TrafficConfig,
               device: str | torch.device) -> Dict[str, Any]:
    """What a training run of the paper scripts was made from: its epochs,
    seed, data config and device (``device_tag``), in the form stored in
    each model's entry of ``table1.json`` and each grid's row of
    ``fig8.json``."""
    return json.loads(json.dumps({
        "epochs": epochs, "seed": seed, "data": dataclasses.asdict(data_cfg),
        "device": device_tag(resolve_device(device))}))


def made_by(rows: Sequence[Dict[str, Any]], record: Dict[str, Any]) -> bool:
    """Whether every row of a stored results file carries ``record``."""
    return all(row.get(k) == v for row in rows for k, v in record.items())


# ---------------------------------------------------------------------------
# Models (functional)
# ---------------------------------------------------------------------------

def init_model(cfg: PaperModelConfig,
               generator: Optional[torch.Generator] = None) -> Params:
    """He-normal MLP weights with zero biases, or ``kan_init`` layers, as
    f32 CPU tensors: the reference's shapes and distributions (its
    ``jax.random`` draws cannot be reproduced in torch)."""
    params = []
    for a, b in zip(cfg.sizes, cfg.sizes[1:]):
        if cfg.kind == "mlp":
            params.append({
                "w": torch.randn((a, b), generator=generator)
                * np.float32(np.sqrt(2.0 / a)),
                "b": torch.zeros((b,)),
            })
        else:
            params.append(kan_init(KANConfig(a, b, cfg.spec), generator))
    return params


def apply_model(params: Params, x: torch.Tensor, cfg: PaperModelConfig,
                collect_nnz: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x in [0, 1].  Returns (y, hidden_nnz_rates), the rates as 0-d
    tensors on x's device (MLPs only)."""
    nnz: List[torch.Tensor] = []
    h = x
    if cfg.kind == "mlp":
        for i, p in enumerate(params):
            h = ieee_matmul(h, p["w"]) + p["b"]
            if i < len(params) - 1:
                h = torch.relu(h)
                if collect_nnz:
                    nnz.append(torch.mean((h > 0).to(torch.float32)))
    else:
        h = 2.0 * h - 1.0                        # map into the spline grid
        for i, p in enumerate(params):
            a, b = cfg.sizes[i], cfg.sizes[i + 1]
            h = kan_apply(p, h, KANConfig(a, b, cfg.spec))
    return h, nnz


def to_device(params: Sequence[Dict[str, Any]],
              device: torch.device) -> Params:
    """f32 copies of ``params`` (tensors or numpy arrays) on ``device``."""
    return [{k: (v if torch.is_tensor(v) else torch.from_numpy(
        np.array(v, np.float32))).to(device, torch.float32, copy=True)
             for k, v in p.items()} for p in params]


def train_step(params: Params, state: OptState, xb: torch.Tensor,
               yb: torch.Tensor, cfg: PaperModelConfig,
               opt_cfg: AdamWConfig
               ) -> Tuple[Params, OptState, torch.Tensor]:
    """One AdamW step on the mean squared error of (xb, yb); returns the
    new params and state and the loss (a device tensor, not synced)."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
              for p in params]
    pred, _ = apply_model(leaves, xb, cfg)
    loss = torch.mean(torch.square(pred - yb))
    grads = iter(torch.autograd.grad(
        loss, [v for p in leaves for v in p.values()]))
    g = [{k: next(grads) for k in p} for p in leaves]
    new, state, _ = adamw_update(g, state, leaves, opt_cfg)
    return new, state, loss.detach()


def train_model(cfg: PaperModelConfig, data: Dict[str, np.ndarray],
                epochs: int, seed: int = 0, batch_size: int = 512,
                lr: float = 1e-3, *, device: str | torch.device = "cuda",
                params: Optional[Sequence[Dict[str, Any]]] = None,
                ) -> Tuple[Params, Dict[str, Any]]:
    """Train ``cfg`` on ``data`` for ``epochs`` on ``device``; returns the
    trained params (on ``device``) and the metrics on the test split.

    ``params`` are the initial params (tensors or numpy arrays in the
    reference's layout), by default ``init_model`` from ``seed``; the
    minibatches of epoch ``ep`` are shuffled from ``seed * 1000 + ep``,
    as in the reference.
    """
    dev = resolve_device(device)
    if params is None:
        params = init_model(cfg, torch.Generator().manual_seed(seed))
    params = to_device(params, dev)
    opt_cfg = AdamWConfig(lr=constant_schedule(lr), weight_decay=0.0,
                          grad_clip_norm=None)
    state = adamw_init(params)

    losses = []
    t0 = time.perf_counter()
    for ep in range(epochs):
        for xb, yb in batches(data["train_x"], data["train_y"], batch_size,
                              seed=seed * 1000 + ep):
            params, state, loss = train_step(
                params, state, torch.from_numpy(xb).to(dev),
                torch.from_numpy(yb).to(dev), cfg, opt_cfg)
            losses.append(loss)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0

    with torch.no_grad():
        pred, nnz = apply_model(
            params, torch.from_numpy(data["test_x"]).to(dev), cfg,
            collect_nnz=True)
    pred = pred.cpu().numpy()
    metrics = {
        "mse": mse(pred, data["test_y"]),
        "rse": rse(pred, data["test_y"]),
        "mae": mae(pred, data["test_y"]),
        "params": cfg.param_count(),
        "nnz_rates": [float(v) for v in nnz],
        "train_s": round(train_s, 1),
        "us_per_step": round(train_s / max(len(losses), 1) * 1e6, 1),
        "epochs": epochs,
        "losses": torch.stack(losses).cpu().tolist() if losses else [],
        "device": device_tag(dev),
    }
    return params, metrics


def run(epochs: int = 100, seed: int = 0,
        data_cfg: TrafficConfig = TrafficConfig(), *,
        device: str | torch.device = "cuda",
        out_dir: Optional[str | Path] = None) -> Dict[str, Dict]:
    """Train the four models; write ``table1.json`` and
    ``paper_models.npz`` into ``out_dir``; return the metrics by name."""
    out = out_path(out_dir)
    data = load_traffic(data_cfg)
    record = run_record(epochs, seed, data_cfg, device)
    results, weights = {}, {}
    for name, cfg in PAPER_MODELS.items():
        params, metrics = train_model(cfg, data, epochs, seed, device=device)
        results[name] = {**metrics, **record}
        weights.update(paper_npz_entries(name, params))
        print(f"{name:12s} params={metrics['params']:7d} "
              f"MSE={metrics['mse']:.3e} RSE={metrics['rse']:.3f} "
              f"MAE={metrics['mae']:.3e} nnz={metrics['nnz_rates']} "
              f"({metrics['device']})", flush=True)

    out.mkdir(parents=True, exist_ok=True)
    (out / "table1.json").write_text(json.dumps(results, indent=1))
    np.savez(out / "paper_models.npz", **weights)

    # headline claims of Table I
    k3, m4 = results["kan-3layer"], results["mlp-4layer"]
    print(f"\nKAN-3 vs MLP-4: params {k3['params']/m4['params']:.2f}x "
          f"(paper 0.30x), MSE ratio {k3['mse']/m4['mse']:.2f} "
          f"(paper 0.74)")
    return results


def load_trained(name: str, out_dir: Optional[str | Path] = None
                 ) -> Tuple[PaperModelConfig, Params]:
    """Reload trained weights (f32 CPU tensors) for downstream benchmarks;
    either package's ``paper_models.npz`` loads."""
    cfg = PAPER_MODELS[name]
    with np.load(out_path(out_dir) / "paper_models.npz") as z:
        return cfg, paper_params_from_npz(z, cfg)


def ensure_trained(epochs: int = 100, seed: int = 0,
                   data_cfg: TrafficConfig = TrafficConfig(), *,
                   device: str | torch.device = "cuda",
                   out_dir: Optional[str | Path] = None) -> Dict[str, Dict]:
    """``table1.json`` from ``out_dir``, after training the models there
    (``run``) unless it and the weights are there and were made by a run
    of these epochs, seed, data config and device."""
    out = out_path(out_dir)
    path = out / "table1.json"
    record = run_record(epochs, seed, data_cfg, device)
    if path.exists() and (out / "paper_models.npz").exists():
        t1 = json.loads(path.read_text())
        if made_by([t1.get(name, {}) for name in PAPER_MODELS], record):
            return t1
        print(f"{path} was made by another run; training {record}",
              flush=True)
    run(epochs, seed, data_cfg, device=device, out_dir=out)
    return json.loads(path.read_text())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    ap.add_argument("--out-dir", default=None,
                    help=f"output directory (default {DEFAULT_OUT_DIR})")
    args = ap.parse_args()
    run(epochs=args.epochs, seed=args.seed, device=args.device,
        out_dir=args.out_dir)


if __name__ == "__main__":
    main()
