"""Training launcher for ``vikin-*`` KAN/MLP stacks on a torch device.

Counterpart of the ``vikin-*`` path of ``repro/launch/train.py``: train a
stack dense, calibrate its two-stage sparsity masks and int8 scales
post-training, and export a checkpoint in the reference's layout (params,
masks and scales in one commit) that ``repro_torch.launch.serve --ckpt``
serves (DESIGN.md Sec. 12).  Runs on the GPU by default; ``--device cpu``
runs the kernels' plain versions:

  PYTHONPATH=src python -m repro_torch.launch.train --arch vikin-mixed \
      --steps 200 --pattern 0.5 --ckpt-dir /tmp/vikin_ckpt
  PYTHONPATH=src python -m repro_torch.launch.serve --arch vikin-mixed \
      --ckpt /tmp/vikin_ckpt

Calibration runs on the device the stack trained on (its dense forward
through the kernels on the card).  The transformer archs (the
reference's LM ``Trainer``) are not ported.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.core.calibrate import (
    calibrate_scales,
    calibrate_stack,
    keep_per_group_for_rate,
    masked_pattern_rates,
)
from repro_torch.core.engine import run_model
from repro_torch.core.quant import quant_stack_apply, quantize_stack_params
from repro_torch.data.stack_task import task_for_model
from repro_torch.runtime.trainer import StackTrainer, StackTrainerConfig


def train_vikin(args: argparse.Namespace, model: Any) -> Dict[str, Any]:
    """Train -> calibrate -> sparsified checkpoint; returns the
    checkpoint's ``extra`` with its directory under ``ckpt_dir``."""
    data = task_for_model(model, classify=(args.loss == "xent"),
                          seed=args.seed)
    tcfg = StackTrainerConfig(
        steps=args.steps, batch_size=args.batch, lr=args.lr,
        device=args.device, loss=args.loss, seed=args.seed,
        log_every=max(1, args.steps // 5))
    trainer = StackTrainer(model, data, tcfg)
    print(f"arch {model.name}: layers={list(model.layer_kinds)} "
          f"sizes={list(model.sizes)} task={data['task']} "
          f"({data['train_x'].shape[0]} train samples) on {trainer.device}")
    out = trainer.run()

    # post-training calibration at the deployment rate (Table II style):
    # --pattern overrides; 0 falls back to the arch's configured rate
    rate = args.pattern if args.pattern > 0 else model.pattern_rate
    kpg = keep_per_group_for_rate(rate)
    calib_x = data["train_x"][:args.calib_samples]
    sp = calibrate_stack(out["params"], model, calib_x, keep_per_group=kpg)
    # quantization scales from the SAME calibration batch: always emitted,
    # so any checkpoint can later be served at --precision int8
    scales = calibrate_scales(out["params"], model, calib_x)
    # run() already evaluated the final dense params; only sparse is new
    dense_eval = {k: v for k, v in out.items() if k.startswith("val_")}
    sparse_eval = trainer.evaluate(masks=sp.masks)
    rates = masked_pattern_rates(sp.masks)
    dense_rep = run_model(model.layer_works(
        pattern_rates=[0.0] * model.n_layers))
    sparse_rep = run_model(model.layer_works(pattern_rates=rates))

    extra = {
        "arch": model.name, "task": data["task"], "loss": args.loss,
        "pattern_rate": rate, "seed": args.seed,
        "mask_keep_rates": sp.summary()["keep_rates"],
        "val_dense": dense_eval, "val_sparse": sparse_eval,
        "sim_cycles_dense": dense_rep.cycles,
        "sim_cycles_sparse": sparse_rep.cycles,
        "precision": args.precision,
        "scale_x": scales.summary()["x"],
    }
    masks = (sp.masks if any(m is not None for m in sp.masks) else None)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix=f"vikin_{model.name}_")
    path = save_checkpoint(ckpt_dir, args.steps, out["params"],
                           extra=extra, masks=masks, scales=scales)
    speedup = dense_rep.cycles / max(sparse_rep.cycles, 1.0)
    print(f"calibrated masks at rate {rate}: keep_rates="
          f"{sp.summary()['keep_rates']}")
    if args.precision == "int8":
        qp = quantize_stack_params(out["params"], model, scales)
        with torch.inference_mode():
            yq = quant_stack_apply(
                qp, torch.from_numpy(data["val_x"]).to(trainer.device),
                model, scales, masks=list(sp.masks)).cpu().numpy()
        mse_q = float(np.mean((yq - np.asarray(data["val_y"])) ** 2))
        print(f"val int8-sparse mse {mse_q:.6f} "
              f"(scales x={extra['scale_x']})")
    print(f"val dense {dense_eval} -> sparse {sparse_eval}")
    print(f"simulated cycles dense {dense_rep.cycles:.0f} -> sparse "
          f"{sparse_rep.cycles:.0f} ({speedup:.2f}x)")
    print(f"sparsified checkpoint: {path} (masks + int8 scales)")
    print(f"serve it:  PYTHONPATH=src python -m repro_torch.launch.serve "
          f"--arch {model.name} --ckpt {ckpt_dir}"
          + (" --precision int8" if args.precision == "int8" else "")
          + (f" --device {args.device}" if args.device != "cuda" else ""))
    return {**extra, "ckpt_dir": ckpt_dir}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"],
                    help="the reference's flag; the vikin path does not "
                         "read it")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--pattern", type=float, default=0.0,
                    help="stage-2 sparsity rate of the calibration; 0 uses "
                         "the arch's configured rate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loss", default="mse", choices=["mse", "xent"],
                    help="stack task: regression | classification")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--calib-samples", type=int, default=256,
                    help="calibration batch size for mask derivation")
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="target serving precision; int8 scales are "
                         "always calibrated and saved, int8 here also "
                         "prints the quantized validation MSE")
    args = ap.parse_args(argv)
    if args.arch not in VIKIN_ARCHS:
        raise SystemExit(
            f"arch {args.arch!r}: the port trains only the vikin-* stacks "
            f"{sorted(VIKIN_ARCHS)}; the transformer archs wait for "
            f"ROADMAP.md queue 1 items 6-7")
    return train_vikin(args, VIKIN_ARCHS[args.arch])


if __name__ == "__main__":
    main()
