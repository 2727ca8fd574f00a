"""Training launcher on a torch device: the LM ``Trainer`` for the zoo's
transformer archs, and the ``vikin-*`` KAN/MLP stack pipeline.

Counterpart of ``repro/launch/train.py``.  Runs on the GPU by default;
``--device cpu`` runs the kernels' plain versions.

``--arch <zoo arch>`` trains the LM through ``runtime/trainer.Trainer``
on ``data/lm.SyntheticLM`` batches, AdamW at a cosine schedule (warmup
``min(100, steps // 10)``), checkpoints every ``max(10, steps // 5)``
steps, restarting from the latest on an injected failure, and prints
``final step N, loss X`` as the reference does.  ``--ffn kan --pattern
0.5`` is the paper's KAN drop-in: every FFN two KAN layers through the
fused-KAN kernel, its gradient through the spline-basis kernel.
``--ffn kanffn --pattern 0.5`` is the reference's KAN-FFN: every FFN a
fused-KAN up-projection (the tiled stage-1 basis mask) and a
pattern-matmul down-projection over the kept half of the hidden lanes,
its gradient (bf16 at ``--scale full``) through the pattern-matmul
kernel (``kernels/pattern_matmul/ops.MatmulCompact``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --steps 100 --seq 128 --batch 8 --scale smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --scale full --ffn kan --pattern 0.5 --steps 4    # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --scale full --ffn kanffn --pattern 0.5 --steps 4  # on the card

Under ``torchrun`` (``WORLD_SIZE`` > 1) ``--mesh DxM`` lays the world
out over ("data", "model") (``PxDxM`` over ("pod", "data", "model")):
the counterpart of the mesh the reference's ``jax.distributed`` wires.
Each rank stores its shards, trains on its ``data`` rows and rank 0
writes the checkpoints (``launch/steps``, ``runtime/trainer``).  A rank
runs on ``cuda:<LOCAL_RANK>`` when each has a card (NCCL) and on
``cuda:0`` when they share one (gloo); ``--device cpu`` runs gloo on the
host:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen2-0.5b --mesh 2x2 --device cpu

``--dry-run`` counts one rank's step of ``--shape`` (``train_4k`` by
default) on the single- and multi-pod production meshes, on the meta
device, as the reference's re-exec of ``launch/dryrun.py`` does: it runs
``repro_torch.launch.dryrun --arch A --shape S --mesh both`` (records
under ``chiprun_out/dryrun/``, no card needed) and exits with its code:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --shape decode_32k --dry-run

``--arch vikin-*`` trains a stack dense, calibrates its two-stage
sparsity masks and int8 scales post-training on the device it trained
on, and exports a checkpoint in the reference's layout (params, masks
and scales in one commit) that ``repro_torch.launch.serve --ckpt``
serves (DESIGN.md Sec. 12):

  PYTHONPATH=src python -m repro_torch.launch.train --arch vikin-mixed \
      --steps 200 --pattern 0.5 --ckpt-dir /tmp/vikin_ckpt
  PYTHONPATH=src python -m repro_torch.launch.serve --arch vikin-mixed \
      --ckpt /tmp/vikin_ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.registry import get_config
from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.core.calibrate import (
    calibrate_scales,
    calibrate_stack,
    keep_per_group_for_rate,
    masked_pattern_rates,
)
from repro_torch.core.engine import run_model
from repro_torch.core.quant import quant_stack_apply, quantize_stack_params
from repro_torch.data.lm import LMDataConfig, SyntheticLM
from repro_torch.data.stack_task import task_for_model
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import StepOptions
from repro_torch.runtime.trainer import (
    StackTrainer,
    StackTrainerConfig,
    Trainer,
    TrainerConfig,
)


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


def train_lm(args: argparse.Namespace) -> Dict[str, Any]:
    """The reference's transformer branch: ``Trainer`` on SyntheticLM;
    returns ``run_with_restarts``'s result."""
    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = cfg.reduce()
    over = {}
    if args.ffn:
        over["ffn_kind"] = args.ffn
    if args.pattern:
        over["pattern_rate"] = args.pattern
    if over:
        cfg = dataclasses.replace(cfg, **over)
    data = SyntheticLM(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))
    mesh, device = None, args.device
    if args.mesh is not None:
        shape = M.parse_mesh(args.mesh)
        device = M.rank_device(args.device)
        mesh = M.init_from_env(shape, M.POD_AXES if len(shape) == 3
                               else M.AXES, device=device)
    ckpt_dir = args.ckpt_dir
    if ckpt_dir is None:
        if mesh is not None and mesh.size > 1:
            raise SystemExit("--mesh over several ranks needs --ckpt-dir "
                             "(one directory every rank reads)")
        ckpt_dir = tempfile.mkdtemp(prefix="train_")
    tcfg = TrainerConfig(
        max_steps=args.steps, ckpt_dir=ckpt_dir,
        ckpt_every=max(10, args.steps // 5), log_every=10, seed=args.seed)
    trainer = Trainer(cfg, tcfg, device, data,
                      StepOptions(lr=args.lr, total_steps=args.steps,
                                  warmup=min(100, args.steps // 10)),
                      mesh=mesh)
    lead = mesh is None or mesh.rank == 0
    if lead:
        where = (f"a {mesh.shape} mesh over {mesh.axis_names} "
                 f"({mesh.backend or 'one process'}), rank 0 on "
                 if mesh is not None else "")
        print(f"arch {cfg.name} ({cfg.dtype}, ffn {cfg.ffn_kind}, pattern "
              f"{cfg.pattern_rate}) on {where}{trainer.device}: "
              f"{args.steps} steps of {args.batch} x {args.seq} tokens, "
              f"checkpoints in {tcfg.ckpt_dir}", flush=True)
    out = trainer.run_with_restarts()
    if lead:
        print(f"final step {out['final_step']}, "
              f"loss {out['metrics'][-1]['loss']:.4f}")
    if mesh is not None:
        M.destroy_process_mesh(mesh)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k",
                    help="--dry-run: the production shape of the cell")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"],
                    help="transformer archs: smoke is the arch's reduce()d "
                         "width, full the registry's; the vikin path does "
                         "not read it")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128,
                    help="transformer archs: tokens a sequence")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 3e-4 (transformer) / 1e-2 (vikin stacks)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ffn", default=None,
                    help="transformer archs: override ffn_kind (kan: the "
                         "reference's KAN drop-in, two KAN layers; kanffn: "
                         "its KAN-FFN, a KAN up-projection and a "
                         "pattern-sparse linear down-projection)")
    ap.add_argument("--pattern", type=float, default=0.0,
                    help="stage-2 sparsity rate (vikin: of the calibration; "
                         "0 uses the arch's configured rate)")
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
    ap.add_argument("--mesh", default=None,
                    help="transformer archs under torchrun: DxM (data x "
                         "model) or PxDxM ranks, e.g. 2x2")
    ap.add_argument("--dry-run", action="store_true",
                    help="count one rank's step of --shape on the "
                         "production meshes on meta (launch/dryrun) and "
                         "exit with its code")
    args = ap.parse_args(argv)
    if args.arch in VIKIN_ARCHS:
        if args.lr is None:
            args.lr = 1e-2
        return train_vikin(args, VIKIN_ARCHS[args.arch])
    if args.lr is None:
        args.lr = 3e-4
    if args.dry_run:
        from repro_torch.launch import dryrun
        dryrun.main(["--arch", args.arch, "--shape", args.shape,
                     "--mesh", "both"])
    return train_lm(args)


if __name__ == "__main__":
    main()
