"""End-to-end LM training driver on the port.

Counterpart of ``examples/train_lm.py``: trains a small decoder LM
(qwen2-family block structure) with the real runtime -- the sharded-host
data pipeline (``data/lm``), AdamW with a cosine schedule, async
checkpoints, the straggler watchdog and, optionally, a mid-run
simulated node failure with the automatic restart -- on the card by
default, ``--device cpu`` for the kernels' plain versions.

The paper's technique is one flag away: ``--ffn kan`` swaps every MLP for
two KAN layers through the fused-KAN kernel (``--pattern 0.5``: the
two-stage sparsity's kept bases).

Run::

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --ffn kan \\
        --pattern 0.5
    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --inject-failure --device cpu
"""
import argparse
import dataclasses
import tempfile
from typing import Any, Dict, List, Optional

from repro_torch.configs.registry import get_config
from repro_torch.data.lm import LMDataConfig, SyntheticLM
from repro_torch.launch.steps import StepOptions
from repro_torch.models.layers import count_params
from repro_torch.models.transformer import param_shapes
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--ffn", default=None, choices=[None, "kan", "swiglu",
                                                    "mlp"])
    ap.add_argument("--pattern", type=float, default=0.0)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels; refused without CUDA) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduce(
        n_layers=args.layers, d_model=args.d_model,
        d_ff=4 * args.d_model, vocab_size=args.vocab,
        n_heads=4, n_kv_heads=2)
    over = {}
    if args.ffn:
        over["ffn_kind"] = args.ffn
    if args.pattern:
        over["pattern_rate"] = args.pattern
    if over:
        cfg = dataclasses.replace(cfg, **over)

    n_params = count_params(param_shapes(cfg))
    print(f"arch={cfg.name} ffn={cfg.ffn_kind} pattern={cfg.pattern_rate} "
          f"params={n_params/1e6:.1f}M")

    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch))
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_ckpt_")
    tcfg = TrainerConfig(
        max_steps=args.steps, ckpt_dir=ckpt,
        ckpt_every=max(10, args.steps // 10),
        log_every=20,
        failure_at=args.steps // 2 if args.inject_failure else None)
    trainer = Trainer(cfg, tcfg, args.device, data,
                      StepOptions(lr=1e-3, total_steps=args.steps,
                                  warmup=20))
    out = trainer.run_with_restarts()
    first, last = out["metrics"][0]["loss"], out["metrics"][-1]["loss"]
    print(f"\ndone: step {out['final_step']}  loss {first:.3f} -> {last:.3f}"
          f"  (checkpoints in {ckpt})")
    return out


if __name__ == "__main__":
    main()
