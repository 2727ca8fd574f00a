"""Synthetic fitting tasks for VIKIN KAN/MLP stacks (train -> serve loop).

Counterpart of ``repro/data/stack_task.py``, numpy only: the same config
gives byte-equal arrays in both packages.

The serving workloads (configs/vikin_models.VIKIN_ARCHS) are generic
``R^{n_in} -> R^{n_out}`` stacks, so the training pipeline needs a task for
*arbitrary* widths, not just the paper's 72h->96h Traffic shapes.  Two
sources, same traffic.py-style dict interface:

  * ``traffic`` -- when a model's (n_in, n_out) matches the paper task
    (72, 96), the synthetic Traffic surrogate (data/traffic.py) is used
    directly, so vikin-kan2/-mlp3/... train on the same distribution as the
    Table I benchmarks.
  * ``teacher`` -- otherwise a smooth random teacher function
    y = tanh(sin(2 x W1)) W2 (+ optional argmax labels for classification)
    generates the regression pairs.  Inputs are uniform on [0, 1] -- inside
    every layer's spline domain once affinely mapped by the grid clip, and
    matching the Traffic occupancy range.

Both are fully seeded: ``load_stack_task`` is deterministic, which the
calibration-determinism tests rely on (DESIGN.md Sec. 12).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.data.traffic import TrafficConfig, load_traffic

TRAFFIC_SHAPE = (72, 96)  # paper task: 72h lookback -> 96h horizon


@dataclasses.dataclass(frozen=True)
class StackTaskConfig:
    n_in: int
    n_out: int
    n_train: int = 2048
    n_val: int = 512
    teacher_width: int = 16     # hidden width of the random teacher
    classify: bool = False      # also emit integer labels (argmax of y)
    seed: int = 0


def _teacher_pairs(cfg: StackTaskConfig, n: int, rng: np.random.Generator):
    x = rng.uniform(0.0, 1.0, (n, cfg.n_in)).astype(np.float32)
    w1 = rng.normal(0.0, 1.0, (cfg.n_in, cfg.teacher_width))
    w2 = rng.normal(0.0, 1.0, (cfg.teacher_width, cfg.n_out))
    w2 /= np.sqrt(cfg.teacher_width)
    y = np.tanh(np.sin(2.0 * x @ w1)) @ w2
    return x, y.astype(np.float32)


def load_stack_task(cfg: StackTaskConfig) -> Dict[str, np.ndarray]:
    """{'train_x','train_y','val_x','val_y'} (+ '*_label' when classifying).

    The teacher weights are drawn once (before the sample split) so train
    and val come from the same function; traffic-shaped tasks defer to
    load_traffic's chronological split instead.
    """
    if (cfg.n_in, cfg.n_out) == TRAFFIC_SHAPE and not cfg.classify:
        d = load_traffic(TrafficConfig(seed=cfg.seed))
        out = {
            "train_x": d["train_x"][:cfg.n_train],
            "train_y": d["train_y"][:cfg.n_train],
            "val_x": d["val_x"][:cfg.n_val],
            "val_y": d["val_y"][:cfg.n_val],
        }
        out["task"] = "traffic"
        return out
    rng = np.random.default_rng(cfg.seed)
    # one teacher, one sample stream, split by prefix
    x, y = _teacher_pairs(cfg, cfg.n_train + cfg.n_val, rng)
    out = {
        "train_x": x[:cfg.n_train], "train_y": y[:cfg.n_train],
        "val_x": x[cfg.n_train:], "val_y": y[cfg.n_train:],
        "task": "teacher",
    }
    if cfg.classify:
        out["train_label"] = np.argmax(out["train_y"], axis=-1)
        out["val_label"] = np.argmax(out["val_y"], axis=-1)
    return out


def task_for_model(model, *, n_train: int = 2048, n_val: int = 512,
                   classify: bool = False, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """Task sized to a PaperModelConfig's (sizes[0], sizes[-1])."""
    return load_stack_task(StackTaskConfig(
        int(model.sizes[0]), int(model.sizes[-1]), n_train=n_train,
        n_val=n_val, classify=classify, seed=seed))
