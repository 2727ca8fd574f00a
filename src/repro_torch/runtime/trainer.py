"""The VIKIN stack trainer: fit a KAN/MLP stack on a small task.

Counterpart of ``StackTrainer`` in ``repro/runtime/trainer.py``, the
"train" end of the train -> calibrate -> serve pipeline (DESIGN.md
Sec. 12).  Training runs DENSE (``pattern_rate`` forced to 0); the
two-stage masks are derived afterwards by ``core/calibrate``.  The
minibatch of step ``s`` is drawn from ``np.random.default_rng(seed *
100003 + s)``, so a fixed seed reproduces the run, and AdamW
(``optim/adamw``) runs at a constant lr with no decay on ``['b']``.

The differences from the reference: ``device`` replaces ``impl`` (the
stack runs through the kernels on a CUDA device and their plain
versions on the CPU), and ``params=`` takes the initial params (the
reference's ``jax.random`` init cannot be drawn in torch; tests carry it
across with ``convert.py``).  The LM ``Trainer`` is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.ffn import vikin_stack_apply, vikin_stack_init
from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
)
from repro_torch.optim.schedules import constant_schedule
from repro_torch.utils import (
    leaf_paths,
    resolve_device,
    tree_map,
    tree_map_with_path,
)

Params = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass
class StackTrainerConfig:
    steps: int = 300
    batch_size: int = 64
    lr: float = 1e-2
    weight_decay: float = 0.0
    seed: int = 0
    log_every: int = 100
    device: str = "cuda"       # "cpu" runs the kernels' plain versions
    loss: str = "mse"          # mse (regression) | xent (classification)


class StackTrainer:
    """AdamW fitting of a configs/vikin_models.PaperModelConfig stack on
    a data/stack_task.load_stack_task dict."""

    def __init__(self, model: Any, data: Dict[str, Any],
                 cfg: Optional[StackTrainerConfig] = None, *,
                 params: Optional[Sequence[Dict[str, Any]]] = None) -> None:
        self.cfg = cfg or StackTrainerConfig()
        if self.cfg.loss not in ("mse", "xent"):
            raise ValueError(f"unknown loss {self.cfg.loss!r}; expected "
                             f"mse|xent")
        self.device = resolve_device(self.cfg.device)
        self.model = dataclasses.replace(model, pattern_rate=0.0)
        self.data = data
        self.metrics_log: List[Dict[str, float]] = []
        if params is None:
            params = vikin_stack_init(
                self.model, torch.Generator().manual_seed(self.cfg.seed))
        self.params: Params = [
            {k: torch.as_tensor(v, dtype=torch.float32).to(self.device,
                                                            copy=True)
             for k, v in p.items()} for p in params]
        self._opt: OptState = adamw_init(self.params)
        self._acfg = AdamWConfig(lr=constant_schedule(self.cfg.lr),
                                 weight_decay=self.cfg.weight_decay,
                                 no_decay_tokens=("['b']",))

    def loss_fn(self, params: Params, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
        pred = vikin_stack_apply(params, x, self.model).to(torch.float32)
        if self.cfg.loss == "xent":
            logp = F.log_softmax(pred, dim=-1)
            return -torch.mean(torch.gather(logp, -1, y[:, None]))
        return torch.mean(torch.square(pred - y))

    def _batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        n = self.data["train_x"].shape[0]
        rng = np.random.default_rng(cfg.seed * 100003 + step)
        idx = rng.integers(0, n, size=min(cfg.batch_size, n))
        x = self.data["train_x"][idx]
        y = (self.data["train_label"][idx] if cfg.loss == "xent"
             else self.data["train_y"][idx])
        return x, y

    def batch(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The minibatch of ``step`` on the trainer's device."""
        x, y = self._batch_at(step)
        return (torch.from_numpy(np.ascontiguousarray(x)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(y)).to(self.device))

    def value_and_grad(self, x: torch.Tensor, y: torch.Tensor
                       ) -> Tuple[torch.Tensor, Params]:
        """The loss of the current params on (x, y) and its gradient, a
        tree shaped like the params."""
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          self.params)
        loss = self.loss_fn(params, x, y)
        paths = leaf_paths(params)
        grads = dict(zip((k for k, _ in paths), torch.autograd.grad(
            loss, [p for _, p in paths])))
        return loss.detach(), tree_map_with_path(lambda k, _: grads[k],
                                                 params)

    def apply(self, grads: Params) -> torch.Tensor:
        """One AdamW update of the params; returns the gradients' global
        norm before the clip."""
        self.params, self._opt, om = adamw_update(grads, self._opt,
                                                  self.params, self._acfg)
        return om["grad_norm"]

    def train_step(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One AdamW step on the minibatch of ``step``; returns the loss
        and the gradients' global norm before the clip (device tensors,
        not synchronised)."""
        loss, grads = self.value_and_grad(*self.batch(step))
        return loss, self.apply(grads)

    @torch.no_grad()
    def evaluate(self, params: Optional[Params] = None,
                 masks: Optional[Sequence[Any]] = None) -> Dict[str, float]:
        """Val-set metrics; ``masks`` evaluates a sparsified stack.

        Regression reports val_mse; classification reports val_xent and
        val_acc (the outputs are unnormalized logits there).
        """
        params = self.params if params is None else params
        x = torch.from_numpy(np.ascontiguousarray(self.data["val_x"]))
        pred = vikin_stack_apply(params, x.to(self.device), self.model,
                                 masks=masks).cpu().numpy().astype(np.float64)
        if self.cfg.loss == "xent":
            labels = self.data["val_label"]
            logp = pred - np.log(
                np.sum(np.exp(pred - pred.max(-1, keepdims=True)),
                       axis=-1, keepdims=True)) - pred.max(-1, keepdims=True)
            return {
                "val_xent": float(-np.mean(
                    logp[np.arange(labels.shape[0]), labels])),
                "val_acc": float(np.mean(np.argmax(pred, -1) == labels)),
            }
        return {"val_mse": float(np.mean((pred - self.data["val_y"]) ** 2))}

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        for step in range(cfg.steps):
            loss, gnorm = self.train_step(step)
            if step % cfg.log_every == 0 or step == cfg.steps - 1:
                m = {"step": step, "loss": float(loss),
                     "grad_norm": float(gnorm)}
                self.metrics_log.append(m)
                print(f"[stack-trainer] step {step} "
                      f"loss {m['loss']:.5f}", flush=True)
        final = self.evaluate()
        return {"params": self.params, "metrics": self.metrics_log,
                **final}
