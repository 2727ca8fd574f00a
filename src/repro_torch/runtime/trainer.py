"""Training loops: the fault-tolerant LM ``Trainer`` and the VIKIN
``StackTrainer``.

Counterpart of ``repro/runtime/trainer.py``.  ``Trainer`` is the LM
training loop, with the reference's contract on one torch device, or on
a process mesh (``mesh=``, a ``launch/mesh.ProcessMesh``; ``device`` is
then the rank's):

  * **Deterministic resume**: the data source is keyed by step and the
    step counter lives in the checkpointed state, so a restart replays
    exactly the batch the dead run would have seen; the step runs under
    torch's deterministic algorithms on the card
    (``launch/steps.deterministic``), so a run killed at step k and
    restarted finishes with the same bits as one that was not.
  * **Checkpoint/restart**: ``AsyncCheckpointer`` (the host copy on the
    calling thread, the files on another) every ``ckpt_every`` steps and
    at the end, atomic commits, ``keep`` newest; the keys are the
    reference's, so either package restores what the other saved.  On a
    mesh a checkpoint holds whole leaves (``launch/steps.gather_state``),
    written by rank 0; restore cuts them for whatever mesh restores them
    (the reference's elastic restore, a different mesh OK).  Each rank
    trains on its ``data`` rows of the step's batch
    (``launch/steps.local_batch``).  The error-feedback residual of
    ``grad_compression`` is checkpointed on a mesh of one rank (it is
    whole there, as without a mesh); on more ranks it is rank-local and
    not written, so such a mesh refuses a ``ckpt_dir`` with it.
  * **Failure injection**: ``failure_at`` raises ``SimulatedFailure``
    once; ``run_with_restarts`` is the supervisor loop (restore the
    latest checkpoint, continue).
  * **Straggler watchdog**: a step's wall time, taken after the step has
    finished on the device, against the median of the last 50; a step
    over ``straggler_factor`` times it fires ``on_straggler`` (or is
    logged).

``params=`` takes the initial params (the reference's ``jax.random``
draws cannot be reproduced; tests carry them across with
``convert.transformer_params_from_jax``); without it they are drawn from
a ``torch.Generator`` on the device, seeded ``tcfg.seed``.

``StackTrainer`` (bottom of file) fits the paper's KAN/MLP stacks, the
"train" end of the train -> calibrate -> serve pipeline (DESIGN.md
Sec. 12).  Training runs DENSE (``pattern_rate`` forced to 0); the
two-stage masks are derived afterwards by ``core/calibrate``.  The
minibatch of step ``s`` is drawn from ``np.random.default_rng(seed *
100003 + s)``, so a fixed seed reproduces the run, and AdamW
(``optim/adamw``) runs at a constant lr with no decay on ``['b']``.
Its differences from the reference: ``device`` replaces ``impl`` (the
stack runs through the kernels on a CUDA device and their plain
versions on the CPU), and ``params=`` takes the initial params.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.launch.steps import (
    StepOptions,
    gather_state,
    init_train_state,
    local_batch,
    make_train_step,
    train_state_shardings,
)
from repro_torch.launch.sharding import shard_tree
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


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0     # step > factor * median -> straggler
    failure_at: Optional[int] = None  # inject SimulatedFailure at this step
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig,
                 device: torch.device | str, source: Any,
                 opts: StepOptions = StepOptions(),
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 *, params: Optional[Any] = None,
                 mesh: Optional[ProcessMesh] = None) -> None:
        self.cfg, self.tcfg, self.source = cfg, tcfg, source
        self.device = resolve_device(device)
        self.opts = opts
        self.mesh = mesh
        if (mesh is not None and mesh.size > 1 and opts.grad_compression
                and tcfg.ckpt_dir):
            raise NotImplementedError(
                "a checkpoint of a mesh's rank-local error-feedback "
                "residuals (grad_compression) is not written; train "
                "without ckpt_dir or on one rank")
        self.on_straggler = on_straggler
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_events: List[int] = []
        self._step_times: List[float] = []
        self._params0 = params
        self._ckpt = (AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep)
                      if tcfg.ckpt_dir else None)
        self._step_fn = make_train_step(cfg, opts, mesh)
        self.state = self._init_or_restore()

    # ------------------------------------------------------------------
    def _init_or_restore(self) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        if self.mesh is None:
            state = init_train_state(self.cfg, self.opts, gen, self.device,
                                     params=self._params0)
            if self._ckpt is not None and latest_step(
                    self.tcfg.ckpt_dir) is not None:
                state, step, _ = restore_checkpoint(self.tcfg.ckpt_dir,
                                                    state)
                print(f"[trainer] restored checkpoint at step {step}",
                      flush=True)
            return state
        if self._ckpt is None or latest_step(self.tcfg.ckpt_dir) is None:
            return init_train_state(self.cfg, self.opts, gen, self.device,
                                    params=self._params0, mesh=self.mesh)
        return self._restore_on_mesh()

    def _restore_on_mesh(self) -> Dict[str, Any]:
        """Every rank reads the whole leaves and keeps its shards."""
        whole = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype),
                         SP.state_specs(self.cfg))
        if self.opts.grad_compression:     # one rank: the residual is whole
            whole["ef_residual"] = tree_map(
                lambda a: torch.empty(a.shape, dtype=torch.float32),
                whole["params"])
        whole, step, _ = restore_checkpoint(self.tcfg.ckpt_dir, whole)
        whole = tree_map(lambda a: a.to(self.device), whole)
        specs = train_state_shardings(self.cfg, self.mesh)
        state = {k: shard_tree(whole[k], specs[k], self.mesh)
                 for k in ("params", "opt", "step")}
        if self.opts.grad_compression:
            state["ef_residual"] = whole["ef_residual"]
        if self._lead:
            print(f"[trainer] restored checkpoint at step {step}",
                  flush=True)
        return state

    @property
    def _lead(self) -> bool:
        """Whether this process logs: one process, or rank 0 of a mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def _save(self, step: int) -> None:
        """Checkpoint the state (whole leaves, written by rank 0)."""
        if self.mesh is None:
            self._ckpt.save(step, self.state)
            return
        whole = gather_state(self.state, self.cfg, self.mesh, "cpu")
        if "ef_residual" in self.state:    # one rank: the residual is whole
            whole["ef_residual"] = tree_map(lambda a: a.to("cpu"),
                                            self.state["ef_residual"])
        if self.mesh.rank == 0:
            self._ckpt.save(step, whole)

    def _wait(self) -> None:
        """The last save committed, on every rank."""
        self._ckpt.wait()
        if self.mesh is not None:
            self.mesh.barrier()

    @property
    def step(self) -> int:
        return int(self.state["step"])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The source's batch of ``step`` on the trainer's device (on a
        mesh, this rank's rows of it)."""
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in self.source.batch_at(step).items()}
        if self.mesh is not None:
            batch = local_batch(batch, self.mesh)
        return {k: v.to(self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def _watchdog(self, step: int, dt: float) -> None:
        self._step_times.append(dt)
        if len(self._step_times) < 5:
            return
        med = float(np.median(self._step_times[-50:]))
        if dt > self.tcfg.straggler_factor * med:
            self.straggler_events.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt)
            else:
                print(f"[trainer] straggler at step {step}: "
                      f"{dt * 1e3:.0f}ms vs median {med * 1e3:.0f}ms "
                      f"(would trigger hot-spare swap)", flush=True)

    def run(self) -> Dict[str, Any]:
        """Single run attempt; raises SimulatedFailure if injected."""
        while self.step < self.tcfg.max_steps:
            step = self.step
            if self.tcfg.failure_at is not None and step == self.tcfg.failure_at:
                self.tcfg.failure_at = None   # fail once
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = self.batch_at(step)
            self._sync()
            t0 = time.time()
            self.state, metrics = self._step_fn(self.state, batch)
            self._sync()
            dt = time.time() - t0
            self._watchdog(step, dt)
            m = {k: float(v) for k, v in metrics.items()}
            m["step"], m["step_time_s"] = step, dt
            self.metrics_log.append(m)
            if step % self.tcfg.log_every == 0 and self._lead:
                print(f"[trainer] step {step} loss {m['loss']:.4f} "
                      f"({dt * 1e3:.0f}ms)", flush=True)
            new_step = step + 1
            if self._ckpt is not None and new_step % self.tcfg.ckpt_every == 0:
                self._save(new_step)
        if self._ckpt is not None:
            self._save(self.step)
            self._wait()
        return {"final_step": self.step, "metrics": self.metrics_log,
                "stragglers": self.straggler_events}

    def run_with_restarts(self, max_restarts: int = 3) -> Dict[str, Any]:
        """Supervisor loop: restart from the latest checkpoint on failure."""
        attempts = 0
        while True:
            try:
                return self.run()
            except SimulatedFailure as e:
                attempts += 1
                if attempts > max_restarts or self._ckpt is None:
                    raise
                print(f"[trainer] {e}; restarting "
                      f"({attempts}/{max_restarts})", flush=True)
                self._wait()
                self.state = self._init_or_restore()


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
