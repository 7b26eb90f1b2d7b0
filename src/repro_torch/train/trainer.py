"""Training loop: auto-resume, async checkpoints, preemption handling,
straggler monitoring — the reference's ``train/trainer.py`` on one device.

  * **checkpoint/restart** — ``CheckpointManager`` (atomic, async, keep-N);
    params + optimizer state + data-iterator step all restore exactly, so a
    killed job resumes where it stopped.
  * **preemption** — SIGTERM triggers a final checkpoint, then exit 143.
  * **straggler mitigation** — per-step wall-time EWMA; a step slower than
    ``straggler_factor×`` EWMA increments a counter and (configurably)
    forces an early checkpoint so an external supervisor can reschedule the
    job.
  * **topology-agnostic checkpoints** — full arrays in the reference's
    format (``checkpoint/manager.py``).

On a mesh (``dist`` from ``Dist.for_mesh``; every rank runs the same
trainer) the parameters and optimizer state are ``DTensor``s placed by the
rules, each rank's data iterator makes its own rows (``DataConfig``'s
``row_start`` / ``rows_local``, ``data.local_rows``) and ``to_mesh`` joins
them into the global batch; a restore distributes each leaf onto the
current mesh, whatever mesh wrote it.

Differences from the reference, deliberate: parameters are drawn from a
``torch.Generator`` seeded ``run.seed`` on ``device`` (the card by
default), not from ``jax.random``; the train step updates parameters and
optimizer state in place (the reference donates its buffers to the jitted
step). The step's wall ends in the ``float(loss)`` sync, as in the
reference.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import torch

from ..checkpoint import CheckpointManager
from ..config import RunConfig
from ..data import DataIterator
from ..data.pipeline import to_mesh
from ..device import resolve_device
from ..models import base as mbase
from ..models.model import Model
from ..sharding.rules import Dist
from .steps import make_train_step

#: Batch keys the model consumes (others, e.g. ``motif_label``, stay home).
MODEL_INPUTS = ("tokens", "labels", "frames", "prefix_embeds")


@dataclass
class StragglerMonitor:
    factor: float = 3.0
    alpha: float = 0.1
    ewma_s: float = 0.0
    slow_steps: int = 0
    _n: int = 0

    def observe(self, dt: float) -> bool:
        self._n += 1
        if self._n <= 2:           # warmup: ignore the first steps
            self.ewma_s = dt
            return False
        slow = dt > self.factor * self.ewma_s
        if slow:
            self.slow_steps += 1
        self.ewma_s = (1 - self.alpha) * self.ewma_s + self.alpha * dt
        return slow


@dataclass
class Trainer:
    model: Model
    run: RunConfig
    dist: Dist
    data: DataIterator
    log_every: int = 10
    checkpoint_on_straggler: bool = False
    device: str = "cuda"

    step: int = 0
    params: dict | None = None
    opt_state: dict | None = None
    metrics_log: list = field(default_factory=list)
    _preempted: bool = field(default=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.ckpt = CheckpointManager(
            self.run.checkpoint_dir,
            keep=self.run.keep_checkpoints,
            async_save=self.run.async_checkpoint,
        )
        self.train_step_fn, self.opt = make_train_step(self.model, self.run, self.dist)
        self.monitor = StragglerMonitor()
        self.param_specs = self.model.param_specs()

    # -- state ------------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.run.seed)
        self.params = self.model.init(gen, device=self.device, dist=self.dist)
        self.opt_state = self.opt.init(self.params, self.param_specs,
                                       self.dist)
        self.step = 0

    def try_resume(self) -> bool:
        """Auto-resume from the latest checkpoint: params, optimizer state,
        step and the data iterator's position."""
        if self.ckpt.latest() is None:
            return False
        if self.dist.mesh is not None:     # the leaves' specs and targets
            like = {"params": self.param_specs,
                    "opt": self.opt.state_specs(self.param_specs)}
        else:
            like = {"params": self.params if self.params is not None else
                    mbase.map_specs(lambda s: torch.empty(
                        s.shape, dtype=mbase.torch_dtype(s.dtype),
                        device=self.device), self.param_specs)}
            if self.opt_state is None:
                self.opt_state = self.opt.init(like["params"],
                                               self.param_specs)
            like["opt"] = self.opt_state
        step, tree, extra = self.ckpt.restore(
            like, shardings=self.dist.shardings(like))
        self.params = self.model.load(tree["params"], self.dist)
        self.opt_state = tree["opt"]
        self.step = step
        if "data" in extra:
            self.data.restore(extra["data"])
        return True

    def save(self):
        self.ckpt.save(
            self.step,
            {"params": self.params, "opt": self.opt_state},
            extra={"data": self.data.state()},
        )

    # -- preemption ---------------------------------------------------------------
    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    # -- loop ------------------------------------------------------------------
    def fit(self, total_steps: int) -> dict:
        if self.params is None:
            if not self.try_resume():
                self.init_state()
        last_loss = None
        while self.step < total_steps:
            batch = next(self.data)
            batch = {k: to_mesh(torch.as_tensor(v).to(self.device), self.dist)
                     for k, v in batch.items() if k in MODEL_INPUTS}
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.train_step_fn(
                self.params, self.opt_state, self.step, batch
            )
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = self.monitor.observe(dt)
            self.step += 1
            last_loss = loss
            if self.step % self.log_every == 0 or self.step == total_steps:
                self.metrics_log.append(
                    {"step": self.step, "loss": loss, "dt_s": dt,
                     "grad_norm": float(metrics["grad_norm"])}
                )
            if slow and self.checkpoint_on_straggler:
                self.save()
            if self.step % self.run.checkpoint_every == 0:
                self.save()
            if self._preempted:
                self.save()
                self.ckpt.wait()
                raise SystemExit(143)
        self.save()
        self.ckpt.wait()
        return {"final_loss": last_loss, "steps": self.step,
                "slow_steps": self.monitor.slow_steps,
                "log": self.metrics_log}
