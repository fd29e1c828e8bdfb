"""Trainer: the integration loop - data, step, checkpoint, fault hooks
(port of ``repro.train.trainer``).

Deterministic data slices, checkpoint-restart that reproduces the exact
batch sequence (``SyntheticLM.batch(step)`` is a pure function of the
step, and the checkpoint holds parameters and optimizer state bit for
bit), heartbeat / straggler hooks around each step.  Runs on the CUDA
device unless the caller passes ``device="cpu"``.  The reference's
``extra_batch_fn`` (extra VLM / enc-dec inputs) is not ported: those
families do not train here yet.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import model_init
from repro_torch.optim import adamw_init
from repro_torch.runtime import HeartbeatMonitor, StragglerDetector
from repro_torch.train.step import TrainConfig, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 rcfg: TrainerConfig, dcfg: DataConfig, *, device="cuda"):
        self.cfg, self.tcfg, self.rcfg = cfg, tcfg, rcfg
        self.device = resolve_device(device)
        self.data = SyntheticLM(dcfg, rcfg.host_id, rcfg.n_hosts,
                                device=self.device)
        self.step_fn = make_train_step(cfg, tcfg)
        self.ckpt = (Checkpointer(rcfg.checkpoint_dir)
                     if rcfg.checkpoint_dir else None)
        self.heartbeat = HeartbeatMonitor(rcfg.n_hosts)
        self.straggler = StragglerDetector(rcfg.n_hosts)

        self.params = model_init(cfg, seed=rcfg.seed, device=self.device)
        self.opt_state = adamw_init(self.params, tcfg.optimizer)
        self.start_step = 0

        if self.ckpt and self.ckpt.latest_step() is not None:
            state = {"params": self.params, "opt": self.opt_state}
            state, step = self.ckpt.restore(state)
            self.params = state["params"]
            self.opt_state = state["opt"]
            self.start_step = step
            print(f"[trainer] restored checkpoint at step {step}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> list[dict]:
        history = []
        rcfg = self.rcfg
        for step in range(self.start_step, rcfg.steps):
            t0 = time.time()
            batch = self.data.batch(step)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            self._sync()
            dt = time.time() - t0

            self.heartbeat.beat(rcfg.host_id, time.time())
            self.straggler.record(rcfg.host_id, dt)

            if step % rcfg.log_every == 0 or step == rcfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, step_time_s=round(dt, 3))
                history.append(m)
                print(f"[trainer] step {step:5d} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} {dt*1e3:.0f} ms")

            if (self.ckpt and rcfg.checkpoint_every
                    and (step + 1) % rcfg.checkpoint_every == 0):
                self.ckpt.save(step + 1, {"params": self.params,
                                          "opt": self.opt_state},
                               host_id=rcfg.host_id,
                               n_hosts=rcfg.n_hosts)
        if self.ckpt:
            self.ckpt.wait()
        return history
