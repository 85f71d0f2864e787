"""Fault-tolerant training loop (the port's counterpart of
``repro.train.loop``).

* checkpoint/restart: group-commit checkpoints every N steps through the
  ring (``repro_torch.checkpoint``); ``restore()`` resumes from the latest
  complete checkpoint (a partially written one is invisible — no
  manifest).
* failure injection: ``fail_at_step`` raises mid-run (tests restart).
* straggler mitigation: the data pipeline hedges slow reads (LINK_TIMEOUT).
* elastic: ``restore(shardings)`` places the checkpoint on any mesh.

On a mesh (``mesh``, ``rules``) the parameters are placed by
``lm.param_specs`` and every step is the mesh train step. The loop runs on ``device`` ("cuda" unless the caller asks for the CPU);
numpy batches from the loader are moved there with ``torch.as_tensor``.
The train step updates ``params`` and the optimizer state in place.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import adamw_init


class InjectedFailure(RuntimeError):
    pass


@dataclass
class TrainLoopConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    peak_lr: float = 3e-4
    fail_at_step: Optional[int] = None     # fault-injection (tests)


class TrainLoop:
    def __init__(self, cfg, loop_cfg: TrainLoopConfig, data: Iterator,
                 *, mesh=None, rules=None, params=None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lc = loop_cfg
        self.data = data
        self.mesh = mesh
        self.step_fn = make_train_step(cfg, mesh, rules,
                                       peak_lr=loop_cfg.peak_lr,
                                       total_steps=loop_cfg.total_steps)
        if params is None:
            params = lm.init_params(
                cfg, torch.Generator(self.device).manual_seed(seed),
                device=self.device)
        if mesh is not None:
            params = lm.place_params(cfg, params, mesh, rules)
        self.params = params
        self.opt_state = adamw_init(params)
        self.ckpt = Checkpointer(loop_cfg.ckpt_dir, every=loop_cfg.ckpt_every)
        self.start_step = 0
        self.metrics_log: list = []

    def restore(self, shardings=None) -> int:
        """Resume from the latest checkpoint, if any: its leaves placed by
        ``shardings`` (a tree like {"params", "opt"} of NamedShardings, on
        any mesh), else plain tensors on the loop's device."""
        state = {"params": self.params, "opt": self.opt_state}
        restored, step = self.ckpt.restore_or(state, shardings)
        if restored is not None:
            self.params = restored["params"]
            self.opt_state = restored["opt"]
            self.start_step = step
        return self.start_step

    def run(self) -> dict:
        it = iter(self.data)
        last = None
        for step in range(self.start_step, self.lc.total_steps):
            if self.lc.fail_at_step is not None and \
                    step == self.lc.fail_at_step:
                raise InjectedFailure(f"injected failure at step {step}")
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in next(it).items()}
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            if step % self.lc.log_every == 0 or \
                    step == self.lc.total_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                self.metrics_log.append(m)
                last = m
            self.ckpt.maybe_save(
                step, {"params": self.params, "opt": self.opt_state})
        return last or {}
