"""Fault-tolerant training loop (``repro/train/trainer.py``).

* checkpoint/restart: atomic checkpoints every ``ckpt_every`` steps of the
  trained tensors and the optimizer state; on start the latest checkpoint
  (or a named step) is restored into the live tensors and the seekable
  data stream resumes at that step, so a restart reproduces the
  uninterrupted loss curve bit for bit.  Tensors the run does not train
  (the frozen stacks) are not written: the run rebuilds them from its
  seeds.
* preemption: a PREEMPTED flag in the checkpoint root makes the loop save
  and return at the next step boundary.
* straggler watchdog: per-step wall time is tracked with an EWMA; a step
  slower than ``watchdog_factor`` times the EWMA is counted.
* metrics: JSONL, one line per logged step; ``losses`` keeps every
  step's loss.
"""

from __future__ import annotations

import json
import time  # reprolint: ignore-file[wall-clock] -- training throughput logs and the straggler watchdog read real step wall time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager


@dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    watchdog_factor: float = 3.0
    metrics_path: Optional[str] = None
    codec: Optional[str] = None  # checkpoint shard codec (None: default)


def _to_like(live, loaded):
    """``loaded`` (a tree of CPU tensors) on the devices of ``live``."""
    if isinstance(live, dict):
        return {k: _to_like(live[k], loaded[k]) for k in live}
    return loaded.to(device=live.device, dtype=live.dtype)


class Trainer:
    def __init__(self, train_step: Callable, params: dict, opt_state: dict,
                 batch_at: Callable[[int], dict], ckpt_root: str,
                 tc: TrainerConfig):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.batch_at = batch_at
        self.mgr = CheckpointManager(ckpt_root, keep=tc.keep_ckpts,
                                     codec=tc.codec)
        self.tc = tc
        self.start_step = 0
        self.straggler_events = 0
        self.losses = {}  # step -> loss of the steps this trainer ran
        self._ewma = None

    def _tree(self):
        return {"params": self.params, "opt": self.opt_state}

    @torch.no_grad()
    def restore_if_available(self, step: Optional[int] = None) -> int:
        """Restore checkpoint ``step`` (None: the latest, if any); returns
        the step restored (0: none)."""
        if step is None:
            step, tree, _meta = self.mgr.restore_latest(self._tree())
            if step is None:
                return 0
        else:
            tree, _meta = self.mgr.restore(step, self._tree())
        for name, p in self.params.items():
            p.copy_(tree["params"][name])
        self.opt_state = _to_like(self.opt_state, tree["opt"])
        self.start_step = step
        return step

    def _save(self, step: int):
        self.mgr.save(step, self._tree(),
                      meta={"straggler_events": self.straggler_events})

    def run(self) -> dict:
        tc = self.tc
        metrics_f = open(tc.metrics_path, "a") if tc.metrics_path else None
        last = {}
        step = self.start_step
        try:
            while step < tc.num_steps:
                if self.mgr.preempted():
                    self._save(step)
                    self.mgr.clear_preemption()
                    return {"preempted_at": step, **last}
                batch = self.batch_at(step)
                t0 = time.monotonic()
                self.params, self.opt_state, m = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(m["loss"])  # waits for the step's device work
                dt = time.monotonic() - t0
                if self._ewma is None:
                    self._ewma = dt
                elif dt > tc.watchdog_factor * self._ewma:
                    self.straggler_events += 1
                self._ewma = 0.9 * self._ewma + 0.1 * dt
                step += 1
                self.losses[step] = loss
                if step % tc.log_every == 0 or step == tc.num_steps:
                    last = {k: float(v) for k, v in m.items()}
                    last.update(loss=loss, step=step,
                                sec_per_step=round(dt, 4),
                                stragglers=self.straggler_events)
                    if metrics_f:
                        metrics_f.write(json.dumps(last) + "\n")
                        metrics_f.flush()
                if step % tc.ckpt_every == 0 or step == tc.num_steps:
                    self._save(step)
        finally:
            if metrics_f:
                metrics_f.close()
        return last
