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

Under a mesh (``placement``, a :class:`~repro_torch.sharding.training.
TrainPlacement`) every rank runs the loop on its slices, and the
decisions that stop or shape it must agree on every rank, or a rank that
stops alone hangs the rest: rank 0 reads the PREEMPTED flag and its own
step time for the watchdog, and broadcasts both over the mesh's gloo
control group each step.  Checkpoints stay mesh-independent: the slices
are gathered to rank 0, which alone writes (the one-rank format, so a
checkpoint written on any mesh restores on any other); on restore rank 0
names the step and every rank reads the whole tensors and keeps its
slices.
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
                 tc: TrainerConfig, placement=None):
        self.placement = placement
        self.lead = placement is None or placement.lead
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

    def _whole_tree(self):
        """The checkpoint's tree: the live one, or under a mesh the whole
        tensors gathered to rank 0 (None on the other ranks)."""
        pl = self.placement
        if pl is None:
            return self._tree()
        params = {n: pl.whole(t, n) for n, t in self.params.items()}
        opt = {kind: {n: pl.whole(t, n)
                      for n, t in self.opt_state[kind].items()}
               for kind in ("mu", "nu", "master")}
        opt["count"] = pl.whole(self.opt_state["count"], "count")
        return {"params": params, "opt": opt} if self.lead else None

    def _local(self, tree):
        """Rank 0's whole tensors cut to this rank's slices."""
        pl = self.placement
        if pl is None:
            return tree
        return {"params": {n: pl.local(t, n)
                           for n, t in tree["params"].items()},
                "opt": {kind: ({n: pl.local(t, n) for n, t in v.items()}
                               if isinstance(v, dict) else v)
                        for kind, v in tree["opt"].items()}}

    @torch.no_grad()
    def restore_if_available(self, step: Optional[int] = None) -> int:
        """Restore checkpoint ``step`` (None: the latest, if any); returns
        the step restored (0: none).  Under a mesh rank 0 names the step."""
        if step is None:
            step = self.mgr.latest_step() if self.lead else None
            if self.placement is not None:
                step = int(self.placement.broadcast([step or 0])[0]) or None
            if step is None:
                return 0
        tree, _meta = self.mgr.restore(step, self._tree())
        tree = self._local(tree)
        for name, p in self.params.items():
            p.copy_(tree["params"][name])
        self.opt_state = _to_like(self.opt_state, tree["opt"])
        self.start_step = step
        return step

    def _save(self, step: int):
        tree = self._whole_tree()
        if self.lead:
            self.mgr.save(step, tree,
                          meta={"straggler_events": self.straggler_events})
        if self.placement is not None:
            self.placement.barrier()  # the step is on disk for every rank

    def _decide(self, preempted: bool, slow: bool):
        """(preempted, slow) as rank 0 sees them, on every rank."""
        if self.placement is None:
            return preempted, slow
        p, s = self.placement.broadcast([float(preempted), float(slow)])
        return bool(p), bool(s)

    def run(self) -> dict:
        tc = self.tc
        metrics_f = (open(tc.metrics_path, "a")
                     if tc.metrics_path and self.lead else None)
        last = {}
        step = self.start_step
        try:
            while step < tc.num_steps:
                preempted, _ = self._decide(
                    self.lead and self.mgr.preempted(), False)
                if preempted:
                    self._save(step)
                    if self.lead:
                        self.mgr.clear_preemption()
                    return {"preempted_at": step, **last}
                batch = self.batch_at(step)
                t0 = time.monotonic()
                self.params, self.opt_state, m = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(m["loss"])  # waits for the step's device work
                dt = time.monotonic() - t0
                slow = (self._ewma is not None
                        and dt > tc.watchdog_factor * self._ewma)
                _, slow = self._decide(False, slow)
                if slow:
                    self.straggler_events += 1
                self._ewma = dt if self._ewma is None else (
                    0.9 * self._ewma + 0.1 * dt)
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
