"""Checkpoint lifecycle (``repro/checkpoint/manager.py``): rotation,
latest step, preemption flag.

Directory layout::

    <root>/step_00001200/   # one store.save_tree dir per retained step
    <root>/step_00001500/
    <root>/PREEMPTED        # flag file a cluster agent drops before kill

``restore_latest`` returns CPU tensors; the trainer copies them into the
live parameters and moves the optimizer state to their device.  ``codec``
names the shard codec of every save (None: the store's default).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

from repro_torch.checkpoint.store import load_tree, save_tree

_STEP_RE = re.compile(r"^step_(\d{8})$")


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3,
                 codec: Optional[str] = None):
        self.root = root
        self.keep = keep
        self.codec = codec
        os.makedirs(root, exist_ok=True)

    def _step_dirs(self):
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and not name.endswith(".tmp"):
                out.append((int(m.group(1)), os.path.join(self.root, name)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def available_steps(self) -> list:
        return [s for s, _ in self._step_dirs()]

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None) -> str:
        meta = dict(meta or {}, step=step)
        path = os.path.join(self.root, f"step_{step:08d}")
        save_tree(path, tree, meta, codec=self.codec)
        self._rotate()
        return path

    def restore(self, step: int, template: Any = None):
        path = os.path.join(self.root, f"step_{step:08d}")
        return load_tree(path, template)

    def restore_latest(self, template: Any = None):
        step = self.latest_step()
        if step is None:
            return None, None, None
        tree, meta = self.restore(step, template)
        return step, tree, meta

    def _rotate(self):
        import shutil

        dirs = self._step_dirs()
        while len(dirs) > self.keep:
            _, path = dirs.pop(0)
            shutil.rmtree(path)

    # ---- preemption protocol ----

    def preempted(self) -> bool:
        return os.path.exists(os.path.join(self.root, "PREEMPTED"))

    def flag_preemption(self) -> None:
        """What the cluster agent does before SIGKILL (tests simulate it)."""
        with open(os.path.join(self.root, "PREEMPTED"), "w") as f:
            f.write("1")

    def clear_preemption(self) -> None:
        flag = os.path.join(self.root, "PREEMPTED")
        if os.path.exists(flag):
            os.remove(flag)
