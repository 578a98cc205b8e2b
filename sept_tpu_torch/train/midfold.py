"""Mid-fold (epoch-level) checkpoint and resume.

Counterpart of ``sept_tpu/train/midfold.py``.  After every epoch the fold
driver persists the whole training state (a
:meth:`sept_tpu_torch.train.steps.TrainState.snapshot`: the model's and the
optimizer's state_dicts with the schedule's update count and the plateau
scale, the generator's state and the step), the best state so far, and the
host bookkeeping (epoch index, best-validation tracking, early-stopping and
plateau counters, metric history); a restarted fold continues from the next
epoch with the same trajectory.

Crash consistency: ``loop.json`` is the one atomic commit point.  Each
epoch's states go to FRESH ``state_e<N>`` / ``best_e<N>`` directories
first; only once they are written is ``loop.json``, which names them,
replaced with ``os.replace``, and only after that are the directories it no
longer names deleted.  A kill at any instant leaves ``loop.json`` naming a
whole checkpoint whose epoch matches its contents.

Layout under ``path``:
    state_e<N>/state.pt  the live state after epoch N
    best_e<N>/state.pt   the best-by-validation state (when one exists)
    loop.json            host bookkeeping + {"state_dir", "best_dir"}

The fold driver deletes the directory once the fold completes (the final
artifact supersedes it).

Under data parallelism (``group``) rank 0 alone writes and deletes, every
rank then passes a barrier, and every rank restores from the directory (the
ranks of one host share it; a multi-host run needs it on a shared
filesystem), so they all continue from the same state.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from sept_tpu_torch.device import resolve_device
from sept_tpu_torch.parallel.mesh import barrier, is_main

__all__ = ["MidFoldCheckpoint"]

_FILE = "state.pt"


class MidFoldCheckpoint:
    def __init__(self, path: str, group=None):
        self.path = os.path.abspath(path)
        self.group = group

    def _loop_path(self) -> str:
        return os.path.join(self.path, "loop.json")

    def _read_loop(self) -> Optional[dict]:
        try:
            with open(self._loop_path()) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None

    def exists(self) -> bool:
        loop = self._read_loop()
        return loop is not None and os.path.isfile(
            os.path.join(self.path, loop["state_dir"], _FILE))

    def save(self, state: dict, best_state: Optional[dict], loop: dict) -> None:
        """``state`` and ``best_state`` are snapshots (dicts of tensors and
        numbers); ``best_state=None`` keeps the best already on disk."""
        if is_main(self.group):
            self._save(state, best_state, loop)
        barrier(self.group)

    def _save(self, state: dict, best_state: Optional[dict], loop: dict) -> None:
        os.makedirs(self.path, exist_ok=True)
        epoch = int(loop.get("epoch", 0))
        state_dir = f"state_e{epoch}"
        best_dir = f"best_e{epoch}" if best_state is not None else None

        # 1) write the new states to fresh directories
        for d, payload in ((state_dir, state), (best_dir, best_state)):
            if d is not None:
                os.makedirs(os.path.join(self.path, d), exist_ok=True)
                torch.save(payload, os.path.join(self.path, d, _FILE))

        # 2) commit: atomically point loop.json at them
        prev = self._read_loop() if os.path.isfile(self._loop_path()) else None
        loop = dict(loop)
        loop["state_dir"] = state_dir
        if best_dir is not None:
            loop["best_dir"] = best_dir
        elif prev and prev.get("best_dir"):
            loop["best_dir"] = prev["best_dir"]  # keep the older best alive
        tmp = self._loop_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(loop, f)
        os.replace(tmp, self._loop_path())

        # 3) only now drop the directories loop.json no longer names
        keep = {state_dir, loop.get("best_dir")}
        for d in os.listdir(self.path):
            if (d.startswith(("state_e", "best_e")) and d not in keep
                    and os.path.isdir(os.path.join(self.path, d))):
                shutil.rmtree(os.path.join(self.path, d), ignore_errors=True)

    def restore(self, device="cuda") -> tuple[dict, Optional[dict], dict]:
        """(state, best_state or None, loop), tensors on ``device``."""
        dev = resolve_device(device)
        loop = self._read_loop()

        def load(d):
            return torch.load(os.path.join(self.path, d, _FILE), weights_only=True,
                              map_location=dev)

        state = load(loop["state_dir"])
        best_dir = loop.get("best_dir")
        best = (load(best_dir) if best_dir
                and os.path.isfile(os.path.join(self.path, best_dir, _FILE)) else None)
        return state, best, loop

    def delete(self) -> None:
        if is_main(self.group):
            shutil.rmtree(self.path, ignore_errors=True)
        barrier(self.group)
