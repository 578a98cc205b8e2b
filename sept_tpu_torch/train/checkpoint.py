"""Checkpoints of the protocol's artifacts.

Counterpart of ``sept_tpu/train/checkpoint.py``.  The reference saves a
best-by-validation state_dict per fold under a directory tree that encodes
every hyperparameter; its stages load one another (the cloak loads the
baseline, a suppressed cloak the suppression-0 cloak, the sweep all three).
Here each artifact is a torch state_dict under a flat key,
``<output_dir>/<artifact>/fold<k>/state_dict.pt``, with a JSON manifest
``<output_dir>/<artifact>/manifest_fold<k>.json`` beside it: the JAX
package's layout, with ``torch.save`` where it writes Orbax.  A state_dict
is read back with ``weights_only=True`` onto the device asked for.
JAX-trained weights cross over only in the tests, through
:mod:`sept_tpu_torch.compat.from_jax`.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from sept_tpu_torch.device import resolve_device
from sept_tpu_torch.utils.logging import _jsonable

__all__ = ["CheckpointManager", "artifact_path"]

STATE_FILE = "state_dict.pt"


def artifact_path(output_dir: str, artifact: str, fold: int) -> str:
    """e.g. results/baseline_emotion/fold1"""
    return os.path.join(os.path.abspath(output_dir), artifact, f"fold{fold}")


class CheckpointManager:
    """Save and restore state_dicts and a JSON manifest per fold."""

    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)

    def save(self, artifact: str, fold: int, state_dict: dict,
             manifest: Optional[dict] = None) -> str:
        path = artifact_path(self.output_dir, artifact, fold)
        os.makedirs(path, exist_ok=True)
        # through a temporary file: a reader finds the old state or the new
        # one whole
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(dict(state_dict), tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        if manifest is not None:
            # one manifest per fold, next to (not inside) the state directory
            mpath = os.path.join(os.path.dirname(path), f"manifest_fold{fold}.json")
            with open(mpath, "w") as f:
                json.dump(_jsonable(manifest), f, indent=2)
        return path

    def restore(self, artifact: str, fold: int, device="cuda") -> dict:
        """The artifact's state_dict, its tensors on ``device``."""
        path = os.path.join(artifact_path(self.output_dir, artifact, fold), STATE_FILE)
        return torch.load(path, weights_only=True, map_location=resolve_device(device))

    def exists(self, artifact: str, fold: int) -> bool:
        return os.path.isfile(os.path.join(artifact_path(self.output_dir, artifact, fold),
                                           STATE_FILE))
