"""Structured run logging: JSONL metrics.

Counterpart of ``sept_tpu/utils/logging.py``: :func:`_jsonable` (shared by
the checkpoint manifests and the mid-fold loop state) and
:class:`MetricsLogger`, an append-only JSONL of per-epoch metric dicts.
``RunManifest`` comes with the CLIs (ROADMAP.md §1 item 9).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

__all__ = ["MetricsLogger"]


def _jsonable(obj):
    """Dataclasses, dicts, sequences, arrays, tensors and numpy scalars as
    plain JSON values (NaN stays a float: ``json.dump`` writes it as NaN)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


class MetricsLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def log(self, **kv) -> None:
        kv.setdefault("t", time.time())
        self._f.write(json.dumps(_jsonable(kv)) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
