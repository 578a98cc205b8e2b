"""Structured run logging: run manifests and JSONL metrics.

Counterpart of ``sept_tpu/utils/logging.py``: :func:`_jsonable` (shared by
the checkpoint manifests and the mid-fold loop state), :class:`RunManifest`,
one JSON file a run with its config, its environment and its final metrics
(where the JAX package records the jax version and ``jax.devices()``, the
port records torch's and CUDA's versions and the devices' names), and
:class:`MetricsLogger`, an append-only JSONL of per-epoch metric dicts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import numpy as np
import torch

__all__ = ["RunManifest", "MetricsLogger"]


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


class RunManifest:
    def __init__(self, path: str, config: Any = None, device="cpu"):
        """``device``: the run's device; the manifest names every visible
        card for a CUDA device, else ``["cpu"]``."""
        self.path = path
        cuda = torch.device(device).type == "cuda"
        self.data: dict = {
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                        if cuda else ["cpu"]),
            "config": _jsonable(config) if config is not None else None,
            "results": {},
        }

    def record(self, **kv) -> None:
        self.data["results"].update(_jsonable(kv))

    def write(self) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.data, f, indent=2)
        return self.path


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
