"""Device-resident splits for the epoch runners.

Counterpart of ``sept_tpu/train/device_loop.py::DeviceSplit`` and
``_spk_weight_vec``.  The fold drivers of that module (``fit_device``,
``fit_device_cloak``: early stopping, plateau, resume, the test vote) are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sept_tpu_torch.device import resolve_device

__all__ = ["DeviceSplit"]


class DeviceSplit:
    """One split's windows, labels and weights on the device, padded to a
    multiple of the batch size with copies of row 0 at weight 0.

    ``split`` is any object with ``windows`` (N, T, D), ``labels_emo`` and
    ``labels_gen`` arrays (the JAX package's ``SplitArrays`` qualifies).  The
    pad copies are excluded from loss and metrics by their weight but still
    enter train-mode BatchNorm statistics, as in the JAX package: all-zero
    rows would bias them with out-of-distribution data.
    """

    def __init__(self, split, label_key: str, batch_size: int,
                 extra_weights: Optional[np.ndarray] = None, device="cuda"):
        dev = resolve_device(device)
        n = len(split.windows)
        pad = (-n) % batch_size
        w = np.ones(n + pad, np.float32)
        w[n:] = 0.0
        if extra_weights is not None:
            w[:n] *= extra_weights

        def padded(a, dtype):
            a = np.asarray(a)
            if pad:
                a = np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
            return torch.as_tensor(a, dtype=dtype, device=dev)

        self.windows = padded(split.windows, torch.float32)
        self.labels_emo = padded(split.labels_emo, torch.long)
        self.labels_gen = padded(split.labels_gen, torch.long)
        self.labels = self.labels_gen if label_key == "labels_gen" else self.labels_emo
        self.weights = torch.as_tensor(w, device=dev)
        self.n_real = n
        self.n_batches = (n + pad) // batch_size
        self.batch_size = batch_size


def _spk_weight_vec(split, spk_weights: Optional[dict]) -> Optional[np.ndarray]:
    """Per-row combine-mode loss weights ``spk_weights["{speaker}_{dataset}"]``
    (1 for a missing key), from ``split.speaker_ids`` and ``split.datasets``."""
    if spk_weights is None:
        return None
    return np.array([spk_weights.get(f"{s}_{d}", 1.0)
                     for s, d in zip(split.speaker_ids, split.datasets)], dtype=np.float32)
