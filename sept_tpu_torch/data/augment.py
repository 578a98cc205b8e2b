"""Class-balancing Gaussian-noise augmentation.

Counterpart of ``sept_tpu/data/augment.py``, copied: the same
``np.random.Generator`` draws in the same order, so one seed gives the same
duplicates in both packages.  Oversample minority classes of the *training*
split (by emotion label or by gender, per ``aug``) with copies of randomly
chosen samples plus N(0, 0.05) noise, until every class matches the
majority count (preprocess_adversary_data.py:392-423).  Where the reference
overwrites the clean sample with its noisy copy (it aliases the original
dict into the augmented key), here the original stays clean and the noisy
duplicate is a separate entry, as in the JAX package.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

__all__ = ["balance_classes"]


def balance_classes(
    windows: np.ndarray,
    labels: np.ndarray,
    rng: np.random.Generator,
    noise_std: float = 0.05,
    extra: dict[str, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, dict[str, np.ndarray]]:
    """Oversample minority classes with noisy duplicates.

    windows: (N, ...) feature windows; labels: (N,) class ids to balance on;
    extra: other aligned per-sample arrays to duplicate (labels of the other
    task, speaker ids, global features...).  Returns balanced copies.
    """
    extra = extra or {}
    counts = Counter(labels.tolist())
    max_count = max(counts.values())

    add_windows, add_labels = [], []
    add_extra: dict[str, list] = {k: [] for k in extra}
    for label, count in counts.items():
        if count == max_count:
            continue
        pool = np.flatnonzero(labels == label)
        picks = rng.integers(0, len(pool), size=max_count - count)
        chosen = pool[picks]
        noisy = windows[chosen] + rng.normal(
            0.0, noise_std, size=windows[chosen].shape
        ).astype(windows.dtype)
        add_windows.append(noisy)
        add_labels.append(labels[chosen])
        for k, v in extra.items():
            add_extra[k].append(v[chosen])

    if not add_windows:
        return windows, labels, dict(extra)
    out_windows = np.concatenate([windows] + add_windows)
    out_labels = np.concatenate([labels] + add_labels)
    out_extra = {
        k: np.concatenate([extra[k]] + add_extra[k]) for k in extra
    }
    return out_windows, out_labels, out_extra
