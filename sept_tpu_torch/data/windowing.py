"""Utterance windowing and padding.

Counterpart of ``sept_tpu/data/windowing.py``, copied.  The reference's
rules (preprocess_adversary_data.py:20-83):

- training/validation/adversary splits: slide a ``win_len``-frame window with
  stride ``shift_len = win_len // 4`` over the (T, D) feature matrix;
  ``n_windows = (T - win_len) // shift_len + 1``;
- utterances shorter than ``win_len`` produce ONE zero-padded window;
- test utterances are stored WHOLE, one entry per utterance, un-windowed;
  the sliding-window vote happens at eval time.
"""

from __future__ import annotations

import numpy as np

__all__ = ["window_utterance", "num_windows", "pad_to"]


def num_windows(t: int, win_len: int, shift_len: int, shift: bool = True) -> int:
    """Window count for a T-frame utterance (preprocess_adversary_data.py:43-48)."""
    if not shift or t < win_len:
        return 1
    return (t - win_len) // shift_len + 1


def pad_to(data: np.ndarray, win_len: int) -> np.ndarray:
    """Zero-pad a (T, D) matrix to (win_len, D) (the NaN-pad + fillna(0) at
    preprocess_adversary_data.py:29-34)."""
    out = np.zeros((win_len, data.shape[1]), dtype=data.dtype)
    out[: len(data)] = data
    return out


def window_utterance(
    data: np.ndarray,
    win_len: int = 200,
    shift_len: int | None = None,
    shift: bool = True,
) -> np.ndarray:
    """Slice (T, D) features into (N, win_len, D) training windows.

    Short utterances yield one zero-padded window.  ``shift_len`` defaults to
    ``win_len // 4`` (preprocess_adversary_data.py:131).
    """
    if shift_len is None:
        shift_len = win_len // 4
    t = len(data)
    if t < win_len:
        return pad_to(data, win_len)[None]
    n = num_windows(t, win_len, shift_len, shift)
    idx = np.arange(n)[:, None] * shift_len + np.arange(win_len)[None, :]
    return np.ascontiguousarray(data[idx])
