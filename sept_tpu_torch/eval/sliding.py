"""Sliding-window softmax-vote inference.

Counterpart of ``sept_tpu/eval/sliding.py``.  The reference's test-time
protocol (a window of win_len frames slid by shift_len over each
utterance, softmax each window, mean the probabilities, argmax) becomes one
forward per padded utterance batch:

- test utterances arrive padded to a shared max frame count with a
  ``lengths`` vector (:class:`sept_tpu_torch.data.pipeline.SplitArrays`);
- every window position of the padded batch, ``(max_t - win) // shift + 1``
  of them, goes through one model forward, then windows whose start lies
  past the utterance's valid range drop out of the probability mean;
- the valid count is the reference's ``max((len - win) // shift, 0) + 1``:
  at least one window (short utterances were zero-padded upstream).

``head_sizes`` splits multi-head logits (``(4, 2)`` for the sweep's joint
emotion + gender forward) and softmaxes each head on its own before the
vote.  With the global feature, each utterance's (88,) vector is repeated
over its windows and goes to ``logits_fn`` beside them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sept_tpu_torch.device import resolve_device

__all__ = ["sliding_vote", "make_sliding_vote_fn", "vote_split"]


def make_sliding_vote_fn(logits_fn: Callable, win_len: int = 200, shift_len: int = 50,
                         head_sizes: Optional[Sequence[int]] = None):
    """``logits_fn(wins (N, 1, win_len, D)[, g (N, 88)]) -> (N, C)`` logits
    (C = sum(head_sizes) when multi-head).  Returns ``vote(specs (B, max_t,
    D), lengths (B,), global_feature=None) -> (probs (B, C), n_valid
    (B,))``, tensors on the specs' device; a (B, 88) ``global_feature`` is
    repeated over each utterance's windows and passed as ``g``."""
    heads = tuple(head_sizes) if head_sizes is not None else None

    def vote(specs: torch.Tensor, lengths: torch.Tensor,
             global_feature: Optional[torch.Tensor] = None):
        b, max_t, d = specs.shape
        dev = specs.device
        n_win = max(0, (max_t - win_len) // shift_len) + 1
        starts = torch.arange(n_win, device=dev) * shift_len
        idx = starts[:, None] + torch.arange(win_len, device=dev)[None, :]
        # a batch shorter than one window reads its last frame again, as
        # JAX's gather clamps an index past the end
        wins = specs[:, idx.clamp(max=max_t - 1), :].reshape(b * n_win, 1, win_len, d)
        if global_feature is None:
            logits = logits_fn(wins)
        else:
            logits = logits_fn(wins, global_feature.repeat_interleave(n_win, 0))
        if heads is None:
            probs = torch.softmax(logits, -1)
        else:
            probs = torch.cat([torch.softmax(part, -1)
                               for part in torch.split(logits, heads, -1)], -1)
        probs = probs.reshape(b, n_win, -1)
        n_valid = torch.clamp((lengths - win_len) // shift_len, min=0) + 1
        valid = torch.arange(n_win, device=dev)[None, :] < n_valid[:, None]
        mean_probs = (probs * valid[..., None]).sum(1) / valid.sum(1).clamp(min=1)[:, None]
        return mean_probs, n_valid

    return vote


def vote_split(vote: Callable, split, win_len: int, batch_size: int = 16,
               device="cuda", use_global: bool = False, group=None) -> np.ndarray:
    """Voted probabilities (N, C) of a split's whole utterances, as numpy:
    ``vote`` (a :func:`make_sliding_vote_fn`) runs on ``device`` (the card
    unless the caller passes ``"cpu"``), ``batch_size`` utterances a call;
    the last batch is padded with zero utterances of ``win_len`` frames,
    whose rows are cut.  ``use_global``: each utterance's
    ``split.global_data`` row goes with it (zeros for the pad rows).

    ``group`` (a data-parallel :class:`~sept_tpu_torch.parallel.DataGroup`):
    each batch is padded to a multiple of the world size (batch boundaries
    stay at ``batch_size``), each rank votes its rows of it, and one
    all-reduce of a zero-filled buffer gives every rank every row (gloo has
    no all-gather on CUDA tensors), as the JAX package shards a batch over
    its mesh."""
    device = resolve_device(device)
    n_dev = 1 if group is None else group.world_size
    pad_to = -(-batch_size // n_dev) * n_dev
    k = pad_to // n_dev
    first = 0 if group is None else group.rank * k
    probs = []
    n = len(split)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        pad = pad_to - (hi - lo)
        specs, lengths = split.windows[lo:hi], split.lengths[lo:hi]
        g = split.global_data[lo:hi].astype(np.float32) if use_global else None
        if pad:
            specs = np.concatenate([specs, np.zeros((pad,) + specs.shape[1:], specs.dtype)])
            lengths = np.concatenate([lengths, np.full(pad, win_len, np.int32)])
            if g is not None:
                g = np.concatenate([g, np.zeros((pad, g.shape[1]), g.dtype)])
        rows = slice(first, first + k)
        p, _ = vote(torch.as_tensor(specs[rows], device=device),
                    torch.as_tensor(lengths[rows], device=device),
                    None if g is None else torch.as_tensor(g[rows], device=device))
        probs.append(p)
    if not probs:
        return np.zeros((0, 0), np.float32)
    if group is not None:
        full = torch.zeros((len(probs), pad_to, probs[0].shape[1]), dtype=probs[0].dtype,
                           device=probs[0].device)
        full[:, first:first + k] = torch.stack(probs)
        probs = list(group.sum_(full))
    return np.concatenate([p[: min(batch_size, n - i * batch_size)].cpu().numpy()
                           for i, p in enumerate(probs)])


def sliding_vote(logits_fn: Callable, specs, lengths, win_len: int = 200,
                 shift_len: int = 50, device="cuda", global_feature=None):
    """One-shot helper: (predictions (B,), mean probabilities (B, C)) as
    numpy arrays.  ``specs``, ``lengths`` and ``global_feature`` (B, 88) or
    None go to ``device``, the one ``logits_fn``'s model is on (the card
    unless the caller passes ``"cpu"``)."""
    device = resolve_device(device)
    g = None if global_feature is None else torch.as_tensor(global_feature, device=device)
    probs, _ = make_sliding_vote_fn(logits_fn, win_len, shift_len)(
        torch.as_tensor(specs, device=device), torch.as_tensor(lengths, device=device), g)
    probs = probs.cpu().numpy()
    return np.argmax(probs, -1), probs
