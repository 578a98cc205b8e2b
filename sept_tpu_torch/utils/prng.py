"""Named, deterministic random streams over explicit ``torch.Generator``s.

Counterpart of ``sept_tpu/utils/prng.py``.  Every consumer of randomness
(cloak noise, dropout, augmentation) takes a generator of its own, drawn
from one seeded sequence and, with a name, derived from it by the same
digest as the JAX package's :func:`fold_in_name`.  The streams are
torch's (Philox on a card, mt19937 on the CPU), not threefry: they are
deterministic and distinct by name, not equal to the JAX package's.
"""

from __future__ import annotations

import hashlib
import numbers

import torch

from sept_tpu_torch.device import resolve_device

__all__ = ["KeySeq", "fold_in_name"]

_MASK63 = (1 << 63) - 1


def _digest(name: str) -> int:
    """The first 4 bytes of sha256(name), big-endian (the JAX package's)."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")


def fold_in_name(seed: int, name: str) -> int:
    """A seed derived deterministically from ``seed`` and a string tag."""
    mixed = hashlib.sha256(f"{int(seed)}:{_digest(name)}".encode()).digest()
    return int.from_bytes(mixed[:8], "big") & _MASK63


class KeySeq:
    """A seeded sequence of generators: ``ks = KeySeq(8, "cpu"); g1 = ks();
    g2 = ks("noise")``.  Each call returns a fresh ``torch.Generator`` on
    ``device``, seeded from the sequence's own stream and, with a name,
    folded by :func:`fold_in_name`.  ``seed_or_generator``: an integer
    (numpy integers too) or a ``torch.Generator`` the sequence draws its
    seeds from."""

    def __init__(self, seed_or_generator, device="cuda"):
        self.device = resolve_device(device)
        if isinstance(seed_or_generator, numbers.Integral):
            self._gen = torch.Generator().manual_seed(int(seed_or_generator))
        elif isinstance(seed_or_generator, torch.Generator):
            self._gen = seed_or_generator
        else:
            raise TypeError(f"KeySeq takes an integer seed or a torch.Generator, not "
                            f"{type(seed_or_generator).__name__}")

    def __call__(self, name: str | None = None) -> torch.Generator:
        seed = int(torch.randint(0, _MASK63, (), generator=self._gen,
                                 device=self._gen.device))
        if name is not None:
            seed = fold_in_name(seed, name)
        return torch.Generator(device=self.device).manual_seed(seed)
