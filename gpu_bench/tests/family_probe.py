"""A model family module for the tests: ``reference/cnn_bigru.py``'s, which
wraps ``reference/model.py``, with each of its functions recorded in
``CALLED`` as it runs."""

from gpu_bench.reference import cnn_bigru as _base

CALLED = set()
PRECISIONS, STATE_KINDS = _base.PRECISIONS, _base.STATE_KINDS
TINY, PUBLISHED = _base.TINY, _base.PUBLISHED
FUNCTIONS = [n for n in _base.__all__ if callable(getattr(_base, n))]


def _recorded(name):
    fn = getattr(_base, name)

    def call(*args, **kwargs):
        CALLED.add(name)
        return fn(*args, **kwargs)

    return call


globals().update({n: _recorded(n) for n in FUNCTIONS})
