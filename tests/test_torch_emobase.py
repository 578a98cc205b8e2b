"""The port's 988-dim emobase functionals (``sept_tpu_torch/ops/emobase.py``)
vs the JAX package's (``sept_tpu/ops/emobase.py``), on the CPU.

Inputs are ``speechlike`` waves made from a seed.  Tolerances:

- the F0 envelope: the port's closed form (a float64 cumulative max in the
  log domain) against the JAX package's f32 ``lax.scan``, rtol 1e-6 at
  700 and 3,000 frames (the scan rounds once a frame; the closed form
  rounds once, when it casts to f32);
- ``_lld``: each track within 1e-4 of max(|track|, 1); the zero-crossing
  rate and its delta exactly (integer counts times XLA's f32 reciprocal,
  ``functionals.static_mean``);
- ``_reduce`` on JAX's own tracks: rtol 1e-5, atol 1e-5, the relative
  positions of the maxima and minima exactly; skewness and kurtosis within
  1e-3 (a track whose mean is hundreds of times its std, F0 at ~360 Hz
  with std ~0.5, has an f32 mean uncertain by ~1e-7 |mean| sqrt(T), which
  the standardized moments see as up to ~5e-4; measured 2.4e-4);
- the batch path against ``_emobase_batch``: rtol = atol = 2e-3,
  ``tests/test_functionals.py``'s device-vs-oracle bound; one utterance's
  ``emobase_functionals`` against the JAX package's likewise, and equal to
  the batch path's row of its wave where the wave is alone in its bucket.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops import emobase as JM
from sept_tpu_torch.ops import emobase as TM
from sept_tpu_torch.ops import functionals as TFN

from _torch_helpers import speechlike

LENGTHS = (7000, 12000, 15000)  # buckets of 8000 and 16000 samples
BATCH_TOL = 2e-3
ZCR = 2  # the zero-crossing rate's track (its delta is ZCR + 26)


@functools.lru_cache(maxsize=None)
def _waves():
    rng = np.random.default_rng(9)
    return {f"u{i}": speechlike(rng, n) for i, n in enumerate(LENGTHS)}


def _padded(i):
    w = np.zeros(16000, np.float32)
    wave = _waves()[f"u{i}"]
    w[: len(wave)] = wave
    return w


@pytest.mark.parametrize("n", [700, 3000])
def test_f0_envelope_closed_form_matches_the_scan(n):
    """Voiced runs of 50-500 Hz between unvoiced zeros, as ``f0_hz`` is."""
    rng = np.random.default_rng(n)
    x = np.where(rng.random(n) < 0.6, rng.uniform(50, 500, n), 0.0).astype(np.float32)
    x[:5] = 0.0

    def step(carry, v):
        e = jnp.maximum(v, 0.95 * carry)
        return e, e

    want = np.asarray(jax.lax.scan(step, jnp.float32(0.0), jnp.asarray(x))[1])
    got = TM.f0_envelope(torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[:5] == 0).all() and (got >= x).all()


@pytest.mark.parametrize("i", range(len(LENGTHS)))
def test_lld_tracks_match_jax(i):
    w = _padded(i)
    jt = np.asarray(jax.jit(JM._lld)(jnp.asarray(w)))
    tt = TM._lld(torch.from_numpy(w)[None])[0].numpy()
    assert tt.shape == jt.shape == (TFN.n_frames(16000), TM.N_LLD)
    scale = np.maximum(np.abs(jt).max(0), 1.0)
    assert (np.abs(tt - jt) <= 1e-4 * scale).all(), (np.abs(tt - jt) / scale).max(0)
    np.testing.assert_array_equal(tt[:, [ZCR, ZCR + 26]], jt[:, [ZCR, ZCR + 26]])


def test_reduce_matches_jax_on_jaxs_tracks():
    tracks = [np.asarray(jax.jit(JM._lld)(jnp.asarray(_padded(i)))) for i in range(3)]
    ts = np.asarray([TFN.n_frames(n) for n in LENGTHS], np.int32)
    ours = TM._reduce(torch.from_numpy(np.stack(tracks)), torch.from_numpy(ts)).numpy()
    func = np.arange(TM.N_EMOBASE) % TM.N_FUNCTIONALS
    positions, moments = np.isin(func, (3, 4)), np.isin(func, (11, 12))
    for r in range(3):
        theirs = np.asarray(JM._reduce(jnp.asarray(tracks[r]), ts[r]))
        np.testing.assert_allclose(ours[r][~moments], theirs[~moments], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours[r][moments], theirs[moments], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(ours[r][positions], theirs[positions])


def test_batch_path_matches_jax():
    waves = _waves()
    ours = TM.emobase_functionals_batch(waves, device="cpu")
    assert ours.keys() == waves.keys()
    for ids, W, ts, _ in TFN.chunked_wave_batches(waves, 8000, 64, TFN.n_frames):
        theirs = np.asarray(JM._emobase_batch(jnp.asarray(W), jnp.asarray(ts)))
        for row, u in enumerate(ids):
            assert ours[u].shape == (TM.N_EMOBASE,)
            np.testing.assert_allclose(ours[u], theirs[row], rtol=BATCH_TOL, atol=BATCH_TOL,
                                       err_msg=u)


@pytest.mark.parametrize("i", range(len(LENGTHS)))
def test_single_utterance_entry_matches_jax_and_the_batch_row(i):
    wave = _waves()[f"u{i}"]
    ours = TM.emobase_functionals(wave, device="cpu")
    assert ours.shape == (TM.N_EMOBASE,) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, JM.emobase_functionals(wave), rtol=BATCH_TOL,
                               atol=BATCH_TOL)
    alone = TM.emobase_functionals_batch({f"u{i}": wave}, device="cpu")[f"u{i}"]
    np.testing.assert_array_equal(ours, alone)
    if i == 0:  # alone in its bucket in the batch path too
        np.testing.assert_array_equal(
            ours, TM.emobase_functionals_batch(_waves(), device="cpu")["u0"])
