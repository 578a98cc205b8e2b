"""The port's 88-dim gemaps functionals (``sept_tpu_torch/ops/egemaps.py``)
vs the JAX package's (``sept_tpu/ops/egemaps.py``), on the CPU.

Inputs are ``speechlike`` waves (two tones over a broadband floor) made
from a seed.  Tolerances, stage by stage:

- ``yin_pitch``: f0 within 1e-4 semitones, the pitch strength within 1e-5,
  the voicing flags equal wherever the strength lies more than 1e-5 from
  the 0.5 threshold (a frame at the threshold may flip on a rounding;
  none of these frames does);
- ``lpc_formants``: frequencies within rtol 1e-4, levels within 1e-4 dB;
- ``_lld``: each track within 1e-4 of max(|track|, 1);
- ``_reduce`` on JAX's own tracks: rtol 1e-5, atol 1e-5 (the same
  reduction, sums in another order); the numpy oracle
  ``functionals_reference`` likewise;
- the batch path against ``_gemaps_batch`` on three lengths in two length
  buckets: rtol = atol = 2e-3, ``tests/test_functionals.py``'s
  device-vs-oracle bound;
- one utterance's entries (``egemaps_functionals`` and the oracle
  ``egemaps_functionals_reference``) against the JAX package's at 2e-3,
  the first equal to the batch path's row of its wave.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops import egemaps as JE
from sept_tpu.ops import functionals as JFN
from sept_tpu_torch.ops import egemaps as TE
from sept_tpu_torch.ops import emobase as TM
from sept_tpu_torch.ops import functionals as TFN

from _torch_helpers import speechlike

LENGTHS = (7000, 12000, 15000)  # buckets of 8000 and 16000 samples
BATCH_TOL = 2e-3


@functools.lru_cache(maxsize=None)
def _waves():
    rng = np.random.default_rng(8)
    return {f"u{i}": speechlike(rng, n) for i, n in enumerate(LENGTHS)}


@functools.lru_cache(maxsize=None)
def _frames(i):
    """The raw frames of wave i, zero-padded to its 16000-sample bucket."""
    w = np.zeros(16000, np.float32)
    wave = _waves()[f"u{i}"]
    w[: len(wave)] = wave
    return w, np.array(JFN.lld_stft_preamble(jnp.asarray(w))[0])


@pytest.mark.parametrize("i", range(len(LENGTHS)))
def test_yin_pitch_matches_jax(i):
    _, frames = _frames(i)
    jf0, jv, js = (np.asarray(a) for a in jax.jit(JE.yin_pitch)(jnp.asarray(frames)))
    tf0, tv, ts = (a.numpy() for a in TE.yin_pitch(torch.from_numpy(frames)))
    np.testing.assert_allclose(tf0, jf0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    off_threshold = np.abs(js - 0.5) > 1e-5
    np.testing.assert_array_equal(tv[off_threshold], jv[off_threshold])
    assert jv.any()  # the tones are voiced


@pytest.mark.parametrize("i", range(len(LENGTHS)))
def test_lpc_formants_match_jax(i):
    _, frames = _frames(i)
    jf, jl = (np.asarray(a) for a in jax.jit(JE.lpc_formants)(jnp.asarray(frames)))
    tf, tl = (a.numpy() for a in TE.lpc_formants(torch.from_numpy(frames)))
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=0)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)


@pytest.mark.parametrize("i", range(len(LENGTHS)))
def test_lld_tracks_match_jax(i):
    w, _ = _frames(i)
    jt = np.asarray(jax.jit(JE._lld)(jnp.asarray(w)))
    tt = TE._lld(torch.from_numpy(w)[None])[0].numpy()
    assert tt.shape == jt.shape == (TFN.n_frames(16000), 37)
    scale = np.maximum(np.abs(jt).max(0), 1.0)
    assert (np.abs(tt - jt) <= 1e-4 * scale).all(), (np.abs(tt - jt) / scale).max(0)


def test_reduce_and_oracle_match_jax_on_jaxs_tracks():
    """Both reductions and both numpy oracles on the same (JAX) tracks,
    rows of different valid counts reduced as one batch by the port."""
    tracks, ts, ns = [], [], []
    for i, n in enumerate(LENGTHS):
        w, _ = _frames(i)
        tracks.append(np.asarray(jax.jit(JE._lld)(jnp.asarray(w))))
        ts.append(TFN.n_frames(n))
        ns.append(n)
    ts, ns = np.asarray(ts, np.int32), np.asarray(ns, np.int32)
    ours = TE._reduce(torch.from_numpy(np.stack(tracks)), torch.from_numpy(ts),
                      torch.from_numpy(ns)).numpy()
    for r in range(len(LENGTHS)):
        theirs = np.asarray(JE._reduce(jnp.asarray(tracks[r]), ts[r], jnp.asarray(ns[r])))
        np.testing.assert_allclose(ours[r], theirs, rtol=1e-5, atol=1e-5)
        ref = TE.functionals_reference(tracks[r][: ts[r]], int(ns[r]))
        np.testing.assert_allclose(ref, JE.functionals_reference(tracks[r][: ts[r]], int(ns[r])),
                                   rtol=1e-5, atol=1e-5)


def test_batch_path_matches_jax_and_the_oracle():
    """``egemaps_functionals_batch`` (the port's buckets and pow2 chunks)
    against JAX's ``_gemaps_batch`` on the same staged chunks, and against
    the port's own numpy oracle on the port's tracks (JAX's
    device-vs-oracle bound)."""
    waves = _waves()
    ours = TE.egemaps_functionals_batch(waves, device="cpu")
    for ids, W, ts, ns in TFN.chunked_wave_batches(waves, 8000, 64, TFN.n_frames):
        theirs = np.asarray(JE._gemaps_batch(jnp.asarray(W), jnp.asarray(ts), jnp.asarray(ns)))
        tracks = TE._lld(torch.from_numpy(W)).numpy()
        for row, u in enumerate(ids):
            assert ours[u].shape == (TE.N_GEMAPS,)
            np.testing.assert_allclose(ours[u], theirs[row], rtol=BATCH_TOL, atol=BATCH_TOL,
                                       err_msg=u)
            ref = TE.functionals_reference(tracks[row, : ts[row]], int(ns[row]))
            np.testing.assert_allclose(ours[u], ref, rtol=BATCH_TOL, atol=BATCH_TOL)
    assert ours.keys() == waves.keys()


def test_combined_path_equals_the_separate_paths_and_int16_staging():
    """``combined_functionals_batch`` shares one preamble and one pitch a
    chunk: the same vectors as the two batch paths, bit for bit; int16 PCM
    staging (normalized on the device) equals float staging bit for bit."""
    waves = _waves()
    gem, emo = TM.combined_functionals_batch(waves, device="cpu")
    sep_g = TE.egemaps_functionals_batch(waves, device="cpu")
    sep_e = TM.emobase_functionals_batch(waves, device="cpu")
    pcm = {u: (w * 20000).astype(np.int16) for u, w in waves.items()}
    pcm_g, pcm_e = TM.combined_functionals_batch(pcm, device="cpu")
    as_float = {u: w.astype(np.float32) / 32768.0 for u, w in pcm.items()}
    float_g, float_e = TM.combined_functionals_batch(as_float, device="cpu")
    for u in waves:
        np.testing.assert_array_equal(gem[u], sep_g[u])
        np.testing.assert_array_equal(emo[u], sep_e[u])
        np.testing.assert_array_equal(pcm_g[u], float_g[u])
        np.testing.assert_array_equal(pcm_e[u], float_e[u])


@pytest.mark.parametrize("entry", ["egemaps_functionals", "egemaps_functionals_reference"])
def test_single_utterance_entries_match_jax_and_the_batch_row(entry):
    """The first wave (alone in its bucket in the batch path, so its chunk
    is the batch path's) through one utterance's entry of each package."""
    wave = _waves()["u0"]
    row = TE.egemaps_functionals_batch(_waves(), device="cpu")["u0"]
    if entry == "egemaps_functionals":
        ours = TE.egemaps_functionals(wave, device="cpu")
        np.testing.assert_array_equal(ours, row)
    else:
        ours = TE.egemaps_functionals_reference(wave)
        np.testing.assert_allclose(ours, row, rtol=BATCH_TOL, atol=BATCH_TOL)
    assert ours.shape == (TE.N_GEMAPS,) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, getattr(JE, entry)(wave), rtol=BATCH_TOL, atol=BATCH_TOL)
