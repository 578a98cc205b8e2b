"""The port's corpus featurization and its host bucketing vs the JAX package
(CPU).

``featurize_corpus`` runs the mel kernel's and the floor + DCT kernel's
plain versions here.  Signals have a broadband floor (``speechlike``), where
the f32 mel chains of the two packages agree within 1e-3 dB; the MFCC stacks
are held within 5e-3.  The staging primitives are pinned as
``tests/test_featurize_staging.py`` pins JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.data import featurize as JFZ
from sept_tpu.ops import functionals as JFN
from sept_tpu_torch.data import featurize as FZ
from sept_tpu_torch.ops import functionals as FN

from _torch_helpers import speechlike


def _stage(waves, bucket_len):
    W = np.zeros((len(waves), bucket_len), np.float32)
    ns = np.zeros(len(waves), np.int32)
    for i, w in enumerate(waves):
        W[i, : len(w)] = w
        ns[i] = len(w)
    return W, ns


@pytest.mark.parametrize("pad", [3, 200, 400])
def test_device_reflect_pad_is_bit_equal_to_jax(pad):
    rng = np.random.default_rng(0)
    lengths = [2, pad + 1, 3 * pad, 4 * pad + 11]
    waves = [rng.standard_normal(n).astype(np.float32) for n in lengths]
    W, ns = _stage(waves, max(lengths))
    ours = FZ.device_reflect_pad(torch.from_numpy(W), torch.from_numpy(ns), pad).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(JFZ.device_reflect_pad(jnp.asarray(W), jnp.asarray(ns), pad)))
    for i, w in enumerate(waves):
        want = np.pad(w, (pad, pad), mode="reflect")
        np.testing.assert_array_equal(ours[i, : len(want)], want)
        assert not ours[i, len(want):].any()


def test_device_reflect_pad_short_utterance_multi_reflection():
    """pad > n: np.pad keeps reflecting; the periodic fold agrees."""
    W, ns = _stage([np.arange(1.0, 6.0, dtype=np.float32)], 16)
    ours = FZ.device_reflect_pad(torch.from_numpy(W), torch.from_numpy(ns), 9).numpy()
    want = np.pad(np.arange(1.0, 6.0, dtype=np.float32), (9, 9), mode="reflect")
    np.testing.assert_array_equal(ours[0, : len(want)], want)
    np.testing.assert_array_equal(
        ours, np.asarray(JFZ.device_reflect_pad(jnp.asarray(W), jnp.asarray(ns), 9)))


@pytest.mark.parametrize("spacing", [1.0, 2.0])
def test_padded_gradient_matches_jax(spacing):
    rng = np.random.default_rng(1)
    waves = [rng.standard_normal(n).astype(np.float32) for n in (5, 64, 200)]
    W, ns = _stage(waves, 200)
    ours = FZ._padded_gradient(torch.from_numpy(W), torch.from_numpy(ns), spacing).numpy()
    theirs = np.asarray(JFZ._padded_gradient(jnp.asarray(W), jnp.asarray(ns), spacing))
    np.testing.assert_allclose(ours, theirs, atol=1e-6)
    for i, w in enumerate(waves):
        np.testing.assert_allclose(ours[i, : len(w)], np.gradient(w, spacing), atol=1e-6)
        assert not ours[i, len(w):].any()


@pytest.mark.parametrize("geometric", [True, False])
def test_bucket_indices_equal_jax(geometric):
    lengths = [100, 8000, 8001, 15999, 16000, 40000, 3, 123456]
    assert (FN.bucket_indices(lengths, 8000, geometric)
            == JFN.bucket_indices(lengths, 8000, geometric))
    for n in (1, 799, 800, 801, 5000):
        assert FN.n_frames(n) == JFN.n_frames(n)


@pytest.mark.parametrize("kind", ["float", "int16", "mixed"])
def test_chunked_wave_batches_equal_jax(kind):
    rng = np.random.default_rng(2)
    lengths = [4800, 7000, 12000, 9000, 15000, 3000, 7999]
    waves = {f"u{i}": speechlike(rng, n) for i, n in enumerate(lengths)}
    if kind != "float":
        for i, u in enumerate(waves):
            if kind == "int16" or i % 2:
                waves[u] = (waves[u] * 20000).astype(np.int16)
    ours = list(FN.chunked_wave_batches(waves, 8000, 2, FN.n_frames))
    theirs = list(JFN.chunked_wave_batches(waves, 8000, 2, JFN.n_frames))
    assert len(ours) == len(theirs)
    for (ids_a, W_a, ts_a, ns_a), (ids_b, W_b, ts_b, ns_b) in zip(ours, theirs):
        assert ids_a == ids_b
        assert W_a.dtype == W_b.dtype == (np.int16 if kind == "int16" else np.float32)
        for a, b in ((W_a, W_b), (ts_a, ts_b), (ns_a, ns_b)):
            np.testing.assert_array_equal(a, b)


def _corpus(pcm):
    """Two length buckets (8000 and 16000 samples), 0.3-0.95 s."""
    rng = np.random.default_rng(4)
    waves = {f"u{i}": speechlike(rng, n)
             for i, n in enumerate((4800, 7900, 12000, 15200, 6100))}
    if pcm:
        waves = {u: (w * 20000).astype(np.int16) for u, w in waves.items()}
    return waves


@pytest.mark.parametrize("pcm", [False, True], ids=["float", "int16"])
@pytest.mark.parametrize("feature_type,atol", [("mel_spec", 1e-3), ("mfcc", 5e-3)])
def test_featurize_corpus_matches_jax(feature_type, atol, pcm):
    waves = _corpus(pcm)
    ours = FZ.featurize_corpus(waves, feature_type, include_gemaps=False, batch_size=2,
                               device="cpu")
    theirs = JFZ.featurize_corpus(waves, feature_type, include_gemaps=False, batch_size=2)
    keys = ("mel1", "mel2") if feature_type == "mel_spec" else ("mfcc",)
    hop = 160 if feature_type == "mel_spec" else 200
    for u, w in waves.items():
        assert set(ours[u]) == set(theirs[u]) == set(keys)
        for k in keys:
            t = 1 + len(w) // hop
            assert ours[u][k].shape == theirs[u][k].shape == (
                (128 if k != "mfcc" else 120), t)
            assert ours[u][k].flags.c_contiguous and ours[u][k].base is None
            np.testing.assert_allclose(ours[u][k], theirs[u][k], atol=atol, err_msg=f"{u} {k}")


@pytest.mark.parametrize("feature_type", ["mel_spec", "mfcc"])
def test_featurize_corpus_int16_staging_bitwise_equal(feature_type):
    pcm = _corpus(True)
    as_float = {u: w.astype(np.float32) / 32768.0 for u, w in pcm.items()}
    a = FZ.featurize_corpus(pcm, feature_type, include_gemaps=False, device="cpu")
    b = FZ.featurize_corpus(as_float, feature_type, include_gemaps=False, device="cpu")
    for u in pcm:
        for k in a[u]:
            np.testing.assert_array_equal(a[u][k], b[u][k])


@pytest.mark.parametrize("kwargs", [{}, {"include_gemaps": True},
                                    {"include_gemaps": False, "include_emobase": True}],
                         ids=["default", "gemaps", "emobase"])
def test_featurize_corpus_refuses_the_functionals(kwargs):
    """Once refused, the functionals are now computed: asked for (also by
    default, as in JAX), the store holds exactly the sets JAX's holds,
    ``gemaps`` (88,) and / or ``emobase`` (988,), within rtol = atol = 2e-3
    of JAX's (``tests/test_functionals.py``'s device-vs-oracle bound; the
    functionals' own parity is in tests/test_torch_egemaps.py and
    tests/test_torch_emobase.py)."""
    waves = _corpus(False)
    ours = FZ.featurize_corpus(waves, "mel_spec", feature_len=32, device="cpu", **kwargs)
    theirs = JFZ.featurize_corpus(waves, "mel_spec", feature_len=32, **kwargs)
    for u in waves:
        assert set(ours[u]) == set(theirs[u]) and set(ours[u]) - {"mel1", "mel2"}
        for k in set(ours[u]) & {"gemaps", "emobase"}:
            assert ours[u][k].shape == theirs[u][k].shape == ((88,) if k == "gemaps" else (988,))
            np.testing.assert_allclose(ours[u][k], theirs[u][k], rtol=2e-3, atol=2e-3,
                                       err_msg=f"{u} {k}")


def test_featurize_corpus_refuses_an_unknown_feature_type():
    with pytest.raises(ValueError, match="unknown feature_type"):
        FZ.featurize_corpus(_corpus(False), "gemaps", include_gemaps=False)
