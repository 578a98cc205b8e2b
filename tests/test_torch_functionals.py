"""The port's masked reducers and functional preamble
(``sept_tpu_torch/ops/functionals.py``) vs the JAX package's
(``sept_tpu/ops/functionals.py``), on the CPU.

The port reduces a batch of utterances at once: rows of one (B, tracks,
t_pad) tensor with a per-row valid count, where JAX ``vmap``s one row's
program.  Each case holds a batch whose rows have valid counts 1, 2, 7,
29 and t_pad (a full row) against JAX's function applied row by row on the
same seeded numpy inputs.  Tolerances: sums, moments and interpolations
rtol 1e-5 (atol 1e-6; 1e-5 for the third and fourth moments, which cube
and square the deviations): the same terms summed in another order;
orders, positions, counts and sorts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops import functionals as J
from sept_tpu_torch.ops import functionals as T

T_PAD, TRACKS = 37, 5
COUNTS = (1, 2, 7, 29, T_PAD)
RTOL, ATOL = 1e-5, 1e-6


def _case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(COUNTS), TRACKS, T_PAD)).astype(np.float32)
    t = np.asarray(COUNTS, np.int32)
    return x, t


def _port_inputs(x, t):
    tt = torch.from_numpy(t)
    return torch.from_numpy(x), T.frame_mask(T_PAD, tt)[:, None], tt[:, None]


def _jax_rows(fn, x, t, extra=lambda n: ()):
    """fn applied to each row on its own: x (tracks, t_pad), the (t_pad,)
    mask and the scalar count."""
    out = []
    for r, n in enumerate(t):
        res = fn(jnp.asarray(x[r]), J.frame_mask(T_PAD, int(n)), *extra(int(n)))
        out.append(tuple(np.asarray(v) for v in res) if isinstance(res, tuple)
                   else np.asarray(res))
    if isinstance(out[0], tuple):
        return tuple(np.stack(parts) for parts in zip(*out))
    return np.stack(out)


def _close(ours, theirs, atol=ATOL):
    ours = tuple(ours) if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=atol)


def test_frame_mask_matches_jax():
    _, t = _case()
    ours = T.frame_mask(T_PAD, torch.from_numpy(t)).numpy()
    for r, n in enumerate(t):
        np.testing.assert_array_equal(ours[r], np.asarray(J.frame_mask(T_PAD, int(n))))


@pytest.mark.parametrize("name", ["masked_mean", "masked_std", "masked_min", "masked_max",
                                  "masked_moments", "masked_linreg"])
def test_sum_reducers_match_jax(name):
    x, t = _case()
    xt, m, tc = _port_inputs(x, t)
    with_t = name == "masked_linreg"
    ours = getattr(T, name)(xt, m, *((tc,) if with_t else ()))
    theirs = _jax_rows(getattr(J, name), x, t, (lambda n: (n,)) if with_t else (lambda n: ()))
    # the third and fourth moments cube and square the deviations
    _close(ours, theirs, atol=1e-5 if name == "masked_moments" else ATOL)


@pytest.mark.parametrize("name", ["masked_argmax_rel", "masked_argmin_rel"])
def test_positions_match_jax_exactly(name):
    x, t = _case(1)
    xt, m, tc = _port_inputs(x, t)
    ours = getattr(T, name)(xt, m, tc).numpy()
    np.testing.assert_array_equal(ours, _jax_rows(getattr(J, name), x, t, lambda n: (n,)))


@pytest.mark.parametrize("q", [20.0, 25.0, 50.0, 75.0, 80.0])
def test_sort_and_percentiles_match_jax(q):
    """The masked sort is exact (the valid cells ascending, the fill past
    them); the percentiles interpolate as np.percentile does."""
    x, t = _case(2)
    xt, m, tc = _port_inputs(x, t)
    s = T.masked_sort(xt, m)
    js = _jax_rows(J.masked_sort, x, t)
    np.testing.assert_array_equal(s.numpy(), js)
    ours = T.percentile_sorted(s, tc, q).numpy()
    theirs = np.stack([np.asarray(J.percentile_sorted(jnp.asarray(js[r]), int(n), q))
                       for r, n in enumerate(t)])
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    for r, n in enumerate(t):
        np.testing.assert_allclose(ours[r], np.percentile(x[r, :, :n], q, axis=1),
                                   rtol=1e-4, atol=1e-6)


def test_run_stats_and_compact_order_match_jax_exactly():
    rng = np.random.default_rng(3)
    flag = rng.random((len(COUNTS), T_PAD)) < 0.5
    t = np.asarray(COUNTS, np.int32)
    m = T.frame_mask(T_PAD, torch.from_numpy(t))
    mean_len, n_runs = T.run_stats(torch.from_numpy(flag), m)
    order = T.compact_order(torch.from_numpy(flag) & m, T_PAD).numpy()
    for r, n in enumerate(t):
        jm = J.frame_mask(T_PAD, int(n))
        jl, jn = J.run_stats(jnp.asarray(flag[r]), jm)
        assert float(mean_len[r]) == float(jl) and int(n_runs[r]) == int(jn)
        np.testing.assert_array_equal(
            order[r], np.asarray(J.compact_order(jnp.asarray(flag[r]) & jm, T_PAD)))


def test_diff_stats_match_jax():
    """Over each row's first n valid elements, also 1 (no diffs: zeros)."""
    x, t = _case(4)
    ours = T.diff_stats(torch.from_numpy(x), torch.from_numpy(t)[:, None])
    theirs = _jax_rows(lambda xr, _m, n: J.diff_stats(xr, n), x, t, lambda n: (n,))
    _close(ours, theirs)
    assert all(float(v[0, 0]) == 0.0 for v in ours)  # the 1-frame row


def test_static_mean_is_bit_equal_to_jnp_mean():
    """Zero-crossing counts: integer sums, so only the reciprocal's rounding
    decides the value, and it is XLA's."""
    rng = np.random.default_rng(5)
    flips = (rng.random((40, 799)) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(T.static_mean(torch.from_numpy(flips)).numpy(),
                                  np.asarray(jnp.mean(jnp.asarray(flips), axis=1)))


def test_lld_stft_preamble_matches_jax():
    """Uncentered 800-sample Hann frames at hop 160 and their power: the
    frames bit-equal, the power within 1e-5 of its row's largest value (two
    f32 GEMMs summing 800 products in another order)."""
    rng = np.random.default_rng(6)
    waves = rng.standard_normal((3, 8000)).astype(np.float32)
    frames, power = T.lld_stft_preamble(torch.from_numpy(waves))
    for r in range(3):
        jf, jp = (np.asarray(a) for a in J.lld_stft_preamble(jnp.asarray(waves[r])))
        np.testing.assert_array_equal(frames[r].numpy(), jf)
        assert power.shape[1:] == jp.shape == (J.n_frames(8000), J.NFREQ)
        np.testing.assert_allclose(power[r].numpy(), jp, rtol=0,
                                   atol=1e-5 * np.abs(jp).max())


@pytest.mark.parametrize("n", [1, 3, 64, 65, 200])
def test_pow2_rows_and_n_frames_match_jax(n):
    assert T.pow2_rows(n, 64) == J.pow2_rows(n, 64)
    assert T.n_frames(n * 160) == J.n_frames(n * 160)
