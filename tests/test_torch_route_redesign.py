"""K3 of block 1 (the pool-routing backward) as its redesigned kernel
computes it, restated in torch on the CPU, vs the port's plain version and
the JAX package's interpret-mode ``_k3_route`` (CPU).

The CUDA kernel (``csrc/conv_block1.cu``, ``route_kernel``) runs only on
the card; ``chip_smoke.py`` holds it against the plain version there.  What
it computes is restated here with its geometry (``K3Geometry``): bands of
cell rows of one (item, channel), each one block; in the vector path (W a
multiple of twice the run, aligned tensors) runs of 8 adjacent cells in
bf16 and 4 in f32, bands of at most 1024 runs in bf16 and 256 in f32, run
r of a band taken by thread r % threads; elsewhere one cell at a time; cells past the
pooled grid route nothing.  Each cell routes its cotangent to the first
maximum of relu(bn) rounded to the storage type, compared in row-major
order, where bn > 0.  A thread sums its runs in f32, a warp its 32 threads,
the block its warps, and the blocks' partial sums are added in double.

Tolerances are ``chip_smoke.py``'s: dy bit-equal to the plain version (and
to JAX's kernel on the same conv output), the sums within 1e-5 of the sums
of |terms|.  Inputs carry bf16 ties: windows whose f32 values differ but
round to the same bf16 maximum, where the first of them takes the
cotangent.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops import pallas_conv as P
from sept_tpu_torch.ops import conv_block1 as K

C, EPS = 32, 1e-5
BF = torch.bfloat16
SUMS_RTOL = 1e-5
# the training windows' shape, chip_smoke.py's K4_EDGES odd and ragged
# shapes, and its wide edge (three column tiles; a width off the run)
SHAPES = [(2, 200, 128), (1, 37, 29), (3, 64, 33), (1, 27, 264)]
MODES = [torch.float32, BF]


def k3_run(cd):
    """(cells a run: 16 bytes of the pooled cotangent, runs a band at most)."""
    return (8, 1024) if cd == BF else (4, 256)


def k3_geometry(h, w, aligned, run, band_max):
    """K3Geometry: (vec, per_row, bands, rows, threads)."""
    vec = aligned and w % (2 * run) == 0
    hc, wc = (h + 1) // 2, (w + 1) // 2
    per_row = wc // run if vec else wc
    bands = max(1, min(hc, -(-hc * per_row // band_max)))
    rows = max(1, -(-hc // bands))
    bands = -(-hc // rows)
    per_band = rows * per_row
    best = None
    for it in range(max(1, -(-per_band // 256)), max(1, -(-per_band // 64)) + 1):
        t = max(64, -(-(-(-per_band // it)) // 32) * 32)
        if best is None or it * t - per_band < best[0]:
            best = (it * t - per_band, t)
    return vec, per_row, bands, rows, best[1]


def k3_restated(y, dp, scale, shift, mean, inv, cd, aligned=True):
    """(dy in ``cd``, (2, C) sums) as the kernel computes them."""
    b, c, h, w = y.shape
    ho, wo, hc, wc = h // 2, w // 2, (h + 1) // 2, (w + 1) // 2
    run, band_max = k3_run(cd)
    vec, per_row, bands, rows, threads = k3_geometry(h, w, aligned, run, band_max)
    col = lambda v: v[None, :, None, None, None]  # noqa: E731
    yw = torch.zeros(b, c, 2 * hc, 2 * wc)
    yw[:, :, :h, :w] = K._wide(y)
    cells = yw.reshape(b, c, hc, 2, wc, 2).permute(0, 1, 2, 4, 3, 5).reshape(b, c, hc, wc, 4)
    bn = cells * col(scale) + col(shift)
    z = K._rounded(torch.relu(bn), cd)
    best = torch.zeros(b, c, hc, wc, dtype=torch.long)
    m = z[..., 0]
    for k in range(1, 4):                      # the first maximum, row-major
        up = z[..., k] > m
        best = torch.where(up, k, best)
        m = torch.where(up, z[..., k], m)
    d = torch.zeros(b, c, hc, wc)
    d[:, :, :ho, :wo] = K._wide(dp)
    g = torch.where((torch.arange(4) == best[..., None]) & (bn > 0), d[..., None], 0.0)
    g[:, :, ho:] = 0.0
    g[:, :, :, wo:] = 0.0
    dy = g.reshape(b, c, hc, wc, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(b, c, 2 * hc, 2 * wc)
    dy = dy[:, :, :h, :w]
    xhat = (cells - col(mean)) * col(inv)
    # run (or cell) r of its band, thread r % threads: f32 sums a thread,
    # a warp, a block; the blocks' partials in double
    i = torch.arange(hc)[:, None]
    j = torch.arange(wc)[None, :]
    r = (i % rows) * per_row + (j // run if vec else j)
    slot = (i // rows) * threads + r % threads                    # (band, thread)
    terms = torch.stack([g.sum(-1), (g * xhat).sum(-1)])          # (2, B, C, hc, wc)
    per_thread = torch.zeros(2, b, c, bands * threads).index_add_(
        -1, slot.flatten(), terms.reshape(2, b, c, -1))
    per_warp = per_thread.view(2, b, c, bands, threads // 32, 32).sum(-1)
    per_block = per_warp.sum(-1)                                  # (2, B, C, bands)
    sums = per_block.double().sum((1, 3)).float()
    return K._stored(dy, cd), sums


def _inputs(shape, cd, seed):
    """conv output with bf16 ties planted (the second pixel of every third
    window one bf16 unit above the first), the pooled cotangent, and the
    eval-mode BN vectors."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.standard_normal((b, C, h, w)).astype(np.float32))
    nxt = (y[:, :, 0::2, 0::2].to(BF).float() * (1 + 2.0 ** -7)).to(BF).float()
    y[:, :, 0:2 * (h // 2):6, 1:2 * (w // 2):2] = nxt[:, :, :h // 2:3, :w // 2]
    y = y.to(cd)
    dp = torch.from_numpy(rng.standard_normal((b, C, h // 2, w // 2)).astype(np.float32)).to(cd)
    gamma = torch.from_numpy((1 + 0.3 * rng.standard_normal(C)).astype(np.float32))
    mean = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32))
    var = torch.from_numpy((1 + 0.5 * rng.random(C)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32))
    scale, shift = K.fold_bn(gamma, beta, mean, var, EPS)
    return y, dp, scale, shift, mean, torch.rsqrt(var + EPS)


def _ties(y, scale, shift):
    """Windows whose f32 maximum is not their first bf16-rounded maximum."""
    b, c, h, w = y.shape
    z = torch.relu(K._wide(y)[:, :, :h // 2 * 2, :w // 2 * 2] * scale[None, :, None, None]
                   + shift[None, :, None, None])
    cells = z.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(-1, 4)
    rounded = cells.to(BF).float()
    return int(((cells.argmax(-1) != rounded.argmax(-1)) & (rounded.max(-1).values > 0)).sum())


def _sums_close(ours, plain, dy, y, mean, inv):
    xhat = (K._wide(y) - mean[None, :, None, None]) * inv[None, :, None, None]
    g = K._wide(dy)
    terms = torch.stack([g.abs().sum((0, 2, 3)), (g * xhat).abs().sum((0, 2, 3))])
    assert float(((ours - plain).abs() / terms.clamp(min=1e-30)).max()) <= SUMS_RTOL


@pytest.mark.parametrize("cd", MODES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k3_runs_match_the_plain_version(shape, cd):
    y, dp, scale, shift, mean, inv = _inputs(shape, cd, seed=5)
    if cd == BF:
        assert _ties(y, scale, shift) > 0
    dy_p, sums_p = K.block1_route_plain(y, dp, scale, shift, mean, inv, cd)
    for aligned in (True, False):  # the vector path where W allows it, and the per-cell one
        dy, sums = k3_restated(y, dp, scale, shift, mean, inv, cd, aligned)
        assert dy.dtype == cd and torch.equal(dy, dy_p)
        _sums_close(sums, sums_p, dy_p, y, mean, inv)


@pytest.mark.parametrize("cd", MODES, ids=["f32", "bf16"])
def test_k3_restated_matches_jax_k3_route(cd):
    """The restated kernel and JAX's interpret-mode _k3_route (the TPU
    kernel, fixed to 200 x 128 windows) on the same conv output."""
    y, dp, scale, shift, mean, inv = _inputs((2, P.H, P.W), cd, seed=6)
    jcd = jnp.bfloat16 if cd == BF else jnp.float32
    b = y.shape[0]
    lanes = jnp.asarray(K._wide(y).permute(0, 2, 1, 3).reshape(b, P.H, C * P.W).numpy())
    dpl = jnp.asarray(K._wide(dp).permute(0, 2, 3, 1).numpy())
    rep = lambda v: P._rep_lanes(jnp.asarray(v.numpy()))  # noqa: E731
    per_item, full = P._per_item, P._full
    dy_j, red = P._grid_call(
        P._k3_route,
        [per_item((P.H, C * P.W)), per_item((P.HP, P.WP, C))] + [full((1, C * P.W))] * 4
        + [full((P.HP, P.H)), full((P.W, P.WP)), full((P.H, P.HP)), full((P.WP, P.W))],
        [(per_item((P.H, C * P.W)), jax_struct((b, P.H, C * P.W), jcd)),
         (full((2, C * P.W)), jax_struct((2, C * P.W), jnp.float32))],
        b, True, cdtype=jcd, c_out=C,
    )(lanes.astype(jcd), dpl.astype(jcd), rep(scale), rep(shift), rep(mean), rep(inv),
      jnp.asarray(P._row_even_selector()), jnp.asarray(P._lane_even_selector()),
      jnp.asarray(P._row_replicator()), jnp.asarray(P._lane_replicator()))
    dy_j = np.asarray(dy_j.astype(jnp.float32)).reshape(b, P.H, C, P.W).transpose(0, 2, 1, 3)
    sums_j = torch.from_numpy(np.array(P._fold_lanes(red, C)))
    dy, sums = k3_restated(y, dp, scale, shift, mean, inv, cd)
    assert np.array_equal(dy.float().numpy(), dy_j)
    _sums_close(sums, sums_j, dy, y, mean, inv)
    if cd == BF:
        assert _ties(y, scale, shift) > 0


def jax_struct(shape, dtype):
    import jax

    return jax.ShapeDtypeStruct(shape, dtype)
