"""K2 of block 1 (BN affine + ReLU + 2x2 first-max pool) as its redesigned
kernel computes it, restated in torch on the CPU, vs the port's plain
version and the JAX package's interpret-mode ``_k2_norm_pool`` (CPU).

The CUDA kernel (``csrc/conv_block1.cu``, ``norm_pool_kernel``) runs only on
the card; ``chip_smoke.py`` holds it against the plain version there.  What
it computes is restated here with its geometry (K3's, ``K3Geometry``, over
the pooled grid: H // 2 rows and W // 2 columns, the last row or column of
y floored away when H or W is odd): bands of pooled rows of one (item,
channel), each one block; in the vector path (W a multiple of twice the run,
aligned tensors) runs of 8 adjacent pooled cells in bf16 and 4 in f32 (16
bytes of output), bands of at most 1024 runs in bf16 and 256 in f32;
elsewhere one cell at a time.  Each cell is max(bn(y) over its 2x2 window,
0) with bn = y * scale[c] + shift[c] rounded as two f32 operations, rounded
once to the storage type (one rounding of the max equals the max of the
roundings: rounding to nearest is monotone).

Tolerance: bit-equal, to the plain version, and to JAX's kernel on the same
conv output in bf16.  In f32, JAX's interpret-mode kernel (XLA on the CPU)
contracts y * scale + shift into one fused multiply-add, so its pooled
values differ from the port's by that one rounding (in 23% of the cells at
seed 8, at most 4.8e-7): there it is held bit-equal to the restatement with
the affine contracted.  Inputs carry bf16 ties (windows whose f32 values
differ but round to the same bf16 value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops import pallas_conv as P
from sept_tpu_torch.ops import conv_block1 as K

C, EPS = 32, 1e-5
BF = torch.bfloat16
# the training windows' shape, chip_smoke.py's odd and ragged edges, and its
# wide edge (three column tiles; a width off the bf16 run)
SHAPES = [(2, 200, 128), (1, 37, 29), (3, 64, 33), (1, 27, 264)]
MODES = [torch.float32, BF]


def k2_run(cd):
    """(pooled cells a run: 16 bytes of output, runs a band at most)."""
    return (8, 1024) if cd == BF else (4, 256)


def k2_geometry(h, w, aligned, cd):
    """K3Geometry over the pooled grid, as ``norm_pool`` launches it:
    (vec, per_row, bands, rows, threads)."""
    run, band_max = k2_run(cd)
    ho, wo = h // 2, w // 2
    vec = aligned and w % (2 * run) == 0
    per_row = wo // run if vec else wo
    bands = max(1, min(ho, -(-ho * per_row // band_max)))
    rows = max(1, -(-ho // bands))
    bands = -(-ho // rows)
    per_band = rows * per_row
    best = None
    for it in range(max(1, -(-per_band // 256)), max(1, -(-per_band // 64)) + 1):
        t = max(64, -(-(-(-per_band // it)) // 32) * 32)
        if best is None or it * t - per_band < best[0]:
            best = (it * t - per_band, t)
    return vec, per_row, bands, rows, best[1]


def k2_restated(y, scale, shift, cd, aligned=True, contract=False):
    """The pooled output in ``cd`` as the kernel computes it, item by item of
    each band; asserts that the items cover every pooled cell once and that
    the band's threads take them all.  ``contract``: the affine as one fused
    multiply-add (exact in float64, rounded once), as XLA computes it."""
    b, c, h, w = y.shape
    ho, wo = h // 2, w // 2
    run = k2_run(cd)[0]
    vec, per_row, bands, rows, threads = k2_geometry(h, w, aligned, cd)
    cells = run if vec else 1
    yw = K._wide(y)
    a, sh = scale[None, :, None, None], shift[None, :, None, None]
    out = torch.full((b, c, ho, wo), float("nan"))
    hits = torch.zeros(ho, wo, dtype=torch.long)
    for band in range(bands):
        i0, i1 = band * rows, min(ho, band * rows + rows)
        n_items = (i1 - i0) * per_row
        assert n_items <= threads * -(-n_items // threads)
        r = torch.arange(n_items)
        i = (i0 + r // per_row)[:, None].expand(-1, cells).reshape(-1)
        j = ((r % per_row) * cells)[:, None].add(torch.arange(cells)).reshape(-1)
        if contract:
            z = [(yw[:, :, 2 * i + dh, 2 * j + dw].double() * a[..., 0].double()
                  + sh[..., 0].double()).float() for dh in (0, 1) for dw in (0, 1)]
        else:
            z = [yw[:, :, 2 * i + dh, 2 * j + dw] * a[..., 0] + sh[..., 0]  # (B, C, cells)
                 for dh in (0, 1) for dw in (0, 1)]
        m = torch.maximum(torch.maximum(z[0], z[1]), torch.maximum(z[2], z[3]))
        out[:, :, i, j] = K._wide(K._stored(torch.clamp(m, min=0.0), cd))
        hits.index_put_((i, j), torch.ones_like(i), accumulate=True)
    assert bool((hits == 1).all())
    return K._stored(out, cd)


def _inputs(shape, cd, seed):
    """conv output with bf16 ties planted (the second pixel of every third
    window one bf16 unit above the first) and the eval-mode BN pair."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.standard_normal((b, C, h, w)).astype(np.float32))
    nxt = (y[:, :, 0::2, 0::2].to(BF).float() * (1 + 2.0 ** -7)).to(BF).float()
    y[:, :, 0:2 * (h // 2):6, 1:2 * (w // 2):2] = nxt[:, :, :h // 2:3, :w // 2]
    gamma = torch.from_numpy((1 + 0.3 * rng.standard_normal(C)).astype(np.float32))
    mean = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32))
    var = torch.from_numpy((1 + 0.5 * rng.random(C)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32))
    scale, shift = K.fold_bn(gamma, beta, mean, var, EPS)
    return y.to(cd), scale, shift


def _ties(y, scale, shift):
    """Pooled windows whose f32 maximum is not their first bf16-rounded one."""
    b, c, h, w = y.shape
    z = torch.relu(K._wide(y)[:, :, :h // 2 * 2, :w // 2 * 2] * scale[None, :, None, None]
                   + shift[None, :, None, None])
    cells = z.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(-1, 4)
    rounded = cells.to(BF).float()
    return int(((cells.argmax(-1) != rounded.argmax(-1)) & (rounded.max(-1).values > 0)).sum())


@pytest.mark.parametrize("cd", MODES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k2_runs_match_the_plain_version(shape, cd):
    y, scale, shift = _inputs(shape, cd, seed=7)
    if cd == BF:
        assert _ties(y, scale, shift) > 0
    plain = K.block1_norm_pool_plain(y, scale, shift, cd)
    for aligned in (True, False):  # the vector path where W allows it, and the per-cell one
        ours = k2_restated(y, scale, shift, cd, aligned)
        assert ours.dtype == cd and torch.equal(ours, plain)


@pytest.mark.parametrize("cd", MODES, ids=["f32", "bf16"])
def test_k2_geometry_takes_runs_only_where_they_fit(cd):
    """Runs need W a multiple of twice the run and aligned tensors; a band
    of the training windows' plane is one block in bf16 and 7 in f32, as
    K3's; odd sizes floor the pooled grid."""
    run = k2_run(cd)[0]
    vec, per_row, bands, rows, threads = k2_geometry(200, 128, True, cd)
    assert vec and per_row == 64 // run and threads % 32 == 0 and 64 <= threads <= 256
    assert bands == (1 if cd == BF else 7) and bands * rows >= 100
    assert not k2_geometry(200, 128, False, cd)[0]
    assert not k2_geometry(37, 29, True, cd)[0] and k2_geometry(37, 29, True, cd)[1] == 14
    assert k2_geometry(27, 264, True, cd)[0] == (264 % (2 * run) == 0)
    assert k2_geometry(200, 40, True, cd)[0] == (cd == torch.float32)


@pytest.mark.parametrize("cd", MODES, ids=["f32", "bf16"])
def test_k2_restated_matches_jax_k2_norm_pool(cd):
    """The restated kernel and JAX's interpret-mode _k2_norm_pool (the TPU
    kernel, fixed to 200 x 128 windows) on the same conv output."""
    y, scale, shift = _inputs((2, P.H, P.W), cd, seed=8)
    jcd = jnp.bfloat16 if cd == BF else jnp.float32
    b = y.shape[0]
    lanes = jnp.asarray(K._wide(y).permute(0, 2, 1, 3).reshape(b, P.H, C * P.W).numpy())
    rep = lambda v: P._rep_lanes(jnp.asarray(v.numpy()))  # noqa: E731
    pooled_j = P._run_k2(lanes.astype(jcd), rep(scale), rep(shift), b, C, jcd, True)
    assert pooled_j.dtype == jcd
    pooled_j = np.asarray(jax.device_get(pooled_j.astype(jnp.float32))).transpose(0, 3, 1, 2)
    ours = k2_restated(y, scale, shift, cd)
    if cd == BF:
        assert np.array_equal(ours.float().numpy(), pooled_j)
    else:
        fused = k2_restated(y, scale, shift, cd, contract=True).numpy()
        assert np.array_equal(fused, pooled_j)
        d = np.abs(ours.numpy() - pooled_j)
        assert 0 < (d > 0).mean() < 0.5 and d.max() <= 2.0 ** -22 * np.abs(pooled_j).max()
    if cd == BF:
        assert _ties(y, scale, shift) > 0
