"""The arithmetic of block 1's redesigned kernels, restated in torch on the
CPU, vs the port's plain versions and the JAX package's
``block1_reference`` (``sept_tpu/ops/pallas_conv.py``).

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them against
the plain versions there.  What they compute is restated here:

- K5 (``input_grad_mma_kernel``, and the same sum in the FMA kernel): an
  implicit GEMM P[h, w, dw] = sum over (c, dh) of dconv(c, h + dh - 2, w) *
  wf[c, dh, dw] (K = C * 5 row taps, N = dw padded from 5 to 8 with zero
  weights), then the shift-sum dx(h, w) = sum over dw of P[h, w + dw - 2,
  dw], with wf the flipped kernel and dconv and wf rounded to bf16 in the
  bf16 mode;
- K1 (``conv_stats_mma_kernel``): pixels x taps (25 padded to 32 with zeros)
  times taps x channels, the bias added in f32, y rounded once to its
  storage type, and the moments taken of the rounded values.

Tolerances are ``chip_smoke.py``'s: dx within 1e-5 of max |plain|, the f32
conv output 1e-4 and its moments 1e-5 relative, the bf16 conv output within
one bf16 unit and bit-equal in 99.9% of the elements, bf16 moments within
1e-5 of the sums of |terms|.  Against JAX (eval-mode BN, the interpret-mode
Pallas kernels being the JAX suite's slow lane): pooled 1e-4 and dx 1e-4 *
max(|ref|, 1), as ``tests/test_torch_conv_block1_grad.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as tf

from sept_tpu.ops.pallas_conv import block1_reference
from sept_tpu_torch.ops import conv_block1 as K

C, EPS = 32, 1e-5
BF = torch.bfloat16
# the training windows' shape and chip_smoke.py's K4_EDGES (ragged bands,
# odd widths, a multiple of 16 with a ragged band)
SHAPES = [(2, 200, 128), (1, 37, 29), (3, 64, 33), (2, 37, 48)]
MODES = [torch.float32, BF]


def _data(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(b, 1, h, w), weight=0.2 * f(C, 1, 5, 5), bias=0.1 * f(C),
                gamma=1 + 0.1 * f(C), beta=0.1 * f(C), mean=0.1 * f(C),
                var=(1 + 0.5 * rng.random(C)).astype(np.float32),
                cot=f(b, C, h // 2, w // 2), m=0.01 * f(2, C))


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def k1_restated(x, weight, bias, cd):
    """K1 as the tensor-core kernel computes it: (y in ``cd``, (2, C) sums)."""
    b, _, h, w = x.shape
    patches = tf.unfold(K._rounded(x, cd), 5, padding=2)             # (B, 25, HW)
    patches = tf.pad(patches, (0, 0, 0, 7))                          # taps 25 -> 32
    w32 = tf.pad(K._rounded(weight, cd).reshape(C, 25), (0, 7))      # (C, 32)
    y = torch.einsum("bkp,ck->bcp", patches, w32) + bias[:, None]   # f32, then the bias
    y = K._stored(y.reshape(b, C, h, w), cd)                         # rounded once
    yr = K._wide(y)
    return y, torch.stack([yr.sum((0, 2, 3)), (yr * yr).sum((0, 2, 3))])


def k5_restated(conv_out, dy, weight, ga, mean, inv, m1, m2, cd):
    """K5 as P[h, w, dw] (the implicit GEMM, N padded to 8) and its shift-sum."""
    b, _, h, w = conv_out.shape
    dconv = K._rounded(K._dconv(conv_out, dy, ga, mean, inv, m1, m2), cd)
    wf = K._rounded(weight, cd)[:, 0].flip(1, 2)                     # wf[c, dh, dw]
    wf = tf.pad(wf, (0, 3))                                          # N: dw 5 -> 8
    rows = tf.pad(dconv, (0, 0, 2, 2))                               # zero rows above, below
    a = torch.stack([rows[:, :, dh:dh + h] for dh in range(5)], 2)   # (B, C, 5, H, W)
    p = torch.einsum("bcdhw,cde->bhwe", a, wf)                       # K = (c, dh)
    assert (p[..., 5:] == 0).all()
    p = tf.pad(p[..., :5], (0, 0, 2, 2))                             # zero columns
    dx = sum(p[:, :, dw:dw + w, dw] for dw in range(5))              # P[h, w + dw - 2, dw]
    return dx[:, None]


def _backward_inputs(d, cd):
    """conv output and dy in ``cd`` (K3 on the plain conv output), the
    eval-mode BN vectors, and train-like (m1, m2)."""
    t = _t(d)
    y, _ = K.block1_conv_stats_plain(t["x"], t["weight"], t["bias"], cd)
    ga, shift = K.fold_bn(t["gamma"], t["beta"], t["mean"], t["var"], EPS)
    inv = torch.rsqrt(t["var"] + EPS)
    dy, _ = K.block1_route_plain(y, t["cot"].to(cd), ga, shift, t["mean"], inv, cd)
    return t, y, dy, ga, inv


@pytest.mark.parametrize("cd", MODES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k5_gemm_and_shift_sum_match_the_plain_version(shape, cd):
    t, y, dy, ga, inv = _backward_inputs(_data(*shape, seed=1), cd)
    for m1, m2 in ((t["m"][0], t["m"][1]), (torch.zeros(C), torch.zeros(C))):  # train, eval
        ours = k5_restated(y, dy, t["weight"], ga, t["mean"], inv, m1, m2, cd)
        plain = K.block1_input_grad_plain(y, dy, t["weight"], ga, t["mean"], inv, m1, m2, cd)
        assert ours.shape == plain.shape == (shape[0], 1) + shape[1:]
        assert float((ours - plain).abs().max()) <= 1e-5 * float(plain.abs().max())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k5_restated_gives_jax_dx(shape):
    """The eval-mode block's dx with K5 restated against jax.grad of
    block1_reference."""
    d = _data(*shape, seed=2)
    t, y, dy, ga, inv = _backward_inputs(d, torch.float32)
    zero = torch.zeros(C)
    ours = k5_restated(y, dy, t["weight"], ga, t["mean"], inv, zero, zero, torch.float32)
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))  # noqa: E731
    k = jnp.asarray(np.transpose(d["weight"], (2, 3, 1, 0)))
    ref = jax.grad(lambda x: jnp.sum(block1_reference(
        x, k, d["bias"], d["gamma"], d["beta"], d["mean"], d["var"]) * nhwc(d["cot"])))(
        nhwc(d["x"]))
    ref = np.transpose(np.asarray(ref), (0, 3, 1, 2))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("cd", MODES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k1_padded_patch_gemm_matches_the_plain_version(shape, cd):
    t = _t(_data(*shape, seed=3))
    y, sums = k1_restated(t["x"], t["weight"], t["bias"], cd)
    yp, sp = K.block1_conv_stats_plain(t["x"], t["weight"], t["bias"], cd)
    assert y.dtype == yp.dtype == cd and y.shape == yp.shape
    a, b = y.float(), yp.float()
    if cd == torch.float32:
        assert float((a - b).abs().max()) <= 1e-4
        assert float(((sums - sp).abs() / sp.abs().clamp(min=1e-6)).max()) <= 1e-5
    else:
        diff = (a - b).abs()
        units = diff / (2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6)
        assert float(units.max()) <= 1.0 and float((diff == 0).float().mean()) >= 0.999
        terms = torch.stack([b.abs().sum((0, 2, 3)), (b * b).sum((0, 2, 3))])
        assert float(((sums - sp).abs() / terms).max()) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k1_restated_gives_jax_pooled(shape):
    """K1 restated, then K2's plain version, against block1_reference."""
    d = _data(*shape, seed=4)
    t = _t(d)
    y, _ = k1_restated(t["x"], t["weight"], t["bias"], torch.float32)
    pooled = K.block1_norm_pool_plain(y, *K.fold_bn(t["gamma"], t["beta"], t["mean"],
                                                    t["var"], EPS))
    ref = block1_reference(jnp.asarray(np.transpose(d["x"], (0, 2, 3, 1))),
                           jnp.asarray(np.transpose(d["weight"], (2, 3, 1, 0))),
                           d["bias"], d["gamma"], d["beta"], d["mean"], d["var"])
    np.testing.assert_allclose(pooled.numpy(), np.transpose(np.asarray(ref), (0, 3, 1, 2)),
                               atol=1e-4)
