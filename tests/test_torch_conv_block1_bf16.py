"""Block 1's bf16 mode in the PyTorch port (K1-K5 with compute_dtype
bfloat16) vs the JAX package's interpret-mode Pallas kernels with
``compute_dtype=bfloat16`` (CPU).

The port's wrappers take their plain versions on CPU tensors; chip_smoke.py
holds the CUDA kernels against those on the card.  The JAX kernels are fixed
to 200 x 128 windows; every tensor a TPU kernel stores is read back by
wrapping ``pallas_conv._grid_call``.  Both sides round at the same places,
so the stored bf16 tensors differ only where two f32 sums in another order
round to neighbouring bf16 values:

- conv output: within one bf16 unit (2^-7 of |value|) plus 1e-6 where the
  sum cancels to near 0, and bit-equal in at least 99.9% of the elements
  (reading at seed 0: all but 16 of 1,638,400);
- pooled: the same bound, bit-equal in at least 99.9% (reading: 99.9993%);
- dy: bit-equal in at least 99.9% (reading: all), though bf16 rounding ties
  the first maximum of windows whose f32 values differ (65 in train mode,
  89 in eval mode here; the test requires some);
- moments (mean, var) within 1e-5; dW, dgamma and dbeta within 1e-4 of
  max |JAX| (train-mode readings 4.2e-5, 5.0e-6, 6.9e-8; eval mode
  ~2e-7); dx within 1e-3 of max |JAX| (train-mode reading 3.4e-4: a dconv
  value rounds to the other bf16 neighbour where the sums m1, m2 differ in
  their last f32 bits; eval mode 1.9e-7); the train-mode db, 0 in exact
  arithmetic, within B * H * W * 2^-24 of 0 on both sides, as
  tests/test_torch_conv_block1_grad.py holds it; the eval-mode db within
  1e-4 of max |JAX| (reading 1.6e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops import pallas_conv as P
from sept_tpu_torch.ops import conv_block1 as K

C, EPS, B, H, W = 32, 1e-5, 2, 200, 128
BF = torch.bfloat16
NAMES = ("dx", "dW", "db", "dgamma", "dbeta")


def _data(seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((B, H, W, 1)).astype(np.float32),
        k=(rng.standard_normal((5, 5, 1, C)) * 0.2).astype(np.float32),
        bias=(rng.standard_normal(C) * 0.1).astype(np.float32),
        gamma=(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        beta=(0.1 * rng.standard_normal(C)).astype(np.float32),
        mean=(0.1 * rng.standard_normal(C)).astype(np.float32),
        var=(1 + 0.5 * rng.random(C)).astype(np.float32),
        cot=rng.standard_normal((B, H // 2, W // 2, C)).astype(np.float32),
    )


@pytest.fixture
def stored(monkeypatch):
    """{kernel name: its outputs} of every Pallas call made in the test."""
    out = {}
    orig = P._grid_call

    def spy(kernel, *a, **kw):
        call = orig(kernel, *a, **kw)

        def run(*args):
            res = call(*args)
            out[kernel.__name__] = res
            return res
        return run

    monkeypatch.setattr(P, "_grid_call", spy)
    return out


def _nchw_from_lanes(a):
    """The kernels' (B, H, C*W) layout -> (B, C, H, W) f32 numpy."""
    return np.asarray(a.astype(jnp.float32)).reshape(B, H, C, W).transpose(0, 2, 1, 3)


def _torch_leaves(d):
    t = torch.from_numpy
    return [t(d["x"]).permute(0, 3, 1, 2).contiguous().requires_grad_(),
            t(d["k"]).permute(3, 2, 0, 1).contiguous().requires_grad_(),
            t(d["bias"]).requires_grad_(), t(d["gamma"]).requires_grad_(),
            t(d["beta"]).requires_grad_()]


def _within_one_bf16_unit(got, want):
    """Bit-equal share; asserts |got - want| <= 2^-7 max(|got|, |want|) + 1e-6."""
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6
    assert (np.abs(got - want) <= bound).all()
    return float((got == want).mean())


def _spy_route(monkeypatch):
    seen = {}
    orig = K.block1_route

    def spy(*a):
        out = orig(*a)
        seen["dy"] = out[0]
        return out

    monkeypatch.setattr(K, "block1_route", spy)
    return seen


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bf16_mode_matches_jax_interpret_kernels(stored, monkeypatch, train):
    d = _data(0 if train else 1)
    args = [jnp.asarray(d[n]) for n in ("x", "k", "bias", "gamma", "beta")]
    cot = jnp.asarray(d["cot"]).astype(jnp.bfloat16)
    if train:
        fn = lambda *a: P.fused_block1_train(*a, C, True, jnp.bfloat16)  # noqa: E731
        (pooled_j, mean_j, var_j), vjp = jax.vjp(fn, *args)
        grads_j = vjp((cot, jnp.zeros_like(mean_j), jnp.zeros_like(var_j)))
    else:
        stats = (jnp.asarray(d["mean"]), jnp.asarray(d["var"]))
        fn = lambda *a: P.fused_block1_eval(*a, *stats, C, True, jnp.bfloat16)  # noqa: E731
        pooled_j, vjp = jax.vjp(fn, *args)
        grads_j = vjp(cot)

    leaves = _torch_leaves(d)
    seen = _spy_route(monkeypatch)
    if train:
        pooled, mean, var = K.Block1Train.apply(*leaves, EPS, BF)
        np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=1e-5)
        np.testing.assert_allclose(var.numpy(), np.asarray(var_j), atol=1e-5)
    else:
        pooled = K.Block1Eval.apply(*leaves, torch.from_numpy(d["mean"]),
                                    torch.from_numpy(d["var"]), EPS, BF)
    assert pooled.dtype == BF

    # the stored bf16 tensors: conv output (K1), pooled (K2), dy (K3)
    conv = K.block1_conv_stats(*(t.detach() for t in leaves[:3]), BF)[0]
    assert conv.dtype == BF
    share = _within_one_bf16_unit(conv.float().numpy(),
                                  _nchw_from_lanes(stored["_k1_conv_stats"][0]))
    assert share >= 0.999
    want_pool = np.asarray(pooled_j.astype(jnp.float32)).transpose(0, 3, 1, 2)
    assert _within_one_bf16_unit(pooled.detach().float().numpy(), want_pool) >= 0.999

    cot_t = torch.from_numpy(d["cot"]).permute(0, 3, 1, 2).to(BF)
    grads = torch.autograd.grad(pooled, leaves, cot_t)
    dy = seen["dy"]
    assert dy.dtype == BF
    dy_j = _nchw_from_lanes(stored["_k3_route"][0])
    assert (dy.float().numpy() == dy_j).mean() >= 0.999
    # windows whose first maximum is a bf16 tie of distinct f32 values
    moments = (mean, var) if train else (torch.from_numpy(d["mean"]),
                                         torch.from_numpy(d["var"]))
    scale, shift = (t.detach()[None, :, None, None]
                    for t in K.fold_bn(leaves[3], leaves[4], *moments, EPS))
    z = torch.relu(conv.float() * scale + shift)
    cells = z.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(-1, 4)
    rounded = cells.to(BF).float()
    ties = ((rounded == rounded.max(-1, keepdim=True).values).sum(-1) > 1) & (
        rounded.max(-1).values > 0) & (cells.argmax(-1) != rounded.argmax(-1))
    assert int(ties.sum()) > 0

    n = B * H * W
    for name, g, r in zip(NAMES, grads, grads_j):
        r = np.asarray(r)
        r = {"dx": lambda a: a.transpose(0, 3, 1, 2),
             "dW": lambda a: a.transpose(3, 2, 0, 1)}.get(name, lambda a: a)(r)
        g = g.numpy()
        assert g.dtype == np.float32, name
        if name == "db" and train:
            assert np.abs(g).max() <= n * 2.0 ** -24 and np.abs(r).max() <= n * 2.0 ** -24
            continue
        tol = 1e-3 if name == "dx" else 1e-4
        np.testing.assert_allclose(g, r, atol=tol * np.abs(r).max(), err_msg=name)


def test_bf16_routing_takes_the_first_of_rounded_ties():
    """K3 in bf16 compares z rounded to bf16: values that differ in f32 but
    round alike tie, and the first of them (row-major) takes the cotangent.
    In f32 the largest takes it."""
    # bn = y + 1000: bf16 holds multiples of 4 there, so 1000.5, 1001 and
    # 1001.5 all round to 1000
    y = torch.tensor([[0.5, 1.0], [1.5, 0.25]])[None, None]
    one, shift, zero = torch.ones(1), torch.full((1,), 1000.0), torch.zeros(1)
    cot = torch.full((1, 1, 1, 1), 3.0)
    dy16, sums = K.block1_route(y.to(BF), cot.to(BF), one, shift, zero, one, BF)
    dy32, _ = K.block1_route(y, cot, one, shift, zero, one)
    assert dy16.dtype == BF
    assert dy16.float().flatten().tolist() == [3.0, 0.0, 0.0, 0.0]
    assert dy32.flatten().tolist() == [0.0, 0.0, 3.0, 0.0]
    assert sums.tolist() == [[3.0], [1.5]]
    # K2 stores the same rounded maximum
    assert K.block1_norm_pool(y.to(BF), one, shift, BF).float().item() == 1000.0


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("x_grad,params_grad,want", [
    (False, True, {"k3", "k4"}),          # a baseline step: x is data
    (True, False, {"k3", "k5"}),          # a frozen backbone under the cloak
    (True, True, {"k3", "k4", "k5"}),     # the GRL gender branch
], ids=["baseline", "frozen", "both"])
def test_bf16_backward_launches_the_bf16_mode_of_what_is_needed(monkeypatch, train, x_grad,
                                                               params_grad, want):
    called = {}
    for tag, name in (("k1", "block1_conv_stats"), ("k2", "block1_norm_pool"),
                      ("k3", "block1_route"), ("k4", "block1_weight_grads"),
                      ("k5", "block1_input_grad")):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _tag=tag, **kw: (
            called.setdefault(_tag, set()).add(kw.get("compute_dtype", a[-1])), _fn(*a, **kw))[1])
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 1, 12, 10)).astype(np.float32))
    k = torch.from_numpy((0.2 * rng.standard_normal((C, 1, 5, 5))).astype(np.float32))
    vecs = [torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32)) + o
            for o in (0.0, 1.0, 0.0)]
    x.requires_grad_(x_grad)
    for p in [k, *vecs]:
        p.requires_grad_(params_grad)
    if train:
        pooled = K.block1_train_forward(x, k, *vecs, compute_dtype=BF)[0]
    else:
        pooled = K.block1_eval(x, k, *vecs, torch.zeros(C), torch.ones(C), compute_dtype=BF)
    assert pooled.dtype == BF
    leaves = [t for t in (x, k, *vecs) if t.requires_grad]
    grads = torch.autograd.grad(pooled.float().sum(), leaves)
    assert set(called) == {"k1", "k2"} | want
    assert all(modes == {BF} for modes in called.values())
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("name", ["block1_conv_stats", "block1_norm_pool", "block1_route",
                                  "block1_weight_grads", "block1_input_grad"])
def test_bf16_wrappers_refuse_what_no_kernel_takes(name):
    """A CPU tensor takes the plain version, any other device launches the
    kernel or raises; a stored tensor of the other dtype, or a third dtype,
    is refused in either case."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 1, 9, 7)).astype(np.float32))
    k = torch.from_numpy((0.2 * rng.standard_normal((C, 1, 5, 5))).astype(np.float32))
    v = torch.ones(C)
    y = torch.nn.functional.conv2d(x, k, padding=2).to(BF)
    dp = torch.zeros(1, C, 4, 3, dtype=BF)
    args = {"block1_conv_stats": (x, k, v), "block1_norm_pool": (y, v, v),
            "block1_route": (y, dp, v, v, v, v),
            "block1_weight_grads": (x, y, y, v, v, v, v, v),
            "block1_input_grad": (y, y, k, v, v, v, v, v)}[name]
    fn = getattr(K, name)
    with pytest.raises(ValueError, match="no kernel for meta"):
        fn(*(a.to("meta") for a in args), compute_dtype=BF)
    with pytest.raises(ValueError, match="compute_dtype"):
        fn(*args, compute_dtype=torch.float16)
    if name != "block1_conv_stats":
        with pytest.raises(TypeError, match="bfloat16"):
            fn(*(a.float() if a.dtype == BF else a for a in args), compute_dtype=BF)
    assert fn.launches_bf16 == 0 and fn.launches == 0  # plain versions launch nothing
