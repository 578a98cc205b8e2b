"""Sync-BN block 1 under data parallelism: the port's ``Block1Train`` with a
group of 2 gloo ranks on the CPU (plain versions) against the JAX package's
``fused_block1_train(..., axis_name="data")`` under ``jax.shard_map`` on a
2-device mesh (interpret mode), and each against one device on the whole
batch, f32 and bf16, B = 4 at 200 x 128 (2 rows a rank).

The ranks run once for the module.  Tolerances are tests/test_pallas_conv.py's:
pooled 1e-4, moments 1e-5, gradients 5e-3 * max(|ref|, 1); in bf16 the
pooled values are held as tests/test_torch_conv_block1_bf16.py holds them
(within one bf16 unit and bit-equal in 99.9% of the elements, a rounding of
two f32 sums in another order), and the train-mode db, 0 in exact
arithmetic, the sum of the ranks' within B * H * W * 2^-24 of 0 on every
side.  dW, db, dgamma and dbeta are each rank's own sums (the TPU kernel's
local results), which the step's gradient all-reduce adds once: a rank's
db is far from 0, and the port's and JAX's are held rank by rank.
Readings at seed 0, of max(|ref|, 1): JAX's sync path against its own one
device 3.3e-7 at most in f32, 2.6e-4 (dx) in bf16; the port's against
JAX's 6.4e-7 in f32, 3.6e-4 (dx) in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from sept_tpu.ops.pallas_conv import fused_block1_train
from sept_tpu.parallel import make_mesh
import _torch_dp_worker as W
from _torch_helpers import start_ranks

C, B, H, WID = 32, 4, 200, 128
GRADS = ("dx", "dW", "db", "dgamma", "dbeta")
LOCAL = ("dW", "db", "dgamma", "dbeta")  # per-rank sums: the step's all-reduce adds them
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
DEADLINE_S = 120


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((B, H, WID, 1)).astype(np.float32),
        k=(rng.standard_normal((5, 5, 1, C)) * 0.2).astype(np.float32),
        bias=(rng.standard_normal(C) * 0.1).astype(np.float32),
        gamma=(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        beta=(0.1 * rng.standard_normal(C)).astype(np.float32),
        cot=rng.standard_normal((B, H // 2, WID // 2, C)).astype(np.float32),
    )


def _jax_block(d, dtype, axis_name):
    """fused_block1_train and its VJP on the rows it is given, in the port's
    layout: {pooled, mean, var, dx, dW, db, dgamma, dbeta}."""
    cd = JDTYPE[dtype]

    def fn(x, k, bias, gamma, beta, cot):
        f = lambda *a: fused_block1_train(*a, C, True, cd, axis_name)  # noqa: E731
        (pooled, mean, var), vjp = jax.vjp(f, x, k, bias, gamma, beta)
        grads = vjp((cot.astype(cd), jnp.zeros_like(mean), jnp.zeros_like(var)))
        return (pooled.astype(jnp.float32), mean, var) + tuple(grads)

    return fn


def _port_layout(out):
    names = ("pooled", "mean", "var") + GRADS
    res = {k: np.asarray(v) for k, v in zip(names, out)}
    res["pooled"] = res["pooled"].transpose(0, 3, 1, 2)
    res["dx"] = res["dx"].transpose(0, 3, 1, 2)
    res["dW"] = res["dW"].transpose(3, 2, 0, 1)
    return res


def _jax_sync(d, dtype):
    """The sync path on a 2-device mesh; the local sums come back stacked
    (2, ...) by shard."""
    fn = _jax_block(d, dtype, "data")

    def local(*a):
        pooled, mean, var, dx, dk, db, dg, dbeta = fn(*a)
        return pooled, mean, var, dx, dk[None], db[None], dg[None], dbeta[None]

    shd, rep = P("data"), P()
    mapped = jax.jit(jax.shard_map(
        local, mesh=make_mesh(2), in_specs=(shd, rep, rep, rep, rep, shd),
        out_specs=(shd, rep, rep, shd, shd, shd, shd, shd), check_vma=False))
    out = mapped(*(jnp.asarray(d[n]) for n in ("x", "k", "bias", "gamma", "beta", "cot")))
    res = _port_layout(out[:4] + (out[4][0],) + out[5:])
    res["dW"] = np.asarray(out[4]).transpose(0, 4, 3, 1, 2)  # (shard, C, 1, 5, 5)
    return res


def _jax_one(d, dtype):
    args = (jnp.asarray(d[n]) for n in ("x", "k", "bias", "gamma", "beta", "cot"))
    return _port_layout(jax.jit(_jax_block(d, dtype, None))(*args))


@pytest.fixture(scope="module")
def runs():
    """Every side's block: the port's two ranks, the port on one device, JAX
    on the 2-device mesh and on one device; by dtype."""
    d = _data()
    ranks = start_ranks(W.block1_case, d, deadline_s=DEADLINE_S)
    out = {dtype: {"one": W.block1_train(d, dtype), "jax_sync": _jax_sync(d, dtype),
                   "jax_one": _jax_one(d, dtype)} for dtype in W.DTYPES}
    for dtype in W.DTYPES:
        out[dtype]["ranks"] = [r[dtype] for r in ranks()]
    return out


def _rows(ranks, name):
    return np.concatenate([r[name] for r in ranks])


def _check_pooled(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4)
        return
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6
    assert (np.abs(got - want) <= bound).all()
    assert (got == want).mean() >= 0.999


def _check_grad(name, got, want, whole_batch=True):
    """``whole_batch``: a gradient of the whole batch's loss, where the
    train-mode db is 0 in exact arithmetic (a rank's own db is not: its rows
    are centred on the global mean)."""
    if name == "db" and whole_batch:
        bound = B * H * WID * 2.0 ** -24
        assert np.abs(got).max() <= bound and np.abs(want).max() <= bound
        return
    np.testing.assert_allclose(got, want, atol=5e-3 * max(np.abs(want).max(), 1.0),
                               err_msg=name)


def _check_sync(sync, one, dtype, per_rank):
    """A 2-rank result against one device on the whole batch: pooled and dx
    by row, the moments equal, the local sums adding up."""
    _check_pooled(per_rank(sync, "pooled"), one["pooled"], dtype)
    for name in ("mean", "var"):
        np.testing.assert_allclose(sync[name], one[name], atol=1e-5, err_msg=name)
    _check_grad("dx", per_rank(sync, "dx"), one["dx"])
    for name in LOCAL:
        _check_grad(name, sync[name].sum(0), one[name])


@pytest.mark.parametrize("dtype", list(W.DTYPES))
def test_sync_block1_matches_jax_sync(runs, dtype):
    r = runs[dtype]
    ranks, jax_sync = r["ranks"], r["jax_sync"]
    _check_pooled(_rows(ranks, "pooled"), jax_sync["pooled"], dtype)
    for name in ("mean", "var"):
        for rank in ranks:
            np.testing.assert_allclose(rank[name], jax_sync[name], atol=1e-5, err_msg=name)
    _check_grad("dx", _rows(ranks, "dx"), jax_sync["dx"])
    for name in LOCAL:  # rank by rank: both sides keep the shard's own sums
        for i, rank in enumerate(ranks):
            _check_grad(name, rank[name], jax_sync[name][i], whole_batch=False)


@pytest.mark.parametrize("dtype", list(W.DTYPES))
def test_sync_block1_matches_one_device(runs, dtype):
    r = runs[dtype]
    stacked = {name: np.stack([rank[name] for rank in r["ranks"]]) for name in LOCAL}
    stacked.update(mean=r["ranks"][0]["mean"], var=r["ranks"][0]["var"])
    _check_sync(stacked, r["one"], dtype, lambda s, name: _rows(r["ranks"], name))


@pytest.mark.parametrize("dtype", list(W.DTYPES))
def test_jax_sync_block1_matches_jax_one_device(runs, dtype):
    """The reference's own sync path against its single-device path."""
    r = runs[dtype]
    _check_sync(r["jax_sync"], r["jax_one"], dtype, lambda s, name: s[name])


def test_sync_block1_reduces_twice_and_keeps_dgamma_dbeta_local(runs):
    """One all-reduce in the forward (K1's sums) and one in the backward (a
    copy of K3's); the ranks' dgamma and dbeta are their own, different
    sums, whose total is one device's."""
    for dtype in W.DTYPES:
        ranks, one = runs[dtype]["ranks"], runs[dtype]["one"]
        assert [rank["all_reduces"] for rank in ranks] == [2, 2]
        for name in ("dgamma", "dbeta"):
            assert not np.allclose(ranks[0][name], ranks[1][name])
            np.testing.assert_allclose(ranks[0][name] + ranks[1][name], one[name],
                                       atol=1e-4 * max(np.abs(one[name]).max(), 1.0))
