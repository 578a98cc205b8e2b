"""bf16 training in the PyTorch port vs the JAX package (CPU): three steps
each of the baseline, cloak and cloak + GRL steps with
``compute_dtype=bfloat16``.

The JAX side is ``Conv2dBiRNN(dtype=bfloat16, conv_backend="fused1")``, its
block 1 in the interpret-mode Pallas kernels (fixed to 200 x 128 windows);
the port's block 1 takes its kernels' plain bf16 versions.  Both start from
the same perturbed weights (hidden 16, B = 2, dropout 0, lr 1e-2), carried
over by sept_tpu_torch.compat.from_jax, on the same batches; the cloak steps
get JAX's epsilon draw injected (recovered from the noise layer alone), and
the GRL step runs the antithetic pair with the saliency-alignment term.

Tolerances, no looser than tests/test_pallas_conv.py's bounds between the
JAX package's two bf16 backends (outputs 0.05 of their scale, gradients
max(0.05 * max, 0.02)): each step's loss within 3e-3 relative (readings up
to 1.1e-3); every trained parameter after 3 steps within 1e-3 * max(|p|, 1)
(readings up to 3.4e-4, conv.0.weight): SGD with momentum 0.9 at lr 1e-2
moves a parameter by about 0.056 of its summed gradients over 3 steps, so
this holds each step's gradient to about 0.02 * max(|p|, 1).  Running
statistics within 5e-3 * max(|p|, 1) (readings up to 2.9e-3, the blocks 2-3
BatchNorms): the JAX steps are jitted, and XLA's excess precision over fused
bf16 chains on the CPU moves the JAX model's own block-2 batch variance by
1e-2 between its jitted and its eager forward (1.5e-3 on the running
variance after one forward, where the port is 2.3e-5 from the eager one;
tests/test_torch_backbone_bf16.py holds the port to the eager model).
Frozen parameters stay bit-unchanged.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.models import CloakedModel as JaxCloaked
from sept_tpu.models import CloakedModelGRL as JaxCloakedGRL
from sept_tpu.models import CloakNoise as JaxCloakNoise
from sept_tpu.models import Conv2dBiRNN as JaxConv2dBiRNN
from sept_tpu.train import ExperimentConfig as JaxConfig
from sept_tpu.train import make_baseline_step as jax_baseline_step
from sept_tpu.train import make_cloak_optimizer as jax_cloak_optimizer
from sept_tpu.train import make_optimizer as jax_make_optimizer
from sept_tpu.train.steps import TrainState as JaxState
from sept_tpu.train.steps import cloak_scales as jax_cloak_scales
from sept_tpu.train.steps import make_cloak_grl_step as jax_grl_step
from sept_tpu.train.steps import make_cloak_step as jax_cloak_step
from sept_tpu_torch.compat.from_jax import (
    backbone_state_dict,
    cloaked_grl_state_dict,
    cloaked_state_dict,
)
from sept_tpu_torch.models import CloakedModel, CloakedModelGRL, Conv2dBiRNN, compute_dtype
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.optim import make_cloak_optimizer, make_optimizer
from sept_tpu_torch.train.steps import (
    init_state,
    make_baseline_step,
    make_cloak_grl_step,
    make_cloak_step,
)

from _torch_helpers import jax_backbone

H, WIN, D, B, STEPS = 16, 200, 128, 2, 3
SCALE_LAMBDA, GENDER_LAMBDA, SALIENCY = 0.1, 0.1, 0.5
CFG = dict(optimizer="sgd", learning_rate=1e-2, weight_decay=1e-4)
LOSS_RTOL, PARAM_TOL, STATS_TOL = 3e-3, 1e-3, 5e-3


def _jax_model(pred):
    return JaxConv2dBiRNN(hidden_size=H, pred=pred, dropout_rate=0.0, dtype=jnp.bfloat16,
                          conv_backend="fused1")


def _port_model(pred):
    return Conv2dBiRNN(hidden_size=H, feature_len=D, pred=pred, dropout_rate=0.0,
                       compute_dtype=compute_dtype(ExperimentConfig(
                           compute_dtype="bfloat16").compute_dtype))


def _noise_params(seed=7):
    rng = np.random.default_rng(seed)
    return {"locs": (0.1 * rng.standard_normal((WIN, D))).astype(np.float32),
            "rhos": (-2 + 0.5 * rng.standard_normal((WIN, D))).astype(np.float32)}


class _NoiseOnly(fnn.Module):
    """The cloaked models' noise layer at the same scope path ("noise"), so
    that it draws the same epsilon from the same key."""

    @fnn.compact
    def __call__(self, x):
        return JaxCloakNoise(win_len=WIN, n_feats=D, name="noise")(x)


def _jax_eps(params, n_rng):
    """The epsilon the JAX cloaked model draws from ``n_rng``, (1, WIN, D)."""
    noise = np.asarray(_NoiseOnly().apply({"params": {"noise": params["noise"]}},
                                          jnp.zeros((1, WIN, D)), rngs={"noise": n_rng}))[0]
    scales = np.asarray(jax_cloak_scales(JaxCloakNoise(), params))
    return torch.from_numpy((noise - np.asarray(params["noise"]["locs"])) / scales)[None]


def _batches(seed=1):
    rng = np.random.default_rng(seed)
    return [dict(spec=rng.standard_normal((B, WIN, D, 1)).astype(np.float32),
                 labels_emo=rng.integers(0, 4, B).astype(np.int32),
                 labels_gen=rng.integers(0, 2, B).astype(np.int32),
                 weight=np.ones(B, np.float32))
            for _ in range(STEPS)]


def _torch_batch(b):
    return {"spec": torch.from_numpy(np.ascontiguousarray(np.transpose(b["spec"], (0, 3, 1, 2)))),
            "labels_emo": torch.from_numpy(b["labels_emo"]).long(),
            "labels_gen": torch.from_numpy(b["labels_gen"]).long(),
            "weight": torch.from_numpy(b["weight"])}


def _setup(workload):
    """(JAX step, JAX state, port step, port state, the state_dict of JAX
    trees, frozen key prefixes)."""
    if workload == "baseline":
        _, params, stats = jax_backbone(H, "emotion", None, WIN, D)
        tx = jax_make_optimizer(JaxConfig(**CFG), 100)
        jstep = jax_baseline_step(_jax_model("emotion"), tx)
        port = _port_model("emotion")
        port.load_state_dict(backbone_state_dict(params, stats))
        opt = make_optimizer(ExperimentConfig(**CFG), 100, port)
        step, to_sd, frozen = make_baseline_step(), backbone_state_dict, ()
    elif workload == "cloak":
        _, pe, se = jax_backbone(H, "emotion", None, WIN, D)
        params, stats = {"noise": _noise_params(), "backbone": pe}, {"backbone": se}
        jm = JaxCloaked(backbone=_jax_model("emotion"), win_len=WIN, n_feats=D)
        tx = jax_cloak_optimizer(JaxConfig(**CFG), 10, params, ("noise",))
        jstep = jax_cloak_step(jm, tx, scale_lambda=SCALE_LAMBDA)
        port = CloakedModel(_port_model("emotion"), win_len=WIN, n_feats=D)
        port.load_state_dict(cloaked_state_dict(params, stats))
        opt = make_cloak_optimizer(ExperimentConfig(**CFG), 10, port, ("noise",))
        step = make_cloak_step(scale_lambda=SCALE_LAMBDA)
        to_sd, frozen = cloaked_state_dict, ("backbone.",)
    else:
        _, pe, se = jax_backbone(H, "emotion", None, WIN, D)
        _, pg, sg = jax_backbone(H, "gender", None, WIN, D, seed=1)
        params = {"noise": _noise_params(), "emotion_backbone": pe, "gender_backbone": pg}
        stats = {"emotion_backbone": se, "gender_backbone": sg}
        jm = JaxCloakedGRL(emotion_backbone=_jax_model("emotion"),
                           gender_backbone=_jax_model("gender"), grl_lambda=0.1,
                           win_len=WIN, n_feats=D)
        prefixes = ("noise", "gender_backbone")
        tx = jax_cloak_optimizer(JaxConfig(**CFG), 10, params, prefixes)
        kw = dict(scale_lambda=SCALE_LAMBDA, gender_lambda=GENDER_LAMBDA, antithetic=True,
                  saliency_align=SALIENCY)
        jstep = jax_grl_step(jm, tx, **kw)
        port = CloakedModelGRL(_port_model("emotion"), _port_model("gender"), grl_lambda=0.1,
                               win_len=WIN, n_feats=D)
        port.load_state_dict(cloaked_grl_state_dict(params, stats))
        opt = make_cloak_optimizer(ExperimentConfig(**CFG), 10, port, prefixes)
        step = make_cloak_grl_step(**kw)
        to_sd, frozen = cloaked_grl_state_dict, ("emotion_backbone.",)
    jstate = JaxState(params=params, batch_stats=stats, opt_state=tx.init(params),
                      rng=jax.random.PRNGKey(3), step=jnp.zeros((), jnp.int32))
    return jstep, jstate, step, init_state(port, opt, device="cpu"), to_sd, frozen


@pytest.mark.parametrize("workload", ["baseline", "cloak", "cloak_grl"])
def test_bf16_steps_match_jax(workload):
    jstep, jst, step, state, to_sd, frozen = _setup(workload)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    for b in _batches():
        args = {}
        if workload != "baseline":
            args["eps"] = _jax_eps(jst.params, jax.random.split(jst.rng, 3 if workload
                                                                 == "cloak_grl" else 2)[1])
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _torch_batch(b), **args)
        assert m["loss"].dtype == torch.float32
        assert float(m["loss"]) == pytest.approx(float(jmet["loss"]), rel=LOSS_RTOL)
    want = to_sd(jax.tree.map(np.asarray, jst.params), jax.tree.map(np.asarray, jst.batch_stats))
    got = state.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert got[k].dtype == torch.float32, k
        if k.startswith(frozen):
            assert torch.equal(got[k], before[k]), f"frozen {k} moved"
        tol = STATS_TOL if "running" in k else PARAM_TOL
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   atol=tol * max(float(w.abs().max()), 1.0), err_msg=k)
    moved = "dense1.weight" if workload == "baseline" else "noise.locs"
    assert not torch.equal(got[moved], before[moved])
