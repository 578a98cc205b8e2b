"""Data parallelism in the port (``sept_tpu_torch.parallel``) on the CPU: 2
gloo ranks (``--device cpu``, the plain versions, one thread a rank) against
the port on one device and against the JAX package's ``epoch_dp`` on a
2-device mesh, hidden 8, windows 20 x 16, batches of 8, 2 batches, dropout
0, sync-BN.

One pair of ranks runs every case once for the module
(``_torch_dp_worker.all_cases``); the JAX references run here.  Tolerances:
against one device, JAX's own DP bounds (tests/test_parallel.py: losses
rtol 1e-5, parameters 3e-6, running statistics 2e-5; bf16 3e-3 relative,
1e-3 and 5e-3 of max(|p|, 1)); against JAX, tests/test_torch_train.py's
(losses rtol 1e-5, parameters and statistics 1e-5 * max(|w|, 1)).  The GRL
game with ``saliency_align`` and unequal shard weights is held to JAX's DP
only: both take the saliency per shard, which one device does not.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.models import CloakedModelGRL as JaxCloakedGRL
from sept_tpu.models import Conv2dBiRNN as JaxConv2dBiRNN
from sept_tpu.parallel import make_mesh
from sept_tpu.parallel.epoch_dp import make_cloak_epoch_runner_dp as jax_cloak_runner_dp
from sept_tpu.parallel.epoch_dp import make_epoch_runner_dp as jax_runner_dp
from sept_tpu.train import ExperimentConfig as JaxConfig
from sept_tpu.train import make_cloak_optimizer as jax_cloak_optimizer
from sept_tpu.train import make_optimizer as jax_make_optimizer
from sept_tpu.train.steps import TrainState as JaxState
from sept_tpu.train.steps import cloak_scales as jax_cloak_scales
from sept_tpu_torch.cli import common
from sept_tpu_torch.compat.from_jax import backbone_state_dict, cloaked_grl_state_dict
from sept_tpu_torch.models import CloakedModelGRL, Conv2dBiRNN
from sept_tpu_torch.parallel import (DataGroup, make_cloak_epoch_runner_dp, make_dp_step,
                                     make_epoch_runner_dp, make_group, mesh, spawn)
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.optim import make_optimizer
from sept_tpu_torch.train.steps import init_state

import _torch_dp_worker as W
from _torch_helpers import jax_backbone, start_ranks

H, WIN, D, B, NB = W.H, W.WIN, W.D, W.B, W.N_BATCHES
M = B * NB
DEADLINE_S = 120
EPOCHS = ("baseline", "multitask", "bf16", "grl", "grl_global")
JAX_DP = ("baseline", "multitask", "grl", "grl_global", "saliency")
ONE = {"loss": 1e-5, "param": 3e-6, "stats": 2e-5}
ONE_BF16 = {"loss": 3e-3, "param": 1e-3, "stats": 5e-3}


def _split(rng, n, t, utts=False):
    lengths = rng.integers(WIN, t + 1, n) if utts else np.full(n, WIN)
    return dict(windows=rng.standard_normal((n, t, D)).astype(np.float32),
                labels_emo=(np.arange(n) % 4).astype(np.int32),
                labels_gen=(np.arange(n) % 2).astype(np.int32),
                lengths=lengths.astype(np.int32),
                global_data=np.zeros((n, 88), np.float32),
                speaker_ids=np.asarray([f"s{i % 3}" for i in range(n)], object),
                datasets=np.asarray(["synthetic"] * n, object),
                utt_ids=np.asarray([f"u{i}" for i in range(n)], object))


def _noise_params(seed=7):
    rng = np.random.default_rng(seed)
    return {"locs": (0.1 * rng.standard_normal((WIN, D))).astype(np.float32),
            "rhos": (-2 + 0.5 * rng.standard_normal((WIN, D))).astype(np.float32)}


def _jax_grl(sync):
    kw = dict(hidden_size=H, dropout_rate=0.0, bn_axis_name="data" if sync else None)
    return JaxCloakedGRL(emotion_backbone=JaxConv2dBiRNN(pred="emotion", **kw),
                         gender_backbone=JaxConv2dBiRNN(pred="gender", **kw),
                         grl_lambda=0.5, win_len=WIN, n_feats=D)


@functools.lru_cache(maxsize=None)
def _noise_fn():
    jm = _jax_grl(False)
    return jax.jit(lambda variables, rngs: jm.apply(
        variables, jnp.zeros((1, WIN, D, 1)), train=True, rngs=rngs,
        mutable=["batch_stats"])[0][-1])


def _jax_eps(key):
    """JAX's epsilon draw of each step of a GRL epoch from ``key`` (the noise
    the model adds to an all-zero input, over its scales), (NB, 1, WIN, D);
    the draw depends on the key alone."""
    params, stats = _grl_params(False)
    scales = np.asarray(jax_cloak_scales(_jax_grl(False), params))
    eps = []
    for _ in range(NB):
        key, n_rng, d_rng = jax.random.split(key, 3)
        noise = np.asarray(_noise_fn()(
            {"params": params, "batch_stats": stats}, {"noise": n_rng, "dropout": d_rng}))
        eps.append((noise[0, :, :, 0] - params["noise"]["locs"]) / scales)
    return np.stack(eps)[:, None].astype(np.float32)


def _grl_params(use_global):
    """The GRL game's JAX trees; with ``use_global`` each backbone's dense1
    takes 88 more (seeded) input rows."""
    rng = np.random.default_rng(11)
    params, stats = {"noise": _noise_params()}, {}
    for name, pred, seed in (("emotion_backbone", "emotion", 0), ("gender_backbone", "gender", 1)):
        _, p, s = jax_backbone(H, pred, None, WIN, D, seed=seed)
        p = jax.tree.map(np.copy, p)
        if use_global:
            k = p["heads"]["dense1"]["kernel"]
            extra = 0.05 * rng.standard_normal((88, k.shape[1]))
            p["heads"]["dense1"]["kernel"] = np.concatenate([k, extra]).astype(np.float32)
        params[name], stats[name] = p, s
    return params, stats


def _inputs():
    rng = np.random.default_rng(5)
    data = dict(windows=rng.standard_normal((M, WIN, D)).astype(np.float32),
                le=(np.arange(M) % 4).astype(np.int32), lg=(np.arange(M) % 2).astype(np.int32),
                w=np.where(np.arange(M) < M - 3, 1.0, 0.0).astype(np.float32),
                order=np.random.default_rng(0).permutation(M),
                globals=(0.5 * rng.standard_normal((M, 88))).astype(np.float32))
    inp = {"data": data}
    for case, pred, dtype in (("baseline", "emotion", "float32"),
                              ("multitask", "multitask", "float32"),
                              ("bf16", "emotion", "bfloat16")):
        _, params, stats = jax_backbone(H, pred, None, WIN, D)
        inp[case] = {"pred": pred, "dtype": dtype, "params": params, "stats": stats,
                     "sd": backbone_state_dict(params, stats)}
    # unequal shard weights for the saliency term: speaker-like weights
    w_sal = rng.uniform(0.5, 2.0, M).astype(np.float32)
    w_sal[[1, 9, 10]] = 0.0
    eps = _jax_eps(jax.random.PRNGKey(3))
    for case, use_global, sal, w in (("grl", False, 0.0, data["w"]),
                                     ("grl_global", True, 0.0, data["w"]),
                                     ("saliency", False, 0.5, w_sal)):
        params, stats = _grl_params(use_global)
        inp[case] = {"use_global": use_global, "saliency_align": sal, "w": w,
                     "params": params, "stats": stats,
                     "sd": cloaked_grl_state_dict(params, stats),
                     "eps": eps}
    steps = []
    for i in range(2):
        s = _split(rng, B, WIN)
        steps.append({"spec": s["windows"][:, None], "labels_emo": s["labels_emo"].astype(np.int64),
                      "labels_gen": s["labels_gen"].astype(np.int64),
                      "weight": np.r_[np.ones(B - 2 * (1 - i)), np.zeros(2 * (1 - i))]
                      .astype(np.float32)})
    inp["steps"] = steps
    inp["fold"] = {"train": _split(rng, 13, WIN), "val": _split(rng, 12, WIN),
                   "test": _split(rng, 7, 2 * WIN, utts=True)}
    inp["mask"] = (np.arange(WIN * D).reshape(WIN, D) % 3 == 0).astype(np.float32)
    return inp


def _ported(inp):
    """What the ranks get: the inputs without the JAX trees."""
    return {k: ({kk: vv for kk, vv in v.items() if kk not in ("params", "stats")}
                if isinstance(v, dict) else v) for k, v in inp.items()}


def _jax_dp(inp, case):
    """JAX's epoch_dp on a 2-device mesh from the same weights: (losses,
    correct, counts, the state in the port's names)."""
    c, d = inp[case], inp["data"]
    cfg = JaxConfig(optimizer="sgd", learning_rate=1e-2, weight_decay=1e-4)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    if case in ("baseline", "multitask"):
        tx = jax_make_optimizer(cfg, NB)
        st = JaxState(params=c["params"], batch_stats=c["stats"],
                      opt_state=tx.init(c["params"]), rng=jax.random.PRNGKey(0),
                      step=jnp.zeros((), jnp.int32))
        model = JaxConv2dBiRNN(hidden_size=H, pred=c["pred"], dropout_rate=0.0,
                               bn_axis_name="data")
        kw = {"labels_gen": j["lg"]} if case == "multitask" else {}
        st, *out = jax_runner_dp(model, tx, make_mesh(2))(
            st, j["windows"], j["le"], j["w"], j["order"], n_batches=NB, batch_size=B, **kw)
        return out, backbone_state_dict(jax.tree.map(np.asarray, st.params),
                                        jax.tree.map(np.asarray, st.batch_stats))
    tx = jax_cloak_optimizer(cfg, 10, c["params"], ("noise", "gender_backbone"))
    st = JaxState(params=c["params"], batch_stats=c["stats"], opt_state=tx.init(c["params"]),
                  rng=jax.random.PRNGKey(3), step=jnp.zeros((), jnp.int32))
    run = jax_cloak_runner_dp(_jax_grl(True), tx, make_mesh(2), scale_lambda=0.1,
                              gender_lambda=0.3, grl=True, saliency_align=c["saliency_align"],
                              use_global=c["use_global"])
    gkw = {"globals_": j["globals"]} if c["use_global"] else {}
    st, *out = run(st, j["windows"], j["le"], j["lg"], jnp.asarray(c["w"]), j["order"], None,
                   n_batches=NB, batch_size=B, **gkw)
    return out, cloaked_grl_state_dict(jax.tree.map(np.asarray, st.params),
                                       jax.tree.map(np.asarray, st.batch_stats))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, one device's, and JAX's DP results."""
    tmp = tmp_path_factory.mktemp("dp")
    inp = _inputs()
    ported = _ported(inp)
    ranks = start_ranks(W.all_cases, ported, str(tmp / "mid"), deadline_s=DEADLINE_S)
    jax_dp = {c: _jax_dp(inp, c) for c in JAX_DP}
    one = {c: W.epoch_case(None, ported, c) for c in ("baseline", "multitask", "bf16")}
    one.update({c: W.grl_case(None, ported, c) for c in ("grl", "grl_global", "saliency")})
    one["dp_step"] = W.dp_step_case(None, ported)
    one["fit"] = W.fit_case(None, ported)
    one["fit_cloak"] = W.fit_case(None, ported, True)
    one["sweep8"] = W.sweep_case(None, ported, 8)
    one["sweep5"] = W.sweep_case(None, ported, 5)
    return {"ranks": ranks(), "one": one, "jax": jax_dp}


def _hold_state(got, want, tol):
    """Every floating tensor of ``want`` (names of the port): parameters
    within tol["param"], running statistics within tol["stats"], of
    max(|w|, 1) where ``tol["relative"]``."""
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        if k.endswith("num_batches_tracked"):
            continue
        part = "stats" if "running" in k else "param"
        atol = tol[part] * (max(np.abs(w).max(), 1.0) if tol.get("relative") else 1.0)
        np.testing.assert_allclose(got[k], w, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", EPOCHS)
def test_dp_epoch_matches_one_device(runs, case):
    r0, r1 = (r[case] for r in runs["ranks"])
    one = runs["one"][case]
    bf16 = case == "bf16"
    tol = dict(ONE_BF16, relative=True) if bf16 else ONE
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=tol["loss"])
    np.testing.assert_array_equal(r0["counts"], one["counts"])
    if not bf16:
        np.testing.assert_array_equal(r0["correct"], one["correct"])
    _hold_state(r0["state"], one["state"], tol)
    for k in r0["state"]:  # every rank steps to the same state
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k], err_msg=k)
    np.testing.assert_array_equal(r0["losses"], r1["losses"])


@pytest.mark.parametrize("case", JAX_DP)
def test_dp_epoch_matches_jax_epoch_dp(runs, case):
    (jl, jc, jn), want = runs["jax"][case]
    got = runs["ranks"][0][case]
    np.testing.assert_allclose(got["losses"], np.asarray(jl), rtol=1e-5)
    np.testing.assert_array_equal(got["correct"], np.asarray(jc))
    np.testing.assert_array_equal(got["counts"], np.asarray(jn))
    _hold_state(got["state"], {k: v.numpy() for k, v in want.items()},
                {"param": 1e-5, "stats": 1e-5, "relative": True})


def test_saliency_shards_differ_from_one_device(runs):
    """With unequal shard weight sums the per-shard saliency term is not the
    single-device one (JAX's local approximation, which the port follows):
    the DP epoch leaves the noise elsewhere than one device would."""
    one, got = runs["one"]["saliency"], runs["ranks"][0]["saliency"]
    assert np.abs(got["state"]["noise.rhos"] - one["state"]["noise.rhos"]).max() > 1e-6


def test_dp_runs_one_flat_all_reduce_a_step(runs):
    """Each step: the sync-BN moments of blocks 1-3 forward and backward
    (6) and one flat buffer of gradients, statistics and metrics."""
    r = runs["ranks"][0]
    for case in ("baseline", "grl"):
        assert r[case + "_all_reduces"] == NB * 7, case


def test_dp_step_matches_one_device(runs):
    got, one = runs["ranks"][0]["dp_step"], runs["one"]["dp_step"]
    for g, o in zip(got["metrics"], one["metrics"]):
        assert float(g["loss"]) == pytest.approx(float(o["loss"]), rel=1e-5)
        assert float(g["count"]) == float(o["count"])
        assert float(g["correct"]) == float(o["correct"])
        np.testing.assert_array_equal(g["preds"], o["preds"])
    assert float(got["metrics"][0]["count"]) == B - 2
    _hold_state(got["state"], one["state"], ONE)


@pytest.mark.parametrize("case", ["fit", "fit_cloak"])
def test_fold_driver_dp_matches_one_device(runs, case):
    """fit_device / fit_device_cloak with a group reproduce one device epoch
    for epoch (tests/test_parallel.py's bounds), the same on both ranks."""
    r0, r1 = (r[case] for r in runs["ranks"])
    one = runs["one"][case]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(r0[key], one[key], rtol=1e-4, err_msg=key)
    assert r0["val_acc"] == one["val_acc"] and r0["test_acc"] == one["test_acc"]
    assert r0["final_test_acc"] == pytest.approx(one["final_test_acc"], abs=1e-6)
    assert r0["best_epoch"] == one["best_epoch"]
    _hold_state(r0["best"], one["best"], ONE)
    assert r0["train_loss"] == r1["train_loss"] and r0["val_loss"] == r1["val_loss"]


def test_midfold_resume_under_dp(runs):
    """A DP fold cut after 2 epochs and resumed on both ranks from rank 0's
    checkpoint follows the uninterrupted run (tests/test_midfold.py)."""
    for r in runs["ranks"]:
        m = r["midfold"]
        assert m["existed"]
        assert len(m["resumed"]["train_loss"]) == 4
        np.testing.assert_allclose(m["resumed"]["train_loss"], m["ref"]["train_loss"],
                                   rtol=1e-6)
        assert m["resumed"]["final_test_acc"] == pytest.approx(m["ref"]["final_test_acc"],
                                                               abs=1e-9)
        assert m["resumed"]["best_epoch"] == m["ref"]["best_epoch"]


@pytest.mark.parametrize("batch_size", [8, 5])
def test_dp_sweep_matches_one_device(runs, batch_size):
    """evaluate_cloaked_test with a group: each batch padded to a multiple
    of the world size, the same metrics as one device on every rank
    (tests/test_parallel.py:385-451)."""
    one = runs["one"][f"sweep{batch_size}"]
    for r in runs["ranks"]:
        got = r[f"sweep{batch_size}"]
        for head in ("baseline", "adversary"):
            g, o = got[head], one[head]
            assert g["acc"] == o["acc"] and g["rec"] == o["rec"], head
            np.testing.assert_array_equal(g["conf"], o["conf"])
            np.testing.assert_allclose(g["probs"], o["probs"], atol=1e-6)


FAKE = DataGroup(0, 2, torch.device("cpu"), "gloo")


def _state():
    m = Conv2dBiRNN(hidden_size=H, feature_len=D, pred="multitask", dropout_rate=0.0)
    return init_state(m, make_optimizer(ExperimentConfig(), 1, m), device="cpu")


def _grl_state():
    m = CloakedModelGRL(Conv2dBiRNN(hidden_size=H, feature_len=D),
                        Conv2dBiRNN(hidden_size=H, feature_len=D, pred="gender"),
                        win_len=WIN, n_feats=D)
    return init_state(m, make_optimizer(ExperimentConfig(), 1, m), device="cpu")


@pytest.mark.parametrize("case", ["indivisible", "multitask_labels_gen", "globals",
                                  "cloak_globals", "dp_step_indivisible", "group_size"])
def test_dp_misuse_raises(case):
    """Misuse fails loudly before any collective: a batch the ranks do not
    divide, a multitask epoch without labels_gen, use_global without
    globals_, more devices than are visible."""
    x = torch.zeros((M, WIN, D))
    lab, w = torch.zeros(M, dtype=torch.long), torch.ones(M)
    call, match = {
        "indivisible": (lambda: make_epoch_runner_dp(FAKE)(
            _state(), x, lab, w, np.arange(M), n_batches=1, batch_size=7), "not divisible"),
        "multitask_labels_gen": (lambda: make_epoch_runner_dp(FAKE)(
            _state(), x, lab, w, np.arange(M), n_batches=1, batch_size=8), "labels_gen"),
        "globals": (lambda: make_epoch_runner_dp(FAKE, use_global=True)(
            _state(), x, lab, w, np.arange(M), n_batches=1, batch_size=8,
            labels_gen=lab), "globals_"),
        "cloak_globals": (lambda: make_cloak_epoch_runner_dp(FAKE, grl=True, use_global=True)(
            _grl_state(), x, lab, lab, w, np.arange(M), None, n_batches=1, batch_size=8),
            "globals_"),
        "dp_step_indivisible": (lambda: make_dp_step(FAKE)(_state(), {
            "spec": torch.zeros((7, 1, WIN, D)), "labels_emo": lab[:7], "labels_gen": lab[:7],
            "weight": w[:7]}), "not divisible"),
        "group_size": (lambda: make_group(mesh.visible_devices("cpu") + 1, "cpu"), "device"),
    }[case]
    with pytest.raises(ValueError, match=match):
        call()


def _args(n_devices, batch_size, device="cpu"):
    return argparse.Namespace(n_devices=n_devices, batch_size=batch_size, device=device)


@pytest.mark.parametrize("n_devices,batch_size,device,want", [
    (0, 32, "cpu", 1),       # auto stays on one device on the CPU
    (2, 12, "cpu", 2),       # an explicit count of CPU ranks
    (1, 7, "cpu", 1),
    (0, 12, "cuda", 6),      # auto: 8 cards, 8 and 7 do not divide 12, 6 does
    (0, 13, "cuda", 1),      # a prime batch: one device, never a failure
])
def test_resolve_world(monkeypatch, n_devices, batch_size, device, want):
    monkeypatch.setattr(common, "visible_devices",
                        lambda dev: 8 if torch.device(dev).type == "cuda" else 4)
    assert common.resolve_world(_args(n_devices, batch_size, device)) == want


@pytest.mark.parametrize("n_devices,batch_size,match", [(2, 7, "divisible"),
                                                        (5, 10, "visible")])
def test_resolve_world_refuses(monkeypatch, n_devices, batch_size, match):
    monkeypatch.setattr(common, "visible_devices", lambda dev: 4)
    with pytest.raises(SystemExit, match=match):
        common.resolve_world(_args(n_devices, batch_size))


def test_resolve_group_from_the_multihost_env(monkeypatch):
    """SEPT_COORDINATOR, SEPT_NUM_PROCESSES and SEPT_PROCESS_ID make this
    process one rank (init_distributed); --n_devices must be 0 or the world
    size, and a coordinator alone is a misconfigured launch."""
    calls = []

    def init(coord, n, pid, device):
        calls.append((coord, n, pid, device))
        return DataGroup(pid, n, torch.device(device), "gloo")

    monkeypatch.setattr(common, "init_distributed", init)
    monkeypatch.setenv("SEPT_COORDINATOR", "head:9999")
    monkeypatch.setenv("SEPT_NUM_PROCESSES", "2")
    monkeypatch.setenv("SEPT_PROCESS_ID", "1")
    group = common.resolve_group(_args(0, 32))
    assert calls == [("head:9999", 2, 1, "cpu")]
    assert (group.rank, group.world_size) == (1, 2)
    assert common.spawn_ranks(None, [], _args(2, 32)) is None  # a rank spawns nothing
    with pytest.raises(SystemExit, match="2 ranks"):
        common.resolve_group(_args(4, 32))
    with pytest.raises(SystemExit, match="divisible"):
        common.resolve_group(_args(2, 7))
    monkeypatch.delenv("SEPT_PROCESS_ID")
    with pytest.raises(SystemExit, match="SEPT_PROCESS_ID"):
        common.resolve_group(_args(0, 32))


def test_init_distributed_plumbs_to_torch(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(mesh, "_current", None)
    group = mesh.init_distributed("10.0.0.1:1234", 4, 2, device="cpu")
    (backend, kw), = calls
    assert backend == "gloo" and kw["init_method"] == "tcp://10.0.0.1:1234"
    assert (kw["world_size"], kw["rank"]) == (4, 2) and kw["timeout"].total_seconds() > 0
    assert (group.rank, group.world_size, group.backend) == (2, 4, "gloo")
    assert mesh.init_distributed("10.0.0.1:1234", 4, 2, device="cpu") is group  # no-op
    monkeypatch.setattr(mesh, "_current", None)
    assert mesh.init_distributed(None, 1, 0, device="cpu") is None and len(calls) == 1


@pytest.mark.parametrize("case", ["raises", "deadline"])
def test_spawn_surfaces_a_failing_or_hanging_rank(case):
    """A rank that raises while its peer waits in a collective fails the
    launch with the rank's error; ranks past the deadline are killed."""
    devices = make_group(2, "cpu")
    if case == "raises":
        with pytest.raises(ValueError, match="rank 1 failed") as e:
            spawn(W.fail_on_rank_1, devices, deadline_s=60, threads=1)
        assert any("fail_on_rank_1" in n for n in e.value.__notes__)
    else:
        with pytest.raises(TimeoutError, match="deadline"):
            spawn(W.sleep, devices, 600, deadline_s=3, threads=1)
