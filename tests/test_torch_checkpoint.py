"""The port's checkpoints (artifacts, manifests, mid-fold resume) and the
structure of its ``run_fold`` chain vs the JAX package (CPU).

The chain trains a tiny baseline, then the GRL cloak at suppression 0 and
at 20 through the port's ``run_fold``s, and runs the JAX package's
``run_fold``s on the port's artifacts (converted by
sept_tpu.compat.torch_import) with its fit loop stubbed out: the artifact
names, the manifests' keys and the training mask must agree, the grafted
backbone must be the baseline's bit for bit, and the suppressed cloak's
``rhos`` the suppression-0 cloak's.
"""

import dataclasses
import itertools
import json
import os

import numpy as np
import pytest
import torch

import sept_tpu.train.loop as jax_loop
from sept_tpu.cli import train_baseline as JTB
from sept_tpu.cli import train_cloak as JTC
from sept_tpu.compat.torch_import import import_backbone, import_cloak_noise
from sept_tpu.data.pipeline import FoldData as JaxFold
from sept_tpu.data.pipeline import SplitArrays as JaxSplit
from sept_tpu.train import ExperimentConfig as JaxConfig
from sept_tpu.train import preset as jax_preset
from sept_tpu.train.checkpoint import artifact_path as jax_artifact_path
from sept_tpu.utils.logging import _jsonable as jax_jsonable
from sept_tpu_torch.cli import train_baseline as TB
from sept_tpu_torch.cli import train_cloak as TC
from sept_tpu_torch.data.pipeline import FoldData, SplitArrays
from sept_tpu_torch.models import Conv2dBiRNN
from sept_tpu_torch.train.checkpoint import CheckpointManager, artifact_path
from sept_tpu_torch.train.config import ExperimentConfig, preset
from sept_tpu_torch.train.device_loop import fit_device
from sept_tpu_torch.train.midfold import MidFoldCheckpoint
from sept_tpu_torch.train.optim import make_optimizer
from sept_tpu_torch.train.steps import init_state, make_eval_logits_fn

T, D, H = 40, 16, 8


def _arrays(n, seed, test=False):
    rng = np.random.default_rng(seed)
    le = rng.integers(0, 4, n).astype(np.int32)
    lengths = rng.integers(25, 70, n).astype(np.int32) if test else np.full(n, T, np.int32)
    w = rng.standard_normal((n, 70 if test else T, D)).astype(np.float32)
    w[np.arange(n), :, le * 3] += 1.5
    return dict(windows=w, labels_emo=le, labels_gen=rng.integers(0, 2, n).astype(np.int32),
                lengths=lengths, global_data=np.zeros((n, 88), np.float32),
                speaker_ids=np.array([f"s{i % 3}" for i in range(n)], object),
                datasets=np.array(["crema-d" if i % 2 else "iemocap" for i in range(n)], object),
                utt_ids=np.array([f"u{i}" for i in range(n)], object))


def _fold(split_cls, fold_cls):
    splits = [split_cls(**_arrays(n, s, test=s == 4))
              for s, n in enumerate((24, 12, 24, 12, 8))]
    return fold_cls(1, *splits)


def test_checkpoint_round_trip_and_manifest(tmp_path):
    torch.manual_seed(0)
    sd = Conv2dBiRNN(H, D, "gender").state_dict()
    cfg = ExperimentConfig(win_len=T, feature_len=D, hidden_size=H)
    manifest = {"config": cfg, "best_epoch": np.int64(3), "best_val_acc": np.float32(0.625),
                "test_uar": float("nan"), "conf": np.eye(2), "trajectory": [np.float64(-1.5), None],
                "pair": (1, "a")}
    ckpt = CheckpointManager(str(tmp_path / "out"))
    assert not ckpt.exists("adv_baseline_gender", 2)
    path = ckpt.save("adv_baseline_gender", 2, sd, manifest=manifest)
    assert path == artifact_path(str(tmp_path / "out"), "adv_baseline_gender", 2) == \
        jax_artifact_path(str(tmp_path / "out"), "adv_baseline_gender", 2)
    assert ckpt.exists("adv_baseline_gender", 2)
    back = ckpt.restore("adv_baseline_gender", 2, device="cpu")
    assert back.keys() == sd.keys() and all(torch.equal(back[k], v) for k, v in sd.items())
    text = (tmp_path / "out" / "adv_baseline_gender" / "manifest_fold2.json").read_text()
    assert text == json.dumps(jax_jsonable(manifest), indent=2)
    assert json.loads(text)["config"]["win_len"] == T


def _run(cfg, resume_path=None):
    fold = _fold(SplitArrays, FoldData)
    torch.manual_seed(8)
    model = Conv2dBiRNN(H, D, "emotion", dropout_rate=0.2)  # draws from the state's generator
    state = init_state(model, make_optimizer(cfg, 3, model), cfg.seed, "cpu")
    res = fit_device(state, fold.training, fold.validation, fold.test, cfg,
                     make_eval_logits_fn(model), verbose=False, resume_path=resume_path)
    return res, state


def test_resume_reproduces_uninterrupted_run(tmp_path, monkeypatch):
    kw = dict(optimizer="adam", learning_rate=1e-3, hidden_size=H, batch_size=10, win_len=T,
              feature_len=D, min_select_epoch=0, plateau_patience=0)
    ref, ref_state = _run(ExperimentConfig(num_epochs=4, **kw))

    # "interrupt" after 2 epochs: the delete-on-finish suppressed leaves the
    # mid-fold checkpoint behind
    mid_dir = str(tmp_path / "mid")
    monkeypatch.setattr(MidFoldCheckpoint, "delete", lambda self: None)
    _run(ExperimentConfig(num_epochs=2, **kw), resume_path=mid_dir)
    monkeypatch.undo()
    assert MidFoldCheckpoint(mid_dir).exists()

    # resumed with the full budget, it continues at epoch 2 and lands where
    # the uninterrupted run did: the shuffle, the dropout draws, the
    # optimizer's moments and the plateau scale all carried over
    res, state = _run(ExperimentConfig(num_epochs=4, **kw), resume_path=mid_dir)
    assert len(res.history) == len(ref.history) == 4
    for h_ref, h_res in zip(ref.history, res.history):
        assert h_res["train"]["loss"] == h_ref["train"]["loss"]
        assert h_res["validate"]["loss"] == h_ref["validate"]["loss"]
    assert (res.best_epoch, res.final_test_acc) == (ref.best_epoch, ref.final_test_acc)
    assert state.optimizer.lr_scale == ref_state.optimizer.lr_scale < 1.0
    assert state.step == ref_state.step
    final, want = state.model.state_dict(), ref_state.model.state_dict()
    assert all(torch.equal(final[k], v) for k, v in want.items())
    assert all(torch.equal(res.best_state["model"][k], v)
               for k, v in ref.best_state["model"].items())
    assert not MidFoldCheckpoint(mid_dir).exists()  # fold complete: the checkpoint went


def test_snapshot_load_replays_a_step():
    """A snapshot is a copy: a step after it changes nothing in it, and
    loading it back makes the next step (dropout draws, momentum, update
    count) the same as the first."""
    from sept_tpu_torch.train.steps import make_baseline_step

    fold = _fold(SplitArrays, FoldData)
    cfg = ExperimentConfig(optimizer="sgd", learning_rate=1e-2)
    torch.manual_seed(3)
    model = Conv2dBiRNN(H, D, "emotion", dropout_rate=0.2)
    state = init_state(model, make_optimizer(cfg, 3, model), 5, "cpu")
    batch = {"spec": torch.from_numpy(fold.training.windows[:8])[:, None],
             "labels_emo": torch.from_numpy(fold.training.labels_emo[:8]).long(),
             "labels_gen": torch.from_numpy(fold.training.labels_gen[:8]).long(),
             "weight": torch.ones(8)}
    step = make_baseline_step()
    step(state, batch)  # a momentum buffer to carry
    snap = state.snapshot()
    kept = {k: v.clone() for k, v in snap["model"].items()}
    first = float(step(state, batch)[1]["loss"])
    after_first = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert all(torch.equal(snap["model"][k], v) for k, v in kept.items())
    for _ in range(2):  # the snapshot survives a replayed step, momentum too
        state.load(snap)
        assert float(step(state, batch)[1]["loss"]) == first
        assert all(torch.equal(state.model.state_dict()[k], v) for k, v in after_first.items())
        assert state.step == snap["step"] + 1
        assert state.optimizer.count == snap["optimizer"]["count"] + 1


def test_crash_window_leaves_consistent_checkpoint(tmp_path, monkeypatch):
    """loop.json is the atomic commit point: a kill after the new epoch's
    state is written but before loop.json is replaced leaves the previous
    epoch's checkpoint whole."""

    def snap(v):
        return {"model": {"w": torch.full((3,), float(v))}, "step": v}

    mid = MidFoldCheckpoint(str(tmp_path / "mid"))
    mid.save(snap(0), None, {"epoch": 0, "tag": "e0"})

    real_replace = os.replace

    def boom(src, dst, *a, **k):
        if dst.endswith("loop.json"):
            raise RuntimeError("killed before commit")
        return real_replace(src, dst, *a, **k)

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(RuntimeError):
        mid.save(snap(1), None, {"epoch": 1, "tag": "e1"})
    monkeypatch.undo()

    assert mid.exists()
    state, best, loop = mid.restore("cpu")
    assert loop["epoch"] == 0 and loop["tag"] == "e0" and best is None
    assert torch.equal(state["model"]["w"], torch.zeros(3)) and state["step"] == 0

    # a later save commits epoch 1 and drops epoch 0
    mid.save(snap(1), snap(1), {"epoch": 1, "tag": "e1"})
    state, best, loop = mid.restore("cpu")
    assert loop["epoch"] == 1
    assert torch.equal(state["model"]["w"], torch.ones(3))
    assert torch.equal(best["model"]["w"], torch.ones(3))
    dirs = {d for d in os.listdir(mid.path) if os.path.isdir(os.path.join(mid.path, d))}
    assert dirs == {"state_e1", "best_e1"}
    # a save without a new best keeps the older one
    mid.save(snap(2), None, {"epoch": 2})
    state, best, loop = mid.restore("cpu")
    assert loop["best_dir"] == "best_e1" and torch.equal(best["model"]["w"], torch.ones(3))


def test_artifact_names_match_jax():
    grid = itertools.product(
        [False, True], ["emotion", "gender", "multitask"], ["float32", "bfloat16"],
        [False, True], [0.0, 0.1], [0, 20, 80], [False, True], [0.0, 0.5], ["train", "eval"])
    for adv, pred, dtype, grl, lam, ratio, anti, sal, md in grid:
        kw = dict(adv=adv, pred=pred, compute_dtype=dtype, grl=grl, scale_lambda=lam,
                  suppression_ratio=ratio, antithetic_noise=anti, saliency_align=sal,
                  mask_direction=md)
        ours, theirs = ExperimentConfig(**kw), JaxConfig(**kw)
        assert TB.artifact_name(ours) == JTB.artifact_name(theirs)
        assert TC.cloak_artifact(ours) == JTC.cloak_artifact(theirs)


class _JaxCkpt:
    """The port's artifacts as the JAX run_folds restore them; saves are
    recorded, not written."""

    def __init__(self, port_ckpt):
        self.port, self.saved = port_ckpt, {}

    def restore(self, artifact, fold):
        sd = {k: v.numpy() for k, v in self.port.restore(artifact, fold, "cpu").items()}
        if artifact.startswith("cloak"):
            return {"params": {"noise": import_cloak_noise(
                {k: sd[f"noise.{k}"] for k in ("locs", "rhos")})}}
        return import_backbone(sd, pred="emotion")

    def save(self, artifact, fold, params, batch_stats=None, manifest=None):
        self.saved[artifact] = manifest


def _jax_fit(captured):
    def fit(state, step, logits_fn, train, val, test, cfg, spk_weights=None, mask=None,
            verbose=True, epoch_callback=None):
        captured["mask"] = None if mask is None else np.asarray(mask)
        return jax_loop.FitResult(best_state=state, best_epoch=0, best_val_acc=0.0,
                                  final_test_acc=0.0, final_test_uar=0.0,
                                  final_confusion=np.zeros((0, 0)), history=[{}])
    return fit


def test_run_fold_chain_matches_jax_structure(tmp_path, monkeypatch):
    kw = dict(win_len=T, feature_len=D, hidden_size=H, batch_size=8, num_epochs=2,
              dataset="combine", output_dir=str(tmp_path / "out"), learning_rate=5e-2)
    ckpt = CheckpointManager(kw["output_dir"])
    fold = _fold(SplitArrays, FoldData)
    metrics = str(tmp_path / "metrics.jsonl")
    TB.run_fold(preset("baseline", **kw), fold, ckpt, verbose=False, metrics_path=metrics,
                device="cpu")
    assert [json.loads(line)["epoch"] for line in open(metrics)] == [0, 1]
    masks = []

    def capture(*args, **kwargs):
        masks.append(kwargs["mask"])
        return fit_device_cloak(*args, **kwargs)

    fit_device_cloak = TC.fit_device_cloak
    monkeypatch.setattr(TC, "fit_device_cloak", capture)
    TC.run_fold(preset("cloak_grl", **kw), fold, ckpt, verbose=False, device="cpu")
    # two epochs leave the scales nearly uniform, where torch's and XLA's tanh
    # (an ulp apart) order near-equal cells differently: spread the rhos, so
    # that both packages' masks come from the same order
    supp0 = ckpt.restore("cloak_grl_lamda0.1_supp0", 1, "cpu")
    supp0["noise.rhos"] = torch.from_numpy(
        np.random.default_rng(4).uniform(-2.5, 0.5, (1, T, D)).astype(np.float32))
    ckpt.save("cloak_grl_lamda0.1_supp0", 1, supp0)
    TC.run_fold(preset("cloak_grl", suppression_ratio=20, **kw), fold, ckpt, verbose=False,
                device="cpu")
    base = ckpt.restore("baseline_emotion", 1, "cpu")
    supp20 = ckpt.restore("cloak_grl_lamda0.1_supp20", 1, "cpu")
    for cloak in (supp0, supp20):  # grafted, frozen: the baseline bit for bit
        assert all(torch.equal(cloak[f"emotion_backbone.{k}"], v) for k, v in base.items())
    assert torch.equal(supp20["noise.rhos"], supp0["noise.rhos"])  # frozen under the mask
    assert not torch.equal(supp20["noise.locs"], supp0["noise.locs"])
    assert masks[0] is None and masks[1].mean() == pytest.approx(0.8, abs=0.01)

    # the JAX run_folds on the same artifacts
    captured = {}
    monkeypatch.setattr(jax_loop, "fit", _jax_fit(captured))
    jckpt = _JaxCkpt(ckpt)
    jfold = _fold(JaxSplit, JaxFold)
    JTB.run_fold(jax_preset("baseline", **kw), jfold, jckpt, verbose=False)
    JTC.run_fold(jax_preset("cloak_grl", suppression_ratio=20, **kw), jfold, jckpt,
                 verbose=False)
    np.testing.assert_array_equal(masks[1], captured["mask"])
    assert sorted(jckpt.saved) == ["baseline_emotion", "cloak_grl_lamda0.1_supp20"]
    for artifact, manifest in jckpt.saved.items():
        ours = json.loads((tmp_path / "out" / artifact / "manifest_fold1.json").read_text())
        assert ours.keys() == manifest.keys()
        assert ours["config"] == {k: v for k, v in jax_jsonable(manifest["config"]).items()
                                  if k in ours["config"]}
    assert dataclasses.asdict(preset("cloak_grl", **kw)).keys() <= \
        dataclasses.asdict(jax_preset("cloak_grl", **kw)).keys()
