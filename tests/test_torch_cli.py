"""The port's command lines against the JAX package's: the option sets,
featurize's store and manifest, preprocess's folds, run_all end to end on
the CPU (artifact names, the sweep CSV, run.json), the requests the port
refuses, and data parallelism through the command lines (2 gloo CPU
ranks)."""

import argparse
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from sept_tpu.cli import common as jcommon
from sept_tpu.cli import evaluate as jevaluate
from sept_tpu.cli import featurize as jfeaturize
from sept_tpu.cli import preprocess as jpreprocess
from sept_tpu.cli import run_all as jrun_all
from sept_tpu.cli import train_baseline as jtrain_baseline
from sept_tpu.cli import train_cloak as jtrain_cloak
from sept_tpu.data import store as jstore
from sept_tpu.eval import sweep as jsweep
from sept_tpu.utils import logging as jlogging
from sept_tpu_torch.cli import evaluate, featurize, preprocess, run_all, train_baseline
from sept_tpu_torch.cli import train_cloak
from sept_tpu_torch.data import store
from sept_tpu_torch.parallel import visible_devices

from _torch_helpers import assert_folds_equal

PAIRS = {"featurize": (featurize, jfeaturize), "preprocess": (preprocess, jpreprocess),
         "train_baseline": (train_baseline, jtrain_baseline),
         "train_cloak": (train_cloak, jtrain_cloak), "evaluate": (evaluate, jevaluate),
         "run_all": (run_all, jrun_all)}
JAX_ONLY = {"--prng_impl", "--conv_backend", "--remat"}
# run_all at a small size on the CPU
SMALL = ["--dataset", "synthetic", "--input_spec_size", "32", "--win_len", "50",
         "--hidden_size", "8", "--num_epochs", "1", "--grl", "1", "--scale_lamda", "0.1",
         "--folds", "1"]
RATIOS = ["--ratios", "0", "20"]


def options(main, monkeypatch):
    """The option strings of ``main``'s parser, read where it parses."""
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["opts"] = {s for a in self._actions for s in a.option_strings}
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            main([])
    return seen["opts"]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_help_exits_zero(name, capsys):
    with pytest.raises(SystemExit) as e:
        PAIRS[name][0].main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--dataset" in out and "--device" in out


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_options_are_jax_less_its_own_plus_device(name, monkeypatch):
    ours = options(PAIRS[name][0].main, monkeypatch)
    theirs = options(PAIRS[name][1].main, monkeypatch)
    assert ours == (theirs - JAX_ONLY) | {"--device"}
    assert JAX_ONLY <= theirs


@pytest.mark.parametrize("flag", ["--prng_impl", "--conv_backend", "--remat"])
def test_jax_only_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as e:
        train_baseline.main(["--device", "cpu", flag, "1"])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def featurize_args(work):
    return ["--dataset", "synthetic", "--work_dir", str(work), "--input_spec_size", "32",
            "--seed", "8", "--n_speakers", "4", "--utts_per_speaker", "2", "--functionals", "0"]


def test_featurize_writes_jax_store_and_manifest(tmp_path):
    """The same synthetic corpus featurized by both CLIs: stores within
    1e-3 dB (test_torch_featurize.py's mel tolerance), manifests the same
    bytes."""
    featurize.main(featurize_args(tmp_path / "ours") + ["--device", "cpu"])
    jfeaturize.main(featurize_args(tmp_path / "theirs"))
    rel = "feature/mel_spec/synthetic"
    ours = store.load_feature_store(str(tmp_path / "ours" / rel / "data_32.npz"))
    theirs = jstore.load_feature_store(str(tmp_path / "theirs" / rel / "data_32.npz"))
    assert ours.keys() == theirs.keys() and len(ours) == 8
    for u in ours:
        assert ours[u].keys() == theirs[u].keys() == {"mel1", "mel2"}
        for k in ours[u]:
            assert ours[u][k].shape == theirs[u][k].shape and ours[u][k].shape[0] == 32
            np.testing.assert_allclose(ours[u][k], theirs[u][k], atol=1e-3, rtol=0)
    assert (tmp_path / "ours" / rel / "manifest.json").read_bytes() == \
        (tmp_path / "theirs" / rel / "manifest.json").read_bytes()


@pytest.mark.parametrize("extra", [[], ["--aug", "gender", "--norm", "min_max", "--shift", "0"]])
def test_preprocess_of_jax_store_writes_jax_folds(tmp_path, extra):
    jfeaturize.main(featurize_args(tmp_path / "theirs"))
    shutil.copytree(tmp_path / "theirs", tmp_path / "ours")
    args = ["--dataset", "synthetic", "--input_spec_size", "32", "--win_len", "50", *extra]
    preprocess.main(args + ["--work_dir", str(tmp_path / "ours")])
    jpreprocess.main(args + ["--work_dir", str(tmp_path / "theirs")])
    for k in range(1, 6):
        rel = f"folds/synthetic/fold{k}.npz"
        assert_folds_equal(store.load_fold(str(tmp_path / "ours" / rel)),
                           store.load_fold(str(tmp_path / "theirs" / rel)))


@pytest.fixture(scope="module")
def run_all_cpu(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_all")
    dirs = ["--work_dir", str(root / "work"), "--output_dir", str(root / "results")]
    run_all.main(SMALL + RATIOS + dirs + ["--device", "cpu"])
    return root, dirs


def jax_config():
    """The JAX package's config of SMALL, through its own parser."""
    p = argparse.ArgumentParser()
    jcommon.add_common_args(p)
    p.add_argument("--grl", type=int, default=0)
    args = p.parse_args(SMALL)
    return jcommon.config_from_args(args, grl=bool(args.grl))


def test_run_all_writes_the_jax_artifact_tree(run_all_cpu):
    root, _ = run_all_cpu
    cfg = jax_config()
    names = {jtrain_baseline.artifact_name(dataclasses.replace(cfg, adv=a, pred=p))
             for a, p in ((False, "emotion"), (True, "gender"))}
    names |= {jtrain_cloak.cloak_artifact(dataclasses.replace(cfg, suppression_ratio=r))
              for r in (0, 20)}
    results = root / "results"
    assert {p.name for p in results.iterdir() if p.is_dir()} == names
    for name in names:
        assert (results / name / "fold1" / "state_dict.pt").is_file()
        assert json.loads((results / name / "manifest_fold1.json").read_text())["config"]
    assert (root / "work" / "feature" / "mel_spec" / "synthetic" / "data_32.npz").is_file()
    assert (root / "work" / "folds" / "synthetic" / "fold1.npz").is_file()
    assert sorted(p.name for p in results.iterdir() if p.is_file()) == ["grl-0.1.csv"]


def test_sweep_csv_is_what_jax_writes(run_all_cpu, tmp_path):
    """The CLI's CSV, byte for byte, is what the JAX package's sweep_to_rows
    + rows_to_csv write for the same per-fold results (evaluate run again
    returns them)."""
    root, dirs = run_all_cpu
    per_ratio = evaluate.main(SMALL + RATIOS + dirs + ["--device", "cpu"])
    assert sorted(per_ratio) == [0, 20] and all(len(v) == 1 for v in per_ratio.values())
    jsweep.rows_to_csv(jsweep.sweep_to_rows(per_ratio, "synthetic"), str(tmp_path / "j.csv"))
    ours = (root / "results" / "grl-0.1.csv").read_text()
    assert ours == (tmp_path / "j.csv").read_text()
    assert ours.splitlines()[0] == ",baseline_acc,baseline_rec,adv_acc,adv_rec"
    assert [r.split(",")[0] for r in ours.splitlines()[1:]] == [
        "suppression_ratio_0_synthetic", "suppression_ratio_20_synthetic"]


@pytest.mark.parametrize("artifact", ["baseline_emotion", "adv_baseline_gender"])
def test_run_json_has_the_jax_keys(run_all_cpu, tmp_path, artifact):
    root, _ = run_all_cpu
    ours = json.loads((root / "results" / artifact / "run.json").read_text())
    jm = jlogging.RunManifest(str(tmp_path / "run.json"), jax_config())
    jm.record(mean_test_acc=0.5, mean_test_uar=0.5, folds=[1])
    theirs = json.loads(open(jm.write()).read())
    assert set(ours) == (set(theirs) - {"jax_version"}) | {"torch_version", "cuda_version"}
    assert set(ours["results"]) == set(theirs["results"])
    assert ours["results"]["folds"] == [1]
    assert set(ours["config"]) == set(theirs["config"]) - {"conv_backend", "remat", "prng_impl",
                                                           "filter_size"}
    assert ours["devices"] == ["cpu"]


@pytest.mark.parametrize("case", ["global_feature", "functionals", "n_devices", "coordinator",
                                  "import_opensmile", "run_all_n_devices"])
def test_what_the_port_refuses(tmp_path, monkeypatch, case):
    """A data-parallel request that cannot run raises ``SystemExit`` before
    any stage runs: ``--n_devices`` above the visible devices, a
    ``SEPT_COORDINATOR`` without ``SEPT_NUM_PROCESSES`` and
    ``SEPT_PROCESS_ID``, and (run_all) a ``--batch_size`` the devices do not
    divide.  The global feature, the functionals and the openSMILE import,
    once refused here, are now taken: ``run_all --global_feature 1`` gets
    past its checks to preprocess (which finds no store under
    ``--skip_featurize``), ``featurize`` writes gemaps and emobase by
    default, and ``--import_opensmile`` reads its file (a missing one raises
    ``FileNotFoundError`` before anything is written)."""
    dirs = ["--work_dir", str(tmp_path), "--output_dir", str(tmp_path / "r"), "--device", "cpu"]
    tiny = ["--dataset", "synthetic", "--n_speakers", "2", "--utts_per_speaker", "1"]
    if case == "coordinator":
        monkeypatch.setenv("SEPT_COORDINATOR", "localhost:1234")
    call = {"global_feature": lambda: run_all.main(SMALL + dirs + ["--global_feature", "1",
                                                                  "--skip_featurize"]),
            "functionals": lambda: featurize.main(tiny + dirs),
            "n_devices": lambda: train_baseline.main(
                SMALL + dirs + ["--n_devices", str(visible_devices("cpu") + 1)]),
            "coordinator": lambda: train_cloak.main(SMALL + dirs),
            "import_opensmile": lambda: featurize.main(
                tiny + dirs + ["--functionals", "0", "--import_opensmile", "x.csv"]),
            "run_all_n_devices": lambda: run_all.main(SMALL + dirs + ["--n_devices", "3"])}
    if case == "functionals":
        call[case]()
        st = store.load_feature_store(str(tmp_path / "feature/mel_spec/synthetic/data_128.npz"))
        assert len(st) == 2 and all(v["gemaps"].shape == (88,) and v["emobase"].shape == (988,)
                                    for v in st.values())
        return
    raises = {"global_feature": FileNotFoundError,
              "import_opensmile": FileNotFoundError}.get(case, SystemExit)
    match = {"global_feature": "feature", "import_opensmile": "x.csv", "n_devices": "visible",
             "coordinator": "SEPT_NUM_PROCESSES", "run_all_n_devices": "divisible"}[case]
    with pytest.raises(raises, match=match):
        call[case]()
    assert not (tmp_path / "feature").exists()


def _train_baseline(root, out, n_devices, extra=()):
    train_baseline.main(SMALL + ["--work_dir", str(root / "work"), "--output_dir", str(out),
                                 "--device", "cpu", "--n_devices", str(n_devices), *extra])
    return out / "baseline_emotion"


def test_train_baseline_on_two_cpu_ranks_writes_what_one_device_writes(run_all_cpu, tmp_path):
    """``--device cpu --n_devices 2`` on run_all's fold: the artifact of one
    device, written once by rank 0 (one metrics line an epoch), with the
    same config, state_dict keys and shapes.  Dropout (0.2) draws per rank,
    as in the JAX package, so the weights are not one device's (the DP
    equality at dropout 0 is tests/test_torch_parallel.py's)."""
    root, _ = run_all_cpu
    two = _train_baseline(root, tmp_path / "two", 2)
    one = _train_baseline(root, tmp_path / "one", 1)
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir())
    m2, m1 = (json.loads((d / "manifest_fold1.json").read_text()) for d in (two, one))
    assert m2.keys() == m1.keys()
    assert {**m2["config"], "output_dir": ""} == {**m1["config"], "output_dir": ""}
    assert 0.0 <= m2["test_acc"] <= 1.0
    sd2, sd1 = (torch.load(d / "fold1" / "state_dict.pt") for d in (two, one))
    assert {k: v.shape for k, v in sd2.items()} == {k: v.shape for k, v in sd1.items()}
    assert all(bool(torch.isfinite(v).all()) for v in sd2.values() if v.is_floating_point())
    lines = (two / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and np.isfinite(json.loads(lines[0])["train_loss"])
    r2, r1 = (json.loads((d / "run.json").read_text()) for d in (two, one))
    assert r2.keys() == r1.keys() and r2["results"]["folds"] == [1]


def test_train_baseline_refuses_a_batch_the_ranks_do_not_divide(run_all_cpu, tmp_path):
    root, _ = run_all_cpu
    with pytest.raises(SystemExit, match="divisible"):
        _train_baseline(root, tmp_path / "r", 2, ["--batch_size", "7"])
    assert not (tmp_path / "r").exists()


def test_evaluate_on_two_cpu_ranks_matches_one_device(run_all_cpu, tmp_path):
    """The sweep data-parallel (eval mode: no dropout) writes one device's
    CSV byte for byte, and returns its results."""
    root, _ = run_all_cpu
    shutil.copytree(root / "results", tmp_path / "results")
    dirs = ["--work_dir", str(root / "work"), "--output_dir", str(tmp_path / "results")]
    (tmp_path / "results" / "grl-0.1.csv").unlink()
    per_ratio = evaluate.main(SMALL + RATIOS + dirs + ["--device", "cpu", "--n_devices", "2"])
    assert (tmp_path / "results" / "grl-0.1.csv").read_text() == \
        (root / "results" / "grl-0.1.csv").read_text()
    ref = evaluate.main(SMALL + RATIOS + dirs + ["--device", "cpu"])
    for ratio in (0, 20):
        for got, want in zip(per_ratio[ratio][0], ref[ratio][0]):
            assert got["acc"] == want["acc"] and got["rec"] == want["rec"]
            np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6)


def test_run_all_passes_n_devices_to_every_stage(tmp_path, monkeypatch):
    seen = {}
    for name, mod in (("featurize", featurize), ("preprocess", preprocess),
                      ("train_baseline", train_baseline), ("train_cloak", train_cloak),
                      ("evaluate", evaluate)):
        monkeypatch.setattr(mod, "main", lambda argv, name=name: seen.setdefault(name, argv))
    run_all.main(SMALL + ["--device", "cpu", "--n_devices", "2", "--work_dir", str(tmp_path)])
    assert len(seen) == 5
    for argv in seen.values():
        assert argv[argv.index("--n_devices") + 1] == "2"
