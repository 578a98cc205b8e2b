"""The port's utilities (``sept_tpu_torch/utils``): named random streams,
the profiler trace and the step timer, held to what tests/test_utils.py
asks of the JAX package's.  Torch's streams are not threefry: the
contract is determinism and distinctness by name, and fold_in_name's
digest, which is the JAX package's."""

import hashlib
import json

import numpy as np
import pytest
import torch

from sept_tpu.utils import StepTimer as JaxStepTimer
from sept_tpu_torch.utils import KeySeq, MetricsLogger, RunManifest, StepTimer, fold_in_name, trace
from sept_tpu_torch.utils import prng


def test_keyseq_deterministic_and_distinct():
    a, b = KeySeq(8, "cpu"), KeySeq(8, "cpu")
    g1, g2 = a(), a()
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=b()))
    assert not torch.equal(torch.rand(4, generator=a()), torch.rand(4, generator=g2))
    # named derivation is stable and name-dependent
    assert fold_in_name(0, "noise") == fold_in_name(0, "noise")
    assert fold_in_name(0, "noise") != fold_in_name(0, "dropout")
    assert fold_in_name(0, "noise") != fold_in_name(1, "noise")
    n1, n2 = KeySeq(8, "cpu")("noise"), KeySeq(8, "cpu")("noise")
    assert torch.equal(torch.rand(4, generator=n1), torch.rand(4, generator=n2))
    assert not torch.equal(torch.rand(4, generator=KeySeq(8, "cpu")("noise")),
                           torch.rand(4, generator=KeySeq(8, "cpu")("dropout")))


def test_keyseq_takes_numpy_seeds_and_generators():
    """A numpy integer is a seed (not a generator), as the JAX package's
    ``numbers.Integral`` check takes it; a generator is drawn from."""
    a, b = KeySeq(np.int64(8), "cpu"), KeySeq(8, "cpu")
    assert torch.equal(torch.rand(3, generator=a("x")), torch.rand(3, generator=b("x")))
    c = KeySeq(torch.Generator().manual_seed(5), "cpu")
    d = KeySeq(torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(torch.rand(3, generator=c()), torch.rand(3, generator=d()))
    with pytest.raises(TypeError):
        KeySeq(8.0, "cpu")


def test_fold_in_name_digest_is_the_jax_packages():
    digest = int.from_bytes(hashlib.sha256(b"noise").digest()[:4], "big")
    assert prng._digest("noise") == digest


def test_keyseq_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        KeySeq(8)


def test_step_timer_summary_matches_jax():
    """The same samples give the JAX package's summary: warm-up skipped,
    the warm-up alone when it is all there is, zeros when empty."""
    for times in ([0.3, 0.1, 0.2, 0.4, 0.15], [0.25], []):
        ours, theirs = StepTimer(), JaxStepTimer()
        ours.times, theirs.times = list(times), list(times)
        assert ours.summary() == theirs.summary()
        assert ours.summary(skip_warmup=0) == theirs.summary(skip_warmup=0)
    t = StepTimer("cpu")
    assert t.summary() == {"n": 0, "mean_s": 0.0, "p50_s": 0.0, "p90_s": 0.0, "total_s": 0.0}
    for _ in range(5):
        with t:
            pass
    s = t.summary()
    assert s["n"] == 4 and s["mean_s"] >= 0 and len(t.times) == 5
    warm = StepTimer()
    with warm:
        pass
    assert warm.summary()["n"] == 1


def test_trace_writes_a_trace_and_nothing_when_disabled(tmp_path):
    x = torch.ones(64, 64)
    with trace(str(tmp_path / "on")):
        (x @ x).sum()
    files = list((tmp_path / "on").glob("*.pt.trace.json"))
    assert len(files) == 1
    assert "aten::mm" in {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    with trace(str(tmp_path / "off"), enabled=False):
        (x @ x).sum()
    with trace(None):
        (x @ x).sum()
    assert not (tmp_path / "off").exists()


def test_run_manifest_and_metrics(tmp_path):
    m = RunManifest(str(tmp_path / "run.json"), config={"lr": 1e-3})
    m.record(acc=np.float32(0.5), conf=np.eye(2))
    data = json.load(open(m.write()))
    assert data["config"]["lr"] == 1e-3
    assert data["results"]["acc"] == 0.5
    log = MetricsLogger(str(tmp_path / "metrics.jsonl"))
    log.log(epoch=0, loss=1.5)
    log.log(epoch=1, loss=torch.tensor(1.2))
    log.close()
    lines = open(tmp_path / "metrics.jsonl").read().strip().split("\n")
    assert len(lines) == 2
    assert abs(json.loads(lines[1])["loss"] - 1.2) < 1e-6
