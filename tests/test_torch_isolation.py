"""The PyTorch port stands alone: no JAX, no scikit-learn, no sept_tpu, no
silent CPU fallback."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "sept_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "sept_tpu")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'sklearn', 'sept_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import sept_tpu_torch.serve, sept_tpu_torch.compat.from_jax\n"
        "import sept_tpu_torch.ops.conv_block1, sept_tpu_torch.ops.cuda_lib\n"
        "import sept_tpu_torch.ops.grl, sept_tpu_torch.models.cloak\n"
        "import sept_tpu_torch.train.config, sept_tpu_torch.train.optim\n"
        "import sept_tpu_torch.train.steps, sept_tpu_torch.train.device_loop\n"
        "import sept_tpu_torch.data.device_pipeline, sept_tpu_torch.data.featurize\n"
        "import sept_tpu_torch.ops.mfcc, sept_tpu_torch.ops.functionals\n"
        "import sept_tpu_torch.eval.metrics, sept_tpu_torch.eval.sliding\n"
        "import sept_tpu_torch.eval.sweep, sept_tpu_torch.train.loop\n"
        "import sept_tpu_torch.train.checkpoint, sept_tpu_torch.train.midfold\n"
        "import sept_tpu_torch.cli.train_baseline, sept_tpu_torch.cli.train_cloak\n"
        "import sept_tpu_torch.utils.logging, sept_tpu_torch.data.pipeline\n"
        "import sept_tpu_torch.data.corpora, sept_tpu_torch.data.windowing\n"
        "import sept_tpu_torch.data.normalize, sept_tpu_torch.data.augment\n"
        "import sept_tpu_torch.data.splits, sept_tpu_torch.data.combine\n"
        "import sept_tpu_torch.data.store, sept_tpu_torch.data.synthetic\n"
        "import sept_tpu_torch.data.walkers, sept_tpu_torch.runtime.wavio\n"
        "import sept_tpu_torch.cli.common, sept_tpu_torch.cli.featurize\n"
        "import sept_tpu_torch.cli.preprocess, sept_tpu_torch.cli.evaluate\n"
        "import sept_tpu_torch.cli.run_all, sept_tpu_torch.cli.serve\n"
        "import sept_tpu_torch.cli.predict, sept_tpu_torch.cli.export_torch\n"
        "import sept_tpu_torch.cli.import_torch, sept_tpu_torch.compat.torch_io\n"
        "import sept_tpu_torch.ops.egemaps, sept_tpu_torch.ops.emobase\n"
        "import sept_tpu_torch.parallel, sept_tpu_torch.parallel.epoch_dp\n"
        "import sept_tpu_torch.data.opensmile_import\n"
        "import sept_tpu_torch.utils.profiling, sept_tpu_torch.utils.prng\n"
        "import sept_tpu_torch.data, sept_tpu_torch.ops, sept_tpu_torch.train\n"
        "import sept_tpu_torch.eval, sept_tpu_torch.utils, sept_tpu_torch.runtime\n"
        "import sept_tpu_torch.models, sept_tpu_torch.compat, sept_tpu_torch.cli\n"
        "from sept_tpu_torch.train import fit, ExperimentConfig\n"
        "from sept_tpu_torch.data import featurize_corpus, SplitArrays\n"
        "import chip_smoke\n"
        "assert not any(m.startswith(('jax', 'flax', 'orbax', 'sklearn')) for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "from sept_tpu_torch.ops import cuda_lib\n"
        "assert not cuda_lib._libs, 'a kernel was built on import'\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_predictor_without_device_needs_cuda(monkeypatch):
    from sept_tpu_torch.serve import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor({})
    with pytest.raises(ValueError, match="unsupported device"):
        Predictor({}, device="meta")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from sept_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib, "_NVCC_DEFAULT", str(tmp_path / "no" / "nvcc"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.build(["mel"])


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA, and alone in an empty directory, the smoke script exits
    non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


@pytest.mark.parametrize("entry", ["featurize_corpus", "fused_mfcc", "bf16_ingest"])
def test_featurization_entry_points_need_cuda_by_default(monkeypatch, entry):
    """The corpus featurizer, ``fused_mfcc`` and the bf16 ingest run on
    ``device="cuda"`` unless asked for the CPU, and raise without a card."""
    import numpy as np

    from sept_tpu_torch.data.device_pipeline import device_ingest
    from sept_tpu_torch.data.featurize import featurize_corpus
    from sept_tpu_torch.ops.mfcc import fused_mfcc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wave = np.zeros(4000, np.float32)
    call = {"featurize_corpus": lambda: featurize_corpus({"u": wave}, "mfcc",
                                                         include_gemaps=False),
            "fused_mfcc": lambda: fused_mfcc(np.zeros((1, 4400), np.float32), 21),
            "bf16_ingest": lambda: device_ingest([wave], np.zeros(1, int), np.zeros(1, int),
                                                 np.zeros(1, int), frontend="pallas_bf16")}
    with pytest.raises(RuntimeError, match="cuda"):
        call[entry]()


@pytest.mark.parametrize("cli", ["featurize", "train_baseline", "train_cloak", "evaluate",
                                 "run_all"])
def test_clis_need_cuda_by_default(monkeypatch, tmp_path, cli):
    """Each CLI that touches a device runs on ``--device cuda`` unless asked
    for the CPU, and raises without a card before it does any work."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--dataset", "synthetic", "--work_dir", str(tmp_path), "--output_dir",
            str(tmp_path / "r")]
    args += {"featurize": ["--functionals", "0", "--n_speakers", "2"],
             "run_all": ["--n_speakers", "2"]}.get(cli, [])
    with pytest.raises(RuntimeError, match="cuda"):
        importlib.import_module(f"sept_tpu_torch.cli.{cli}").main(args)
    assert list(tmp_path.iterdir()) == []
