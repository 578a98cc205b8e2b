"""The port's public API against the JAX package's: every name in every JAX
subpackage's ``__all__`` is exported by the port's subpackage of the same
name, or has no module-level counterpart and is listed in
``NO_MODULE_COUNTERPART`` with where its function lives in the port (None:
XLA's alone).  The README's port section carries the same table."""

import importlib

import pytest

SUBPACKAGES = ("data", "ops", "train", "eval", "utils", "runtime", "models", "parallel",
               "compat")

NO_MODULE_COUNTERPART = {
    # the Pallas entries: the CUDA kernels' wrappers
    "ops.pallas_mel_spectrogram": "sept_tpu_torch.ops.mel.mel_db",
    "ops.pallas_mfcc": "sept_tpu_torch.ops.mfcc.fused_mfcc",
    # flax submodules that are methods of the port's modules
    "models.AttentionPool": "sept_tpu_torch.models.Conv2dBiRNN.pool",
    "models.StackedBiRNN": "sept_tpu_torch.models.Conv2dBiRNN._rnn",
    # Mesh / NamedSharding helpers: one process a device, a rank takes its rows
    "parallel.make_mesh": "sept_tpu_torch.parallel.make_group",
    "parallel.batch_sharding": "sept_tpu_torch.parallel.DataGroup",
    "parallel.replicated": "sept_tpu_torch.parallel.DataGroup",
    "parallel.shard_batch": "sept_tpu_torch.parallel.DataGroup",
    "parallel.replicate_state": "sept_tpu_torch.parallel.broadcast_state",
    "parallel.put_replicated": "sept_tpu_torch.parallel.broadcast_state",
    "parallel.make_shard_map_dp_step": "sept_tpu_torch.parallel.make_dp_step",
    # XLA's compile cache and platform pin: nothing to port
    "cli.common.enable_compile_cache": None,
    "cli.common.pin_cpu_platform": None,
}

THEIRS = {sub: importlib.import_module(f"sept_tpu.{sub}") for sub in SUBPACKAGES}
OURS = {sub: importlib.import_module(f"sept_tpu_torch.{sub}") for sub in SUBPACKAGES}


def _resolve(dotted):
    """The object at a dotted path: the longest importable module prefix,
    then attributes."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(dotted)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_is_exported_or_mapped(sub):
    theirs, ours = THEIRS[sub].__all__, OURS[sub]
    missing = [n for n in theirs
               if n not in ours.__all__ and f"{sub}.{n}" not in NO_MODULE_COUNTERPART]
    assert not missing, f"sept_tpu_torch.{sub} lacks {missing}"
    for name in ours.__all__:
        assert getattr(ours, name) is not None, name


def test_the_mapping_names_jax_exports_and_port_locations():
    for key, home in NO_MODULE_COUNTERPART.items():
        module, name = key.rsplit(".", 1)
        assert name in importlib.import_module(f"sept_tpu.{module}").__all__, key
        assert name not in getattr(importlib.import_module(f"sept_tpu_torch.{module}"),
                                   "__all__", ()), f"{key} is exported: drop it from the map"
        if home is not None:
            assert callable(_resolve(home)), home
