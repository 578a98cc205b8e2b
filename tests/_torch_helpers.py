"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX model is initialised from a seed, then every parameter and running
statistic is perturbed with seeded numpy noise, so that no mapping error can
hide behind flax's zero biases or unit running variances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sept_tpu.models import Conv2dBiRNN


def _perturb(tree, rng, scale):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, scale) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_backbone(hidden=8, pred="emotion", att=None, win=60, d=32, seed=0):
    """(model, params, batch_stats) of a JAX Conv2dBiRNN as numpy trees,
    shared by the tests of one process (callers must not mutate them)."""
    model = Conv2dBiRNN(hidden_size=hidden, pred=pred, att=att)
    v = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)},
                            jnp.zeros((1, win, d, 1)))
    rng = np.random.default_rng(seed + 100)
    params = _perturb(jax.tree_util.tree_map(np.asarray, v["params"]), rng, 0.05)
    stats = {
        name: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
               "var": (1.0 + 0.5 * rng.random(s["var"].shape)).astype(np.float32)}
        for name, s in v["batch_stats"].items()
    }
    return model, params, stats


@functools.lru_cache(maxsize=None)
def jax_zoo(model_type, hidden=8, pred="emotion", att=None, win=60, d=32, seed=0,
            rnn_cell="gru"):
    """(model, params, batch_stats) of the JAX package's ``build_backbone``
    of any --model_type, initialised with its own pooling and perturbed as
    :func:`jax_backbone` perturbs; shared by the tests of one process."""
    from sept_tpu.models import build_backbone, pooling_for

    model = build_backbone(model_type, hidden_size=hidden, pred=pred, att=att,
                           rnn_cell=rnn_cell)
    init = functools.partial(model.init, pooling=pooling_for(model_type))
    v = jax.jit(init)({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, win, d, 1)))
    rng = np.random.default_rng(seed + 100)
    params = _perturb(jax.tree_util.tree_map(np.asarray, v["params"]), rng, 0.05)
    stats = {
        name: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
               "var": (1.0 + 0.5 * rng.random(s["var"].shape)).astype(np.float32)}
        for name, s in v.get("batch_stats", {}).items()
    }
    return model, params, stats


def speechlike(rng, n, noise=0.05):
    """A 16 kHz test signal: two tones over a broadband noise floor.

    The floor keeps every mel band far above f32 rounding: where a band sits
    60 dB under the frame's energy, its dB value is set by the summation
    order of the DFT and two f32 implementations differ by up to ~0.05 dB.
    """
    t = np.arange(n) / 16000.0
    f1, f2 = rng.uniform(100, 400), rng.uniform(800, 3000)
    w = (0.3 * np.sin(2 * np.pi * f1 * t) + 0.1 * np.sin(2 * np.pi * f2 * t)
         + noise * rng.standard_normal(n))
    return w.astype(np.float32)


BF16_GEOMETRY = (64, 64, 128, 32, 16)  # the bf16 mel kernel's (nc, ks, mel_tile, mel_sub, align)


def bf16_kernel_tables(n_fft, n_mels, geometry=BF16_GEOMETRY):
    """The bf16 mel kernel's operands (``ops/mel.py::_kernel_tables_bf16``)
    on the CPU: (window, table, bank, masks)."""
    import torch

    from sept_tpu_torch.ops import mel as M

    return M._kernel_tables_bf16(n_fft, n_mels, geometry, torch.device("cpu"))


def expand_bf16_tables(n_fft, n_mels, geometry=BF16_GEOMETRY):
    """The bf16 mel kernel's tables read back tile by tile into dense f32
    (k_pad, chunks * nc) cos and sin and a (chunks * nc, passes * mel_tile)
    bank, asserting that every table is used whole and that each mask bit
    says whether its bank sub-tile holds a nonzero.  Returns (window, cos,
    sin, bank)."""
    import torch

    from sept_tpu_torch.ops import mel as M

    nc, ks, mel_tile, mel_sub, _ = geometry
    window, table, bank, masks = bf16_kernel_tables(n_fft, n_mels, geometry)
    widths = M.bf16_chunks(n_fft, geometry)
    k_pad = -(-n_fft // ks) * ks
    cos = torch.zeros((k_pad, len(widths) * nc))
    sin = torch.zeros_like(cos)
    off = 0
    for c, w in enumerate(widths):
        for k in range(0, k_pad, ks):
            tile = M.swizzle_tile(table[off:off + 2 * w * ks].view(2 * w, ks)).float()
            off += 2 * w * ks
            cos[k:k + ks, c * nc:c * nc + w] = tile[0::2].T
            sin[k:k + ks, c * nc:c * nc + w] = tile[1::2].T
    assert off == table.numel()
    passes = -(-n_mels // mel_tile)
    assert tuple(masks.shape) == (passes, len(widths))
    fb = torch.zeros((len(widths) * nc, passes * mel_tile))
    off = 0
    for p in range(passes):
        for c in range(len(widths)):
            blk = M.swizzle_tile(bank[off:off + mel_tile * ks].view(mel_tile, ks)).float()
            off += mel_tile * ks
            for sub in range(mel_tile // mel_sub):
                nonzero = bool(blk[sub * mel_sub:(sub + 1) * mel_sub].any())
                assert bool(int(masks[p, c]) >> sub & 1) == nonzero
            fb[c * nc:(c + 1) * nc, p * mel_tile:(p + 1) * mel_tile] = blk.T
    assert off == bank.numel()
    return window, cos, sin, fb


def assert_folds_equal(a, b):
    """Two FoldData (of either package) equal array for array: dtype, shape
    and values of every field of every split."""
    assert a.fold == b.fold
    for split in ("training", "validation", "adv_training", "adv_validation", "test"):
        sa, sb = getattr(a, split), getattr(b, split)
        for name in ("windows", "labels_emo", "labels_gen", "lengths", "global_data",
                     "speaker_ids", "datasets", "utt_ids"):
            x, y = getattr(sa, name), getattr(sb, name)
            assert x.dtype == y.dtype and x.shape == y.shape, (split, name)
            assert np.array_equal(x, y), (split, name)


def start_ranks(fn, *args, deadline_s=120):
    """Start ``fn(group, *args)`` on 2 gloo CPU ranks of one thread each
    (``sept_tpu_torch.parallel.spawn``) in a background thread, so that the
    test process computes its references meanwhile; returns a function that
    waits for the ranks and returns their results (or raises their error)."""
    import threading

    from sept_tpu_torch.parallel import make_group, spawn

    box = {}

    def run():
        try:
            box["ranks"] = spawn(fn, make_group(2, "cpu"), *args, deadline_s=deadline_s,
                                 threads=1)
        except BaseException as e:  # noqa: BLE001 -- re-raised by the waiter
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["ranks"]

    return wait
