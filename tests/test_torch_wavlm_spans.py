"""The spans of ``models/wavlm.py`` in a cloak + GRL step on two tiny
WavLM backbones: the eager step (the one ``fit``'s host loop runs and the
benchmark's span steps profile) opens ``wavlm.feature_encoder`` once and
``wavlm.attention`` / ``wavlm.ffn`` once a layer in each backbone, all
inside its ``train.forward``; a step the epoch runner replays as a CUDA
graph opens none of them (``card``: on the card, ``python -m pytest
tests/test_torch_wavlm_spans.py --noconftest -m card -q``).  No JAX here:
the card's machine has none."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sept_tpu_torch.models import CloakedModelGRL, build_backbone
from sept_tpu_torch.train.config import preset
from sept_tpu_torch.train.optim import make_cloak_optimizer
from sept_tpu_torch.train.steps import init_state, make_cloak_epoch_runner, make_cloak_grl_step

LAYERS, WIN, HOP, B = 2, 48, 160, 4
TINY = dict(hidden_size=32, num_hidden_layers=LAYERS, num_attention_heads=4,
            intermediate_size=64, conv_dim=[16] * 7, num_conv_pos_embeddings=8,
            num_conv_pos_embedding_groups=4, num_buckets=32, max_bucket_distance=40,
            classifier_proj_size=8)
WAVLM = ("wavlm.feature_encoder", "wavlm.attention", "wavlm.ffn")


def _state(device, dtype=torch.float32):
    torch.manual_seed(0)
    model = CloakedModelGRL(
        *(build_backbone("wavlm-large", pred=p, compute_dtype=dtype, **TINY)
          for p in ("emotion", "gender")), win_len=WIN, n_feats=HOP)
    exp = preset("cloak_grl", batch_size=B)
    opt = make_cloak_optimizer(exp, 8, model, ("noise", "gender_backbone"))
    return init_state(model, opt, 5, device)


def _batch(device, n=B, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"spec": torch.randn((n, 1, WIN, HOP), generator=g).to(device),
            "labels_emo": torch.randint(0, 4, (n,), generator=g).to(device),
            "labels_gen": torch.randint(0, 2, (n,), generator=g).to(device),
            "weight": torch.ones(n, device=device)}


def _ranges(prof, names):
    out = {n: [] for n in names}
    for e in prof.profiler.kineto_results.events():
        if e.name() in out and e.device_type() != torch.autograd.DeviceType.CUDA:
            out[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def test_eager_step_opens_the_wavlm_spans_inside_its_forward():
    state = _state("cpu")
    step = make_cloak_grl_step(0.1, 0.1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _batch("cpu"))
    got = _ranges(prof, ("train.forward", "train.backward") + WAVLM)
    assert [len(got[n]) for n in WAVLM] == [2, 2 * LAYERS, 2 * LAYERS]
    (f0, f1), = got["train.forward"]
    for name in WAVLM:
        assert all(f0 <= a and b <= f1 for a, b in got[name]), name
    # attention, then the FFN, layer by layer
    att, ffn = sorted(got["wavlm.attention"]), sorted(got["wavlm.ffn"])
    assert all(a[1] <= f[0] for a, f in zip(att, ffn))


def test_outside_a_session_the_step_records_nothing():
    state = _state("cpu")
    make_cloak_grl_step(0.1, 0.1)(state, _batch("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not any(_ranges(prof, WAVLM).values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_card_replayed_steps_open_no_wavlm_span(card):
    """A bf16 runner's first step is eager and its second captured; the
    three after them, in a profiler session, are replays: one
    ``train.step`` each and no WavLM span."""
    state = _state(card, torch.bfloat16)
    n = 5 * B
    data = _batch(card, n, seed=2)
    windows = data["spec"][:, 0]
    runner = make_cloak_epoch_runner(0.1, 0.1, grl=True)

    def run(rows):
        return runner(state, windows, data["labels_emo"], data["labels_gen"], data["weight"],
                      rows, None, n_batches=len(rows) // B, batch_size=B)[1]

    first = run(torch.arange(2 * B, device=card))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        later = run(torch.arange(2 * B, n, device=card))
        torch.cuda.synchronize()
    assert (runner.eager_steps, runner.graph_captures, runner.graph_replays) == (1, 1, 3)
    assert bool(torch.isfinite(torch.cat([first, later])).all())
    got = _ranges(prof, ("train.step",) + WAVLM)
    assert len(got["train.step"]) == 3
    assert not any(got[n] for n in WAVLM)
