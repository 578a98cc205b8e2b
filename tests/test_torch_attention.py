"""WavLM's gated-bias attention op (``ops/attention.py``,
``csrc/attention.cu``) held against the composition it replaces, and the
plain self-attention op (``self_attention``, Whisper's) against the
softmax.

On the CPU the op runs its plain version, which is ``models/wavlm.py``'s
attention core as it stood before the kernel (restated here as
``_composition``): its output and the gradients of qkv, the gate and the
bias equal the composition's bit for bit, in train and eval mode, at sizes
whose T is and is not a multiple of 16.  A CPU model launches no kernel,
and the f32 model's logits and gradients equal those of the model with the
old attention core patched back in, bit for bit.

The tests marked ``card`` launch the kernels on the H100: the kernel
against the plain version on the card at the benchmark's shape (32, 16,
99, 64) and off it (T 1, 17, 130 and 300; head dims 8, 16 and 80), the
masks from ``DropoutDraws``; a captured and replayed training step against
the eager one; the launch counters of one GRL step at 24 layers; the
streaming self-attention against its f32 composition at the Whisper cell's
shape and at T 99, 129 and 1,500, with no (B, heads, T, T) allocation, and
its counters under a graph replay.  They decide inside themselves whether
there is a card and skip without one.  On the card: ``python -m pytest
tests/test_torch_attention.py --noconftest -m card -q`` (``--noconftest``:
the suite's conftest imports JAX, which the card's machine does not have).
No JAX here.
"""

import math

import pytest
import torch
import torch.nn.functional as tf

from sept_tpu_torch.models import CloakedModelGRL, build_backbone
from sept_tpu_torch.models import wavlm as wavlm_mod
from sept_tpu_torch.models.backbone import DropoutDraws
from sept_tpu_torch.ops.attention import gated_bias_attention, gated_bias_attention_plain
from sept_tpu_torch.train.config import preset
from sept_tpu_torch.train.optim import make_cloak_optimizer
from sept_tpu_torch.train.steps import init_state, make_cloak_epoch_runner, make_cloak_grl_step

BF = torch.bfloat16
RATE = 0.1
WIN, HOP = 48, 160  # 23 frames
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            conv_dim=[16] * 7, num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4,
            num_buckets=32, max_bucket_distance=40, classifier_proj_size=8)


def _composition(qkv, gate, pos_bias, heads, draws, training, cd):
    """The attention core of ``WavLM._attention`` before the kernel, from
    the QKV product's (B, T, 3 hidden) output to the context."""
    b, t, width = qkv.shape
    hidden = width // 3
    hd = hidden // heads
    qkv = qkv.view(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    scores = (torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(hd))
              + gate.transpose(1, 2)[..., None] * pos_bias)
    p = wavlm_mod._drop(torch.softmax(scores, -1), draws, RATE, training)
    return torch.matmul(p.to(cd), v).transpose(1, 2).reshape(b, t, hidden)


def _old_attention(self, u, att, pos_bias, draws):
    """``WavLM._attention`` before the kernel, whole."""
    cd, heads = self.compute_dtype, self.heads
    b, t, hidden = u.shape
    hd = hidden // heads
    w = torch.cat([att.q_proj.weight, att.k_proj.weight, att.v_proj.weight]).to(cd)
    bias = torch.cat([att.q_proj.bias, att.k_proj.bias, att.v_proj.bias]).to(cd)
    qkv = tf.linear(u.to(cd), w, bias)
    g = tf.linear(u.view(b, t, heads, hd), att.gru_rel_pos_linear.weight,
                  att.gru_rel_pos_linear.bias)
    g = torch.sigmoid(g.view(b, t, heads, 2, 4).sum(-1))
    gate = g[..., 0] * (g[..., 1] * att.gru_rel_pos_const.view(heads) - 1.0) + 2.0
    ctx = _composition(qkv, gate, pos_bias, heads, draws, self.training, cd)
    return wavlm_mod._linear(ctx, att.out_proj, cd).float()


def _inputs(b, heads, t, hd, seed, dtype=BF, device="cpu", permuted_bias=True):
    """qkv (B, T, 3 hidden) in ``dtype``, the f32 gate (B, T, heads) in the
    model's range (1 to 3) and the f32 bias (heads, T, T), as leaves; the
    bias a permuted view where ``permuted_bias``, as the model builds it."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, t, 3 * heads * hd, generator=g).to(dtype)
    gate = 1.0 + 2.0 * torch.rand(b, t, heads, generator=g)
    bias = torch.randn(t, t, heads, generator=g)
    if not permuted_bias:
        bias = bias.permute(2, 0, 1).contiguous()
    qkv, gate, bias = (x.to(device).requires_grad_() for x in (qkv, gate, bias))
    return qkv, gate, (bias.permute(2, 0, 1) if permuted_bias else bias), bias


def _grads(out, leaves, seed):
    g = torch.Generator().manual_seed(seed + 1)
    dout = torch.randn(out.shape, generator=g).to(out.dtype).to(out.device)
    return torch.autograd.grad(out, leaves, dout, allow_unused=True)


# ---------------------------------------------------------------------------
# the CPU: the plain version is the composition


@pytest.mark.parametrize("t", [16, 23])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("bias_grad", [False, True], ids=["frozen_bias", "bias_grad"])
@pytest.mark.parametrize("dtype", [BF, torch.float32], ids=["bf16", "f32"])
def test_plain_equals_the_composition(t, train, bias_grad, dtype):
    """The op on CPU tensors (bf16), and the plain version in f32, against
    the composition: the context and the gradients of qkv, the gate and
    the bias, bit for bit, with the masks of one seeded ``DropoutDraws``."""
    heads, hd, seed = 4, 8, 3 + t
    outs = []
    for fn in ("composition", "op"):
        qkv, gate, bias, leaf = _inputs(3, heads, t, hd, seed, dtype)
        leaf.requires_grad_(bias_grad)
        draws = DropoutDraws(torch.Generator().manual_seed(seed)) if train else None
        if fn == "composition":
            ctx = _composition(qkv, gate, bias, heads, draws, train, dtype)
        else:
            mask = draws.keep((3, heads, t, t), RATE) if train else None
            keep = torch.tensor(1.0 - RATE, dtype=torch.float32).item()
            core = gated_bias_attention if dtype == BF else gated_bias_attention_plain
            ctx = core(qkv, gate, bias, heads, mask, keep)
        leaves = [qkv, gate] + ([leaf] if bias_grad else [])
        outs.append((ctx,) + _grads(ctx, leaves, seed))
    assert outs[0][0].dtype == dtype and outs[0][0].shape == (3, t, heads * hd)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert float(outs[0][1].float().abs().sum()) > 0  # the gradients are not all 0


def _model(dtype, pred="emotion"):
    torch.manual_seed(0)
    return build_backbone("wavlm-large", pred=pred, compute_dtype=dtype, **TINY)


def _forward_backward(model, train, seed=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((4, 1, WIN, HOP), generator=g)
    model.train(train)
    draws = DropoutDraws(torch.Generator().manual_seed(seed)) if train else None
    logits = model(x, dropout=draws)
    grads = torch.autograd.grad(logits.pow(2).sum(), list(model.parameters()))
    return logits.detach(), grads


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_f32_model_unchanged(monkeypatch, train):
    """compute_dtype f32: the logits and every parameter's gradient equal
    those of the model with the old attention core, bit for bit."""
    model = _model(torch.float32)
    got = _forward_backward(model, train)
    monkeypatch.setattr(wavlm_mod.WavLM, "_attention", _old_attention)
    want = _forward_backward(model, train)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_cpu_model_launches_nothing(monkeypatch, train):
    """A bf16 model on the CPU runs the plain version: both counters stay
    at 0, and its logits and gradients are those of the old attention core
    bit for bit."""
    model = _model(BF)
    for attr in ("launches", "launches_bwd"):
        monkeypatch.setattr(gated_bias_attention, attr, 0)
    got = _forward_backward(model, train)
    assert gated_bias_attention.launches == gated_bias_attention.launches_bwd == 0
    monkeypatch.setattr(wavlm_mod.WavLM, "_attention", _old_attention)
    want = _forward_backward(model, train)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_refusals():
    qkv, gate, bias, _ = _inputs(2, 4, 5, 8, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        gated_bias_attention(qkv.float(), gate, bias, 4)
    with pytest.raises(ValueError, match="multiple"):
        gated_bias_attention(qkv, gate, bias, 5)
    with pytest.raises(ValueError, match="gate"):
        gated_bias_attention(qkv, gate[:, :4], bias, 4)
    with pytest.raises(ValueError, match="bias"):
        gated_bias_attention(qkv, gate, bias.double(), 4)
    with pytest.raises(ValueError, match="mask"):
        gated_bias_attention(qkv, gate, bias, 4, torch.ones(2, 4, 5, 5), 0.9)


# ---------------------------------------------------------------------------
# the card

# Kernel against the plain version on the card, each as ||a - b|| / ||b||.
# Both round q k^T, P and the products' outputs to bf16 at the same places;
# they differ in the order of the sums over keys (the softmax's sum and D:
# the kernel's quad of lanes against torch's warp), which moves f32 values
# by units, and a bf16 rounding then flips by a unit where a value lies
# next to a boundary.  On an H100 the gaps read at most 5.0e-5 (ctx), 6.8e-5
# (dqkv), 4.0e-6 (dgate) and 9.0e-6 (dbias) over CARD_SHAPES in both modes;
# the limits leave 10x room.  The plain version with the gate at 1, the bias
# at 0, no dropout or no 1 / keep reads 0.1 or more from itself (CPU, B 8).
CTX_GAP = 5e-4
DQKV_GAP = 7e-4
DGATE_GAP = 5e-5
DBIAS_GAP = 1e-4

# (B, heads, T, hd): the benchmark's shape, T off the tiles and past one
# tile (the general path), head dims under and past 64
CARD_SHAPES = [(32, 16, 99, 64), (4, 4, 1, 64), (4, 4, 17, 64), (2, 4, 130, 64),
               (2, 4, 300, 64), (4, 4, 99, 8), (4, 4, 99, 16), (4, 4, 99, 80), (4, 4, 23, 8),
               (2, 2, 40, 160)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gap(a, b):
    nb = float(b.double().norm())
    d = float((a.double() - b.double()).norm())
    return d / nb if nb else (0.0 if d == 0.0 else float("inf"))


def card_gaps(shape, train, device, seed=11):
    """The kernel's context and gradients against the plain version's on
    ``device``: {name: gap}."""
    b, heads, t, hd = shape
    outs = []
    for fn in (gated_bias_attention, gated_bias_attention_plain):
        qkv, gate, bias, _ = _inputs(b, heads, t, hd, seed, BF, device, permuted_bias=False)
        mask, keep = None, 1.0
        if train:
            draws = DropoutDraws(torch.Generator(device=device).manual_seed(seed))
            mask = draws.keep((b, heads, t, t), RATE)
            keep = torch.tensor(1.0 - RATE, dtype=torch.float32).item()
        ctx = fn(qkv, gate, bias, heads, mask, keep)
        outs.append((ctx,) + _grads(ctx, [qkv, gate, bias], seed))
    return dict(zip(("ctx", "dqkv", "dgate", "dbias"),
                    (_gap(a.float(), b.float()) for a, b in zip(*outs))))


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_card_kernel_follows_the_plain_version(card, shape, train):
    before = (gated_bias_attention.launches, gated_bias_attention.launches_bwd)
    gaps = card_gaps(shape, train, card)
    assert (gated_bias_attention.launches, gated_bias_attention.launches_bwd) == (
        before[0] + 1, before[1] + 1)
    limits = dict(ctx=CTX_GAP, dqkv=DQKV_GAP, dgate=DGATE_GAP, dbias=DBIAS_GAP)
    assert all(gaps[k] <= limits[k] for k in limits), gaps


def _state(device, layers=2, sizes=TINY, win=WIN, seed=5):
    torch.manual_seed(0)
    kw = {**TINY, **sizes, "num_hidden_layers": layers}
    model = CloakedModelGRL(
        *(build_backbone("wavlm-large", pred=p, compute_dtype=BF, **kw)
          for p in ("emotion", "gender")), win_len=win, n_feats=HOP)
    exp = preset("cloak_grl", batch_size=4)
    opt = make_cloak_optimizer(exp, 8, model, ("noise", "gender_backbone"))
    return init_state(model, opt, seed, device)


def _batches(device, n, b, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"spec": torch.randn((n * b, 1, WIN, HOP), generator=g).to(device),
            "labels_emo": torch.randint(0, 4, (n * b,), generator=g).to(device),
            "labels_gen": torch.randint(0, 2, (n * b,), generator=g).to(device),
            "weight": torch.ones(n * b, device=device)}


@pytest.mark.card
def test_card_replayed_steps_follow_the_eager_steps(card):
    """Four GRL steps of the bf16 runner (eager, captured, two replays)
    against the eager step closure from the same state: each step's loss
    and the gender backbone's parameters after them, within the step-graph
    tests' loss gap and bit for bit where nothing differs between the two."""
    n, b = 4, 4
    data = _batches(card, n, b)
    graphed, eager = _state(card), _state(card)
    runner = make_cloak_epoch_runner(0.1, 0.1, grl=True)
    got = runner(graphed, data["spec"][:, 0], data["labels_emo"], data["labels_gen"],
                 data["weight"], torch.arange(n * b, device=card), None, n_batches=n,
                 batch_size=b)[1]
    assert (runner.eager_steps, runner.graph_captures, runner.graph_replays) == (1, 1, 2)
    step = make_cloak_grl_step(0.1, 0.1)
    want = torch.stack([step(eager, {k: v[i * b:(i + 1) * b] for k, v in data.items()})[1]["loss"]
                        for i in range(n)])
    torch.cuda.synchronize()
    assert float(((got - want).abs() / want.abs()).max()) <= 2.5e-6, (got, want)
    pg, pe = dict(graphed.model.named_parameters()), dict(eager.model.named_parameters())
    for k, v in pe.items():
        assert torch.allclose(pg[k], v, rtol=1e-5, atol=1e-6), k


@pytest.mark.card
def test_card_counters_of_one_published_grl_step(card):
    """One GRL step at the published 24 layers (hidden 1024, 16 heads, 99
    frames) launches the forward kernel once a layer in each backbone and
    the backward kernel once a layer in each: 48 and 48."""
    sizes = dict(hidden_size=1024, num_attention_heads=16, intermediate_size=4096)
    win = 200
    state = _state(card, layers=24, sizes=sizes, win=win)
    g = torch.Generator().manual_seed(2)
    batch = {"spec": torch.randn((2, 1, win, HOP), generator=g).to(card),
             "labels_emo": torch.tensor([0, 1], device=card),
             "labels_gen": torch.tensor([0, 1], device=card),
             "weight": torch.ones(2, device=card)}
    gated_bias_attention.launches = gated_bias_attention.launches_bwd = 0
    make_cloak_grl_step(0.1, 0.1)(state, batch)
    torch.cuda.synchronize()
    assert (gated_bias_attention.launches, gated_bias_attention.launches_bwd) == (48, 48)


# ---------------------------------------------------------------------------
# plain self-attention (Whisper): the composition on the CPU, the streaming
# path on the card


def _self_reference(qkv, heads):
    """softmax(q k^T / sqrt(hd)) v in float64 from qkv's values."""
    b, t, width = qkv.shape
    q, k, v = qkv.double().view(b, t, 3, heads, -1).permute(2, 0, 3, 1, 4)
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), -1)
    return (p @ v).transpose(1, 2).reshape(b, t, width // 3)


def _self_qkv(b, t, heads, hd, seed, dtype, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, t, 3 * heads * hd, generator=g).to(dtype).to(device).requires_grad_()


@pytest.mark.parametrize("t", [40, 300])
@pytest.mark.parametrize("dtype", [BF, torch.float32], ids=["bf16", "f32"])
def test_self_attention_plain_follows_the_softmax(t, dtype):
    """On the CPU the op is the composition: in f32 a few float32 units
    from the float64 softmax of the same values, output and gradient; in
    bf16 the scores and P rounded to bf16 and the context stored in bf16, a
    few bf16 units (2^-8) of the unit-scale context."""
    from sept_tpu_torch.ops.attention import self_attention, self_attention_plain

    qkv = _self_qkv(2, t, 4, 16, 3, dtype)
    out = self_attention(qkv, 4)
    assert out.dtype == dtype and out.shape == (2, t, 64)
    assert torch.equal(out, self_attention_plain(qkv, 4))
    ref_qkv = qkv.detach().double().requires_grad_()
    ref = _self_reference(ref_qkv, 4)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((out.detach().double() - ref).abs().max()) <= tol
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    (g,) = torch.autograd.grad(out, qkv, dout.to(dtype))
    (g_ref,) = torch.autograd.grad(ref, ref_qkv, dout.double())
    assert _gap(g, g_ref) <= (1e-5 if dtype == torch.float32 else 2e-2)


def test_self_attention_refusals():
    from sept_tpu_torch.ops.attention import self_attention

    with pytest.raises(ValueError, match="heads"):
        self_attention(torch.zeros(1, 4, 3 * 10), 4)
    with pytest.raises(ValueError, match="3 hidden"):
        self_attention(torch.zeros(4, 30), 2)


# (B, T, heads, hd): the benchmark's shape, and T on, one past and over the
# 128-key tile, at the cell's 64-wide heads
SELF_SHAPES = [(8, 1500, 20, 64), (4, 99, 4, 64), (4, 129, 4, 64), (2, 1500, 4, 64)]
# the streaming path's output and gradients against the composition's in
# f32 from the same bf16 values: P and the context rounded to bf16 on the
# path, nothing rounded in the composition: a bf16 unit of the norm, 2x room
SELF_GAP = 8e-3


@pytest.mark.card
@pytest.mark.parametrize("shape", SELF_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_card_self_attention_streams(card, shape):
    """The bf16 op on the card against the f32 composition of the same
    values: the context and dq, dk, dv within SELF_GAP of the norm, one
    launch each way, and no (B, heads, T, T) tensor: the peak memory over
    the inputs stays under a quarter of one bf16 score matrix's bytes."""
    from sept_tpu_torch.ops.attention import self_attention, self_attention_plain

    b, t, heads, hd = shape
    qkv = _self_qkv(b, t, heads, hd, 7, BF, card)
    dout = torch.randn((b, t, heads * hd), generator=torch.Generator().manual_seed(8)).to(
        card).to(BF)
    ref_qkv = qkv.detach().float().requires_grad_()
    ref = self_attention_plain(ref_qkv, heads)
    (g_ref,) = torch.autograd.grad(ref, ref_qkv, dout.float())
    torch.cuda.synchronize()
    before = (self_attention.launches, self_attention.launches_bwd)
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    out = self_attention(qkv, heads)
    (g,) = torch.autograd.grad(out, qkv, dout)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - base
    assert (self_attention.launches, self_attention.launches_bwd) == (before[0] + 1,
                                                                     before[1] + 1)
    assert out.dtype == BF and g.shape == qkv.shape
    assert _gap(out.float(), ref) <= SELF_GAP
    for i, name in enumerate(("dq", "dk", "dv")):
        part = slice(i * heads * hd, (i + 1) * heads * hd)
        assert _gap(g[..., part].float(), g_ref[..., part]) <= SELF_GAP, name
    assert peak < 0.25 * 2 * b * heads * t * t + 16 * b * t * heads * hd, peak


@pytest.mark.card
def test_card_self_attention_counts_under_replay(card):
    """Four bf16 GRL steps of a 2-layer Whisper through the epoch runner
    (one eager step, a capture, replays): each step counts 4 forward and 4
    backward calls (2 layers, 2 backbones), the replays as the eager
    step."""
    from sept_tpu_torch.ops.attention import self_attention

    sizes = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128,
                 num_mel_bins=16, max_source_positions=40, classifier_proj_size=16)
    torch.manual_seed(0)
    model = CloakedModelGRL(*(build_backbone("whisper-large-v3", pred=p, compute_dtype=BF,
                                             **sizes) for p in ("emotion", "gender")),
                            win_len=80, n_feats=16)
    exp = preset("cloak_grl", batch_size=2)
    state = init_state(model, make_cloak_optimizer(exp, 4, model, ("noise", "gender_backbone")),
                       3, card)
    g = torch.Generator().manual_seed(1)
    n, b = 4, 2
    x = torch.randn((n * b, 80, 16), generator=g).to(card)
    runner = make_cloak_epoch_runner(0.1, 0.1, grl=True)
    self_attention.launches = self_attention.launches_bwd = 0
    runner(state, x, torch.arange(n * b, device=card) % 4, torch.arange(n * b, device=card) % 2,
           torch.ones(n * b, device=card), torch.arange(n * b, device=card), None, n_batches=n,
           batch_size=b)
    torch.cuda.synchronize()
    assert runner.graph_replays == 2
    assert (self_attention.launches, self_attention.launches_bwd) == (16, 16)
