"""The bf16 GRU-layer op (``ops/gru_lowp.py``, ``csrc/gru_lowp.cu``) held
against the loop it replaces, ``bigru_layer_lowp`` under autograd.

On the CPU the op runs its plain version: the output equals the loop's bit
for bit, the recurrence's cotangent rows (dgi) equal autograd's through the
loop bit for bit, and each parameter and input gradient is within a stated
gap of the loop's, relative to the loop's norm, for the products' summation
order only: the loop rounds ``dx`` and ``dW_ih`` once more (the two
directions' bf16 products are summed in bf16), and ``dW_hh`` and ``db_hh``
step by step (a bf16 sum over the T steps of bf16 products), where the op
takes one product over all steps and rounds once.

The tests marked ``card`` launch the kernels on the H100 at the benchmark's
shapes, above the register path's hidden size (128) and above 1024 (the
tiles in global scratch): the output against the loop on the card, the
gradients against the loop's on the CPU; they decide inside themselves
whether there is a card and skip without one.  On the card: ``python -m
pytest tests/test_torch_gru_lowp.py --noconftest -m card -q``
(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have).
"""

import pytest
import torch

from sept_tpu_torch.device import f32_precision
from sept_tpu_torch.models.backbone import bigru_layer_lowp
from sept_tpu_torch.ops.gru_lowp import (bigru_lowp, bigru_lowp_backward_plain,
                                         bigru_lowp_forward_plain, bigru_steps_lowp)

BF = torch.bfloat16
# the gradients' gaps to the loop's, relative to its norm (CPU readings
# on 5 shapes: at most 3.1e-3 for dx and dW_ih, 8.7e-3 for dW_hh and db_hh)
GAP_ONE_ROUNDING = 1e-2   # dx, dW_ih: one bf16 rounding of the sum more in the loop
GAP_STEP_SUMS = 2e-2      # dW_hh, db_hh: the loop's bf16 sums over the steps


def _weights(f, h, g, pinned=True):
    """One layer's 8 tensors, torch layout; the r and z rows of b_hh 0 where
    ``pinned`` (as the model pins them)."""
    ws = []
    for _ in range(2):
        ws += [torch.randn(3 * h, f, generator=g) * 0.3, torch.randn(3 * h, h, generator=g) * 0.3,
               torch.randn(3 * h, generator=g) * 0.3, torch.randn(3 * h, generator=g) * 0.3]
    if pinned:
        for k in (3, 7):
            ws[k][:2 * h] = 0.0
    return ws


def _gap(a, b):
    """||a - b|| / ||b||; 0 only where a equals b if b is 0."""
    nb = float(b.double().norm())
    d = float((a.double() - b.double()).norm())
    return d / nb if nb else (0.0 if d == 0.0 else float("inf"))


def _case(b, t, f, h, seed, pinned=True, x_dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, f, generator=g).to(x_dtype)
    ws = _weights(f, h, g, pinned)
    dout = torch.randn(b, t, 2 * h, generator=g)
    return x.to(device), [w.to(device) for w in ws], dout.to(device)


def _run(fn, x, ws, dout):
    """(output, gradients of x and the 8 tensors) of ``fn``."""
    xr = x.clone().requires_grad_()
    wr = [w.clone().requires_grad_() for w in ws]
    out = fn(xr, wr, BF)
    out.backward(dout)
    return out.detach(), [xr.grad] + [w.grad for w in wr]


def _both(x, ws, dout):
    """``_run`` of the loop, then of the op."""
    return _run(bigru_layer_lowp, x, ws, dout), _run(bigru_lowp, x, ws, dout)


def _check_grads(got, want):
    names = ["x"] + [f"{k}{sfx}" for sfx in ("", "_reverse")
                     for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        tol = GAP_STEP_SUMS if name.startswith(("weight_hh", "bias_hh")) else GAP_ONE_ROUNDING
        assert _gap(a, b) <= tol, (name, _gap(a, b))


# ---------------------------------------------------------------------------
# CPU: the plain version


@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "b_hh_full"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "no_grad"])
@pytest.mark.parametrize("t", [1, 25])
@pytest.mark.parametrize("h", [8, 64, 136])
def test_plain_op_is_the_loop(h, t, train, pinned):
    x, ws, dout = _case(3, t, 48, h, seed=h + t, pinned=pinned)
    if not train:
        with torch.no_grad():
            got, want = bigru_lowp(x, ws), bigru_layer_lowp(x, ws, BF)
        assert got.grad_fn is None
        assert got.dtype == torch.float32 and torch.equal(got, want)
        return
    (want, g_want), (got, g_got) = _both(x, ws, dout)
    assert torch.equal(got, want)
    _check_grads(g_got, g_want)


@pytest.mark.parametrize("x_dtype", [torch.float32, BF], ids=["x_f32", "x_bf16"])
def test_plain_backward_rows_are_autograds_through_the_loop(x_dtype):
    """The recurrence's cotangent rows: each step's dgi equals what autograd
    gives the loop's input projection, bit for bit."""
    b, t, f, h = 4, 25, 40, 16
    x, ws, dout = _case(b, t, f, h, seed=3, x_dtype=x_dtype)
    w_ih = torch.stack([ws[0], ws[4]]).to(BF)
    b_ih = torch.stack([ws[2], ws[6]]).to(BF)[:, None, None]
    xs = x.to(BF)
    gi = (torch.stack([xs, xs.flip(1)]) @ w_ih.transpose(1, 2)[:, None] + b_ih).detach()
    gi.requires_grad_()
    loop = bigru_steps_lowp(gi, ws, BF)[0]  # the loop's recurrence from gi
    loop.backward(dout)
    want = torch.cat([gi.grad[0], gi.grad[1].flip(1)], -1)  # (B, T, 6H), time order
    out, (_, gates) = bigru_lowp_forward_plain(x, ws, save=True)
    assert torch.equal(out, loop.detach())
    dgi, dgh, hb = bigru_lowp_backward_plain(dout, out, gates, ws)
    assert dgi.dtype == BF and torch.equal(dgi, want)
    # dgh: the r and z columns are dgi's; hb: bf16(h_{t-1}), 0 at each
    # direction's first step
    for d in (0, 1):
        assert torch.equal(dgh[d][..., :2 * h], dgi[..., 3 * h * d:3 * h * d + 2 * h])
    assert torch.equal(hb[0][:, 1:], out[:, :-1, :h].to(BF))
    assert torch.equal(hb[1][:, :-1], out[:, 1:, h:].to(BF))
    assert not hb[0][:, 0].any() and not hb[1][:, -1].any()


@pytest.mark.parametrize("what", ["f32_mode", "weight_shape", "x_not_contiguous",
                                  "weight_dtype", "x_rank", "seven_weights"])
def test_the_op_refuses(what):
    x, ws, _ = _case(2, 5, 24, 8, seed=0)
    dtype = BF
    if what == "f32_mode":
        dtype = torch.float32
    elif what == "weight_shape":
        ws[5] = ws[5][:, :-1].contiguous()
    elif what == "x_not_contiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif what == "weight_dtype":
        ws[2] = ws[2].double()
    elif what == "x_rank":
        x = x[0]
    else:
        ws = ws[:7]
    with pytest.raises(ValueError):
        bigru_lowp(x, ws, dtype)


def test_the_cpu_path_launches_nothing():
    x, ws, dout = _case(2, 6, 24, 8, seed=1)
    before = (bigru_lowp.launches, bigru_lowp.launches_bwd)
    xr = x.clone().requires_grad_()
    bigru_lowp(xr, ws).backward(dout)
    with torch.no_grad():
        bigru_lowp(x, ws)
    assert (bigru_lowp.launches, bigru_lowp.launches_bwd) == before
    assert xr.grad is not None


def test_only_the_gradients_asked_for():
    """A frozen layer (the cloak's emotion backbone) gets dx alone; data
    input (a baseline step's first layer) gets the weights' alone."""
    x, ws, dout = _case(2, 6, 24, 8, seed=2)
    xr = x.clone().requires_grad_()
    bigru_lowp(xr, ws).backward(dout)
    assert xr.grad is not None and xr.grad.dtype == torch.float32
    wr = [w.clone().requires_grad_() for w in ws]
    bigru_lowp(x, wr).backward(dout)
    assert all(w.grad is not None for w in wr)


# ---------------------------------------------------------------------------
# the card: the kernels against the loop


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    f32_precision()  # as the training steps set it: cuBLAS's bf16 products sum in f32
    return torch.device("cuda")


# (B, T, F, H): the benchmark's two layers, a ragged batch and odd sizes,
# hidden sizes above the register path (128), the largest with the tiles in
# shared memory (1024) and one above it (the tiles in global scratch)
CARD_SHAPES = [(32, 25, 2048, 64), (32, 25, 128, 64), (19, 9, 40, 12), (5, 25, 64, 128),
               (17, 25, 96, 136), (3, 4, 33, 257), (2, 3, 24, 1024), (3, 3, 33, 1100)]


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_card_kernels_against_the_loop(card, shape):
    """The kernels' output against the loop on the card (the same roundings;
    the products summed in the same order: equal at every shape read), and
    every gradient against autograd through the loop on the CPU, within the
    CPU test's gaps: the loop's own autograd on the card sums its bf16
    products in cuBLAS's order and lands up to 1.5% from itself on the CPU
    (the chain of bf16 roundings spreads each unit a sum moves), the
    kernels' gradients 0.2-0.7% (H100 readings).  One forward and one
    backward launch a layer."""
    b, t, f, h = shape
    x, ws, dout = _case(b, t, f, h, seed=b + h, x_dtype=BF if f == 2048 else torch.float32,
                        device=card)
    before = (bigru_lowp.launches, bigru_lowp.launches_bwd)
    (want, _), (got, g_got) = _both(x, ws, dout)
    torch.cuda.synchronize()
    assert (bigru_lowp.launches, bigru_lowp.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _gap(got, want) <= 1e-3, _gap(got, want)
    _, g_cpu = _run(bigru_layer_lowp, x.cpu(), [w.cpu() for w in ws], dout.cpu())
    _check_grads([g.cpu() for g in g_got], g_cpu)
    with torch.no_grad():
        assert torch.equal(bigru_lowp(x, ws), got)


@pytest.mark.card
def test_card_kernels_equal_the_plain_recurrence_on_their_own_rows(card):
    """The backward kernel's rows against the plain backward on the CPU,
    from the same saved output and gates: the kernel keeps the CPU's
    roundings, so each direction's first step (before any ``dgh @ W_hh``
    product) and bf16(h_{t-1}) are equal, and the rest is within what the
    products' sum order moves through the chain of bf16 roundings (8e-7 to
    1.4e-3 of the norm at H 12-1100 on an H100, over 1e-4 on this test's
    seed).  Torch's elementwise
    kernels on the card round otherwise: the plain backward there reads
    3e-3 to 1.1e-2 from the kernel, already at the first step."""
    from sept_tpu_torch.ops import gru_lowp

    x, ws, dout = _case(32, 25, 128, 64, seed=5, device=card)
    out, (_, _, gates) = gru_lowp._forward_kernel(x, ws, save=True)
    rows = [r.cpu() for r in gru_lowp._backward_kernel(dout, out, gates, ws)]
    plain = bigru_lowp_backward_plain(dout.cpu(), out.cpu(),
                                      gru_lowp._gates_in_step_order(gates).cpu(),
                                      [w.cpu() for w in ws])
    h = ws[1].shape[1]
    # each direction's first step: the forward one's last time, the reverse one's first
    assert torch.equal(rows[0][:, -1, :3 * h], plain[0][:, -1, :3 * h])
    assert torch.equal(rows[0][:, 0, 3 * h:], plain[0][:, 0, 3 * h:])
    assert torch.equal(rows[1][0][:, -1], plain[1][0][:, -1])
    assert torch.equal(rows[1][1][:, 0], plain[1][1][:, 0])
    for name, a, b in zip(("dgi", "dgh"), rows, plain):
        assert _gap(a.float(), b.float()) <= 1e-2, (name, _gap(a.float(), b.float()))
    assert torch.equal(rows[2], plain[2])
    plain_out, _ = bigru_lowp_forward_plain(x, ws, save=False)
    assert _gap(out, plain_out) <= 1e-3
