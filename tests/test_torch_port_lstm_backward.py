"""The LSTM recurrence's backward: the plain version against the JAX
package's scan VJP and torch's autograd, the CPU routing of
``LSTMRecurrence``, the backward kernel's geometry and weight layout, and
the TF32 split its products use.

Tolerances, relative L2 over each gradient:

- against ``jax.vjp`` of ``lstm_cell_scan`` (float32, HIGHEST), per
  direction: 1e-5, float32 recurrences of up to 40 steps summed in
  another order;
- against torch's autograd of ``lstm_bidirectional_recurrence_plain``
  at "highest": 1e-5 in float32, 1e-12 in float64 (the same arithmetic,
  ordered otherwise).

The kernel itself runs only on a card: the test marked ``cuda`` holds it
to the plain version there and skips here.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pyannote_audio_tpu.ops.lstm import lstm_cell_scan
from pyannote_audio_tpu.ops.lstm import multilayer_lstm as jax_multilayer
from pyannote_audio_tpu_torch.models.blocks.rnn import LSTM
from pyannote_audio_tpu_torch.ops import lstm_kernel
from pyannote_audio_tpu_torch.ops.lstm import (
    lstm_bidirectional_recurrence_backward_plain,
    lstm_bidirectional_recurrence_plain, split_tf32)
from test_torch_port_models import one_torch_thread  # noqa: F401

SHAPES = [(13, 3, 8, 2), (40, 5, 16, 2), (1, 2, 3, 2), (17, 4, 3, 1),
          (9, 1, 16, 1), (25, 5, 8, 1)]


def _inputs(T, B, H, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T, B, D * 4 * H)).astype(dtype)
    w_hh = (rng.uniform(-1, 1, (D, 4 * H, H)) / np.sqrt(H)).astype(dtype)
    grad = rng.standard_normal((T, B, D * H)).astype(dtype)
    return xw, w_hh, grad


def _rel(ours, theirs) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs,
                                                           np.float64)
    return float(np.linalg.norm(ours - theirs)
                 / max(np.linalg.norm(theirs), 1e-30))


@pytest.mark.parametrize("T,B,H,D", SHAPES)
def test_plain_backward_matches_jax_scan_vjp(T, B, H, D):
    xw, w_hh, grad = _inputs(T, B, H, D, seed=T * H + D)
    gx, gw = lstm_bidirectional_recurrence_backward_plain(
        torch.from_numpy(xw), torch.from_numpy(w_hh), torch.from_numpy(grad))
    H4 = 4 * H
    for d in range(D):
        _, vjp = jax.vjp(lambda a, w: lstm_cell_scan(a, w, reverse=d == 1),
                         jnp.asarray(xw[..., d * H4:(d + 1) * H4]),
                         jnp.asarray(w_hh[d]))
        jx, jw = vjp(jnp.asarray(grad[..., d * H:(d + 1) * H]))
        assert _rel(gx[..., d * H4:(d + 1) * H4].numpy(), jx) <= 1e-5
        assert _rel(gw[d].numpy(), jw) <= 1e-5


@pytest.mark.parametrize("dtype,limit", [(np.float32, 1e-5),
                                         (np.float64, 1e-12)])
@pytest.mark.parametrize("T,B,H,D", SHAPES)
def test_plain_backward_matches_autograd(T, B, H, D, dtype, limit):
    xw, w_hh, grad = (torch.from_numpy(a) for a in
                      _inputs(T, B, H, D, seed=T + B + H, dtype=dtype))
    a = xw.clone().requires_grad_()
    w = w_hh.clone().requires_grad_()
    lstm_bidirectional_recurrence_plain(a, w, "highest").backward(grad)
    gx, gw = lstm_bidirectional_recurrence_backward_plain(xw, w_hh, grad)
    assert gx.dtype == gw.dtype == xw.dtype
    assert _rel(gx, a.grad) <= limit
    assert _rel(gw, w.grad) <= limit


def test_function_backward_on_the_cpu_is_the_plain_backward():
    """On the CPU LSTMRecurrence's backward is the plain backward, equal
    to it bit for bit; the backward kernel's count stays 0."""
    xw, w_hh, grad = (torch.from_numpy(a) for a in _inputs(11, 3, 8, 2, 5))
    routed = []
    original = lstm_kernel.lstm_recurrence_backward

    def counted(*args):
        routed.append(1)
        return original(*args)

    before = lstm_kernel.lstm_recurrence_backward.launches
    lstm_kernel.lstm_recurrence_backward = counted
    try:
        a = xw.clone().requires_grad_()
        w = w_hh.clone().requires_grad_()
        lstm_kernel.LSTMRecurrence.apply(a, w, "default").backward(grad)
    finally:
        lstm_kernel.lstm_recurrence_backward = original
    gx, gw = lstm_bidirectional_recurrence_backward_plain(xw, w_hh, grad)
    assert routed == [1]
    assert torch.equal(a.grad, gx) and torch.equal(w.grad, gw)
    assert lstm_kernel.lstm_recurrence_backward.launches == before == 0
    # needs_input_grad: a gradient only where it is wanted
    a = xw.clone().requires_grad_()
    lstm_kernel.LSTMRecurrence.apply(a, w_hh, "highest").backward(grad)
    assert torch.equal(a.grad, gx)


def _expected_fragments(w_hh: np.ndarray, geometry: dict) -> np.ndarray:
    """The backward kernel's A fragments, from the definition: phase 0
    multiplies by A (gate row q * units + ul of CTA c = W_hh row q * H +
    c * units + ul), phase 1 by A's transpose; warp kp * tiles + mt holds
    tile row mt, k-steps kp * frags + i; lane 4g + t holds (A[g, t],
    A[g + 8, t], A[g, t + 4], A[g + 8, t + 4]) of each 16 x 8 tile."""
    D, _, H = w_hh.shape
    C, units = geometry["cluster"], geometry["units"]
    warps, frags = geometry["warps"], geometry["frags"]
    warp, i, lane, e = np.meshgrid(np.arange(warps), np.arange(frags),
                                   np.arange(32), np.arange(4),
                                   indexing="ij")
    g, t = lane // 4, lane % 4
    out = np.zeros((D, C, 2, warps, frags, 32, 4), np.float32)
    for phase, rows in ((0, 4 * units), (1, C * units)):
        tiles = rows // 16
        row = 16 * (warp % tiles) + g + 8 * (e % 2)
        col = 8 * ((warp // tiles) * frags + i) + t + 4 * (e // 2)
        gate_row, k = (row, col) if phase == 0 else (col, row)
        q, ul = gate_row // units, gate_row % units
        for d in range(D):
            for c in range(C):
                u = c * units + ul
                inside = (u < H) & (k < H)
                out[d, c, phase] = np.where(
                    inside, w_hh[d, q * H + np.minimum(u, H - 1),
                                 np.minimum(k, H - 1)], 0.0)
    return out


@pytest.mark.parametrize("H", [1, 3, 8, 16, 17, 60, 96, 128, 200, 256])
def test_backward_weights_layout(H):
    """Each warp's fragments hold the W_hh values the kernel multiplies,
    column for column, zero-padded; the geometry fits the kernel's
    limits."""
    geometry = lstm_kernel.backward_geometry(H)
    C, Hp, units = (geometry[k] for k in ("cluster", "padded", "units"))
    assert units in (16, 32) and Hp == C * units and H <= Hp
    assert C in (1, 2, 4, 8) and (C == 1 or Hp // 2 < H or units == 32)
    assert geometry["frags"] == Hp // 16
    assert geometry["shared_bytes"] <= lstm_kernel.SHARED_BYTES
    w_hh = torch.randn(2, 4 * H, H, generator=torch.Generator()
                       .manual_seed(H))
    packed = lstm_kernel.pack_backward_weights(w_hh, geometry)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.shape == (2, C, 2, geometry["warps"], geometry["frags"],
                            32, 4)
    assert np.array_equal(packed.numpy(),
                          _expected_fragments(w_hh.numpy(), geometry))
    # every value of W_hh lands in each phase's fragments exactly once
    for phase in range(2):
        values = packed[:, :, phase]
        assert int((values != 0).sum()) == int((w_hh != 0).sum())
        assert torch.allclose(values.sum(), w_hh.sum(), atol=1e-3)


@pytest.mark.parametrize("H,D", [(257, 2), (300, 2), (384, 2), (512, 2),
                                 (1024, 1)])
def test_streamed_backward_geometry_and_layout(H, D):
    """Above H = 256 the backward kernel streams W_hh's fragments from
    device memory: a cluster of 8 CTAs of padded / 8 units (H padded to a
    multiple of 128), 8 rows, 16 warps taking the packing's units / 2
    warps in turn, no A in registers or shared memory; the packing is the
    on-chip route's, held against the fragment definition."""
    geometry = lstm_kernel.backward_geometry(H, 32, D)
    C, Hp, units = (geometry[k] for k in ("cluster", "padded", "units"))
    assert geometry["stream"] and (C, geometry["rows"]) == (8, 8)
    assert Hp == -(-H // 128) * 128 and units == Hp // 8
    assert (geometry["warps"], geometry["threads"]) == (units // 2, 512)
    assert geometry["frags"] == Hp // 16 and geometry["a_registers"] == 0
    assert geometry["shared_bytes"] <= lstm_kernel.SHARED_BYTES
    w_hh = torch.randn(D, 4 * H, H, generator=torch.Generator()
                       .manual_seed(H))
    packed = lstm_kernel.pack_backward_weights(w_hh, geometry)
    assert packed.shape == (D, C, 2, units // 2, Hp // 16, 32, 4)
    assert np.array_equal(packed.numpy(),
                          _expected_fragments(w_hh.numpy(), geometry))


def test_wide_bilstm_gradient_matches_jax():
    """A 2-layer BiLSTM at H = 384 (the JAX module's Pallas route, the
    card's streamed one): the port module's gradients of the input and of
    every parameter, through ``LSTMRecurrence``'s plain backward on the
    CPU, against ``jax.vjp`` of the JAX module's float32 scan, which is
    what its Pallas route's ``custom_vjp`` rules take; relative L2 1e-5.
    Forward: 1e-5 absolute."""
    rng = np.random.default_rng(384)
    x = rng.standard_normal((2, 6, 24)).astype(np.float32)
    module = LSTM(24, hidden_size=384, num_layers=2,
                  generator=torch.Generator().manual_seed(385))
    upstream = rng.standard_normal((2, 6, 768)).astype(np.float32)
    names = {}
    layers = []
    for i in range(2):
        layer = {}
        for ours_name, theirs in (("w_ih", "weight_ih"),
                                  ("w_hh", "weight_hh"),
                                  ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            for sfx, jsfx in (("", ""), ("_reverse", "_r")):
                name = f"{theirs}_l{i}{sfx}"
                layer[ours_name + jsfx] = jnp.asarray(
                    getattr(module, name).detach().numpy())
                names[name] = (i, ours_name + jsfx)
        layers.append(layer)
    out, vjp = jax.vjp(jax_multilayer, jnp.asarray(x), layers)
    grad_x, grad_layers = vjp(jnp.asarray(upstream))
    xt = torch.from_numpy(x).requires_grad_()
    ours = module(xt)
    ours.backward(torch.from_numpy(upstream))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(out),
                               atol=1e-5)
    assert _rel(xt.grad, grad_x) < 1e-5
    for name, (i, key) in names.items():
        assert _rel(getattr(module, name).grad,
                    grad_layers[i][key]) < 1e-5, name


def test_backward_geometry_refuses_what_does_not_fit():
    """Every H from 1 to 2048 has a route (on chip up to 256, streamed
    above) within the card's budgets; the one refusal left is an H whose
    phase buffers exceed a CTA's shared memory, above 2048."""
    with pytest.raises(ValueError, match="2048"):
        lstm_kernel.backward_geometry(2049)
    for H in range(1, 2049):
        geometry = lstm_kernel.backward_geometry(H, 3264)
        assert geometry["stream"] == (H > lstm_kernel.MAX_HIDDEN)
        # 64 KB of registers per SM: A's registers (64 at most) leave the
        # rest of a thread's budget of one CTA per SM (255, or 128 at 512
        # threads) to the accumulators and the prefetched cells
        assert geometry["a_registers"] <= 64
        assert geometry["threads"] * min(255, 65536 // geometry["threads"]) \
            <= 65536
        assert geometry["shared_bytes"] <= lstm_kernel.SHARED_BYTES


# (B, rows, CTAs) at H = 128, D = 2: every training path's B ((x) PyanNet
# at 32 and its last batch 7, (H) a DDP rank's 16, the DPRNN's intra /
# inter BiLSTMs of (z) at a batch of 16 and of (w)'s 32 and its tail), and
# B on each side of each step of the rows (8 -> 16 -> 32 -> 64)
ROWS_SHAPES = [(32, 8, 64), (16, 8, 32), (7, 8, 16), (3264, 64, 816),
               (3200, 64, 800), (3162, 64, 800), (3100, 64, 784),
               (1632, 64, 416), (1600, 64, 400), (64, 8, 128),
               (65, 16, 80), (128, 16, 128), (129, 32, 80), (256, 32, 128),
               (257, 64, 80), (512, 64, 128), (513, 64, 144)]


@pytest.mark.parametrize("B,rows,ctas", ROWS_SHAPES)
def test_backward_geometry_rows_follow_the_batch(B, rows, ctas):
    """Rows per cluster follow B: the smallest whose grid of one CTA per
    SM fits the card at once (latency sets the time), else 64 (fewer
    waves); clusters of 8 CTAs of 16 units, A in registers, and the
    budgets fit."""
    geometry = lstm_kernel.backward_geometry(128, B, 2)
    assert (geometry["rows"], geometry["cluster"], geometry["units"]) == \
        (rows, 8, 16)
    assert -(-B // rows) * geometry["cluster"] * 2 == ctas
    fits = [r for r in lstm_kernel.BACKWARD_ROWS
            if 2 * -(-B // r) * 8 <= lstm_kernel.SMS]
    assert rows == (fits[0] if fits else lstm_kernel.BACKWARD_ROWS[-1])
    assert geometry["a_registers"] == 64 and geometry["threads"] == 256
    assert geometry["shared_bytes"] <= lstm_kernel.SHARED_BYTES


@pytest.mark.parametrize("K", [512, 1024])
def test_split_tf32_product_is_float32_accurate(K):
    """hi.hi + hi.lo + lo.hi of the TF32 splits, summed in float32 as the
    tensor cores do, within 1e-6 relative L2 of the float64 product (the
    float32 product is about 3e-7 off; one TF32 pass about 3e-4)."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((64, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, 40)).astype(np.float32))
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    for part in (a_hi, a_lo, b_hi, b_lo):  # TF32: 10 mantissa bits
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(a_hi + a_lo, a) or \
        float(((a_hi.double() + a_lo.double() - a.double()).abs()
               / a.double().abs()).max()) <= 2.0 ** -22
    exact = a.double() @ b.double()
    three = a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)
    assert _rel(three.numpy(), exact.numpy()) <= 1e-6
    assert _rel((a_hi @ b_hi).numpy(), exact.numpy()) > 1e-5


def test_split_tf32_rounds_to_nearest_away():
    """cvt.rna: the 13 dropped bits round half away from zero."""
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10
    x = torch.cat([one * (1 + ulp / 2), one * (1 + ulp / 2 - 2.0 ** -23),
                   one * (1 + ulp)])
    hi, lo = split_tf32(x)
    assert hi.tolist() == [1 + ulp, -(1 + ulp), 1.0, -1.0, 1 + ulp,
                           -(1 + ulp)]
    assert float((hi.double() + lo.double() - x.double()).abs().max()) \
        <= 2.0 ** -22


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,D", [
    (589, 32, 128, 2), (1, 1, 8, 2), (17, 5, 8, 1), (21, 9, 10, 2),
    (33, 20, 256, 2), (100, 3264, 128, 2),
    # the geometry's edges: B on each side of the rows steps, B = 1,
    # T = 1 and 2, H = 8, 17, 100, 200, 256, one direction
    (50, 64, 128, 2), (50, 65, 128, 2), (50, 128, 128, 2),
    (50, 129, 128, 2), (50, 256, 128, 2), (50, 257, 128, 2),
    (1, 1, 128, 2), (2, 3, 128, 2), (40, 1, 17, 2), (40, 6, 100, 2),
    (40, 6, 200, 2), (20, 70, 256, 1), (30, 7, 128, 1)])
def test_backward_kernel_matches_plain_on_card(T, B, H, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    xw, w_hh, grad = (torch.from_numpy(a).cuda()
                      for a in _inputs(T, B, H, D, seed=T + B))
    before = (lstm_kernel.lstm_bidirectional_recurrence.launches,
              lstm_kernel.lstm_recurrence_backward.launches)
    gx, gw = lstm_kernel.lstm_recurrence_backward(xw, w_hh, grad)
    torch.cuda.synchronize()
    rx, rw = lstm_bidirectional_recurrence_backward_plain(xw, w_hh, grad)
    assert (lstm_kernel.lstm_bidirectional_recurrence.launches,
            lstm_kernel.lstm_recurrence_backward.launches) == \
        (before[0], before[1] + 1)
    assert torch.isfinite(gx).all() and torch.isfinite(gw).all()
    assert _rel(gx.cpu(), rx.cpu()) <= 1e-4
    assert _rel(gw.cpu(), rw.cpu()) <= 1e-4
