"""The LSTM recurrence's backward: the plain version against the JAX
package's scan VJP and torch's autograd, the CPU routing of
``LSTMRecurrence``, and the backward kernel's weight layout.

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
from pyannote_audio_tpu_torch.ops import lstm_kernel
from pyannote_audio_tpu_torch.ops.lstm import (
    lstm_bidirectional_recurrence_backward_plain,
    lstm_bidirectional_recurrence_plain)
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


@pytest.mark.parametrize("H", [1, 3, 8, 16, 17, 60, 96, 128, 200, 256])
def test_backward_weights_layout(H):
    """Each CTA's block holds the W_hh columns of its own units, gate row
    by gate row, zero-padded; the geometry fits the kernel's limits."""
    geometry = lstm_kernel.backward_geometry(H)
    C, Hp = geometry["cluster"], geometry["padded"]
    assert Hp % (16 * C) == 0 and H <= Hp < H + 16 * C
    assert Hp // C <= lstm_kernel.MAX_UNITS
    assert geometry["shared_bytes"] <= lstm_kernel.SHARED_BYTES
    w_hh = torch.randn(2, 4 * H, H, generator=torch.Generator()
                       .manual_seed(H))
    packed, cluster = lstm_kernel.pack_backward_weights(w_hh)
    assert cluster == C and packed.shape == (2, C, 4 * Hp, Hp // C)
    padded = F.pad(w_hh.reshape(2, 4, H, H), (0, Hp - H, 0, Hp - H)) \
        .reshape(2, 4 * Hp, Hp)
    for c in range(C):
        assert torch.equal(packed[:, c],
                           padded[:, :, c * Hp // C:(c + 1) * Hp // C])


def test_backward_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="256"):
        lstm_kernel.backward_geometry(257)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,D", [(589, 32, 128, 2), (1, 1, 8, 2),
                                     (17, 5, 8, 1), (21, 9, 10, 2),
                                     (33, 20, 256, 2), (100, 3264, 128, 2)])
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
