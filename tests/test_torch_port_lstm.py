"""The port's LSTM recurrence (plain version, module, kernel wrapper)
against the JAX package and torch.nn.LSTM.

All comparisons are float32 at atol 1e-5: the same recurrence with
sums taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_audio_tpu.ops.lstm import lstm_cell_scan
from pyannote_audio_tpu.ops.lstm import multilayer_lstm as jax_multilayer
from pyannote_audio_tpu.ops.pallas_lstm import pallas_lstm_cell
from pyannote_audio_tpu_torch.models.blocks.rnn import LSTM
from pyannote_audio_tpu_torch.ops import lstm_kernel
from pyannote_audio_tpu_torch.ops.lstm import (
    lstm_bidirectional_recurrence_plain, lstm_recurrence, multilayer_lstm)

ATOL = 1e-5


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (4 * H, H)) / np.sqrt(H)).astype(np.float32)
    return xw, w_hh


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(23, 4, 16), (1, 3, 8), (9, 1, 12)])
def test_recurrence_matches_jax_scan(T, B, H, reverse):
    xw, w_hh = _inputs(T, B, H, seed=T + H)
    expected = np.asarray(lstm_cell_scan(jnp.asarray(xw), jnp.asarray(w_hh),
                                         reverse=reverse))
    ours = lstm_recurrence(torch.from_numpy(xw), torch.from_numpy(w_hh),
                           reverse=reverse).numpy()
    np.testing.assert_allclose(ours, expected, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_matches_pallas_interpret(reverse, monkeypatch):
    # the TPU kernel's own arithmetic, run the way tests/test_pallas_lstm.py
    # runs it on the CPU; f32 matmuls as in the scan
    monkeypatch.setenv("PYANNOTE_TPU_LSTM_PRECISION", "highest")
    xw, w_hh = _inputs(12, 8, 8, seed=3)
    expected = np.asarray(pallas_lstm_cell(
        jnp.asarray(xw), jnp.asarray(w_hh), reverse=reverse, interpret=True))
    ours = lstm_recurrence(torch.from_numpy(xw), torch.from_numpy(w_hh),
                           reverse=reverse).numpy()
    np.testing.assert_allclose(ours, expected, atol=ATOL)


@pytest.mark.parametrize("T,H,bidirectional", [
    (17, 16, True),      # forward + reverse directions
    (1, 16, True),       # a single step
    (13, 6, True),       # H not a multiple of 8
    (11, 10, False),     # forward only
])
def test_multilayer_matches_torch_lstm(T, H, bidirectional):
    torch.manual_seed(T + H)
    ref = torch.nn.LSTM(5, H, num_layers=2, batch_first=True,
                        bidirectional=bidirectional)
    x = torch.randn(3, T, 5)
    with torch.no_grad():
        expected, _ = ref(x)
        module = LSTM(5, hidden_size=H, num_layers=2,
                      bidirectional=bidirectional)
        module.load_state_dict(ref.state_dict())
        ours = module(x)
        layers = []
        for i in range(2):
            layer = {}
            for ours_name, theirs in (("w_ih", "weight_ih"),
                                      ("w_hh", "weight_hh"),
                                      ("b_ih", "bias_ih"),
                                      ("b_hh", "bias_hh")):
                layer[ours_name] = getattr(ref, f"{theirs}_l{i}")
                if bidirectional:
                    layer[ours_name + "_r"] = getattr(
                        ref, f"{theirs}_l{i}_reverse")
            layers.append(layer)
        functional = multilayer_lstm(x, layers, bidirectional=bidirectional)
    np.testing.assert_allclose(ours.numpy(), expected.numpy(), atol=ATOL)
    np.testing.assert_allclose(functional.numpy(), expected.numpy(),
                               atol=ATOL)


def test_module_matches_jax_multilayer_lstm():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 21, 9)).astype(np.float32)
    module = LSTM(9, hidden_size=16, num_layers=2,
                  generator=torch.Generator().manual_seed(0))
    layers = []
    for i in range(2):
        layer = {}
        for ours_name, theirs in (("w_ih", "weight_ih"),
                                  ("w_hh", "weight_hh"),
                                  ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            for sfx, jsfx in (("", ""), ("_reverse", "_r")):
                layer[ours_name + jsfx] = jnp.asarray(
                    getattr(module, f"{theirs}_l{i}{sfx}").detach().numpy())
        layers.append(layer)
    expected = np.asarray(jax_multilayer(jnp.asarray(x), layers))
    with torch.no_grad():
        ours = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, expected, atol=ATOL)


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(11)
    xw = torch.from_numpy(rng.standard_normal((7, 3, 2 * 4 * 6))
                          .astype(np.float32))
    w_hh = torch.from_numpy((rng.uniform(-1, 1, (2, 24, 6)) / 3)
                            .astype(np.float32))
    before = lstm_kernel.lstm_bidirectional_recurrence.launches
    ours = lstm_kernel.lstm_bidirectional_recurrence(xw, w_hh)
    # a CPU call is not a kernel launch
    assert lstm_kernel.lstm_bidirectional_recurrence.launches == before
    expected = torch.cat([lstm_recurrence(xw[..., :24], w_hh[0]),
                          lstm_recurrence(xw[..., 24:], w_hh[1],
                                          reverse=True)], dim=-1)
    assert torch.equal(ours, expected)
    assert torch.equal(lstm_bidirectional_recurrence_plain(xw, w_hh),
                       expected)


def test_wrapper_refuses_mixed_devices():
    xw = torch.zeros(2, 1, 32)
    w_hh = torch.zeros(1, 32, 8, device="meta")
    with pytest.raises(ValueError):
        lstm_kernel.lstm_bidirectional_recurrence(xw, w_hh)


# kernel vs plain version in the same precision on the card (chip_smoke.py's
# bounds): float32 sums in another order; in "default" an h that rounds one
# bf16 step apart (damped by the recurrence) as well
CARD_ATOL = {"default": 1e-3, "high": 1e-5, "highest": 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("T,B,H,D", [(589, 256, 128, 2), (1, 1, 8, 2),
                                     (7, 3, 96, 2), (5, 2, 256, 1),
                                     (6, 9, 10, 2)])
def test_kernel_matches_plain_on_card(T, B, H, D, precision):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(T + B)
    xw = torch.randn(T, B, D * 4 * H, generator=g).cuda()
    w_hh = ((torch.rand(D, 4 * H, H, generator=g) * 2 - 1)
            / H ** 0.5).cuda()
    before = lstm_kernel.lstm_bidirectional_recurrence.launches
    ours = lstm_kernel.lstm_bidirectional_recurrence(xw, w_hh, precision)
    expected = lstm_bidirectional_recurrence_plain(xw, w_hh, precision)
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_bidirectional_recurrence.launches == before + 1
    assert (ours - expected).abs().max().item() < CARD_ATOL[precision]


@pytest.mark.cuda
def test_kernel_refuses_what_does_not_fit_on_chip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    xw = torch.zeros(2, 1, 4 * 300, device="cuda")
    w_hh = torch.zeros(1, 4 * 300, 300, device="cuda")
    before = lstm_kernel.lstm_bidirectional_recurrence.launches
    with pytest.raises(ValueError, match="256"):
        lstm_kernel.lstm_bidirectional_recurrence(xw, w_hh, "default")
    assert lstm_kernel.lstm_bidirectional_recurrence.launches == before
