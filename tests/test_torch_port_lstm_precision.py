"""The port's LSTM precision gate and the kernel's weight layout, on the CPU.

PYANNOTE_TPU_LSTM_PRECISION picks the precision of the recurrent product
h @ W_hh^T, as in the JAX package (ops/pallas_lstm.py `_kernel_precision`):
"default" rounds h and W_hh to bf16 and sums the products in float32,
"high" is bf16_3x, "highest" float32. Tolerances:

- plain version vs the same algorithm written in JAX: atol 1e-5; a bf16 x
  bf16 product is exact in float32, so only the summation order differs;
- "highest" vs the JAX scan and the Pallas kernel in interpret mode: atol
  1e-5, float32 sums in another order;
- drift from the float32 scan over PyanNet's 589 steps at H = 128: 3.2e-4
  for "default" and 6.2e-7 for "high" on this seed (the JAX docstring
  claims 3e-4 for "default" on a TPU); bounded at 1e-3 and 2e-6, about
  3x;
- bf16 hi + lo reconstructs float32 within 2^-16 relative, the error of
  two bf16 terms (8 significant bits each, the second rounded to nearest).
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_audio_tpu.ops.lstm import lstm_cell_scan
from pyannote_audio_tpu.ops.pallas_lstm import pallas_lstm_cell
from pyannote_audio_tpu_torch.models.blocks.rnn import LSTM
from pyannote_audio_tpu_torch.ops import lstm_kernel
from pyannote_audio_tpu_torch.ops.lstm import (
    lstm_bidirectional_recurrence_plain, lstm_recurrence, split_bf16)
from pyannote_audio_tpu_torch.utils.runtime import lstm_precision
from test_torch_port_models import one_torch_thread  # noqa: F401

ATOL = 1e-5
DRIFT_BOUND = {"default": 1e-3, "high": 2e-6}


def _inputs(T, B, H, seed, D_in=None):
    rng = np.random.default_rng(seed)
    if D_in is None:
        xw = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    else:   # xw as PyanNet makes it: x @ W_ih^T + b
        x = rng.standard_normal((T, B, D_in)).astype(np.float32)
        w_ih = rng.uniform(-1, 1, (4 * H, D_in)) / np.sqrt(H)
        b = rng.uniform(-1, 1, 4 * H) * 2 / np.sqrt(H)
        xw = (x @ w_ih.T + b).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (4 * H, H)) / np.sqrt(H)).astype(np.float32)
    return xw, w_hh


def _jax_recurrence(xw, w_hh, precision, reverse):
    """The JAX package's Pallas step at ``precision``, written out: the
    bf16 roundings made explicit, products summed in float32."""
    w_t = jnp.asarray(w_hh).T
    bf = jnp.bfloat16

    def dot(a, b):
        return jnp.dot(a.astype(bf), b.astype(bf),
                       preferred_element_type=jnp.float32)

    def product(h):
        if precision == "default":
            return dot(h, w_t)
        h_hi = h.astype(bf).astype(jnp.float32)
        w_hi = w_t.astype(bf).astype(jnp.float32)
        return dot(h, w_t) + dot(h, w_t - w_hi) + dot(h - h_hi, w_t)

    def step(carry, xw_t):
        h, c = carry
        gates = xw_t + product(h)
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h = jax.nn.sigmoid(o) * jnp.tanh(c)
        return (h, c), h

    B, H = xw.shape[1], w_hh.shape[1]
    init = (jnp.zeros((B, H), jnp.float32), jnp.zeros((B, H), jnp.float32))
    _, hs = jax.lax.scan(step, init, jnp.asarray(xw), reverse=reverse)
    return np.asarray(hs)


@pytest.mark.parametrize("precision", ["default", "high"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(23, 4, 16), (9, 3, 12)])
def test_plain_precision_matches_jax(T, B, H, reverse, precision):
    xw, w_hh = _inputs(T, B, H, seed=T * H)
    expected = _jax_recurrence(xw, w_hh, precision, reverse)
    ours = lstm_recurrence(torch.from_numpy(xw), torch.from_numpy(w_hh),
                           reverse=reverse, precision=precision).numpy()
    np.testing.assert_allclose(ours, expected, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_highest_matches_scan_and_pallas(reverse, monkeypatch):
    monkeypatch.setenv("PYANNOTE_TPU_LSTM_PRECISION", "highest")
    xw, w_hh = _inputs(12, 8, 8, seed=5)
    scan = np.asarray(lstm_cell_scan(jnp.asarray(xw), jnp.asarray(w_hh),
                                     reverse=reverse))
    pallas = np.asarray(pallas_lstm_cell(
        jnp.asarray(xw), jnp.asarray(w_hh), reverse=reverse, interpret=True))
    ours = lstm_recurrence(torch.from_numpy(xw), torch.from_numpy(w_hh),
                           reverse=reverse, precision="highest").numpy()
    np.testing.assert_allclose(ours, scan, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


@pytest.mark.parametrize("precision", ["default", "high"])
def test_drift_from_float32_at_pyannet_shape(precision):
    xw, w_hh = _inputs(589, 3, 128, seed=0, D_in=60)
    xw, w_hh = torch.from_numpy(xw), torch.from_numpy(w_hh)
    exact = np.asarray(lstm_cell_scan(jnp.asarray(xw.numpy()),
                                      jnp.asarray(w_hh.numpy())))
    ours = lstm_recurrence(xw, w_hh, precision=precision).numpy()
    drift = float(np.abs(ours - exact).max())
    print(f"{precision}: max drift from the float32 scan over 589 steps "
          f"{drift:.3e} (bound {DRIFT_BOUND[precision]}; JAX docstring, "
          f"TPU, default: 3e-4)")
    assert 0.0 < drift <= DRIFT_BOUND[precision]


def test_lstm_precision_resolves(monkeypatch):
    monkeypatch.delenv("PYANNOTE_TPU_LSTM_PRECISION", raising=False)
    assert lstm_precision("cpu") == "highest"
    assert lstm_precision(torch.device("cuda")) == "default"
    assert lstm_precision("cuda:1") == "default"
    for name in ("default", "high", "highest"):
        monkeypatch.setenv("PYANNOTE_TPU_LSTM_PRECISION", name)
        assert lstm_precision(torch.device("cuda", 0)) == name
        assert lstm_precision(torch.device("cpu")) == "highest"
    monkeypatch.setenv("PYANNOTE_TPU_LSTM_PRECISION", "bf16")
    with pytest.raises(ValueError, match="PYANNOTE_TPU_LSTM_PRECISION"):
        lstm_precision("cuda")
    with pytest.raises(ValueError):
        lstm_precision("cpu")


def test_cpu_module_ignores_the_gate(monkeypatch):
    # on the CPU the JAX package runs its float32 scan whatever the gate
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 15, 7)).astype(np.float32))
    module = LSTM(7, hidden_size=16, generator=torch.Generator()
                  .manual_seed(0))
    with torch.no_grad():
        monkeypatch.setenv("PYANNOTE_TPU_LSTM_PRECISION", "highest")
        exact = module(x)
        monkeypatch.setenv("PYANNOTE_TPU_LSTM_PRECISION", "default")
        gated = module(x)
    assert torch.equal(exact, gated)
    assert module._prepared == {}   # nothing packed for the kernel


def test_wrapper_passes_precision_to_plain_on_cpu():
    xw, w_hh = _inputs(11, 3, 8, seed=9)
    xw2 = torch.from_numpy(np.concatenate([xw, xw[::-1]], axis=-1).copy())
    w2 = torch.from_numpy(np.stack([w_hh, w_hh]))
    before = lstm_kernel.lstm_bidirectional_recurrence.launches
    for precision in ("default", "high", "highest"):
        ours = lstm_kernel.lstm_bidirectional_recurrence(xw2, w2, precision)
        assert torch.equal(ours, lstm_bidirectional_recurrence_plain(
            xw2, w2, precision))
    assert lstm_kernel.lstm_bidirectional_recurrence.launches == before
    with pytest.raises(ValueError, match="precision"):
        lstm_kernel.lstm_bidirectional_recurrence(xw2, w2, "fast")


@pytest.mark.parametrize("H,precision,cluster,padded", [
    (8, "default", 1, 16), (16, "highest", 1, 16), (96, "default", 2, 96),
    (128, "default", 2, 128), (128, "high", 2, 128),
    (128, "highest", 2, 128), (200, "default", 4, 256),
    (256, "default", 4, 256), (256, "high", 8, 256),
    (256, "highest", 8, 256)])
def test_kernel_geometry(H, precision, cluster, padded):
    geometry = lstm_kernel.kernel_geometry(H, precision)
    assert (geometry["cluster"], geometry["padded"]) == (cluster, padded)
    assert geometry["shared_bytes"] <= lstm_kernel.SHARED_BYTES
    # a warp per 16 units of a CTA, at most 4 warps
    units = padded // cluster
    assert units % 16 == 0 and units <= lstm_kernel.MAX_UNITS


def test_kernel_geometry_refuses_beyond_the_chip():
    """Past the on-chip route (H = 256) the streamed one takes over; the
    one refusal left is an H whose h and xw ring exceed a CTA's shared
    memory: above 1792 in "default", 1408 in "high" and "highest"."""
    assert lstm_kernel.kernel_geometry(300, "default")["stream"]
    for precision, largest in lstm_kernel.STREAM_MAX_HIDDEN.items():
        assert lstm_kernel.kernel_geometry(largest, precision)["stream"]
        with pytest.raises(ValueError, match=str(largest)):
            lstm_kernel.kernel_geometry(largest + 1, precision)
    with pytest.raises(ValueError, match="1408"):
        lstm_kernel.prepare_recurrent_weights(
            torch.zeros(1, 4 * 1409, 1409), "highest")
    with pytest.raises(ValueError, match="precision"):
        lstm_kernel.kernel_geometry(128, "fp8")


def _unpack(prepared, D):
    """The inverse of prepare_recurrent_weights' permutation, written from
    the fragment layout: (D, 4, Hp, Hp) per part."""
    packed, Hp = prepared.packed.float(), prepared.padded
    if prepared.precision == "highest":
        # (D, C, group, gate, k/4, half, g, 4) -> (D, gate, C, group, half,
        # g, k/4, 4)
        return [packed.permute(0, 3, 1, 2, 5, 6, 4, 7).reshape(D, 4, Hp, Hp)]
    # (D, C, part, group, gate, k-step, g, t, kh, rh, e)
    return [packed[:, :, p].permute(0, 3, 1, 2, 8, 5, 4, 7, 6, 9)
            .reshape(D, 4, Hp, Hp) for p in range(packed.shape[2])]


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("H,D", [(40, 2), (8, 1), (128, 2)])
def test_weight_preparation_round_trips(H, D, precision):
    rng = np.random.default_rng(H)
    w_hh = torch.from_numpy((rng.uniform(-1, 1, (D, 4 * H, H))
                             / np.sqrt(H)).astype(np.float32))
    prepared = lstm_kernel.prepare_recurrent_weights(w_hh, precision)
    Hp = prepared.padded
    parts = _unpack(prepared, D)
    for part in parts:   # padded rows and columns are zero
        assert not part[:, :, H:].any() and not part[..., H:].any()
    back = [p[:, :, :H, :H].reshape(D, 4 * H, H) for p in parts]
    if precision == "highest":
        assert prepared.packed.dtype == torch.float32
        assert torch.equal(back[0], w_hh)
    elif precision == "default":
        assert torch.equal(back[0], w_hh.to(torch.bfloat16).float())
    else:
        hi, lo = split_bf16(w_hh)
        assert torch.equal(back[0], hi) and torch.equal(back[1], lo)
        err = (back[0] + back[1] - w_hh).abs()
        assert bool((err <= 2.0 ** -16 * w_hh.abs()).all())
    assert prepared.packed.shape[:2] == (D, prepared.cluster)
    assert prepared.packed.is_contiguous()
    assert Hp % (16 * prepared.cluster) == 0


def test_fragment_layout_gives_the_product():
    """Emulate mma.sync m16n8k16 from the packed A fragments (each lane's
    registers {row g / g+8, k 2t..2t+1 / +8}) and a B fragment of h^T:
    the accumulators must be W_hh @ h^T in the permuted gate rows."""
    H, D = 40, 1
    rng = np.random.default_rng(1)
    w = rng.uniform(-1, 1, (D, 4 * H, H)).astype(np.float32)
    h = rng.uniform(-1, 1, (8, H)).astype(np.float32)
    prepared = lstm_kernel.prepare_recurrent_weights(torch.from_numpy(w),
                                                     "default")
    C, Hp = prepared.cluster, prepared.padded
    groups, S = Hp // C // 16, Hp // 16
    frags = prepared.packed.float().numpy()[0, :, 0]  # (C, group, q, S, ...)
    frags = frags.reshape(C, groups, 4, S, 32, 8)
    w_bf = torch.from_numpy(w[0]).to(torch.bfloat16).float().numpy()
    h_pad = np.zeros((8, Hp), np.float32)
    h_pad[:, :H] = h
    for c in range(C):
        for wp in range(groups):
            for q in range(4):
                acc = np.zeros((16, 8), np.float64)
                for s in range(S):
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        for reg in range(4):
                            kh, rh = reg // 2, reg % 2
                            for e in range(2):
                                k = 16 * s + 8 * kh + 2 * t + e
                                acc[g + 8 * rh] += frags[
                                    c, wp, q, s, lane, 2 * reg + e] \
                                    * h_pad[:, k]
                units = c * Hp // C + wp * 16 + np.arange(16)
                ref = np.zeros((16, 8))
                real = units < H
                ref[real] = w_bf[q * H + units[real]] @ h.T
                np.testing.assert_allclose(acc, ref, atol=1e-5)


def test_speaker_diarization_runs_on_the_card_by_default(monkeypatch):
    from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
        WeSpeakerResNet34
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    default = inspect.signature(SpeakerDiarization).parameters["device"]
    assert default.default == "cuda"
    g = torch.Generator().manual_seed(0)
    models = (PyanNet(lstm_hidden=8, linear_hidden=8, generator=g),
              WeSpeakerResNet34(num_blocks=(1, 1, 1, 1), m_channels=8,
                                generator=g))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SpeakerDiarization(*models)
    pipeline = SpeakerDiarization(*models, device="cpu")
    assert pipeline.device == torch.device("cpu")
