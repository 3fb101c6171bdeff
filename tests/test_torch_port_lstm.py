"""The port's LSTM recurrence (plain version, module, kernel wrapper)
against the JAX package and torch.nn.LSTM.

All comparisons are float32 at atol 1e-5: the same recurrence with
sums taken in another order. The kernel's geometry and its packing of
W_hh are held exactly, on both routes (on chip up to H = 256, streamed
from device memory above).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_audio_tpu.ops.lstm import lstm_cell_scan
from pyannote_audio_tpu.ops.lstm import multilayer_lstm as jax_multilayer
from pyannote_audio_tpu.ops.pallas_lstm import (pallas_lstm_cell,
                                                pallas_multilayer_lstm)
from pyannote_audio_tpu_torch.models.blocks.rnn import LSTM
from pyannote_audio_tpu_torch.ops import lstm_kernel
from pyannote_audio_tpu_torch.ops.lstm import (
    lstm_bidirectional_recurrence_plain, lstm_recurrence, multilayer_lstm,
    split_bf16, split_tf32)
from test_torch_port_models import one_torch_thread  # noqa: F401

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


def _jax_layers(module, num_layers):
    """The port module's parameters as the JAX package's layer dicts."""
    layers = []
    for i in range(num_layers):
        layer = {}
        for ours_name, theirs in (("w_ih", "weight_ih"),
                                  ("w_hh", "weight_hh"),
                                  ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            for sfx, jsfx in (("", ""), ("_reverse", "_r")):
                layer[ours_name + jsfx] = jnp.asarray(
                    getattr(module, f"{theirs}_l{i}{sfx}").detach().numpy())
        layers.append(layer)
    return layers


def test_wide_bilstm_matches_jax_scan_and_pallas(monkeypatch):
    """A 2-layer BiLSTM at H = 384, where the JAX module takes its Pallas
    kernel (H % 128 == 0) and the card the streamed route: the port's
    module against the JAX scan and ``pallas_multilayer_lstm`` in
    interpret mode (float32 products, as tests/test_pallas_lstm.py runs
    it)."""
    monkeypatch.setenv("PYANNOTE_TPU_LSTM_PRECISION", "highest")
    rng = np.random.default_rng(384)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    module = LSTM(24, hidden_size=384, num_layers=2,
                  generator=torch.Generator().manual_seed(384))
    layers = _jax_layers(module, 2)
    scan = np.asarray(jax_multilayer(jnp.asarray(x), layers))
    pallas = np.asarray(pallas_multilayer_lstm(jnp.asarray(x), layers,
                                               interpret=True))
    with torch.no_grad():
        ours = module(torch.from_numpy(x)).numpy()
    assert ours.shape == (2, 7, 768)
    np.testing.assert_allclose(ours, scan, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


def _packing_from_definition(w_hh: np.ndarray, precision: str, C: int,
                             Hp: int) -> np.ndarray:
    """The forward kernel's W_hh blocks, written from the definition:
    "highest" float4 rows (direction, CTA c, group, gate q, k/4, half, g,
    j) = W_hh[q * H + u, 4 k/4 + j], u = c * Hp / C + 16 group + 8 half +
    g; the bf16 modes the mma.sync m16n8k16 A fragments (direction, CTA,
    part, group, gate, k-step s, g, t, kh, rh, e) = W_hh[q * H + u, k], u
    = c * Hp / C + 16 group + 8 rh + g, k = 16 s + 8 kh + 2 t + e
    (register 2 kh + rh of lane 4 g + t), bf16 (hi and lo for "high");
    zero past H."""
    D, H4, H = w_hh.shape
    units = Hp // C
    w = np.zeros((D, 4, Hp, Hp), np.float32)
    w[:, :, :H, :H] = w_hh.reshape(D, 4, H, H)
    if precision == "highest":
        d, c, grp, q, k4, half, g, j = np.ix_(
            range(D), range(C), range(units // 16), range(4), range(Hp // 4),
            range(2), range(8), range(4))
        return w[d, q, c * units + 16 * grp + 8 * half + g, 4 * k4 + j]
    parts = split_bf16(torch.from_numpy(w)) if precision == "high" \
        else (torch.from_numpy(w),)
    d, c, grp, q, s, g, t, kh, rh, e = np.ix_(
        range(D), range(C), range(units // 16), range(4), range(Hp // 16),
        range(8), range(4), range(2), range(2), range(2))
    u, k = c * units + 16 * grp + 8 * rh + g, 16 * s + 8 * kh + 2 * t + e
    return np.stack([p.to(torch.bfloat16).float().numpy()[d, q, u, k]
                     for p in parts], axis=2)


def _stream_packing_from_definition(w_hh: np.ndarray,
                                    precision: str) -> np.ndarray:
    """The streamed forward's chunks, written from the definition: record
    (unit group G, k-step s, gate q, part, lane 4 g + t) holds the mma.sync
    A fragment of gate q's rows u = 16 G + 8 rh + g (fragment row g + 8
    rh) of W_hh: for "default" / "high" m16n8k16 bf16 (register 2 kh + rh
    holds columns k = 16 s + 8 kh + 2 t + e, e = 0, 1; "high" its hi then
    lo part), for "highest" m16n8k8 float32 of the k-step's half ``part``
    (register 2 ch + rh holds column k = 16 s + 8 part + 4 ch + t); zero
    past H. Chunk j holds k-steps [j KS, j KS + KS) of every unit group in
    turn."""
    D, H4, H = w_hh.shape
    layout = lstm_kernel.stream_layout(H, precision)
    Hp, S, KS = layout["padded"], layout["steps"], layout["chunk_steps"]
    w = np.zeros((D, 4, Hp, 16 * S), np.float32)
    w[:, :, :H, :H] = w_hh.reshape(D, 4, H, H)
    if precision == "highest":
        d, G, s, q, part, g, t, ch, rh = np.ix_(
            range(D), range(Hp // 16), range(S), range(4), range(2),
            range(8), range(4), range(2), range(2))
        rec = w[d, q, 16 * G + 8 * rh + g, 16 * s + 8 * part + 4 * ch + t]
    else:
        parts = split_bf16(torch.from_numpy(w)) if precision == "high" \
            else (torch.from_numpy(w),)
        d, G, s, q, g, t, kh, rh, e = np.ix_(
            range(D), range(Hp // 16), range(S), range(4), range(8),
            range(4), range(2), range(2), range(2))
        rec = np.stack([
            p.to(torch.bfloat16).float().numpy()[
                d, q, 16 * G + 8 * rh + g, 16 * s + 8 * kh + 2 * t + e]
            for p in parts], axis=4)
    return np.concatenate([rec[:, :, j:j + KS].reshape(D, -1)
                           for j in range(0, S, KS)], axis=1)


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("H,D", [(257, 2), (300, 2), (384, 2), (512, 2),
                                 (1024, 1)])
def test_streamed_route_geometry_and_packing(H, D, precision):
    """Above H = 256 the forward kernel streams W_hh through shared
    memory: H padded to a multiple of 128, a cluster of 8 CTAs, or 16 where
    that padding is a multiple of 256, of padded / cluster units (a warp
    per 16 for each group of row tiles, and the producer warp); the
    packing is in chunks of k-steps of every unit group, held against the
    mma fragment definition value for value, and a CTA's share of a chunk
    is one run of bytes."""
    geometry = lstm_kernel.kernel_geometry(H, precision, 32, D)
    C, Hp = geometry["cluster"], geometry["padded"]
    assert geometry["stream"] and Hp == -(-H // 128) * 128
    assert C == (16 if Hp % 256 == 0 else 8)
    units = Hp // C
    assert geometry["units"] == units and units % 16 == 0
    assert geometry["threads"] == 32 * (geometry["warps"] + 1)
    assert geometry["warps"] * geometry["ntw"] * 8 == \
        units // 16 * geometry["rows"] * geometry["kparts"]
    # the warps' registers fit one CTA an SM
    assert geometry["warps"] <= lstm_kernel.STREAM_WARPS[geometry["ntw"]]
    assert geometry["shared_bytes"] <= lstm_kernel.SHARED_BYTES
    w_hh = torch.randn(D, 4 * H, H, generator=torch.Generator()
                       .manual_seed(H)) / H ** 0.5
    prepared = lstm_kernel.prepare_recurrent_weights(w_hh, precision)
    assert (prepared.cluster, prepared.padded) == (0, Hp)
    assert prepared.packed.is_contiguous()
    layout = lstm_kernel.stream_layout(H, precision)
    assert layout["steps"] == -(-H // 16)
    assert prepared.packed.numel() * prepared.packed.element_size() == \
        D * layout["steps"] * Hp // 16 * layout["step_bytes"]
    expected = _stream_packing_from_definition(w_hh.numpy(), precision)
    assert np.array_equal(prepared.packed.float().numpy().reshape(
        expected.shape), expected)


# (H, precision, B) -> (cluster, rows per cluster, every chunk resident):
# the shapes chip_smoke.py's phase 3 holds and times, B astride the steps
# of the rows and of the cluster at H = 512 (24 / 25, 48 / 49, 144 / 145
# resident / streamed, 336 / 337 one wave / two), and the cluster's edge
# (H = 384 / 385)
STREAM_GEOMETRY = [
    (512, "default", 32, 16, 16, True), (512, "default", 256, 8, 48, False),
    (512, "high", 256, 8, 48, False), (512, "highest", 256, 8, 48, False),
    (512, "highest", 32, 16, 16, False), (257, "default", 256, 8, 40, True),
    (257, "highest", 32, 8, 8, False), (384, "default", 256, 8, 40, True),
    (385, "default", 32, 16, 16, True), (1024, "default", 8, 16, 8, False),
    (512, "default", 24, 16, 8, True), (512, "default", 25, 16, 16, True),
    (512, "default", 48, 16, 16, True), (512, "default", 49, 8, 8, False),
    (512, "default", 144, 16, 48, True), (512, "default", 145, 8, 24, False),
    (512, "default", 336, 8, 48, False), (512, "default", 337, 8, 24, False)]


@pytest.mark.parametrize("H,precision,B,cluster,rows,resident",
                         STREAM_GEOMETRY)
def test_streamed_geometry_follows_the_batch(H, precision, B, cluster, rows,
                                             resident):
    """Rows per cluster follow B: of the geometries that fit a CTA's shared
    memory, the fewest waves of clusters on the card (one wherever B
    allows), then the least work a CTA, the fewest bytes streamed a step,
    the larger cluster. Where a CTA's share of W_hh fits beside h it stays
    resident and nothing streams; else a ring of at least 2 slots."""
    geometry = lstm_kernel.kernel_geometry(H, precision, B, 2)
    assert (geometry["cluster"], geometry["rows"]) == (cluster, rows)
    assert (geometry["resident"] == geometry["chunks"]) == resident
    assert (geometry["slots"] == 0) == resident
    assert resident or 2 <= geometry["slots"] <= lstm_kernel.STREAM_SLOTS
    assert 1 <= geometry["per_slot"] <= lstm_kernel.STREAM_PER_SLOT
    assert geometry["streamed_bytes"] == \
        (geometry["chunks"] - geometry["resident"]) * geometry["chunk_bytes"]
    assert geometry["clusters"] == 2 * -(-B // rows)
    capacity = lstm_kernel.STREAM_CLUSTER_CAPACITY[cluster]
    assert geometry["waves"] == -(-geometry["clusters"] // capacity)
    fewest = min(-(-2 * -(-B // r) // lstm_kernel.STREAM_CLUSTER_CAPACITY[c])
                 for c in lstm_kernel.STREAM_CLUSTERS
                 for r in lstm_kernel.STREAM_ROWS
                 if lstm_kernel._stream_candidate(
                     lstm_kernel.stream_layout(H, precision), precision, c,
                     r, B, 2) is not None)
    assert geometry["waves"] == fewest
    assert geometry["shared_bytes"] <= lstm_kernel.SHARED_BYTES


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_streamed_caps_are_kept(precision):
    """The streamed route takes every H up to STREAM_MAX_HIDDEN (1792,
    1408, 1408: not lowered) at every B, and refuses the next."""
    cap = lstm_kernel.STREAM_MAX_HIDDEN[precision]
    assert cap == {"default": 1792, "high": 1408, "highest": 1408}[precision]
    for H in (257, cap - 1, cap):
        for B in (1, 8, 32, 256, 3264):
            geometry = lstm_kernel.kernel_geometry(H, precision, B, 2)
            assert geometry["stream"]
            assert geometry["shared_bytes"] <= lstm_kernel.SHARED_BYTES
    with pytest.raises(ValueError, match=str(cap)):
        lstm_kernel.kernel_geometry(cap + 1, precision, 32, 2)


def _steps(geometry_of, batches):
    """The B at which ``geometry_of(B)`` differs from ``geometry_of(B -
    1)``, for B in ``batches``."""
    steps, before = [], None
    for B in batches:
        now = geometry_of(B)
        if before is not None and now != before:
            steps.append(B)
        before = now
    return steps


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_chip_check_edges_reach_every_streamed_instantiation(precision):
    """chip_smoke.py's phase 3 holds the streamed forward, in every mode,
    at B on both sides of every step of its geometry at H = 512 (cluster,
    rows, row tiles a warp, k-parts, resident chunks, ring slots and their
    chunks, waves) up to
    its largest edge, and its edges reach every row-tile instantiation
    (NTW, a template parameter of the kernel) and both cluster sizes."""
    import chip_smoke
    edges = {B for B, H in chip_smoke.WIDE_EDGES if H == 512}
    keys = ("cluster", "rows", "ntw", "kparts", "resident", "slots",
            "per_slot", "waves")

    def geometry_of(B):
        g = lstm_kernel.kernel_geometry(512, precision, B, 2)
        return tuple(g[k] for k in keys)

    steps = _steps(geometry_of, range(1, max(edges) + 1))
    assert len(steps) >= 10
    for B in steps:
        assert {B - 1, B} <= edges, B
    held = [lstm_kernel.kernel_geometry(H, precision, B, 2)
            for B, H in chip_smoke.WIDE_EDGES
            if H <= lstm_kernel.STREAM_MAX_HIDDEN[precision]]
    assert {g["ntw"] for g in held} == set(lstm_kernel.STREAM_WARPS)
    assert {g["cluster"] for g in held} == set(lstm_kernel.STREAM_CLUSTERS)
    # "highest" on this route is held tighter than on chip, never looser
    assert chip_smoke.STREAM_ATOL[precision] <= \
        chip_smoke.KERNEL_ATOL[precision]


def test_geometry_is_memoised_and_copied():
    """A launch asks for its geometry on every call: it is computed once
    for each set of arguments, and each caller gets its own dict."""
    first = lstm_kernel.kernel_geometry(512, "highest", 171, 2)
    first["rows"] = -1
    again = lstm_kernel.kernel_geometry(512, "highest", 171, 2)
    assert again["rows"] == 32 and again is not first
    backward = lstm_kernel.backward_geometry(512, 32, 2)
    backward.clear()
    assert lstm_kernel.backward_geometry(512, 32, 2)["rows"] == 16


def test_tf32_split_by_bits_is_cvt_rna():
    """The streamed forward splits h and W_hh as hi = (bits + 0x1000) &
    0xffffe000 (no conversion instruction) and lo = x - hi, passed whole:
    hi is TF32 rounded to nearest, ties away (``split_tf32``'s cvt.rna),
    lo exact, and the three passes with lo truncated to TF32 (as the
    tensor cores read it) keep the product within 1e-6 of float64."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(4096).astype(np.float32)
    x[:4] = [1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11, 0.0]

    def split_bits(v):
        bits = v.view(np.uint32)
        hi = ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)) \
            .view(np.float32)
        return hi, (v - hi).astype(np.float32)

    hi, lo = split_bits(x)
    ref_hi, _ = split_tf32(torch.from_numpy(x))
    assert np.array_equal(hi, ref_hi.numpy())
    assert np.array_equal(hi.astype(np.float64) + lo.astype(np.float64),
                          x.astype(np.float64))
    a = rng.standard_normal((64, 512)).astype(np.float32)
    b = rng.standard_normal((512, 8)).astype(np.float32)
    trunc = lambda v: (v.view(np.uint32) & np.uint32(0xffffe000)) \
        .view(np.float32)
    (ah, al), (bh, bl) = split_bits(a), split_bits(b)
    three = ah @ bh + (trunc(al) @ bh + ah @ trunc(bl))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.linalg.norm(three - exact) / np.linalg.norm(exact) <= 1e-6


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_every_hidden_size_has_a_route(precision):
    """H = 1 to 1024 in every mode: on chip up to 256, streamed above."""
    for H in range(1, 1025):
        geometry = lstm_kernel.kernel_geometry(H, precision)
        assert geometry["stream"] == (H > lstm_kernel.MAX_HIDDEN)
        assert H <= geometry["padded"]
        assert geometry["shared_bytes"] <= lstm_kernel.SHARED_BYTES


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
    """H = 300, off chip, takes the streamed route and matches the plain
    version; the one refusal left is an H whose h and xw ring exceed a
    CTA's shared memory (above 1792 in "default"), which launches
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(300)
    xw = torch.randn(4, 3, 4 * 300, generator=g).cuda()
    w_hh = (torch.rand(1, 4 * 300, 300, generator=g) * 2 - 1).cuda() / 300
    before = lstm_kernel.lstm_bidirectional_recurrence.launches
    ours = lstm_kernel.lstm_bidirectional_recurrence(xw, w_hh, "default")
    expected = lstm_bidirectional_recurrence_plain(xw, w_hh, "default")
    assert lstm_kernel.lstm_bidirectional_recurrence.launches == before + 1
    assert (ours - expected).abs().max().item() < CARD_ATOL["default"]
    xw = torch.zeros(2, 1, 4 * 1793, device="cuda")
    w_hh = torch.zeros(1, 4 * 1793, 1793, device="cuda")
    with pytest.raises(ValueError, match="1792"):
        lstm_kernel.lstm_bidirectional_recurrence(xw, w_hh, "default")
    assert lstm_kernel.lstm_bidirectional_recurrence.launches == before + 1
