"""The port's accelerator paths against the JAX package's, on the CPU.

Each module of the shared whole-file front-end, the whole-file fbank, the
shared trunk and the bf16 SincNet is held against its JAX counterpart on
the same numpy inputs and weights, with the gates set on both sides.
Shapes are small: PyanNet hidden 16, ResNet blocks (1, 1, 1, 1) x 8
channels, trunk panels core 16 / halo 16 / batch 2.

Tolerances:
- float32 front-end fold 1e-4 (the JAX package's own bound,
  tests/test_shared_sinc.py), whole-file conv 1e-5 relative;
- bf16 front-end: the conv output within one bf16 step (2^-7
  relative) of the JAX one, log-probabilities within 5e-2 and the port
  no further from float32 than 2x the JAX bf16 error;
- fbank 1e-3 (log-mel through another rfft), the whole-file slices
  equal to the per-chunk fbank within 1e-5; the composed-conv and
  DFT-matmul spectra within the golden bound 2e-3 of the rfft fbank and
  of the JAX package's on the same route; CMN ``prepare`` within 1e-5
  of a float64 CMN, and of JAX's up to JAX's own float32 error;
- float32 trunk 2e-3 (conv summation order); bf16 trunk as the step-0
  bound of tests/test_torch_port_models.py (2e-2 of the frames' scale,
  and the 2x relative bound);
- the pipeline with every gate on: the same hard clusters and
  Annotations (boundaries within one frame) as the JAX pipeline, and
  centroids within 2e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from corpus import default_two_speaker_file
from pyannote_audio_tpu.core.inference import Inference as JaxInference
from pyannote_audio_tpu.ops.fbank import fbank_num_frames
from pyannote_audio_tpu.pipelines import clustering as jax_clustering
from pyannote_audio_tpu.pipelines.speaker_diarization import (
    EmbeddingHotPathMixin, SpeakerDiarization as JaxSpeakerDiarization)
from pyannote_audio_tpu_torch.core.inference import (Inference, _chunk_grid,
                                                     pad_to_grid)
from pyannote_audio_tpu_torch.core.segment import SlidingWindowFeature
from pyannote_audio_tpu_torch.ops.fbank import fbank, whole_fbank
from pyannote_audio_tpu_torch.pipelines import clustering
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from pyannote_audio_tpu_torch.utils.runtime import device_flag
from test_torch_port_models import (SmallWeSpeakerBF16, jax_pyannet,
                                    jax_wespeaker, torch_pyannet_from,
                                    torch_wespeaker_from)
from test_torch_port_pipeline import (PARAMS, _assert_same_annotation,
                                      _capture_clusters)
from test_torch_port_models import one_torch_thread  # noqa: F401

GATES = ("PYANNOTE_TPU_SEG_BF16", "PYANNOTE_TPU_SHARED_SINC",
         "PYANNOTE_TPU_SHARED_TRUNK")
PANELS = {"TRUNK_PANEL_CORE": 16, "TRUNK_PANEL_HALO": 16,
          "TRUNK_PANEL_BATCH": 2}
SR = 16000


def set_gates(mp, **values):
    """Set the gates (and the conv-fbank gate off on both sides)."""
    mp.setenv("PYANNOTE_TPU_CONV_FBANK", "0")
    for name in GATES:
        mp.setenv(name, values.get(name.split("_TPU_")[1].lower(), "0"))


def _closure(fn, name):
    """A variable that ``fn`` closes over (the JAX pipeline keeps its
    trunk pieces in closures)."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


class JaxTrunkHost(EmbeddingHotPathMixin):
    """Just enough of the JAX pipeline to build its shared-trunk
    functions for an embedding model."""

    def __init__(self, embedding):
        self._embedding = embedding
        self.mesh = None
        for name, value in PANELS.items():
            setattr(self, name, value)


def port_pipeline(seg, emb, compute_dtype=torch.float32, duration=2.0):
    """The port's pipeline on the CPU, with test-sized trunk panels."""
    pipeline = SpeakerDiarization(
        torch_pyannet_from(seg), torch_wespeaker_from(emb, compute_dtype),
        segmentation_batch_size=4, embedding_batch_size=4, device="cpu")
    assert pipeline._segmentation.duration == duration
    for name, value in PANELS.items():
        setattr(pipeline, name, value)
    return pipeline


def _wave(seconds, seed, silent=None):
    rng = np.random.default_rng(seed)
    wav = 0.1 * rng.standard_normal((1, int(SR * seconds)))
    if silent is not None:
        wav[:, int(silent[0] * SR):int(silent[1] * SR)] = 0.0
    return wav.astype(np.float32)


# -- utils/runtime.py --------------------------------------------------------

@pytest.mark.parametrize("value,device,expected", [
    ("1", "cpu", True), ("0", "cuda", False), ("yes", "cuda", False),
    (None, "cuda", True), (None, "cpu", False), (None, "cuda:1", True)])
def test_device_flag(monkeypatch, value, device, expected):
    if value is None:
        monkeypatch.delenv("PYANNOTE_TPU_SHARED_TRUNK", raising=False)
    else:
        monkeypatch.setenv("PYANNOTE_TPU_SHARED_TRUNK", value)
    assert device_flag("PYANNOTE_TPU_SHARED_TRUNK", device) is expected
    assert device_flag("PYANNOTE_TPU_SHARED_TRUNK",
                       torch.device(device)) is expected


# -- models/blocks/sincnet.py, models/segmentation/pyannet.py ---------------

def _frontend_chunks():
    """Speech-like noise, a silent chunk and a near-silent one."""
    rng = np.random.default_rng(12)
    chunks = 0.1 * rng.standard_normal((3, 32000))
    chunks[1] = 0.0
    chunks[2] *= 1e-3
    return chunks.astype(np.float32)


def _jax_frontend(model, chunks):
    """JAX whole conv (batch as channels) + fold, and the per-chunk
    forward, under the gates currently set."""
    params = jax.tree_util.tree_map(jnp.asarray, model.params)
    conv = model.module.apply(params, jnp.asarray(chunks),
                              method="precompute_frontend")
    folded = model.module.apply(
        params, conv, jnp.asarray(chunks.mean(axis=-1)),
        jnp.asarray(chunks.var(axis=-1)), method="forward_from_frontend")
    per_chunk = model.module.apply(params, jnp.asarray(chunks[:, None]))
    return (np.asarray(conv.astype(jnp.float32)).transpose(0, 2, 1),
            np.asarray(folded), np.asarray(per_chunk))


@pytest.mark.parametrize("seg_bf16", ["0", "1"])
def test_whole_conv_and_from_conv_match_jax(monkeypatch, seg_bf16):
    model = jax_pyannet(seed=13)
    port = torch_pyannet_from(model)
    chunks = _frontend_chunks()
    set_gates(monkeypatch)
    _, f32, _ = _jax_frontend(model, chunks)
    set_gates(monkeypatch, seg_bf16=seg_bf16)
    conv, expected, per_chunk_jax = _jax_frontend(model, chunks)
    with torch.no_grad():
        ours_conv = port.precompute_frontend(torch.from_numpy(chunks))
        ours = port.forward_from_frontend(
            ours_conv, torch.from_numpy(chunks.mean(axis=-1)),
            torch.from_numpy(chunks.var(axis=-1))).numpy()
        per_chunk = port(torch.from_numpy(chunks[:, None])).numpy()
    assert ours_conv.dtype == (torch.bfloat16 if seg_bf16 == "1"
                               else torch.float32)
    assert ours_conv.shape == conv.shape == \
        (3, 80, port.frontend_num_frames(32000))
    ours_conv = ours_conv.float().numpy()
    assert np.isfinite(ours).all() and ours.shape == expected.shape
    if seg_bf16 == "0":
        np.testing.assert_allclose(ours_conv, conv, rtol=1e-5,
                                   atol=1e-5 * np.abs(conv).max())
        np.testing.assert_allclose(ours, expected, atol=1e-4)
        # the fold is exact: the shared path equals the per-chunk one
        np.testing.assert_allclose(ours, per_chunk, atol=1e-4)
    else:
        # both round the float32-accumulated conv to bf16 once: at most
        # one bf16 step (2^-7 relative) apart where the sums round apart
        np.testing.assert_allclose(ours_conv, conv, rtol=2 ** -7,
                                   atol=1e-6)
        np.testing.assert_allclose(ours, expected, atol=5e-2)
        np.testing.assert_allclose(per_chunk, per_chunk_jax, atol=5e-2)
        jax_err = np.abs(expected - f32).max()
        assert 0 < np.abs(ours - f32).max() <= 2 * jax_err


# -- core/inference.py ----------------------------------------------------------

def _jax_slide(model, waveform, step):
    inf = JaxInference(model, duration=2.0, step=step, batch_size=8,
                       skip_aggregation=True)
    return np.asarray(inf.slide(waveform, SR).data)


def _port_slide(port, waveform, step):
    inf = Inference(port, duration=2.0, step=step, batch_size=8,
                    skip_aggregation=True, device="cpu")
    out = inf.slide(torch.from_numpy(waveform), SR).data.numpy()
    return out, inf.counts["whole_conv"]


@pytest.mark.parametrize("seg_bf16", ["0", "1"])
def test_shared_slide_matches_jax(monkeypatch, seg_bf16):
    """7.3 s with a silent second: full chunks, silent chunks and a
    zero-padded tail chunk."""
    model = jax_pyannet(seed=14)
    port = torch_pyannet_from(model)
    wav = _wave(7.3, seed=15, silent=(3.0, 6.0))
    set_gates(monkeypatch, seg_bf16=seg_bf16, shared_sinc="1")
    expected = _jax_slide(model, wav, 0.5)
    ours, passes = _port_slide(port, wav, 0.5)
    assert passes == 1
    set_gates(monkeypatch, seg_bf16=seg_bf16)
    per_chunk, passes = _port_slide(port, wav, 0.5)
    assert passes == 0
    assert ours.shape == expected.shape == per_chunk.shape == (12, 115, 3)
    if seg_bf16 == "0":
        np.testing.assert_allclose(ours, expected, atol=1e-4)
        np.testing.assert_allclose(ours, per_chunk, atol=1e-4)
    else:
        # hard multilabel scores: a bf16 rounding may flip a near tie
        assert (ours != expected).any(-1).mean() < 2e-2
        assert (ours != per_chunk).any(-1).mean() < 5e-2


def test_shared_slide_needs_aligned_step(monkeypatch):
    set_gates(monkeypatch, shared_sinc="1")
    port = torch_pyannet_from(jax_pyannet(seed=16))
    wav = _wave(5.5, seed=17)
    _, passes = _port_slide(port, wav, 0.5003)
    assert passes == 0                       # per-chunk, as the JAX package
    _, passes = _port_slide(port, wav, 0.5)
    assert passes == 1


def test_shared_slide_out_of_memory_raises(monkeypatch):
    set_gates(monkeypatch, shared_sinc="1")
    port = torch_pyannet_from(jax_pyannet(seed=16))

    def out_of_memory(waveform):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(port, "precompute_frontend", out_of_memory)
    with pytest.raises(MemoryError, match="PYANNOTE_TPU_SHARED_SINC=0"):
        _port_slide(port, _wave(5.5, seed=17), 0.5)


@pytest.mark.parametrize("shared_sinc", ["0", "1"])
def test_batch_out_of_memory_raises(monkeypatch, shared_sinc):
    """A CUDA out-of-memory in a per-chunk batch raises the JAX package's
    MemoryError text, with the shared front-end's hint on that path."""
    set_gates(monkeypatch, shared_sinc=shared_sinc)
    port = torch_pyannet_from(jax_pyannet(seed=16))

    def out_of_memory(*args):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(port, "forward", out_of_memory)
    monkeypatch.setattr(port, "forward_from_frontend", out_of_memory)
    with pytest.raises(MemoryError, match="batch_size \\( 8\\) is probably") \
            as raised:
        _port_slide(port, _wave(5.5, seed=17), 0.5)
    assert ("PYANNOTE_TPU_SHARED_SINC=0" in str(raised.value)) == \
        (shared_sinc == "1")


# -- ops/fbank.py -------------------------------------------------------------------

def test_whole_fbank_slices_match_per_chunk_and_jax():
    """5.5 s on a 2 s / 0.2 s grid: the zero-padded tail chunk too."""
    emb = jax_wespeaker(seed=18)
    wav = torch.from_numpy(_wave(5.5, seed=19))
    padded = pad_to_grid(wav, 32000, 3200)
    starts, padded_len = _chunk_grid(wav.shape[1], 32000, 3200)
    assert padded.shape[1] == padded_len > wav.shape[1]
    feats = whole_fbank(padded)
    assert feats.shape == (fbank_num_frames(padded_len, SR, 25.0, 10.0), 80)
    expected = np.asarray(JaxTrunkHost(emb)._make_whole_fbank_fn()(
        jnp.asarray(padded.numpy())))
    np.testing.assert_allclose(feats.numpy(), expected, atol=1e-3)
    per_chunk = fbank(padded[0].unfold(0, 32000, 3200) * 32768.0,
                      window_type="hamming")              # (C, 198, 80)
    slices = torch.stack([feats[s // 160:s // 160 + per_chunk.shape[1]]
                          for s in starts])
    np.testing.assert_allclose(slices.numpy(), per_chunk.numpy(), atol=1e-5)


FBANK_ROUTES = {"conv": {"PYANNOTE_TPU_CONV_FBANK": "1"},
                "dft": {"PYANNOTE_TPU_CONV_FBANK": "0",
                        "PYANNOTE_TPU_DFT_FBANK": "1"}}


@pytest.mark.parametrize("window_type", ["povey", "hamming"])
@pytest.mark.parametrize("route", list(FBANK_ROUTES))
def test_fbank_spectra_match_rfft_and_jax(monkeypatch, route, window_type):
    """The composed-conv and DFT-matmul power spectra, gates forced on, on
    the golden input (white noise at 0.1, in the x32768 scale) and a batch
    of it: against the port's rfft fbank and the JAX package's fbank on
    the same route, within the JAX package's golden bound 2e-3
    (tests/test_fbank.py); the batch against each item within 1e-4."""
    from pyannote_audio_tpu.ops.fbank import fbank_impl as jax_fbank
    rng = np.random.default_rng(25)
    wav = (0.1 * rng.standard_normal((2, 16000))).astype(np.float32) \
        * np.float32(32768.0)
    monkeypatch.delenv("PYANNOTE_TPU_DFT_FBANK", raising=False)
    monkeypatch.setenv("PYANNOTE_TPU_CONV_FBANK", "0")
    rfft = fbank(torch.from_numpy(wav), window_type=window_type).numpy()
    for name, value in FBANK_ROUTES[route].items():
        monkeypatch.setenv(name, value)
    expected = np.asarray(jax_fbank(jnp.asarray(wav),
                                    window_type=window_type))

    def no_rfft(*args, **kwargs):
        raise AssertionError("the rfft ran")
    monkeypatch.setattr(torch.fft, "rfft", no_rfft)
    ours = fbank(torch.from_numpy(wav), window_type=window_type).numpy()
    one = fbank(torch.from_numpy(wav[1]), window_type=window_type).numpy()
    assert ours.shape == expected.shape == (2, 98, 80)
    np.testing.assert_allclose(ours, rfft, atol=2e-3)
    np.testing.assert_allclose(ours, expected, atol=2e-3)
    np.testing.assert_allclose(ours[1], one, atol=1e-4)


def test_fbank_rfft_is_the_cpu_default(monkeypatch):
    """Unset, the conv-fbank gate is off on the CPU (on on a CUDA device,
    ``device_flag``), so the CPU keeps the rfft."""
    monkeypatch.delenv("PYANNOTE_TPU_CONV_FBANK", raising=False)
    monkeypatch.delenv("PYANNOTE_TPU_DFT_FBANK", raising=False)
    calls = []
    rfft = torch.fft.rfft
    monkeypatch.setattr(torch.fft, "rfft",
                        lambda *a, **k: calls.append(1) or rfft(*a, **k))
    fbank(torch.from_numpy(_wave(0.5, seed=26)))
    assert calls == [1]
    assert device_flag("PYANNOTE_TPU_CONV_FBANK", "cuda")


# -- pipelines/speaker_diarization.py: the shared trunk ------------------------------

def _trunk_inputs(seconds=5.5):
    wav = torch.from_numpy(_wave(seconds, seed=20))
    padded = pad_to_grid(wav, 32000, 3200)
    return padded, fbank_num_frames(wav.shape[1], SR, 25.0, 10.0)


def test_trunk_geometry_matches_jax():
    emb = jax_wespeaker(seed=21)
    pipeline = port_pipeline(jax_pyannet(seed=21), emb)
    for window in (32000, 160000):
        _, _, expected = JaxTrunkHost(emb)._make_shared_trunk_fns(
            window, device_masks=True)
        ours = pipeline.trunk_geometry(window)
        assert ours["stride"] == expected["stride"] == 8
        assert ours["trunk_frames_per_chunk"] == \
            expected["trunk_frames_per_chunk"]
    assert pipeline.trunk_geometry(160000)["frames_per_chunk"] == 998
    assert pipeline.trunk_geometry(160000)["trunk_frames_per_chunk"] == 125


def _cmn_reference(feats, num_real, frames_per_chunk):
    """Sliding-window CMN in float64 on the host (as the JAX package's
    tests/test_shared_trunk.py replicates it)."""
    feats = feats.astype(np.float64)
    T = feats.shape[0]
    half = frames_per_chunk // 2
    csum = np.vstack([np.zeros((1, feats.shape[1])),
                      np.cumsum(feats[:num_real], axis=0)])
    lo = np.clip(np.arange(T) - half, 0, None)
    hi = np.maximum(np.clip(np.arange(T) + half, None, num_real), lo + 1)
    mean = (csum[np.minimum(hi, num_real)] - csum[np.minimum(lo, num_real)]) \
        / np.maximum(hi - lo, 1)[:, None]
    centered = feats - mean
    centered[num_real:] = 0.0
    return centered


def test_prepare_matches_jax():
    """The port's CMN is within 1e-5 of the float64 CMN, and no further
    from JAX's than JAX's own float32 running sum is from it (+1e-5)."""
    emb = jax_wespeaker(seed=22)
    pipeline = port_pipeline(jax_pyannet(seed=22), emb)
    compute_trunk, _, _ = JaxTrunkHost(emb)._make_shared_trunk_fns(
        32000, device_masks=True)
    prepare = _closure(compute_trunk, "prepare")
    padded, num_real = _trunk_inputs()
    feats = whole_fbank(padded)
    T = feats.shape[0]
    assert num_real < T                            # padded tail frames
    expected = np.asarray(prepare(jnp.asarray(feats.numpy()),
                                  jnp.int32(num_real)))
    ours = pipeline.prepare(feats, num_real, 32000).numpy()
    assert ours.shape == expected.shape
    start = 8 * PANELS["TRUNK_PANEL_HALO"]
    assert not ours[:start].any() and not ours[start + num_real:].any()
    reference = _cmn_reference(feats.numpy(), num_real, 198)
    np.testing.assert_allclose(ours[start:start + T], reference, atol=1e-5)
    jax_err = np.abs(expected[start:start + T] - reference).max()
    assert np.abs(ours - expected).max() <= jax_err + 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_trunk_matches_jax(dtype):
    klass = SmallWeSpeakerBF16 if dtype == "bfloat16" else None
    emb = jax_wespeaker(seed=23, **({"klass": klass} if klass else {}))
    pipeline = port_pipeline(jax_pyannet(seed=23), emb,
                             compute_dtype=getattr(torch, dtype))
    padded, num_real = _trunk_inputs()
    compute_trunk, _, _ = JaxTrunkHost(emb)._make_shared_trunk_fns(
        32000, device_masks=True)
    expected = np.asarray(compute_trunk(jnp.asarray(padded.numpy()),
                                        num_real))
    with torch.no_grad():
        ours = pipeline.compute_trunk(padded, num_real, 32000).numpy()
    assert ours.shape == expected.shape
    # 5.5 s -> 5.6 s padded: 558 fbank frames, 70 trunk frames, 5 panels
    # of 16, 3 batches of 2
    assert pipeline.counts["trunk_panel_batches"] == 3
    assert pipeline.counts["whole_fbank"] == 1
    scale = np.abs(expected).max()
    if dtype == "float32":
        np.testing.assert_allclose(ours, expected, atol=2e-3)
    else:
        assert np.abs(ours - expected).max() <= 2e-2 * scale
        assert np.abs(ours - expected).mean() <= 2e-3 * scale


def test_panels_equal_one_unpanelled_pass():
    """Halos cover the trunk's receptive field: panels reproduce one pass
    of the trunk over the same padded layout (float32)."""
    pipeline = port_pipeline(jax_pyannet(seed=24), jax_wespeaker(seed=24))
    padded, num_real = _trunk_inputs()
    with torch.no_grad():
        trunk = pipeline.compute_trunk(padded, num_real, 32000)
        layout = pipeline.prepare(whole_fbank(padded), num_real, 32000)
        whole = pipeline._embedding.frames_from_fbank(layout[None],
                                                      centered=True)[0]
    halo = PANELS["TRUNK_PANEL_HALO"]
    t_total = -(-whole_fbank(padded).shape[0] // 8)
    assert trunk.shape[0] >= t_total
    np.testing.assert_allclose(trunk[:t_total].numpy(),
                               whole[halo:halo + t_total].numpy(), atol=1e-5)


# -- the whole pipeline with the gates on ------------------------------------------

ALL_GATES = {"shared_sinc": "1", "shared_trunk": "1"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """31.3 s of the corpus (not a whole number of 1 s steps: a
    zero-padded tail chunk) and the models of test_torch_port_pipeline."""
    path = tmp_path_factory.mktemp("corpus") / "two_speakers.wav"
    default_two_speaker_file(path, duration=31.3)
    return ({"audio": str(path), "uri": "two_speakers"},
            jax_pyannet(duration=10.0, seed=2), jax_wespeaker(seed=22))


@pytest.fixture(scope="module", params=["0", "1"], ids=["f32_sincnet",
                                                        "bf16_sincnet"])
def gated_outputs(request, corpus):
    """Port and JAX pipelines with the shared sinc, fbank and trunk on,
    SincNet in float32 or in bf16 (then every gate is on)."""
    file, seg, emb = corpus
    clusters = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        set_gates(mp, seg_bf16=request.param, **ALL_GATES)
        port = SpeakerDiarization(torch_pyannet_from(seg),
                                  torch_wespeaker_from(emb),
                                  segmentation_batch_size=16,
                                  embedding_batch_size=16, device="cpu")
        jax_pipeline = JaxSpeakerDiarization(
            segmentation=seg, embedding=emb,
            clustering="AgglomerativeClustering",
            segmentation_batch_size=16, embedding_batch_size=16)
        for pipeline in (port, jax_pipeline):
            pipeline.instantiate(PARAMS)
            for name, value in PANELS.items():
                setattr(pipeline, name, value)
        _capture_clusters(mp, jax_clustering.AgglomerativeClustering,
                          clusters["jax"])
        _capture_clusters(mp, clustering.AgglomerativeClustering,
                          clusters["port"])
        expected = jax_pipeline(dict(file), max_speakers=4)
        ours = port(dict(file), max_speakers=4)
        # both segmentations' log-probabilities, for the bf16 flips
        waveform, _ = port._audio(dict(file))
        jax_logp = np.asarray(JaxInference(
            seg, duration=10.0, step=1.0, batch_size=16,
            skip_aggregation=True, skip_conversion=True).slide(
                waveform, SR).data)
        port._segmentation._powerset = None       # log-probs, unconverted
        port_logp = port._segmentation.slide(torch.from_numpy(waveform),
                                             SR).data.numpy()
    counts = dict(port.counts,
                  whole_conv=port._segmentation.counts["whole_conv"])
    return {"expected": expected, "ours": ours, "clusters": clusters,
            "counts": counts, "frame": seg.receptive_field.step,
            "logp": (jax_logp, port_logp)}


def test_gated_pipeline_took_the_accelerator_path(gated_outputs):
    # 31.3 s -> 32 s padded: 3198 fbank frames, 400 trunk frames, 25
    # panels of 16, 13 batches of 2; the segmentation's whole-file conv
    # ran twice (the pipeline, then the log-probability probe)
    assert gated_outputs["counts"] == {
        "whole_conv": 2, "whole_fbank": 1, "trunk_panel_batches": 13,
        "chunk_trunk_batches": 0}


def test_gated_pipeline_same_clusters_and_annotations(gated_outputs):
    """Float32 SincNet: the JAX pipeline's hard clusters, Annotations and
    centroids. bf16 SincNet: bf16 roundings that the two frameworks place
    apart move log-probabilities by ~1e-3, which flips the powerset argmax
    where two classes of these random-weight models tie that closely;
    every flip must be such a near tie, flips must be rare, and the hard
    clusters must agree outside the chunks that a flip touches."""
    expected, ours = gated_outputs["expected"], gated_outputs["ours"]
    clusters = gated_outputs["clusters"]
    jax_logp, port_logp = gated_outputs["logp"]
    assert len(clusters["jax"]) == len(clusters["port"]) == 1
    jax_clusters, port_clusters = clusters["jax"][0], clusters["port"][0]
    logp_err = np.abs(port_logp - jax_logp).max()
    flips = jax_logp.argmax(-1) != port_logp.argmax(-1)       # (C, F)
    if not flips.any():
        assert logp_err <= 1e-4
        np.testing.assert_array_equal(port_clusters, jax_clusters)
        assert ours.speaker_diarization.labels() == \
            expected.speaker_diarization.labels()
        frame = gated_outputs["frame"]
        _assert_same_annotation(ours.speaker_diarization,
                                expected.speaker_diarization, frame)
        _assert_same_annotation(ours.exclusive_speaker_diarization,
                                expected.exclusive_speaker_diarization,
                                frame)
        np.testing.assert_allclose(ours.speaker_embeddings,
                                   np.asarray(expected.speaker_embeddings),
                                   atol=2e-3)
        return
    assert logp_err <= 5e-2 and flips.mean() < 1e-2
    top = np.sort(jax_logp, axis=-1)
    assert (top[..., -1] - top[..., -2])[flips].max() <= 2 * logp_err
    touched = flips.any(-1)
    np.testing.assert_array_equal(port_clusters[~touched],
                                  jax_clusters[~touched])


def test_gated_pipeline_float32_sincnet_has_no_flip(gated_outputs,
                                                    request):
    """The float32 run must take the exact-parity branch above."""
    jax_logp, port_logp = gated_outputs["logp"]
    flips = (jax_logp.argmax(-1) != port_logp.argmax(-1)).sum()
    if "f32_sincnet" in request.node.callspec.id:
        assert flips == 0
    else:
        assert flips > 0             # bf16 SincNet really ran on both sides


@pytest.fixture(scope="module")
def embeddings(corpus):
    """JAX and port embeddings on the JAX segmentation's masks, by
    (side, SHARED_TRUNK gate, trunk dtype), and the active pairs."""
    file, seg, emb = corpus
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for gate, dtype in (("1", "f32"), ("1", "bf16"), ("0", "f32")):
            set_gates(mp, shared_sinc="1", shared_trunk=gate)
            jax_emb = emb if dtype == "f32" else \
                jax_wespeaker(seed=22, klass=SmallWeSpeakerBF16)
            jax_pipeline = JaxSpeakerDiarization(
                segmentation=seg, embedding=jax_emb,
                clustering="AgglomerativeClustering",
                segmentation_batch_size=16, embedding_batch_size=16)
            port = SpeakerDiarization(
                torch_pyannet_from(seg), torch_wespeaker_from(
                    emb, torch.float32 if dtype == "f32" else torch.bfloat16),
                segmentation_batch_size=16, embedding_batch_size=16,
                device="cpu")
            for pipeline in (port, jax_pipeline):
                for key, value in PANELS.items():
                    setattr(pipeline, key, value)
            prepared = jax_pipeline.prepare_one(dict(file))
            segmentations = jax_pipeline.get_segmentations(prepared)
            out["jax", gate, dtype] = np.asarray(
                jax_pipeline.get_embeddings(prepared, segmentations))
            waveform, _ = port._audio(dict(file))
            out["port", gate, dtype] = port.get_embeddings(
                torch.from_numpy(waveform), SlidingWindowFeature(
                    torch.from_numpy(np.asarray(segmentations.data)),
                    segmentations.sliding_window))
            assert port.counts["trunk_panel_batches"] == \
                (13 if gate == "1" else 0)
    active = np.asarray(segmentations.data).sum(axis=1) > 0      # (C, S)
    return out, active


def test_shared_trunk_bf16_embeddings(embeddings):
    """The default bf16 trunk on the shared-trunk path, against the JAX
    bf16 trunk on the same masks, with the 2x bound against float32."""
    out, _ = embeddings
    f32 = out["jax", "1", "f32"]
    np.testing.assert_allclose(out["port", "1", "f32"], f32, atol=2e-3)
    bf16, ours = out["jax", "1", "bf16"], out["port", "1", "bf16"]
    scale = np.abs(f32).max()
    assert np.abs(ours - bf16).max() <= 2e-2 * scale
    for reduce in (np.max, np.mean):
        assert reduce(np.abs(ours - f32)) <= \
            2 * reduce(np.abs(bf16 - f32))


def _cosine(a, b):
    return np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1) + 1e-9)


def test_shared_trunk_departs_from_exact_as_jax_does(embeddings):
    """The shared trunk is approximate by design (sliding CMN, real
    context at chunk borders). Over the active (chunk, speaker) pairs the
    port's shared-trunk embeddings depart from its exact path by the same
    cosine as the JAX package's do from its own, within 1e-3, and both
    stay inside the JAX package's bounds (min > 0.7, mean > 0.85)."""
    out, active = embeddings
    cos = {side: _cosine(out[side, "1", "f32"][active],
                         out[side, "0", "f32"][active])
           for side in ("jax", "port")}
    for reduce in (np.min, np.mean):
        assert abs(reduce(cos["port"]) - reduce(cos["jax"])) <= 1e-3
    assert cos["port"].min() > 0.7 and cos["port"].mean() > 0.85
    np.testing.assert_allclose(cos["port"], cos["jax"], atol=1e-3)


def test_early_dispatch_leaves_output_unchanged(corpus, monkeypatch):
    """apply() queues the trunk before the count's host sync; without the
    early dispatch get_embeddings computes the same trunk itself."""
    file, seg, emb = corpus
    set_gates(monkeypatch, seg_bf16="1", **ALL_GATES)
    port = port_pipeline(seg, emb, duration=10.0)
    port.instantiate(PARAMS)
    early = port(dict(file), max_speakers=4)
    assert port.counts["whole_fbank"] == 1           # one trunk, used once
    monkeypatch.setattr(port, "_start_shared_trunk", lambda waveform: None)
    late = port(dict(file), max_speakers=4)
    assert port.counts["whole_fbank"] == 2           # computed late
    assert late.speaker_diarization == early.speaker_diarization
    np.testing.assert_array_equal(late.speaker_embeddings,
                                  early.speaker_embeddings)
