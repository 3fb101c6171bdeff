"""The separation pipeline's WavLM-large configuration on the CPU, at a
small size: ToTaToNet with its WavLM branch against the benchmark's plain
reference, the leakage mask against scipy, and the pipeline's spans.

Held:
- ToTaToNet with a pre-LN WavLM branch (layer-normed biased convs, 2
  layers x 64, 4 heads) and one DPRNN repeat, on seeded weights drawn in
  the reference's layout, gives the diarization and the sources of
  ``portbench/reference/totatonet.py`` (plain PyTorch, float32, no port
  import) within float32 tolerances, and WavLM's last state too; a bf16
  cast of that state breaks the sources' tolerance;
- ``dilate`` and ``apply_leakage_mask`` give scipy's ``binary_dilation``
  booleans (collars 0, 1, 2 and 1600 samples; seeded masks, activity at
  both ends, empty and full masks);
- a recorded run of a small ``SpeechSeparation`` yields the spans
  ``separate``, ``embedding``, ``clustering``, ``reconstruct``,
  ``overlap_add`` (with ``overlap_add_wait``, a wait, inside) and
  ``leakage`` for the file, in that order and without overlap, and the
  counters ``separated_chunks`` and ``chunk_sources_peak_bytes``; the
  output is the same with recording off.

No JAX: the file also runs where the JAX package is absent.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation

from portbench.reference import totatonet as reference
from portbench.reference.numerics import Numerics
from portbench.weights import draw, generator
from pyannote_audio_tpu_torch.core.annotation import Annotation
from pyannote_audio_tpu_torch.core.io import write_wav
from pyannote_audio_tpu_torch.core.segment import Segment
from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
    WeSpeakerResNet34
from pyannote_audio_tpu_torch.models.separation.totatonet import (
    ToTaToNet, default_specifications)
from pyannote_audio_tpu_torch.pipelines.speech_separation import (
    SpeechSeparation, apply_leakage_mask, dilate)
from pyannote_audio_tpu_torch.telemetry import spans

SR = 16000
SSL = dict(hidden=64, layers=2, heads=4, ffn=128, conv_channels=32,
           rel_pos_bias=True, pre_ln=True, conv_norm="layer")
HPARAMS = dict(
    encoder_decoder=dict(fb_name="free", n_filters=16, kernel_size=32,
                         stride=16),
    dprnn=dict(n_repeats=1, bn_chan=16, hid_size=16, chunk_size=20),
    linear=dict(hidden_size=16, num_layers=2),
    diar=dict(frames_per_second=125), n_sources=3, sample_rate=SR)
SPEC = dict(hparams=HPARAMS, ssl=SSL)
# float32 through a few hundred products and norms, the port's products
# as three TF32 passes (its plain version on the CPU; both sides about 1e-6
# relative): the sources and WavLM's state within 1e-5 relative L2; the
# scores within 1e-3, since the classifier carries the gain that spreads
# its logits (about x100), which scales that rounding up to about 1e-4. A
# bf16 rounding of WavLM's state (2^-9 relative) moves the sources by
# about 1e-3 and the scores by about 5e-3.
SCORE_TOLERANCE, SOURCE_TOLERANCE, STATE_TOLERANCE = 1e-3, 1e-5, 1e-5


def model_and_weights(chunks: torch.Tensor, duration: float = 2.0):
    """The model and its weights, the classifier's logits over ``chunks``
    centred on their median and scaled to a spread of 1.5 (at init the
    scores are a near tie, 0.5 within about 1e-2)."""
    weights = draw(reference.leaves(SPEC), generator(7, 1, "cpu"), "cpu")
    reference.finish(weights)
    with torch.inference_mode():
        pooled, _ = reference.forward(SPEC, weights, chunks,
                                      Numerics("float32"), features=True)
        logits = reference.head(pooled, weights, HPARAMS).double()
    gain = float(1.5 / logits.std())
    weights["classifier.weight"] = weights["classifier.weight"] * gain
    weights["classifier.bias"] = (weights["classifier.bias"]
                                  - float(logits.median())) * gain
    model = ToTaToNet(
        encoder_decoder=HPARAMS["encoder_decoder"],
        linear=HPARAMS["linear"], diar=HPARAMS["diar"],
        dprnn=HPARAMS["dprnn"], n_sources=3, use_wavlm=True,
        wavlm_config=SSL,
        specifications=default_specifications(3, duration)).eval()
    model.load_reference_state_dict(weights)
    return model, weights


@pytest.fixture(scope="module")
def chunks():
    g = torch.Generator().manual_seed(11)
    t = torch.arange(2 * SR) / SR
    voice = 0.2 * torch.sin(2 * np.pi * 140.0 * t) * (
        0.5 + 0.5 * torch.sin(2 * np.pi * 3.0 * t).abs())
    return (voice + 0.02 * torch.randn(3, 2 * SR, generator=g))[:, None]


def test_totatonet_with_wavlm_matches_the_plain_reference(chunks):
    model, weights = model_and_weights(chunks)
    with torch.inference_mode():
        scores, sources = model(chunks)
        theirs = reference.forward(SPEC, weights, chunks,
                                   Numerics("float32"))
        state = model.wavlm(chunks)[-1]
        their_state = reference.ssl_output(SPEC, weights, chunks[:, 0],
                                           Numerics("float32"))
    assert scores.shape == theirs[0].shape == (3, 249, 3)
    assert sources.shape == theirs[1].shape == (3, 2 * SR, 3)
    assert float((scores - theirs[0]).abs().max()) < SCORE_TOLERANCE
    assert reference.relative_l2(sources, theirs[1]) < SOURCE_TOLERANCE
    assert float(reference.unit_gap(state, their_state).max()) < \
        STATE_TOLERANCE
    # the scores are no near tie: the comparison sees the head's work
    assert float(scores.std()) > 0.1


def test_a_bf16_wavlm_state_breaks_the_tolerance(chunks, monkeypatch):
    model, weights = model_and_weights(chunks)
    original = model.wavlm.forward

    def rounded(*args, **kwargs):
        states = original(*args, **kwargs)
        states[-1] = states[-1].to(torch.bfloat16).float()
        return states
    monkeypatch.setattr(model.wavlm, "forward", rounded)
    with torch.inference_mode():
        scores, sources = model(chunks)
        theirs = reference.forward(SPEC, weights, chunks,
                                   Numerics("float32"))
    assert reference.relative_l2(sources, theirs[1]) > SOURCE_TOLERANCE
    assert float((scores - theirs[0]).abs().max()) > SCORE_TOLERANCE


def masks(n: int, seed: int):
    rng = np.random.default_rng(seed)
    runs = np.zeros(n, dtype=bool)
    t = 0
    while t < n:
        length = int(rng.integers(1, 400))
        runs[t:t + length] = rng.random() < 0.4
        t += length + int(rng.integers(1, 600))
    ends = np.zeros(n, dtype=bool)
    ends[:3] = ends[-5:] = True
    return {"seeded": runs, "sparse": rng.random(n) < 0.002,
            "both ends": ends, "empty": np.zeros(n, dtype=bool),
            "full": np.ones(n, dtype=bool)}


@pytest.mark.parametrize("collar", [0, 1, 2, 1600])
@pytest.mark.parametrize("kind", ["seeded", "sparse", "both ends", "empty",
                                  "full"])
def test_dilate_is_scipys_binary_dilation(collar, kind):
    active = masks(20000, collar)[kind]
    expected = active if collar == 0 else binary_dilation(
        active, structure=np.ones(2 * collar))
    assert np.array_equal(dilate(active, collar), expected)


def scipy_leakage_mask(sources, diarization, collar):
    """``apply_leakage_mask`` as the port computed it before: scipy's
    dilation of each speaker's activity."""
    num_samples, num_clusters = sources.shape
    out = sources.copy()
    for k in range(num_clusters):
        active = np.zeros(num_samples, dtype=bool)
        for segment, _, label in diarization.itertracks(yield_label=True):
            if label == k:
                active[max(0, int(segment.start * SR)):
                       min(num_samples, int(segment.end * SR))] = True
        if collar > 0:
            active = binary_dilation(active, structure=np.ones(2 * collar))
        out[~active, k] = 0.0
    return out


@pytest.mark.parametrize("collar_s", [0.0, 1 / SR, 2 / SR, 0.1])
def test_apply_leakage_mask_is_the_scipy_mask(collar_s):
    rng = np.random.default_rng(5)
    num_samples = 3 * SR
    diarization = Annotation(uri="leak")
    diarization[Segment(0.0, 0.4)] = 0
    diarization[Segment(0.9, 1.7)] = 1
    diarization[Segment(1.2, 2.1)] = 0
    diarization[Segment(2.5, 3.5)] = 1       # past the end
    sources = rng.standard_normal((num_samples, 3)).astype(np.float32)
    ours = apply_leakage_mask(sources, diarization, SR,
                              asr_collar=collar_s)
    assert np.array_equal(ours, scipy_leakage_mask(
        sources, diarization, int(round(collar_s * SR))))
    assert not ours[:, 2].any()


ORDER = ["separate", "embedding", "clustering", "reconstruct",
         "overlap_add", "leakage"]


@pytest.fixture(scope="module")
def separation_file(tmp_path_factory):
    rng = np.random.default_rng(3)
    t = np.arange(9 * SR) / SR
    wav = 0.003 * rng.standard_normal(len(t))
    for start, end, f0 in ((0.5, 3.0, 110.0), (2.5, 5.5, 260.0),
                           (6.0, 8.5, 170.0)):
        on = (t >= start) & (t < end)
        wav[on] += 0.2 * np.sin(2 * np.pi * f0 * t[on])
    path = tmp_path_factory.mktemp("separation") / "mix.wav"
    write_wav(path, wav.astype(np.float32)[None], SR)
    return {"audio": str(path), "uri": "mix"}


def test_a_recorded_separation_has_its_spans_and_counters(chunks,
                                                         separation_file):
    model, _ = model_and_weights(chunks)
    embedding = WeSpeakerResNet34(num_blocks=(1, 1, 1, 1), m_channels=8,
                                  compute_dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(2))
    pipeline = SpeechSeparation(model, embedding, segmentation_batch_size=4,
                                embedding_batch_size=4, device="cpu")
    pipeline.instantiate(pipeline.default_parameters())
    off = pipeline(dict(separation_file))
    with spans.recording() as rec:
        on = pipeline(dict(separation_file))
    assert np.array_equal(off.sources, on.sources)
    assert off.speaker_diarization == on.speaker_diarization
    closed = rec.closed()
    top = [s for s in closed if s.parent is not None
           and s.parent.name in spans.CALLS]
    assert [s.path for s in top] == ORDER
    assert all(s.uri == "mix" for s in closed)
    for a, b in zip(top, top[1:]):
        assert a.end_ns <= b.start_ns
    wait = [s for s in closed if s.name == "overlap_add_wait"]
    assert len(wait) == 1 and wait[0].wait
    assert wait[0].path == "overlap_add/overlap_add_wait"
    assert wait[0].parent.start_ns <= wait[0].start_ns <= \
        wait[0].end_ns <= wait[0].parent.end_ns
    # 9 s of 2-s chunks every 0.2 s
    chunks = 1 + (9 * SR - 2 * SR) // (SR // 5)
    assert rec.counters == {"separated_chunks": chunks,
                            "chunk_sources_peak_bytes":
                                chunks * 2 * SR * 3 * 4}
    # off the card there are no device units
    assert rec.units == []


def test_counter_totals_sum_and_keep_peaks():
    """``tools/pipeline_spans.py``'s reader of several recordings'
    counters: the chunk counts summed, the peak bytes the largest."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "tools" / \
        "pipeline_spans.py"
    spec = importlib.util.spec_from_file_location("pipeline_spans", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    recordings = []
    for chunks, peak in ((10, 300), (7, 900), (5, 200)):
        with spans.recording() as rec:
            spans.counter("separated_chunks", chunks)
            spans.counter("chunk_sources_peak_bytes", peak, peak=True)
            spans.counter("chunk_sources_peak_bytes", peak // 2, peak=True)
        recordings.append(rec)
    assert tool.counter_totals(recordings) == {
        "separated_chunks": 22, "chunk_sources_peak_bytes": 900}
    # off, a counter records nothing and raises nothing
    spans.counter("separated_chunks", 3)
