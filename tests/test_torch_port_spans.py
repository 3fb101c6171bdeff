"""The port's span recorder (``telemetry/spans.py``) and the spans of the
diarization pipeline, on the CPU; one case on the card.

Held:
- off, ``span`` hands back the one shared no-op and nothing is recorded;
- recording changes no result: ``apply_batch``'s Annotations and
  centroids are equal with the recorder on and off (AHC and VBx);
- on, each file has one ``stage`` and one ``finalize`` span with its uri,
  children lie within their parents, every wait lies inside ``finalize``
  or right under the ``apply_batch`` call, and ``clustering`` has its
  ``linkage`` / ``vbx`` / ``assign`` children (``linkage`` / ``assign``
  for AHC);
- a span's path leaves out the call spans: one file through ``__call__``
  and a direct ``_stage`` / ``_finalize`` give the same paths;
- under a CPU-only profile each span's ``record_function`` range and its
  recorded interval agree within ``PROFILER_TOLERANCE_NS`` once the
  recording's wall-clock offset is added;
- the readers (totals here, self time, labels, idle gaps and share in
  ``tools/pipeline_spans.py``) give known values on a recording made on a
  fake clock;
- on the card (``cuda``), the device units of a list do not overlap and
  lie within the list's wall.

The models are the port's own, drawn from a seed (no JAX), so the file
also runs on the card.
"""

import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pyannote_audio_tpu_torch.core.io import write_wav
from pyannote_audio_tpu_torch.core.model import Specifications
from pyannote_audio_tpu_torch.core.plda import PLDA
from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
    WeSpeakerResNet34
from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from pyannote_audio_tpu_torch.telemetry import spans

SR = 16000
CLUSTERINGS = ("AgglomerativeClustering", "VBxClustering")
WAITS = {"decode_wait", "staged_wait", "reconstruct_wait"}
# a span's range opens just before its recorded start and closes just
# after its recorded end; a loaded CPU may hold the thread in between
PROFILER_TOLERANCE_NS = 2_000_000


def load_tool():
    """``tools/pipeline_spans.py``, where the readers of a recording
    live."""
    path = Path(__file__).resolve().parent.parent / "tools" / \
        "pipeline_spans.py"
    spec = importlib.util.spec_from_file_location("pipeline_spans", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tool = load_tool()


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def voices(seconds: float, seed: int) -> np.ndarray:
    """(1, samples) float32: a noise floor and turns of three harmonic
    voices with a syllable-rate envelope."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    wav = 0.003 * rng.standard_normal(n)
    start, k = 0.5, 0
    while start < seconds:
        length = rng.uniform(1.0, 3.0)
        i0, i1 = int(start * SR), min(n, int((start + length) * SR))
        f0 = (110.0, 170.0, 260.0)[k % 3]
        tt = t[i0:i1]
        wav[i0:i1] += 0.2 * np.sin(2 * np.pi * f0 * tt) * (
            0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 4 * tt)))
        start += length + rng.uniform(0.2, 1.0)
        k += 1 + int(rng.integers(0, 2))
    return wav.astype(np.float32)[None]


def plda(seed: int = 11, dim: int = 256, lda_dim: int = 32) -> PLDA:
    rng = np.random.default_rng(seed)
    return PLDA(mean1=rng.standard_normal(dim) * 0.01,
                mean2=rng.standard_normal(lda_dim) * 0.01,
                lda=rng.standard_normal((dim, lda_dim)) * 0.1,
                plda_mu=rng.standard_normal(lda_dim) * 0.01,
                plda_tr=np.linalg.qr(rng.standard_normal((lda_dim,
                                                          lda_dim)))[0],
                plda_psi=np.abs(rng.standard_normal(lda_dim)) + 0.5)


def make_pipeline(clustering: str, device="cpu") -> SpeakerDiarization:
    """Small seeded models; the classifier's weights scaled up so that the
    powerset classes change with the voices and every file has speech."""
    g = torch.Generator().manual_seed(3)
    seg = PyanNet(Specifications(duration=5.0, classes=["a", "b", "c"],
                                 powerset_max_classes=2),
                  lstm_hidden=16, linear_hidden=16, lstm_layers=1,
                  generator=g)
    with torch.no_grad():
        seg.classifier.weight.mul_(30.0)
    emb = WeSpeakerResNet34(num_blocks=(1, 1, 1, 1), m_channels=8,
                            compute_dtype=torch.float32, generator=g)
    pipeline = SpeakerDiarization(
        seg, emb, clustering=clustering,
        plda=plda() if clustering == "VBxClustering" else None,
        segmentation_batch_size=8, embedding_batch_size=8, device=device)
    if clustering == "AgglomerativeClustering":
        pipeline.instantiate({"segmentation": {"min_duration_off": 0.0},
                              "clustering": {"method": "centroid",
                                             "min_cluster_size": 3,
                                             "threshold": 0.7}})
    return pipeline


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    out = []
    for i, seconds in enumerate((14.0, 17.3, 12.5)):
        path = root / f"f{i}.wav"
        write_wav(path, voices(seconds, i), SR)
        out.append({"audio": str(path), "uri": f"f{i}"})
    return out


@pytest.fixture(scope="module", params=CLUSTERINGS)
def recorded(request, files):
    """(clustering, pipeline, outputs with the recorder off, outputs and
    recording with it on) of one list of three files."""
    pipeline = make_pipeline(request.param)
    off = pipeline([dict(f) for f in files])
    with spans.recording() as rec:
        on = pipeline([dict(f) for f in files])
    return request.param, pipeline, off, on, rec


def recording_on() -> bool:
    return spans.span("probe") is not spans.OFF


def ancestors(s):
    while s.parent is not None:
        s = s.parent
        yield s


# -- off --------------------------------------------------------------------

def test_off_hands_back_the_shared_noop(files):
    assert not recording_on()
    assert spans.span("stage") is spans.OFF
    assert spans.span("decode_wait", files[0], wait=True) is spans.OFF
    with spans.span("stage") as s:
        assert s is spans.OFF
    assert spans.device_mark(torch.device("cpu")) is None
    with spans.recording() as rec:
        assert recording_on()
        assert spans.device_mark(torch.device("cpu")) is None
    make_pipeline("AgglomerativeClustering")([dict(files[0])])
    assert rec.spans == [] and rec.units == []
    assert not recording_on()


def test_a_recording_inside_another_is_that_recording():
    with spans.recording() as outer:
        with spans.recording() as inner:
            with spans.span("stage"):
                pass
        assert inner is outer and recording_on()
        with spans.span("finalize"):
            pass
    assert not recording_on()
    assert [s.path for s in outer.spans] == ["stage", "finalize"]


# -- the pipeline's spans -----------------------------------------------------

def test_recording_changes_no_result(recorded):
    _, _, off, on, _ = recorded
    assert len(off) == len(on) == 3
    for a, b in zip(off, on):
        for name in ("speaker_diarization", "exclusive_speaker_diarization"):
            x, y = getattr(a, name), getattr(b, name)
            assert list(x.itertracks(yield_label=True)) == \
                list(y.itertracks(yield_label=True))
        np.testing.assert_array_equal(a.speaker_embeddings,
                                      b.speaker_embeddings)
    assert all(len(a.speaker_diarization.labels()) >= 2 for a in on)


def test_each_file_has_one_stage_and_one_finalize(recorded, files):
    _, _, _, _, rec = recorded
    closed = rec.closed()
    assert closed == rec.spans
    assert {s.thread for s in closed} == {threading.get_ident()}
    calls = [s for s in closed if s.name == "apply_batch"]
    assert len(calls) == 1 and calls[0].parent is None
    for f in files:
        for path in ("stage", "finalize"):
            assert [s.uri for s in closed if s.path == path].count(
                f["uri"]) == 1
    for s in closed:
        if s.parent is None:
            continue
        assert s.parent.start_ns <= s.start_ns <= s.end_ns <= \
            s.parent.end_ns
        if s.parent.uri is not None:
            assert s.uri == s.parent.uri
    for path in ("stage/segmentation", "stage/embedding",
                 "finalize/clustering", "finalize/reconstruct",
                 "finalize/reconstruct/reconstruct_wait",
                 "finalize/annotate", "decode_wait"):
        assert {s.uri for s in closed if s.path == path} == \
            {f["uri"] for f in files}, path


def test_waits_lie_inside_finalize_or_under_apply_batch(recorded):
    _, _, _, _, rec = recorded
    waits = [s for s in rec.closed() if s.wait]
    assert {s.name for s in waits} <= WAITS
    assert {s.name for s in waits} >= {"decode_wait", "reconstruct_wait"}
    for s in waits:
        names = [a.name for a in ancestors(s)]
        assert "finalize" in names or names == ["apply_batch"], s
    assert not any(s.wait for s in rec.closed() if s.name not in WAITS)


def test_clustering_has_its_children(recorded):
    clustering, _, _, _, rec = recorded
    expected = {"linkage", "vbx", "assign"} \
        if clustering == "VBxClustering" else {"linkage", "assign"}
    parents = [s for s in rec.closed() if s.path == "finalize/clustering"]
    assert len(parents) == 3
    for parent in parents:
        children = [s for s in rec.closed() if s.parent is parent]
        assert sorted(s.name for s in children) == sorted(expected)
        assert {s.path for s in children} == \
            {f"finalize/clustering/{name}" for name in expected}


def test_paths_leave_out_the_call(files):
    pipeline = make_pipeline("VBxClustering")
    with spans.recording() as rec:
        pipeline(dict(files[0]))
    one = [s.path for s in rec.closed()]
    assert one[0] == "apply" and rec.spans[0].parent is None
    with spans.recording() as rec:
        f = dict(files[0])
        pipeline._decode_into(f, False)
        pipeline._finalize(pipeline._stage(f))
    assert [s.path for s in rec.closed()] == one[1:]
    assert "finalize/clustering/vbx" in one


def test_totals_and_self_time_of_finalize(recorded):
    _, _, _, _, rec = recorded
    totals = rec.totals()
    children = ("finalize/clustering", "finalize/reconstruct",
                "finalize/annotate", "finalize/staged_wait")
    inside = sum(totals.get(path, 0.0) for path in children)
    assert tool.self_seconds(rec, "finalize") == pytest.approx(
        totals["finalize"] - inside, abs=1e-9)
    assert 0.0 <= tool.self_seconds(rec, "finalize") < totals["finalize"]


# -- the profiler's clock ----------------------------------------------------

def test_profiler_ranges_agree_with_spans(files):
    pipeline = make_pipeline("VBxClustering")
    pipeline([dict(files[0])])                                   # warm
    with spans.recording() as rec:
        with spans.span("before"):
            pass
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            pipeline([dict(f) for f in files[:2]])
        with spans.span("after"):
            pass
    ranged = [s for s in rec.closed() if s.ranged]
    assert {s.path for s in rec.closed() if not s.ranged} == \
        {"before", "after"}
    # the k-th span of a path against the k-th range of that name
    events = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            events.setdefault(e.name, []).append(e)
    pairs = []
    for path in {s.path for s in ranged}:
        mine = [s for s in ranged if s.path == path]
        found = sorted(events.get(path, []), key=lambda e: e.time_range.start)
        assert len(found) == len(mine), path
        pairs.extend(zip(mine, found))
    assert len(pairs) == len(ranged) > 20
    assert len(tool.profiler_pairs(rec, prof)) == len(pairs)
    # the profiler's clock is the wall clock, counted from the trace's start
    offset = rec.wall_profiler_offset(prof)
    for s, event in pairs:
        start = (s.start_ns + offset) * 1e-3
        end = (s.end_ns + offset) * 1e-3
        assert abs(start - event.time_range.start) * 1e3 <= \
            PROFILER_TOLERANCE_NS, (s, event.time_range)
        assert abs(end - event.time_range.end) * 1e3 <= \
            PROFILER_TOLERANCE_NS, (s, event.time_range)


# -- the readers, on a fake clock ---------------------------------------------

class FakeClock:
    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        return self.now

    time_ns = perf_counter_ns


def test_readers_on_a_fake_clock(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(spans, "time", clock)

    def at(ns):
        clock.now = ns

    with spans.recording() as rec:
        with spans.span("apply_batch"):
            with spans.span("finalize", "a"):                     # 0-100
                with spans.span("staged_wait", wait=True):        # 0-40
                    at(40)
                with spans.span("clustering"):                    # 40-90
                    at(50)
                    with spans.span("vbx"):                       # 50-70
                        at(70)
                    at(90)
                at(100)
            with spans.span("stage", "b"):                        # 100-130
                at(130)
    rec.units.extend([spans.Unit("stage", "a", 0, 0, 45),
                      spans.Unit("reconstruct", "a", 0, 60, 65),
                      spans.Unit("stage", "b", 0, 110, 130)])
    totals = rec.totals()
    assert totals["finalize"] == pytest.approx(100e-9)
    assert totals["finalize/clustering/vbx"] == pytest.approx(20e-9)
    assert tool.self_seconds(rec, "finalize") == pytest.approx(10e-9)
    assert tool.self_seconds(rec, "finalize/clustering") == \
        pytest.approx(30e-9)
    assert rec.totals(100, 130) == {"stage": pytest.approx(30e-9)}
    assert {s.uri for s in rec.closed() if s.path.startswith("finalize")} \
        == {"a"}
    # the innermost span that covers more than half of the stretch
    assert tool.label(rec, 50, 70) == "finalize/clustering/vbx"
    assert tool.label(rec, 45, 55) == "finalize/clustering"      # vbx: a half
    assert tool.label(rec, 60, 80) == "finalize/clustering"
    assert tool.label(rec, 95, 102) == "finalize"
    assert tool.label(rec, 95, 105) == "apply_batch"       # finalize: a half
    # none covers half: the one that covers most, the innermost of equals
    assert tool.label(rec, -60, 10) == "finalize/staged_wait"
    assert tool.label(rec, -60, 45) == "finalize"
    assert tool.label(rec, 200, 300) is None
    # idle: 45-60 (vbx covers 10 of 15), 65-110 (clustering 25 of 45, the
    # innermost of those over a half), 130-150 (after every span)
    gaps = tool.idle_gaps(rec, 0, 150)
    assert [g[0] for g in gaps] == ["finalize/clustering",
                                    "outside the spans",
                                    "finalize/clustering/vbx"]
    assert [g[1] for g in gaps] == pytest.approx([45e-9, 20e-9, 15e-9])
    assert tool.busy_ns(rec, 0, 150) == 45 + 5 + 20
    assert tool.idle_share(rec, 0, 150) == pytest.approx(100.0 * 80 / 150)
    assert tool.idle_share(rec, 0, 0) is None
    assert tool.idle_share(spans.Recording(), 0, 10) is None


def test_idle_gaps_reach_the_window_edges():
    rec = spans.Recording()
    rec.units.append(spans.Unit("stage", "a", 0, 20, 30))
    assert [g[1] for g in tool.idle_gaps(rec, 0, 50)] == pytest.approx(
        [20e-9, 20e-9])
    assert tool.idle_gaps(rec, 22, 28) == []
    assert tool.idle_share(rec, 22, 28) == 0.0


# -- the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_device_units_do_not_overlap_and_lie_within_the_wall(files):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the units are CUDA events")
    device = torch.device("cuda", 0)
    pipeline = make_pipeline("VBxClustering", device=device)
    pipeline([dict(f) for f in files])                           # warm
    torch.cuda.synchronize()
    with spans.recording() as rec:
        begin = time.perf_counter_ns()
        pipeline([dict(f) for f in files])
        torch.cuda.synchronize()
        end = time.perf_counter_ns()
    units = rec.units
    assert sorted((u.uri, u.name) for u in units) == sorted(
        (f["uri"], name) for f in files for name in ("stage", "reconstruct"))
    # the anchors' host times are midpoints of a record and a wait
    slack = 100_000
    for u in units:
        assert begin - slack <= u.start_ns < u.end_ns <= end + slack, u
    for a, b in zip(units, units[1:]):
        assert a.end_ns <= b.start_ns + 2_000, (a, b)
    assert 0.0 <= tool.idle_share(rec, begin, end) < 100.0
    stage = [s for s in rec.closed() if s.path == "stage"]
    for u in units:
        if u.name == "stage":
            mine = next(s for s in stage if s.uri == u.uri)
            # a unit starts when the stream reaches it, after its _stage
            # began queueing it
            assert u.start_ns >= mine.start_ns - slack
