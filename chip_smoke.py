"""Run the PyTorch/CUDA port's diarization main path on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: torch and CUDA versions, the card's name and power
     limit; TF32 is switched off for matmuls and convolutions;
  2. build every kernel of the path from the sources in this checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at ragged ones, with kernel and plain times;
  4. the slice end to end: SpeakerDiarization with full-width PyanNet and
     WeSpeaker ResNet34 (seeded random weights) at bench.py's settings,
     first held against the same pipeline on the CPU on a short file,
     then timed on two synthetic PCM16 WAV files of 10 and 3 minutes,
     with the kernel launch counter showing that PyanNet's LSTM ran
     through the kernel.

The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SAMPLE_RATE = 16000
FILE_MINUTES = (10.0, 3.0)
BATCH_SIZE = 256
PARAMS = {"segmentation": {"min_duration_off": 0.0},
          "clustering": {"method": "centroid", "threshold": 0.6,
                         "min_cluster_size": 1}}
KERNEL_ATOL = 1e-4
# the same pipeline on the CPU (plain LSTM, CPU convolutions) on a short
# file: float32 sums in another order through 589 recurrent steps
REFERENCE_LOGP_ATOL = 1e-3
REFERENCE_EMBEDDING_RTOL = 1e-3


def log(message: str) -> None:
    print(message, flush=True)


def synth(minutes: float, seed: int) -> np.ndarray:
    """Synthetic "conversation": harmonic speakers + silences, PCM16-exact
    (the recipe of the JAX package's bench.py)."""
    rng = np.random.default_rng(seed)
    n = int(minutes * 60 * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    wav = 0.003 * rng.standard_normal(n).astype(np.float32)
    segment = 5.0
    for i, start in enumerate(np.arange(0.0, minutes * 60 - segment, 7.0)):
        f0 = [140.0, 210.0, 320.0][(i + seed) % 3]
        i0, i1 = int(start * SAMPLE_RATE), int((start + segment)
                                               * SAMPLE_RATE)
        tt = t[i0:i1]
        wav[i0:i1] += (0.2 * np.sin(2 * np.pi * f0 * tt)
                       * (0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 3 * tt)))
                       ).astype(np.float32)
    return np.round(wav * 32768.0).clip(-32768, 32767).astype(
        np.float32) / np.float32(32768.0)


def cuda_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def segmentation_batches() -> list:
    """Batch sizes the main path gives PyanNet, file after file."""
    from pyannote_audio_tpu_torch.core.inference import _chunk_grid
    sizes = []
    for minutes in FILE_MINUTES:
        starts, _ = _chunk_grid(int(minutes * 60 * SAMPLE_RATE),
                                10 * SAMPLE_RATE, SAMPLE_RATE)
        sizes += [min(BATCH_SIZE, len(starts) - b)
                  for b in range(0, len(starts), BATCH_SIZE)]
    return sizes


def phase_environment() -> str:
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = card.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls (torch.backends.cuda.matmul.allow_tf32) and "
        "convolutions (torch.backends.cudnn.allow_tf32)")
    return card


def phase_build() -> None:
    from pyannote_audio_tpu_torch.utils.build import build
    info = build("lstm_recurrence")
    log(f"built {info['path'].name} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())


def phase_kernels(device: torch.device) -> dict:
    """LSTM kernel vs its plain version; returns the kernel's record."""
    from pyannote_audio_tpu_torch.ops.lstm import \
        lstm_bidirectional_recurrence_plain
    from pyannote_audio_tpu_torch.ops.lstm_kernel import \
        lstm_bidirectional_recurrence

    gen = torch.Generator().manual_seed(0)

    def layer_inputs(T, B, D_in, H, D):
        """xw as the main path makes it: x @ W_ih^T + b, x ~ N(0, 1)."""
        bound = H ** -0.5
        x = torch.randn(T, B, D_in, generator=gen)
        w_ih = (torch.rand(D * 4 * H, D_in, generator=gen) * 2 - 1) * bound
        b = (torch.rand(D * 4 * H, generator=gen) * 2 - 1) * 2 * bound
        w_hh = (torch.rand(D, 4 * H, H, generator=gen) * 2 - 1) * bound
        x, w_ih, b, w_hh = (t.to(device) for t in (x, w_ih, b, w_hh))
        return (x @ w_ih.t() + b).contiguous(), w_hh

    # PyanNet on 10 s chunks: T = 589 frames, B = every batch size of the
    # main path (256 and each file's tail), H = 128; layer 0 reads
    # SincNet's 60 features, layer 1 the 256 of layer 0
    shapes = [(f"main B={B} layer {layer}", 589, B, D_in, 128, 2)
              for B in sorted(set(segmentation_batches()), reverse=True)
              for layer, D_in in enumerate((60, 256))]
    shapes += [("B=1 T=1 H=8", 1, 1, 5, 8, 2),
              ("H=96", 33, 4, 60, 96, 2),
              ("B=3", 40, 3, 60, 128, 2),
              ("H=8 one direction", 17, 5, 60, 8, 1)]
    worst = 0.0
    for name, T, B, D_in, H, D in shapes:
        xw, w_hh = layer_inputs(T, B, D_in, H, D)
        out = lstm_bidirectional_recurrence(xw, w_hh)
        torch.cuda.synchronize()
        ref = lstm_bidirectional_recurrence_plain(xw, w_hh)
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        log(f"lstm_recurrence {name}: xw {tuple(xw.shape)} -> "
            f"{tuple(out.shape)}, max_abs_err {err:.3e}")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"LSTM kernel disagrees with its plain "
                                 f"version at {name}: {err} > {KERNEL_ATOL}")

    xw, w_hh = layer_inputs(589, 256, 256, 128, 2)
    plain_ms = cuda_ms(lambda: lstm_bidirectional_recurrence_plain(xw, w_hh),
                       runs=5)
    kernel_ms = cuda_ms(lambda: lstm_bidirectional_recurrence(xw, w_hh),
                        runs=20)
    plain_ms_2 = cuda_ms(
        lambda: lstm_bidirectional_recurrence_plain(xw, w_hh), runs=5)
    log(f"lstm_recurrence at (589, 256, 1024) -> (589, 256, 256): kernel "
        f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} / {plain_ms_2:.3f} ms "
        f"(median of 20 and of 5 runs, before and after)")
    return {"name": "lstm_recurrence", "route": "cuda",
            "source": "pyannote_audio_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": "pyannote_audio_tpu/ops/pallas_lstm.py:100",
            "launches": None, "max_abs_err": worst, "ms": kernel_ms,
            "plain_ms": min(plain_ms, plain_ms_2)}


def build_pipeline(segmentation, embedding, device):
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    pipeline = SpeakerDiarization(
        segmentation=segmentation, embedding=embedding,
        clustering="AgglomerativeClustering",
        segmentation_batch_size=BATCH_SIZE, embedding_batch_size=BATCH_SIZE,
        device=device)
    return pipeline.instantiate(PARAMS)


def traced_run(pipeline, file: dict):
    """Run ``pipeline`` on ``file`` and keep what its stages decided: the
    hard segmentation (C, F, S), the hard clusters (C, S) and the
    reconstructed (frames, speakers) matrices, normal and exclusive."""
    seen = {"binary": []}
    slide, cluster = pipeline._segmentation.slide, pipeline.clustering
    to_annotation = pipeline.to_annotation

    def slide_(*args, **kwargs):
        out = slide(*args, **kwargs)
        seen["scores"] = out.data.cpu().numpy()
        seen["window"] = out.sliding_window
        return out

    def cluster_(*args, **kwargs):
        out = cluster(*args, **kwargs)
        seen["clusters"] = np.array(out[0])
        return out

    def to_annotation_(binarized, **kwargs):
        seen["binary"].append(binarized.data)
        return to_annotation(binarized, **kwargs)

    pipeline._segmentation.slide = slide_
    pipeline.clustering = cluster_
    pipeline.to_annotation = to_annotation_
    try:
        out = pipeline(dict(file), max_speakers=4)
    finally:
        del pipeline._segmentation.slide, pipeline.to_annotation
        pipeline.clustering = cluster
    return out, seen


def check_against_cpu(pipeline, cpu_pipeline, device) -> None:
    """The card's pipeline against the same weights on the CPU, on 30 s.

    PyanNet's log-probabilities are held on every chunk of the file, the
    embeddings on 8 chunks. Float32 sums in another order can flip the
    powerset argmax where two classes tie within the log-prob error; each
    such flip must be a near tie, the hard clusters must be equal, and the
    reconstructed speaker frames may differ only at the output frames
    that a flip feeds. Without a flip, both Annotations must have the same
    tracks with boundaries within one frame.
    """
    from pyannote_audio_tpu_torch.core.inference import chunk_views
    wav = synth(0.5, seed=7)[None]
    waveform = torch.from_numpy(wav)
    chunks = chunk_views(waveform, 10 * SAMPLE_RATE, SAMPLE_RATE)
    seg_gpu = pipeline._segmentation.model
    seg_cpu = cpu_pipeline._segmentation.model
    emb_gpu, emb_cpu = pipeline._embedding, cpu_pipeline._embedding
    masks = (torch.rand(8, 3, 589, generator=torch.Generator()
                        .manual_seed(1)) > 0.5).float()
    with torch.inference_mode():
        logp = seg_gpu(chunks.contiguous().to(device)).cpu()
        logp_ref = seg_cpu(chunks.contiguous())
        emb = emb_gpu.embed(emb_gpu.frames(chunks[:8].contiguous()
                                           .to(device)),
                            masks.to(device)).cpu()
        emb_ref = emb_cpu.embed(emb_cpu.frames(chunks[:8].contiguous()),
                                masks)
    logp_err = (logp - logp_ref).abs().max().item()
    emb_err = ((emb - emb_ref).abs().max() / emb_ref.abs().max()).item()
    log(f"card vs CPU: PyanNet log-prob max_abs_err {logp_err:.3e} on "
        f"{len(chunks)} chunks (limit {REFERENCE_LOGP_ATOL}), embedding "
        f"max relative err {emb_err:.3e} on 8 chunks (limit "
        f"{REFERENCE_EMBEDDING_RTOL})")
    if not (logp.shape == (len(chunks), 589, 7)
            and torch.isfinite(logp).all()
            and logp_err <= REFERENCE_LOGP_ATOL):
        raise AssertionError("PyanNet on the card disagrees with the CPU")
    if not (emb.shape == (8, 3, 256) and torch.isfinite(emb).all()
            and emb_err <= REFERENCE_EMBEDDING_RTOL):
        raise AssertionError("ResNet34 on the card disagrees with the CPU")

    file = {"waveform": wav, "sample_rate": SAMPLE_RATE, "uri": "short"}
    out, ours = traced_run(pipeline, file)
    ref, theirs = traced_run(cpu_pipeline, file)
    flips = np.argwhere((ours["scores"] != theirs["scores"]).any(-1))
    top_gpu = logp.argmax(-1)
    top_cpu = logp_ref.argmax(-1)
    margins = [(logp_ref[c, f, top_cpu[c, f]]
                - logp_ref[c, f, top_gpu[c, f]]).item() for c, f in flips]
    log(f"card vs CPU pipeline on 30 s: {len(flips)} of "
        f"{top_cpu.numel()} chunk frames flip their powerset class, CPU "
        f"margins {['%.3e' % m for m in margins]}")
    if max(margins, default=0.0) > 2 * logp_err:
        raise AssertionError("a segmentation flip is not a near tie")
    if not np.array_equal(ours["clusters"], theirs["clusters"]):
        raise AssertionError(f"hard clusters differ: {ours['clusters']} "
                             f"vs {theirs['clusters']}")
    frames = seg_gpu.receptive_field
    offsets, _, _ = pipeline._aggregation_grid(
        ours["window"], frames, len(ours["scores"]))
    fed = {int(offsets[c] + f) for c, f in flips}
    for name, a, b in zip(("normal", "exclusive"), ours["binary"],
                          theirs["binary"]):
        differ = np.flatnonzero((a != b).any(-1)) if a.shape == b.shape \
            else None
        if differ is None or not set(differ.tolist()) <= fed:
            raise AssertionError(f"{name} reconstruction differs beyond "
                                 f"the flipped frames: {differ}")
        log(f"  {name} reconstruction: {len(differ)} of {len(a)} output "
            f"frames differ, none beyond the flipped frames")
    a = list(out.speaker_diarization.itertracks(yield_label=True))
    b = list(ref.speaker_diarization.itertracks(yield_label=True))
    log(f"  {len(a)} vs {len(b)} segments, labels "
        f"{out.speaker_diarization.labels()} vs "
        f"{ref.speaker_diarization.labels()}")
    if not a:
        raise AssertionError("empty diarization of the short file")
    if not len(flips) and not (len(a) == len(b) and all(
            la == lb and abs(sa.start - sb.start) <= frames.step
            and abs(sa.end - sb.end) <= frames.step
            for (sa, _, la), (sb, _, lb) in zip(a, b))):
        raise AssertionError("the pipeline on the card disagrees with the "
                             "CPU on the short file")


def phase_slice(device: torch.device, workdir: Path) -> int:
    from pyannote_audio_tpu_torch.core.annotation import Annotation
    from pyannote_audio_tpu_torch.core.io import write_wav
    from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
        WeSpeakerResNet34
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    from pyannote_audio_tpu_torch.ops.lstm_kernel import \
        lstm_bidirectional_recurrence

    # full published widths: sinc stride 10, BiLSTM 2 x 128, 2 x Linear
    # 128, 7 powerset classes; ResNet34 (3, 4, 6, 3) x 32 channels, 80 mel
    # bins, 256-d embeddings. Seed 1 gives a random PyanNet that marks
    # speech (most seeds' random heads settle on one class everywhere).
    segmentation = PyanNet(generator=torch.Generator().manual_seed(1))
    embedding = WeSpeakerResNet34(generator=torch.Generator().manual_seed(2))
    cpu_pipeline = build_pipeline(copy.deepcopy(segmentation),
                                  copy.deepcopy(embedding), "cpu")
    pipeline = build_pipeline(segmentation, embedding, device)
    check_against_cpu(pipeline, cpu_pipeline, device)
    del cpu_pipeline

    paths = []
    for k, minutes in enumerate(FILE_MINUTES):
        path = workdir / f"synth_{k}.wav"
        write_wav(path, synth(minutes, seed=k)[None], SAMPLE_RATE)
        paths.append(path)
    files = [{"audio": str(p), "uri": p.stem} for p in paths]
    batches = len(segmentation_batches())

    lstm_bidirectional_recurrence.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    outputs = pipeline([dict(f) for f in files], max_speakers=4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = lstm_bidirectional_recurrence.launches

    for f, out in zip(files, outputs):
        ann = out.speaker_diarization
        if not isinstance(ann, Annotation) or not len(ann):
            raise AssertionError(f"{f['uri']}: expected a non-empty "
                                 f"Annotation, got {ann!r}")
        if not np.isfinite(out.speaker_embeddings).all():
            raise AssertionError(f"{f['uri']}: non-finite centroids")
        log(f"{f['uri']}: {len(ann)} segments, labels {ann.labels()}")
    expected = 2 * batches
    log(f"lstm_recurrence launches in the main path: {launches} "
        f"(2 layers x {batches} segmentation batches = {expected})")
    if launches != expected:
        raise AssertionError(f"expected {expected} LSTM kernel launches, "
                             f"counted {launches}")
    hours = sum(FILE_MINUTES) / 60.0
    log(f"slice end to end: {seconds:.3f} s for {sum(FILE_MINUTES):g} min "
        f"of audio = {seconds / hours:.3f} s per audio-hour")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    phase_environment()
    phase_build()
    record = phase_kernels(device)
    with tempfile.TemporaryDirectory() as tmp:
        record["launches"] = phase_slice(device, Path(tmp))
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
