"""What the diarization configurations share (``community1``,
``sseriouss-wavlm-base``): the port's powerset ``SpeakerDiarization``,
with a segmentation model of a kind that ``portbench/reference/<kind>.py``
defines (a BiLSTM over its frames), a WeSpeaker ResNet embedding and a
clustering of ``portbench/reference/clustering.py``, all held against
``portbench/reference/pipeline.py``'s ``ReferencePipeline``. Each such
configuration module takes these hooks from here (``harness.py`` lists
what the harness asks of a configuration module).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from portbench import flops


# -- the capture points ----------------------------------------------------

def install(capture, pipeline) -> None:
    """Wrappers on one ``SpeakerDiarization`` instance:

    - ``_stage``, ``_finalize``, ``clustering``, ``_segmentation.slide``,
      ``_start_shared_trunk`` and ``get_embeddings``: host seconds in each
      (the layers' spans) and their intervals, and which file the calls
      inside belong to;
    - ``_segmentation._convert``: each batch's raw model output, the
      segmentation log-probs, kept on the device with no copy and no
      sync;
    - ``clustering``: its inputs (embeddings, clean and active frame
      counts) and its hard clusters, copied on the host;
    - an SSL trunk's ``forward`` (SSeRiouSS): its last layer's output for
      the first segmentation batch of each file, kept on the device;
    - ``_finalize``'s staged dict: the binarized segmentation (on the
      device) and the frame-level count (copied).

    The span labels, and with ``ranges`` the ``portbench.<label>``
    ranges: ``segmentation`` (the slide), ``embedding`` (the early shared
    trunk and ``get_embeddings``), ``stage``, ``finalize``,
    ``clustering``."""
    def stage(original):
        def run(file, *args, **kwargs):
            capture.current = file["uri"]
            return original(file, *args, **kwargs)
        return capture.timed("stage", run)

    def finalize(original):
        def run(staged):
            uri = staged["file"]["uri"]
            capture.current = uri
            out = original(staged)
            record = capture.files[uri]
            record["binarized"] = staged["binarized"]
            record["count"] = np.array(staged["host"]["count"])
            return out
        return capture.timed("finalize", run)

    def convert(original):
        def run(out):
            capture.files[capture.current].setdefault("logp", []).append(out)
            return original(out)
        return run

    def clustering(original):
        def run(embeddings, clean_frames, **kwargs):
            out = original(embeddings, clean_frames, **kwargs)
            record = capture.files[capture.current]
            record["embeddings"] = np.array(embeddings)
            record["clean_frames"] = np.array(clean_frames)
            record["speaker_frames"] = np.array(kwargs["speaker_frames"])
            record["hard"] = np.array(out[0])
            return out
        return capture.timed("clustering", run)

    def ssl(original):
        def run(*args, **kwargs):
            states = original(*args, **kwargs)
            capture.files[capture.current].setdefault("ssl", states[-1])
            return states
        return run

    trunk = getattr(pipeline._segmentation.model, "wav2vec", None)
    if trunk is not None:
        capture.wrap(trunk, "forward", ssl)
    capture.wrap(pipeline, "_stage", stage)
    capture.wrap(pipeline, "_finalize", finalize)
    capture.wrap(pipeline._segmentation, "_convert", convert)
    capture.wrap(pipeline, "clustering", clustering)
    capture.time(pipeline._segmentation, "slide", "segmentation")
    capture.time(pipeline, "_start_shared_trunk", "embedding")
    capture.time(pipeline, "get_embeddings", "embedding")


# -- the warm-up -----------------------------------------------------------

def warmup(traffic, config: dict) -> list:
    """The shortest recording of the pool that fills one segmentation
    batch and leaves a tail batch, and with ``warmup_longest`` in the
    configuration the longest too (the host's and the card's memory
    caches then hold blocks of every size a list asks for)."""
    first = _batch_and_tail(traffic, config)
    longest = max(traffic.pool, key=lambda r: r.samples)
    if config.get("warmup_longest") and longest is not first:
        return [first, longest]
    return [first]


def _window_and_step(config: dict) -> Tuple[int, int]:
    """Samples of a segmentation chunk, and between two chunks."""
    seg = config["segmentation"]
    rate = seg["hparams"]["sample_rate"]
    window = int(round(seg["specifications"]["duration"] * rate))
    return window, int(round(config["segmentation_step"] * window))


def _batch_and_tail(traffic, config: dict):
    window, step = _window_and_step(config)
    batch = config["segmentation_batch_size"]
    for rec in sorted(traffic.pool, key=lambda r: r.samples):
        chunks, _ = flops.chunk_grid(rec.samples, window, step)
        if chunks > batch and chunks % batch:
            return rec
    return max(traffic.pool, key=lambda r: r.samples)


# -- the counts ------------------------------------------------------------

def _classes(config: dict) -> int:
    """Powerset classes of the segmentation's specifications."""
    from math import comb
    spec = config["segmentation"]["specifications"]
    return sum(comb(len(spec["classes"]), k)
               for k in range(spec["powerset_max_classes"] + 1))


def recording_flops(config: dict, num_samples: int) -> Dict[str, int]:
    """Per-stage FLOPs of one recording through the configuration
    (``portbench/flops.py``: the work the audio needs, no padding)."""
    seg = config["segmentation"]
    window, step = _window_and_step(config)
    chunks, padded = flops.chunk_grid(num_samples, window, step)
    out = dict(flops.shared_flops(seg, padded))
    per_chunk, _ = flops.chunk_flops(seg, window, _classes(config))
    out["segmentation"] = per_chunk * chunks
    emb = config["embedding"]["hparams"]
    frames = flops.conv1d_out(num_samples, 400, 160)
    out["fbank"] = flops.fbank_flops(flops.conv1d_out(padded, 400, 160))
    out["trunk"] = flops.resnet_trunk_flops_per_frame(
        emb["m_channels"], emb["num_blocks"], emb["num_mel_bins"]) * frames
    freq = emb["num_mel_bins"]
    for _ in range(3):
        freq = (freq + 1) // 2
    pooled = emb["m_channels"] * 8 * freq
    trunk_frames = flops.conv1d_out(window, 400, 160)
    for _ in range(3):
        trunk_frames = (trunk_frames - 1) // 2 + 1
    speakers = len(seg["specifications"]["classes"])
    out["pool_and_embed"] = chunks * speakers * (
        2 * trunk_frames * pooled + 2 * 2 * pooled * emb["embed_dim"])
    return out


def lstm_launches(config: dict, num_samples: int) -> List[Tuple[int, int]]:
    """(T, B) of each recurrence launch of one recording: one per layer
    and batch of chunks."""
    seg = config["segmentation"]
    window, step = _window_and_step(config)
    chunks, _ = flops.chunk_grid(num_samples, window, step)
    _, steps = flops.chunk_flops(seg, window, _classes(config))
    batch = config["segmentation_batch_size"]
    sizes = [batch] * (chunks // batch) + ([chunks % batch]
                                           if chunks % batch else [])
    return [(steps, b) for b in sizes
            for _ in range(seg["hparams"]["lstm"]["num_layers"])]


def lstm_trace(config: dict, recordings) -> dict:
    """The trace's ``lstm`` entry for the recordings of a traced list."""
    return {"hidden": config["segmentation"]["hparams"]["lstm"]["hidden_size"],
            "directions": 2, "precision": config["lstm_precision"],
            "launches": [shape for r in recordings
                         for shape in lstm_launches(config, r.samples)]}


# -- the check -------------------------------------------------------------

def well_formed(output) -> bool:
    annotation = getattr(output, "speaker_diarization", None)
    return annotation is not None and hasattr(annotation, "itertracks")


def check(ctx, weights, done, outputs, records) -> Dict[str, float]:
    """Every compared number (``portbench/reference/check.py``), the
    largest over a seeded sample of the finished recordings (each
    recording's first finished pass) that always holds the longest."""
    from portbench.reference.check import numbers
    from portbench.reference.pipeline import ReferencePipeline
    from portbench.traffic.generator import seeded
    config, traffic, log = ctx.config, ctx.traffic, ctx.log
    finished = [(f["uri"], r) for d in done
                for f, r in zip(d["files"], d["recordings"])
                if f["uri"] in outputs and "embeddings" in records.get(
                    f["uri"], {})]
    longest = max(range(len(finished)), key=lambda i: finished[i][1].samples)
    rest = [i for i in range(len(finished)) if i != longest]
    count = min(config["check_files"], len(finished)) - 1
    chosen = [longest] + list(seeded(ctx.seed, 3).choice(rest, size=count,
                                                         replace=False))
    ref = ReferencePipeline(config, weights, ctx.device)
    values: Dict[str, float] = {}
    shares = []
    for i in chosen:
        uri, rec = finished[i]
        record = dict(records[uri], output=outputs[uri])
        start = time.perf_counter()
        parts = {}
        found = numbers(ref, traffic.audio(rec), record, parts,
                        end_to_end=i == longest)
        output = record["output"]
        active = record["speaker_frames"] > 0
        frames = record["binarized"].shape[1]
        log(f"{uri}: {traffic.voices(rec)} voices; the program's "
            f"{len(np.unique(record['hard'][active]))} clusters, "
            f"{len(output.speaker_diarization.labels())} speakers, "
            f"{len(list(output.speaker_diarization.itertracks()))} segments"
            + (f"; the reference alone's {found.pop('clusters')} clusters"
               if "clusters" in found else "")
            + f"; {int((record['clean_frames'] >= 0.2 * frames).sum())}"
            f" embeddings clustered of {active.size}")
        binarized = record["binarized"].float()
        active = binarized.sum(dim=-1)
        shares.append(((active >= 1).float().mean().item(),
                       (active >= 2).float().mean().item()))
        log(f"checked {uri} ({rec.seconds:.1f} s) in "
            f"{time.perf_counter() - start:.3f} s "
            f"({', '.join(f'{k} {v:.2f}' for k, v in parts.items())}): "
            f"{found}")
        for name, value in found.items():
            values[name] = max(values.get(name, value), value)
    log("frames with speech / with overlap in the checked recordings: "
        + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in shares))
    return values


def control(ctx, weights, mode: str, files: int = None):
    """The plain reference in ``mode`` put in the program's place, for the
    recordings a run's check takes from the pool (the longest and seeded
    others): -> [(uri, seconds, numbers)]."""
    from portbench.reference.check import control_numbers
    from portbench.reference.pipeline import ReferencePipeline
    from portbench.traffic.generator import seeded
    config, traffic = ctx.config, ctx.traffic
    ref = ReferencePipeline(config, weights, ctx.device)
    pool = sorted(traffic.pool, key=lambda r: -r.samples)
    count = min(files or config["check_files"], len(pool)) - 1
    others = seeded(ctx.seed, 3).choice(len(pool) - 1, size=count,
                                        replace=False)
    out = []
    for rec in [pool[0]] + [pool[1 + i] for i in others]:
        start = time.perf_counter()
        found = control_numbers(ref, traffic.audio(rec), mode)
        ctx.log(f"control {mode} seed {ctx.seed} pool_{rec.index:02d} "
                f"({rec.seconds:.1f} s) in "
                f"{time.perf_counter() - start:.3f} s: {found}")
        out.append((f"pool_{rec.index:02d}", rec.seconds, found))
    return out
