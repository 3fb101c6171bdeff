"""One run of one cell: set-up, the measured window, the check, the line.

``main(argv, started)`` is ``run.py``'s entry. Tests call it with
``device`` set to the CPU, which skips the look for a card, and may pass
``prepare(pipeline)`` to break the timed path underneath.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional


HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "pyannote_audio_tpu")
# in a traced run, list 1 runs under a device-only profile (kernels and
# copies: the idle share, the roofline, the step's FLOP rate) and list 2
# under a full one (CPU ops too, which slows the host several times: the
# kernels launched inside each layer's range); the host spans come from
# the lists run without a profile
TRACED_LISTS = {1: "device", 2: "ranges"}


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: List[dict], name: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no entry named {name!r}")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX
    package, each compared whole."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return "card: " + out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as error:
        return f"card: nvidia-smi not available ({error})"


@dataclass
class Context:
    seed: int
    device: object
    workdir: Path
    config: dict
    traffic: object
    log: Callable[[str], None] = log


def parse(argv: List[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv: List[str], started: Optional[float] = None, device=None,
         prepare: Optional[Callable] = None, mix: Optional[dict] = None
         ) -> int:
    """``device``, ``prepare`` and ``mix`` (in place of the cell's traffic
    file) serve the tests."""
    started = time.perf_counter() if started is None else started
    args = parse(argv)
    bench = load_benchmark()
    workload = find(bench["workloads"], args.workload)
    entry = find(bench["configs"], workload["config"])
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < workload["chips"]:
            log(f"{args.workload} needs {workload['chips']} CUDA card(s); "
                f"torch sees {torch.cuda.device_count()}: no result")
            return 2
        device = torch.device("cuda", 0)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    log(card_line())
    config = json.loads((ROOT / entry["file"]).read_text())
    os.environ["PYANNOTE_TPU_LSTM_PRECISION"] = config["lstm_precision"]
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        return run_cell(args, bench, workload, entry, config, device, workdir,
                        started, prepare, mix)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def warmup_recordings(traffic, config: dict):
    """The shortest recording of the pool that fills one segmentation
    batch and leaves a tail batch, and with ``warmup_longest`` in the
    configuration the longest too (the host's and the card's memory
    caches then hold blocks of every size a list asks for)."""
    first = _batch_and_tail(traffic, config)
    longest = max(traffic.pool, key=lambda r: r.samples)
    if config.get("warmup_longest") and longest is not first:
        return [first, longest]
    return [first]


def _batch_and_tail(traffic, config: dict):
    from portbench.flops import chunk_grid
    seg = config["segmentation"]
    rate = seg["hparams"]["sample_rate"]
    window = int(round(seg["specifications"]["duration"] * rate))
    step = int(round(config["segmentation_step"] * window))
    batch = config["segmentation_batch_size"]
    for rec in sorted(traffic.pool, key=lambda r: r.samples):
        chunks, _ = chunk_grid(rec.samples, window, step)
        if chunks > batch and chunks % batch:
            return rec
    return max(traffic.pool, key=lambda r: r.samples)


def lstm_launches_counted() -> int:
    from pyannote_audio_tpu_torch.ops.lstm_kernel import \
        lstm_bidirectional_recurrence
    return lstm_bidirectional_recurrence.launches


def run_cell(args, bench, workload, entry, config, device, workdir: Path,
             started: float, prepare, mix) -> int:
    import torch

    from portbench.capture import Capture
    from portbench.flops import lstm_launches
    from portbench.traffic.generator import Traffic, load_mix

    log(f"set-up: imports and device at {time.perf_counter() - started:.3f} s")
    traffic = Traffic(mix or load_mix(workload["traffic"]), args.seed,
                      workdir)
    traffic.write(device)
    log(f"set-up: traffic written at {time.perf_counter() - started:.3f} s")
    module = load_module(HERE / "configs" / f"{entry['name']}.py",
                         f"portbench_config_{entry['name'].replace('-', '_')}")
    ctx = Context(args.seed, device, workdir, config, traffic)
    pipeline, weights = module.build(ctx)
    log(f"set-up: weights drawn, pipeline built at "
        f"{time.perf_counter() - started:.3f} s")
    if prepare is not None:
        prepare(pipeline)
    capture = Capture(ranges=bool(args.trace)).install(pipeline)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    warm = warmup_recordings(traffic, config)
    pipeline([{"audio": str(r.path), "uri": f"warmup_{k}"}
              for k, r in enumerate(warm)])
    sync()
    if args.trace:
        # the profiler's first session initialises its device tracing, which
        # takes seconds: not inside a traced list
        for with_cpu in (False, True):
            profiled(lambda: torch.ones(8, device=device).sum(), sync,
                     with_cpu)
    capture.files.clear()
    capture.spans.clear()
    setup_s = time.perf_counter() - started
    log(f"setup {setup_s:.3f} s (warm-up on recordings of "
        f"{', '.join(f'{r.seconds:.1f}' for r in warm)} s)")

    lists = traffic.lists()
    rounds = traffic.round
    kept = set()
    done = []
    outputs: Dict[str, object] = {}
    failed = 0
    window_start = time.perf_counter()
    deadline = window_start + args.seconds
    k = 0
    while True:
        recordings = next(lists)
        files = [{"audio": str(r.path),
                  "uri": f"l{k:03d}_{j:02d}_p{r.index:02d}"}
                 for j, r in enumerate(recordings)]
        kind = TRACED_LISTS.get(k) if args.trace else None
        spans = dict(capture.spans)
        launches = lstm_launches_counted() if on_card else 0
        begin = time.perf_counter()
        profile = None
        try:
            if kind is None:
                result = pipeline(files)
            else:
                profile, result = profiled(lambda: pipeline(files), sync,
                                           with_cpu=kind == "ranges")
            sync()
        except Exception:
            traceback.print_exc()
            failed += len(files)
            result = []
        end = time.perf_counter()
        for f, r, out in zip(files, recordings, result):
            outputs[f["uri"]] = out
            # what the check reads is kept for each recording's first
            # finished pass only, so that it takes no memory to speak of
            if r.index in kept:
                capture.files.pop(f["uri"], None)
            else:
                kept.add(r.index)
        done.append({"files": files, "recordings": recordings,
                     "begin": begin, "end": end, "kind": kind,
                     "profile": profile,
                     "spans": {name: capture.spans[name] - spans.get(name, 0.0)
                               for name in capture.spans},
                     "launches": (lstm_launches_counted() - launches)
                     if on_card else None})
        k += 1
        if end >= deadline and k % rounds == 0 and (
                not args.trace or k > max(TRACED_LISTS)):
            break
    window_end = done[-1]["end"]
    sync()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    attempted = sum(len(d["files"]) for d in done)
    audio_s = sum(r.seconds for d in done for r in d["recordings"])
    log(f"window: {len(done)} lists, {attempted} recordings, "
        f"{audio_s:.1f} s of audio in {window_end - window_start:.3f} s")

    launches_short = 0
    if on_card:
        for d in done:
            expected = sum(len(lstm_launches(config, r.samples))
                           for r in d["recordings"])
            launches_short += abs(expected - d["launches"])
    for uri in [f["uri"] for d in done for f in d["files"]]:
        if not _well_formed(outputs.get(uri)):
            failed += 1

    for d in done:
        log(f"list {d['files'][0]['uri'][:4]} ({d['kind'] or 'untraced'}): "
            f"{_rate(d):.3f} audio s/s over "
            f"{sum(r.seconds for r in d['recordings']):.1f} s of audio; "
            f"host s: " + ", ".join(f"{k} {v:.3f}"
                                    for k, v in sorted(d["spans"].items())))
    metrics, extra = {}, {}
    if args.trace:
        trace = trace_summary(done, config, capture.intervals)
        readers = [m for m in bench["per_layer"]
                   if args.workload in m.get("workloads",
                                             [args.workload])]
        for metric in readers:
            reader = load_module(HERE / "metrics" / f"{metric['name']}.py",
                                 f"portbench_metric_{metric['name']}")
            value = reader.read(trace)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
        extra = {"busy_s": trace["device"]["busy_s"],
                 "window_s": trace["device"]["window_s"],
                 "breakdown": trace["breakdown"]}
    else:
        metrics["diar_audio_s_per_s"] = {
            "value": audio_s / (window_end - window_start),
            "unit": "audio_s/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    records = capture.files
    capture.remove()
    del pipeline
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    values = check(config, weights, device, traffic, done, outputs, records,
                   args.seed)
    if on_card:
        values["launches_short"] = launches_short
    values["failed"] = failed
    limits = {name: limit for name, limit in config["limits"].items()
              if name in values}
    correct = all(values[name] <= limits[name] for name in limits)

    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}: "
            f"no result")
        return 3
    device_entry = {"platform": "gpu" if on_card else "cpu",
                    "kind": torch.cuda.get_device_name(device)
                    if on_card else "cpu",
                    "count": workload["chips"], "memory_peak_bytes": peak}
    if args.trace:
        device_entry.update(busy_s=extra["busy_s"],
                            window_s=extra["window_s"])
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_entry}
    if args.trace:
        line["breakdown"] = extra["breakdown"]
    line["checks"] = {name: {"value": values[name], "limit": limits[name]}
                      for name in limits}
    for name in limits:
        log(f"check {name}: {values[name]!r} (limit {limits[name]!r})")
    print(json.dumps(line), flush=True)
    return 0


def _well_formed(output) -> bool:
    annotation = getattr(output, "speaker_diarization", None)
    return annotation is not None and hasattr(annotation, "itertracks")


def check(config, weights, device, traffic, done, outputs, records,
          seed: int) -> Dict[str, float]:
    """Every compared number, the largest over a seeded sample of the
    finished recordings (each recording's first finished pass) that always
    holds the longest."""
    import numpy as np

    from portbench.reference.check import numbers
    from portbench.reference.pipeline import ReferencePipeline
    from portbench.traffic.generator import seeded
    finished = [(f["uri"], r) for d in done
                for f, r in zip(d["files"], d["recordings"])
                if f["uri"] in outputs and "embeddings" in records.get(
                    f["uri"], {})]
    longest = max(range(len(finished)), key=lambda i: finished[i][1].samples)
    rest = [i for i in range(len(finished)) if i != longest]
    count = min(config["check_files"], len(finished)) - 1
    chosen = [longest] + list(seeded(seed, 3).choice(rest, size=count,
                                                     replace=False))
    ref = ReferencePipeline(config, weights, device)
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


def profiled(fn, sync, with_cpu: bool):
    """Run ``fn`` under the profiler: CUDA activity, and CPU ops with
    ``with_cpu``. Returns ((profile, host clock at its start), result)."""
    import torch
    activities = [torch.profiler.ProfilerActivity.CUDA] \
        if torch.cuda.is_available() else []
    if with_cpu or not activities:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=activities) as prof:
        started = time.perf_counter()
        result = fn()
        sync()
    return (prof, started), result


def _rate(d: dict) -> float:
    return sum(r.seconds for r in d["recordings"]) / (d["end"] - d["begin"])


def trace_summary(done: List[dict], config: dict, intervals) -> dict:
    """What the per-layer readers read: ``spans`` from the lists run
    without a profile, ``device`` from the device-only profile, ``ranges``
    from the full one."""
    from torch.autograd import DeviceType

    from portbench.flops import lstm_launches, recording_flops
    plain = [d for d in done if d["kind"] is None]
    spans = {"audio_s": sum(r.seconds for d in plain for r in d["recordings"]),
             "seconds": {}}
    for d in plain:
        for name, seconds in d["spans"].items():
            spans["seconds"][name] = spans["seconds"].get(name, 0.0) + seconds

    listed = next(d for d in done if d["kind"] == "device")
    (prof, started) = listed["profile"]
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [(e.name, (e.time_range.end - e.time_range.start) * 1e-6)
               for e in events]
    merged = _merged(sorted((e.time_range.start, e.time_range.end)
                            for e in events))
    busy_s = sum(end - start for start, end in merged) * 1e-6
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        middle = started + 0.5 * (e0 + s1) * 1e-6
        around = [(t1 - t0, label) for t0, t1, label in intervals
                  if t0 <= middle <= t1]
        gaps.append([min(around)[1] if around else "outside the spans",
                     (s1 - e0) * 1e-6])
    gaps = sorted(gaps, key=lambda g: -g[1])[:10]
    by_name: Dict[str, float] = {}
    for name, seconds in kernels:
        by_name[name] = by_name.get(name, 0.0) + seconds
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    seg = config["segmentation"]["hparams"]
    device = {
        "audio_s": sum(r.seconds for r in listed["recordings"]),
        "window_s": listed["end"] - listed["begin"], "busy_s": busy_s,
        "kernels": kernels,
        "flops": sum(sum(recording_flops(config, r.samples).values())
                     for r in listed["recordings"]),
        "lstm": {"hidden": seg["lstm"]["hidden_size"], "directions": 2,
                 "precision": config["lstm_precision"],
                 "launches": [shape for r in listed["recordings"]
                              for shape in lstm_launches(config, r.samples)]}}

    ranged = next(d for d in done if d["kind"] == "ranges")
    device_s: Dict[str, float] = {}
    for e in ranged["profile"][0].events():
        if e.device_type == DeviceType.CPU and \
                e.name.startswith("portbench."):
            label = e.name.split(".", 1)[1]
            device_s[label] = device_s.get(label, 0.0) + \
                e.device_time_total * 1e-6
    ranges = {"audio_s": sum(r.seconds for r in ranged["recordings"]),
              "device_s": device_s}
    return {"spans": spans, "device": device, "ranges": ranges,
            "breakdown": {"device_ops": [list(kv) for kv in device_ops],
                          "idle_gaps": gaps}}


def _merged(intervals):
    """The union of sorted (start, end) intervals as disjoint [start,
    end] pairs (``tools/profile_accelerator_pass.py``'s
    ``busy_microseconds`` sums their lengths)."""
    out = []
    for start, end in intervals:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out
