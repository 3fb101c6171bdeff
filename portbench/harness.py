"""One run of one cell: set-up, the measured window, the check, the line.

``main(argv, started)`` is ``run.py``'s entry. Tests call it with
``device`` set to the CPU, which skips the look for a card, may pass
``prepare(pipeline)`` to break the timed path underneath, and may give
another benchmark ``root``: a tree that holds a ``BENCHMARK.json`` and,
under ``portbench/``, the files it names.

The harness asks everything about a configuration of its module,
``portbench/configs/<name>.py`` beside ``<name>.json``, which defines:

- ``build(ctx)`` -> (the pipeline on ``ctx.device``, the weights the
  reference gets), and ``draw_weights(ctx)`` -> those weights alone;
- ``install(capture, pipeline)``: which calls are timed under which span
  labels, and what each file keeps for the check (``capture.py``);
- ``warmup(traffic, config)`` -> the recordings set-up runs;
- ``lstm_launches(config, samples)`` -> (T, B) of each LSTM kernel launch
  a recording needs (``launches_short``, on the card);
- ``recording_flops(config, samples)`` -> FLOPs by stage of a recording;
- ``lstm_trace(config, recordings)`` -> the trace's ``lstm`` entry
  (``hidden``, ``directions``, ``precision``, ``launches``);
- ``well_formed(output)`` -> whether a file's output counts as an answer;
- ``check(ctx, weights, done, outputs, records)`` -> every compared
  number, each held to the limit of that name in ``<name>.json``;
- ``control(ctx, weights, mode, files)`` -> the control's numbers
  (``control.py``).

The diarization configurations take these from ``portbench/diarization.py``.
A traffic mix is ``portbench/traffic/<mix>.json``, a per-layer metric the
reader ``portbench/metrics/<name>.py``: all found under the root by name.
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


def config_module(root: Path, name: str):
    """The configuration's module, ``portbench/configs/<name>.py``."""
    return load_module(root / HERE.name / "configs" / f"{name}.py",
                       f"portbench_config_{name.replace('-', '_')}")


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
         prepare: Optional[Callable] = None, mix: Optional[dict] = None,
         root: Path = ROOT) -> int:
    """``device``, ``prepare``, ``mix`` (in place of the cell's traffic
    file) and ``root`` serve the tests."""
    started = time.perf_counter() if started is None else started
    args = parse(argv)
    bench = load_benchmark(root)
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
    config = json.loads((root / entry["file"]).read_text())
    if "lstm_precision" in config:
        os.environ["PYANNOTE_TPU_LSTM_PRECISION"] = config["lstm_precision"]
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        return run_cell(args, bench, workload, entry, config, device, workdir,
                        started, prepare, mix, root)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def warmup_recordings(traffic, config: dict):
    """The diarization configurations' warm-up, as
    ``tools/pipeline_spans.py`` asks for it; the harness asks the
    configuration module."""
    from portbench.diarization import warmup
    return warmup(traffic, config)


def lstm_launches_counted() -> int:
    from pyannote_audio_tpu_torch.ops.lstm_kernel import \
        lstm_bidirectional_recurrence
    return lstm_bidirectional_recurrence.launches


def run_cell(args, bench, workload, entry, config, device, workdir: Path,
             started: float, prepare, mix, root: Path) -> int:
    import torch

    from portbench.capture import Capture
    from portbench.traffic.generator import Traffic, load_mix

    log(f"set-up: imports and device at {time.perf_counter() - started:.3f} s")
    traffic = Traffic(mix or load_mix(workload["traffic"],
                                      root / HERE.name / "traffic"),
                      args.seed, workdir)
    traffic.write(device)
    log(f"set-up: traffic written at {time.perf_counter() - started:.3f} s")
    module = config_module(root, entry["name"])
    ctx = Context(args.seed, device, workdir, config, traffic)
    pipeline, weights = module.build(ctx)
    log(f"set-up: weights drawn, pipeline built at "
        f"{time.perf_counter() - started:.3f} s")
    if prepare is not None:
        prepare(pipeline)
    capture = Capture(ranges=bool(args.trace))
    module.install(capture, pipeline)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    warm = module.warmup(traffic, config)
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
            expected = sum(len(module.lstm_launches(config, r.samples))
                           for r in d["recordings"])
            launches_short += abs(expected - d["launches"])
    for uri in [f["uri"] for d in done for f in d["files"]]:
        if not module.well_formed(outputs.get(uri)):
            failed += 1

    for d in done:
        log(f"list {d['files'][0]['uri'][:4]} ({d['kind'] or 'untraced'}): "
            f"{_rate(d):.3f} audio s/s over "
            f"{sum(r.seconds for r in d['recordings']):.1f} s of audio; "
            f"host s: " + ", ".join(f"{k} {v:.3f}"
                                    for k, v in sorted(d["spans"].items())))
    metrics, extra = {}, {}
    if args.trace:
        trace = trace_summary(done, config, capture.intervals, module)
        readers = [m for m in bench["per_layer"]
                   if args.workload in m.get("workloads",
                                             [args.workload])]
        for metric in readers:
            reader = load_module(root / HERE.name / "metrics"
                                 / f"{metric['name']}.py",
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
    values = module.check(ctx, weights, done, outputs, records)
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


def trace_summary(done: List[dict], config: dict, intervals, module
                  ) -> dict:
    """What the per-layer readers read: ``spans`` from the lists run
    without a profile, ``device`` from the device-only profile, ``ranges``
    from the full one; the FLOPs and the LSTM launches of the profiled
    list's recordings from the configuration's ``module``."""
    from torch.autograd import DeviceType

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
    device = {
        "audio_s": sum(r.seconds for r in listed["recordings"]),
        "window_s": listed["end"] - listed["begin"], "busy_s": busy_s,
        "kernels": kernels,
        "flops": sum(sum(module.recording_flops(config, r.samples).values())
                     for r in listed["recordings"]),
        "lstm": module.lstm_trace(config, listed["recordings"])}

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
