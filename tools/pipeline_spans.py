"""Read one benchmark cell through the pipeline's own spans and units.

    python3 tools/pipeline_spans.py --workload <name> --seed <n> \
        [--lists N] [--out FILE]

Builds the cell as ``portbench/run.py`` does (its configuration, traffic
and warm-up, from the seed, on the CUDA card), puts the benchmark's
outside spans on the pipeline (the configuration module's ``install``,
``portbench/capture.py``), then runs four
phases of ``--lists`` lists (a round of the cell by default) in turns,
span recording off / on / on / off (``telemetry/spans.py``), one list with
recording on under a device-only profile and one under a profile with CPU
ops. It prints, as one JSON line (also appended to ``--out`` where given):

- ``rate``: audio seconds per second of the lists, recording off and on;
- ``per_audio_h``: host seconds per audio-hour of every span path, over
  the lists run with recording on and no profile; ``self``: the same for
  each path's own time (none of its children's); ``capture``: the outside
  spans (``stage``, ``finalize``, ...) in the same lists, and
  ``capture_off`` in the lists run with recording off;
- ``pipeline_idle_share``: percent of those lists' wall in which none of
  the pipeline's device units ran; ``unit_gaps``: the longest such
  stretches, each labelled with the innermost span that covers most of
  it;
- ``profile``: in the device-only profiled list, the profiler's idle share
  beside the units' in the same list, and the profile's longest idle gaps
  labelled from the spans (put on the profiler's clock from the wall
  clock); in the list profiled with CPU ops, the spread of the
  span / range pairs' offsets, the spans' distances from their ranges
  once the recording's wall-clock offset is added (median, 90th
  percentile, most), and how far the pairs' median lies from that
  offset;
- ``cost``: seconds per span entered and left, with recording off and on,
  and the spans per list;
- ``counters``: the recordings' counters (``counter_totals``), per list.

The readers of a recording (``self_seconds``, ``busy_ns``, ``idle_share``,
``label``, ``idle_gaps``, ``profiler_pairs``, ``counter_totals``) are
plain functions, tested on the CPU (``tests/test_torch_port_spans.py``,
``tests/test_torch_port_separation_wavlm.py``).
"""

from __future__ import annotations

import os

if __name__ == "__main__":
    # the host pools at one thread each, as portbench/run.py sets them
    for _pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                  "OPENBLAS_NUM_THREADS"):
        os.environ[_pool] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.capture import Capture  # noqa: E402
from portbench.harness import (CACHE, Context, _merged,  # noqa: E402
                               card_line, config_module, find,
                               load_benchmark, profiled)
from portbench.traffic.generator import Traffic, load_mix  # noqa: E402
from pyannote_audio_tpu_torch.telemetry import spans  # noqa: E402

PHASES = ("off", "on", "on", "off")


# -- the readers of a recording ----------------------------------------------

def self_seconds(rec, path: str, start_ns: Optional[int] = None,
                 end_ns: Optional[int] = None) -> float:
    """Seconds of the spans at ``path`` that none of their children
    covers."""
    closed = rec.closed(start_ns, end_ns)
    total = sum(s.seconds for s in closed if s.path == path)
    return total - sum(s.seconds for s in closed
                       if s.parent is not None and s.parent.path == path)


def busy_ns(rec, start_ns: int, end_ns: int) -> int:
    """Nanoseconds of [start_ns, end_ns] inside some device unit."""
    clipped = sorted((max(u.start_ns, start_ns), min(u.end_ns, end_ns))
                     for u in rec.units)
    return sum(e - s for s, e in _merged((s, e) for s, e in clipped
                                         if e > s))


def idle_share(rec, start_ns: int, end_ns: int) -> Optional[float]:
    """Percent of [start_ns, end_ns] in which no unit ran; None without
    units."""
    if not rec.units or end_ns <= start_ns:
        return None
    wall = end_ns - start_ns
    return 100.0 * (wall - busy_ns(rec, start_ns, end_ns)) / wall


def _depth(s) -> int:
    depth = 0
    while s.parent is not None:
        s, depth = s.parent, depth + 1
    return depth


def label(rec, start_ns: int, end_ns: int) -> Optional[str]:
    """The path of the innermost span that covers more than half of
    [start_ns, end_ns], else of the one that covers most of it (the
    innermost of equals); None where no span overlaps it."""
    best = None
    length = max(end_ns - start_ns, 1)
    for s in rec.closed():
        covered = min(s.end_ns, end_ns) - max(s.start_ns, start_ns)
        if covered <= 0:
            continue
        over_half = 2 * covered > length
        key = (over_half, _depth(s), covered) if over_half \
            else (over_half, covered, _depth(s))
        if best is None or key > best[0]:
            best = (key, s.path)
    return None if best is None else best[1]


def idle_gaps(rec, start_ns: int, end_ns: int) -> List[Tuple[str, float]]:
    """The stretches of [start_ns, end_ns] between the merged units,
    longest first, each as (the label of what the host did, seconds);
    "outside the spans" where no span overlaps one."""
    busy = _merged(sorted((max(u.start_ns, start_ns), min(u.end_ns, end_ns))
                          for u in rec.units
                          if u.end_ns > start_ns and u.start_ns < end_ns))
    edges = [start_ns] + [t for b in busy for t in b] + [end_ns]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    out = [(label(rec, s, e) or "outside the spans", (e - s) * 1e-9)
           for s, e in gaps]
    return sorted(out, key=lambda g: -g[1])


def profiler_pairs(rec, prof) -> list:
    """(span, the profiler's event of its range) for every span that
    opened a range under ``prof``: the k-th span of a path against the
    k-th range of that name, for paths whose counts agree."""
    ranged: Dict[str, list] = {}
    for s in rec.closed():
        if s.ranged:
            ranged.setdefault(s.path, []).append(s)
    events: Dict[str, list] = {}
    for e in prof.events():
        if e.name in ranged and \
                e.device_type == torch.autograd.DeviceType.CPU:
            events.setdefault(e.name, []).append(e)
    pairs = []
    for path, found in ranged.items():
        ranges = sorted(events.get(path, []),
                        key=lambda e: e.time_range.start)
        if len(ranges) == len(found):
            pairs.extend(zip(found, ranges))
    return pairs


def counter_totals(recordings) -> Dict[str, int]:
    """The counters of several recordings together: summed, except those
    named ``*_peak_bytes``, of which the largest."""
    out: Dict[str, int] = {}
    for rec in recordings:
        for name, value in rec.counters.items():
            if name.endswith("_peak_bytes"):
                out[name] = max(out.get(name, value), value)
            else:
                out[name] = out.get(name, 0) + value
    return out


def span_cost(repeats: int = 200_000) -> dict:
    """Seconds to enter and leave one span, recording off and on."""
    out = {}
    for phase in ("off", "on"):
        with spans.recording() if phase == "on" else contextlib.nullcontext():
            start = time.perf_counter()
            for _ in range(repeats):
                with spans.span("cost"):
                    pass
            out[phase] = (time.perf_counter() - start) / repeats
    return out


def run_list(pipeline, files, capture, sync):
    before = dict(capture.spans)
    begin = time.perf_counter_ns()
    pipeline(files)
    sync()
    end = time.perf_counter_ns()
    return {"begin": begin, "end": end,
            "capture": {k: capture.spans[k] - before.get(k, 0.0)
                        for k in capture.spans}}


def main(argv) -> int:
    parser = argparse.ArgumentParser(prog="tools/pipeline_spans.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--lists", type=int, default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = load_benchmark()
    workload = find(bench["workloads"], args.workload)
    entry = find(bench["configs"], workload["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["PYANNOTE_TPU_LSTM_PRECISION"] = config["lstm_precision"]
    card = card_line()
    print(card, file=sys.stderr)
    workdir = Path(tempfile.mkdtemp(prefix="pipeline-spans-"))
    try:
        result = measure(args, workload, entry, config, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    result.update(card=card, workload=args.workload, seed=args.seed)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


def measure(args, workload, entry, config, device, workdir: Path,
            mix: dict = None) -> dict:
    """The result line's numbers; ``mix`` in place of the cell's traffic
    serves a rehearsal on the CPU."""
    from torch.autograd import DeviceType

    traffic = Traffic(mix or load_mix(workload["traffic"]), args.seed,
                      workdir)
    traffic.write(device)
    module = config_module(ROOT, entry["name"])
    pipeline, _ = module.build(Context(args.seed, device, workdir, config,
                                       traffic))
    capture = Capture()
    module.install(capture, pipeline)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    warm = module.warmup(traffic, config)
    pipeline([{"audio": str(r.path), "uri": f"warmup_{k}"}
              for k, r in enumerate(warm)])
    for with_cpu in (False, True):
        profiled(lambda: torch.ones(8, device=device).sum(), sync, with_cpu)
    with spans.recording():
        pipeline([{"audio": str(warm[0].path), "uri": "warmup_recorded"}])
    sync()

    count = args.lists or traffic.round
    lists = traffic.lists()
    k = 0

    def next_files():
        nonlocal k
        recordings = next(lists)
        files = [{"audio": str(r.path),
                  "uri": f"l{k:03d}_{j:02d}_p{r.index:02d}"}
                 for j, r in enumerate(recordings)]
        k += 1
        return files, sum(r.seconds for r in recordings)

    phases = {"off": [], "on": []}
    recordings = []
    for phase in PHASES:
        recorder = spans.recording() if phase == "on" \
            else contextlib.nullcontext()
        with recorder as rec:
            for _ in range(count):
                files, audio_s = next_files()
                run = run_list(pipeline, files, capture, sync)
                run["audio_s"] = audio_s
                phases[phase].append(run)
        if rec is not None:
            recordings.append((rec, phases[phase][-count:]))

    rate = {phase: sum(r["audio_s"] for r in runs)
            / (sum(r["end"] - r["begin"] for r in runs) * 1e-9)
            for phase, runs in phases.items()}
    audio_h = sum(r["audio_s"] for r in phases["on"]) / 3600.0
    wall_ns = sum(r["end"] - r["begin"] for r in phases["on"])
    totals, own, busy, gaps, span_count = {}, {}, 0, [], 0
    for rec, runs in recordings:
        for run in runs:
            window = (run["begin"], run["end"])
            for path, seconds in rec.totals(*window).items():
                totals[path] = totals.get(path, 0.0) + seconds
            for path in {s.path for s in rec.closed(*window)}:
                own[path] = own.get(path, 0.0) + self_seconds(rec, path,
                                                               *window)
            busy += busy_ns(rec, *window)
            gaps.extend(idle_gaps(rec, *window))
        span_count += len(rec.spans)
    def outside(runs):
        """The outside spans' seconds per audio-hour over ``runs``."""
        hours = sum(r["audio_s"] for r in runs) / 3600.0
        out = {}
        for run in runs:
            for name, seconds in run["capture"].items():
                out[name] = out.get(name, 0.0) + seconds / hours
        return dict(sorted(out.items()))
    gaps.sort(key=lambda g: -g[1])
    children = ("finalize/staged_wait", "finalize/clustering",
                "finalize/reconstruct", "finalize/annotate")
    result = {
        "lists": count, "files_per_list": traffic.mix["files_per_list"],
        "rate": rate, "audio_s_on": audio_h * 3600.0,
        "wall_s_on": wall_ns * 1e-9,
        "per_audio_h": {p: s / audio_h for p, s in sorted(totals.items())},
        "self": {p: s / audio_h for p, s in sorted(own.items())},
        "capture": outside(phases["on"]),
        "capture_off": outside(phases["off"]),
        "finalize_children_share": sum(totals.get(c, 0.0)
                                       for c in children)
        / totals["finalize"] if totals.get("finalize") else None,
        "pipeline_idle_share": 100.0 * (wall_ns - busy) / wall_ns,
        "unit_gaps": [list(gap) for gap in gaps[:12]],
        "units_per_list": sum(len(rec.units) for rec, _ in recordings)
        / (2 * count),
        "spans_per_list": span_count / (2 * count),
        "counters": {name: value / (2 * count) if not name.endswith(
            "_peak_bytes") else value for name, value in counter_totals(
                [rec for rec, _ in recordings]).items()},
    }

    # one list under a device-only profile, recording on
    files, audio_s = next_files()
    with spans.recording() as rec:
        (prof, _), _ = profiled(lambda: pipeline(files), sync, False)
    offset = rec.wall_profiler_offset(prof)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    merged = _merged(sorted((e.time_range.start, e.time_range.end)
                            for e in events)) or [[0.0, 1.0]]
    first, last = merged[0][0], merged[-1][1]
    busy_us = sum(end - start for start, end in merged)
    labelled = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        start = round(e0 * 1e3) - offset
        end = round(s1 * 1e3) - offset
        labelled.append([label(rec, start, end) or "outside the spans",
                         (s1 - e0) * 1e-6])
    labelled.sort(key=lambda g: -g[1])
    window = (round(first * 1e3) - offset, round(last * 1e3) - offset)
    device_profile = {
        "profiler_idle_share": 100.0 * (1 - busy_us / (last - first)),
        "units_idle_share": idle_share(rec, *window),
        "between_first_and_last_device_op_s": (last - first) * 1e-6,
        "gaps": labelled[:12]}

    # one list under a profile with CPU ops, recording on
    files, audio_s = next_files()
    with spans.recording() as rec:
        (prof, _), _ = profiled(lambda: pipeline(files), sync, True)
    offset = rec.wall_profiler_offset(prof)
    pairs = profiler_pairs(rec, prof)
    offsets = [round(event.time_range.start * 1e3) - s.start_ns
               for s, event in pairs]
    distances = sorted(
        max(abs((s.start_ns + offset) * 1e-3 - event.time_range.start),
            abs((s.end_ns + offset) * 1e-3 - event.time_range.end))
        for s, event in pairs)
    quartiles = statistics.quantiles(offsets, n=4)
    result["profile"] = {
        "device_only": device_profile,
        "ranges": {"pairs": len(offsets),
                   "spans": len([s for s in rec.closed() if s.ranged]),
                   "offset_iqr_us": (quartiles[2] - quartiles[0]) * 1e-3,
                   "offset_range_us": (max(offsets) - min(offsets)) * 1e-3,
                   "span_vs_range_us": {
                       "median": statistics.median(distances),
                       "p90": distances[int(0.9 * (len(distances) - 1))],
                       "max": distances[-1]},
                   "pairs_median_minus_wall_us":
                       (statistics.median(offsets) - offset) * 1e-3}}
    result["cost"] = dict(span_cost(),
                          spans_per_list=result["spans_per_list"])
    capture.remove()
    return result


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
