"""Profile one pass of the port's accelerator path on one card.

    python3 tools/profile_accelerator_pass.py [--batch]

Builds the pipeline that ``chip_smoke.py`` drives (full-width PyanNet and
WeSpeaker ResNet34, seeded random weights, batch 256, the accelerator
gates at their defaults) on its synthetic files of 10 and 3 minutes, runs
two warm passes, then one pass under ``torch.profiler``: the files one by
one through ``apply``, or with ``--batch`` as one list through the
pipelined ``apply_batch``. Prints the card's name and power limit, the pass's wall time (host clock, card synchronised at both ends),
the card's busy time (the union of kernel and copy intervals), the idle
share, the LSTM recurrence kernel's time and launch count, the 12
kernels that took the most time, and the 10 host operations and CUDA
runtime calls with the most self time on the host.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def busy_microseconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, last_end = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end <= last_end:
            continue
        total += end - max(start, last_end)
        last_end = end
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", action="store_true",
                        help="one list through apply_batch")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    chip_smoke.set_gates(None)
    segmentation, embedding = chip_smoke.make_models(torch.bfloat16)
    pipeline = chip_smoke.build_pipeline(segmentation, embedding, device)
    run = chip_smoke.run_batch if args.batch else chip_smoke.run_one_by_one
    with tempfile.TemporaryDirectory() as tmp:
        files = chip_smoke.write_files(Path(tmp), chip_smoke.FILE_MINUTES)
        for _ in range(2):
            run(pipeline, files)
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            start = time.perf_counter()
            run(pipeline, files)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
    intervals, by_name, counts = [], defaultdict(float), defaultdict(int)
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        intervals.append((event.time_range.start, event.time_range.end))
        by_name[event.name] += event.time_range.elapsed_us()
        counts[event.name] += 1
    if not intervals:
        print("the profiler recorded no device events", file=sys.stderr)
        return 1
    busy = busy_microseconds(intervals) / 1e3
    lstm = [name for name in by_name if "lstm_recurrence" in name]
    minutes = sum(chip_smoke.FILE_MINUTES)
    mode = "apply_batch" if args.batch else "apply, file by file"
    print(f"accelerator pass ({mode}) on {minutes:g} min of audio: wall "
          f"{wall * 1e3:.3f} ms, card busy {busy:.3f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.3f}")
    print(f"LSTM recurrence kernel: "
          f"{sum(by_name[n] for n in lstm) / 1e3:.3f} ms in "
          f"{sum(counts[n] for n in lstm)} launches "
          f"({sum(by_name[n] for n in lstm) / 1e3 / busy:.1%} of busy)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3:9.3f} ms {counts[name]:6d}x  {name[:100]}")
    print("host: the 10 operations and runtime calls with the most self "
          "time on the host")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for event in host[:10]:
        print(f"  {event.self_cpu_time_total / 1e3:9.3f} ms "
              f"{event.count:6d}x  {event.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
