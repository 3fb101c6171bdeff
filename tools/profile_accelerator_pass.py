"""Profile one pass of the port's accelerator path on one card.

    python3 tools/profile_accelerator_pass.py

Builds the pipeline that ``chip_smoke.py`` drives (full-width PyanNet and
WeSpeaker ResNet34, seeded random weights, batch 256, the accelerator
gates at their defaults) on its synthetic files of 10 and 3 minutes, runs
two warm passes, then one pass under ``torch.profiler``. Prints the card's
name and power limit, the pass's wall time (host clock, card synchronised
at both ends), the card's busy time (the union of kernel and copy
intervals), the idle share, the LSTM recurrence kernel's time and launch
count, and the 12 kernels that took the most time.
"""

from __future__ import annotations

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
    with tempfile.TemporaryDirectory() as tmp:
        files = chip_smoke.write_files(Path(tmp), chip_smoke.FILE_MINUTES)
        for _ in range(2):
            pipeline([dict(f) for f in files], max_speakers=4)
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            start = time.perf_counter()
            pipeline([dict(f) for f in files], max_speakers=4)
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
    print(f"accelerator pass on {minutes:g} min of audio: wall "
          f"{wall * 1e3:.3f} ms, card busy {busy:.3f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.3f}")
    print(f"LSTM recurrence kernel: "
          f"{sum(by_name[n] for n in lstm) / 1e3:.3f} ms in "
          f"{sum(counts[n] for n in lstm)} launches "
          f"({sum(by_name[n] for n in lstm) / 1e3 / busy:.1%} of busy)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3:9.3f} ms {counts[name]:6d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
