"""Where the float32 WavLM trunk's card time goes, kernel by kernel, with
the torch op that launched each kernel.

    python3 tools/ssl_trunk_profile.py [--tree DIR] [--batch 32]
                                       [--out FILE]

Builds SSeRiouSS at its defaults (the WavLM-base trunk, 12 x 768, float32
with TF32 off; seeded weights) on the card, runs one warm batch of
``--batch`` ten-second chunks under ``torch.inference_mode`` (the serving
path), then profiles one more batch with shapes recorded. Each kernel's
time is charged to the innermost torch op that launched it (the
profiler's CPU-op-to-kernel link) with that op's input shapes, so a
library kernel's name (``implicit_convolve_sgemm``, a cuBLAS GEMM) is tied
to the layer it ran. ``--tree`` imports the package from another checkout
(the parent commit unpacked beside this one). The card's name and power
limit are printed first; the result is one JSON line, also appended to
``--out``: the batch's wall (CUDA events), the kernels' summed time, and
the top kernels by time with their launching ops and shapes.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=None)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() if args.tree else ROOT))
    if not torch.cuda.is_available():
        print("ssl_trunk_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    from pyannote_audio_tpu_torch.models.segmentation.sseriouss import \
        SSeRiouSS
    device = torch.device("cuda")
    model = SSeRiouSS(generator=torch.Generator().manual_seed(50))
    model = model.to(device).eval()
    g = torch.Generator(device=device).manual_seed(51)
    x = 0.1 * torch.randn(args.batch, 1, 160000, generator=g, device=device)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model(x)
        end.record()
        torch.cuda.synchronize()
        wall = start.elapsed_time(end)
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities,
                                    record_shapes=True) as prof:
            model(x)
            torch.cuda.synchronize()
    from torch.autograd import DeviceType
    by_kernel = collections.defaultdict(float)  # every kernel on the card
    by_launch = collections.defaultdict(float)  # those a torch op launched
    seen = set()  # a kernel can be listed more than once: count it once
    for event in prof.events():
        span = (event.name, event.time_range.start, event.time_range.end)
        if event.device_type == DeviceType.CUDA and span not in seen:
            seen.add(span)
            by_kernel[event.name] += event.time_range.elapsed_us()
        for kernel in getattr(event, "kernels", []):
            by_launch[(kernel.name, event.name,
                       str(event.input_shapes))] += kernel.duration
    attributed = collections.defaultdict(float)
    for (kernel, _, _), us in by_launch.items():
        attributed[kernel] += us
    for kernel, us in by_kernel.items():
        if us - attributed[kernel] > 1.0:
            by_launch[(kernel, "(no torch op)", "")] += \
                us - attributed[kernel]
    total = sum(by_kernel.values())
    top = sorted(by_launch.items(), key=lambda kv: -kv[1])[:args.top]
    for (kernel, op, shapes), us in top:
        print(f"{us / 1e3:9.3f} ms  {100 * us / total:5.1f} %  "
              f"{kernel[:70]}  <- {op} {shapes[:120]}")
    record = {"card": card, "batch": args.batch, "wall_ms": wall,
              "kernels_ms": total / 1e3,
              "top": [{"kernel": k, "op": op, "shapes": shapes,
                       "ms": us / 1e3} for (k, op, shapes), us in top],
              "tree": args.tree or "."}
    line = json.dumps(record)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
