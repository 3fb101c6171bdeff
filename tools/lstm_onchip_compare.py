"""Time both LSTM kernels' on-chip route (H <= 256) from one checkout.

    python3 tools/lstm_onchip_compare.py [--tree DIR] [--out FILE]

The forward kernel (``lstm_bidirectional_recurrence``) at PyanNet's
serving shape (T, B, H, D) = (589, 256, 128, 2) in each precision and at
(293, 256, 128, 2) in "default", medians of 20 launches; the backward
(``lstm_recurrence_backward``, the whole call: the backward kernel and
the grad_W_hh product) at (589, 32, 128, 2) and DPRNN's (100, 3264, 128,
2), medians of 10; CUDA events after 2 warm-up calls, inputs seeded.
``--tree`` imports the package from another checkout (for example the
parent commit unpacked beside this one), so two commits are timed by the
same script in one call, alternating: parent, change, change, parent.
The card's name and power limit are printed first; the result is one
JSON line, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch


def cuda_ms(fn, runs: int, warmup: int = 2) -> float:
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


def inputs(T, B, H, D, seed):
    gen = torch.Generator().manual_seed(seed)
    xw = torch.randn(T, B, D * 4 * H, generator=gen)
    w_hh = (torch.rand(D, 4 * H, H, generator=gen) * 2 - 1) * H ** -0.5
    grad = torch.randn(T, B, D * H, generator=gen)
    return xw.cuda(), w_hh.cuda(), grad.cuda()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve()
                                              .parent.parent))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from pyannote_audio_tpu_torch.ops import lstm_kernel as lk
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"tree": args.tree, "card": card, "forward_ms": {},
              "backward_ms": {}}
    for T, modes in ((589, ("default", "high", "highest")),
                     (293, ("default",))):
        xw, w_hh, _ = inputs(T, 256, 128, 2, seed=T)
        for mode in modes:
            prepared = lk.prepare_recurrent_weights(w_hh, mode)
            result["forward_ms"][f"({T}, 256) {mode}"] = cuda_ms(
                lambda: lk.lstm_bidirectional_recurrence(
                    xw, w_hh, mode, prepared), runs=20)
    for T, B in ((589, 32), (100, 3264)):
        xw, w_hh, grad = inputs(T, B, 128, 2, seed=B)
        result["backward_ms"][f"({T}, {B})"] = cuda_ms(
            lambda: lk.lstm_recurrence_backward(xw, w_hh, grad), runs=10)
        del xw, w_hh, grad
        torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
