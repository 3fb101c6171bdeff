"""Time both LSTM kernels' streamed route (H > 256) from one checkout.

    python3 tools/lstm_stream_compare.py [--tree DIR] [--out FILE]

The forward kernel (``lstm_bidirectional_recurrence``) at the streamed
shapes of PERF.md section 6, (T, B, H, D) = (589, 32 and 256, 257 / 384 /
512, 2) and the H = 512 pipeline's batch of 3 minutes, (589, 171, 512, 2),
in each precision and (589, 8, 1024, 2) in "default", medians of 5
launches; the backward (``lstm_recurrence_backward``, the whole call: the
backward kernel and the grad_W_hh product) at (589, 32, 384 and 512, 2),
medians of 5; and, to show them unchanged, the on-chip shapes of
``tools/lstm_onchip_compare.py`` (the forward at (589, 256, 128, 2) in
each precision and (293, 256, 128, 2) "default", medians of 20; the
backward at (589, 32, 128, 2), median of 10). CUDA events after warm-up
calls, inputs seeded. ``--tree`` imports the package from another
checkout (for example the parent commit unpacked beside this one), so two
commits are timed by the same script in one call, alternating: parent,
change, change, parent. The card's name and power limit are printed
first; the result is one JSON line, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from lstm_onchip_compare import cuda_ms, inputs  # noqa: E402

STREAMED = [(589, B, H, ("default", "high", "highest"))
            for H in (257, 384, 512) for B in (32, 256)] \
    + [(589, 171, 512, ("default", "high", "highest")),
       (589, 8, 1024, ("default",))]
BACKWARD = [(589, 32, 384), (589, 32, 512)]


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
              "backward_ms": {}, "onchip_forward_ms": {},
              "onchip_backward_ms": {}}
    for T, B, H, modes in STREAMED:
        xw, w_hh, _ = inputs(T, B, H, 2, seed=H + B)
        for mode in modes:
            prepared = lk.prepare_recurrent_weights(w_hh, mode)
            result["forward_ms"][f"({T}, {B}, {H}) {mode}"] = cuda_ms(
                lambda: lk.lstm_bidirectional_recurrence(
                    xw, w_hh, mode, prepared), runs=5, warmup=1)
        del xw, w_hh
        torch.cuda.empty_cache()
    for T, B, H in BACKWARD:
        xw, w_hh, grad = inputs(T, B, H, 2, seed=B + H)
        result["backward_ms"][f"({T}, {B}, {H})"] = cuda_ms(
            lambda: lk.lstm_recurrence_backward(xw, w_hh, grad), runs=5,
            warmup=1)
        del xw, w_hh, grad
        torch.cuda.empty_cache()
    for T, modes in ((589, ("default", "high", "highest")),
                     (293, ("default",))):
        xw, w_hh, _ = inputs(T, 256, 128, 2, seed=T)
        for mode in modes:
            prepared = lk.prepare_recurrent_weights(w_hh, mode)
            result["onchip_forward_ms"][f"({T}, 256, 128) {mode}"] = cuda_ms(
                lambda: lk.lstm_bidirectional_recurrence(
                    xw, w_hh, mode, prepared), runs=20)
    xw, w_hh, grad = inputs(589, 32, 128, 2, seed=32)
    result["onchip_backward_ms"]["(589, 32, 128)"] = cuda_ms(
        lambda: lk.lstm_recurrence_backward(xw, w_hh, grad), runs=10)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
