"""Time the parts of the LSTM recurrence's backward on one card.

    python3 tools/lstm_backward_profile.py [--tree DIR] [--out FILE]

``LSTMRecurrence``'s backward (``ops/lstm_kernel.py``
``lstm_recurrence_backward``) runs three parts: the "highest" recompute of
the layer into a (T, B, D, 5H) workspace, the reverse walk through time
for grad_xw, and one float32 product for grad_W_hh. This script times
each part alone with CUDA events (medians of 10 launches after 2 warm-up
launches), the whole call, and cuDNN's float32 layer backward
(``torch.nn.LSTM``, TF32 off) on the same shape, at the training shapes
(T, B, H, D) = (589, 32 / 16, 128, 2) and DPRNN's (100, 3264 / 1632, 128,
2). Two scans split a step's time:

- the hidden size at (589, 32): each part's time per step against the
  size of the product per step;
- the batch at T = 100, H = 128: each part's time against the number of
  CTAs it launches, i.e. the waves of one CTA per SM;
- for the one-kernel design, the rows per cluster at T = 100 and one
  grid of 128 CTAs: a step's time against the rows it carries.

``--tree`` imports the package from another checkout (for example the
parent commit unpacked beside this one), so two designs are timed by the
same script in one call. Each design is driven through the entry points
its own module has: the workspace recompute of the forward kernel and the
separate walk kernel (``_launch_forward`` with a workspace,
``pack_backward_weights``), or the one backward kernel's phases
(``_launch_backward`` with ``phases`` 1 and 2). The card's name and power
limit are printed first; every result is one JSON line, also appended to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SMS = 132


def cuda_ms(fn, runs: int = 10, warmup: int = 2) -> float:
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


def inputs(T, B, H, D, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bound = H ** -0.5
    xw = torch.randn(T, B, D * 4 * H, generator=gen) * 0.5
    w_hh = (torch.rand(D, 4 * H, H, generator=gen) * 2 - 1) * bound
    grad = torch.randn(T, B, D * H, generator=gen)
    return (t.cuda().contiguous() for t in (xw, w_hh, grad))


def product_ms(lk, grad_xw, h_prev, T, B, H, D) -> float:
    """The grad_W_hh product as the design's module computes it: one
    batched product over a permuted view (the walk-kernel design), or
    one 2-D product per direction (the one-kernel design)."""
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32

    def batched():
        with exact_float32():
            torch.matmul(grad_xw.view(T * B, D, 4 * H).permute(1, 2, 0),
                         h_prev.view(D, T * B, H))
    return cuda_ms(lambda: lk.grad_w_hh_product(grad_xw, h_prev)
                   if hasattr(lk, "grad_w_hh_product") else batched())


def parts_walk_kernel(lk, T, B, H, D) -> dict:
    """The design with the forward kernel's workspace recompute and a
    separate walk kernel."""
    xw, w_hh, grad = inputs(T, B, H, D)
    prepared = lk.prepare_recurrent_weights(w_hh, "highest")
    packed, cluster = lk.pack_backward_weights(w_hh)
    ws = torch.empty((T, B, D, 5 * H), device="cuda")
    grad_xw = torch.empty_like(xw)
    lib = lk._backward_library()
    stream = torch.cuda.current_stream().cuda_stream

    def walk():
        err = lib.lstm_recurrence_backward(
            ws.data_ptr(), grad.data_ptr(), packed.data_ptr(),
            grad_xw.data_ptr(), T, B, H, D, cluster, stream)
        assert err == 0, err

    row = {"recompute_ms": cuda_ms(lambda: lk._launch_forward(
        xw, prepared, ws)),
        "forward_highest_ms": cuda_ms(lambda: lk._launch_forward(
            xw, prepared, None))}
    h = lk._launch_forward(xw, prepared, ws)
    row["walk_ms"] = cuda_ms(walk)

    def shifted():  # h_prev as this design builds it from the recomputed h
        h_prev = h.new_zeros((D, T, B, H))
        h_prev[0, 1:] = h[:-1, :, :H]
        if D == 2:
            h_prev[1, :-1] = h[1:, :, H:]
        return h_prev
    row["h_prev_ms"] = cuda_ms(shifted)
    row["product_ms"] = product_ms(lk, grad_xw, shifted(), T, B, H, D)
    row["whole_ms"] = cuda_ms(lambda: lk.lstm_recurrence_backward(
        xw, w_hh, grad))
    rows = -(-B // 8)
    row.update(cluster=cluster, rows=8, ctas=rows * cluster * D,
               warps=2 * lk.backward_geometry(H)["padded"] // cluster // 32)
    return row


def parts_one_kernel(lk, T, B, H, D) -> dict:
    """The design with the recompute and the walk as the two phases of
    one backward kernel."""
    xw, w_hh, grad = inputs(T, B, H, D)
    geometry = lk.backward_geometry(H, B, D)
    packed = lk.pack_backward_weights(w_hh, geometry)
    ws = torch.empty((T, B, D, 5 * H), device="cuda")
    h_prev = torch.empty((D, T, B, H), device="cuda")
    grad_xw = torch.empty_like(xw)

    def phases(which):
        return lambda: lk._launch_backward(xw, grad, packed, geometry, ws,
                                           h_prev, grad_xw, which)

    row = {"recompute_ms": cuda_ms(phases(1))}
    row["walk_ms"] = cuda_ms(phases(2))
    row["both_phases_ms"] = cuda_ms(phases(3))
    row["product_ms"] = product_ms(lk, grad_xw, h_prev, T, B, H, D)
    row["whole_ms"] = cuda_ms(lambda: lk.lstm_recurrence_backward(
        xw, w_hh, grad))
    row.update(cluster=geometry["cluster"], rows=geometry["rows"],
               ctas=-(-B // geometry["rows"]) * geometry["cluster"] * D,
               warps=geometry["warps"])
    return row


def cudnn_backward_ms(T, B, H) -> float:
    from pyannote_audio_tpu_torch.utils.runtime import exact_float32
    lstm = torch.nn.LSTM(2 * H, H, bidirectional=True).cuda()
    lstm.flatten_parameters()
    x = torch.randn(T, B, 2 * H, device="cuda", requires_grad=True)
    g = torch.randn(T, B, 2 * H, device="cuda")
    with exact_float32():
        y, _ = lstm(x)
        return cuda_ms(lambda: torch.autograd.grad(
            y, [x, *lstm.parameters()], g, retain_graph=True))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve()
                                              .parent.parent))
    parser.add_argument("--out", default=None)
    parser.add_argument("--no-scans", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from pyannote_audio_tpu_torch.ops import lstm_kernel as lk
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    design = "one kernel" if hasattr(lk, "_launch_backward") \
        else "walk kernel"
    parts = parts_one_kernel if design == "one kernel" \
        else parts_walk_kernel
    out = open(args.out, "a") if args.out else None

    def emit(kind, T, B, H, D, row):
        line = json.dumps({"tree": args.tree, "design": design, "card": card,
                           "kind": kind, "shape": [T, B, H, D], **row})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for T, B in ((589, 32), (589, 16), (100, 3264), (100, 1632)):
        row = parts(lk, T, B, 128, 2)
        row["cudnn_backward_ms"] = cudnn_backward_ms(T, B, 128)
        for key in ("recompute_ms", "walk_ms"):
            row[key.replace("_ms", "_us_per_step")] = 1e3 * row[key] / T
        emit("parts", T, B, 128, 2, row)
        torch.cuda.empty_cache()
    if args.no_scans:
        return
    for H in (32, 64, 96, 128):
        row = parts(lk, 589, 32, H, 2)
        row["walk_us_per_step"] = 1e3 * row["walk_ms"] / 589
        row["recompute_us_per_step"] = 1e3 * row["recompute_ms"] / 589
        emit("hidden scan", 589, 32, H, 2, row)
    for B in (8, 264, 528, 1056, 2112, 3264):
        row = parts(lk, 100, B, 128, 2)
        emit("batch scan", 100, B, 128, 2, row)
        torch.cuda.empty_cache()
    if design == "one kernel":
        # rows per cluster at one grid of 128 CTAs (B = 8 * rows): a
        # step's time against the rows it carries
        for rows in lk.BACKWARD_ROWS:
            B = 8 * rows
            xw, w_hh, grad = inputs(100, B, 128, 2)
            geometry = dict(lk.backward_geometry(128, B, 2), rows=rows)
            packed = lk.pack_backward_weights(w_hh, geometry)
            ws = torch.empty((100, B, 2, 5 * 128), device="cuda")
            h_prev = torch.empty((2, 100, B, 128), device="cuda")
            grad_xw = torch.empty_like(xw)
            row = {"rows": rows, "ctas": 8 * 8 * 2}
            for name, which in (("recompute", 1), ("walk", 2)):
                row[f"{name}_us_per_step"] = 10 * cuda_ms(
                    lambda: lk._launch_backward(xw, grad, packed, geometry,
                                                ws, h_prev, grad_xw, which))
            emit("rows scan", 100, B, 128, 2, row)


if __name__ == "__main__":
    main()
