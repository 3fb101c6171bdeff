"""Time the parts of the streamed LSTM forward's step on one card.

    python3 tools/lstm_stream_parts.py [--out FILE]

Each variant is ``pyannote_audio_tpu_torch/csrc/lstm_recurrence.cu``
built with ``-DLSTM_STREAM_PROBE=bits`` (see ``kProbe`` in the source),
which drops parts of the streamed route's step at compile time; the
build the port loads drops nothing. The variants, built in parallel (one
nvcc each, into the package's git-ignored ``_build/``):

- ``whole``: the kernel as the port runs it;
- ``no product``, ``no exchange``, ``no ring copies``: without the
  recurrent product, the exchange of h between the CTAs of a cluster, or
  the ring's bulk copies (wrong values; for the split only);
- ``none of the three``: what is left (the cells, xw's reads, out's
  writes and the step's barriers; the chunk loops, emptied, are compiled
  away);
- ``one pass`` ("highest" only): the product's hi.hi pass alone, a single
  TF32 pass. It is the control of chip_smoke.py's limit for "highest" on
  this route: its error against the plain version is printed beside the
  kernel's and must exceed ``STREAM_ATOL["highest"]``, which the kernel
  must meet.

Times are medians of 5 launches by CUDA events after a warm-up, at
(T, B, H, D) = (589, 32, 512, 2) and (589, 256, 512, 2) in "highest" and
(589, 32, 512, 2) in "high", on chip_smoke.py's seeded layer inputs; the
control's error is read at phase 3's timed streamed shapes in "highest"
(589 x 32 and 256 at H = 257, 384 and 512, and 589 x 171 at H = 512).
The card's name and power limit are printed first; each result is one
JSON line, also appended to ``--out``. Exits 1 if the control does not
tell the passes apart.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (STREAM_ATOL, WIDE_BATCHES, WIDE_D_IN,  # noqa: E402
                        WIDE_HIDDEN, WIDE_PIPELINE_BATCH, cuda_ms,
                        layer_inputs)
from pyannote_audio_tpu_torch.ops import lstm_kernel as lk  # noqa: E402
from pyannote_audio_tpu_torch.ops.lstm import \
    lstm_bidirectional_recurrence_plain  # noqa: E402
from pyannote_audio_tpu_torch.utils import build  # noqa: E402

VARIANTS = {"whole": 0, "no product": 1, "no exchange": 2,
            "no ring copies": 4, "none of the three": 7, "one pass": 32}
SHAPES = ((589, 32, 512, "highest"), (589, 256, 512, "highest"),
          (589, 32, 512, "high"))


def compile_variant(bits: int) -> ctypes.CDLL:
    """lstm_recurrence.cu built with LSTM_STREAM_PROBE = ``bits``."""
    built = build.build("lstm_recurrence", (f"LSTM_STREAM_PROBE={bits}",))
    lib = ctypes.CDLL(str(built["path"]))
    lib.lstm_recurrence.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    lib.lstm_recurrence.restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, xw: torch.Tensor,
           prepared: lk.RecurrentWeights) -> torch.Tensor:
    """One launch of a variant, as ``lstm_kernel._launch_forward`` makes
    it for the streamed route."""
    T, B, _ = xw.shape
    D, H = prepared.packed.shape[0], prepared.hidden
    g = lk.kernel_geometry(H, prepared.precision, B, D)
    out = torch.empty((T, B, D * H), device=xw.device)
    err = lib.lstm_recurrence(
        xw.data_ptr(), prepared.packed.data_ptr(), out.data_ptr(), T, B, H,
        D, lk.MODES[prepared.precision], g["cluster"], g["rows"], g["ntw"],
        g["kparts"], g["chunk_steps"], g["resident"], g["slots"],
        g["per_slot"], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence variant failed: CUDA error {err}")
    return out


def emit(line: dict, out) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(text + "\n")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(compile_variant,
                                           VARIANTS.values())))
    device = torch.device("cuda", 0)
    for T, B, H, precision in SHAPES:
        xw, w_hh, _ = layer_inputs(device, T, B, WIDE_D_IN, H, 2, seed=H)
        prepared = lk.prepare_recurrent_weights(w_hh, precision)
        row = {name: cuda_ms(lambda: launch(lib, xw, prepared), runs=5,
                             warmup=1)
               for name, lib in libs.items()
               if name != "one pass" or precision == "highest"}
        emit({"kind": "parts", "card": card, "shape": [T, B, H, 2],
              "precision": precision, "ms": row}, args.out)
        del xw, w_hh, prepared
        torch.cuda.empty_cache()
    limit = STREAM_ATOL["highest"]
    told_apart = True
    for T, B, H in [(589, B, H) for H in WIDE_HIDDEN for B in WIDE_BATCHES] \
            + [WIDE_PIPELINE_BATCH]:
        xw, w_hh, _ = layer_inputs(device, T, B, WIDE_D_IN, H, 2, seed=H)
        prepared = lk.prepare_recurrent_weights(w_hh, "highest")
        ref = lstm_bidirectional_recurrence_plain(xw, w_hh, "highest")
        errs = {name: (launch(libs[name], xw, prepared) - ref).abs().max()
                .item() for name in ("whole", "one pass")}
        told_apart &= errs["whole"] <= limit < errs["one pass"]
        emit({"kind": "control", "card": card, "shape": [T, B, H, 2],
              "precision": "highest", "limit": limit,
              "max_abs_err": errs}, args.out)
        del xw, w_hh, prepared, ref
        torch.cuda.empty_cache()
    return 0 if told_apart else 1


if __name__ == "__main__":
    sys.exit(main())
