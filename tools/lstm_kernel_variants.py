"""Time design variants of the port's LSTM recurrence kernel on one card.

    python3 tools/lstm_kernel_variants.py

Each variant is the kernel in ``pyannote_audio_tpu_torch/csrc/
lstm_recurrence.cu`` with one design choice undone by a textual edit:

- ``final``: the kernel as it is;
- ``cluster barrier``: h pushed into the peers' shared memory with plain
  stores and ordered by one split cluster barrier per step
  (barrier.cluster.arrive.release / wait.acquire) instead of st.async
  counted on mbarriers;
- ``A in shared memory``: "default" reads its mma A fragments from shared
  memory every step instead of keeping them in registers;
- ``accurate gates``: sigmoid and tanh with expf, tanhf and IEEE division.

All variants are built in parallel (one nvcc each) into the package's
git-ignored ``_build/variants/``, checked against the plain version in
the same precision, and timed in turns (CUDA events, median of 15
launches, two rounds) at PyanNet's shape (T, B, H, D) = (589, 256, 128,
2). An edit that no longer matches the source raises. The card's name and
power limit are printed first.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pyannote_audio_tpu_torch.ops import lstm_kernel  # noqa: E402
from pyannote_audio_tpu_torch.ops.lstm import \
    lstm_bidirectional_recurrence_plain  # noqa: E402
from pyannote_audio_tpu_torch.utils import build  # noqa: E402

SHAPE = (589, 256, 128, 2)
VARIANTS = {
    "final": [],
    "cluster barrier": [
        ("""    if (C > 1) {
      // h(t-1) of the peers""", """    if (C > 1 && t > 0)
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if (false) {
      // h(t-1) of the peers"""),
        ("""          st_async16(cluster_addr(h_addr + off, peer), v,
                     cluster_addr(bar, peer));""",
         """          *reinterpret_cast<uint4*>(
              cluster.map_shared_rank(h_s + off, peer)) = v;"""),
        ("""    // out after the step's synchronisation""",
         """    if (C > 1 && t + 1 < T)
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    // out after the step's synchronisation"""),
    ],
    "A in shared memory": [
        ("const bool a_in_regs = MODE == kDefault && S <= kRegSteps;",
         "const bool a_in_regs = false;"),
    ],
    "accurate gates": [
        ("return __fdividef(1.0f, 1.0f + __expf(-x));",
         "return 1.0f / (1.0f + expf(-x));"),
        ("return 2.0f * sigmoid(2.0f * x) - 1.0f;", "return tanhf(x);"),
    ],
}


def build_variant(name: str, edits) -> Path:
    source = (build.CSRC_DIR / "lstm_recurrence.cu").read_text()
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"variant {name!r}: edit does not match the "
                             f"source once: {old[:60]!r}")
        source = source.replace(old, new)
    directory = build.BUILD_DIR / "variants"
    directory.mkdir(parents=True, exist_ok=True)
    stem = name.replace(" ", "_")
    cu, lib = directory / f"{stem}.cu", directory / f"lib{stem}.so"
    cu.write_text(source)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS,
                                           VARIANTS.values())))
    T, B, H, D = SHAPE
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    xw = torch.randn(T, B, D * 4 * H, generator=gen).to(device)
    w_hh = ((torch.rand(D, 4 * H, H, generator=gen) * 2 - 1)
            / H ** 0.5).to(device)
    out = torch.empty(T, B, D * H, device=device)
    for precision in ("default", "high", "highest"):
        prepared = lstm_kernel.prepare_recurrent_weights(w_hh, precision)
        ref = lstm_bidirectional_recurrence_plain(xw, w_hh, precision)
        times = {name: [] for name in libs}
        for _ in range(2):
            for name, path in libs.items():
                fn = ctypes.CDLL(str(path)).lstm_recurrence
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
                    + [ctypes.c_void_p]

                def launch():
                    err = fn(xw.data_ptr(), prepared.packed.data_ptr(),
                             out.data_ptr(), None, T, B, H, D,
                             lstm_kernel.MODES[precision], prepared.cluster,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                launch()
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                runs = []
                for _ in range(15):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    launch()
                    end.record()
                    torch.cuda.synchronize()
                    runs.append(start.elapsed_time(end))
                times[name].append((statistics.median(runs), err))
        for name, results in times.items():
            print(f"{precision:8s} {name:20s} "
                  + " / ".join(f"{ms:.3f} ms" for ms, _ in results)
                  + f"  max_abs_err vs plain {results[0][1]:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
