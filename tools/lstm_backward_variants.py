"""Time design variants of the port's LSTM backward kernel on one card.

    python3 tools/lstm_backward_variants.py [VARIANT ...]

Each variant is ``pyannote_audio_tpu_torch/csrc/lstm_recurrence_backward
.cu`` with one part of a step undone by a textual edit, so that the time
the part costs shows against the kernel as it is:

- ``final``: the kernel as it is;
- ``one pass``: the products' hi.hi pass only (TF32 accuracy, a third
  of the mma);
- ``no product``: no mma at all (the operands are still loaded and split);
- ``fast gates``: the gate math with __expf and __fdividef (not float32
  accurate; for the split only);
- ``no exchange``: no st.async between the CTAs of a cluster and nothing
  awaited from them (wrong values; for the split only);
- ``no global stores`` / ``no global loads``: without the workspace's,
  h_prev's and grad_xw's stores, or with constants for the loads of xw,
  the workspace and grad_out (wrong values, and the compiler folds much
  of the walk's gate math on the constants; for the split only);
- ``rows 32``: the kernel as it is at 32 batch rows per cluster at DPRNN's
  shape (64 by the geometry), the baseline of the next two;
- ``two CTAs per SM``: launch bounds of two CTAs per SM (at most 128
  registers a thread) at every rows count (the kernel takes them up to
  16 rows), at 32 rows at DPRNN's shape;
- ``two CTAs per SM, A in float32``: the same with W_hh's fragments kept
  in registers as float32 and split into hi and lo at each use (half the
  registers).

Beside them, a microbenchmark of the instructions the products use, per
SM partition: ``mma.sync`` m16n8k8 TF32 and m16n8k16 bf16 issued as 8
independent chains per warp, and float32 FMA, at 8 warps on every SM.

All variants are built in parallel (one nvcc each) into the package's
git-ignored ``_build/variants/`` and timed in turns (CUDA events, medians
of 10) by their phases alone (the recompute, the walk) at (T, B, H, D) =
(589, 32, 128, 2) and (100, 3264, 128, 2); with names given, only those
variants (and ``final``) run. An edit that no longer matches the source
raises. The card's name and power limit are printed
first; each result is one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pyannote_audio_tpu_torch.ops import lstm_kernel  # noqa: E402
from pyannote_audio_tpu_torch.utils import build  # noqa: E402

SHAPES = ((589, 32), (100, 3264))
VARIANTS = {
    "final": [],
    "one pass": [
        ("""        for (int n = 0; n < NT; ++n)  // lo . hi
          mma_tf32(""", """        for (int n = 0; n < 0; ++n)  // lo . hi
          mma_tf32("""),
        ("""        for (int n = 0; n < NT; ++n)  // hi . lo
          mma_tf32(""", """        for (int n = 0; n < 0; ++n)  // hi . lo
          mma_tf32("""),
    ],
    "no product": [
        ("""  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));""",
         """  c[0] += __uint_as_float(a.x ^ b0);
  c[1] += __uint_as_float(a.y ^ b1);"""),
    ],
    "fast gates": [
        ("""  return 1.0f / (1.0f + expf(-x));""",
         """  return __fdividef(1.0f, 1.0f + __expf(-x));"""),
    ],
    "no exchange": [
        ("""    const unsigned remote_bytes = (C - 1) * HC * R * 4;""",
         """    const unsigned remote_bytes = 0;"""),
        ("""    const unsigned remote_bytes = (C - 1) * parts * HC * R * 4;""",
         """    const unsigned remote_bytes = 0;"""),
        ("""            st_async16(cluster_addr(off, peer), v, cluster_addr(bar, peer));""",
         """            if (v.x == 0xffffffffu) st_async16(off, v, bar);"""),
        ("""            st_async8(base + (o0 + 8 * m) * 4, out[m][0], out[m][1], bar);
            st_async8(base + (o1 + 8 * m) * 4, out[m][2], out[m][3], bar);""",
         """            if (out[m][0] == 1e30f) st_async8(base, out[m][1], out[m][2], bar);"""),
    ],
    "no global stores": [
        ("""        if (b < B && u < H) {
          float* w = p.ws""", """        if (b < 0) {
          float* w = p.ws"""),
        ("""        if (b < B && u < H) {
          float* gx""", """        if (b < 0) {
          float* gx"""),
    ],
    "no global loads": [
        ("""        for (int q = 0; q < 4; ++q) x[j][q] = valid ? src[q * H] : 0.0f;""",
         """        for (int q = 0; q < 4; ++q) x[j][q] = valid ? 0.5f + q : 0.0f;"""),
        ("""        for (int q = 0; q < 4; ++q) v[j][q] = valid ? w[q * H] : 0.0f;
        if (fresh) v[j][4] = valid ? w[4 * H] : 0.0f;""",
         """        for (int q = 0; q < 5; ++q) v[j][q] = valid ? 0.5f : 0.0f;"""),
        ("""p.ws[((prev * B + b) * D + d) * ws_row + 4 * H + u]""", "0.5f"),
        ("""p.grad_out[(t_idx * B + b) * out_row + d * H + u]""", "0.5f"),
    ],
    "rows 32": [],
    "two CTAs per SM": [
        ("""__global__ void __launch_bounds__(16 * HC, NT <= 2 ? 2 : 1)""",
         """__global__ void __launch_bounds__(16 * HC, 2)"""),
    ],
    "two CTAs per SM, A in float32": [
        ("""__global__ void __launch_bounds__(16 * HC, NT <= 2 ? 2 : 1)""",
         """__global__ void __launch_bounds__(16 * HC, 2)"""),
        ("""  uint4 a_hi[kRegs ? kFrags : 1], a_lo[kRegs ? kFrags : 1];""",
         """  uint4 a_hi[kRegs ? kFrags : 1], a_lo[1];"""),
        ("""        if (i < F) split4(src[(warp * F + i) * 32 + lane], a_hi[i], a_lo[i]);""",
         """        if (i < F) a_hi[i] = src[(warp * F + i) * 32 + lane];"""),
        ("""          ahi = a_hi[i];
          alo = a_lo[i];""", """          split4(a_hi[i], ahi, alo);"""),
    ],
}
# batch rows per cluster at DPRNN's shape, where a variant sets them
ROWS = {"rows 32": 32, "two CTAs per SM": 32,
        "two CTAs per SM, A in float32": 32}

MICRO = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void mma_tf32(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  uint32_t b0 = a0 * 3, b1 = a0 * 5;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]),
                     "+f"(acc[n][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  float s = 0;
  for (int n = 0; n < 8; ++n) s += acc[n][0] + acc[n][1] + acc[n][2] + acc[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void mma_bf16(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  uint32_t b0 = a0 * 3, b1 = a0 * 5;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]),
                     "+f"(acc[n][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  float s = 0;
  for (int n = 0; n < 8; ++n) s += acc[n][0] + acc[n][1] + acc[n][2] + acc[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void fma_f32(float* out, int iters) {
  float acc[16];
  for (int n = 0; n < 16; ++n) acc[n] = threadIdx.x + n;
  const float x = out[0], y = out[1];
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[n] = fmaf(acc[n], x, y);
  float s = 0;
  for (int n = 0; n < 16; ++n) s += acc[n];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int micro(int which, float* out, int blocks, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) mma_tf32<<<blocks, 256, 0, s>>>(out, iters);
  if (which == 1) mma_bf16<<<blocks, 256, 0, s>>>(out, iters);
  if (which == 2) fma_f32<<<blocks, 256, 0, s>>>(out, iters);
  return cudaGetLastError();
}
"""


def cuda_ms(fn, runs: int = 10) -> float:
    for _ in range(2):
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


def compile_variant(name: str, edits: list, out_dir: Path) -> Path:
    source = (build.CSRC_DIR / "lstm_recurrence_backward.cu").read_text()
    for old, new in edits:
        if old not in source:
            raise ValueError(f"variant {name!r}: edit does not match")
        source = source.replace(old, new)
    slug = "".join(c if c.isalnum() else "_" for c in name)
    src = out_dir / f"{slug}.cu"
    src.write_text(source)
    lib = out_dir / f"lib{slug}.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], check=True,
                          capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"{name}: {line.strip()}", flush=True)
    return lib


def compile_micro(out_dir: Path) -> Path:
    src = out_dir / "micro.cu"
    src.write_text(MICRO)
    lib = out_dir / "libmicro.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return lib


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    chosen = {name: edits for name, edits in VARIANTS.items()
              if len(sys.argv) == 1 or name in sys.argv[1:]
              or name == "final"}
    with ThreadPoolExecutor(len(chosen) + 1) as pool:
        futures = {name: pool.submit(compile_variant, name, edits, out_dir)
                   for name, edits in chosen.items()}
        micro_future = pool.submit(compile_micro, out_dir)
        libs = {name: f.result() for name, f in futures.items()}
        micro_lib = micro_future.result()

    micro = ctypes.CDLL(str(micro_lib)).micro
    micro.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p]
    out = torch.ones(132 * 256 * 4, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    for which, name, flops in ((0, "mma.sync m16n8k8 tf32", 2 * 16 * 8 * 8),
                               (1, "mma.sync m16n8k16 bf16",
                                2 * 16 * 8 * 16),
                               (2, "fma f32", None)):
        ms = cuda_ms(lambda: micro(which, out.data_ptr(), 132, iters,
                                   stream))
        if flops is None:  # 16 FMAs per thread per iteration
            total = 132 * 256 * iters * 16 * 2
        else:  # 8 mma per warp per iteration, 8 warps per SM
            total = 132 * 8 * iters * 8 * flops
        print(json.dumps({"kind": "micro", "card": card, "instruction": name,
                          "ms": ms, "tflops": total / ms / 1e9}),
              flush=True)

    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).lstm_recurrence_backward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    H, D = 128, 2
    for T, B in SHAPES:
        gen = torch.Generator().manual_seed(0)
        xw = (torch.randn(T, B, D * 4 * H, generator=gen) * 0.5).cuda()
        w_hh = ((torch.rand(D, 4 * H, H, generator=gen) * 2 - 1)
                / H ** 0.5).cuda()
        grad = torch.randn(T, B, D * H, generator=gen).cuda()
        geometry = lstm_kernel.backward_geometry(H, B, D)
        packed = lstm_kernel.pack_backward_weights(w_hh, geometry)
        rows_of = {name: ROWS.get(name, geometry["rows"])
                   if B > 1000 else geometry["rows"] for name in fns}
        ws = torch.empty((T, B, D, 5 * H), device="cuda")
        h_prev = torch.empty((D, T, B, H), device="cuda")
        grad_xw = torch.empty_like(xw)
        rows = {}
        for round_ in range(2):
            for name, fn in (fns.items() if round_ == 0
                             else reversed(list(fns.items()))):
                for phases, part in ((1, "recompute"), (2, "walk")):
                    def launch():
                        err = fn(xw.data_ptr(), grad.data_ptr(),
                                 packed.data_ptr(), ws.data_ptr(),
                                 h_prev.data_ptr(), grad_xw.data_ptr(), T,
                                 B, H, D, geometry["cluster"],
                                 rows_of[name], phases,
                                 geometry["resident"], geometry["ring"],
                                 geometry["frags_per_chunk"],
                                 geometry["stream_warps"], stream)
                        assert err == 0, err
                    rows.setdefault((name, part), []).append(cuda_ms(launch))
        for (name, part), times in rows.items():
            print(json.dumps({"kind": "variant", "card": card,
                              "variant": name, "part": part,
                              "shape": [T, B, H, D],
                              "rows": rows_of[name], "ms": times,
                              "us_per_step": [1e3 * t / T for t in times]}),
                  flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
