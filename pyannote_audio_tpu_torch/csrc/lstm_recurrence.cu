// LSTM recurrence over hoisted input projections, both directions of a
// layer in one launch, with W_hh on chip and the recurrent product on
// tensor cores.
//
// Replaces the Pallas TPU kernel `pallas_lstm_cell`
// (pyannote_audio_tpu/ops/pallas_lstm.py, kernel body `_lstm_kernel`) and
// its fused-bidirectional call site `pallas_lstm_bidirectional_layer`,
// which ran both directions as one block-diagonal (8H, 2H) recurrence.
// Here the two directions are two rows of the grid instead, so no zero
// blocks are multiplied.
//
// What it computes, for direction d (d = 1 walks time backwards):
//   gates = xw[t, b, d*4H:(d+1)*4H] + h @ W_hh[d]^T   (gate order i, f, g, o)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//   out[t, b, d*H:(d+1)*H] = h
// with h = c = 0 before the first step. The backward direction reads xw and
// writes out at index T-1-t, so out is the torch bidirectional concat.
// The product h @ W_hh^T takes the JAX package's three precisions
// (PYANNOTE_TPU_LSTM_PRECISION): default = h and W_hh rounded to bf16,
// products summed in f32; high = bf16_3x (hi.hi + hi.lo + lo.hi); highest
// = f32. xw is added after the product; c, the gates and h are f32.
//
// Layout: xw (T, B, D*4H) f32, out (T, B, D*H) f32, and W_hh as
// `prepare_recurrent_weights` (ops/lstm_kernel.py) packs it: per
// (direction, CTA of the cluster) one contiguous block, bf16 mma A
// fragments (hi then lo for high) or f32 rows (highest).
//
// What bounds it: PyanNet runs 2 layers x 589 *sequential* steps per batch
// of 256 chunks. The work, 2*T*B*D*4H*H = 39.5 GFLOP at (589, 256, 128, 2),
// is 0.04 ms on the bf16 tensor cores and 0.59 ms on the f32 CUDA cores;
// the bytes (xw read, out written: 772 MB) are 0.23 ms of HBM. The time is
// the latency of 589 dependent steps: the product, the gate math and the
// exchange of h between the CTAs that share a batch row.
//
// Design. A cluster of C CTAs (2 at H = 128; 1 for H <= 16; up to 8 where
// the bytes require, H <= 256) owns kRows = 8 batch rows of one direction
// and walks all T steps in an in-block loop. Each CTA owns Hc = Hp / C <=
// 64 hidden units, a warp per 16, and all 4 gate rows of each: W_hh's
// share stays on chip for all T steps (64 KB of bf16 at H = 128, in
// registers for "default" up to H = 128, else in shared memory), and
// nothing reads it from device memory inside the time loop.
// - The product runs on tensor cores as gates^T (4 gates x 16 units, 8
//   rows) = W (64, Hp) . h^T (Hp, 8) per warp, with mma.sync m16n8k16
//   bf16 -> f32 (three passes for high): the batch rows are the n = 8 side,
//   and each gate is its own m16 tile, so a thread's accumulators hold i,
//   f, g and o of the same (unit, row) and the gate math needs no
//   exchange. wgmma is not needed: the product is latency-bound (32 mma
//   per warp per step), not throughput-bound. highest runs the same
//   ownership as f32 FMA on the CUDA cores.
// - Exchange of h: each CTA keeps all Hp units of h (bf16, hi and lo for
//   high, or f32), double-buffered by step parity. It writes its own slice
//   locally, and after the step's __syncthreads sends it to the peers with
//   st.async, which counts the bytes on the peer's mbarrier for that
//   parity; a CTA waits on its own mbarrier before the next product. No
//   fence or cluster barrier is in the time loop: a cluster-scope release
//   per step cost more than the exchange itself.
// - xw is prefetched kAhead steps ahead into a ring in shared memory with
//   16-byte cp.async; its layout (T, B, D*4H) is kept, so a CTA reads
//   8 rows x 4 gates x Hc floats per step. out is written after the
//   exchange, off the critical path. Padded units get zero xw and zero
//   weights, so their h stays 0.
// - A step is a chain of dependent latencies with one warp per scheduler.
//   A thread loads the xw of its 4 cells first, computes them together and
//   stores last, so their latencies overlap; sigmoid and tanh use the fast
//   exponential and division (__expf, __fdividef; tanh(x) = 2 sigmoid(2x)
//   - 1), within about 1e-7 of torch's, far inside every mode's bound
//   against the plain version (chip_smoke.py prints each mode's error at
//   every shape).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHidden = 256;
constexpr int kRows = 8;     // batch rows per cluster: the mma's n
constexpr int kStages = 6;   // xw ring depth
constexpr int kAhead = kStages - 2;  // steps prefetched ahead
constexpr int kMaxUnits = 64;        // hidden units per CTA
constexpr int kMaxThreads = 32 * kMaxUnits / 16;  // a warp per 16 units
constexpr int kRegSteps = 8;  // k-steps of A fragments kept in registers
constexpr long long kWaitCycles = 1LL << 34;  // ~9 s at 1.98 GHz
constexpr int kMaxSharedBytes = 227 * 1024;

enum Mode { kDefault = 0, kHigh = 1, kHighest = 2 };

struct Params {
  const float* xw;
  const void* w;
  float* out;
  int T, B, H, D;
  int padded;   // Hp: H rounded up to 16 * cluster
  int units;    // Hp / cluster: hidden units per CTA
  int cluster;
  int vec;      // 16-byte xw copies (H % 4 == 0, xw 16-byte aligned)
};

// Shared memory of one CTA: W block, xw ring, h double buffer.
__host__ __device__ size_t weight_bytes(int mode, int units, int padded) {
  const size_t n = 4 * static_cast<size_t>(units) * padded;
  return mode == kHighest ? n * 4 : (mode == kHigh ? 2 : 1) * n * 2;
}

__host__ __device__ size_t ring_floats(int units) {
  return static_cast<size_t>(kStages) * kRows * (4 * units + 4);
}

// one parity of h: bf16 [parts][kRows][Hp + 8] or f32 [Hp][kRows]
__host__ __device__ size_t h_parity_bytes(int mode, int padded) {
  return mode == kHighest
             ? static_cast<size_t>(padded) * kRows * 4
             : (mode == kHigh ? 2 : 1) * static_cast<size_t>(kRows) *
                   (padded + 8) * 2;
}

// + an mbarrier per h parity
__host__ __device__ size_t shared_bytes(int mode, int units, int padded) {
  return weight_bytes(mode, units, padded) + ring_floats(units) * 4 +
         2 * h_parity_bytes(mode, padded) + 2 * sizeof(uint64_t);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 2.0f * sigmoid(2.0f * x) - 1.0f;
}

__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// cp.async that zero-fills when !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// this CTA's one arrival of a phase, expecting `bytes` of st.async data
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity` to complete. A phase that never completes
// is a fault of the protocol: trap after kWaitCycles rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  const long long start = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - start > kWaitCycles) __trap();
  }
}

// 16 bytes into another CTA's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async16(unsigned remote, const uint4& v,
                                           unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

template <int MODE>
__global__ void __launch_bounds__(kMaxThreads)
lstm_recurrence_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = p.cluster;
  const int T = p.T, B = p.B, H = p.H, Hp = p.padded, Hc = p.units;
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * kRows;  // first batch row
  const int unit0 = rank * Hc;  // this CTA's first hidden unit
  const int warps = Hc / 16;  // one per group of 16 units
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma lane group and its thread

  const size_t w_bytes = weight_bytes(MODE, Hc, Hp);
  const size_t hp_bytes = h_parity_bytes(MODE, Hp);
  unsigned char* w_s = smem;
  const int ring_row = 4 * Hc + 4;  // +4 floats: rows 2tq fall on other banks
  const int stage_floats = kRows * ring_row;
  float* ring = reinterpret_cast<float*>(smem + w_bytes);
  unsigned char* h_s =
      reinterpret_cast<unsigned char*>(ring + kStages * stage_floats);
  const int hb_row = Hp + 8;  // bf16 h row, padded: B-fragment reads are
                              // conflict-free
  // full[b]: the peers' h slices for parity b have landed
  uint64_t* full = reinterpret_cast<uint64_t*>(h_s + 2 * hp_bytes);
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // W_hh's block for this (direction, rank): loaded once, kept for all T
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const unsigned char*>(p.w) +
        (static_cast<size_t>(d) * C + rank) * w_bytes);
    uint4* dst = reinterpret_cast<uint4*>(w_s);
    for (size_t i = threadIdx.x; i < w_bytes / 16; i += blockDim.x)
      dst[i] = src[i];
    uint4* h16 = reinterpret_cast<uint4*>(h_s);
    for (size_t i = threadIdx.x; i < 2 * hp_bytes / 16; i += blockDim.x)
      h16[i] = make_uint4(0, 0, 0, 0);
  }

  // This CTA's h slice, sent to each peer after every step: 16-byte
  // chunks of bf16 rows [part][r][unit0, unit0 + Hc), or f32 rows
  // [unit0, unit0 + Hc)[kRows]
  constexpr int kParts = MODE == kHigh ? 2 : 1;
  const int row_chunks = Hc / 8;  // bf16
  const int chunks = MODE == kHighest ? Hc * 2 : kParts * kRows * row_chunks;
  auto chunk_offset = [&](int c) -> size_t {
    if constexpr (MODE == kHighest)
      return static_cast<size_t>(unit0) * kRows * 4 + c * 16;
    const int row = c / row_chunks;  // part * kRows + r
    return (static_cast<size_t>(row) * hb_row + unit0) * 2 +
           (c % row_chunks) * 16;
  };
  const unsigned slice_bytes = chunks * 16;
  const unsigned h_addr = smem_addr(h_s), full_addr = smem_addr(full);

  const int64_t xw_row = static_cast<int64_t>(p.D) * 4 * H;
  const int64_t out_row = static_cast<int64_t>(p.D) * H;
  const float* xw_d = p.xw + static_cast<int64_t>(d) * 4 * H;

  // The CTA's xw of one step is 8 rows x 4 gates x Hc floats: 8 Hc
  // chunks of 16 bytes, kVecChunks for each of the 2 Hc threads. Their
  // offsets, less the step's, are computed once (-1: zero-fill).
  constexpr int kVecChunks = 4;
  int64_t chunk_src[kVecChunks];
  int chunk_dst[kVecChunks];
#pragma unroll
  for (int n = 0; n < kVecChunks; ++n) {
    const int i = threadIdx.x + n * blockDim.x;
    const int j = i % (Hc / 4), q = i / (Hc / 4) % 4, r = i / Hc;
    const int b = row0 + r, u = unit0 + 4 * j;
    chunk_src[n] = b < B && u < H ? b * xw_row + q * H + u : -1;
    chunk_dst[n] = r * ring_row + q * Hc + 4 * j;
  }

  // one commit group per step s
  auto prefetch = [&](int s) {
    if (s < T) {
      const int64_t t_idx = d ? T - 1 - s : s;
      const float* xw_t = xw_d + t_idx * B * xw_row;
      float* stage = ring + (s % kStages) * stage_floats;
      if (p.vec) {
#pragma unroll
        for (int n = 0; n < kVecChunks; ++n) {
          const bool valid = chunk_src[n] >= 0;
          cp_async16(stage + chunk_dst[n],
                     valid ? xw_t + chunk_src[n] : p.xw, valid);
        }
      } else {  // H % 4 != 0: 4-byte copies
        for (int i = threadIdx.x; i < kRows * 4 * Hc; i += blockDim.x) {
          const int j = i % Hc, q = i / Hc % 4, r = i / (4 * Hc);
          const int b = row0 + r, u = unit0 + j;
          const bool valid = b < B && u < H;
          cp_async4(stage + r * ring_row + q * Hc + j,
                    valid ? xw_t + b * xw_row + q * H + u : p.xw, valid);
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < kAhead; ++s) prefetch(s);
  cp_async_wait_ahead();  // step 0's xw has landed
  // this thread's 4 cells: units of fragment rows g + 8 * half, batch rows
  // 2tq + col; index e = half * 2 + col, as in the mma accumulators
  float c_state[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // W, zeroed h, step 0's xw and the mbarriers, in every CTA
  cluster_sync();

  // "default" up to H = 128 (S <= kRegSteps k-steps) keeps its A fragments
  // in registers (128 a thread), off the shared-memory path of every step
  const int S = Hp / 16;
  const bool a_in_regs = MODE == kDefault && S <= kRegSteps;
  uint4 a_reg[4][kRegSteps];
  if constexpr (MODE == kDefault) {
    if (a_in_regs) {
      const uint4* wa = reinterpret_cast<const uint4*>(w_s);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int s = 0; s < kRegSteps; ++s)
          a_reg[q][s] = s < S ? wa[((warp * 4 + q) * S + s) * 32 + lane]
                              : make_uint4(0, 0, 0, 0);
    }
  }

  for (int t = 0; t < T; ++t) {
    prefetch(t + kAhead);  // its slot was last read at step t - 2
    const int parity = t & 1;
    if (C > 1) {
      // h(t-1) of the peers (the use of full[parity] is t - 1 >> 1; this
      // CTA's own slice is ordered by the __syncthreads of step t - 1)
      if (t > 0) mbar_wait(&full[parity], ((t - 1) >> 1) & 1);
      // the peers' h(t), arriving in this step and the next
      if (threadIdx.x == 0 && t + 1 < T)
        mbar_expect(&full[parity ^ 1], (C - 1) * slice_bytes);
    }
    float acc[4][4];  // [gate][e]
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

    if constexpr (MODE == kHighest) {
      const float* hf =
          reinterpret_cast<const float*>(h_s + parity * hp_bytes);
      const float4* wr = reinterpret_cast<const float4*>(w_s);
      const int K4 = Hp / 4;
#pragma unroll 2
      for (int k4 = 0; k4 < K4; ++k4) {
        float2 hv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hv[j] = *reinterpret_cast<const float2*>(hf + (4 * k4 + j) * kRows +
                                                   2 * tq);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float4 wv =
                wr[(((warp * 4 + q) * K4 + k4) * 2 + half) * 8 + g];
            float* a = acc[q] + half * 2;
            a[0] = fmaf(wv.x, hv[0].x, a[0]);
            a[1] = fmaf(wv.x, hv[0].y, a[1]);
            a[0] = fmaf(wv.y, hv[1].x, a[0]);
            a[1] = fmaf(wv.y, hv[1].y, a[1]);
            a[0] = fmaf(wv.z, hv[2].x, a[0]);
            a[1] = fmaf(wv.z, hv[2].y, a[1]);
            a[0] = fmaf(wv.w, hv[3].x, a[0]);
            a[1] = fmaf(wv.w, hv[3].y, a[1]);
          }
      }
    } else if (a_in_regs) {
      const __nv_bfloat16* hb =
          reinterpret_cast<const __nv_bfloat16*>(h_s + parity * hp_bytes) +
          g * hb_row + 2 * tq;
#pragma unroll
      for (int s = 0; s < kRegSteps; ++s) {
        if (s < S) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(hb + s * 16);
          const uint32_t b1 =
              *reinterpret_cast<const uint32_t*>(hb + s * 16 + 8);
#pragma unroll
          for (int q = 0; q < 4; ++q) mma_bf16(acc[q], a_reg[q][s], b0, b1);
        }
      }
    } else {
      const __nv_bfloat16* hb =
          reinterpret_cast<const __nv_bfloat16*>(h_s + parity * hp_bytes) +
          g * hb_row + 2 * tq;
      const uint4* wa = reinterpret_cast<const uint4*>(w_s);
#pragma unroll 8
      for (int s = 0; s < S; ++s) {
        // B fragment: h^T rows k = 16s + 2tq (+1) and +8, column g
        const __nv_bfloat16* hk = hb + s * 16;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(hk);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(hk + 8);
        uint32_t l0 = 0, l1 = 0;
        if constexpr (MODE == kHigh) {
          const __nv_bfloat16* lk = hk + kRows * hb_row;
          l0 = *reinterpret_cast<const uint32_t*>(lk);
          l1 = *reinterpret_cast<const uint32_t*>(lk + 8);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 a = wa[((warp * 4 + q) * S + s) * 32 + lane];
          mma_bf16(acc[q], a, b0, b1);
          if constexpr (MODE == kHigh) {  // + hi.lo + lo.hi
            mma_bf16(acc[q], a, l0, l1);
            mma_bf16(acc[q],
                     wa[(((warps + warp) * 4 + q) * S + s) * 32 + lane], b0,
                     b1);
          }
        }
      }
    }

    // gate math: every load first, then the arithmetic of the 4 cells,
    // then every store, so the cells' latencies overlap
    const float* stage = ring + (t % kStages) * stage_floats;
    float x[4][4];  // [gate][e]
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q][e] = stage[(2 * tq + (e & 1)) * ring_row + q * Hc + warp * 16 +
                        g + 8 * (e >> 1)];
    float h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float i_g = sigmoid(x[0][e] + acc[0][e]);
      const float f_g = sigmoid(x[1][e] + acc[1][e]);
      const float g_g = tanh_fast(x[2][e] + acc[2][e]);
      const float o_g = sigmoid(x[3][e] + acc[3][e]);
      c_state[e] = f_g * c_state[e] + i_g * g_g;
      h[e] = o_g * tanh_fast(c_state[e]);
    }

    const size_t h_next = (parity ^ 1) * hp_bytes;  // the other parity
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * tq + (e & 1);
      const int u = unit0 + warp * 16 + g + 8 * (e >> 1);
      if constexpr (MODE == kHighest) {
        *reinterpret_cast<float*>(
            h_s + h_next + (static_cast<size_t>(u) * kRows + r) * 4) = h[e];
      } else {
        __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(h_s + h_next) +
                            r * hb_row + u;
        const __nv_bfloat16 hi = __float2bfloat16(h[e]);
        hb[0] = hi;
        if constexpr (MODE == kHigh)
          hb[kRows * hb_row] = __float2bfloat16(h[e] - __bfloat162float(hi));
      }
    }
    cp_async_wait_ahead();  // step t + 1's xw has landed
    // the slice and xw(t + 1) for every warp; every read of this step's
    // ring slot and h buffer done
    __syncthreads();
    if (C > 1 && t + 1 < T) {
      // publish the slice: st.async into each peer's h buffer, counted on
      // the peer's full[parity ^ 1]
      const unsigned bar = full_addr + (parity ^ 1) * sizeof(uint64_t);
      for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
        const size_t off = h_next + chunk_offset(c);
        const uint4 v = *reinterpret_cast<const uint4*>(h_s + off);
        for (int k = 1; k < C; ++k) {
          const int peer = (rank + k) % C;
          st_async16(cluster_addr(h_addr + off, peer), v,
                     cluster_addr(bar, peer));
        }
      }
    }
    // out after the step's synchronisation, off its critical path
    const int64_t t_idx = d ? T - 1 - t : t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = row0 + 2 * tq + (e & 1);
      const int u = unit0 + warp * 16 + g + 8 * (e >> 1);
      if (b < B && u < H)
        p.out[(t_idx * B + b) * out_row + d * H + u] = h[e];
    }
  }
  // no CTA leaves while a peer may still write into its shared memory
  cluster_sync();
}

template <int MODE>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_recurrence_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = (p.B + kRows - 1) / kRows;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(groups * p.cluster, p.D);
  config.blockDim = dim3(32 * (p.units / 16));
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t launched =
      cudaLaunchKernelEx(&config, lstm_recurrence_kernel<MODE>, p);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. `w` is the packed W_hh of
// `prepare_recurrent_weights` for this (H, mode, cluster); mode is 0
// (default), 1 (high) or 2 (highest). Returns a cudaError_t code: 0 on a
// successful launch. The launch is asynchronous on `stream`, on the
// current device.
extern "C" int lstm_recurrence(const void* xw, const void* w, void* out,
                               int T, int B, int H, int D, int mode,
                               int cluster, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxHidden || D < 1 || D > 2 ||
      mode < kDefault || mode > kHighest ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return cudaErrorInvalidValue;
  Params p;
  p.xw = static_cast<const float*>(xw);
  p.w = w;
  p.out = static_cast<float*>(out);
  p.T = T;
  p.B = B;
  p.H = H;
  p.D = D;
  p.padded = (H + 16 * cluster - 1) / (16 * cluster) * (16 * cluster);
  p.units = p.padded / cluster;
  p.cluster = cluster;
  p.vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(xw) % 16 == 0;
  if (p.units > kMaxUnits) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(mode, p.units, p.padded);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDefault:
      return launch<kDefault>(p, smem, s);
    case kHigh:
      return launch<kHigh>(p, smem, s);
    default:
      return launch<kHighest>(p, smem, s);
  }
}
