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
//
// Above H = 256 W_hh does not fit on chip (4H^2 values a direction: 2 MiB
// of bf16 at H = 512 against a cluster's 8 x 227 KiB), and the kernel takes
// its streamed route (lstm_stream_kernel). What bounds it: every step
// multiplies h by all of W_hh, so a cluster reads its direction's W_hh once
// per step, from L2 (it stays resident there: both directions' float32
// W_hh take 8 MiB at H = 512), and every one of the T steps waits for the
// previous one. At (589, 256, 512, 2) the operations are 0.64 ms on the
// bf16 tensor cores and 3.8 ms as three TF32 passes ("highest"); xw and
// out are 0.92 ms of HBM; what a design must keep small is L2 traffic per
// step (clusters x W_hh bytes) and the latency of a step.
// - Rows per cluster from B. A cluster of C CTAs (8, or 16 where H pads
//   to a multiple of 256 alike) owns R = 8 to 64 batch rows (a multiple
//   of 8) of one direction, chosen by `kernel_geometry` (ops/lstm_kernel.py)
//   so that D x ceil(B / R) clusters fit one wave of the card where B
//   allows (an H100 holds 15 clusters of 8 and 7 of 16 at one CTA an SM):
//   each fragment of W_hh read feeds R / 8 mma tiles, and L2 traffic per
//   step is D x ceil(B / R) x W_hh. Each CTA owns Hc = Hp / C units, all 4
//   gate rows of each; a consumer warp owns 16 units and NTW (1 to 4) of
//   the R / 8 row tiles, so a thread's accumulators hold i, f, g and o of
//   the same (unit, row) as on chip. Where those warps are few (small B),
//   KP of them (up to 4) split the chunks, and K-parts 1 .. KP - 1 hand
//   their partial sums to k-part 0 through shared memory: a lone warp's
//   chain of products and loads is latency-bound.
// - W_hh through shared memory. `prepare_recurrent_weights` packs W_hh
//   in chunks of KS k-steps (16 columns each) across all unit groups, so a
//   CTA's share of a chunk is one contiguous run of bytes. The first
//   `resident` chunks of the share are copied once into shared memory and
//   kept for all T steps (all of them where the share fits beside h); the
//   rest go through a ring of `slots` slots of up to 4 chunks fed by
//   cp.async.bulk (the bulk copy engine, counted on an mbarrier per slot)
//   by one producer warp (the consumers wait and release per slot: the
//   fewer, larger slots the better). The
//   ring runs across step boundaries: the next step's first chunks land
//   while this step's gate math and exchange of h run. Every consumer warp
//   reads its fragments of every chunk and then frees the slot (an mbarrier
//   counting the consumer warps), so the producer refills it.
// - "highest" on tensor cores: mma.sync m16n8k8 TF32 in three passes
//   (hi.hi + hi.lo + lo.hi), h and W_hh split into TF32 hi (rounded to
//   nearest, ties away, by integer arithmetic on the bits) and lo (the
//   rest, exact in float32) where a warp reads them; the small products sum
//   apart from hi.hi. W_hh's fragments stay float32 in memory, so each
//   value is split once per warp that reads it per step. "default" and
//   "high" keep their bf16 mma and the on-chip route's numerics.
// - The next step's xw is prefetched into L2 and read after the product;
//   h is exchanged in the cluster as on chip (st.async counted on the
//   peer's mbarrier per parity), its rows unpadded with their 16-byte
//   blocks swizzled by the row (the B fragments' reads fall on 32 banks);
//   the consumer warps synchronise on a named barrier that the producer
//   warp does not join. Each cluster starts its streamed chunks at its own
//   offset, and the ring's slots and parities are counted, not divided.
// Shared memory holds h (two parities), the k-parts' partial sums, the
// resident chunks and the ring: h alone caps H at 1792 ("default") or
// 1408 ("high", "highest") at R = 8.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHidden = 256;  // on chip; above, the streamed route
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
  // this (direction, rank)'s W block, copied into shared memory below and
  // kept for all T
  const unsigned char* w_g = static_cast<const unsigned char*>(p.w) +
                             (static_cast<size_t>(d) * C + rank) * w_bytes;
  const unsigned char* w_s = smem;
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
    const uint4* src = reinterpret_cast<const uint4*>(w_g);
    uint4* dst = reinterpret_cast<uint4*>(smem);
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
            mma_bf16(acc[q], wa[(((warps + warp) * 4 + q) * S + s) * 32 + lane],
                     b0, b1);
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


// ---------------------------------------------------------------------------
// The streamed route (H > 256).

constexpr int kRecord = 512;  // one fragment record: 32 lanes x 16 bytes

// For timing and controls only (tools/lstm_stream_parts.py builds its
// variants with -DLSTM_STREAM_PROBE=bits; 0, the build the port loads,
// drops nothing): bit 0 drops the product, bit 1 the exchange of h, bit 2
// the ring's copies, bit 3 (with bit 2) the chunk loops, bit 4 xw's reads
// and out's writes, bit 5 "highest"'s hi.lo and lo.hi passes
#ifndef LSTM_STREAM_PROBE
#define LSTM_STREAM_PROBE 0
#endif
constexpr int kProbe = LSTM_STREAM_PROBE;

// the most consumer warps of a streamed CTA at NTW row tiles per warp: with
// the producer warp, a multiple of 4 warps (the register file is allocated
// to warps in fours), whose registers fit one CTA per SM
__host__ __device__ constexpr int stream_warps(int ntw) {
  return ntw == 1 ? 15 : (ntw <= 3 ? 11 : 7);
}

struct StreamParams {
  const float* xw;
  const unsigned char* w;
  float* out;
  int T, B, H, D;
  int padded;       // Hp: H rounded up to 128
  int cluster;      // C: 8 or 16
  int units;        // Hc = Hp / C
  int groups;       // UG = Hc / 16 unit groups, a warp each per row group
  int row_groups;   // NG: warps per unit group, NTW row tiles each
  int rows;         // R = 8 * NG * NTW batch rows of the cluster (<= 64)
  int kparts;       // KP: warps per (unit group, row group), each reading
                    // every KP-th chunk
  int steps;        // S = ceil(H / 16) k-steps of 16 columns
  int chunk_steps;  // KS k-steps of a chunk (the last may hold fewer)
  int chunks;       // ceil(S / KS)
  int resident;     // chunks kept in shared memory for all T steps
  int slots;        // ring slots (0: every chunk resident)
  int per_slot;     // chunks a ring slot carries (1 to 4)
};

// fragment records of one (unit group, k-step, gate): bf16 A ("default"),
// its hi and lo ("high"), or the two float32 m16n8k8 A of the k-step's
// halves ("highest")
__host__ __device__ inline int stream_parts(int mode) {
  return mode == kDefault ? 1 : 2;
}

// bytes of one (unit group, k-step): 4 gates x parts records
__host__ __device__ inline size_t stream_step_bytes(int mode) {
  return 4 * static_cast<size_t>(stream_parts(mode)) * kRecord;
}

// one parity of h: bf16 [parts][R][Hp] or f32 [R][Hp], each row's 16-byte
// blocks swizzled (`swizzle`)
__host__ __device__ inline size_t stream_h_bytes(int mode, int rows,
                                                 int padded) {
  return mode == kHighest
             ? static_cast<size_t>(rows) * padded * 4
             : (mode == kHigh ? 2 : 1) * static_cast<size_t>(rows) * padded *
                   2;
}

// Where element k of an h row of the streamed route lies: its 16-byte
// block (of `per` elements, 8 bf16 or 4 f32) XOR the row's low 3 bits, so
// that the B fragments' reads of 8 rows at one column fall on 32 banks
// without padding the rows
__device__ __forceinline__ int swizzle(int row, int k, int per) {
  return ((k / per) ^ (row & 7)) * per + k % per;
}

__host__ __device__ inline size_t stream_chunk_bytes(int mode, int groups,
                                                     int chunk_steps) {
  return static_cast<size_t>(groups) * chunk_steps * stream_step_bytes(mode);
}

// the partial products of k-parts 1 .. KP - 1: each warp's 16 NTW
// accumulators a lane
__host__ __device__ inline size_t stream_red_bytes(int group, int ntw,
                                                   int kparts) {
  return static_cast<size_t>(kparts - 1) * group * 16 * ntw * 32 * 4;
}

// h, the partial products, the resident chunks, the ring (slots of
// per_slot chunks), and the mbarriers: h's two parities, the resident
// chunks', and each slot's full and empty
__host__ __device__ inline size_t stream_shared_bytes(int mode, int groups,
                                                      int rows, int padded,
                                                      int ntw, int kparts,
                                                      int chunk_steps,
                                                      int resident, int slots,
                                                      int per_slot) {
  return 2 * stream_h_bytes(mode, rows, padded) +
         stream_red_bytes(groups * (rows / 8 / ntw), ntw, kparts) +
         (resident + static_cast<size_t>(slots) * per_slot) *
             stream_chunk_bytes(mode, groups, chunk_steps) +
         (3 + 2 * static_cast<size_t>(slots)) * sizeof(uint64_t);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// `bytes` of W_hh from device memory (it stays in L2: every step reads
// it) into this CTA's shared memory by the bulk copy engine, counted on
// `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the phase of `parity` of an mbarrier that only this CTA's bulk
// copies and threads complete (CTA scope: the cluster-scope acquire of
// `mbar_wait` is for the peers' st.async); trap after kWaitCycles.
__device__ __forceinline__ void mbar_wait_cta(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  const long long start = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - start > kWaitCycles) __trap();
  }
}

// the consumer warps' barrier (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (nearest, ties away from zero: add
// half of the 13 dropped bits' unit, then drop them), lo = x - hi exactly;
// the tensor cores read lo's top 10 mantissa bits, so hi.lo + lo.hi miss
// about 2^-21 of each product
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

template <int MODE, int NTW>
__global__ void __launch_bounds__(32 * (stream_warps(NTW) + 1), 1)
lstm_stream_kernel(const StreamParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = p.cluster, T = p.T, B = p.B, H = p.H, Hp = p.padded;
  const int Hc = p.units, UG = p.groups, NG = p.row_groups, R = p.rows;
  const int KP = p.kparts;
  const int group = UG * NG;          // consumer warps of one k-part
  const int warps = group * KP;       // consumer warps
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * R;  // first batch row
  const int unit0 = rank * Hc;            // this CTA's first hidden unit
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma lane group and its thread
  constexpr int P = MODE == kDefault ? 1 : 2;
  constexpr int kHParts = MODE == kHigh ? 2 : 1;
  constexpr bool kF32 = MODE == kHighest;
  // "highest" at one row tile: hi.lo + lo.hi on their own accumulators, so
  // each gate has two independent chains
  constexpr bool kSmall = kF32 && NTW == 1;

  const size_t hp_bytes = stream_h_bytes(MODE, R, Hp);
  const size_t step_bytes = stream_step_bytes(MODE);
  const size_t chunk_bytes = stream_chunk_bytes(MODE, UG, p.chunk_steps);
  unsigned char* h_s = smem;
  float* red = reinterpret_cast<float*>(smem + 2 * hp_bytes);
  unsigned char* res_s =
      smem + 2 * hp_bytes + stream_red_bytes(group, NTW, KP);
  unsigned char* ring_s = res_s + p.resident * chunk_bytes;
  uint64_t* hfull = reinterpret_cast<uint64_t*>(
      ring_s + p.slots * p.per_slot * chunk_bytes);
  uint64_t* wres = hfull + 2;    // the resident chunks have landed
  uint64_t* wfull = hfull + 3;   // [slots]: the slot's chunk has landed
  uint64_t* wempty = wfull + p.slots;  // [slots]: every consumer is past it
  if (threadIdx.x == 0) {
    mbar_init(&hfull[0], 1);
    mbar_init(&hfull[1], 1);
    mbar_init(wres, 1);
    for (int i = 0; i < p.slots; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    uint4* h16 = reinterpret_cast<uint4*>(h_s);
    for (size_t i = threadIdx.x; i < 2 * hp_bytes / 16; i += blockDim.x)
      h16[i] = make_uint4(0, 0, 0, 0);
  }
  // chunk j: k-steps [j KS, j KS + ks), every unit group's records in turn;
  // this CTA's unit groups [rank UG, (rank + 1) UG) are one run of bytes.
  // K-part kp's warps read the kp-th run of the resident chunks and the
  // streamed chunks at positions kp (mod KP) of the ring; every consumer
  // warp waits for every chunk of the ring and frees it, so none runs more
  // than a phase of a slot ahead of the others. The ring's slots, parities
  // and chunks are counted, not divided out: a division a chunk cost more
  // than the chunk's products.
  const unsigned char* w_d =
      p.w + static_cast<size_t>(d) * p.steps * (Hp / 16) * step_bytes;
  auto chunk_ks = [&](int j) {
    return min(p.chunk_steps, p.steps - j * p.chunk_steps);
  };
  auto chunk_src = [&](int j) {
    return w_d + (static_cast<size_t>(j) * p.chunk_steps * (Hp / 16) +
                  static_cast<size_t>(rank) * UG * chunk_ks(j)) *
                     step_bytes;
  };
  // The streamed chunks of a step, in the order the ring carries them:
  // each cluster starts at its own chunk, so the clusters that read the
  // same share do not ask L2 for the same lines at once
  const int streamed = p.chunks - p.resident;
  const int rotation = streamed > 0 ? (blockIdx.x / C) % streamed : 0;
  // a ring slot carries per_slot chunks (the step's last, the rest): one
  // wait and one release for all of them
  const size_t slot_bytes = p.per_slot * chunk_bytes;
  const int slot_loads = (streamed + p.per_slot - 1) / p.per_slot;
  // zeroed h and the mbarriers, in every CTA
  cluster_sync();

  if (warp == warps) {
    // the producer: the resident chunks once, then the ring, T times over
    // the streamed chunks, each slot refilled once every consumer warp is
    // past it
    if (lane == 0) {
      if (p.resident > 0) {
        unsigned total = 0;
        for (int j = 0; j < p.resident; ++j)
          total += UG * chunk_ks(j) * step_bytes;
        mbar_expect(wres, total);
        for (int j = 0; j < p.resident; ++j)
          bulk_load(res_s + j * chunk_bytes, chunk_src(j),
                    UG * chunk_ks(j) * step_bytes, wres);
      }
      // a slot carries up to per_slot consecutive streamed chunks of a step
      const int loads = kProbe & 4 ? 0 : T * slot_loads;
      int slot = 0;          // the next slot
      int next = rotation;   // the next chunk, less the resident ones
      int first = 0;                  // the load's first chunk in the step
      unsigned parity = 0;            // of the slot's use
      for (int i = 0; i < loads; ++i) {
        // the slot's previous chunks read by every consumer warp
        if (i >= p.slots) mbar_wait_cta(&wempty[slot], parity ^ 1);
        const int count = min(p.per_slot, streamed - first);
        unsigned bytes = 0;
        for (int c = 0, n = next; c < count; ++c) {
          bytes += UG * chunk_ks(p.resident + n) * step_bytes;
          if (++n == streamed) n = 0;
        }
        mbar_expect(&wfull[slot], bytes);
        for (int c = 0; c < count; ++c) {
          const int j = p.resident + next;
          if (++next == streamed) next = 0;
          bulk_load(ring_s + slot * slot_bytes + c * chunk_bytes,
                    chunk_src(j), UG * chunk_ks(j) * step_bytes,
                    &wfull[slot]);
        }
        if ((first += count) == streamed) first = 0;
        if (++slot == p.slots) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
    __syncwarp();
    cluster_sync();
    return;
  }

  // a consumer warp: unit group ug (16 units, all 4 gates), row tiles
  // [ng NTW, (ng + 1) NTW) of the cluster's R / 8, k-part kp; k-part 0
  // sums the others' partial products and runs the cells
  const int ug = warp % UG, ng = warp / UG % NG, kp = warp / group;
  const int threads = 32 * warps;
  const int hrow = Hp;  // h row stride, in elements (rows swizzled)
  constexpr int kPer = kF32 ? 4 : 8;  // elements of a 16-byte block
  const int64_t xw_row = static_cast<int64_t>(p.D) * 4 * H;
  const int64_t out_row = static_cast<int64_t>(p.D) * H;
  // this thread's cells: units g + 8 * half of its group, rows 2tq + col of
  // its row tiles; index e = half * 2 + col, as in the mma accumulators
  auto cell_row = [&](int n, int e) {
    return row0 + 8 * (ng * NTW + n) + 2 * tq + (e & 1);
  };
  const int cell_unit0 = unit0 + 16 * ug + g;  // + 8 * (e >> 1)
  // this thread's cells in xw and out: the first row's offsets less the
  // step's, the rows 8 n + (e & 1) and units 8 (e >> 1) past them, and
  // which of them lie inside B and H (bit n * 4 + e)
  const int first_row = cell_row(0, 0);
  const int64_t xw_cell0 =
      static_cast<int64_t>(first_row) * xw_row + d * 4 * H + cell_unit0;
  const int64_t out_cell0 =
      static_cast<int64_t>(first_row) * out_row + d * H + cell_unit0;
  unsigned inside = 0;
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (cell_row(n, e) < B && cell_unit0 + 8 * (e >> 1) < H)
        inside |= 1u << (n * 4 + e);
  // xw of this thread's cell (n, e) at step s, gate q (null outside B, H)
  auto xw_cell = [&](int s, int n, int q, int e) -> const float* {
    const int64_t t_idx = d ? T - 1 - s : s;
    return inside >> (n * 4 + e) & 1
               ? p.xw + t_idx * B * xw_row + xw_cell0 +
                     (8 * n + (e & 1)) * xw_row + q * H + 8 * (e >> 1)
               : nullptr;
  };

  // This CTA's h slice, sent to each peer after every step: 16-byte
  // chunks of the rows [part][r][unit0, unit0 + Hc)
  const int row_chunks = kF32 ? Hc / 4 : Hc / 8;
  const int slice_chunks = kHParts * R * row_chunks;
  const unsigned slice_bytes = slice_chunks * 16;
  const unsigned h_addr = smem_addr(h_s), hfull_addr = smem_addr(hfull);
  auto slice_offset = [&](int c) -> size_t {
    const int row = c / row_chunks;
    return (static_cast<size_t>(row) * hrow +
            swizzle(row, unit0 + (c % row_chunks) * kPer, kPer)) *
           (kF32 ? 4 : 2);
  };
  // this warp's partial sums in `red`: [k-part - 1][warp of the part]
  // [gate, row tile, e][lane]
  auto red_at = [&](int part, int q, int n, int e) -> float* {
    return red + ((static_cast<size_t>(part - 1) * group + ug + UG * ng) *
                      16 * NTW +
                  (q * NTW + n) * 4 + e) *
                     32 +
           lane;
  };

  float c_state[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c_state[n][e] = 0.0f;
  // the xw of step s into L2, read after the product of step s
  auto prefetch_xw = [&](int s) {
    if (kProbe & 16) return;
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* x = xw_cell(s, n, q, e);
          if (x) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(x));
        }
  };
  if (kp == 0) prefetch_xw(0);
  if (p.resident > 0) mbar_wait_cta(wres, 0);
  int ring_slot = 0;         // the ring's next slot
  unsigned ring_parity = 0;  // and the parity of its use
  // this k-part's run of the resident chunks
  const int res_first = kp * p.resident / KP;
  const int res_last = (kp + 1) * p.resident / KP;

  for (int t = 0; t < T; ++t) {
    if (kp == 0 && t + 1 < T) prefetch_xw(t + 1);
    const int parity = t & 1;
    constexpr bool exchange = !(kProbe & 2);
    // h(t-1) of the peers (this CTA's own slice is ordered by the
    // consumers' barrier of step t - 1)
    if (t > 0 && exchange) mbar_wait(&hfull[parity], ((t - 1) >> 1) & 1);
    // the peers' h(t), arriving in this step and the next
    if (threadIdx.x == 0 && t + 1 < T && exchange)
      mbar_expect(&hfull[parity ^ 1], (C - 1) * slice_bytes);

    float acc[4][NTW][4];  // [gate][row tile][e]
    float small[kSmall ? 4 : 1][NTW][4];  // hi.lo + lo.hi
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[q][n][e] = 0.0f;
          if constexpr (kSmall) small[q][n][e] = 0.0f;
        }

    const unsigned char* h_t = h_s + parity * hp_bytes;
    // one k-step's products: k-step s (columns 16 s ..), its records at wk
    auto product = [&](const unsigned char* wk, int s) {
      if constexpr (kF32) {
        const float* hf = reinterpret_cast<const float*>(h_t) +
                          g * hrow + tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint4 a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[q] = *reinterpret_cast<const uint4*>(
                wk + (q * 2 + half) * kRecord);
          uint32_t bh[NTW][2], bl[NTW][2];
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            // columns 16 s + 8 half + tq (+ 4): blocks 4 s + 2 half (+ 1)
            const float* hk = hf + 8 * (ng * NTW + n) * hrow;
            const int blk = 4 * s + 2 * half;
            split_tf32(hk[(blk ^ g) * 4], bh[n][0], bl[n][0]);
            split_tf32(hk[((blk + 1) ^ g) * 4], bh[n][1], bl[n][1]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint4 ah, al;
            split_tf32(__uint_as_float(a[q].x), ah.x, al.x);
            split_tf32(__uint_as_float(a[q].y), ah.y, al.y);
            split_tf32(__uint_as_float(a[q].z), ah.z, al.z);
            split_tf32(__uint_as_float(a[q].w), ah.w, al.w);
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
              float (&lo)[4] = kSmall ? small[kSmall ? q : 0][n] : acc[q][n];
              if constexpr (!(kProbe & 32)) {
                mma_tf32(lo, al, bh[n][0], bh[n][1]);
                mma_tf32(lo, ah, bl[n][0], bl[n][1]);
              }
              mma_tf32(acc[q][n], ah, bh[n][0], bh[n][1]);
            }
          }
        }
      } else {
        // B fragments: h^T rows k = 16 s + 2tq (+1) and + 8 (blocks 2 s and
        // 2 s + 1), column g
        const __nv_bfloat16* hb =
            reinterpret_cast<const __nv_bfloat16*>(h_t) + g * hrow + 2 * tq;
        const int blk0 = ((2 * s) ^ g) * 8, blk1 = ((2 * s + 1) ^ g) * 8;
        uint4 a[4], alo[MODE == kHigh ? 4 : 1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = *reinterpret_cast<const uint4*>(wk + q * P * kRecord);
          if constexpr (MODE == kHigh)
            alo[q] = *reinterpret_cast<const uint4*>(
                wk + (q * P + 1) * kRecord);
        }
        uint32_t b0[NTW], b1[NTW], l0[NTW], l1[NTW];
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const __nv_bfloat16* hk = hb + 8 * (ng * NTW + n) * hrow;
          b0[n] = *reinterpret_cast<const uint32_t*>(hk + blk0);
          b1[n] = *reinterpret_cast<const uint32_t*>(hk + blk1);
          if constexpr (MODE == kHigh) {
            const __nv_bfloat16* lk = hk + R * hrow;  // (R + row) & 7 = g
            l0[n] = *reinterpret_cast<const uint32_t*>(lk + blk0);
            l1[n] = *reinterpret_cast<const uint32_t*>(lk + blk1);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            mma_bf16(acc[q][n], a[q], b0[n], b1[n]);
            if constexpr (MODE == kHigh) {  // + hi.lo + lo.hi
              mma_bf16(acc[q][n], a[q], l0[n], l1[n]);
              mma_bf16(acc[q][n], alo[kHParts == 2 ? q : 0], b0[n], b1[n]);
            }
          }
      }
    };
    if (!(kProbe & 9)) {
      // this k-part's run of the resident chunks
      for (int j = res_first; j < res_last; ++j) {
        const int ks_j = chunk_ks(j);
        const unsigned char* wg =
            res_s + j * chunk_bytes + ug * ks_j * step_bytes + lane * 16;
#pragma unroll 2
        for (int ks = 0; ks < ks_j; ++ks)
          product(wg + ks * step_bytes, j * p.chunk_steps + ks);
      }
    }
    // the streamed chunks in the ring's order, a slot's worth at a time,
    // the k-parts in turn by slot
    int next = rotation;  // the next streamed chunk - resident
    int part = 0;         // the k-part of the slot
    for (int k = 0; k < (kProbe & 8 ? 0 : streamed); k += p.per_slot) {
      const int count = min(p.per_slot, streamed - k);
      const bool mine = part == kp && !(kProbe & 1);
      if (++part == KP) part = 0;
      if (!(kProbe & 4)) mbar_wait_cta(&wfull[ring_slot], ring_parity);
      for (int c = 0; c < count; ++c) {
        const int j = p.resident + next;
        if (++next == streamed) next = 0;
        if (!mine) continue;
        const int ks_j = chunk_ks(j);
        const unsigned char* wg = ring_s + ring_slot * slot_bytes +
                                  c * chunk_bytes + ug * ks_j * step_bytes +
                                  lane * 16;
#pragma unroll 2
        for (int ks = 0; ks < ks_j; ++ks)
          product(wg + ks * step_bytes, j * p.chunk_steps + ks);
      }
      // this warp is past the slot's chunks
      if (!(kProbe & 4)) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&wempty[ring_slot]);
      }
      if (++ring_slot == p.slots) {
        ring_slot = 0;
        ring_parity ^= 1;
      }
    }

    if constexpr (kSmall) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[q][n][e] += small[kSmall ? q : 0][n][e];
    }
    if (KP > 1) {
      // the k-parts' partial products meet in k-part 0
      if (kp > 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int n = 0; n < NTW; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) *red_at(kp, q, n, e) = acc[q][n][e];
      }
      consumers_sync(threads);
      if (kp == 0) {
        for (int part = 1; part < KP; ++part)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int n = 0; n < NTW; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[q][n][e] += *red_at(part, q, n, e);
      }
    }

    float h[NTW][4];
    if (kp == 0) {
      // gate math, then h into the other parity
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* src = kProbe & 16 ? nullptr : xw_cell(t, n, q, e);
            x[q] = (src ? __ldg(src) : 0.0f) + acc[q][n][e];
          }
          const float i_g = sigmoid(x[0]), f_g = sigmoid(x[1]);
          const float g_g = tanh_fast(x[2]), o_g = sigmoid(x[3]);
          c_state[n][e] = f_g * c_state[n][e] + i_g * g_g;
          h[n][e] = o_g * tanh_fast(c_state[n][e]);
        }
      unsigned char* h_next = h_s + (parity ^ 1) * hp_bytes;
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = cell_row(n, e) - row0;
          const int u = cell_unit0 + 8 * (e >> 1);
          if constexpr (kF32) {
            reinterpret_cast<float*>(h_next)[r * hrow + swizzle(r, u, 4)] =
                h[n][e];
          } else {
            // the lo part's row R + r swizzles as r (R is a multiple of 8)
            __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(h_next) +
                                r * hrow + swizzle(r, u, 8);
            const __nv_bfloat16 hi = __float2bfloat16(h[n][e]);
            hb[0] = hi;
            if constexpr (MODE == kHigh)
              hb[R * hrow] = __float2bfloat16(h[n][e] - __bfloat162float(hi));
          }
        }
    }
    // the slice from every consumer warp; every read of this step's h (and
    // of the partial sums) done
    consumers_sync(threads);
    if (t + 1 < T && exchange) {
      // publish the slice: st.async into each peer's h buffer, counted on
      // the peer's hfull[parity ^ 1]
      const unsigned bar = hfull_addr + (parity ^ 1) * sizeof(uint64_t);
      const size_t base = (parity ^ 1) * hp_bytes;
      for (int c = threadIdx.x; c < slice_chunks; c += threads) {
        const size_t off = base + slice_offset(c);
        const uint4 v = *reinterpret_cast<const uint4*>(h_s + off);
        for (int k = 1; k < C; ++k) {
          const int peer = (rank + k) % C;
          st_async16(cluster_addr(h_addr + off, peer), v,
                     cluster_addr(bar, peer));
        }
      }
    }
    if (kp == 0) {
      // out after the step's synchronisation, off its critical path
      const int64_t t_idx = d ? T - 1 - t : t;
      float* out_t = p.out + t_idx * B * out_row + out_cell0;
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (inside >> (n * 4 + e) & 1 && !(kProbe & 16))
            out_t[(8 * n + (e & 1)) * out_row + 8 * (e >> 1)] = h[n][e];
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

// The streamed kernel's launch configuration; `clusters` (when given)
// receives how many of its clusters the card holds at once, and nothing
// is launched.
template <int MODE, int NTW>
cudaError_t launch_stream(const StreamParams& p, size_t smem,
                          cudaStream_t stream, int* clusters) {
  auto kernel = lstm_stream_kernel<MODE, NTW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((p.B + p.rows - 1) / p.rows * p.cluster, p.D);
  config.blockDim = dim3(32 * (p.groups * p.row_groups * p.kparts + 1));
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  if (clusters)
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
  const cudaError_t launched = cudaLaunchKernelEx(&config, kernel, p);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

template <int NTW>
cudaError_t stream_mode(const StreamParams& p, int mode, size_t smem,
                        cudaStream_t s, int* clusters) {
  switch (mode) {
    case kDefault:
      return launch_stream<kDefault, NTW>(p, smem, s, clusters);
    case kHigh:
      return launch_stream<kHigh, NTW>(p, smem, s, clusters);
    default:
      return launch_stream<kHighest, NTW>(p, smem, s, clusters);
  }
}

cudaError_t stream_ntw(const StreamParams& p, int ntw, int mode, size_t smem,
                       cudaStream_t s, int* clusters) {
  switch (ntw) {
    case 1:
      return stream_mode<1>(p, mode, smem, s, clusters);
    case 2:
      return stream_mode<2>(p, mode, smem, s, clusters);
    case 3:
      return stream_mode<3>(p, mode, smem, s, clusters);
    default:
      return stream_mode<4>(p, mode, smem, s, clusters);
  }
}

// The streamed geometry, checked: every count positive and within the
// kernel's bounds, the shared memory within a CTA's.
cudaError_t stream_params(StreamParams& p, int T, int B, int H, int D,
                          int mode, int cluster, int rows, int ntw,
                          int kparts, int chunk_steps, int resident,
                          int slots, int per_slot, size_t* smem) {
  p.T = T;
  p.B = B;
  p.H = H;
  p.D = D;
  p.padded = (H + 127) / 128 * 128;
  p.cluster = cluster;
  p.units = p.padded / (cluster > 0 ? cluster : 1);
  p.groups = p.units / 16;
  p.rows = rows;
  p.row_groups = rows / 8 / (ntw > 0 ? ntw : 1);
  p.kparts = kparts;
  p.steps = (H + 15) / 16;
  p.chunk_steps = chunk_steps;
  p.chunks = chunk_steps > 0 ? (p.steps + chunk_steps - 1) / chunk_steps : 0;
  p.resident = resident;
  p.slots = slots;
  p.per_slot = per_slot;
  const int warps = p.groups * p.row_groups * kparts;
  if (T < 1 || B < 1 || H <= kMaxHidden || D < 1 || D > 2 ||
      mode < kDefault || mode > kHighest || (cluster != 8 && cluster != 16) ||
      p.padded % (16 * cluster) != 0 || ntw < 1 || ntw > 4 || rows < 8 ||
      rows > 64 || p.row_groups < 1 || p.row_groups * 8 * ntw != rows ||
      kparts < 1 || kparts > 4 ||
      warps > stream_warps(ntw) || chunk_steps < 1 || resident < 0 ||
      resident > p.chunks || slots < 0 ||
      (resident < p.chunks) != (slots > 0) || per_slot < 1 || per_slot > 4)
    return cudaErrorInvalidValue;
  *smem = stream_shared_bytes(mode, p.groups, rows, p.padded, ntw, kparts,
                              chunk_steps, resident, slots, per_slot);
  if (*smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, bound with ctypes. `w` is the packed W_hh of
// `prepare_recurrent_weights` for this (H, mode); mode is 0 (default), 1
// (high) or 2 (highest). Up to H = 256 (on chip) `cluster` is the
// packing's and the rest is unused; above, the streamed route runs the
// geometry of `kernel_geometry` (ops/lstm_kernel.py): `cluster` 8 or 16,
// `rows` per cluster, `ntw` row tiles per warp, `kparts` k-parts,
// `chunk_steps` of the packing, `resident` chunks, ring `slots` of
// `per_slot` chunks. Returns a cudaError_t code: 0 on a successful launch. The launch is asynchronous on `stream`, on the
// current device.
extern "C" int lstm_recurrence(const void* xw, const void* w, void* out,
                               int T, int B, int H, int D, int mode,
                               int cluster, int rows, int ntw, int kparts,
                               int chunk_steps, int resident, int slots,
                               int per_slot, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H > kMaxHidden) {
    StreamParams p;
    size_t smem = 0;
    const cudaError_t err = stream_params(p, T, B, H, D, mode, cluster, rows,
                                          ntw, kparts, chunk_steps, resident,
                                          slots, per_slot, &smem);
    if (err != cudaSuccess) return err;
    p.xw = static_cast<const float*>(xw);
    p.w = static_cast<const unsigned char*>(w);
    p.out = static_cast<float*>(out);
    return stream_ntw(p, ntw, mode, smem, s, nullptr);
  }
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2 || mode < kDefault ||
      mode > kHighest ||
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
  switch (mode) {
    case kDefault:
      return launch<kDefault>(p, smem, s);
    case kHigh:
      return launch<kHigh>(p, smem, s);
    default:
      return launch<kHighest>(p, smem, s);
  }
}

// How many clusters of the streamed route's geometry (as for
// `lstm_recurrence`, for a batch of `B` rows) the current device holds at
// once, into `clusters`; returns a cudaError_t code.
extern "C" int lstm_recurrence_stream_clusters(int B, int H, int D, int mode,
                                               int cluster, int rows, int ntw,
                                               int kparts, int chunk_steps,
                                               int resident, int slots,
                                               int per_slot, int* clusters) {
  StreamParams p;
  size_t smem = 0;
  const cudaError_t err = stream_params(p, 1, B, H, D, mode, cluster, rows,
                                        ntw, kparts, chunk_steps, resident,
                                        slots, per_slot, &smem);
  if (err != cudaSuccess) return err;
  return stream_ntw(p, ntw, mode, smem, nullptr, clusters);
}
