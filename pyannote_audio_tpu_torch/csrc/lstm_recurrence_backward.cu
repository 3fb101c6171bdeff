// Backward of the LSTM recurrence: the "highest" recompute of a layer and
// the reverse walk through time that turns the output's gradient into the
// gradient of the hoisted inputs xw, both directions in one launch, with
// W_hh on chip and both products on tensor cores at float32 accuracy.
//
// Replaces the JAX package's backward of `pallas_lstm_cell`: the
// `custom_vjp` rules `_bidir_layer_bwd` and `_single_layer_bwd`
// (pyannote_audio_tpu/ops/pallas_lstm.py), which take `jax.vjp` of the
// float32 scan (`lstm_cell_scan`, ops/lstm.py, Precision.HIGHEST). XLA
// compiles that VJP into one loop on the device; it is not a Pallas kernel.
//
// What it computes, for direction d (d = 1 walks time backwards):
// phase 1, the recompute, from h = c = 0, step by step in the direction's
// order:
//   gates = xw[t, b, d*4H:(d+1)*4H] + h @ W_hh[d]^T   (i, f, g, o)
//   c = sigmoid(f) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)
// writing i, f, g, o (activated) and c to the workspace `ws` (T, B, D, 5H)
// and h to `h_prev` (D, T, B, H) at the index of the next step (0 at the
// first), for grad_W_hh = sum_t dgates_t^T h_prev_t, one large product
// after this kernel (ops/lstm_kernel.py), as XLA leaves it outside the
// scan's loop. Phase 2, the walk, from the last step to the first, with
// dh_rec = dc_next = 0 before it:
//   dh = grad_out[t, b, d*H + u] + dh_rec
//   dc = dc_next + dh * o * (1 - tanh(c)^2)
//   dgates = (dc * g * i (1 - i), dc * c_prev * f (1 - f),
//             dc * i * (1 - g^2), dh * tanh(c) * o (1 - o))
//   grad_xw[t, b, d*4H:(d+1)*4H] = dgates
//   dc_next = dc * f;  dh_rec = dgates @ W_hh[d]   (B x 4H by 4H x H)
// The gate math is exact float32 (expf, tanhf, IEEE division): no
// fast-math shortcut sits on a gradient or on what it is computed from.
//
// What bounds it: the latency of 2T dependent steps, each an (R x Hp) by
// (Hp x 4Hc) product (phase 1) or an (R x 4Hc) by (4Hc x Hp) one (phase
// 2) per CTA, the gate math and an exchange inside the cluster. The
// operations, 2 x 2*T*B*D*4H*H in three TF32 passes, are 0.03 ms of the
// tensor cores' 495 TFLOP/s at (589, 32, 128, 2) and 0.52 ms at (100, 3264);
// the bytes (xw, grad_out read, ws and h_prev written and read back,
// grad_xw written) 0.2 ms and 3.4 ms of HBM.
//
// Design.
// - Ownership. A cluster of C CTAs owns R batch rows of one direction for
//   both phases; each CTA owns Hc hidden units (16, or 32 above H = 128)
//   and the 4Hc gate rows of W_hh of those units, Hp = C * Hc. R is chosen
//   from B (ops/lstm_kernel.py `backward_geometry`): 8 where the batch
//   fills the card at once (latency sets the time), up to 64 at DPRNN's
//   B = 1600-3264 (fewer waves; the products grow to 8 mma tiles of n).
// - The products on tensor cores at float32 accuracy: mma.sync m16n8k8
//   TF32 in three passes, hi.hi + hi.lo + lo.hi, of the operands split as
//   hi = tf32(x), lo = tf32(x - hi) (cvt.rna; ops/lstm.py `split_tf32` is
//   the plain version); lo.lo, about 2^-22 of each product, is dropped.
//   W_hh is the A operand, 16 gate rows (phase 1) or 16 units (phase 2) per
//   tile; the batch rows are the n side.
// - W_hh in registers. Each warp keeps its A fragments, split once into hi
//   and lo, in registers for all T steps of a phase (64 registers at
//   H = 128, C = 8): nothing streams W from shared memory per step.
//   (Two CTAs per SM at 32 rows, with A kept as float32 and split at each
//   use to fit 128 registers, was no faster at DPRNN's B.) Above
//   H = 128 (Hc = 32, 16 warps) the fragments stay in shared memory as
//   float32 and are split per use.
// - Phase 1: a warp owns one 16-row tile of the CTA's gate rows and half
//   of K = Hp (8 warps at Hc = 16: 4 gates x 2 halves), so every
//   scheduler has two warps of short mma chains; the two halves meet in
//   shared memory with one __syncthreads per step. Each CTA sends its own units'
//   h (R x Hc) to every peer with st.async, counted on the peer's mbarrier
//   for the step's parity.
// - Phase 2 sums partial products instead of exchanging gate gradients: a
//   CTA multiplies its own units' dgates (R x 4Hc, local) by its own gate
//   rows of W_hh, giving a partial dh_rec for every unit; a warp owns one
//   16-unit tile (the units of one destination CTA at Hc = 16) and sends
//   it with st.async into that CTA's slot for (source CTA, k-part). Every
//   CTA receives 8 slots per step and sums them in the cell's gate math.
//   The bytes per step are a quarter of an exchange of dgates, both phases
//   use the same slice of W_hh, and one __syncthreads per step remains.
// - Local writes into the buffers a peer also writes are counted on the
//   same mbarrier: each warp arrives once per step (after __syncwarp), so a
//   completed phase means every slot (or every h slice) of the step is in.
//   The first wait is one step after the first send; the last step sends
//   nothing.
// - A thread owns R / 16 cells (unit, row) of its CTA (one at R = 16, half
//   the warps idle at R = 8) and prefetches the next step's xw (phase 1)
//   or workspace and grad_out values (phase 2; c_{s-1}, read for step s,
//   is step s - 1's c) into registers while the current step runs; ws,
//   h_prev and grad_xw are written off the critical path. The same thread owns the same cells in both phases, so phase 2
//   reads back only what its own thread wrote.
// - Padded units have zero W_hh rows and columns and zero inputs; rows
//   past B read zeros. Their h, c and gradients stay 0.
// - `phases` selects phase 1, phase 2 or both (3, the wrapper's call): the
//   parts alone are for timing (chip_smoke.py phase 3).
// - Above H = 256 (template STREAM) W_hh stays in device memory, resident
//   in L2, in the same packing: a cluster of 8 CTAs, each owning Hc = Hp / 8
//   units (Hp = H rounded up to 128), 8 rows per cluster and 16 warps a
//   CTA. The packing's Hc / 2 warps of fragments become virtual warps, each
//   real warp taking every 16th, and every product reads its A fragments
//   from device memory and splits them at each use. The ownership, both
//   phases, the exchanges and the barriers are the on-chip route's (each
//   real warp arrives once per step after all its virtual warps' writes).
//   Shared memory holds the phase buffers alone, about 96 Hp bytes: up to
//   Hc = 256, H = 2048.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHidden = 256;  // on chip; above, the streamed route
constexpr int kStreamCluster = 8;
constexpr int kStreamRows = 8;
constexpr int kStreamWarps = 16;       // real warps of a streamed CTA
constexpr int kMaxStreamUnits = 256;   // Hc of the streamed route
constexpr int kSlots = 8;  // partial dh_rec sums a CTA receives per step
constexpr long long kWaitCycles = 1LL << 34;  // ~9 s at 1.98 GHz
constexpr int kMaxSharedBytes = 227 * 1024;

struct Params {
  const float* xw;        // (T, B, D*4H)
  const float* grad_out;  // (T, B, D*H)
  const float* a;         // (D, C, 2, warps, Hp/16, 32, 4) A fragments
  float* ws;              // (T, B, D, 5H): i, f, g, o, c of each step
  float* h_prev;          // (D, T, B, H)
  float* grad_xw;         // (T, B, D*4H)
  int T, B, H, D;
  int cluster;
  int units;   // Hc, hidden units per CTA
  int phases;  // bit 0: the recompute, bit 1: the walk
};

// floats of the phase buffers, shared by the two phases: phase 1 h by
// parity [2][R][Hp + 4] and the partial gate sums of the two K halves
// [2][R][4Hc + 4]; phase 2 the partial dh_rec slots [2][kSlots][Hc][R + 2]
// and this CTA's dgates [R][4Hc + 4]
__host__ __device__ inline size_t buffer_floats(int units, int padded,
                                                int rows) {
  const size_t gate_row = 4 * static_cast<size_t>(units) + 4;
  const size_t fwd = 2 * static_cast<size_t>(rows) * (padded + 4) +
                     2 * static_cast<size_t>(rows) * gate_row;
  const size_t bwd =
      2 * static_cast<size_t>(kSlots) * units * (rows + 2) + rows * gate_row;
  return fwd > bwd ? fwd : bwd;
}

// A fragments kept in shared memory (Hc = 32): warps x Hp/16 x 32 x 16 B;
// none in registers (Hc = 16) or streamed (above H = 256)
__host__ __device__ inline size_t a_smem_bytes(int units, int padded,
                                               bool stream) {
  return units == 16 || stream
             ? 0
             : static_cast<size_t>(units / 2) * (padded / 16) * 32 * 16;
}

// + 4 mbarriers (2 per phase)
__host__ __device__ inline size_t shared_bytes(int units, int padded,
                                               int rows, bool stream) {
  return a_smem_bytes(units, padded, stream) +
         4 * buffer_floats(units, padded, rows) + 4 * sizeof(uint64_t);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_addr(bar))
               : "memory");
}

// Wait for the phase of `parity`; trap after kWaitCycles rather than hang.
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

__device__ __forceinline__ void st_async16(unsigned remote, const uint4& v,
                                           unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void st_async8(unsigned remote, float x, float y,
                                          unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(remote),
      "r"(__float_as_uint(x)), "r"(__float_as_uint(y)), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const uint4& v, uint4& hi, uint4& lo) {
  split(__uint_as_float(v.x), hi.x, lo.x);
  split(__uint_as_float(v.y), hi.y, lo.y);
  split(__uint_as_float(v.z), hi.z, lo.z);
  split(__uint_as_float(v.w), hi.w, lo.w);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// acc[n][.] += tile n's product of one k-step, A = hi + lo and this
// lane's B values bk[n * 8 * stride] and bk[n * 8 * stride + 4], in three
// passes, pass by pass over the tiles: consecutive mma are independent
template <int NT, int kAcc>
__device__ __forceinline__ void mma3(float (&acc)[NT][kAcc][4],
                                     const uint4& ahi, const uint4& alo,
                                     const float* bk, int stride) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    split(bk[n * 8 * stride], bh[n][0], bl[n][0]);
    split(bk[n * 8 * stride + 4], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)  // lo . hi
    mma_tf32(acc[n][1 % kAcc], alo, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n)  // hi . lo
    mma_tf32(acc[n][2 % kAcc], ahi, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n)  // hi . hi
    mma_tf32(acc[n][0], ahi, bh[n][0], bh[n][1]);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// HC_ hidden units per CTA (16, or 32 above H = 128), NT mma tiles of 8
// batch rows per cluster. Up to 16 rows the kernel fits two CTAs' worth
// of registers per SM without spilling (at most 128 a thread), which
// shortened the recompute at (589, 32) by 0.1 ms on an H100 (tools/
// lstm_backward_variants.py); above, it takes up to 255. STREAM_HC > 0 is
// the streamed route for Hc up to STREAM_HC (128 or 256; Hc is p.units),
// one CTA per SM's registers (at most 128 a thread).
template <int HC_, int NT, int STREAM_HC>
__global__ void __launch_bounds__(STREAM_HC ? 32 * kStreamWarps : 16 * HC_,
                                  STREAM_HC ? 1 : (NT <= 2 ? 2 : 1))
lstm_recurrence_backward_kernel(const Params p) {
  constexpr bool STREAM = STREAM_HC > 0;
  constexpr int kWarps = STREAM ? kStreamWarps : HC_ / 2;  // real warps
  constexpr int kThreads = 32 * kWarps;
  constexpr int R = 8 * NT;                 // batch rows of the cluster
  constexpr bool kRegs = !STREAM && HC_ == 16;  // A fragments in registers
  constexpr int kFrags = kRegs ? 8 : 16;    // bound of F, the warp's frags
  constexpr int kMaxHC = STREAM ? STREAM_HC : HC_;
  constexpr int kCells = (kMaxHC * R + kThreads - 1) / kThreads;
  constexpr int kAcc = NT == 1 ? 3 : (NT == 2 ? 2 : 1);  // chains per tile
  constexpr int Sr = R + 2;                 // slot row stride
  const int HC = STREAM ? p.units : HC_;
  const int Sg = 4 * HC + 4;                // gate row stride
  const int vwarps = HC / 2;                // the packing's warps
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = p.cluster, Hp = C * HC, F = Hp / 16;
  const int T = p.T, B = p.B, H = p.H, D = p.D;
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * R;  // first batch row
  const int unit0 = rank * HC;            // this CTA's first unit
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma lane group and its thread
  const int Sh = Hp + 4;                   // h row stride

  const size_t a_bytes = a_smem_bytes(HC, Hp, STREAM);
  uint4* a_s = reinterpret_cast<uint4*>(smem);
  float* buf = reinterpret_cast<float*>(smem + a_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + a_bytes + 4 * buffer_floats(HC, Hp, R));
  if (tid == 0) {
    // the local warps' arrivals and the expect_tx arrival of each step
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], kWarps + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // this (direction, rank)'s A fragments of `phase` in device memory
  auto a_global = [&](int phase) {
    return reinterpret_cast<const uint4*>(p.a) +
           static_cast<size_t>((d * C + rank) * 2 + phase) * vwarps * F * 32;
  };
  // this warp's A fragments of `phase`, split into hi and lo
  uint4 a_hi[kRegs ? kFrags : 1], a_lo[kRegs ? kFrags : 1];
  auto load_a = [&](int phase) {
    const uint4* src = a_global(phase);
    if constexpr (STREAM) {
      // read at each use
    } else if constexpr (kRegs) {
#pragma unroll
      for (int i = 0; i < kFrags; ++i)
        if (i < F) split4(src[(warp * F + i) * 32 + lane], a_hi[i], a_lo[i]);
    } else {
      for (int i = tid; i < kWarps * F * 32; i += kThreads) a_s[i] = src[i];
    }
  };

  // out[n] = the 16 x 8 tile n of A . Bop, A the F fragments of virtual
  // warp vw (this warp on chip) of `phase`, Bop[k][r] = src[r * stride + k0
  // + k] (k < 8F)
  auto product = [&](const float* src, int stride, int k0, int vw, int phase,
                     float (&out)[NT][4]) {
    float acc[NT][kAcc][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int k = 0; k < kAcc; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][k][e] = 0.0f;
    const float* bk = src + g * stride + k0 + tq;
    if constexpr (STREAM) {
      const uint4* a_vw = a_global(phase) + vw * F * 32;
#pragma unroll 4
      for (int i = 0; i < F; ++i) {
        uint4 ahi, alo;
        split4(__ldg(a_vw + i * 32 + lane), ahi, alo);
        mma3<NT, kAcc>(acc, ahi, alo, bk + 8 * i, stride);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kFrags; ++i) {
        if (i < F) {
          uint4 ahi, alo;
          if constexpr (kRegs) {
            ahi = a_hi[i];
            alo = a_lo[i];
          } else {
            split4(a_s[(warp * F + i) * 32 + lane], ahi, alo);
          }
          mma3<NT, kAcc>(acc, ahi, alo, bk + 8 * i, stride);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float small = 0.0f;
#pragma unroll
        for (int k = 1; k < kAcc; ++k) small += acc[n][k][e];
        out[n][e] = acc[n][0][e] + small;
      }
  };

  // cell j of this thread: unit ul (fastest), row r
  auto cell_on = [&](int j) { return tid + j * kThreads < HC * R; };
  auto cell_ul = [&](int j) { return (tid + j * kThreads) % HC; };
  auto cell_r = [&](int j) { return (tid + j * kThreads) / HC; };
  auto cell_valid = [&](int j) {
    return cell_on(j) && row0 + cell_r(j) < B && unit0 + cell_ul(j) < H;
  };
  const int64_t ws_row = 5LL * H;  // per (t, b, d)

  // -- phase 1: the recompute ------------------------------------------
  auto recompute = [&]() {
    float* hbuf = buf;                   // [2][R][Sh]
    float* part = buf + 2 * R * Sh;      // [2][R][Sg]
    const int tiles = HC / 4;            // 16-row tiles of 4Hc gate rows
    const unsigned remote_bytes = (C - 1) * HC * R * 4;
    const unsigned h_addr = smem_addr(hbuf), bar_addr = smem_addr(bars);
    const int64_t xw_row = static_cast<int64_t>(D) * 4 * H;

    // xw of this thread's cells at step n, zeros outside B and H
    auto load = [&](int n, float (&x)[kCells][4]) {
      const int64_t t_idx = d ? T - 1 - n : n;
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        const bool valid = cell_valid(j);
        const float* src = p.xw + (t_idx * B + row0 + cell_r(j)) * xw_row +
                           d * 4 * H + unit0 + cell_ul(j);
#pragma unroll
        for (int q = 0; q < 4; ++q) x[j][q] = valid ? src[q * H] : 0.0f;
      }
    };

    float cur[kCells][4], nxt[kCells][4], c_state[kCells];
#pragma unroll
    for (int j = 0; j < kCells; ++j) c_state[j] = 0.0f;
    load(0, cur);
    for (int n = 0; n < T; ++n) {
      const int par = n & 1;
      if (n + 1 < T) load(n + 1, nxt);
      // h(n - 1) of every CTA (this CTA's by its warps' arrivals)
      if (n > 0) mbar_wait(&bars[par], ((n - 1) >> 1) & 1);
      // h(n) of the peers, arriving in this step and the next
      if (tid == 0 && n + 1 < T) mbar_expect(&bars[par ^ 1], remote_bytes);
      if (n > 0) {
        // virtual warp vw: tile mt of the gate rows, K half kp
        for (int vw = warp; vw < vwarps; vw += kWarps) {
          const int mt = vw % tiles, kp = vw / tiles;
          float out[NT][4];
          product(hbuf + par * R * Sh, Sh, kp * F * 8, vw, 0, out);
          float* pp = part + kp * R * Sg + 16 * mt + g;
#pragma unroll
          for (int m = 0; m < NT; ++m) {
            const int r = 8 * m + 2 * tq;
            pp[r * Sg] = out[m][0];
            pp[(r + 1) * Sg] = out[m][1];
            pp[r * Sg + 8] = out[m][2];
            pp[(r + 1) * Sg + 8] = out[m][3];
          }
          if constexpr (!STREAM) break;
        }
      }
      // both K halves of every gate row
      __syncthreads();
      const int64_t t_idx = d ? T - 1 - n : n;
      const int64_t t_next = d ? t_idx - 1 : t_idx + 1;
      float* hnext = hbuf + (par ^ 1) * R * Sh;
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        if (!cell_on(j)) continue;  // whole warps
        const int ul = cell_ul(j), r = cell_r(j);
        const int b = row0 + r, u = unit0 + ul;
        float x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[q] = cur[j][q];
          if (n > 0)
            x[q] += part[r * Sg + q * HC + ul] +
                    part[(R + r) * Sg + q * HC + ul];
        }
        const float i_g = sigmoid(x[0]), f_g = sigmoid(x[1]),
                    g_g = tanhf(x[2]), o_g = sigmoid(x[3]);
        c_state[j] = f_g * c_state[j] + i_g * g_g;
        const float h = o_g * tanhf(c_state[j]);
        if (b < B && u < H) {
          float* w = p.ws + ((t_idx * B + b) * D + d) * ws_row + u;
          w[0] = i_g;
          w[H] = f_g;
          w[2 * H] = g_g;
          w[3 * H] = o_g;
          w[4 * H] = c_state[j];
          float* hp = p.h_prev + (static_cast<int64_t>(d) * T) * B * H +
                      static_cast<int64_t>(b) * H + u;
          if (n == 0) hp[t_idx * B * H] = 0.0f;
          if (n + 1 < T) hp[t_next * B * H] = h;
        }
        hnext[r * Sh + u] = h;
        // 4 units per 16-byte st.async into every peer's h of this parity
        const float h1 = __shfl_down_sync(0xffffffffu, h, 1);
        const float h2 = __shfl_down_sync(0xffffffffu, h, 2);
        const float h3 = __shfl_down_sync(0xffffffffu, h, 3);
        if (C > 1 && n + 1 < T && (ul & 3) == 0) {
          const uint4 v = make_uint4(__float_as_uint(h), __float_as_uint(h1),
                                     __float_as_uint(h2),
                                     __float_as_uint(h3));
          const unsigned off =
              h_addr + (((par ^ 1) * R + r) * Sh + u) * 4;
          const unsigned bar = bar_addr + (par ^ 1) * sizeof(uint64_t);
          for (int k = 1; k < C; ++k) {
            const int peer = (rank + k) % C;
            st_async16(cluster_addr(off, peer), v, cluster_addr(bar, peer));
          }
        }
      }
      // this warp's h written and its reads of `part` done
      if (n + 1 < T) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&bars[par ^ 1]);
#pragma unroll
        for (int j = 0; j < kCells; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) cur[j][q] = nxt[j][q];
      }
    }
  };

  // -- phase 2: the walk -----------------------------------------------
  auto walk = [&]() {
    float* slots = buf;                       // [2][kSlots][HC][Sr]
    float* dg = buf + 2 * kSlots * HC * Sr;   // [R][Sg]
    uint64_t* bbar = bars + 2;
    const int tiles = F;                      // 16-unit tiles of Hp
    const int parts = vwarps / tiles;         // k-parts of 4Hc
    const unsigned remote_bytes = (C - 1) * parts * HC * R * 4;
    const unsigned bar_addr = smem_addr(bbar);
    const int64_t out_row = static_cast<int64_t>(D) * H;
    const int64_t xw_row = static_cast<int64_t>(D) * 4 * H;

    // this thread's cells at step s: i, f, g, o, c, c_{s-1}, grad_out; c
    // from the workspace only at the first step of the walk (`fresh`),
    // else it is the c_{s-1} of the step before (copied by the caller)
    auto load = [&](int s, float (&v)[kCells][7], bool fresh) {
      const int64_t t_idx = d ? T - 1 - s : s;
      const int64_t prev = d ? t_idx + 1 : t_idx - 1;
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        const bool valid = cell_valid(j);
        const int64_t b = row0 + cell_r(j);
        const int u = unit0 + cell_ul(j);
        const float* w = p.ws + ((t_idx * B + b) * D + d) * ws_row + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) v[j][q] = valid ? w[q * H] : 0.0f;
        if (fresh) v[j][4] = valid ? w[4 * H] : 0.0f;
        v[j][5] = valid && s > 0
                      ? p.ws[((prev * B + b) * D + d) * ws_row + 4 * H + u]
                      : 0.0f;
        v[j][6] = valid ? p.grad_out[(t_idx * B + b) * out_row + d * H + u]
                        : 0.0f;
      }
    };

    float cur[kCells][7], nxt[kCells][7], dc_next[kCells];
#pragma unroll
    for (int j = 0; j < kCells; ++j) dc_next[j] = 0.0f;
    load(T - 1, cur, true);
    for (int n = 0; n < T; ++n) {
      const int s = T - 1 - n;  // the step, in the direction's own order
      const int par = n & 1;
      if (s > 0) load(s - 1, nxt, false);
      // every slot of iteration n - 1
      if (n > 0) mbar_wait(&bbar[par], ((n - 1) >> 1) & 1);
      if (tid == 0 && n + 1 < T) mbar_expect(&bbar[par ^ 1], remote_bytes);
      const int64_t t_idx = d ? T - 1 - s : s;
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        if (!cell_on(j)) continue;  // whole warps
        const int ul = cell_ul(j), r = cell_r(j);
        const int b = row0 + r, u = unit0 + ul;
        float dh = cur[j][6];
        if (n > 0) {
          const float* sl = slots + par * kSlots * HC * Sr + ul * Sr + r;
          float rec = 0.0f;
#pragma unroll
          for (int k = 0; k < kSlots; ++k) rec += sl[k * HC * Sr];
          dh += rec;
        }
        const float i = cur[j][0], f = cur[j][1], gg = cur[j][2],
                    o = cur[j][3], c = cur[j][4], c_prev = cur[j][5];
        const float tc = tanhf(c);
        const float dc = dc_next[j] + dh * o * (1.0f - tc * tc);
        float dgate[4];
        dgate[0] = dc * gg * i * (1.0f - i);
        dgate[1] = dc * c_prev * f * (1.0f - f);
        dgate[2] = dc * i * (1.0f - gg * gg);
        dgate[3] = dh * tc * o * (1.0f - o);
        dc_next[j] = dc * f;
        if (b < B && u < H) {
          float* gx = p.grad_xw + (t_idx * B + b) * xw_row + d * 4 * H + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) gx[q * H] = dgate[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) dg[r * Sg + q * HC + ul] = dgate[q];
      }
      // every dgate of this CTA; every read of this parity's slots done
      __syncthreads();
      if (n + 1 < T) {
        // virtual warp vw: tile mt of the units, k-part kp
        for (int vw = warp; vw < vwarps; vw += kWarps) {
          const int mt = vw % tiles, kp = vw / tiles;
          const int dest = 16 * mt / HC, dest_ul = 16 * mt % HC;
          const int slot = rank * parts + kp;
          float out[NT][4];
          product(dg, Sg, kp * F * 8, vw, 1, out);
          // tile rows are units dest_ul + g (+8), columns batch rows
          float* mine = slots + ((par ^ 1) * kSlots + slot) * HC * Sr;
          const int o0 = (dest_ul + g) * Sr + 2 * tq, o1 = o0 + 8 * Sr;
          if (dest == rank) {
#pragma unroll
            for (int m = 0; m < NT; ++m) {
              *reinterpret_cast<float2*>(mine + o0 + 8 * m) =
                  make_float2(out[m][0], out[m][1]);
              *reinterpret_cast<float2*>(mine + o1 + 8 * m) =
                  make_float2(out[m][2], out[m][3]);
            }
          } else {
            const unsigned base = cluster_addr(smem_addr(mine), dest);
            const unsigned bar =
                cluster_addr(bar_addr + (par ^ 1) * sizeof(uint64_t), dest);
#pragma unroll
            for (int m = 0; m < NT; ++m) {
              st_async8(base + (o0 + 8 * m) * 4, out[m][0], out[m][1], bar);
              st_async8(base + (o1 + 8 * m) * 4, out[m][2], out[m][3], bar);
            }
          }
          if constexpr (!STREAM) break;
        }
        // this warp's local slot written and its reads of dg done
        __syncwarp();
        if (lane == 0) mbar_arrive(&bbar[par ^ 1]);
      }
      if (s > 0) {
#pragma unroll
        for (int j = 0; j < kCells; ++j) {
          nxt[j][4] = cur[j][5];  // c_{s-1}
#pragma unroll
          for (int k = 0; k < 7; ++k) cur[j][k] = nxt[j][k];
        }
      }
    }
  };

  load_a(p.phases & 1 ? 0 : 1);
  // the mbarriers and A in every CTA
  cluster_sync();
  if (p.phases & 1) {
    recompute();
    // every st.async of phase 1 has landed (each was waited for) and no
    // CTA reads its buffers any more: phase 2 reuses them
    cluster_sync();
    if (p.phases & 2) {
      load_a(1);
      __syncthreads();
    }
  }
  if (p.phases & 2) {
    walk();
    // no CTA leaves while a peer may still write into its shared memory
    cluster_sync();
  }
}

template <int HC, int NT, int STREAM_HC = 0>
cudaError_t launch(const Params& p, int rows, size_t smem,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_recurrence_backward_kernel<HC, NT, STREAM_HC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((p.B + rows - 1) / rows * p.cluster, p.D);
  config.blockDim = dim3(STREAM_HC ? 32 * kStreamWarps : 16 * HC);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &config, lstm_recurrence_backward_kernel<HC, NT, STREAM_HC>, p);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. `a` is W_hh's A fragments as
// `pack_backward_weights` (ops/lstm_kernel.py) packs them for this (H,
// cluster); `rows` (8, 16, 32 or 64; 8 above H = 128) the batch rows per
// cluster; `phases` 1 (the recompute into ws and h_prev), 2 (the walk over
// them into grad_xw) or 3 (both). H above 256 takes the streamed route (a
// cluster of 8, 8 rows). Returns a cudaError_t code: 0 on a successful
// launch. The launch is asynchronous on `stream`, on the current device.
extern "C" int lstm_recurrence_backward(const void* xw, const void* grad_out,
                                        const void* a, void* ws, void* h_prev,
                                        void* grad_xw, int T, int B, int H,
                                        int D, int cluster, int rows,
                                        int phases, void* stream) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2 || phases < 1 || phases > 3)
    return cudaErrorInvalidValue;
  const bool streamed = H > kMaxHidden;
  // streamed: Hp = H rounded up to 128, Hc = Hp / 8
  const int units = streamed ? (H + 127) / 128 * 16 : (H > 128 ? 32 : 16);
  const bool cluster_ok =
      units == 16 ? (cluster == 1 || cluster == 2 || cluster == 4 ||
                     cluster == 8)
                  : cluster == (streamed ? kStreamCluster : 8);
  const bool rows_ok = units == 16 ? (rows == 8 || rows == 16 ||
                                      rows == 32 || rows == 64)
                                   : rows == (streamed ? kStreamRows : 8);
  if (!cluster_ok || !rows_ok || units * cluster < H ||
      units > kMaxStreamUnits)
    return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(units, units * cluster, rows, streamed);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  Params p;
  p.xw = static_cast<const float*>(xw);
  p.grad_out = static_cast<const float*>(grad_out);
  p.a = static_cast<const float*>(a);
  p.ws = static_cast<float*>(ws);
  p.h_prev = static_cast<float*>(h_prev);
  p.grad_xw = static_cast<float*>(grad_xw);
  p.T = T;
  p.B = B;
  p.H = H;
  p.D = D;
  p.cluster = cluster;
  p.units = units;
  p.phases = phases;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (streamed)
    return units <= 128 ? launch<0, 1, 128>(p, rows, smem, s)
                        : launch<0, 1, kMaxStreamUnits>(p, rows, smem, s);
  if (units == 32) return launch<32, 1>(p, rows, smem, s);
  switch (rows) {
    case 8:
      return launch<16, 1>(p, rows, smem, s);
    case 16:
      return launch<16, 2>(p, rows, smem, s);
    case 32:
      return launch<16, 4>(p, rows, smem, s);
    default:
      return launch<16, 8>(p, rows, smem, s);
  }
}
