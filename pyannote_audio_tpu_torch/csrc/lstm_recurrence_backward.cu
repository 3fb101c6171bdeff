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
// - Above H = 256 (template STREAM) W_hh does not fit on chip and streams
//   through shared memory. What bounds it: each of the 2T steps multiplies
//   by a CTA's whole share of W_hh (4Hc x Hp float32), read from L2 (W_hh
//   stays resident there) once per step, and waits for the step before.
//   A cluster of C = 8 or 16 CTAs (16 where H pads to a multiple of 256
//   alike: half the share a CTA) owns R = 8 or 16 rows, chosen from B
//   (`backward_geometry`, ops/lstm_kernel.py) so that the clusters fit one
//   wave where B allows. The packing's fragments come in chunks of F
//   k-steps of SW virtual warps, one run of bytes each, in the order the
//   warps read them: SW (the CTA's warps) is 16, or 12 where rounds of 12
//   leave fewer virtual warps idle (24 a phase at H = 384), and F the
//   most k-steps (up to 12) that divide both phases' and of which two
//   chunks fit beside the phase buffers: the warps meet at every chunk (at
//   (589, 32, 384) 8 k-steps took 15.0 ms, 4 took 18.1, on an H100). A CTA
//   keeps the first `resident` chunks of a phase in shared memory (copied
//   at the phase's start) and the rest pass through a ring of `ring` slots
//   fed by cp.async.bulk, across step
//   and phase boundaries; each warp reads its virtual warp's
//   fragments of every chunk, splits them once into hi and lo, uses them
//   for the R / 8 row tiles and counts itself out of the slot, and the last
//   warp out sends the slot's next chunk (a 17th, producer warp would cut
//   every thread's registers from 128 to 96: warps take registers in
//   fours). Phase 2's virtual warp is one
//   16-unit tile over all 4Hc gate rows, so a CTA receives one partial
//   dh_rec slot from each CTA of the cluster (C slots). The ownership, the
//   exchanges and the barriers are otherwise the on-chip route's (each
//   warp arrives once per step after all its virtual warps' writes).
//   Shared memory holds the phase buffers, the resident chunks and the
//   ring: H up to 2048.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHidden = 256;  // on chip; above, the streamed route
// warps of a streamed CTA: 16, or 12 where rounds of 12 virtual warps
// leave fewer of them idle
constexpr int kMaxStreamUnits = 256;   // Hc of the streamed route
constexpr int kMaxStreamCells = 2048;  // Hc x R of the streamed route
constexpr int kMaxChunkFrags = 12;  // k-steps of a streamed chunk: 2 to 12

// a streamed chunk: `frags` fragments of `warps` virtual warps
__host__ __device__ inline size_t chunk_bytes(int frags, int warps) {
  return static_cast<size_t>(warps) * frags * 32 * 16;
}
constexpr int kSlots = 8;  // partial dh_rec sums a CTA receives per step
                           // on chip (C on the streamed route)
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
  int slots;     // partial dh_rec sums a CTA receives per step
  int resident;  // streamed: chunks of a phase kept in shared memory
  int ring;      // streamed: ring slots (0 when every chunk is resident)
  int frags;     // streamed: k-steps of a chunk (2, 4, 8 or 12)
  int warps;     // streamed: warps of the CTA (12 or 16)
};

// floats of the phase buffers, shared by the two phases: phase 1 h by
// parity [2][R][Hp + 4] and the partial gate sums of the two K halves
// [2][R][4Hc + 4]; phase 2 the partial dh_rec slots [2][slots][Hc][R + 2]
// and this CTA's dgates [R][4Hc + 4]
__host__ __device__ inline size_t buffer_floats(int units, int padded,
                                                int rows, int slots) {
  const size_t gate_row = 4 * static_cast<size_t>(units) + 4;
  const size_t fwd = 2 * static_cast<size_t>(rows) * (padded + 4) +
                     2 * static_cast<size_t>(rows) * gate_row;
  const size_t bwd =
      2 * static_cast<size_t>(slots) * units * (rows + 2) + rows * gate_row;
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

// + 4 mbarriers (2 per phase); streamed, + the resident chunks, the ring,
// the mbarrier of the resident chunks and each slot's mbarrier and count
// of warps out
__host__ __device__ inline size_t shared_bytes(int units, int padded,
                                               int rows, bool stream,
                                               int slots, int resident,
                                               int ring, int frags,
                                               int warps) {
  return a_smem_bytes(units, padded, stream) +
         4 * buffer_floats(units, padded, rows, slots) +
         static_cast<size_t>(resident + ring) * chunk_bytes(frags, warps) +
         (4 + (stream ? 1 + 2 * static_cast<size_t>(ring) : 0)) *
             sizeof(uint64_t);
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
// SW (12 or 16) warps, one CTA per SM's registers.
template <int HC_, int NT, int STREAM_HC, int SW>
__global__ void __launch_bounds__(STREAM_HC ? 32 * SW : 16 * HC_,
                                  STREAM_HC ? 1 : (NT <= 2 ? 2 : 1))
lstm_recurrence_backward_kernel(const Params p) {
  constexpr bool STREAM = STREAM_HC > 0;
  constexpr int kWarps = STREAM ? SW : HC_ / 2;  // real warps
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
  // streamed: the resident chunks and the ring, after the phase buffers
  unsigned char* res_s = smem + a_bytes + 4 * buffer_floats(HC, Hp, R,
                                                            p.slots);
  unsigned char* ring_s = res_s + static_cast<size_t>(p.resident) *
                                      chunk_bytes(p.frags, kWarps);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      ring_s + static_cast<size_t>(p.ring) * chunk_bytes(p.frags, kWarps));
  uint64_t* wres = bars + 4;      // a phase's resident chunks have landed
  uint64_t* wfull = bars + 5;     // [ring]: the slot's chunk has landed
  // [ring]: warps done with the slot's chunk
  int* out_count = reinterpret_cast<int*>(wfull + p.ring);
  if (tid == 0) {
    // the local warps' arrivals and the expect_tx arrival of each step
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], kWarps + 1);
    if constexpr (STREAM) {
      mbar_init(wres, 1);
      for (int i = 0; i < p.ring; ++i) {
        mbar_init(&wfull[i], 1);
        out_count[i] = 0;
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // streamed: phase `phase`'s virtual warps, their fragments (k-steps)
  // each, and its chunks: rounds of SW virtual warps by k-slices of
  // p.frags; the first `resident` of a step's chunks stay on chip
  const int vwarps_of[2] = {HC / 2, STREAM ? F : HC / 2};
  const int frags_of[2] = {F, STREAM ? HC / 2 : F};
  auto phase_chunks = [&](int phase) {
    return (vwarps_of[phase] + kWarps - 1) / kWarps *
           (frags_of[phase] / p.frags);
  };
  auto phase_resident = [&](int phase) {
    return min(p.resident, phase_chunks(phase));
  };
  // the ring's chunks over the launch, in the order the warps read them:
  // phase 0's streamed chunks (those past the resident ones) for each of
  // its T - 1 steps that multiply, then phase 1's
  const int ring_chunks0 =
      p.phases & 1 ? (T - 1) * (phase_chunks(0) - phase_resident(0)) : 0;
  const int ring_chunks1 =
      p.phases & 2 ? (T - 1) * (phase_chunks(1) - phase_resident(1)) : 0;
  // this warp's next ring chunk, its slot and the parity of the slot's use
  // (counted, not divided out: a division a chunk cost more than the
  // chunk's products)
  int ring_i = 0, ring_slot = 0;
  unsigned ring_parity = 0;
  unsigned res_uses = 0;   // phases whose resident chunks were loaded

  // this (direction, rank)'s A fragments of `phase` in device memory
  auto a_global = [&](int phase) {
    return reinterpret_cast<const uint4*>(p.a) +
           static_cast<size_t>((d * C + rank) * 2 + phase) * vwarps * F * 32;
  };
  // streamed: the chunk a CTA visits v-th in a step of `phase`: round r =
  // v / slices, k-slice (v + rotation) % slices, so that the clusters that
  // read the same share do not ask L2 for the same lines at once; the
  // first `resident` it visits stay on chip
  const int cluster_index = static_cast<int>(blockIdx.x) / C;
  auto visit = [&](int phase, int v) {
    const int slices = frags_of[phase] / p.frags;
    const int r = v / slices;
    return r * slices + (v + cluster_index) % slices;
  };
  // streamed: chunk c of `phase` (round r, k-slice j) in device memory, and
  // its bytes: fragments [j p.frags, (j + 1) p.frags) of the
  // round's virtual warps, one run
  auto chunk_src = [&](int phase, int c, unsigned& bytes) {
    const int slices = frags_of[phase] / p.frags;
    const int r = c / slices, j = c % slices;
    const int nvw = min(kWarps, vwarps_of[phase] - kWarps * r);
    bytes = nvw * p.frags * 32 * 16;
    return a_global(phase) +
           (static_cast<size_t>(kWarps) * r * frags_of[phase] +
            static_cast<size_t>(j) * nvw * p.frags) *
               32;
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

  // out[n] = the 16 x 8 tile n of A . Bop, A the F fragments of this warp
  // (vw) of `phase` on chip, Bop[k][r] = src[r * stride + k0 + k] (k < 8F)
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

  // streamed: ring chunk i into `slot`, counted on the slot's mbarrier
  // (none past the last)
  auto send_chunk = [&](int i, int slot) {
    if (i >= ring_chunks0 + ring_chunks1) return;
    const int phase = i < ring_chunks0 ? 0 : 1;
    const int k = phase ? i - ring_chunks0 : i;
    const int streamed = phase_chunks(phase) - phase_resident(phase);
    unsigned bytes;
    const uint4* src = chunk_src(
        phase, visit(phase, phase_resident(phase) + k % streamed), bytes);
    mbar_expect(&wfull[slot], bytes);
    bulk_load(ring_s + static_cast<size_t>(slot) * chunk_bytes(p.frags, kWarps), src,
              bytes, &wfull[slot]);
  };
  // `phase`'s resident chunks, counted on wres
  auto send_resident = [&](int phase) {
    const int nres = phase_resident(phase);
    if (nres == 0) return;
    unsigned bytes, total = 0;
    for (int v = 0; v < nres; ++v) {
      chunk_src(phase, visit(phase, v), bytes);
      total += bytes;
    }
    mbar_expect(wres, total);
    for (int v = 0; v < nres; ++v) {
      const uint4* src = chunk_src(phase, visit(phase, v), bytes);
      bulk_load(res_s + static_cast<size_t>(v) * chunk_bytes(p.frags, kWarps), src,
                bytes, wres);
    }
  };

  // streamed: out[n] = the 16 x 8 tile n of A . Bop as `product`, A the
  // fragments of round r's virtual warp of this warp (``has``: one exists)
  // of `phase`, chunk by chunk from the resident chunks or the ring; every
  // consumer warp reads (and frees) every chunk of the round
  auto product_ring = [&](const float* src, int stride, int k0, int phase,
                          int r, bool has, float (&out)[NT][4]) {
    float acc[NT][kAcc][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int k = 0; k < kAcc; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][k][e] = 0.0f;
    const float* bk = src + g * stride + k0 + tq;
    const int slices = frags_of[phase] / p.frags;
    const int nres = phase_resident(phase);
    int j = cluster_index % slices;  // the k-slice of visit v
    for (int v = r * slices; v < (r + 1) * slices; ++v) {
      const unsigned char* chunk;
      const bool ring = v >= nres;
      if (ring) {
        mbar_wait_cta(&wfull[ring_slot], ring_parity);
        chunk = ring_s + static_cast<size_t>(ring_slot) * chunk_bytes(p.frags, kWarps);
      } else {
        chunk = res_s + static_cast<size_t>(v) * chunk_bytes(p.frags, kWarps);
      }
      if (has) {
        const uint4* a = reinterpret_cast<const uint4*>(chunk) +
                         warp * p.frags * 32 + lane;
#pragma unroll
        for (int f = 0; f < kMaxChunkFrags; ++f) {
          if (f == p.frags) break;
          uint4 ahi, alo;
          split4(a[f * 32], ahi, alo);
          mma3<NT, kAcc>(acc, ahi, alo, bk + 8 * (j * p.frags + f),
                         stride);
        }
      }
      if (ring) {  // this warp's reads of the slot are done
        __syncwarp();
        // (the slot's values are in registers: the mma consumed them, and
        // __syncwarp orders the other lanes; a fence here would also wait
        // for this thread's stores to the workspace)
        if (lane == 0 &&
            atomicAdd(&out_count[ring_slot], 1) == kWarps - 1) {
          // the last warp out: every read of the slot is done
          out_count[ring_slot] = 0;
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          send_chunk(ring_i + p.ring, ring_slot);
        }
        ++ring_i;
        if (++ring_slot == p.ring) {
          ring_slot = 0;
          ring_parity ^= 1;
        }
      }
      if (++j == slices) j = 0;
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
  // streamed: wait for `phase`'s resident chunks (the producer's copies at
  // the phase's start)
  auto wait_resident = [&](int phase) {
    if constexpr (STREAM) {
      if (phase_resident(phase) > 0) mbar_wait_cta(wres, res_uses++ & 1);
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
    wait_resident(0);
    for (int n = 0; n < T; ++n) {
      const int par = n & 1;
      if (n + 1 < T) load(n + 1, nxt);
      // h(n - 1) of every CTA (this CTA's by its warps' arrivals)
      if (n > 0) mbar_wait(&bars[par], ((n - 1) >> 1) & 1);
      // h(n) of the peers, arriving in this step and the next
      if (tid == 0 && n + 1 < T) mbar_expect(&bars[par ^ 1], remote_bytes);
      if (n > 0) {
        // virtual warp vw: tile mt of the gate rows, K half kp
        auto store = [&](int vw, const float (&out)[NT][4]) {
          const int mt = vw % tiles, kp = vw / tiles;
          float* pp = part + kp * R * Sg + 16 * mt + g;
#pragma unroll
          for (int m = 0; m < NT; ++m) {
            const int r = 8 * m + 2 * tq;
            pp[r * Sg] = out[m][0];
            pp[(r + 1) * Sg] = out[m][1];
            pp[r * Sg + 8] = out[m][2];
            pp[(r + 1) * Sg + 8] = out[m][3];
          }
        };
        if constexpr (STREAM) {
          for (int r = 0; r * kWarps < vwarps; ++r) {
            const int vw = r * kWarps + warp;
            float out[NT][4];
            product_ring(hbuf + par * R * Sh, Sh, vw / tiles * F * 8, 0, r,
                         vw < vwarps, out);
            if (vw < vwarps) store(vw, out);
          }
        } else {
          for (int vw = warp; vw < vwarps; vw += kWarps) {
            const int kp = vw / tiles;
            float out[NT][4];
            product(hbuf + par * R * Sh, Sh, kp * F * 8, vw, 0, out);
            store(vw, out);
            break;
          }
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
    const int nslots = STREAM ? C : kSlots;
    float* slots = buf;                       // [2][nslots][HC][Sr]
    float* dg = buf + 2 * nslots * HC * Sr;   // [R][Sg]
    uint64_t* bbar = bars + 2;
    const int tiles = F;                      // 16-unit tiles of Hp
    // k-parts of 4Hc (streamed: one, all 4Hc gate rows a virtual warp)
    const int parts = STREAM ? 1 : vwarps / tiles;
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
    wait_resident(1);
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
          const float* sl = slots + par * nslots * HC * Sr + ul * Sr + r;
          float rec = 0.0f;
          if constexpr (STREAM) {
            for (int k = 0; k < nslots; ++k) rec += sl[k * HC * Sr];
          } else {
#pragma unroll
            for (int k = 0; k < kSlots; ++k) rec += sl[k * HC * Sr];
          }
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
        auto send = [&](int vw, const float (&out)[NT][4]) {
          const int mt = vw % tiles, kp = vw / tiles;
          const int dest = 16 * mt / HC, dest_ul = 16 * mt % HC;
          const int slot = rank * parts + kp;
          // tile rows are units dest_ul + g (+8), columns batch rows
          float* mine = slots + ((par ^ 1) * nslots + slot) * HC * Sr;
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
        };
        if constexpr (STREAM) {
          for (int r = 0; r * kWarps < tiles; ++r) {
            const int vw = r * kWarps + warp;
            float out[NT][4];
            product_ring(dg, Sg, 0, 1, r, vw < tiles, out);
            if (vw < tiles) send(vw, out);
          }
        } else {
          for (int vw = warp; vw < vwarps; vw += kWarps) {
            const int kp = vw / tiles;
            float out[NT][4];
            product(dg, Sg, kp * F * 8, vw, 1, out);
            send(vw, out);
            break;
          }
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
  if constexpr (STREAM) {
    // the first phase's resident chunks and the ring's first chunks
    if (tid == 0) {
      send_resident(p.phases & 1 ? 0 : 1);
      for (int i = 0; i < p.ring; ++i) send_chunk(i, i);
    }
  }
  if (p.phases & 1) {
    recompute();
    // every st.async of phase 1 has landed (each was waited for) and no
    // CTA reads its buffers any more: phase 2 reuses them
    cluster_sync();
    if (p.phases & 2) {
      if constexpr (STREAM) {
        if (tid == 0) send_resident(1);
      } else {
        load_a(1);
        __syncthreads();
      }
    }
  }
  if (p.phases & 2) {
    walk();
    // no CTA leaves while a peer may still write into its shared memory
    cluster_sync();
  }
}

template <int HC, int NT, int STREAM_HC = 0, int SW = 16>
cudaError_t launch(const Params& p, int rows, size_t smem,
                   cudaStream_t stream) {
  auto kernel = lstm_recurrence_backward_kernel<HC, NT, STREAM_HC, SW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && STREAM_HC)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((p.B + rows - 1) / rows * p.cluster, p.D);
  config.blockDim = dim3(STREAM_HC ? 32 * SW : 16 * HC);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&config, kernel, p);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. `a` is W_hh's A fragments as
// `pack_backward_weights` (ops/lstm_kernel.py) packs them for the geometry
// of `backward_geometry`: on chip (H <= 256) `cluster` 1 to 8 and `rows`
// (8, 16, 32 or 64; 8 above H = 128) the batch rows per cluster; streamed
// (H > 256) `cluster` 8 or 16, `rows` 8 or 16, `resident` chunks of a
// phase kept in shared memory, `ring` slots, `frags` k-steps a chunk and
// `warps` (12 or 16; all 0 on chip). `phases` 1
// (the recompute into ws and h_prev), 2 (the walk over them into grad_xw)
// or 3 (both). Returns a cudaError_t code: 0 on a successful launch. The
// launch is asynchronous on `stream`, on the current device.
extern "C" int lstm_recurrence_backward(const void* xw, const void* grad_out,
                                        const void* a, void* ws, void* h_prev,
                                        void* grad_xw, int T, int B, int H,
                                        int D, int cluster, int rows,
                                        int phases, int resident, int ring,
                                        int frags, int warps, void* stream) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2 || phases < 1 || phases > 3)
    return cudaErrorInvalidValue;
  const bool streamed = H > kMaxHidden;
  // streamed: Hp = H rounded up to 128, Hc = Hp / cluster
  const int padded = (H + 127) / 128 * 128;
  const int units = streamed ? padded / (cluster == 16 ? 16 : 8)
                             : (H > 128 ? 32 : 16);
  const bool cluster_ok =
      streamed ? (cluster == 8 || (cluster == 16 && padded % 256 == 0))
               : (units == 16 ? (cluster == 1 || cluster == 2 ||
                                 cluster == 4 || cluster == 8)
                              : cluster == 8);
  const bool rows_ok =
      streamed ? ((rows == 8 || rows == 16) && units * rows <= kMaxStreamCells)
               : (units == 16 ? (rows == 8 || rows == 16 || rows == 32 ||
                                 rows == 64)
                              : rows == 8);
  // streamed: a ring of at least 2 slots unless every chunk of both phases
  // is resident (a phase has units / 2 / 16 rounds of Hp / 16 / frags
  // slices, or Hp / 16 / 16 rounds of units / 2 / frags)
  const int f = frags > 0 ? frags : 1, w = warps > 0 ? warps : 1;
  const int chunks0 = (units / 2 + w - 1) / w * (padded / 16 / f);
  const int chunks1 = (padded / 16 + w - 1) / w * (units / 2 / f);
  const int most = chunks0 > chunks1 ? chunks0 : chunks1;
  const bool ring_ok =
      streamed ? resident >= 0 && (resident >= most ? ring == 0 : ring >= 2)
               : resident == 0 && ring == 0;
  const bool frags_ok =
      streamed ? frags >= 2 && frags <= kMaxChunkFrags && frags % 2 == 0 &&
                     (padded / 16) % frags == 0 && (units / 2) % frags == 0 &&
                     (warps == 12 || warps == 16)
               : frags == 0 && warps == 0;
  if (!cluster_ok || !rows_ok || !ring_ok || !frags_ok ||
      units * cluster < H || units > kMaxStreamUnits)
    return cudaErrorInvalidValue;
  const int slots = streamed ? cluster : kSlots;
  const size_t smem = shared_bytes(units, units * cluster, rows, streamed,
                                   slots, resident, ring, frags, warps);
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
  p.slots = slots;
  p.resident = resident;
  p.ring = ring;
  p.frags = frags;
  p.warps = warps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (streamed) {
    if (warps == 12) {
      if (units > 128)
        return launch<0, 1, kMaxStreamUnits, 12>(p, rows, smem, s);
      return rows == 8 ? launch<0, 1, 128, 12>(p, rows, smem, s)
                       : launch<0, 2, 128, 12>(p, rows, smem, s);
    }
    if (units > 128) return launch<0, 1, kMaxStreamUnits>(p, rows, smem, s);
    return rows == 8 ? launch<0, 1, 128>(p, rows, smem, s)
                     : launch<0, 2, 128>(p, rows, smem, s);
  }
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
