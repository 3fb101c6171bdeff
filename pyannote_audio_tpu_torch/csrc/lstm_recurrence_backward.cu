// Backward of the LSTM recurrence: the reverse walk through time that turns
// the output's gradient into the gradient of the hoisted inputs xw, both
// directions of a layer in one launch, with W_hh on chip.
//
// Replaces the JAX package's backward of `pallas_lstm_cell`: the
// `custom_vjp` rules `_bidir_layer_bwd` and `_single_layer_bwd`
// (pyannote_audio_tpu/ops/pallas_lstm.py), which take `jax.vjp` of the
// float32 scan (`lstm_cell_scan`, ops/lstm.py, Precision.HIGHEST). XLA
// compiles that VJP into one loop on the device; it is not a Pallas kernel.
//
// What it computes, for direction d (d = 1 walks time backwards, so its
// reverse walk runs forwards in t), step s from the last to the first,
// with dh_rec = dc_next = 0 before the walk:
//   dh = grad_out[t, b, d*H + u] + dh_rec
//   dc = dc_next + dh * o * (1 - tanh(c_s)^2)
//   dgates = (dc * g * i (1 - i), dc * c_{s-1} * f (1 - f),
//             dc * i * (1 - g^2), dh * tanh(c_s) * o (1 - o))
//   grad_xw[t, b, d*4H:(d+1)*4H] = dgates   (gates = xw + h W^T)
//   dc_next = dc * f;  dh_rec = dgates @ W_hh[d]   (B x 4H by 4H x H)
// in f32. The activations i, f, g, o and c of every step come from the
// workspace `ws` (T, B, D, 5H), written by the forward kernel
// (lstm_recurrence.cu) when it recomputes the layer at "highest" for the
// backward. grad_W_hh = sum_t dgates_t^T h_{t-1} is one large product
// after this kernel (ops/lstm_kernel.py), as XLA leaves it outside the
// scan's loop.
//
// What bounds it: like the forward, the latency of T dependent steps, each
// a (8 x 4Hp) by (4Hp x Hc) product per CTA, the gate math and an exchange
// inside the cluster. The operations, 2*T*B*D*4H*H, are 0.04 ms of the
// CUDA cores' f32 rate at (589, 32, 128, 2); the bytes (ws and grad_out
// read, grad_xw written: 193 MB) 0.06 ms of HBM.
//
// Design. The forward's ownership (lstm_recurrence.cu): a cluster of C
// CTAs owns kRows = 8 batch rows of one direction and walks all T steps
// in an in-block loop; each CTA owns Hc = Hp / C <= 64 hidden units.
// - Owning outputs, exchanging dgates. A CTA computes dh_rec for its own
//   units only, so it needs every unit's dgates (8 x 4Hp) and the columns
//   of W_hh of its own units (4Hp x Hc, 128 KB of f32 at H = 128, C = 2),
//   kept in shared memory for all T steps. Each CTA sends its own slice of
//   dgates (8 x 4Hc) to every peer with st.async, counted on the peer's
//   mbarrier for that step's parity, exactly as the forward exchanges h.
//   The other choice, owning the forward's gate rows and reducing partial
//   dh_rec sums across the cluster, moves 4x fewer bytes but needs a
//   second thread mapping, a second barrier and a sum per step; this one
//   keeps one __syncthreads per step and the forward's proven protocol.
// - A thread owns one unit and 4 batch rows (2 Hc threads): the product's
//   inner loop reads W[j][unit] (consecutive across lanes) and the 4 rows'
//   dgates[j] as one broadcast float4, 4 f32 FMAs per j on the CUDA cores;
//   its cells' gate math needs no exchange.
// - ws and grad_out of step s - 1 are loaded into registers while step s
//   runs, off the critical path; grad_xw is written after the exchange.
// - The gate math is exact f32 (tanhf of c, products): no fast-math
//   shortcut sits on a gradient.
// - Padded units have zero W_hh columns and zero workspace, so their
//   dgates stay 0; rows past B read zeros and give 0 too.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHidden = 256;
constexpr int kRows = 8;       // batch rows per cluster, as the forward
constexpr int kCellRows = 4;   // batch rows per thread
constexpr int kMaxUnits = 64;  // hidden units per CTA
constexpr int kMaxThreads = 2 * kMaxUnits;
constexpr int kValues = 7;     // i, f, g, o, c, c_{s-1}, grad_out per cell
constexpr long long kWaitCycles = 1LL << 34;  // ~9 s at 1.98 GHz
constexpr int kMaxSharedBytes = 227 * 1024;

struct Params {
  const float* ws;        // (T, B, D, 5H)
  const float* grad_out;  // (T, B, D*H)
  const float* w;         // (D, cluster, 4Hp, Hc) W_hh columns
  float* grad_xw;         // (T, B, D*4H)
  int T, B, H, D;
  int padded;   // Hp: H rounded up to 16 * cluster
  int units;    // Hc = Hp / cluster
  int cluster;
};

// W columns, the dgates double buffer ([4Hp][kRows] per parity), 2
// mbarriers
__host__ __device__ size_t shared_bytes(int units, int padded) {
  return 4 * static_cast<size_t>(padded) * units * 4 +
         2 * static_cast<size_t>(4) * padded * kRows * 4 +
         2 * sizeof(uint64_t);
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

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_recurrence_backward_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = p.cluster;
  const int T = p.T, B = p.B, H = p.H, D = p.D, Hp = p.padded, Hc = p.units;
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * kRows;  // first batch row
  const int unit0 = rank * Hc;                // this CTA's first unit
  const int ul = threadIdx.x % Hc;            // this thread's unit
  const int r0 = kCellRows * (threadIdx.x / Hc);  // and its first row
  const int u = unit0 + ul;
  const int J = 4 * Hp;  // gate rows of W_hh, padded

  float* w_s = reinterpret_cast<float*>(smem);  // [J][Hc]
  float* dg_s = w_s + static_cast<size_t>(J) * Hc;  // [2][J][kRows]
  uint64_t* full = reinterpret_cast<uint64_t*>(dg_s + 2 * J * kRows);
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    const float4* src = reinterpret_cast<const float4*>(
        p.w + (static_cast<size_t>(d) * C + rank) * J * Hc);
    float4* dst = reinterpret_cast<float4*>(w_s);
    for (int i = threadIdx.x; i < J * Hc / 4; i += blockDim.x)
      dst[i] = src[i];
  }

  // this CTA's slice of dgates, 16-byte chunks: for each gate q the
  // units [unit0, unit0 + Hc) of all kRows rows, 2 Hc chunks
  const int chunks = 4 * 2 * Hc;
  auto chunk_offset = [&](int c) -> size_t {
    const int q = c / (2 * Hc);
    return (static_cast<size_t>(q) * Hp + unit0) * kRows * 4 +
           (c % (2 * Hc)) * 16;
  };
  const unsigned slice_bytes = chunks * 16;
  const size_t parity_bytes = static_cast<size_t>(J) * kRows * 4;
  const unsigned dg_addr = smem_addr(dg_s), full_addr = smem_addr(full);

  const int64_t ws_row = 5LL * H;  // per (t, b, d)
  const int64_t out_row = static_cast<int64_t>(D) * H;
  const int64_t xw_row = static_cast<int64_t>(D) * 4 * H;

  // the values of this thread's cells at step s: [e][i, f, g, o, c,
  // c_{s-1}, grad_out], zeros outside the batch and the hidden size
  auto load = [&](int s, float (&v)[kCellRows][kValues]) {
    const int64_t t_idx = d ? T - 1 - s : s;
    const int64_t prev = d ? t_idx + 1 : t_idx - 1;
#pragma unroll
    for (int e = 0; e < kCellRows; ++e) {
      const int b = row0 + r0 + e;
      const bool valid = b < B && u < H;
      const float* w =
          p.ws + ((t_idx * B + b) * D + d) * ws_row + u;
#pragma unroll
      for (int q = 0; q < 5; ++q) v[e][q] = valid ? w[q * H] : 0.0f;
      v[e][5] = valid && s > 0
                    ? p.ws[((prev * B + b) * D + d) * ws_row + 4 * H + u]
                    : 0.0f;
      v[e][6] = valid ? p.grad_out[(t_idx * B + b) * out_row + d * H + u]
                      : 0.0f;
    }
  };

  float cur[kCellRows][kValues], nxt[kCellRows][kValues];
  float dc_next[kCellRows] = {0.0f, 0.0f, 0.0f, 0.0f};
  load(T - 1, cur);
  // W, the mbarriers, in every CTA
  cluster_sync();

  for (int n = 0; n < T; ++n) {
    const int s = T - 1 - n;  // the step, in the direction's own order
    if (s > 0) load(s - 1, nxt);
    const int parity = n & 1;
    if (C > 1) {
      // the peers' dgates of iteration n - 1 (this CTA's own slice is
      // ordered by the __syncthreads of iteration n - 1)
      if (n > 0) mbar_wait(&full[parity], ((n - 1) >> 1) & 1);
      // the peers' dgates of iteration n, arriving in this iteration and
      // the next
      if (threadIdx.x == 0 && n + 1 < T)
        mbar_expect(&full[parity ^ 1], (C - 1) * slice_bytes);
    }
    // dh_rec of this thread's cells: dgates(s + 1) (8 x J) . W[:, u]
    float acc[kCellRows] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (n > 0) {
      const float* dg = dg_s + parity * J * kRows + r0;
      const float* wc = w_s + ul;
#pragma unroll 8
      for (int j = 0; j < J; ++j) {
        const float4 gv = *reinterpret_cast<const float4*>(dg + j * kRows);
        const float wv = wc[j * Hc];
        acc[0] = fmaf(gv.x, wv, acc[0]);
        acc[1] = fmaf(gv.y, wv, acc[1]);
        acc[2] = fmaf(gv.z, wv, acc[2]);
        acc[3] = fmaf(gv.w, wv, acc[3]);
      }
    }

    float dgate[4][kCellRows];  // [gate][e]
#pragma unroll
    for (int e = 0; e < kCellRows; ++e) {
      const float i = cur[e][0], f = cur[e][1], g = cur[e][2],
                  o = cur[e][3], c = cur[e][4], c_prev = cur[e][5];
      const float dh = cur[e][6] + acc[e];
      const float tc = tanhf(c);
      const float dc = dc_next[e] + dh * o * (1.0f - tc * tc);
      dgate[0][e] = dc * g * i * (1.0f - i);
      dgate[1][e] = dc * c_prev * f * (1.0f - f);
      dgate[2][e] = dc * i * (1.0f - g * g);
      dgate[3][e] = dh * tc * o * (1.0f - o);
      dc_next[e] = dc * f;
    }
    // this thread's dgates into the other parity: 4 rows of one (gate,
    // unit) are one float4
    float* dg_next = dg_s + (parity ^ 1) * J * kRows;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(dg_next + (q * Hp + u) * kRows + r0) =
          make_float4(dgate[q][0], dgate[q][1], dgate[q][2], dgate[q][3]);
    // the slice for every warp; every read of this parity's buffer done
    __syncthreads();
    if (C > 1 && n + 1 < T) {
      const unsigned bar = full_addr + (parity ^ 1) * sizeof(uint64_t);
      const size_t base = (parity ^ 1) * parity_bytes;
      for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
        const size_t off = base + chunk_offset(c);
        const uint4 v = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const unsigned char*>(dg_s) + off);
        for (int k = 1; k < C; ++k) {
          const int peer = (rank + k) % C;
          st_async16(cluster_addr(dg_addr + off, peer), v,
                     cluster_addr(bar, peer));
        }
      }
    }
    // grad_xw after the step's synchronisation, off its critical path
    const int64_t t_idx = d ? T - 1 - s : s;
#pragma unroll
    for (int e = 0; e < kCellRows; ++e) {
      const int b = row0 + r0 + e;
      if (b < B && u < H) {
        float* gx = p.grad_xw + (t_idx * B + b) * xw_row + d * 4 * H + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) gx[q * H] = dgate[q][e];
      }
    }
    if (s > 0) {
#pragma unroll
      for (int e = 0; e < kCellRows; ++e)
#pragma unroll
        for (int k = 0; k < kValues; ++k) cur[e][k] = nxt[e][k];
    }
  }
  // no CTA leaves while a peer may still write into its shared memory
  cluster_sync();
}

}  // namespace

// Plain C entry point, bound with ctypes. `ws` is the forward kernel's
// workspace of this layer at "highest", `w` W_hh's columns as
// `prepare_backward_weights` (ops/lstm_kernel.py) packs them for this
// (H, cluster). Returns a cudaError_t code: 0 on a successful launch. The
// launch is asynchronous on `stream`, on the current device.
extern "C" int lstm_recurrence_backward(const void* ws, const void* grad_out,
                                        const void* w, void* grad_xw, int T,
                                        int B, int H, int D, int cluster,
                                        void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxHidden || D < 1 || D > 2 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return cudaErrorInvalidValue;
  Params p;
  p.ws = static_cast<const float*>(ws);
  p.grad_out = static_cast<const float*>(grad_out);
  p.w = static_cast<const float*>(w);
  p.grad_xw = static_cast<float*>(grad_xw);
  p.T = T;
  p.B = B;
  p.H = H;
  p.D = D;
  p.padded = (H + 16 * cluster - 1) / (16 * cluster) * (16 * cluster);
  p.units = p.padded / cluster;
  p.cluster = cluster;
  if (p.units > kMaxUnits) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(p.units, p.padded);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_recurrence_backward_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((B + kRows - 1) / kRows * cluster, D);
  config.blockDim = dim3(2 * p.units);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, lstm_recurrence_backward_kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
