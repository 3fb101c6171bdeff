// LSTM recurrence over hoisted input projections, both directions of a
// layer in one launch, f32 throughout.
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
//
// Layout: xw (T, B, D*4H), w_hh_t (D, H, 4H) = W_hh transposed so that the
// threads of a warp read neighbouring addresses, out (T, B, D*H).
//
// Design. Batch rows are independent: a block owns kRows rows of one
// direction and walks all T steps in an in-block loop. A thread owns one
// hidden unit j (or several, when H exceeds the block) and computes all
// four gates of j for each of its rows, so the gate math needs no
// exchange between threads. h is double-buffered in shared memory (one
// __syncthreads() per step); c lives in shared memory, private to the
// owning thread. W_hh (256 KB in f32 at H = 128, more than a block's
// 227 KB of shared memory) is read from device memory on every step, where
// it stays resident in the 50 MB L2; each W_hh element fetched serves
// kRows rows. kRows = 8 was the fastest of 1, 2, 4 and 8 at PyanNet's
// shape on an H100 (27.6, 11.1, 11.6 and 8.1 ms). The xw loads for a step
// are issued before the recurrent dot product, which does not depend on
// them, so their latency hides behind it.
//
// What bounds it: PyanNet runs 2 layers x 589 *sequential* steps per batch
// of 256 chunks. The recurrent work is 2*B*H*4H*T ~ 19.8 GFLOP per
// direction-layer at B = 256, H = 128, small for the card; the time is
// the latency of 589 dependent steps, each an L2 sweep over W_hh plus a
// block barrier. A later version should keep W_hh on chip (bf16 in shared
// memory, or f32 split across a 2-CTA cluster) and run the per-step
// (kRows, H) x (H, 4H) product on tensor cores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRows = 8;  // batch rows per block
// shared memory a Hopper block can use: h double-buffered and c, kRows x H
// floats each, bound H
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kMaxHidden = kMaxSharedBytes / (3 * kRows * sizeof(float));

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_recurrence_kernel(const float* __restrict__ xw,
                       const float* __restrict__ w_hh_t,
                       float* __restrict__ out, int T, int B, int H, int D) {
  extern __shared__ float smem[];
  constexpr int R = kRows;
  float* h_buf = smem;                 // [2][R][H]
  float* c_buf = smem + 2 * R * H;     // [R][H]

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * R;
  const int64_t G = 4LL * H;
  const int64_t xw_row = static_cast<int64_t>(D) * G;
  const int64_t out_row = static_cast<int64_t>(D) * H;
  const float* w = w_hh_t + static_cast<int64_t>(d) * H * G;

  for (int i = threadIdx.x; i < 3 * R * H; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int64_t t_idx = d ? (T - 1 - t) : t;
    const float* h_cur = h_buf + (t & 1) * R * H;
    float* h_nxt = h_buf + ((t + 1) & 1) * R * H;

    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float xv[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        if (b < B) {
          const float* p = xw + (t_idx * B + b) * xw_row + d * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) xv[r][g] = p[g * H];
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g) xv[r][g] = 0.0f;
        }
      }

      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;

#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float* wk = w + k * G + j;
        const float w0 = __ldg(wk);
        const float w1 = __ldg(wk + H);
        const float w2 = __ldg(wk + 2 * H);
        const float w3 = __ldg(wk + 3 * H);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hk = h_cur[r * H + k];
          acc[r][0] = fmaf(hk, w0, acc[r][0]);
          acc[r][1] = fmaf(hk, w1, acc[r][1]);
          acc[r][2] = fmaf(hk, w2, acc[r][2]);
          acc[r][3] = fmaf(hk, w3, acc[r][3]);
        }
      }

#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float i_g = sigmoid(xv[r][0] + acc[r][0]);
        const float f_g = sigmoid(xv[r][1] + acc[r][1]);
        const float g_g = tanhf(xv[r][2] + acc[r][2]);
        const float o_g = sigmoid(xv[r][3] + acc[r][3]);
        const float c = f_g * c_buf[r * H + j] + i_g * g_g;
        const float h = o_g * tanhf(c);
        c_buf[r * H + j] = c;
        h_nxt[r * H + j] = h;
        const int b = b0 + r;
        if (b < B) out[(t_idx * B + b) * out_row + d * H + j] = h;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Largest hidden size the kernel takes (its shared memory bounds it).
extern "C" int lstm_recurrence_max_hidden() { return kMaxHidden; }

// Plain C entry point, bound with ctypes. Returns a cudaError_t code: 0 on
// a successful launch. The launch is asynchronous on `stream`, on the
// current device.
extern "C" int lstm_recurrence_f32(const void* xw, const void* w_hh_t,
                                   void* out, int T, int B, int H, int D,
                                   void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxHidden || D < 1 || D > 2)
    return cudaErrorInvalidValue;
  const int threads = ((H + 31) / 32) * 32;
  const dim3 block(threads < kMaxThreads ? threads : kMaxThreads);
  const dim3 grid((B + kRows - 1) / kRows, D);
  const size_t smem = 3 * static_cast<size_t>(kRows) * H * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  lstm_recurrence_kernel<<<grid, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xw), static_cast<const float*>(w_hh_t),
      static_cast<float*>(out), T, B, H, D);
  return cudaGetLastError();
}
