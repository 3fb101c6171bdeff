// A float32 matrix product at float32 accuracy on Hopper's tensor cores:
// C[M, N] = A[M, K] . W^T + bias, optionally followed by the exact (erf)
// GELU, everything float32 in and out, the products as three TF32 passes.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA,
// which on a TPU runs float32 at Precision.HIGHEST as several passes of the
// matrix unit. It was added for the float32 WavLM trunk
// (models/blocks/ssl.py), whose linears and strided feature-extractor convs
// are about 90 % of the `sseriouss` configuration's FLOPs and which
// cuBLAS and cuDNN run on the CUDA cores (FFMA, 67 TFLOP/s) while TF32 is
// off, as it must be for float32 accuracy.
//
// Arithmetic ("3xTF32"): each float x is split into hi = x rounded to TF32
// (nearest, ties away from zero) and lo = (x - hi) rounded to TF32, and
// A.W^T is taken as lo_A.hi_W + hi_A.lo_W + hi_A.hi_W on the tensor cores.
// What the split drops, lo.lo and the rounding of lo, is about 2^-21 of
// each product (Ootomo & Yokota, 2022). The tensor cores add into their
// float32 accumulator by truncation, so a long chain of additions into one
// accumulator drifts toward zero: each k-block's 12 products (4 k-steps x
// 3 passes) start a fresh accumulator, which is then added to the running
// sum by an ordinary (round-to-nearest) float32 addition. The result is as
// accurate as a float32 product. ops/tf32x3_gemm.py holds the plain
// version of the same arithmetic.
//
// What bounds it: operations. Three TF32 passes are 3 x 2MNK at 495 TFLOP/s
// (H100 SXM, dense), a bound of 165 TFLOP/s of float32-accurate work; at
// the trunk's shapes the bytes (A read once, C written once) are a few
// percent of that time. What a design has to watch is L2 traffic: every
// tile reads its rows of A and W's hi and lo from L2, 0.03 bytes per
// multiply-add at this kernel's tiles.
//
// Layouts.
// - A is a batched strided view: row r of item b = r / rows_per_item
//   starts at a + b * item_stride + (r % rows_per_item) * row_stride and
//   holds K contiguous floats. A linear's rows are its input's rows (row
//   stride K); conv i of the feature extractor (kernel k, stride s, C
//   channels, channels-last input (B, T_in, C)) reads output frame t as
//   the contiguous run x[b, t*s : t*s + k, :], so its row stride is s*C
//   and K is k*C: no im2col is written.
// - W (N, K) is split and packed once by `pack_weight`
//   (ops/tf32x3_gemm.py): N padded to a multiple of 128 and K to a
//   multiple of 32 with zeros, then for each (128-row tile, 32-column
//   k-block) one contiguous 16 KiB block per part, laid out as this
//   kernel's shared memory holds it: 128 rows of 128 bytes, the 16-byte
//   chunks of row r swizzled by r % 8 (the 128-byte swizzle of wgmma), and
//   the 32 columns of a block permuted so that a thread's A fragment is
//   two 16-byte loads (below).
// - C (M, N) is row-major; bias (N) is optional.
//
// Design (sm_90a).
// - A CTA of two warpgroups, persistent over tiles of 128 rows x 128
//   columns (one CTA an SM; tile t at (t / n_tiles, t % n_tiles), so the
//   CTAs running together share A's rows and W's tiles in L2).
// - W's hi and lo blocks of each k-block stream into a ring of 6 stages
//   (32 KiB each) by cp.async.bulk, counted on a "full" mbarrier. No warp
//   is set aside to produce: the second warpgroup to finish with a stage
//   (a counter in shared memory) refills it with the k-block 6 ahead. On an
//   H100 both alternatives measured slower: W multicast to a cluster of 2
//   or 4 CTAs (1.8x, 4x), and a producer warpgroup, whose 384 threads cap a
//   thread's registers at 168 (ptxas does not allocate by setmaxnreg).
// - Each warpgroup owns 64 rows x 128 columns: one wgmma m64n128k8 TF32
//   per pass and k-step, A from registers, B (W's hi or lo) from shared
//   memory. A thread loads its A fragment for the next k-block from device
//   memory straight into registers (two rows, two 16-byte loads each, in
//   flight during this k-block's products) and splits it into hi and lo
//   there: no shared memory, and no second copy of A, holds A. The
//   permutation of W's columns is what makes a fragment two 16-byte loads.
// - A k-block is 4 k-steps x 3 passes = 12 wgmma into the fresh
//   accumulator, one wait, then 64 float32 additions a thread into the
//   running sum; the two warpgroups interleave, so one's wait, additions
//   and split overlap the other's products.
// - The epilogue adds the bias, applies GELU where asked, and stores
//   float2 pairs straight from the running sums, masking the ragged M and
//   N edges; rows past M read zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                // rows of a tile: 2 warpgroups x 64
constexpr int kBN = 128;                // columns of a tile: wgmma's n
constexpr int kBK = 32;                 // columns of a k-block: 128 bytes
constexpr int kStages = 6;              // ring depth
constexpr int kThreads = 256;           // two warpgroups
constexpr int kAcc = kBN / 2;           // accumulators a thread
constexpr int kTileFloats = kBN * kBK;  // one packed block of W's hi or lo
constexpr unsigned kTileBytes = kTileFloats * 4;
constexpr size_t kRingBytes = static_cast<size_t>(kStages) * 2 * kTileBytes;
constexpr size_t kSharedBytes =
    kRingBytes + 1024 + kStages * (sizeof(uint64_t) + sizeof(unsigned));
constexpr long long kWaitCycles = 1LL << 34;  // ~9 s at 1.98 GHz

struct Params {
  const float* a;
  const float* w_hi;
  const float* w_lo;
  const float* bias;  // nullptr: none
  float* out;
  long long item_stride;  // floats between the items of A
  long long row_stride;   // floats between the rows of an item
  int rows_per_item;
  int M, N, K;
  int k_blocks;  // ceil(K / 32)
  int n_tiles;   // ceil(N / 128)
  int tiles;     // ceil(M / 128) * n_tiles
  int gelu;
  int pairs;     // N even: the epilogue stores float2 pairs
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the refilling thread's arrival of a phase, expecting `bytes` of bulk
// copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity`. A phase that never completes is a fault
// of the protocol: trap after kWaitCycles rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
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

// `bytes` from device memory into this CTA's shared memory by the bulk
// copy engine, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// x rounded to TF32 (nearest, ties away from zero), as float32 bits
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

// wgmma's shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), the leading offset unused
__device__ __forceinline__ uint64_t descriptor(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3ffff) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, this warpgroup's) = (scale ? d : 0) + A (64 x 8, TF32
// fragments in registers) . B (8 x 128, K-major in shared memory at
// `desc`)
__device__ __forceinline__ void wgmma(float (&d)[kAcc], const uint32_t (&a)[4],
                                      uint64_t desc, int scale) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A thread's share of A for one k-block: rows r and r + 8 of its warp's 16,
// physical columns [4t, 4t + 4) and [16 + 4t, 16 + 4t + 4) of the block
// (`col` = the block's first column + 4t). Rows past M and columns past K
// read zeros.
__device__ __forceinline__ void load_block(const float* row0,
                                           const float* row1, int col, int K,
                                           float4 (&raw)[4]) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool c0 = col < K, c1 = col + 16 < K;
  raw[0] = row0 && c0 ? __ldg(reinterpret_cast<const float4*>(row0 + col))
                      : zero;
  raw[1] = row0 && c1
               ? __ldg(reinterpret_cast<const float4*>(row0 + col + 16))
               : zero;
  raw[2] = row1 && c0 ? __ldg(reinterpret_cast<const float4*>(row1 + col))
                      : zero;
  raw[3] = row1 && c1
               ? __ldg(reinterpret_cast<const float4*>(row1 + col + 16))
               : zero;
}

// value q (0..7) of a row's 8: q < 4 from the first load, else the second
__device__ __forceinline__ float value(const float4 (&raw)[4], int row,
                                       int q) {
  return q < 4 ? part(raw[2 * row], q) : part(raw[2 * row + 1], q - 4);
}

__device__ __forceinline__ const float* row_pointer(const Params& p, int r) {
  if (r >= p.M) return nullptr;
  const int item = r / p.rows_per_item;
  return p.a + item * p.item_stride +
         static_cast<long long>(r - item * p.rows_per_item) * p.row_stride;
}

// Start the copies of k-block `block` of this CTA's sequence (its tiles in
// order, each tile's k-blocks in order) into ring stage `stage`, if there is
// one.
__device__ __forceinline__ void refill(const Params& p, float* ring,
                                       uint64_t* full, long long block,
                                       int stage) {
  const long long tile =
      blockIdx.x + block / p.k_blocks * static_cast<long long>(gridDim.x);
  if (tile >= p.tiles) return;
  const size_t first =
      (static_cast<size_t>(tile % p.n_tiles) * p.k_blocks +
       static_cast<size_t>(block % p.k_blocks)) * kTileFloats;
  float* dst = ring + static_cast<size_t>(stage) * 2 * kTileFloats;
  mbar_expect(&full[stage], 2 * kTileBytes);
  bulk_load(dst, p.w_hi + first, kTileBytes, &full[stage]);
  bulk_load(dst + kTileFloats, p.w_lo + first, kTileBytes, &full[stage]);
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ void store(const Params& p, float* row, int col,
                                      float v0, float v1) {
  if (row == nullptr) return;
  if (p.gelu) {
    v0 = gelu(v0);
    v1 = gelu(v1);
  }
  if (p.pairs && col + 1 < p.N) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    row[col] = v0;
    if (col + 1 < p.N) row[col + 1] = v1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tf32x3_gemm_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle works on shared addresses: 1024-align the ring
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* ring = reinterpret_cast<float*>(smem);  // stage s: hi, then lo
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  unsigned* released = reinterpret_cast<unsigned*>(full + kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages; ++s) refill(p, ring, full, s, s);
  }
  __syncthreads();

  // warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile, warp w of it
  // rows 16 w + g and 16 w + g + 8 (g = lane / 4), and in each k-step the
  // columns t and t + 4 (t = lane % 4) of A's fragment; the warp index
  // broadcast from lane 0, so the compiler sees it uniform in the warp
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rbase = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  long long block = 0;  // this CTA's k-blocks so far
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int mt = tile / p.n_tiles, nt = tile - mt * p.n_tiles;
    const int r0 = mt * kBM + rbase;
    const float* row0 = row_pointer(p, r0);
    const float* row1 = row_pointer(p, r0 + 8);
    float acc[kAcc], part_acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = part_acc[i] = 0.f;
    float4 raw[4];
    load_block(row0, row1, 4 * t, p.K, raw);
    for (int kb = 0; kb < p.k_blocks; ++kb, ++block) {
      const int stage = static_cast<int>(block % kStages);
      // k-step j takes values 2j (column t) and 2j + 1 (column t + 4) of
      // each row: the packing put W's matching columns there
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split(value(raw, 0, 2 * j), hi[j][0], lo[j][0]);
        split(value(raw, 1, 2 * j), hi[j][1], lo[j][1]);
        split(value(raw, 0, 2 * j + 1), hi[j][2], lo[j][2]);
        split(value(raw, 1, 2 * j + 1), hi[j][3], lo[j][3]);
      }
      if (kb + 1 < p.k_blocks)
        load_block(row0, row1, (kb + 1) * kBK + 4 * t, p.K, raw);
      mbar_wait(&full[stage], static_cast<unsigned>(block / kStages) & 1);
      const float* w_hi = ring + static_cast<size_t>(stage) * 2 * kTileFloats;
      const uint64_t d_hi = descriptor(w_hi);
      const uint64_t d_lo = descriptor(w_hi + kTileFloats);
      fence_acc(part_acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a k-step is 8 columns, 32 bytes into each 128-byte row
        wgmma(part_acc, lo[j], d_hi + 2 * j, j > 0);
        wgmma(part_acc, hi[j], d_lo + 2 * j, 1);
        wgmma(part_acc, hi[j], d_hi + 2 * j, 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(part_acc);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part_acc[i];
      // the second warpgroup done with the stage refills it
      if ((threadIdx.x & 127) == 0) {
        __threadfence_block();
        if (atomicAdd(&released[stage], 1u) & 1u)
          refill(p, ring, full, block + kStages, stage);
      }
    }
    // accumulator 4i + 2h + v is row r0 + 8h, column 8i + 2t + v
    float* out0 = r0 < p.M ? p.out + static_cast<size_t>(r0) * p.N : nullptr;
    float* out1 =
        r0 + 8 < p.M ? p.out + static_cast<size_t>(r0 + 8) * p.N : nullptr;
    const int col0 = nt * kBN + 2 * t;
#pragma unroll
    for (int i = 0; i < kAcc / 4; ++i) {
      const int col = col0 + 8 * i;
      if (col < p.N) {
        float b0 = 0.f, b1 = 0.f;
        if (p.bias != nullptr) {
          b0 = __ldg(p.bias + col);
          if (col + 1 < p.N) b1 = __ldg(p.bias + col + 1);
        }
        store(p, out0, col, acc[4 * i] + b0, acc[4 * i + 1] + b1);
        store(p, out1, col, acc[4 * i + 2] + b0, acc[4 * i + 3] + b1);
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/tf32x3_gemm.py). `w_hi` and
// `w_lo` are `pack_weight`'s for a W of (N, K); A's rows as above, K a
// multiple of 4 and every row 16-byte aligned; `bias` may be null; `gelu`
// 0 or 1. Returns a cudaError_t code: 0 on a successful launch, which is
// asynchronous on `stream`, on the current device.
extern "C" int tf32x3_gemm(const void* a, const void* w_hi, const void* w_lo,
                           const void* bias, void* out, int M, int N, int K,
                           int rows_per_item, long long item_stride,
                           long long row_stride, int gelu, void* stream) {
  const auto misaligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
  };
  if (M < 1 || N < 1 || K < 1 || K % 4 != 0 || rows_per_item < 1 ||
      M % rows_per_item != 0 || item_stride < 0 || row_stride < 0 ||
      item_stride % 4 != 0 || row_stride % 4 != 0 || misaligned(a) ||
      misaligned(w_hi) || misaligned(w_lo) || (gelu != 0 && gelu != 1))
    return cudaErrorInvalidValue;
  Params p;
  p.a = static_cast<const float*>(a);
  p.w_hi = static_cast<const float*>(w_hi);
  p.w_lo = static_cast<const float*>(w_lo);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.item_stride = item_stride;
  p.row_stride = row_stride;
  p.rows_per_item = rows_per_item;
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_blocks = (K + kBK - 1) / kBK;
  p.n_tiles = (N + kBN - 1) / kBN;
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * p.n_tiles;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  p.gelu = gelu;
  p.pairs = N % 2 == 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tf32x3_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSharedBytes));
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  tf32x3_gemm_kernel<<<grid, kThreads, kSharedBytes,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
