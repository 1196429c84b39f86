// Row RMSNorm for Hopper (sm_90a), float32 and bfloat16:
//
//   y = x * rsqrt(mean(x^2) + eps) * scale
//
// x and y are (rows, d) row-major, scale is (d,).  In bfloat16 (the
// reference's default dtype of the LM) x, scale and y are bfloat16; every
// value is widened to float32 as it is read,
// the sum of squares and the products are float32, and y is rounded once
// to bfloat16 (__float2bfloat16_rn), as the TPU kernel computes in float32
// and casts its output to x's dtype.  The order is the
// reference's: x times the inverse root first, then times scale.  The
// inverse root is rsqrtf (at most 2 ulp from the correctly rounded value;
// the reference's (var + eps) ** -0.5 is held to it at 1e-5).
//
// Replaces: src/repro/kernels/rmsnorm.py :: rmsnorm_pallas (_rmsnorm_kernel).
//
// Bound: bytes.  Three float operations per element against 8 bytes of
// traffic (4 in bfloat16).  On the LM's decode step a call normalises one row of 4096: the
// bytes take 0.015 us, so what bounds the call is latency (the launch and
// the memory round trips on its critical path).
//
// Design.  The TPU kernel holds tiles of 256 full rows in VMEM.  Here a
// row lives in its block's registers, so x is read once and y written
// once.  The first port read scale only after the reduction,
// behind two barriers: two dependent memory round trips a call, the second
// with the scale vector cold from HBM in the decode step, where the
// weights stream through L2 between two norms.  Here:
// - Each thread loads its slice of scale in the same burst as its slice of
//   x, before the reduction, which does not need it: one round trip a
//   call.
// - One barrier: each warp reduces its squares with a shuffle butterfly and
//   writes one partial; after a single __syncthreads() every thread adds
//   all the partials itself in warp order, so every thread holds the same
//   bits and two calls give the same result.
// - Four vectors a thread (a float4 where d % 4 == 0 and every pointer is
//   16-byte aligned, else single floats; eight single floats for rows over
//   4096), so a row of 4096 is 256 threads.
// - Scale in registers costs as many registers as x: one row a block then
//   holds fewer rows an SM than the first port did, and many rows lose
//   their rate (the trainer's 1024 rows, L2-warm, ran 4% slower).  So where
//   a call has many rows a block takes two, and each thread's scale slice
//   serves both: an SM holds as many rows as before, and scale is read
//   half as often.  One row takes one block (no idle second row's sums).
// - bfloat16 is the same kernel over another element type: a 16-byte
//   vector holds 8 values, so a row of 4096 is 128 threads of four
//   vectors, and the bytes a call moves are half of float32's.  Its
//   16-byte form takes at most 256 threads (a row of 8192), and says so
//   in its launch bounds: under the 1024-thread bound's 64 registers the
//   two-row block spilled 716 bytes a thread (ptxas, on an H100) and ran
//   below the float32 kernel.
// The wrapper picks the width (load_width), threads and vectors from d
// (launch_shape) and the rows a block from the row count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;

using bf16 = __nv_bfloat16;

// W consecutive values, moved as one load or store (16 bytes for 4 floats
// or 8 bfloat16)
template <typename T, int W>
struct __align__(sizeof(T) * W) Vec {
  T v[W];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// T: x's, scale's and y's type; W: values per vector (1, or 16 bytes: 4
// floats, 8 bfloat16); VPT: vectors per thread; ROWS: rows a block (1 or
// 2), which share the thread's slice of scale
template <typename T, int W>
constexpr int max_threads() {
  return sizeof(T) == 2 && W > 1 ? kMaxThreads / 4 : kMaxThreads;
}

template <typename T, int W, int VPT, int ROWS>
__global__ void __launch_bounds__(max_threads<T, W>())
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ y, long long rows, int d, float eps) {
  using V = Vec<T, W>;
  __shared__ float red[ROWS][kMaxWarps];
  const long long row0 = (long long)blockIdx.x * ROWS;
  // a block of two rows may hold one (the last of an odd count)
  const int live = ROWS == 1 ? 1 : (int)min((long long)ROWS, rows - row0);
  const int n = d / W;                       // vectors in a row
  const V* wr = reinterpret_cast<const V*>(scale);

  // one burst: the rows' values and the scale's, before any is used
  V v[ROWS][VPT], w[VPT];
  bool ok[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    ok[k] = i < n;
    if (ok[k]) {
      w[k] = wr[i];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < live)
          v[r][k] = reinterpret_cast<const V*>(x + (row0 + r) * d)[i];
    }
  }
  // squares in vector order, then element order; a warp's sum by shuffles
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < live) {
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        if (ok[k]) {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            const float xe = widen(v[r][k].v[e]);
            sq += xe * xe;
          }
        }
      }
      sq = warp_sum(sq);
      if (threadIdx.x % kWarp == 0) red[r][threadIdx.x / kWarp] = sq;
    }
  }
  __syncthreads();
  const int warps = blockDim.x / kWarp;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < live) {
      float total = 0.f;
      for (int i = 0; i < warps; ++i) total += red[r][i];
      const float inv = rsqrtf(total / d + eps);
      V* yr = reinterpret_cast<V*>(y + (row0 + r) * d);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        if (ok[k]) {
          V o;
#pragma unroll
          for (int e = 0; e < W; ++e)
            o.v[e] = narrow<T>(widen(v[r][k].v[e]) * inv * widen(w[k].v[e]));
          yr[threadIdx.x + k * blockDim.x] = o;
        }
      }
    }
  }
}

// the kernel for (width, vpt, rows_per_block): width 16 / sizeof(T) with
// vpt 4, or width 1 with vpt 4 or 8
template <typename T>
const void* kernel_for(int width, int vpt, int rows_per_block) {
  constexpr int kWide = 16 / sizeof(T);
#define REPRO_RMS_KERNEL(W, V)                                               \
  if (width == W && vpt == V)                                                \
    return rows_per_block == 1                                               \
               ? (const void*)rmsnorm_kernel<T, W, V, 1>                     \
               : (const void*)rmsnorm_kernel<T, W, V, 2>;
  if (rows_per_block != 1 && rows_per_block != 2) return nullptr;
  REPRO_RMS_KERNEL(kWide, 4)
  REPRO_RMS_KERNEL(1, 4)
  REPRO_RMS_KERNEL(1, 8)
#undef REPRO_RMS_KERNEL
  return nullptr;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const T* x, const T* scale, T* y, long long rows, int d,
           int width, int threads, int vpt, int rows_per_block, float eps,
           void* stream) {
  const void* fn = kernel_for<T>(width, vpt, rows_per_block);
  const int most = width > 1 ? max_threads<T, (int)(16 / sizeof(T))>()
                             : max_threads<T, 1>();
  if (fn == nullptr || rows <= 0 || rows > 0x7fffffffLL || d <= 0 ||
      d > 8192 || d % width != 0 || threads % kWarp != 0 || threads <= 0 ||
      threads > most || (long long)threads * vpt < d / width)
    return (int)cudaErrorInvalidValue;
  if (width > 1 && !(aligned16(x) && aligned16(scale) && aligned16(y)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &scale, &y, &rows, &d, &eps};
  const unsigned blocks =
      (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  cudaError_t err = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args,
                                     0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// 1 <= d <= 8192; 1 <= rows < 2^31.  width 4 (16-byte vectors: d % 4 == 0
// and x, scale and y 16-byte aligned) with vpt 4, or width 1 with vpt 4 or
// 8; threads a whole number of warps up to 1024 with threads * vpt >=
// d / width (the wrapper's launch_shape); rows_per_block 1 or 2.  Returns
// cudaGetLastError() after the launch.
extern "C" int rmsnorm_f32(const float* x, const float* scale, float* y,
                           long long rows, int d, int width, int threads,
                           int vpt, int rows_per_block, float eps,
                           void* stream) {
  return launch<float>(x, scale, y, rows, d, width, threads, vpt,
                       rows_per_block, eps, stream);
}

// x, scale and y bfloat16; width 8 (16-byte vectors: d % 8 == 0 and x,
// scale and y 16-byte aligned) with vpt 4, or width 1 with vpt 4 or 8;
// threads up to 256 with width 8; otherwise as rmsnorm_f32.
extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* y,
                            long long rows, int d, int width, int threads,
                            int vpt, int rows_per_block, float eps,
                            void* stream) {
  return launch<bf16>(static_cast<const bf16*>(x),
                      static_cast<const bf16*>(scale), static_cast<bf16*>(y),
                      rows, d, width, threads, vpt, rows_per_block, eps,
                      stream);
}

// Blocks of the kernel for (width, vpt, threads, rows_per_block) one SM
// holds at once (-1 on error).
extern "C" int rmsnorm_occupancy(int width, int vpt, int threads,
                                 int rows_per_block) {
  const void* fn = kernel_for<float>(width, vpt, rows_per_block);
  int blocks = -1;
  if (fn == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, fn, threads, 0) != cudaSuccess)
    return -1;
  return blocks;
}
