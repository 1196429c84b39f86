// Row RMSNorm for Hopper (sm_90a), float32:
//
//   y = x * rsqrt(mean(x^2) + eps) * scale
//
// x and y are (rows, d) row-major, scale is (d,).  The order is the
// reference's: x times the inverse root first, then times scale.  The
// inverse root is rsqrtf (at most 2 ulp from the correctly rounded value;
// the reference's (var + eps) ** -0.5 is held to it at 1e-5).
//
// Replaces: src/repro/kernels/rmsnorm.py :: rmsnorm_pallas (_rmsnorm_kernel).
//
// Bound: bytes.  Three float operations per element against 8 bytes of
// traffic.  On the LM's decode step a call normalises one row of 4096: the
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
// The wrapper picks the width (load_width), threads and vectors from d
// (launch_shape) and the rows a block from the row count.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;

// W consecutive floats, moved as one load or store (16 bytes for W = 4)
template <int W>
struct __align__(4 * W) Vec {
  float v[W];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// W: floats per vector (1 or 4); VPT: vectors per thread; ROWS: rows a
// block (1 or 2), which share the thread's slice of scale
template <int W, int VPT, int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               float* __restrict__ y, long long rows, int d, float eps) {
  using V = Vec<W>;
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
        if (r < live) v[r][k] = reinterpret_cast<const V*>(x + (row0 + r) * d)[i];
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
          for (int e = 0; e < W; ++e) sq += v[r][k].v[e] * v[r][k].v[e];
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
          for (int e = 0; e < W; ++e) o.v[e] = v[r][k].v[e] * inv * w[k].v[e];
          yr[threadIdx.x + k * blockDim.x] = o;
        }
      }
    }
  }
}

const void* kernel_for(int width, int vpt, int rows_per_block) {
#define REPRO_RMS_KERNEL(W, V)                                               \
  if (width == W && vpt == V)                                                \
    return rows_per_block == 1 ? (const void*)rmsnorm_kernel<W, V, 1>        \
                               : (const void*)rmsnorm_kernel<W, V, 2>;
  if (rows_per_block != 1 && rows_per_block != 2) return nullptr;
  REPRO_RMS_KERNEL(4, 4)
  REPRO_RMS_KERNEL(1, 4)
  REPRO_RMS_KERNEL(1, 8)
#undef REPRO_RMS_KERNEL
  return nullptr;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
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
  const void* fn = kernel_for(width, vpt, rows_per_block);
  if (fn == nullptr || rows <= 0 || rows > 0x7fffffffLL || d <= 0 ||
      d > 8192 || d % width != 0 || threads % kWarp != 0 || threads <= 0 ||
      threads > kMaxThreads || (long long)threads * vpt < d / width)
    return (int)cudaErrorInvalidValue;
  if (width == 4 && !(aligned16(x) && aligned16(scale) && aligned16(y)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &scale, &y, &rows, &d, &eps};
  const unsigned blocks =
      (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  cudaError_t err = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args,
                                     0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the kernel for (width, vpt, threads, rows_per_block) one SM
// holds at once (-1 on error).
extern "C" int rmsnorm_occupancy(int width, int vpt, int threads,
                                 int rows_per_block) {
  const void* fn = kernel_for(width, vpt, rows_per_block);
  int blocks = -1;
  if (fn == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, fn, threads, 0) != cudaSuccess)
    return -1;
  return blocks;
}
