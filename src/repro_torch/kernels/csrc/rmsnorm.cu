// Row RMSNorm for Hopper (sm_90a), float32 and bfloat16:
//
//   y = x * rsqrt(mean(x^2) + eps) * scale
//
// x and y are (rows, d) row-major, scale is (d,).  In bfloat16 (the
// reference's default dtype of the LM) x and y are bfloat16 and scale is
// bfloat16 or float32, as the reference's kernel takes either; every value
// is widened to float32 as it is read, the sum of squares and the products
// are float32, and y is rounded once to bfloat16 (__float2bfloat16_rn), as
// the TPU kernel computes in float32 and casts its output to x's dtype.
// float32 rows take a float32 scale.  The order is the reference's: x times
// the inverse root first, then times scale.  The inverse root is rsqrtf
// (at most 2 ulp from the correctly rounded value; the reference's
// (var + eps) ** -0.5 is held to it at 1e-5).
//
// Replaces: src/repro/kernels/rmsnorm.py :: rmsnorm_pallas (_rmsnorm_kernel).
//
// Bound: bytes.  Three float operations per element against 8 bytes of
// traffic (4 in bfloat16).  On the LM's decode step a call normalises one
// row of 4096: the bytes take 0.015 us, so what bounds the call is latency
// (the launch and the memory round trips on its critical path).
//
// Two kernels; the wrapper's launch_plan picks one from the dtype and the
// load width.
// - rmsnorm_kernel (the block kernel): a row, or two where a call has many
//   rows, in one block's registers, four vectors a thread; x and scale in
//   one burst, one barrier.  Every float32 call and every bfloat16 call
//   whose values cannot move 16 bytes at a time (d % 8 != 0 or a pointer
//   off a 16-byte boundary) takes it.  It has no 16-byte bfloat16 form: that
//   ran at 0.61-0.71 of the byte bound where float32's reaches 0.85-0.87,
//   a lane's chain being 64 squares of two rows in 120 registers under a
//   256-thread bound.
// - rmsnorm_row_kernel (bfloat16 rows, 16-byte vectors): one row a block,
//   two vectors a lane, so a lane carries 16 squares and a row of 1024
//   spreads over two warps; scale (bfloat16 or float32) in the same burst
//   as x; one barrier, none where one warp holds the row.  It ran ahead of
//   the block kernel at every bfloat16 shape measured: with 55 registers an
//   SM holds four blocks of a row of 4096, and a block that ends makes room
//   for the next.
// In both a thread holds vectors t + k * threads (k < vpt), adds their
// squares in k, then element order, its warp meets in a shuffle butterfly,
// and every thread adds the warps' sums in warp order: the order depends on
// the launch shape alone, never on which block takes a row or when, so a
// second call gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kBlock = 0, kRow = 1;
// the row kernel: two vectors a lane; a bfloat16 row of 8192 is 1024
// vectors, 512 threads
constexpr int kRowVectors = 2;
constexpr int kRowThreads = 512;

using bf16 = __nv_bfloat16;

constexpr int vec_align(int bytes) { return bytes > 16 ? 16 : bytes; }

// W consecutive values, moved as one load or store (16 bytes for 4 floats
// or 8 bfloat16; a float32 scale's 8 values are two 16-byte loads)
template <typename T, int W>
struct alignas(vec_align(sizeof(T) * W)) Vec {
  static constexpr int size = W;
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

// the squares of a thread's vectors, in vector then element order
template <typename V, int VPT>
__device__ __forceinline__ float squares(const V (&v)[VPT],
                                         const bool (&ok)[VPT]) {
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (ok[k]) {
#pragma unroll
      for (int e = 0; e < V::size; ++e) {
        const float xe = widen(v[k].v[e]);
        sq += xe * xe;
      }
    }
  }
  return sq;
}

// y's vectors t + k * threads of one row: x times inv, times scale
template <typename T, typename V, typename VS, int VPT>
__device__ __forceinline__ void store_row(T* yrow, const V (&v)[VPT],
                                          const VS (&w)[VPT],
                                          const bool (&ok)[VPT], float inv) {
  V* yr = reinterpret_cast<V*>(yrow);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (ok[k]) {
      V o;
#pragma unroll
      for (int e = 0; e < V::size; ++e)
        o.v[e] = narrow<T>(widen(v[k].v[e]) * inv * widen(w[k].v[e]));
      yr[threadIdx.x + k * blockDim.x] = o;
    }
  }
}

// ---- the block kernel ------------------------------------------------------

// T: x's and y's type, S: scale's; W: values per vector (1, or 4 floats);
// VPT: vectors per thread; ROWS: rows a block (1 or 2), which share the
// thread's slice of scale
template <typename T, typename S, int W, int VPT, int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ y, long long rows, int d, float eps) {
  using V = Vec<T, W>;
  using VS = Vec<S, W>;
  __shared__ float red[ROWS][kMaxWarps];
  const long long row0 = (long long)blockIdx.x * ROWS;
  // a block of two rows may hold one (the last of an odd count)
  const int live = ROWS == 1 ? 1 : (int)min((long long)ROWS, rows - row0);
  const int n = d / W;                       // vectors in a row
  const VS* wr = reinterpret_cast<const VS*>(scale);

  // one burst: the rows' values and the scale's, before any is used
  V v[ROWS][VPT];
  VS w[VPT];
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
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < live) {
      const float sq = warp_sum(squares(v[r], ok));
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
      store_row(y + (row0 + r) * d, v[r], w, ok, rsqrtf(total / d + eps));
    }
  }
}

// ---- the row kernel --------------------------------------------------------

// bfloat16 rows; S: scale's type (bfloat16 or float32)
template <typename S>
__global__ void __launch_bounds__(kRowThreads)
rmsnorm_row_kernel(const bf16* __restrict__ x, const S* __restrict__ scale,
                   bf16* __restrict__ y, int d, float eps) {
  using V = Vec<bf16, 8>;
  using VS = Vec<S, 8>;
  __shared__ float red[kRowThreads / kWarp];
  const long long row = blockIdx.x;
  const int n = d / V::size;
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  const VS* wr = reinterpret_cast<const VS*>(scale);
  V v[kRowVectors];
  VS w[kRowVectors];
  bool ok[kRowVectors];
#pragma unroll
  for (int k = 0; k < kRowVectors; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    ok[k] = i < n;
    if (ok[k]) {
      v[k] = xr[i];
      w[k] = wr[i];
    }
  }
  const float sq = warp_sum(squares(v, ok));
  float total;
  if (blockDim.x == kWarp) {
    total = sq;               // the same bits as 0 + the one warp's sum
  } else {
    if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = sq;
    __syncthreads();
    total = 0.f;
    for (int i = 0; i < (int)(blockDim.x / kWarp); ++i) total += red[i];
  }
  store_row(y + row * d, v, w, ok, rsqrtf(total / d + eps));
}

// ---- launch ----------------------------------------------------------------

// the block kernel for (width, vpt, rows_per_block): width 1 with vpt 4 or
// 8, and in float32 also width 4 with vpt 4
template <typename T, typename S>
const void* block_kernel(int width, int vpt, int rows_per_block) {
#define REPRO_RMS_KERNEL(W, V)                                               \
  if (width == W && vpt == V)                                                \
    return rows_per_block == 1                                               \
               ? (const void*)rmsnorm_kernel<T, S, W, V, 1>                  \
               : (const void*)rmsnorm_kernel<T, S, W, V, 2>;
  if (rows_per_block != 1 && rows_per_block != 2) return nullptr;
  if constexpr (sizeof(T) == 4) {
    REPRO_RMS_KERNEL(4, 4)
  }
  REPRO_RMS_KERNEL(1, 4)
  REPRO_RMS_KERNEL(1, 8)
#undef REPRO_RMS_KERNEL
  return nullptr;
}

// the kernel of a plan (see rmsnorm_f32), or nullptr; *most: its threads
template <typename T, typename S>
const void* kernel_for(int kernel, int width, int vpt, int rows_per_block,
                       int* most) {
  if (kernel == kBlock) {
    *most = kMaxThreads;
    return block_kernel<T, S>(width, vpt, rows_per_block);
  }
  if constexpr (sizeof(T) == 2) {
    if (kernel == kRow && width == 8 && vpt == kRowVectors &&
        rows_per_block == 1) {
      *most = kRowThreads;
      return (const void*)rmsnorm_row_kernel<S>;
    }
  }
  return nullptr;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename T, typename S>
int launch(const T* x, const S* scale, T* y, long long rows, int d,
           int width, int threads, int vpt, int rows_per_block, int kernel,
           float eps, void* stream) {
  int most = 0;
  const void* fn = kernel_for<T, S>(kernel, width, vpt, rows_per_block, &most);
  if (fn == nullptr || rows <= 0 || rows > 0x7fffffffLL || d <= 0 ||
      d > 8192 || d % width != 0 || threads % kWarp != 0 || threads <= 0 ||
      threads > most || (long long)threads * vpt < d / width)
    return (int)cudaErrorInvalidValue;
  if (width > 1 && !(aligned16(x) && aligned16(scale) && aligned16(y)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kernel == kRow) {
    void* args[] = {&x, &scale, &y, &d, &eps};
    err = cudaLaunchKernel(fn, dim3((unsigned)rows), dim3(threads), args, 0,
                           s);
  } else {
    void* args[] = {&x, &scale, &y, &rows, &d, &eps};
    const unsigned blocks =
        (unsigned)((rows + rows_per_block - 1) / rows_per_block);
    err = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, 0, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// A launch plan (the wrapper's launch_plan): ``kernel`` 0 is the block
// kernel (width 1 with vpt 4 or 8, or in float32 width 4 with vpt 4;
// rows_per_block 1 or 2; at most 1024 threads), 1 the row kernel
// (bfloat16 rows, width 8, vpt 2, one row a block, at most 512 threads).
// threads a whole number of warps with threads * vpt >= d / width;
// 1 <= d <= 8192; 1 <= rows < 2^31; with a 16-byte width, d % width == 0
// and x, scale and y 16-byte aligned.  Returns cudaGetLastError() after
// the launch.
extern "C" int rmsnorm_f32(const float* x, const float* scale, float* y,
                           long long rows, int d, int width, int threads,
                           int vpt, int rows_per_block, int kernel,
                           float eps, void* stream) {
  return launch<float, float>(x, scale, y, rows, d, width, threads, vpt,
                              rows_per_block, kernel, eps, stream);
}

// x and y bfloat16; scale bfloat16, or float32 where ``scale_f32``;
// otherwise as rmsnorm_f32.
extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* y,
                            long long rows, int d, int width, int threads,
                            int vpt, int rows_per_block, int kernel,
                            int scale_f32, float eps, void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  if (scale_f32)
    return launch<bf16, float>(xb, static_cast<const float*>(scale), yb, rows,
                               d, width, threads, vpt, rows_per_block, kernel,
                               eps, stream);
  return launch<bf16, bf16>(xb, static_cast<const bf16*>(scale), yb, rows, d,
                            width, threads, vpt, rows_per_block, kernel, eps,
                            stream);
}

// Blocks of a plan's kernel (as rmsnorm_bf16 takes it; x of ``itemsize``
// 4 or 2 bytes, scale of ``scale_itemsize``) one SM holds at once (-1 on
// error).
extern "C" int rmsnorm_occupancy(int itemsize, int scale_itemsize, int kernel,
                                 int width, int vpt, int threads,
                                 int rows_per_block) {
  int most = 0;
  const void* fn = nullptr;
  if (itemsize == 4 && scale_itemsize == 4)
    fn = kernel_for<float, float>(kernel, width, vpt, rows_per_block, &most);
  else if (itemsize == 2 && scale_itemsize == 2)
    fn = kernel_for<bf16, bf16>(kernel, width, vpt, rows_per_block, &most);
  else if (itemsize == 2 && scale_itemsize == 4)
    fn = kernel_for<bf16, float>(kernel, width, vpt, rows_per_block, &most);
  int blocks = -1;
  if (fn == nullptr || threads > most ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    0) != cudaSuccess)
    return -1;
  return blocks;
}
