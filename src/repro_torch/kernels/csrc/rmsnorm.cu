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
// traffic.
//
// Design: the TPU kernel holds tiles of 256 full rows in VMEM.  Here one
// block owns one row, which lives in its threads' registers (at most eight
// values a thread), so x is read once and y written once; the sum of
// squares is a warp-shuffle reduction and then a fixed-order reduction over
// the warps through shared memory, so it does not depend on scheduling.
// Rows whose width is a multiple of 4 (and whose pointers are 16-byte
// aligned) move as float4, others as single floats.  The block has as many
// threads as give each at most four vectors, from 32 up to 1024: 256 at
// d = 4096, so a single decode row is spread over a whole SM.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sumsq(float a) { return a * a; }
__device__ __forceinline__ float sumsq(float4 a) {
  return a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
}
__device__ __forceinline__ float norm(float x, float inv, float w) {
  return x * inv * w;
}
__device__ __forceinline__ float4 norm(float4 x, float inv, float4 w) {
  return make_float4(x.x * inv * w.x, x.y * inv * w.y, x.z * inv * w.z,
                     x.w * inv * w.w);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// T: float or float4; VPT: values of T per thread; n: values of T per row
template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               float* __restrict__ y, int n, int d, float eps) {
  __shared__ float red[kMaxThreads / kWarp];
  const long long row = blockIdx.x;
  const T* xr = reinterpret_cast<const T*>(x + row * d);
  T* yr = reinterpret_cast<T*>(y + row * d);
  const T* w = reinterpret_cast<const T*>(scale);

  T v[VPT];
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    v[i] = idx < n ? xr[idx] : zero<T>();
    sq += sumsq(v[i]);
  }
  sq = warp_sum(sq);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x / kWarp;
    float t = lane < nwarps ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / d + eps);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < n) yr[idx] = norm(v[i], inv, w[idx]);
  }
}

template <typename T>
cudaError_t launch(long long rows, int n, int d, float eps, const float* x,
                   const float* scale, float* y, cudaStream_t stream) {
  // threads: enough that each holds at most four values, a whole number of
  // warps, at most 1024 (then up to eight values each)
  int threads = ((n + 3) / 4 + kWarp - 1) / kWarp * kWarp;
  threads = threads < kWarp ? kWarp : (threads > kMaxThreads ? kMaxThreads
                                                             : threads);
  const int vpt = (n + threads - 1) / threads;
  const dim3 grid((unsigned)rows);
#define REPRO_RMS_LAUNCH(V)                                                  \
  rmsnorm_kernel<T, V><<<grid, threads, 0, stream>>>(x, scale, y, n, d, eps)
  if (vpt <= 1) REPRO_RMS_LAUNCH(1);
  else if (vpt <= 2) REPRO_RMS_LAUNCH(2);
  else if (vpt <= 4) REPRO_RMS_LAUNCH(4);
  else if (vpt <= 8) REPRO_RMS_LAUNCH(8);
  else return cudaErrorInvalidValue;
#undef REPRO_RMS_LAUNCH
  return cudaSuccess;
}

}  // namespace

// 1 <= d <= 8192; 1 <= rows < 2^31.  Returns cudaGetLastError() after the
// launch.
extern "C" int rmsnorm_f32(const float* x, const float* scale, float* y,
                           long long rows, int d, float eps, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || d > 8192)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<std::uintptr_t>(x) |
                     reinterpret_cast<std::uintptr_t>(scale) |
                     reinterpret_cast<std::uintptr_t>(y)) & 15) == 0;
  cudaError_t err = vec ? launch<float4>(rows, d / 4, d, eps, x, scale, y, s)
                        : launch<float>(rows, d, d, eps, x, scale, y, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
