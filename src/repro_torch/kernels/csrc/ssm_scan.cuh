// Shared by the selective-scan kernels (ssm_scan.cu, ssm_scan_backward.cu):
// the chunk of steps between the forward's state checkpoints, the layout
// of those checkpoints, the exponential both kernels compute, and the
// asynchronous copies that stage a chunk's operands in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_ssm {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 16;        // steps per chunk (state checkpoints)
constexpr int kWarp = 32;
constexpr float kLog2e = 1.4426950408889634f;

// N is kept in registers as a tile of 4, 8 or 16 (zero-padded states)
inline int state_tile(int N) { return N <= 4 ? 4 : (N <= 8 ? 8 : 16); }

__host__ __device__ inline int num_chunks(int L) { return (L + kChunk - 1) / kChunk; }

inline bool bad_shape(int batch, int L, int Din, int N) {
  return batch <= 0 || batch > 65535 || L <= 0 || Din <= 0 || N <= 0 ||
         N > 16;
}

// index of state n of channel (b, d) at the start of chunk c, in the
// forward's checkpoints (batch, nchunks, N, Din): coalesced over d
__device__ __forceinline__ long long state_index(int b, int c, int nc, int n,
                                                 int N, int d, int Din) {
  return (((long long)b * nc + c) * N + n) * Din + d;
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The step's decay exp(dt * a) as both kernels compute it: a2 = a *
// log2(e) formed once per state, one multiply by dt and one ex2.approx
// (flushing results under 2^-126 to 0, where the plain version's denormals
// are smaller than any tolerance).  The state update is pinned to one
// rounding order, h = fma(decay, h, du * b) with du = dt * u, in both
// kernels (no contraction left to the compiler), so the backward's
// recomputed states are the forward's bits.
__device__ __forceinline__ float decay(float dt, float a2) {
  return ex2(__fmul_rn(dt, a2));
}

__device__ __forceinline__ float update(float da, float h, float du,
                                        float b) {
  return __fmaf_rn(da, h, __fmul_rn(du, b));
}

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

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// 4 bytes from global to shared, asynchronously; zero-filled where !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0));
}

// 16 bytes from global to shared, asynchronously; zero-filled where !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;");
}

// values of T a 16-byte copy moves
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// K kChunk x W tiles of K row-major global matrices of one shape into
// shared memory: tile row r of matrix q is src[q][(row0 + r) * ld + col0
// ...], zeros where r >= rows or a column >= cols.  With vec (ld and col0
// multiples of kVec<T>, every src 16-byte aligned, so no 16-byte group
// straddles cols) 16 bytes a cp.async; else one value a copy: 4 bytes by
// cp.async for float, a plain load and store for bfloat16 (cp.async moves
// no fewer than 4 bytes).  The thread of index tid (0 .. NT - 1, by
// default threadIdx.x) copies entries tid, tid + NT, ... of every tile; a
// thread's own entries are in shared memory once it has waited on its
// copies (cp_async_wait_all), the others' after a barrier besides.
template <int NT, int K, int W, typename T>
__device__ __forceinline__ void copy_tiles(T (*dst)[kChunk][W],
                                           const T* const (&src)[K],
                                           long long row0, long long ld,
                                           int rows, int col0, int cols,
                                           bool vec,
                                           int tid = threadIdx.x) {
  constexpr int E = kVec<T>;
  if constexpr (W % E == 0) {          // else the caller passes !vec
    if (vec) {
      for (int i = tid; i < kChunk * (W / E); i += NT) {
        const int r = i / (W / E), j = E * (i % (W / E));
        const bool in = r < rows && j < cols;
        const long long off = in ? (row0 + r) * ld + col0 + j : 0;
#pragma unroll
        for (int q = 0; q < K; ++q)
          cp_async16(&dst[q][r][j], src[q] + off, in);
      }
      return;
    }
  }
  for (int i = tid; i < kChunk * W; i += NT) {
    const int r = i / W, j = i % W;
    const bool in = r < rows && j < cols;
    const long long off = in ? (row0 + r) * ld + col0 + j : 0;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if constexpr (sizeof(T) == 4)
        cp_async4(&dst[q][r][j], src[q] + off, in);
      else
        dst[q][r][j] = in ? src[q][off] : T(0.f);
    }
  }
}

}  // namespace repro_ssm
