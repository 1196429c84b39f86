// Fused DiT adaLN for Hopper (sm_90a), float32 and bfloat16:
//
//   plain:     y = (LN(x) * w + b) * (1 + scale) + shift
//   epilogue:  r = residual + gate * x;  y = (LN(r) * w + b) * (1 + scale) + shift
//
// x / residual / y / r are (B, S, d) row-major; shift / scale / gate are one
// d-vector per batch row b (row stride given, so a view of a wider
// modulation tensor needs no copy); w / b are the LayerNorm affine (d,).
//
// Replaces: src/repro/kernels/adaln_norm.py :: adaln_norm_pallas
//   (_adaln_kernel for the plain form, _adaln_epilogue_kernel for the
//   gated-residual epilogue).
//
// Bound: bytes.  Per element it does ~10 float operations against 8 bytes
// (plain) or 16 bytes (epilogue) of traffic in float32, half that in
// bfloat16, far below the card's
// operations-per-byte balance, so the least time is the bytes over the
// memory rate.  At the DiT's shapes (B <= 4 rows of 256 x 768) the bytes
// take under 4 us, so what bounds a call in practice is latency: the
// launch, one memory round trip, and the two reductions.
//
// Design.  The first port gave each row to one warp, 8 rows a block: at
// B = 4 that is 128 blocks of 8 warps, one block an SM, each lane issuing
// 24 scalar loads, and the four parameter vectors were read only after both
// reductions (a second round trip on the critical path).  Here:
// - One block a row, each thread two vectors of it (a float4 where the
//   row allows, see below), so a d = 768 row is 96 threads (3 warps) and
//   1024 rows (B = 4) fit one wave; at B = 1, 256 blocks put work on every
//   SM.  Rows wider than 1024 vectors give each thread 4 or 8 (d <= 4096).
//   Tried on the card and not kept (PERF.md): one float4 a thread (192
//   threads a row; 6 blocks an SM by registers, so 1024 rows took 1.3
//   waves) and two rows of one batch row a block sharing the parameter
//   loads (the epilogue 2% faster, the plain form 3% and B = 1 7% slower).
// - 16-byte loads and stores (W = 4) where d % 4 == 0 and every pointer
//   and modulation row stride is 16-byte aligned, as for the DiT's (B, 6d)
//   projection chunks; single floats (W = 1) otherwise.  The wrapper picks
//   the width from the shapes, strides and pointers; both widths are this
//   kernel, one template.  In bfloat16 a 16-byte vector holds 8 values
//   (W = 8) and a thread takes one, so a d = 768 row is 96 threads, as in
//   float32 (two vectors a thread, 64 threads, ran 4-9% slower on an H100;
//   one float4 a thread, 7-12% slower in float32); w and b move as W
//   values of P (8 bytes for bfloat16 with float32 x, 32 bytes as two
//   16-byte loads for float32 with bfloat16 x).
// - The parameters (w, b, scale, shift) are loaded with the row, before the
//   reductions that do not need them, so their latency hides under the
//   sums.
// - Mean and variance are two block sums over the registers: a warp
//   shuffle butterfly, then every thread adds the warps' partials from
//   shared memory in warp order, so every thread holds the same bits and
//   two calls give the same result.  The variance is the mean of squared
//   deviations, as jnp.var computes it, not E[x^2] - mean^2; the row stays
//   in registers between the passes, so x and the residual are read once
//   and y and r written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / kWarp;

using bf16 = __nv_bfloat16;

constexpr int vec_align(int bytes) { return bytes < 16 ? bytes : 16; }

// W consecutive values of U, moved as one load or store (16 bytes for 4
// floats or 8 bfloat16; wider vectors as 16-byte pieces)
template <typename U, int W>
struct alignas(vec_align(sizeof(U) * W)) Vec {
  U v[W];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename U>
__device__ __forceinline__ U narrow(float v);
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

// the block's sum of v, the same bits in every thread: warps in order
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  float t = 0.f;
  const int warps = blockDim.x / kWarp;
  for (int i = 0; i < warps; ++i) t += red[i];
  return t;
}

// T: the activations' and modulation's type; P: w's and b's; W: values
// per vector (1, or 16 bytes of T); VPT: vectors per thread
template <typename T, typename P, int W, int VPT, bool EPILOGUE>
__global__ void __launch_bounds__(kMaxThreads)
adaln_kernel(const T* __restrict__ x, const T* __restrict__ residual,
             const T* __restrict__ gate, long long gate_stride,
             const T* __restrict__ shift, long long shift_stride,
             const T* __restrict__ scale, long long scale_stride,
             const P* __restrict__ weight, const P* __restrict__ bias,
             T* __restrict__ y, T* __restrict__ r_out, int seq, int d,
             float eps) {
  using V = Vec<T, W>;
  using VP = Vec<P, W>;
  __shared__ float red_sum[kMaxWarps];
  __shared__ float red_sq[kMaxWarps];
  const long long row = blockIdx.x;
  const long long b = row / seq;
  const int n = d / W;                       // vectors in a row
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  const V* rr = reinterpret_cast<const V*>(residual + row * d);
  const V* gr = reinterpret_cast<const V*>(gate + b * gate_stride);
  const V* shr = reinterpret_cast<const V*>(shift + b * shift_stride);
  const V* scr = reinterpret_cast<const V*>(scale + b * scale_stride);
  const VP* wr = reinterpret_cast<const VP*>(weight);
  const VP* br = reinterpret_cast<const VP*>(bias);

  // the row in float32 (in the epilogue the unrounded r); the parameters
  // as loaded, widened where used
  float v[VPT][W];
  VP w[VPT], bi[VPT];
  V sc[VPT], sh[VPT];
  bool ok[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    ok[k] = i < n;
    if (ok[k]) {
      const V xv = xr[i];
      if (EPILOGUE) {
        const V res = rr[i];
        const V g = gr[i];
#pragma unroll
        for (int e = 0; e < W; ++e)
          v[k][e] = widen(res.v[e]) + widen(g.v[e]) * widen(xv.v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) v[k][e] = widen(xv.v[e]);
      }
      // nothing below the sums depends on these: load them now
      w[k] = wr[i];
      bi[k] = br[i];
      sc[k] = scr[i];
      sh[k] = shr[i];
    }
  }

  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (ok[k]) {
      if (EPILOGUE) {
        V o;
#pragma unroll
        for (int e = 0; e < W; ++e) o.v[e] = narrow<T>(v[k][e]);
        reinterpret_cast<V*>(r_out + row * d)[threadIdx.x + k * blockDim.x] =
            o;
      }
#pragma unroll
      for (int e = 0; e < W; ++e) sum += v[k][e];
    }
  }
  const float mean = block_sum(sum, red_sum) / d;

  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (ok[k]) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float c = v[k][e] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = 1.0f / sqrtf(block_sum(sq, red_sq) / d + eps);

  V* yr = reinterpret_cast<V*>(y + row * d);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (ok[k]) {
      V o;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float t = (v[k][e] - mean) * rstd;
        t = t * widen(w[k].v[e]) + widen(bi[k].v[e]);
        o.v[e] = narrow<T>(t * (1.0f + widen(sc[k].v[e])) +
                           widen(sh[k].v[e]));
      }
      yr[threadIdx.x + k * blockDim.x] = o;
    }
  }
}

// the kernel for (width, vpt): width 16 / sizeof(T) with vpt 2 (float32)
// or 1 (bfloat16), or width 1 with vpt 2, 4 or 8
template <typename T, typename P, bool EPILOGUE>
const void* kernel_for(int width, int vpt) {
  constexpr int kWide = 16 / sizeof(T);
  constexpr int kWideVpt = sizeof(T) == 2 ? 1 : 2;
  if (width == kWide && vpt == kWideVpt)
    return (const void*)adaln_kernel<T, P, kWide, kWideVpt, EPILOGUE>;
  if (width == 1 && vpt == 2)
    return (const void*)adaln_kernel<T, P, 1, 2, EPILOGUE>;
  if (width == 1 && vpt == 4)
    return (const void*)adaln_kernel<T, P, 1, 4, EPILOGUE>;
  if (width == 1 && vpt == 8)
    return (const void*)adaln_kernel<T, P, 1, 8, EPILOGUE>;
  return nullptr;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename T, typename P>
int launch(const T* x, const T* residual, const T* gate,
           long long gate_stride, const T* shift, long long shift_stride,
           const T* scale, long long scale_stride, const P* weight,
           const P* bias, T* y, T* r_out, long long rows, int seq, int d,
           int width, int threads, int vpt, float eps, void* stream) {
  const bool epilogue = residual != nullptr;
  const void* fn = epilogue ? kernel_for<T, P, true>(width, vpt)
                            : kernel_for<T, P, false>(width, vpt);
  if (fn == nullptr || rows <= 0 || rows > 0x7fffffffLL || seq <= 0 ||
      d <= 0 || d % width != 0 || threads % kWarp != 0 || threads <= 0 ||
      threads > kMaxThreads || (long long)threads * vpt < d / width)
    return (int)cudaErrorInvalidValue;
  if (width > 1) {
    const void* ptrs[] = {x, shift, scale, weight, bias, y};
    for (const void* p : ptrs)
      if (!aligned16(p)) return (int)cudaErrorInvalidValue;
    if (shift_stride % width || scale_stride % width)
      return (int)cudaErrorInvalidValue;
    if (epilogue && (!aligned16(residual) || !aligned16(gate) ||
                     !aligned16(r_out) || gate_stride % width))
      return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&x,      &residual,     &gate,  &gate_stride, &shift,
                  &shift_stride, &scale, &scale_stride, &weight, &bias,
                  &y,      &r_out,        &seq,   &d,           &eps};
  cudaError_t err =
      cudaLaunchKernel(fn, dim3((unsigned)rows), dim3(threads), args, 0,
                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_params(const T* x, const T* residual, const T* gate,
                  long long gate_stride, const T* shift,
                  long long shift_stride, const T* scale,
                  long long scale_stride, const void* weight,
                  const void* bias, int params_bf16, T* y, T* r_out,
                  long long rows, int seq, int d, int width, int threads,
                  int vpt, float eps, void* stream) {
  if (params_bf16)
    return launch<T, bf16>(x, residual, gate, gate_stride, shift,
                           shift_stride, scale, scale_stride,
                           static_cast<const bf16*>(weight),
                           static_cast<const bf16*>(bias), y, r_out, rows,
                           seq, d, width, threads, vpt, eps, stream);
  return launch<T, float>(x, residual, gate, gate_stride, shift,
                          shift_stride, scale, scale_stride,
                          static_cast<const float*>(weight),
                          static_cast<const float*>(bias), y, r_out, rows,
                          seq, d, width, threads, vpt, eps, stream);
}

}  // namespace

// residual == nullptr selects the plain form (gate and r_out are ignored).
// x, residual, gate, shift, scale, y and r_out float32; weight and bias
// float32, or bfloat16 where params_bf16 is nonzero.  width 4 (16-byte
// vectors: d % 4 == 0, every pointer 16-byte aligned and every modulation
// row stride a multiple of 4) with vpt 2, or width 1 with vpt 2, 4 or 8;
// threads a whole number of warps up to 512 with threads * vpt >= d /
// width (the wrapper's launch_shape).  Returns cudaGetLastError() after
// the launch.
extern "C" int adaln_norm_f32(const float* x, const float* residual,
                              const float* gate, long long gate_stride,
                              const float* shift, long long shift_stride,
                              const float* scale, long long scale_stride,
                              const void* weight, const void* bias,
                              int params_bf16, float* y, float* r_out,
                              long long rows, int seq, int d, int width,
                              int threads, int vpt, float eps, void* stream) {
  return launch_params<float>(x, residual, gate, gate_stride, shift,
                              shift_stride, scale, scale_stride, weight,
                              bias, params_bf16, y, r_out, rows, seq, d,
                              width, threads, vpt, eps, stream);
}

// As adaln_norm_f32 with x, residual, gate, shift, scale, y and r_out
// bfloat16, and width 8 (16-byte vectors: d % 8 == 0, the pointers 16-byte
// aligned, the modulation row strides multiples of 8) with vpt 1, or width
// 1 with vpt 2, 4 or 8.
extern "C" int adaln_norm_bf16(const void* x, const void* residual,
                               const void* gate, long long gate_stride,
                               const void* shift, long long shift_stride,
                               const void* scale, long long scale_stride,
                               const void* weight, const void* bias,
                               int params_bf16, void* y, void* r_out,
                               long long rows, int seq, int d, int width,
                               int threads, int vpt, float eps, void* stream) {
  return launch_params<bf16>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(residual),
      static_cast<const bf16*>(gate), gate_stride,
      static_cast<const bf16*>(shift), shift_stride,
      static_cast<const bf16*>(scale), scale_stride, weight, bias,
      params_bf16, static_cast<bf16*>(y), static_cast<bf16*>(r_out), rows,
      seq, d, width, threads, vpt, eps, stream);
}

// Blocks of the float32 kernel for (width, vpt, threads, epilogue) one SM
// holds at once (-1 on error).
extern "C" int adaln_norm_occupancy(int width, int vpt, int threads,
                                    int epilogue) {
  const void* fn = epilogue ? kernel_for<float, float, true>(width, vpt)
                            : kernel_for<float, float, false>(width, vpt);
  int blocks = -1;
  if (fn == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, fn, threads, 0) != cudaSuccess)
    return -1;
  return blocks;
}
