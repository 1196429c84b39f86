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
// Design of adaln_kernel, a block a row (single values, rows over 1024
// values, and the bfloat16 epilogue at few rows).  The first port gave
// each row to one warp, 8 rows a block: at B = 4 that was 128 blocks of 8
// warps, each lane issuing 24 scalar loads, and the four parameter
// vectors were read only after both reductions (a second round trip on
// the critical path).  Here a block owns a row, each thread two vectors
// of it (a float4 where the row allows; one 16-byte vector of 8 in
// bfloat16), so a d = 768 row is 96 threads (3 warps); rows wider than
// 1024 vectors give each thread 4 or 8 (d <= 4096).  The parameters are
// loaded with the row, before the reductions that do not need them.  Mean
// and variance are two block sums over the registers: a warp's shuffle
// butterfly, then every thread adds the warps' partials from shared memory
// in warp order.  The wrapper picks single values (W = 1) where d is not a
// multiple of 16 bytes of x, or a pointer or modulation row stride is not
// 16-byte aligned.
//
// Design of adaln_rows_kernel, a warp a row (16-byte vectors, d <= 1024:
// the DiT in both dtypes).  A block a row spends its time around the row:
// at B = 4, 1024 blocks of 3 warps, two barriers with a shared-memory read
// each.  Here lane l of a row's warp holds vectors l + 32 k (k < VPL:
// three of 8 bfloat16 or six float4 at d = 768), so one warp-wide load
// reads 512 contiguous bytes, and both sums are xor butterflies with no
// barrier and no shared memory; every lane ends with the same bits (each
// stage adds the same two values in both partners), so the order is fixed
// and two calls give the same result.  A block's four warps take
// consecutive rows of one batch row.  The row and its w, b, scale and
// shift slices stay in registers, all loaded in one burst.  A lane runs
// three times a block thread's chain of dependent operations; in
// bfloat16, where every value is widened, that leaves the epilogue slower
// than a block a row below 7 rows an SM, and the wrapper (launch_plan)
// keeps it on adaln_kernel there.  Tried on an H100 and not kept (PERF.md
// §6): two rows a warp sharing the parameter registers (slower: a
// lane's chain doubles), eight partial sums a lane added as a tree, the
// parameters staged in shared memory once a block, and a programmatic
// dependent launch (back to back it hid the launch gap, but the DiT's CUDA
// graph ran 0.4-1.1% slower with it).
//
// Both kernels: the variance is the mean of squared deviations, as jnp.var
// computes it, not E[x^2] - mean^2; the row stays in registers between the
// passes, so x and the residual are read once and y and r written once;
// w and b move as W values of P (8 bytes for bfloat16 with float32 x, 32
// bytes as two 16-byte loads for float32 with bfloat16 x).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kRowThreads = 256;   // adaln_rows_kernel: at most 8 warps

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

// 16-byte vectors of T, VPL a lane (a row of at most 32 * VPL * 16 /
// sizeof(T) values).  Warp w of block j of batch row b takes row j *
// warps + w of b.
template <typename T, typename P, int VPL, bool EPILOGUE>
__global__ void __launch_bounds__(kRowThreads)
adaln_rows_kernel(const T* __restrict__ x, const T* __restrict__ residual,
                  const T* __restrict__ gate, long long gate_stride,
                  const T* __restrict__ shift, long long shift_stride,
                  const T* __restrict__ scale, long long scale_stride,
                  const P* __restrict__ weight, const P* __restrict__ bias,
                  T* __restrict__ y, T* __restrict__ r_out, int seq, int d,
                  int blocks_per_batch, float eps) {
  constexpr int W = 16 / sizeof(T);
  using V = Vec<T, W>;
  using VP = Vec<P, W>;
  const int lane = threadIdx.x % kWarp;
  const long long b = blockIdx.x / blocks_per_batch;
  const int s = (int)(blockIdx.x % blocks_per_batch) * (blockDim.x / kWarp) +
                (int)(threadIdx.x / kWarp);
  if (s >= seq) return;                      // warp-uniform
  const long long row = b * seq + s;
  const int n = d / W;                       // vectors in a row
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  const V* rr = reinterpret_cast<const V*>(residual + row * d);
  const V* gr = reinterpret_cast<const V*>(gate + b * gate_stride);
  const V* shr = reinterpret_cast<const V*>(shift + b * shift_stride);
  const V* scr = reinterpret_cast<const V*>(scale + b * scale_stride);
  const VP* wr = reinterpret_cast<const VP*>(weight);
  const VP* br = reinterpret_cast<const VP*>(bias);

  // the row in float32 (in the epilogue the unrounded r); the parameters
  // as loaded, in the same burst, widened where used.  Where the
  // parameter loads sit in the burst was measured on an H100: after each
  // vector's row values in bfloat16, after the whole row in float32 (its
  // epilogue ran 5-18% slower the other way, bfloat16's 1-4% faster)
  constexpr bool kParamsByVector = sizeof(T) == 2;
  float v[VPL][W];
  VP w[VPL], bi[VPL];
  V sc[VPL], sh[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + k * kWarp;
    if (i < n) {
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
      if (kParamsByVector) {
        w[k] = wr[i];
        bi[k] = br[i];
        sc[k] = scr[i];
        sh[k] = shr[i];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + k * kWarp;
    if (!kParamsByVector && i < n) {
      w[k] = wr[i];
      bi[k] = br[i];
      sc[k] = scr[i];
      sh[k] = shr[i];
    }
  }

  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + k * kWarp;
    if (i < n) {
      if (EPILOGUE) {
        V o;
#pragma unroll
        for (int e = 0; e < W; ++e) o.v[e] = narrow<T>(v[k][e]);
        reinterpret_cast<V*>(r_out + row * d)[i] = o;
      }
#pragma unroll
      for (int e = 0; e < W; ++e) sum += v[k][e];
    }
  }
  const float mean = warp_sum(sum) / d;

  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (lane + k * kWarp < n) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float c = v[k][e] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / d + eps);

  V* yr = reinterpret_cast<V*>(y + row * d);
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + k * kWarp;
    if (i < n) {
      V o;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float t = (v[k][e] - mean) * rstd;
        t = t * widen(w[k].v[e]) + widen(bi[k].v[e]);
        o.v[e] = narrow<T>(t * (1.0f + widen(sc[k].v[e])) +
                           widen(sh[k].v[e]));
      }
      yr[i] = o;
    }
  }
}

// the rows kernel for vpl vectors a lane (the wrapper's row_vectors): 1 to
// 4, and 6 or 8 in float32 (a lane's share of a row at most 32 values)
template <typename T, typename P, bool EPILOGUE>
const void* rows_kernel_for(int vpl) {
  switch (vpl) {
    case 1: return (const void*)adaln_rows_kernel<T, P, 1, EPILOGUE>;
    case 2: return (const void*)adaln_rows_kernel<T, P, 2, EPILOGUE>;
    case 3: return (const void*)adaln_rows_kernel<T, P, 3, EPILOGUE>;
    case 4: return (const void*)adaln_rows_kernel<T, P, 4, EPILOGUE>;
  }
  if constexpr (sizeof(T) == 4) {
    if (vpl == 6) return (const void*)adaln_rows_kernel<T, P, 6, EPILOGUE>;
    if (vpl == 8) return (const void*)adaln_rows_kernel<T, P, 8, EPILOGUE>;
  }
  return nullptr;
}

// the block-a-row kernel for (width, vpt): width 16 / sizeof(T) with vpt
// 2 (float32) or 1 (bfloat16), or width 1 with vpt 2, 4 or 8
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

bool operands_aligned(const void* x, const void* residual, const void* gate,
                      long long gate_stride, const void* shift,
                      long long shift_stride, const void* scale,
                      long long scale_stride, const void* weight,
                      const void* bias, const void* y, const void* r_out,
                      int width) {
  const void* ptrs[] = {x, shift, scale, weight, bias, y};
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  if (shift_stride % width || scale_stride % width) return false;
  if (residual != nullptr && (!aligned16(residual) || !aligned16(gate) ||
                              !aligned16(r_out) || gate_stride % width))
    return false;
  return true;
}

// warp_rows 0: adaln_kernel, a block of threads a row (vpt vectors a
// thread); 1: adaln_rows_kernel (16-byte vectors), a warp a row, threads /
// 32 warps a block, vpt vectors a lane
template <typename T, typename P>
int launch(const T* x, const T* residual, const T* gate,
           long long gate_stride, const T* shift, long long shift_stride,
           const T* scale, long long scale_stride, const P* weight,
           const P* bias, T* y, T* r_out, long long rows, int seq, int d,
           int width, int threads, int vpt, int warp_rows, float eps,
           void* stream) {
  const bool epilogue = residual != nullptr;
  if (rows <= 0 || rows > 0x7fffffffLL || seq <= 0 || rows % seq != 0 ||
      d <= 0 || d % width != 0 || threads % kWarp != 0 || threads <= 0)
    return (int)cudaErrorInvalidValue;
  if (width > 1 &&
      !operands_aligned(x, residual, gate, gate_stride, shift, shift_stride,
                        scale, scale_stride, weight, bias, y, r_out, width))
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  long long grid = rows;
  int blocks_per_batch = 0;
  if (warp_rows == 0) {
    fn = epilogue ? kernel_for<T, P, true>(width, vpt)
                  : kernel_for<T, P, false>(width, vpt);
    if (threads > kMaxThreads || (long long)threads * vpt < d / width)
      return (int)cudaErrorInvalidValue;
  } else if (warp_rows == 1) {
    if (width == 16 / (int)sizeof(T))
      fn = epilogue ? rows_kernel_for<T, P, true>(vpt)
                    : rows_kernel_for<T, P, false>(vpt);
    if (threads > kRowThreads || (long long)kWarp * vpt * width < d)
      return (int)cudaErrorInvalidValue;
    blocks_per_batch = (seq + threads / kWarp - 1) / (threads / kWarp);
    grid = rows / seq * blocks_per_batch;
  }
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  void* block_args[] = {&x,      &residual,     &gate,  &gate_stride,
                        &shift,  &shift_stride, &scale, &scale_stride,
                        &weight, &bias,         &y,     &r_out,
                        &seq,    &d,            &eps};
  void* rows_args[] = {&x,      &residual,     &gate,  &gate_stride,
                       &shift,  &shift_stride, &scale, &scale_stride,
                       &weight, &bias,         &y,     &r_out,
                       &seq,    &d,            &blocks_per_batch, &eps};
  cudaError_t err = cudaLaunchKernel(
      fn, dim3((unsigned)grid), dim3(threads),
      warp_rows ? rows_args : block_args, 0,
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
                  int vpt, int warp_rows, float eps, void* stream) {
  if (params_bf16)
    return launch<T, bf16>(x, residual, gate, gate_stride, shift,
                           shift_stride, scale, scale_stride,
                           static_cast<const bf16*>(weight),
                           static_cast<const bf16*>(bias), y, r_out, rows,
                           seq, d, width, threads, vpt, warp_rows, eps,
                           stream);
  return launch<T, float>(x, residual, gate, gate_stride, shift,
                          shift_stride, scale, scale_stride,
                          static_cast<const float*>(weight),
                          static_cast<const float*>(bias), y, r_out, rows,
                          seq, d, width, threads, vpt, warp_rows, eps,
                          stream);
}

}  // namespace

// residual == nullptr selects the plain form (gate and r_out are ignored).
// x, residual, gate, shift, scale, y and r_out float32; weight and bias
// float32, or bfloat16 where params_bf16 is nonzero.  warp_rows 0, the
// block-a-row kernel: width 4 (16-byte vectors: d % 4 == 0, every pointer
// 16-byte aligned and every modulation row stride a multiple of 4) with
// vpt 2, or width 1 with vpt 2, 4 or 8; threads a whole number of warps up
// to 512 with threads * vpt >= d / width (the wrapper's launch_shape).
// warp_rows 1, the rows kernel: width 4, vpt vectors a lane in {1, 2, 3,
// 4, 6, 8} with 128 * vpt >= d, threads 32 to 256 (the wrapper's
// launch_plan).  Returns cudaGetLastError() after the launch.
extern "C" int adaln_norm_f32(const float* x, const float* residual,
                              const float* gate, long long gate_stride,
                              const float* shift, long long shift_stride,
                              const float* scale, long long scale_stride,
                              const void* weight, const void* bias,
                              int params_bf16, float* y, float* r_out,
                              long long rows, int seq, int d, int width,
                              int threads, int vpt, int warp_rows,
                              float eps, void* stream) {
  return launch_params<float>(x, residual, gate, gate_stride, shift,
                              shift_stride, scale, scale_stride, weight,
                              bias, params_bf16, y, r_out, rows, seq, d,
                              width, threads, vpt, warp_rows, eps,
                              stream);
}

// As adaln_norm_f32 with x, residual, gate, shift, scale, y and r_out
// bfloat16: width 8 (16-byte vectors: d % 8 == 0, the pointers 16-byte
// aligned, the modulation row strides multiples of 8) with vpt 1, or width
// 1 with vpt 2, 4 or 8; the rows kernel (warp_rows 1) width 8 with vpt in
// {1, 2, 3, 4} and 256 * vpt >= d.
extern "C" int adaln_norm_bf16(const void* x, const void* residual,
                               const void* gate, long long gate_stride,
                               const void* shift, long long shift_stride,
                               const void* scale, long long scale_stride,
                               const void* weight, const void* bias,
                               int params_bf16, void* y, void* r_out,
                               long long rows, int seq, int d, int width,
                               int threads, int vpt, int warp_rows,
                               float eps, void* stream) {
  return launch_params<bf16>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(residual),
      static_cast<const bf16*>(gate), gate_stride,
      static_cast<const bf16*>(shift), shift_stride,
      static_cast<const bf16*>(scale), scale_stride, weight, bias,
      params_bf16, static_cast<bf16*>(y), static_cast<bf16*>(r_out), rows,
      seq, d, width, threads, vpt, warp_rows, eps, stream);
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

// Blocks of the rows kernel (weights in x's dtype: float32 where f32 is
// nonzero, else bfloat16) for (vpt, threads, epilogue) one SM holds at
// once (-1 on error).
extern "C" int adaln_norm_rows_occupancy(int f32, int vpt, int threads,
                                         int epilogue) {
  const void* fn =
      f32 ? (epilogue ? rows_kernel_for<float, float, true>(vpt)
                      : rows_kernel_for<float, float, false>(vpt))
          : (epilogue ? rows_kernel_for<bf16, bf16, true>(vpt)
                      : rows_kernel_for<bf16, bf16, false>(vpt));
  int blocks = -1;
  if (fn == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, fn, threads, 0) != cudaSuccess)
    return -1;
  return blocks;
}
