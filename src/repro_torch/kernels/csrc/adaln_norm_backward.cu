// Gradient of the fused DiT adaLN (adaln_norm.cu) for Hopper (sm_90a),
// float32.  With x' = x (plain form) or x' = residual + gate * x (epilogue
// form), xh = (x' - mean) * rstd, z = xh * w + b and y = z * (1 + sc) + sh,
// given dy (and, in the epilogue form, dr, the gradient of the returned r):
//
//   dsh[b] = sum_s dy              dsc[b] = sum_s dy * z
//   dz = dy * (1 + sc)             dw = sum_{b,s} dz * xh,  db = sum_{b,s} dz
//   g = dz * w                     dx' = rstd * (g - mean(g) - xh * mean(g * xh)) + dr
//   epilogue: dresidual = dx',  dgate[b] = sum_s dx' * x,  dx = gate * dx'
//
// Replaces no Pallas kernel: the reference has no backward kernel and
// differentiates its plain adaLN (repro.kernels.ref.adaln_norm) with XLA.
//
// Bound: bytes.  It reads x and dy and writes dx (plain), or reads x,
// residual, dy and dr and writes dx and dresidual (epilogue), against some
// 20 float operations an element; the per-column and per-batch sums are
// d- and (B, d)-sized, a rounding error beside the rows.
//
// Design.  Two kernels, no atomics, so two calls give the same bits:
// - Rows.  A block owns R consecutive rows of one batch row b (the wrapper
//   picks R so that about four blocks land on each SM) and walks them one
//   at a time with the forward's layout: a row across the block, two
//   vectors a thread (16-byte loads where the row allows).  It recomputes
//   mean and rstd from the row it has read (the forward saves nothing),
//   then the two row means of the backward in one block sum, and writes
//   the row's dx (and dresidual).  w, b, sc and gate are read once a
//   block.  Across its rows each thread keeps three per-column sums in
//   registers: sum dy, sum dy * xh and, in the epilogue form,
//   sum dx' * x.  dsh, dsc, dw and db all follow from the first two:
//   dsc[b] = w * sum_s dy * xh + b * sum_s dy, dw = sum_b (1 + sc[b]) *
//   sum_s dy * xh, db = sum_b (1 + sc[b]) * sum_s dy.  The block writes
//   its sums to a workspace, one d-vector each.
// - Combine.  A block owns 32 columns; for each batch row in order its 16
//   warps sum that row's blocks' partials (warp w the blocks w, w + 16,
//   ... in order, then the warps in order), write dsh, dsc and dgate, and
//   warp 0 adds (1 + sc[b]) times the sums into dw and db in batch order.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kCombineWarps = 16;
constexpr int kCombineThreads = kCombineWarps * kWarp;

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

// the block's sum of v, the same bits in every thread: warps in order.
// Each call site has its own ``red``, and three barriers separate two uses
// of one buffer, so no thread overwrites a partial another still reads.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  float t = 0.f;
  const int warps = blockDim.x / kWarp;
  for (int i = 0; i < warps; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  const int warps = blockDim.x / kWarp;
  for (int i = 0; i < warps; ++i) {
    t.x += red[i].x;
    t.y += red[i].y;
  }
  return t;
}

// W: floats per vector (1 or 4); VPT: vectors per thread.  Grid (chunks,
// batch): block (c, b) owns rows [c * R, min(seq, (c + 1) * R)) of batch
// row b.  part: (batch, chunks, KP, d) with KP = 2 (sum dy, sum dy * xh),
// 3 in the epilogue form (+ sum dx' * x).
template <int W, int VPT, bool EPILOGUE>
__global__ void __launch_bounds__(kMaxThreads)
adaln_bwd_rows(const float* __restrict__ x, const float* __restrict__ residual,
               const float* __restrict__ gate, long long gate_stride,
               const float* __restrict__ scale, long long scale_stride,
               const float* __restrict__ weight, const float* __restrict__ bias,
               const float* __restrict__ dy, const float* __restrict__ dr,
               float* __restrict__ dx, float* __restrict__ dres,
               float* __restrict__ part, int seq, int d, int rows_per_block,
               float eps) {
  using V = Vec<W>;
  constexpr int KP = EPILOGUE ? 3 : 2;
  __shared__ float red_sum[kMaxWarps];
  __shared__ float red_sq[kMaxWarps];
  __shared__ float2 red_g[kMaxWarps];
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int s0 = chunk * rows_per_block;
  const int s1 = min(seq, s0 + rows_per_block);
  const int n = d / W;
  const V* wr = reinterpret_cast<const V*>(weight);
  const V* br = reinterpret_cast<const V*>(bias);
  const V* scr = reinterpret_cast<const V*>(scale + b * scale_stride);
  const V* gr = reinterpret_cast<const V*>(gate + b * gate_stride);

  V w[VPT], bi[VPT], sc[VPT], g[VPT];
  V acc_dy[VPT], acc_dyxh[VPT], acc_dg[VPT];
  bool ok[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    ok[k] = i < n;
    if (ok[k]) {
      w[k] = wr[i];
      bi[k] = br[i];
      sc[k] = scr[i];
      if (EPILOGUE) g[k] = gr[i];
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      acc_dy[k].v[e] = 0.f;
      acc_dyxh[k].v[e] = 0.f;
      acc_dg[k].v[e] = 0.f;
    }
  }

  for (int s = s0; s < s1; ++s) {
    const long long row = (long long)b * seq + s;
    const V* xr = reinterpret_cast<const V*>(x + row * d);
    const V* rr = reinterpret_cast<const V*>(residual + row * d);
    const V* dyr = reinterpret_cast<const V*>(dy + row * d);
    V h[VPT], v[VPT], gy[VPT];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (ok[k]) {
        h[k] = xr[i];
        gy[k] = dyr[i];
        v[k] = h[k];
        if (EPILOGUE) {
          const V res = rr[i];
#pragma unroll
          for (int e = 0; e < W; ++e) v[k].v[e] = res.v[e] + g[k].v[e] * h[k].v[e];
        }
#pragma unroll
        for (int e = 0; e < W; ++e) sum += v[k].v[e];
      }
    }
    // the forward's statistics, in its order
    const float mean = block_sum(sum, red_sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (ok[k]) {
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float c = v[k].v[e] - mean;
          sq += c * c;
        }
      }
    }
    const float rstd = 1.0f / sqrtf(block_sum(sq, red_sq) / d + eps);

    // v becomes xh, gy stays dy; t1 and t2 sum g and g * xh
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (ok[k]) {
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float xh = (v[k].v[e] - mean) * rstd;
          const float gg = gy[k].v[e] * (1.0f + sc[k].v[e]) * w[k].v[e];
          v[k].v[e] = xh;
          t1 += gg;
          t2 += gg * xh;
          acc_dy[k].v[e] += gy[k].v[e];
          acc_dyxh[k].v[e] += gy[k].v[e] * xh;
        }
      }
    }
    const float2 m = block_sum2(t1, t2, red_g);
    const float m1 = m.x / d, m2 = m.y / d;

    V* dxr = reinterpret_cast<V*>(dx + row * d);
    V* dresr = reinterpret_cast<V*>(dres + row * d);
    const V* drr = reinterpret_cast<const V*>(dr + row * d);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (ok[k]) {
        V o;
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float gg = gy[k].v[e] * (1.0f + sc[k].v[e]) * w[k].v[e];
          o.v[e] = rstd * (gg - m1 - v[k].v[e] * m2);
        }
        if (EPILOGUE) {
          if (dr != nullptr) {
            const V dd = drr[i];
#pragma unroll
            for (int e = 0; e < W; ++e) o.v[e] += dd.v[e];
          }
          dresr[i] = o;
          V ox;
#pragma unroll
          for (int e = 0; e < W; ++e) {
            acc_dg[k].v[e] += o.v[e] * h[k].v[e];
            ox.v[e] = g[k].v[e] * o.v[e];
          }
          dxr[i] = ox;
        } else {
          dxr[i] = o;
        }
      }
    }
  }

  float* pb = part + ((long long)b * gridDim.x + chunk) * KP * d;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (ok[k]) {
      reinterpret_cast<V*>(pb)[i] = acc_dy[k];
      reinterpret_cast<V*>(pb + d)[i] = acc_dyxh[k];
      if (EPILOGUE) reinterpret_cast<V*>(pb + 2 * d)[i] = acc_dg[k];
    }
  }
}

// Grid ceil(d / 32): block j owns columns [32 j, 32 j + 32).  For each
// batch row b in order, warp w sums the partials of chunks w, w + 16, ...
// in order, lane l column 32 j + l; the warps' sums are added in warp
// order.
__global__ void __launch_bounds__(kCombineThreads)
adaln_bwd_combine(const float* __restrict__ part,
                  const float* __restrict__ scale, long long scale_stride,
                  const float* __restrict__ weight,
                  const float* __restrict__ bias, float* __restrict__ dweight,
                  float* __restrict__ dbias, float* __restrict__ dshift,
                  float* __restrict__ dscale, float* __restrict__ dgate,
                  int batch, int chunks, int kp, int d) {
  __shared__ float red[3][kCombineWarps][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int col = blockIdx.x * kWarp + lane;
  const bool ok = col < d;
  float dw = 0.f, db = 0.f;
  for (int b = 0; b < batch; ++b) {
    float a = 0.f, c = 0.f, gs = 0.f;
    if (ok) {
      const float* p = part + (long long)b * chunks * kp * d + col;
#pragma unroll 4
      for (int ch = warp; ch < chunks; ch += kCombineWarps) {
        const float* q = p + (long long)ch * kp * d;
        a += q[0];
        c += q[d];
        if (kp == 3) gs += q[2 * d];
      }
    }
    red[0][warp][lane] = a;
    red[1][warp][lane] = c;
    red[2][warp][lane] = gs;
    __syncthreads();
    if (warp == 0 && ok) {
      a = 0.f;
      c = 0.f;
      gs = 0.f;
      for (int i = 0; i < kCombineWarps; ++i) {
        a += red[0][i][lane];
        c += red[1][i][lane];
        gs += red[2][i][lane];
      }
      const long long o = (long long)b * d + col;
      dshift[o] = a;
      dscale[o] = weight[col] * c + bias[col] * a;
      if (kp == 3) dgate[o] = gs;
      const float s1 = 1.0f + scale[b * scale_stride + col];
      dw += s1 * c;
      db += s1 * a;
    }
    __syncthreads();
  }
  if (warp == 0 && ok) {
    dweight[col] = dw;
    dbias[col] = db;
  }
}

template <bool EPILOGUE>
const void* rows_kernel_for(int width, int vpt) {
  if (width == 4 && vpt == 2) return (const void*)adaln_bwd_rows<4, 2, EPILOGUE>;
  if (width == 1 && vpt == 2) return (const void*)adaln_bwd_rows<1, 2, EPILOGUE>;
  if (width == 1 && vpt == 4) return (const void*)adaln_bwd_rows<1, 4, EPILOGUE>;
  if (width == 1 && vpt == 8) return (const void*)adaln_bwd_rows<1, 8, EPILOGUE>;
  return nullptr;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace

// residual == nullptr selects the plain form (gate, dr, dres and dgate are
// ignored); in the epilogue form dr may be nullptr (r unused).  Widths and
// launch shape as adaln_norm_f32; rows_per_block R >= 1.  dweight, dbias:
// (d,); dshift, dscale, dgate: (batch, d), contiguous.  part holds batch *
// ceil(seq / R) * (2, or 3 in the epilogue form) * d floats.  Returns
// cudaGetLastError() after the two launches.
extern "C" int adaln_norm_backward_f32(
    const float* x, const float* residual, const float* gate,
    long long gate_stride, const float* scale, long long scale_stride,
    const float* weight, const float* bias, const float* dy, const float* dr,
    float* dx, float* dres, float* dweight, float* dbias, float* dshift,
    float* dscale, float* dgate, float* part, int batch, int seq, int d,
    int width, int threads, int vpt, int rows_per_block, float eps,
    void* stream) {
  const bool epilogue = residual != nullptr;
  const void* fn = epilogue ? rows_kernel_for<true>(width, vpt)
                            : rows_kernel_for<false>(width, vpt);
  if (fn == nullptr || batch <= 0 || batch > 65535 || seq <= 0 || d <= 0 ||
      d % width != 0 || threads % kWarp != 0 || threads <= 0 ||
      threads > kMaxThreads || (long long)threads * vpt < d / width ||
      rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  if (width == 4) {
    const void* ptrs[] = {x, scale, weight, bias, dy, dx, part};
    for (const void* p : ptrs)
      if (!aligned16(p)) return (int)cudaErrorInvalidValue;
    if (scale_stride % 4) return (int)cudaErrorInvalidValue;
    if (epilogue && (!aligned16(residual) || !aligned16(gate) ||
                     !aligned16(dres) || (dr != nullptr && !aligned16(dr)) ||
                     gate_stride % 4))
      return (int)cudaErrorInvalidValue;
  }
  int chunks = (seq + rows_per_block - 1) / rows_per_block;
  int kp = epilogue ? 3 : 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&x,     &residual, &gate, &gate_stride, &scale,
                  &scale_stride, &weight, &bias, &dy,   &dr,
                  &dx,    &dres,     &part, &seq,  &d,
                  &rows_per_block, &eps};
  cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)chunks, (unsigned)batch),
                                     dim3(threads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  adaln_bwd_combine<<<dim3((unsigned)((d + kWarp - 1) / kWarp)),
                      dim3(kCombineThreads), 0, st>>>(
      part, scale, scale_stride, weight, bias, dweight, dbias, dshift, dscale,
      dgate, batch, chunks, kp, d);
  return (int)cudaGetLastError();
}

// Blocks of the row kernel for (width, vpt, threads, epilogue) one SM
// holds at once (-1 on error).
extern "C" int adaln_norm_backward_occupancy(int width, int vpt, int threads,
                                             int epilogue) {
  const void* fn = epilogue ? rows_kernel_for<true>(width, vpt)
                            : rows_kernel_for<false>(width, vpt);
  int blocks = -1;
  if (fn == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, fn, threads, 0) != cudaSuccess)
    return -1;
  return blocks;
}
