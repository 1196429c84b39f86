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
// Design.  One launch, no floating atomics, every float sum in an order
// fixed by indices, so two calls give the same bits:
// - Rows.  A block owns R consecutive rows of one batch row b (the wrapper
//   picks R so that about four blocks land on each SM) and walks them one
//   at a time with the forward's layout: a row across the block, two
//   vectors a thread (16-byte loads where the row allows), the next row's
//   loads (dr's too) in flight meanwhile.  It recomputes mean and rstd
//   from the row (the forward saves nothing), then the two row means of
//   the backward in one block sum, and writes the row's dx (and
//   dresidual).  w, sc and gate are read once a block.  Across its rows
//   each thread keeps three per-column sums in
//   registers: sum dy, sum dy * xh and, in the epilogue form,
//   sum dx' * x.  dsh, dsc, dw and db all follow from the first two:
//   dsc[b] = w * sum_s dy * xh + b * sum_s dy, dw = sum_b (1 + sc[b]) *
//   sum_s dy * xh, db = sum_b (1 + sc[b]) * sum_s dy.
// - Cluster.  The blocks of a batch row are launched in clusters of
//   kCluster (their count padded to a multiple; a block past the last row
//   adds zeros).  Block rank r owns column slice r (whole vectors,
//   [r n / C, (r + 1) n / C) of the row's n vectors).  Each block pushes
//   each of its sums with st.async into the shared memory of the block
//   that owns its column, where it completes a transaction on that
//   block's mbarrier; the owner adds its slice over the cluster's blocks
//   in rank order.  A push needs no release fence, so the rows' stores
//   are not drained on the way (a pull after a cluster barrier, whose
//   release drains them, took twice as long), and no block reads
//   another's memory.
// - Tickets.  The last cluster of batch row b to finish slice r (an
//   integer ticket, acquire-release) adds the clusters' slices in cluster
//   order (with one cluster a batch row, the cluster's sums are the batch
//   row's), writes dsh, dsc and dgate of b and (1 + sc[b]) times the two
//   sums; the last batch row to finish slice r adds those in batch order
//   into dw and db.  The block that draws a counter's last number resets
//   it, so the counters stay zero between calls.
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kCluster = 8;       // blocks a cluster: the portable maximum
constexpr int kMaxBatch = 65535;  // the grid's y limit

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

// Thread block clusters and their mbarriers (PTX for sm_90).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address ``addr`` of this block's shared memory has in block ``rank``
__device__ __forceinline__ unsigned peer(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// an mbarrier whose one phase completes when ``bytes`` have arrived
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void wait_phase0(unsigned bar) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar) : "memory");
}

// v into another block's shared memory at ``addr``, completing
// sizeof(v) bytes of the transaction of its mbarrier ``bar``
__device__ __forceinline__ void push(unsigned addr, const Vec<1>& v,
                                     unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(addr), "r"(__float_as_uint(v.v[0])), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void push(unsigned addr, const Vec<4>& v,
                                     unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "r"(__float_as_uint(v.v[0])),
         "r"(__float_as_uint(v.v[1])), "r"(__float_as_uint(v.v[2])),
         "r"(__float_as_uint(v.v[3])), "r"(bar) : "memory");
}

// Whether this block is the last of ``count`` to draw a ticket from
// ``*counter``.  The barrier orders every thread's global writes before
// thread 0's acquire-release add, which publishes them; the last block
// sees every earlier block's writes (read them with __ldcg, past L1) and
// resets the counter for the next call.  Block-uniform; ``flag`` is
// shared.
__device__ __forceinline__ bool last_to_arrive(unsigned int* counter,
                                               unsigned int count,
                                               unsigned int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> t(*counter);
    const bool last = t.fetch_add(1u, cuda::memory_order_acq_rel) == count - 1;
    if (last) t.store(0u, cuda::memory_order_relaxed);
    *flag = last;
  }
  __syncthreads();
  return *flag != 0;
}

// Row ``row``'s operands into registers: x and dy and, in the epilogue
// form, the residual and dr (where given).
template <int W, int VPT, bool EPILOGUE>
__device__ __forceinline__ void load_row(
    const float* __restrict__ x, const float* __restrict__ residual,
    const float* __restrict__ dy, const float* __restrict__ dr,
    long long row, int d, const bool (&ok)[VPT], Vec<W> (&h)[VPT],
    Vec<W> (&gy)[VPT], Vec<W> (&rs)[VPT], Vec<W> (&dd)[VPT]) {
  using V = Vec<W>;
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  const V* dyr = reinterpret_cast<const V*>(dy + row * d);
  const V* rr = reinterpret_cast<const V*>(residual + row * d);
  const V* drr = reinterpret_cast<const V*>(dr + row * d);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (ok[k]) {
      h[k] = xr[i];
      gy[k] = dyr[i];
      if (EPILOGUE) {
        rs[k] = rr[i];
        if (dr != nullptr) dd[k] = drr[i];
      }
    }
  }
}

// W: floats per vector (1 or 4); VPT: vectors per thread.  Grid (blocks,
// batch) in clusters of (kCluster, 1): block (c, b) owns rows [c * R,
// min(seq, (c + 1) * R)) of batch row b.  KP = 2 sums (sum dy, sum dy *
// xh), 3 in the epilogue form (+ sum dx' * x).  Dynamic shared memory:
// (kCluster, KP, L) vectors, the sums of the cluster's blocks over this
// block's slice of at most L = ceil(d / W / kCluster) vectors.  part:
// (batch, blocks / kCluster, KP, d); mid: (batch, 2, d); tickets: (batch
// + 1, kCluster), zero on entry and on exit.
template <int W, int VPT, bool EPILOGUE>
__global__ void __launch_bounds__(kMaxThreads)
adaln_bwd(const float* __restrict__ x, const float* __restrict__ residual,
          const float* __restrict__ gate, long long gate_stride,
          const float* __restrict__ scale, long long scale_stride,
          const float* __restrict__ weight, const float* __restrict__ bias,
          const float* __restrict__ dy, const float* __restrict__ dr,
          float* __restrict__ dx, float* __restrict__ dres,
          float* __restrict__ dweight, float* __restrict__ dbias,
          float* __restrict__ dshift, float* __restrict__ dscale,
          float* __restrict__ dgate, float* __restrict__ part,
          float* __restrict__ mid, unsigned int* __restrict__ tickets,
          int seq, int d, int rows_per_block, float eps) {
  using V = Vec<W>;
  constexpr int KP = EPILOGUE ? 3 : 2;
  extern __shared__ __align__(16) float recv[];
  __shared__ __align__(8) unsigned long long bar;
  __shared__ float red_sum[kMaxWarps];
  __shared__ float red_sq[kMaxWarps];
  __shared__ float2 red_g[kMaxWarps];
  __shared__ unsigned int flag;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int s0 = chunk * rows_per_block;
  const int s1 = min(seq, s0 + rows_per_block);
  const int n = d / W;
  const V* wr = reinterpret_cast<const V*>(weight);
  const V* scr = reinterpret_cast<const V*>(scale + b * scale_stride);
  const V* gr = reinterpret_cast<const V*>(gate + b * gate_stride);
  // this block's column slice, in vectors, and its mbarrier, set up while
  // the rows run
  const unsigned rank = cluster_rank();
  const int vlo = (int)((long long)rank * n / kCluster);
  const int vhi = (int)((long long)(rank + 1) * n / kCluster);
  const int len = (n + kCluster - 1) / kCluster;
  const unsigned bar_addr = smem_addr(&bar);
  if (threadIdx.x == 0)
    expect_bytes(bar_addr, kCluster * KP * (vhi - vlo) * sizeof(V));
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  V w[VPT], sc[VPT], g[VPT];
  V acc_dy[VPT], acc_dyxh[VPT], acc_dg[VPT];
  bool ok[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    ok[k] = i < n;
    if (ok[k]) {
      w[k] = wr[i];
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

  // a row at a time, the next row's loads in flight while it is reduced
  V h[VPT], gy[VPT], rs[VPT], dd[VPT];
  if (s0 < s1)
    load_row<W, VPT, EPILOGUE>(x, residual, dy, dr, (long long)b * seq + s0,
                               d, ok, h, gy, rs, dd);
  for (int s = s0; s < s1; ++s) {
    const long long row = (long long)b * seq + s;
    V nh[VPT], ngy[VPT], nrs[VPT], ndd[VPT];
    if (s + 1 < s1)
      load_row<W, VPT, EPILOGUE>(x, residual, dy, dr, row + 1, d, ok, nh, ngy,
                                 nrs, ndd);
    V v[VPT];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (ok[k]) {
        v[k] = h[k];
        if (EPILOGUE) {
#pragma unroll
          for (int e = 0; e < W; ++e) v[k].v[e] = rs[k].v[e] + g[k].v[e] * h[k].v[e];
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
#pragma unroll
            for (int e = 0; e < W; ++e) o.v[e] += dd[k].v[e];
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
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      h[k] = nh[k];
      gy[k] = ngy[k];
      rs[k] = nrs[k];
      dd[k] = ndd[k];
    }
  }

  // every block's mbarrier is set up: push each sum to its column's owner
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  const unsigned recv_addr = smem_addr(recv);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (ok[k]) {
      const unsigned q = (unsigned)(((long long)(i + 1) * kCluster - 1) / n);
      const int j = i - (int)((long long)q * n / kCluster);
      const unsigned to = peer(recv_addr, q) +
                          (unsigned)(((rank * KP) * len + j) * sizeof(V));
      const unsigned qbar = peer(bar_addr, q);
      push(to, acc_dy[k], qbar);
      push(to + len * sizeof(V), acc_dyxh[k], qbar);
      if (EPILOGUE) push(to + 2 * len * sizeof(V), acc_dg[k], qbar);
    }
  }

  // this block's slice over the cluster's blocks, in rank order; every
  // push into this block has landed, and the wait before the exit keeps
  // each block until every push out of it has too
  wait_phase0(bar_addr);
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int lo = vlo * W, hi = vhi * W, stride = len * W;
  const int clusters = gridDim.x / kCluster;
  auto finish_row = [&](int c, float a, float cs, float gs) {
    const long long o = (long long)b * d + c;
    dshift[o] = a;
    dscale[o] = weight[c] * cs + bias[c] * a;
    if (EPILOGUE) dgate[o] = gs;
    const float s1 = 1.0f + scale[b * scale_stride + c];
    mid[(2LL * b) * d + c] = s1 * cs;
    mid[(2LL * b + 1) * d + c] = s1 * a;
  };
  float* pc = part + ((long long)b * clusters + chunk / kCluster) * KP * d;
  for (int c = lo + threadIdx.x; c < hi; c += blockDim.x) {
    float t[KP];
#pragma unroll
    for (int p = 0; p < KP; ++p) t[p] = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
#pragma unroll
      for (int p = 0; p < KP; ++p) t[p] += recv[(q * KP + p) * stride + c - lo];
    }
    if (clusters == 1) {
      finish_row(c, t[0], t[1], EPILOGUE ? t[KP - 1] : 0.f);
    } else {
#pragma unroll
      for (int p = 0; p < KP; ++p) pc[p * d + c] = t[p];
    }
  }

  // with more than one cluster a batch row, the last to finish the slice
  // adds the clusters, in cluster order
  bool row_done = clusters == 1;
  if (!row_done &&
      last_to_arrive(tickets + b * kCluster + rank, clusters, &flag)) {
    row_done = true;
    const float* pb = part + (long long)b * clusters * KP * d;
    for (int c = lo + threadIdx.x; c < hi; c += blockDim.x) {
      float t[KP];
#pragma unroll
      for (int p = 0; p < KP; ++p) t[p] = 0.f;
#pragma unroll 8
      for (int q = 0; q < clusters; ++q) {
#pragma unroll
        for (int p = 0; p < KP; ++p)
          t[p] += __ldcg(pb + ((long long)q * KP + p) * d + c);
      }
      finish_row(c, t[0], t[1], EPILOGUE ? t[KP - 1] : 0.f);
    }
  }
  // the last batch row to finish the slice adds them, in batch order
  if (row_done && last_to_arrive(tickets + gridDim.y * kCluster + rank,
                                 gridDim.y, &flag)) {
    for (int c = lo + threadIdx.x; c < hi; c += blockDim.x) {
      float dw = 0.f, db = 0.f;
#pragma unroll 8
      for (int bb = 0; bb < (int)gridDim.y; ++bb) {
        dw += __ldcg(mid + (2LL * bb) * d + c);
        db += __ldcg(mid + (2LL * bb + 1) * d + c);
      }
      dweight[c] = dw;
      dbias[c] = db;
    }
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <bool EPILOGUE>
const void* kernel_for(int width, int vpt) {
  if (width == 4 && vpt == 2) return (const void*)adaln_bwd<4, 2, EPILOGUE>;
  if (width == 1 && vpt == 2) return (const void*)adaln_bwd<1, 2, EPILOGUE>;
  if (width == 1 && vpt == 4) return (const void*)adaln_bwd<1, 4, EPILOGUE>;
  if (width == 1 && vpt == 8) return (const void*)adaln_bwd<1, 8, EPILOGUE>;
  return nullptr;
}

const void* kernel_for(int width, int vpt, bool epilogue) {
  return epilogue ? kernel_for<true>(width, vpt)
                  : kernel_for<false>(width, vpt);
}

// the shared memory a block receives its cluster's sums in
int recv_bytes(int d, int width, int kp) {
  const int len = (d / width + kCluster - 1) / kCluster;
  return kCluster * kp * len * width * (int)sizeof(float);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// The launch of ``fn`` for one block of ``threads`` with ``smem`` bytes of
// dynamic shared memory, in clusters of kCluster along x; near 48 kB
// (d = 4096 in the epilogue form) the kernel is allowed more first.
cudaError_t launch_config(const void* fn, dim3 grid, int threads, int smem,
                          cudaStream_t st, cudaLaunchAttribute* attr,
                          cudaLaunchConfig_t* cfg) {
  if (smem > 48 * 1024 - 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// residual == nullptr selects the plain form (gate, dr, dres and dgate are
// ignored); in the epilogue form dr may be nullptr (r unused).  Widths and
// block shape as adaln_norm_f32; rows_per_block R >= 1; ``blocks`` blocks a
// batch row, a multiple of ``cluster`` (which must be kCluster) that covers
// the seq rows.  dweight, dbias: (d,); dshift, dscale, dgate: (batch, d),
// contiguous.  work holds batch * (blocks / cluster * KP + 2) * d floats
// (KP = 2, or 3 in the epilogue form); tickets (batch + 1) * cluster
// zeroed unsigned ints, left zero, used by one stream at a time.  Returns
// cudaGetLastError() after the launch.
extern "C" int adaln_norm_backward_f32(
    const float* x, const float* residual, const float* gate,
    long long gate_stride, const float* scale, long long scale_stride,
    const float* weight, const float* bias, const float* dy, const float* dr,
    float* dx, float* dres, float* dweight, float* dbias, float* dshift,
    float* dscale, float* dgate, float* work, unsigned int* tickets,
    int batch, int seq, int d, int width, int threads, int vpt,
    int rows_per_block, int cluster, int blocks, float eps, void* stream) {
  const bool epilogue = residual != nullptr;
  const void* fn = kernel_for(width, vpt, epilogue);
  if (fn == nullptr || batch <= 0 || batch > kMaxBatch || seq <= 0 ||
      d <= 0 || d % width != 0 || threads % kWarp != 0 || threads <= 0 ||
      threads > kMaxThreads || (long long)threads * vpt < d / width ||
      rows_per_block <= 0 || cluster != kCluster || blocks <= 0 ||
      blocks % kCluster != 0 || (long long)blocks * rows_per_block < seq)
    return (int)cudaErrorInvalidValue;
  if (width == 4) {
    const void* ptrs[] = {x, scale, weight, bias, dy, dx};
    for (const void* p : ptrs)
      if (!aligned16(p)) return (int)cudaErrorInvalidValue;
    if (scale_stride % 4) return (int)cudaErrorInvalidValue;
    if (epilogue && (!aligned16(residual) || !aligned16(gate) ||
                     !aligned16(dres) || (dr != nullptr && !aligned16(dr)) ||
                     gate_stride % 4))
      return (int)cudaErrorInvalidValue;
  }
  const int kp = epilogue ? 3 : 2;
  const int smem = recv_bytes(d, width, kp);
  float* part = work;
  float* mid = work + (long long)batch * (blocks / kCluster) * kp * d;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = launch_config(
      fn, dim3((unsigned)blocks, (unsigned)batch), threads, smem,
      static_cast<cudaStream_t>(stream), &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&x,      &residual, &gate,    &gate_stride, &scale,
                  &scale_stride, &weight, &bias, &dy,     &dr,
                  &dx,     &dres,     &dweight, &dbias,  &dshift,
                  &dscale, &dgate,    &part,    &mid,    &tickets,
                  &seq,    &d,        &rows_per_block,   &eps};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the kernel for (width, vpt, threads, epilogue) at width d one
// SM holds at once, or (clusters != 0) clusters of kCluster blocks the
// card holds at once (cudaOccupancyMaxActiveClusters); -1 on error.
extern "C" int adaln_norm_backward_occupancy(int width, int vpt, int threads,
                                             int epilogue, int d,
                                             int clusters) {
  const void* fn = kernel_for(width, vpt, epilogue != 0);
  if (fn == nullptr || d <= 0) return -1;
  const int smem = recv_bytes(d, width, epilogue ? 3 : 2);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  if (launch_config(fn, dim3(kCluster), threads, smem, nullptr, &attr,
                    &cfg) != cudaSuccess)
    return -1;
  int n = -1;
  cudaError_t err =
      clusters ? cudaOccupancyMaxActiveClusters(&n, fn, &cfg)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                               smem);
  return err == cudaSuccess ? n : -1;
}
