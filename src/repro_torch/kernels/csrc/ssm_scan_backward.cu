// Gradient of the Mamba selective scan (ssm_scan.cu) for Hopper (sm_90a),
// float32: du, ddt, dA, dB, dC and dD from dy.
//
// Replaces no Pallas kernel: the reference has no backward kernel and
// differentiates its plain scan (repro.kernels.ref.ssm_scan) with XLA.
//
// Bound: bytes.  u, dt and dy read once, du and ddt written once (20 bytes
// per (b, t, d)), against one exponential and 16 float operations per
// (b, t, d, n) that the gradient needs; this kernel takes a second
// exponential and more operations to recompute the forward.
//
// Design: a reverse-time scan per (b, d) channel, one thread each, 64
// channels of one b per block.  For each chunk, last first, the thread
// reloads the chunk's start state from the forward's checkpoints and
// recomputes the chunk's forward, keeping every h_{t-1} in shared memory
// (the recurrence is never inverted: dividing by exp(dt * A) is unstable),
// then walks the chunk backwards carrying g = dL/dh_t in registers.  du
// and ddt are per channel and written directly; dA and dD are summed over
// t in registers.  dB_t and dC_t are sums over all Din channels: each warp
// reduces its 2N values per step with a fixed-order butterfly, the block's
// warps are summed in order, and one partial per (b, block, t) goes to a
// workspace; a second kernel sums the partials over the blocks (and dA, dD
// over the batch) in a fixed order, so the gradients are deterministic.
// The history takes kChunk * 16 floats a thread (64 kB a block at N = 16),
// which bounds the blocks an SM holds to three.
#include <cuda_runtime.h>

#include "ssm_scan.cuh"

namespace {

using namespace repro_ssm;

constexpr int kBwdThreads = 64;   // channels per block
constexpr int kBwdWarps = kBwdThreads / kWarp;
constexpr int kCombineThreads = 256;

// Sums v[0..V-1] over the 32 lanes of a warp in a fixed order.  Lanes
// differing in bits >= log2(V) are folded first; then each exchange halves
// the values a lane keeps (lane bit s set keeps the upper half).  Lane l
// returns the total of value l % V.  V is a power of two, V <= 32.
template <int V>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[V]) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int s = kWarp / 2; s >= V; s >>= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], s);
  }
#pragma unroll
  for (int s = V / 2; s >= 1; s >>= 1) {
    const bool lower = (lane & s) == 0;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = lower ? v[i + s] : v[i];
      const float keep = lower ? v[i] : v[i + s];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  return v[0];
}

template <int NT>
constexpr int bwd_smem_floats() {
  // hist [kChunk][NT][kBwdThreads], sB and sC [kChunk][NT],
  // red [kChunk][kBwdWarps][2 NT]
  return kChunk * NT * kBwdThreads + 2 * kChunk * NT +
         kChunk * kBwdWarps * 2 * NT;
}

template <int NT>
__global__ void __launch_bounds__(kBwdThreads)
ssm_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ Dv,
                    const float* __restrict__ states,
                    const float* __restrict__ gy,
                    float* __restrict__ gu, float* __restrict__ gdt,
                    float* __restrict__ part_bc, float* __restrict__ part_a,
                    float* __restrict__ part_d,
                    int L, int Din, int N) {
  constexpr int V = 2 * NT;
  extern __shared__ float smem[];
  float* hist = smem;                                   // h_{t-1} per step
  float* sB = hist + kChunk * NT * kBwdThreads;
  float* sC = sB + kChunk * NT;
  float* red = sC + kChunk * NT;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int d = blockIdx.x * kBwdThreads + tid;
  const bool live = d < Din;
  const int nc = num_chunks(L);
  const long long row = (long long)b * L;
  const long long chan = (long long)b * Din + d;

  float a[NT], g[NT], ga[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    a[n] = (live && n < N) ? A[(long long)d * N + n] : 0.f;
    g[n] = 0.f;
    ga[n] = 0.f;
  }
  const float dd = live ? Dv[d] : 0.f;
  float gd = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int kn = min(kChunk, L - t0);
    for (int i = tid; i < kChunk * NT; i += kBwdThreads) {
      const int k = i / NT, n = i % NT;
      const bool in = k < kn && n < N;
      sB[i] = in ? Bm[(row + t0 + k) * N + n] : 0.f;
      sC[i] = in ? Cm[(row + t0 + k) * N + n] : 0.f;
    }
    float uk[kChunk], dk[kChunk], gk[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const bool in = live && k < kn;
      const long long idx = (row + t0 + k) * Din + d;
      uk[k] = in ? u[idx] : 0.f;
      dk[k] = in ? dt[idx] : 0.f;
      gk[k] = in ? gy[idx] : 0.f;
    }
    float h[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      h[n] = (live && n < N) ? states[state_index(b, c, nc, n, N, d, Din)]
                             : 0.f;
    __syncthreads();

    // the chunk's forward again, keeping h_{t-1} of every step
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < kn) {
        const float du = dk[k] * uk[k];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          hist[(k * NT + n) * kBwdThreads + tid] = h[n];
          h[n] = exp_(dk[k] * a[n]) * h[n] + du * sB[k * NT + n];
        }
      }
    }
    // h is h_t of the chunk's last step; walk the chunk backwards
#pragma unroll
    for (int k = kChunk - 1; k >= 0; --k) {
      if (k < kn) {
        const float du = dk[k] * uk[k];
        float contrib[V];                 // dB_t (n < NT), dC_t (n >= NT)
        float s_gb = 0.f, s_gda = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          g[n] += gk[k] * sC[k * NT + n];
          const float hp = hist[(k * NT + n) * kBwdThreads + tid];
          const float da = exp_(dk[k] * a[n]);
          contrib[n] = g[n] * du;
          contrib[NT + n] = gk[k] * h[n];
          s_gb += g[n] * sB[k * NT + n];
          const float q = g[n] * hp * da;
          s_gda += q * a[n];
          ga[n] += q * dk[k];
          g[n] *= da;
          h[n] = hp;
        }
        if (live) {
          const long long idx = (row + t0 + k) * Din + d;
          gu[idx] = dd * gk[k] + dk[k] * s_gb;
          gdt[idx] = uk[k] * s_gb + s_gda;
        }
        gd += gk[k] * uk[k];
        const float tot = warp_transpose_sum<V>(contrib);
        if (lane < V) red[(k * kBwdWarps + warp) * V + lane] = tot;
      }
    }
    __syncthreads();
    // this block's partial of dB_t, dC_t: its warps summed in order
    for (int i = tid; i < kn * V; i += kBwdThreads) {
      const int k = i / V, j = i % V;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w)
        s += red[(k * kBwdWarps + w) * V + j];
      part_bc[(((long long)b * gridDim.x + blockIdx.x) * L + t0 + k) * V + j] =
          s;
    }
    __syncthreads();                    // before the next chunk's staging
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < N) part_a[chan * N + n] = ga[n];
    }
    part_d[chan] = gd;
  }
}

// dB, dC: sum of the blocks' partials in block order; dA, dD: sum over
// the batch in order.  One thread per output element.
__global__ void __launch_bounds__(kCombineThreads)
ssm_scan_bwd_combine_kernel(const float* __restrict__ part_bc,
                            const float* __restrict__ part_a,
                            const float* __restrict__ part_d,
                            float* __restrict__ gB, float* __restrict__ gC,
                            float* __restrict__ gA, float* __restrict__ gD,
                            int batch, int L, int Din, int N, int V,
                            int nblk) {
  const long long i = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  const long long n_bc = (long long)batch * L * 2 * N;
  const long long n_a = (long long)Din * N;
  if (i < n_bc) {
    const int j = (int)(i % (2 * N));
    const long long bt = i / (2 * N);                 // b * L + t
    const long long b = bt / L, t = bt % L;
    const bool is_b = j < N;
    const int col = is_b ? j : V / 2 + (j - N);
    float s = 0.f;
    for (int blk = 0; blk < nblk; ++blk)
      s += part_bc[((b * nblk + blk) * L + t) * V + col];
    (is_b ? gB : gC)[bt * N + (is_b ? j : j - N)] = s;
  } else if (i < n_bc + n_a) {
    const long long k = i - n_bc;
    float s = 0.f;
    for (int bb = 0; bb < batch; ++bb) s += part_a[(long long)bb * n_a + k];
    gA[k] = s;
  } else if (i < n_bc + n_a + Din) {
    const long long k = i - n_bc - n_a;
    float s = 0.f;
    for (int bb = 0; bb < batch; ++bb) s += part_d[(long long)bb * Din + k];
    gD[k] = s;
  }
}

template <int NT>
cudaError_t launch_bwd(dim3 grid, cudaStream_t s, const float* u,
                       const float* dt, const float* A, const float* B,
                       const float* C, const float* D, const float* states,
                       const float* gy, float* gu, float* gdt,
                       float* part_bc, float* part_a, float* part_d, int L,
                       int Din, int N) {
  const int smem = bwd_smem_floats<NT>() * (int)sizeof(float);
  // above 48 kB, dynamic shared memory must be asked for (per device)
  cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ssm_scan_bwd_kernel<NT><<<grid, kBwdThreads, smem, s>>>(
      u, dt, A, B, C, D, states, gy, gu, gdt, part_bc, part_a, part_d, L,
      Din, N);
  return cudaGetLastError();
}

}  // namespace

// Floats of the backward's workspace: the dB/dC partials (batch, blocks,
// L, 2 NT), then the dA partials (batch, Din, N) and the dD partials
// (batch, Din).
extern "C" long long ssm_scan_backward_workspace_floats(int batch, int L,
                                                        int Din, int N) {
  const long long nblk = (Din + kBwdThreads - 1) / kBwdThreads;
  return (long long)batch * nblk * L * 2 * state_tile(N) +
         (long long)batch * Din * N + (long long)batch * Din;
}

// states: the forward's checkpoints of the same inputs; workspace:
// ssm_scan_backward_workspace_floats() floats.  Two launches: the reverse
// scan, then the fixed-order combine.
extern "C" int ssm_scan_backward_f32(
    const float* u, const float* dt, const float* A, const float* B,
    const float* C, const float* D, const float* states, const float* gy,
    float* gu, float* gdt, float* gA, float* gB, float* gC, float* gD,
    float* workspace, int batch, int L, int Din, int N, void* stream) {
  if (bad_shape(batch, L, Din, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = state_tile(N);
  const int nblk = (Din + kBwdThreads - 1) / kBwdThreads;
  float* part_bc = workspace;
  float* part_a = part_bc + (long long)batch * nblk * L * 2 * nt;
  float* part_d = part_a + (long long)batch * Din * N;
  const dim3 grid(nblk, batch);
  cudaError_t err;
#define REPRO_SSM_BWD(NT)                                                    \
  err = launch_bwd<NT>(grid, s, u, dt, A, B, C, D, states, gy, gu, gdt,      \
                       part_bc, part_a, part_d, L, Din, N)
  if (nt == 4) REPRO_SSM_BWD(4);
  else if (nt == 8) REPRO_SSM_BWD(8);
  else REPRO_SSM_BWD(16);
#undef REPRO_SSM_BWD
  if (err != cudaSuccess) return (int)err;
  const long long total =
      (long long)batch * L * 2 * N + (long long)Din * N + Din;
  const unsigned blocks =
      (unsigned)((total + kCombineThreads - 1) / kCombineThreads);
  ssm_scan_bwd_combine_kernel<<<blocks, kCombineThreads, 0, s>>>(
      part_bc, part_a, part_d, gB, gC, gA, gD, batch, L, Din, N, 2 * nt,
      nblk);
  return (int)cudaGetLastError();
}
