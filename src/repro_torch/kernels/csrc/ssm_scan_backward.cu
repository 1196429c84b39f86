// Gradient of the Mamba selective scan (ssm_scan.cu) for Hopper (sm_90a),
// float32 or bfloat16: du, ddt, dA, dB, dC and dD from dy.
//
// Replaces no Pallas kernel: the reference has no backward kernel and
// differentiates its plain scan (repro.kernels.ref.ssm_scan) with XLA.
//
// Bound: bytes.  u, dt and dy read once, du and ddt written once (20 bytes
// per (b, t, d)), against one exponential and 16 float operations per
// (b, t, d, n) that the gradient needs; this kernel takes a second
// exponential and more operations to recompute the forward.
//
// Design: a reverse-time scan with one thread per (channel d, state n), 16
// lanes of a warp on the 16 states of one channel, two channels a warp,
// 32 channels of one b a block (512 threads).  For each chunk of 16 steps,
// last first, the block stages the chunk's u, dt, dy (coalesced over d),
// B_t and C_t, and the forward's checkpoint of its channels' states
// (coalesced over d) in shared memory.  Each thread recomputes its own
// state's 16-step forward from the checkpoint, keeping every h_{t-1} in 16
// registers (the recurrence is never inverted: dividing by exp(dt * A) is
// unstable), then walks the chunk backwards carrying g = dL/dh_t.
// - du_t and ddt_t are sums over n.  Each thread keeps its per-step terms
//   of the chunk in 32 registers; once per chunk a fixed-order butterfly
//   over the 16 lanes (30 shuffles) leaves lane n with the totals of step
//   n, and the block writes du and ddt through shared memory, coalesced.
// - dB_t and dC_t are sums over all Din channels: per step one shuffle
//   adds a warp's two channels, the block's 16 warps are summed in warp
//   order once per chunk, and one partial per (b, block, t) goes to a
//   workspace; a second kernel sums the partials over the blocks (and dA,
//   dD over the batch) in a fixed order.  No atomics: the gradients are
//   the same bits on every call.
// The history lives in registers, not shared memory (47 kB a block), so an
// SM holds as many blocks as registers allow.
//
// bfloat16 (the gradient of the bfloat16 forward, as the reference's
// Mamba block trains it) is the same kernel over the element type of u,
// dt, B, C and dy and of du, ddt, dB and dC; A, D, the checkpoints, the
// workspace, dA and dD stay float32.  Each value is widened as it is
// staged, so the recomputed states come from the widened values the
// forward used (ssm_scan.cu widens the same bfloat16 values the same
// way), every sum runs in float32 as in float32, and du, ddt, dB and dC
// are rounded once, at their store, as the reference's gradient of its
// float32 upcast rounds them.  Where Din % 8 == 0 and the pointers align,
// u, dt and dy are read and du, ddt written 16 bytes (8 values) at a time
// by 64 of the block's threads; otherwise one value a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssm_scan.cuh"

namespace {

using namespace repro_ssm;
using bf16 = __nv_bfloat16;

constexpr int kLanes = 16;                     // states per channel, padded
constexpr int kChanPerWarp = kWarp / kLanes;   // 2
constexpr int kBwdWarps = 16;
constexpr int kBwdThreads = kBwdWarps * kWarp;
constexpr int kBwdChans = kBwdWarps * kChanPerWarp;   // 32 channels a block
constexpr int kV = 2 * kLanes;                 // dB then dC columns
constexpr int kPad = kBwdChans + 1;
constexpr int kCombineThreads = 256;
static_assert(kChunk == kLanes, "lane n reduces step n of a chunk");
static_assert(kBwdThreads == kChunk * kBwdChans, "one staged value a thread");
constexpr int kVec = 8;                        // bfloat16 values in 16 bytes
constexpr int kVecThreads = kChunk * kBwdChans / kVec;   // 64

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

// 8 bfloat16 values from global memory (16 bytes, aligned), widened into
// dst[0..7]; zeros where !in
__device__ __forceinline__ void load8(float* dst, const bf16* src, bool in) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (in) raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// src[0..7] (stride 1 in shared memory) rounded once and stored as 16
// bytes
__device__ __forceinline__ void store8(bf16* dst, const float* src) {
  uint4 raw;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

// One butterfly step over the 16 lanes of a half warp: lanes with bit S
// clear keep the lower W values, the others the upper W, each added to its
// partner's.
template <int S, int W>
__device__ __forceinline__ void fold(float (&v)[2 * kChunk], int lane) {
  const bool lower = (lane & S) == 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = lower ? v[i + W] : v[i];
    const float keep = lower ? v[i] : v[i + W];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// Sums v[0..31] over the 16 lanes of each half warp in a fixed order; lane
// l (of its half) is left with the totals of v[2l] in v[0] and v[2l + 1]
// in v[1].
__device__ __forceinline__ void half_warp_transpose_sum(
    float (&v)[2 * kChunk]) {
  const int lane = threadIdx.x & (kWarp - 1);
  fold<8, 16>(v, lane);
  fold<4, 8>(v, lane);
  fold<2, 4>(v, lane);
  fold<1, 2>(v, lane);
}

// T: the type of u, dt, B, C, dy, du, ddt (float or bfloat16); vec: 16-byte
// copies of u, dt, dy, du and ddt (bfloat16 only: Din % 8 == 0, aligned)
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
ssm_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dv,
                    const float* __restrict__ states,
                    const T* __restrict__ gy,
                    T* __restrict__ gu, T* __restrict__ gdt,
                    float* __restrict__ part_bc, float* __restrict__ part_a,
                    float* __restrict__ part_d,
                    int L, int Din, int N, bool vec) {
  __shared__ __align__(16) float sU[kChunk][kBwdChans];
  __shared__ __align__(16) float sDt[kChunk][kBwdChans];
  __shared__ __align__(16) float sGy[kChunk][kBwdChans];
  __shared__ float sB[kChunk][kLanes];
  __shared__ float sC[kChunk][kLanes];
  __shared__ float sH[kLanes][kPad];          // the chunk's start states
  __shared__ float sGu[kChunk][kPad];
  __shared__ float sGdt[kChunk][kPad];
  __shared__ float red[kBwdWarps][kChunk][kV];  // dB, dC per warp and step
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int n = lane % kLanes;                          // this thread's state
  const int dl = warp * kChanPerWarp + lane / kLanes;   // and channel
  const int d0 = blockIdx.x * kBwdChans;
  const int d = d0 + dl;
  const bool live = d < Din && n < N;
  // the block's staging and write-out: row sk (a step, or a state) of
  // channel d0 + sc
  const int sk = tid / kBwdChans, sc = tid % kBwdChans;
  const bool s_live = d0 + sc < Din;
  const int nc = num_chunks(L);
  const long long row = (long long)b * L;

  const float a = live ? A[(long long)d * N + n] : 0.f;
  const float dd = d < Din ? Dv[d] : 0.f;
  float g = 0.f, ga = 0.f, gd = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int kn = min(kChunk, L - t0);
    if constexpr (sizeof(T) == 2) {
      if (vec) {
        if (tid < kVecThreads) {
          const int k = tid / (kBwdChans / kVec);
          const int j = kVec * (tid % (kBwdChans / kVec));
          const bool in = k < kn && d0 + j < Din;
          const long long idx = in ? (row + t0 + k) * Din + d0 + j : 0;
          load8(&sU[k][j], u + idx, in);
          load8(&sDt[k][j], dt + idx, in);
          load8(&sGy[k][j], gy + idx, in);
        }
      }
    }
    if (!vec) {
      const bool in = s_live && sk < kn;
      const long long idx = (row + t0 + sk) * Din + d0 + sc;
      sU[sk][sc] = in ? widen(u[idx]) : 0.f;
      sDt[sk][sc] = in ? widen(dt[idx]) : 0.f;
      sGy[sk][sc] = in ? widen(gy[idx]) : 0.f;
    }
    sH[sk][sc] = (s_live && sk < N)
                     ? states[state_index(b, c, nc, sk, N, d0 + sc, Din)]
                     : 0.f;
    if (tid < kChunk * kLanes) {
      const int k = tid / kLanes, m = tid % kLanes;
      const bool in = k < kn && m < N;
      sB[k][m] = in ? widen(Bm[(row + t0 + k) * N + m]) : 0.f;
      sC[k][m] = in ? widen(Cm[(row + t0 + k) * N + m]) : 0.f;
    }
    __syncthreads();

    // the chunk's forward again, keeping h_{t-1} of every step
    float hist[kChunk];
    float h = sH[n][dl];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      hist[k] = h;
      if (k < kn) {                     // the same in the block
        const float dk = sDt[k][dl];
        const float du = dk * sU[k][dl];
        h = exp_(dk * a) * h + du * sB[k][n];
      }
    }
    // h is h_t of the chunk's last step; walk the chunk backwards
    float pv[2 * kChunk];               // per step: g.B and g.h_{t-1}.dA.A
#pragma unroll
    for (int k = kChunk - 1; k >= 0; --k) {
      float gb = 0.f, gda = 0.f, cb = 0.f, cc = 0.f;
      if (k < kn) {
        const float uk = sU[k][dl], dk = sDt[k][dl], gk = sGy[k][dl];
        const float du = dk * uk;
        g += gk * sC[k][n];
        const float hp = hist[k];
        const float da = exp_(dk * a);
        cb = g * du;                    // this channel's dB_t[n]
        cc = gk * h;                    // and dC_t[n]
        gb = g * sB[k][n];
        const float q = g * hp * da;
        gda = q * a;
        ga += q * dk;
        g *= da;
        h = hp;
        gd += gk * uk;
      }
      pv[2 * k] = gb;
      pv[2 * k + 1] = gda;
      // the warp's two channels: lanes < 16 keep dB, the others dC
      const bool low = lane < kLanes;
      red[warp][k][lane] = (low ? cb : cc) +
          __shfl_xor_sync(0xffffffffu, low ? cc : cb, kLanes);
    }
    half_warp_transpose_sum(pv);        // lane n: step n's sums over states
    if (n < kn) {
      sGu[n][dl] = dd * sGy[n][dl] + sDt[n][dl] * pv[0];
      sGdt[n][dl] = sU[n][dl] * pv[0] + pv[1];
    }
    __syncthreads();
    if constexpr (sizeof(T) == 2) {
      if (vec && tid < kVecThreads) {
        const int k = tid / (kBwdChans / kVec);
        const int j = kVec * (tid % (kBwdChans / kVec));
        if (k < kn && d0 + j < Din) {
          const long long idx = (row + t0 + k) * Din + d0 + j;
          float v[kVec];
#pragma unroll
          for (int i = 0; i < kVec; ++i) v[i] = sGu[k][j + i];
          store8(gu + idx, v);
#pragma unroll
          for (int i = 0; i < kVec; ++i) v[i] = sGdt[k][j + i];
          store8(gdt + idx, v);
        }
      }
    }
    if (!vec && s_live && sk < kn) {
      const long long idx = (row + t0 + sk) * Din + d0 + sc;
      gu[idx] = narrow<T>(sGu[sk][sc]);
      gdt[idx] = narrow<T>(sGdt[sk][sc]);
    }
    // this block's partial of dB_t, dC_t: its warps summed in order
    if (sk < kn) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) s += red[w][sk][sc];
      part_bc[(((long long)b * gridDim.x + blockIdx.x) * L + t0 + sk) * kV +
              sc] = s;
    }
    __syncthreads();                    // before the next chunk's staging
  }
  if (live) part_a[((long long)b * Din + d) * N + n] = ga;
  if (d < Din && n == 0) part_d[(long long)b * Din + d] = gd;
}

// dB, dC: sum of the blocks' partials in block order, rounded once to T;
// dA, dD: sum over the batch in order.  One thread per output element.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
ssm_scan_bwd_combine_kernel(const float* __restrict__ part_bc,
                            const float* __restrict__ part_a,
                            const float* __restrict__ part_d,
                            T* __restrict__ gB, T* __restrict__ gC,
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
    (is_b ? gB : gC)[bt * N + (is_b ? j : j - N)] = narrow<T>(s);
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <typename T>
int backward(const T* u, const T* dt, const float* A, const T* B, const T* C,
             const float* D, const float* states, const T* gy, T* gu, T* gdt,
             float* gA, T* gB, T* gC, float* gD, float* workspace, int batch,
             int L, int Din, int N, void* stream) {
  if (bad_shape(batch, L, Din, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (Din + kBwdChans - 1) / kBwdChans;
  float* part_bc = workspace;
  float* part_a = part_bc + (long long)batch * nblk * L * kV;
  float* part_d = part_a + (long long)batch * Din * N;
  const bool vec = sizeof(T) == 2 && Din % kVec == 0 && aligned16(u) &&
                   aligned16(dt) && aligned16(gy) && aligned16(gu) &&
                   aligned16(gdt);
  ssm_scan_bwd_kernel<T><<<dim3(nblk, batch), kBwdThreads, 0, s>>>(
      u, dt, A, B, C, D, states, gy, gu, gdt, part_bc, part_a, part_d, L,
      Din, N, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total =
      (long long)batch * L * 2 * N + (long long)Din * N + Din;
  const unsigned blocks =
      (unsigned)((total + kCombineThreads - 1) / kCombineThreads);
  ssm_scan_bwd_combine_kernel<T><<<blocks, kCombineThreads, 0, s>>>(
      part_bc, part_a, part_d, gB, gC, gA, gD, batch, L, Din, N, kV, nblk);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the backward's workspace: the dB/dC partials (batch, blocks,
// L, 32), then the dA partials (batch, Din, N) and the dD partials
// (batch, Din).  The same for both element types.
extern "C" long long ssm_scan_backward_workspace_floats(int batch, int L,
                                                        int Din, int N) {
  const long long nblk = (Din + kBwdChans - 1) / kBwdChans;
  return (long long)batch * nblk * L * kV + (long long)batch * Din * N +
         (long long)batch * Din;
}

// states: the forward's checkpoints of the same inputs; workspace:
// ssm_scan_backward_workspace_floats() floats.  Two launches: the reverse
// scan, then the fixed-order combine.
extern "C" int ssm_scan_backward_f32(
    const float* u, const float* dt, const float* A, const float* B,
    const float* C, const float* D, const float* states, const float* gy,
    float* gu, float* gdt, float* gA, float* gB, float* gC, float* gD,
    float* workspace, int batch, int L, int Din, int N, void* stream) {
  return backward<float>(u, dt, A, B, C, D, states, gy, gu, gdt, gA, gB, gC,
                         gD, workspace, batch, L, Din, N, stream);
}

// u, dt, B, C, gy and gu, gdt, gB, gC bfloat16; A, D, states, gA, gD and
// the workspace float32; states from ssm_scan_bf16; otherwise as
// ssm_scan_backward_f32.
extern "C" int ssm_scan_backward_bf16(
    const void* u, const void* dt, const float* A, const void* B,
    const void* C, const float* D, const float* states, const void* gy,
    void* gu, void* gdt, float* gA, void* gB, void* gC, float* gD,
    float* workspace, int batch, int L, int Din, int N, void* stream) {
  return backward<bf16>(
      static_cast<const bf16*>(u), static_cast<const bf16*>(dt), A,
      static_cast<const bf16*>(B), static_cast<const bf16*>(C), D, states,
      static_cast<const bf16*>(gy), static_cast<bf16*>(gu),
      static_cast<bf16*>(gdt), gA, static_cast<bf16*>(gB),
      static_cast<bf16*>(gC), gD, workspace, batch, L, Din, N, stream);
}

// Blocks of the reverse scan (512 threads each) one SM holds at once (-1 on
// error); the bfloat16 kernel's registers and shared memory are the same.
extern "C" int ssm_scan_backward_occupancy() {
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ssm_scan_bwd_kernel<float>, kBwdThreads, 0) !=
      cudaSuccess)
    return -1;
  return blocks;
}

