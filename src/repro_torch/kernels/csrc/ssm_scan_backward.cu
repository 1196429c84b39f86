// Gradient of the Mamba selective scan (ssm_scan.cu) for Hopper (sm_90a),
// float32 or bfloat16: du, ddt, dA, dB, dC and dD from dy.
//
// Replaces no Pallas kernel: the reference has no backward kernel and
// differentiates its plain scan (repro.kernels.ref.ssm_scan) with XLA.
//
// Bound: bytes in float32, operations in bfloat16 (PERF.md rows 4b, 4d).
// u, dt and dy read once, du and ddt written once (20 bytes per (b, t, d)
// in float32, 10 in bfloat16), against one exponential and 16 float
// operations per (b, t, d, n) that the gradient needs; this kernel takes
// 0.75 more exponentials and about 8 more operations an element to
// recompute the forward, and its sums across lanes add about 9 shuffles,
// selects and adds an element.
//
// Design (PERF.md rows 4b, 4d): a reverse-time scan with four lanes a
// channel, four states a lane (n0 = 4 * (lane % 4)), eight channels a warp,
// 32 channels of one b a block (128 threads, four blocks an SM at 128
// registers).  For each chunk of 16 steps, last first:
// - Staging.  The chunk's u, dt and dy (coalesced over d), B_t and C_t and
//   the forward's checkpoint of the block's channels (coalesced over d)
//   come into one stage of a two-stage ring by cp.async (ssm_scan.cuh
//   copy_tiles: 16 bytes a copy where rows align), issued when the chunk
//   after it starts, so they are in flight while that chunk runs.  One
//   pass then widens the chunk once: (dt, dt * u, dy, u) a float4 per step
//   and channel, B_t and C_t float rows.
// - Recompute, in quarters.  Each lane runs its states' first 12 steps
//   again from the checkpoint, keeping the states before steps 4, 8 and
//   12; then for each quarter, last first, it runs the quarter's 4 steps
//   again from its start state, keeping h_{t-1} and the decay exp(dt * a)
//   of each (32 registers), and walks them back carrying g = dL/dh_t.  The
//   decay and the update are the forward's decay() and update()
//   (ssm_scan.cuh), so the states are the forward's bits; the walk reuses
//   the decays it kept: 1.75 exponentials an element (the first port
//   took 2) in 48 registers of history (a full chunk's h_{t-1}, 64,
//   spilled 344 bytes at 128 registers).  The recurrence is never
//   inverted: dividing by exp(dt * A) is unstable.  A step reads one
//   float4 of its channel and float4 broadcasts of B_t and C_t for its
//   four states.
// - du_t and ddt_t are sums over n: the lane's four states by fma in
//   order, then a shuffle between lanes 2m and 2m + 1 that leaves the even
//   lane with the pair's sum of g.B and the odd one with that of the dA
//   term g.h_{t-1}.dA.a2 (a2 = a * log2(e), the forward's factor; the sum
//   is scaled by ln(2) once), one more across the pairs, and one that
//   hands the second lane the g.B sum: the channel's first lane forms du,
//   its second ddt, into shared rows.
// - dB_t and dC_t are sums over all Din channels.  Per step a transposing
//   butterfly over the warp's eight channels (7 shuffles) leaves each lane
//   with one of the 32 (dB or dC, n) sums, stored in a per-warp row.
// - Write-out.  While the next chunk is widened (between the same two
//   barriers), the block writes the chunk's du and ddt, rounded once, 16
//   bytes a thread where rows align, and its partial of dB_t, dC_t: its 4
//   warps' rows added in order, a float4 a thread, one partial per (b,
//   block, t).  A second kernel sums the partials over the blocks (and dA,
//   dD over the batch) in a fixed order, a block an output row, its 8
//   warps each taking every 8th block.  No atomics: the gradients are the
//   same bits on every call.
// The steps past L in the last chunk are skipped (a branch uniform over the
// block); a full chunk's 16 steps have no branch between them.
// Tried on the card and not kept (PERF.md): the full chunk's history in
// registers (spills), the same at 168 registers (3 blocks an SM), two
// halves of 8 steps (2.5 exponentials an element), quarters at 96
// registers (5 blocks an SM, spills), quarters in a loop that is not
// unrolled, each quarter's four butterflies after its arithmetic, and
// dB, dC summed over a warp's channels through shared rows instead of
// shuffles.
//
// bfloat16 (the gradient of the bfloat16 forward, as the reference's
// Mamba block trains it) is the same kernel over the element type of u,
// dt, B, C and dy and of du, ddt, dB and dC; A, D, the checkpoints, the
// workspace, dA and dD stay float32.  Each value is widened once, in the
// chunk's widening pass, so the recomputed states come from the widened
// values the forward used, every sum runs in float32 as in float32, and
// du, ddt, dB and dC are rounded once, at their store, as the reference's
// gradient of its float32 upcast rounds them.  Where Din % 8 == 0 and the
// pointers align, u, dt and dy are copied and du, ddt written 16 bytes (8
// values) at a time; otherwise one value a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssm_scan.cuh"

namespace {

using namespace repro_ssm;

constexpr int kStates = 16;                    // states a channel, padded
constexpr int kS = 4;                          // states a lane
constexpr int kQuad = kStates / kS;            // lanes a channel
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * kWarp;
constexpr int kBwdChans = kBwdThreads / kQuad;  // 32 channels a block
constexpr int kV = 2 * kStates;                // dB then dC columns
constexpr int kCombineWarps = 8;

// One chunk's operands as copied: u, dt, dy (x[0..2], step by channel), B
// and C (bc[0..1], step by state) in T, the checkpoint (state by channel)
// in float32
template <typename T>
struct Stage {
  alignas(16) T x[3][kChunk][kBwdChans];
  alignas(16) T bc[2][kChunk][kStates];
  alignas(16) float H[1][kStates][kBwdChans];
};

// 8 floats rounded once to bfloat16, or 4 floats, stored as 16 bytes
__device__ __forceinline__ void store16(bf16* dst, const float* v) {
  uint4 raw;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

__device__ __forceinline__ void store16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// The block's shared arrays that a chunk's walk reads and writes
struct Walk {
  float4 W[kChunk][kBwdChans];            // dt, dt * u, dy, u
  alignas(16) float B[kChunk][kStates];
  alignas(16) float C[kChunk][kStates];
  float gu[kChunk][kBwdChans];            // du and ddt, before rounding
  float gdt[kChunk][kBwdChans];
  float red[kBwdWarps][kChunk][kV];       // dB, dC per warp and step
};

// This lane's arithmetic of step k of the walk back: g = dL/dh_t carried
// in, h = h_t, hp = h_{t-1} and da the step's decays from the recompute;
// out, the step's (dt, dt * u, dy, u), this channel's terms of dB_t and
// dC_t for the lane's states and the lane's sums over them of g.B and of
// g.h_{t-1}.dA.a2
struct Terms {
  float4 w;
  float cb[kS], cc[kS], gb, gda;
};

__device__ __forceinline__ void step_back(
    const Walk& sm, int k, int dl, int n0, const float (&a2)[kS],
    const float (&hp)[kS], const float (&da)[kS], float (&h)[kS],
    float (&g)[kS], float (&ga)[kS], float& gd, Terms& o) {
  const float4 w = o.w = sm.W[k][dl];
  const float dk = w.x, du = w.y, gk = w.z, uk = w.w;
  const float4 bq = *reinterpret_cast<const float4*>(&sm.B[k][n0]);
  const float4 cq = *reinterpret_cast<const float4*>(&sm.C[k][n0]);
  const float b[kS] = {bq.x, bq.y, bq.z, bq.w};
  const float cv[kS] = {cq.x, cq.y, cq.z, cq.w};
  o.gb = 0.f;
  o.gda = 0.f;
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    g[i] = __fmaf_rn(gk, cv[i], g[i]);          // dL/dh_t
    o.cb[i] = __fmul_rn(g[i], du);
    o.cc[i] = __fmul_rn(gk, h[i]);
    o.gb = __fmaf_rn(g[i], b[i], o.gb);
    const float q = __fmul_rn(__fmul_rn(g[i], hp[i]), da[i]);
    o.gda = __fmaf_rn(q, a2[i], o.gda);
    ga[i] = __fmaf_rn(q, dk, ga[i]);
    g[i] = __fmul_rn(g[i], da[i]);
    h[i] = hp[i];
  }
  gd = __fmaf_rn(gk, uk, gd);
}

// Step k's sums across lanes, to shared memory: g.B and the dA term over
// the channel's 4 lanes (even lanes keep g.B, odd ones the dA term, each
// adding its partner's, then across the two pairs), from which the
// channel's first lane forms du = D dy + dt (g.B) and its second ddt =
// u (g.B) + ln(2) (dA term); and dB_t, dC_t over the warp's 8 channels
// (lane bits 2-4) by a transposing butterfly: bit 4 keeps dB or dC, bit 3
// the state pair, bit 2 the state
__device__ __forceinline__ void reduce_step(Walk& sm, int k, int dl, int n0,
                                            int lane, float dd, float* red,
                                            const Terms& o) {
  constexpr float kLn2 = 0.6931471805599453f;
  const bool odd = lane & 1;
  float s = (odd ? o.gda : o.gb) +
            __shfl_xor_sync(0xffffffffu, odd ? o.gb : o.gda, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const float gb = __shfl_xor_sync(0xffffffffu, s, 1);  // odd lanes: g.B
  if (n0 == 0) sm.gu[k][dl] = __fmaf_rn(o.w.x, s, __fmul_rn(dd, o.w.z));
  if (n0 == kS) sm.gdt[k][dl] = __fmaf_rn(o.w.w, gb, __fmul_rn(kLn2, s));
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
  float r4[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i)
    r4[i] = (hi16 ? o.cc[i] : o.cb[i]) +
            __shfl_xor_sync(0xffffffffu, hi16 ? o.cb[i] : o.cc[i], 16);
  float r2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    r2[i] = (hi8 ? r4[i + 2] : r4[i]) +
            __shfl_xor_sync(0xffffffffu, hi8 ? r4[i] : r4[i + 2], 8);
  red[k * kV] = (hi4 ? r2[1] : r2[0]) +
                __shfl_xor_sync(0xffffffffu, hi4 ? r2[0] : r2[1], 4);
}

// One chunk, walked back in quarters of 4 steps: the states before steps
// 4, 8 and 12 from one pass over the first 12 steps, then for each quarter,
// last first, its 4 steps again from its start state, keeping h_{t-1} and
// the decays (32 registers), and its walk back.  FULL: all 16 steps in
// range (kn == 16).
template <bool FULL>
__device__ __forceinline__ void walk(
    Walk& sm, const float (&H)[kStates][kBwdChans], int kn, int dl, int n0,
    int lane, float dd, float* red, const float (&a2)[kS], float (&g)[kS],
    float (&ga)[kS], float& gd) {
  float hq[3][kS], h[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) h[i] = H[n0 + i][dl];
#pragma unroll
  for (int k = 0; k < 3 * 4; ++k) {
    if (FULL || k < kn) {
      const float4 w = sm.W[k][dl];
      const float4 bq = *reinterpret_cast<const float4*>(&sm.B[k][n0]);
      const float b[kS] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < kS; ++i)
        h[i] = update(decay(w.x, a2[i]), h[i], w.y, b[i]);
    }
    if (k % 4 == 3) {
#pragma unroll
      for (int i = 0; i < kS; ++i) hq[k / 4][i] = h[i];
    }
  }
#pragma unroll
  for (int q = 3; q >= 0; --q) {
    // the quarter's start state, then its steps again
#pragma unroll
    for (int i = 0; i < kS; ++i)
      h[i] = q == 0 ? H[n0 + i][dl]
                    : (q == 1 ? hq[0][i] : (q == 2 ? hq[1][i] : hq[2][i]));
    float hp[4][kS], da[4][kS];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * q + j;
      if (FULL || k < kn) {
        const float4 w = sm.W[k][dl];
        const float4 bq = *reinterpret_cast<const float4*>(&sm.B[k][n0]);
        const float b[kS] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          hp[j][i] = h[i];
          da[j][i] = decay(w.x, a2[i]);
          h[i] = update(da[j][i], h[i], w.y, b[i]);
        }
      }
    }
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      const int k = 4 * q + j;
      if (FULL || k < kn) {
        Terms t;
        step_back(sm, k, dl, n0, a2, hp[j], da[j], h, g, ga, gd, t);
        reduce_step(sm, k, dl, n0, lane, dd, red, t);
      }
    }
  }
}

// T: the type of u, dt, B, C, dy, du, ddt (float or bfloat16); vec_u:
// 16-byte copies of u, dt, dy and stores of du, ddt (Din % kVec<T> == 0,
// aligned); vec_bc: 16-byte copies of B and C; vec_h: of the checkpoints
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 4)
ssm_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dv,
                    const float* __restrict__ states,
                    const T* __restrict__ gy,
                    T* __restrict__ gu, T* __restrict__ gdt,
                    float* __restrict__ part_bc, float* __restrict__ part_a,
                    float* __restrict__ part_d,
                    int L, int Din, int N, bool vec_u, bool vec_bc,
                    bool vec_h) {
  __shared__ Stage<T> ring[2];
  __shared__ Walk sm;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int n0 = kS * (lane % kQuad);                    // this lane's states
  const int dl = warp * (kWarp / kQuad) + lane / kQuad;  // and channel
  const int d0 = blockIdx.x * kBwdChans;
  const int d = d0 + dl;
  const int cols = Din - d0;
  // the (dB or dC, n) sum this lane holds after the butterfly
  float* red = &sm.red[warp][0][(lane >> 4) * kStates + n0 +
                                ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1)];
  const int nc = num_chunks(L);
  const long long row = (long long)b * L;

  auto copy = [&](Stage<T>& st, int c) {
    const long long r0 = row + (long long)c * kChunk;
    const int kn = min(kChunk, L - c * kChunk);
    const T* const x[3] = {u, dt, gy};
    const T* const bc[2] = {Bm, Cm};
    const float* const h[1] = {states};
    copy_tiles<kBwdThreads>(st.x, x, r0, Din, kn, d0, cols, vec_u);
    copy_tiles<kBwdThreads>(st.bc, bc, r0, N, kn, 0, N, vec_bc);
    copy_tiles<kBwdThreads>(st.H, h, ((long long)b * nc + c) * N, Din, N,
                            d0, cols, vec_h);
  };
  copy(ring[(nc - 1) & 1], nc - 1);
  cp_async_commit();

  // a * log2(e), the forward's decay factor; the dA term of ddt is summed
  // over a2 and scaled by ln(2) once, at the store
  float a2[kS], g[kS], ga[kS], gd = 0.f;
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    a2[i] = (d < Din && n0 + i < N)
                ? __fmul_rn(A[(long long)d * N + n0 + i], kLog2e) : 0.f;
    g[i] = 0.f;
    ga[i] = 0.f;
  }
  const float dd = d < Din ? Dv[d] : 0.f;

  // chunk cc's du and ddt, rounded once, and the block's partial of its
  // dB_t, dC_t (its warps summed in order), from the walk's sums
  auto write_out = [&](int cc) {
    const int t1 = cc * kChunk;
    const int kn = min(kChunk, L - t1);
    constexpr int E = kVec<T>;
    if (vec_u) {
      for (int i = tid; i < kChunk * kBwdChans / E; i += kBwdThreads) {
        const int k = i / (kBwdChans / E), j = E * (i % (kBwdChans / E));
        if (k < kn && j < cols) {
          const long long idx = (row + t1 + k) * Din + d0 + j;
          store16(gu + idx, &sm.gu[k][j]);
          store16(gdt + idx, &sm.gdt[k][j]);
        }
      }
    } else {
      for (int e = tid; e < kChunk * kBwdChans; e += kBwdThreads) {
        const int k = e / kBwdChans, j = e % kBwdChans;
        if (k < kn && j < cols) {
          const long long idx = (row + t1 + k) * Din + d0 + j;
          gu[idx] = narrow<T>(sm.gu[k][j]);
          gdt[idx] = narrow<T>(sm.gdt[k][j]);
        }
      }
    }
    for (int e = tid; e < kChunk * kV / 4; e += kBwdThreads) {
      const int k = e / (kV / 4), m = 4 * (e % (kV / 4));
      if (k < kn) {
        float4 s = *reinterpret_cast<const float4*>(&sm.red[0][k][m]);
#pragma unroll
        for (int w = 1; w < kBwdWarps; ++w) {
          const float4 r = *reinterpret_cast<const float4*>(&sm.red[w][k][m]);
          s = make_float4(s.x + r.x, s.y + r.y, s.z + r.z, s.w + r.w);
        }
        *reinterpret_cast<float4*>(
            &part_bc[(((long long)b * gridDim.x + blockIdx.x) * L + t1 + k) *
                         kV + m]) = s;
      }
    }
  };

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int kn = min(kChunk, L - t0);
    // chunk c has landed in every thread's view, and every thread is done
    // with the last chunk's walk, whose sums are complete
    cp_async_wait_all();
    __syncthreads();
    if (c > 0) {
      copy(ring[(c - 1) & 1], c - 1);
      cp_async_commit();
    }
    if (c + 1 < nc) write_out(c + 1);
    const Stage<T>& st = ring[c & 1];
    for (int e = tid; e < kChunk * kBwdChans; e += kBwdThreads) {
      const int k = e / kBwdChans, j = e % kBwdChans;
      const float uk = widen(st.x[0][k][j]), dk = widen(st.x[1][k][j]);
      sm.W[k][j] =
          make_float4(dk, __fmul_rn(dk, uk), widen(st.x[2][k][j]), uk);
    }
    for (int e = tid; e < kChunk * kStates; e += kBwdThreads) {
      const int k = e / kStates, m = e % kStates;
      sm.B[k][m] = widen(st.bc[0][k][m]);
      sm.C[k][m] = widen(st.bc[1][k][m]);
    }
    __syncthreads();
    if (kn == kChunk)
      walk<true>(sm, st.H[0], kn, dl, n0, lane, dd, red, a2, g, ga, gd);
    else
      walk<false>(sm, st.H[0], kn, dl, n0, lane, dd, red, a2, g, ga, gd);
  }
  __syncthreads();
  write_out(0);
  if (d < Din) {
#pragma unroll
    for (int i = 0; i < kS; ++i)
      if (n0 + i < N) part_a[((long long)b * Din + d) * N + n0 + i] = ga[i];
    if (n0 == 0) part_d[(long long)b * Din + d] = gd;
  }
}

// dB, dC: a block an output row (b, t), its 32 columns (dB, then dC)
// across each warp; warp w sums the partials of blocks w, w + 8, ... in
// order and the 8 warps' sums are added in warp order, rounded once to T.
// dA, dD (the blocks after the rows): a thread an element, summed over the
// batch in order.
template <typename T>
__global__ void __launch_bounds__(kCombineWarps * kWarp)
ssm_scan_bwd_combine_kernel(const float* __restrict__ part_bc,
                            const float* __restrict__ part_a,
                            const float* __restrict__ part_d,
                            T* __restrict__ gB, T* __restrict__ gC,
                            float* __restrict__ gA, float* __restrict__ gD,
                            int batch, int L, int Din, int N, int nblk) {
  __shared__ float part[kCombineWarps][kWarp];
  const long long rows = (long long)batch * L;
  const int w = threadIdx.x / kWarp, j = threadIdx.x % kWarp;
  if (blockIdx.x < rows) {
    const long long bt = blockIdx.x, b = bt / L, t = bt % L;
    const float* p = part_bc + (b * nblk * L + t) * kV + j;
    float s = 0.f;
    for (int blk = w; blk < nblk; blk += kCombineWarps)
      s += p[(long long)blk * L * kV];
    part[w][j] = s;
    __syncthreads();
    if (w == 0) {
#pragma unroll
      for (int v = 1; v < kCombineWarps; ++v) s += part[v][j];
      const int n = j % kStates;
      if (n < N) (j < kStates ? gB : gC)[bt * N + n] = narrow<T>(s);
    }
    return;
  }
  const long long k =
      (blockIdx.x - rows) * kCombineWarps * kWarp + threadIdx.x;
  const long long n_a = (long long)Din * N;
  if (k < n_a) {
    float s = 0.f;
    for (int bb = 0; bb < batch; ++bb) s += part_a[(long long)bb * n_a + k];
    gA[k] = s;
  } else if (k < n_a + Din) {
    const long long m = k - n_a;
    float s = 0.f;
    for (int bb = 0; bb < batch; ++bb) s += part_d[(long long)bb * Din + m];
    gD[m] = s;
  }
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
  constexpr int E = kVec<T>;
  const bool vec_u = Din % E == 0 && aligned16(u) && aligned16(dt) &&
                     aligned16(gy) && aligned16(gu) && aligned16(gdt);
  const bool vec_bc = N % E == 0 && aligned16(B) && aligned16(C);
  const bool vec_h = Din % 4 == 0 && aligned16(states);
  ssm_scan_bwd_kernel<T><<<dim3(nblk, batch), kBwdThreads, 0, s>>>(
      u, dt, A, B, C, D, states, gy, gu, gdt, part_bc, part_a, part_d, L,
      Din, N, vec_u, vec_bc, vec_h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = kCombineWarps * kWarp;
  const unsigned blocks = (unsigned)(
      (long long)batch * L +
      ((long long)Din * N + Din + threads - 1) / threads);
  ssm_scan_bwd_combine_kernel<T><<<blocks, threads, 0, s>>>(
      part_bc, part_a, part_d, gB, gC, gA, gD, batch, L, Din, N, nblk);
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

// Blocks of the reverse scan (128 threads each) one SM holds at once (-1
// on error); the bfloat16 kernel's registers and shared memory differ.
extern "C" int ssm_scan_backward_occupancy() {
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ssm_scan_bwd_kernel<float>, kBwdThreads, 0) !=
      cudaSuccess)
    return -1;
  return blocks;
}
