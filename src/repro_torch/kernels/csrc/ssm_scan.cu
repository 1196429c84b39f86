// Mamba selective scan for Hopper (sm_90a), float32, forward:
//
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * u_t * B_t      (per channel, N states)
//   y_t = C_t . h_t + D * u_t
//
// u, dt, y: (batch, L, Din) row-major; A: (Din, N); B, C: (batch, L, N);
// D: (Din,); h_final: (batch, Din, N).  N <= 16.  The state starts at 0.
//
// Replaces: src/repro/kernels/ssm_scan.py :: ssm_scan_pallas (_ssm_kernel).
//
// Bound: the exponentials.  u and dt read once, y written once (12 bytes
// per (b, t, d)), against one exponential and 6 float operations per
// (b, t, d, n).  At N = 16 the exponentials, on the special-function units
// at a sixteenth of the float32 rate, take a little longer than the bytes
// (0.032 against 0.030 ms at B=8, L=128, Din=8192 on an H100 SXM); the
// other operations take a third of that.  The units take 8 clocks of an SM
// quarter for one warp's exponentials, so the rest of a state's step (4
// float operations) and each step's loads must fit beside them, and the
// chunk copies (and, when training, the checkpoint stores: a third more
// bytes) must overlap them.
//
// Design.  The TPU kernel tiles Din into VPU lanes and streams time in
// chunks with the (block, N) state in VMEM.  Here a thread owns one (b, d)
// channel and keeps its N states in registers for the whole sequence, so
// the state never leaves the SM; a block covers 128 consecutive channels of
// one b.  The first port had that layout too, but its __expf
// compiled to a multiply by log2(e), a compare and two subnormal-scaling
// multiplies around each MUFU.EX2 (in its SASS about 9.6 float, special-
// function and shared-memory instructions an exponential, against the
// units' 8 clocks a warp's exponential: issue bound), it loaded each
// chunk's u and dt only after the last chunk ended (a memory round trip
// every 16 steps, behind two barriers), and it branched around every step
// and its y store.  Here (about 6.1 such instructions an exponential):
// - A two-stage ring in shared memory: while chunk c runs, chunk c + 1's
//   u, dt, B and C are in flight (cp.async, coalesced over d, 16 bytes a
//   copy where every row is 16-byte aligned, 4 bytes otherwise, values out
//   of range zero-filled), and one barrier a chunk both publishes a
//   chunk's copies and frees the stage the next copies overwrite.
// - B_t and C_t are read as float4 broadcasts: 8 shared loads a step for
//   16 states.
// - A full chunk's 16 steps have no branch between them (the y pointer
//   moves a row a step), so the compiler interleaves one step's
//   exponentials with the last one's sums.
// - a * log2(e) is formed once per state, so each exponential is one
//   multiply by dt and one ex2.approx.ftz (flushing results under 2^-126
//   to 0, where the plain version's denormals are smaller than any
//   tolerance).
// Tried on the card and not kept (PERF.md): two lanes a channel, eight
// states each, with y joined by a shuffle (twice the warps an SM, more
// instructions an exponential: slower), y staged in shared memory and
// stored a chunk late, and a third ring stage.
// Every sum has a fixed order (the states in n order), so two calls give
// the same bits.
//
// With a states buffer it also writes h at the start of every chunk,
// (batch, nchunks, N, Din): the checkpoints ssm_scan_backward.cu
// recomputes from.  h_final is written on request (the prefill's state).
#include <cuda_runtime.h>

#include "ssm_scan.cuh"

namespace {

using namespace repro_ssm;

constexpr int kFwdThreads = 128;                  // channels a block
constexpr float kLog2e = 1.4426950408889634f;

// 4 bytes from global to shared, asynchronously; zero-filled where !in
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0));
}

// 16 bytes from global to shared, asynchronously; zero-filled where !in
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
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

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One chunk's operands: u and dt of the block's channels, B and C padded
// to NT states (zeros past N)
template <int NT>
struct Stage {
  float u[kChunk][kFwdThreads];
  float dt[kChunk][kFwdThreads];
  float4 B[kChunk][NT / 4];
  float4 C[kChunk][NT / 4];
};

// A chunk's u and dt (and B and C) move 16 bytes a copy where every row
// starts on a 16-byte boundary (vec_u: Din % 4 == 0 and u, dt aligned;
// vec_bc: N % 4 == 0 and B, C aligned), 4 bytes otherwise.
template <int NT>
__device__ __forceinline__ void copy_chunk(
    Stage<NT>& st, const float* __restrict__ u, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    long long row0, int kn, int d0, int Din, int N, bool vec_u,
    bool vec_bc) {
  if (vec_u) {
    constexpr int Q = kFwdThreads / 4;
    for (int i = threadIdx.x; i < kChunk * Q; i += kFwdThreads) {
      const int k = i / Q, j = 4 * (i % Q);
      const bool in = k < kn && d0 + j < Din;
      const long long off = in ? (row0 + k) * Din + d0 + j : 0;
      cp_async16(&st.u[k][j], u + off, in);
      cp_async16(&st.dt[k][j], dt + off, in);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * kFwdThreads; i += kFwdThreads) {
      const int k = i / kFwdThreads, j = i % kFwdThreads;
      const bool in = k < kn && d0 + j < Din;
      const long long off = in ? (row0 + k) * Din + d0 + j : 0;
      cp_async4(&st.u[k][j], u + off, in);
      cp_async4(&st.dt[k][j], dt + off, in);
    }
  }
  if (vec_bc) {
    constexpr int Q = NT / 4;
    for (int i = threadIdx.x; i < kChunk * Q; i += kFwdThreads) {
      const int k = i / Q, q = i % Q;
      const bool in = k < kn && 4 * q < N;
      const long long off = in ? (row0 + k) * N + 4 * q : 0;
      cp_async16(&st.B[k][q], Bm + off, in);
      cp_async16(&st.C[k][q], Cm + off, in);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * NT; i += kFwdThreads) {
      const int k = i / NT, n = i % NT;
      const bool in = k < kn && n < N;
      const long long off = in ? (row0 + k) * N + n : 0;
      cp_async4(reinterpret_cast<float*>(st.B[k]) + n, Bm + off, in);
      cp_async4(reinterpret_cast<float*>(st.C[k]) + n, Cm + off, in);
    }
  }
}

// One step k of the recurrence for channel j's NT states; y_t to *yk.
template <int NT>
__device__ __forceinline__ void step(const Stage<NT>& st, int k, int j,
                                     const float (&a2)[NT], float (&h)[NT],
                                     float dd, bool live, float* yk) {
  const float uk = st.u[k][j];
  const float dk = st.dt[k][j];
  const float du = dk * uk;
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < NT / 4; ++q) {
    const float4 bq = st.B[k][q];
    const float4 cq = st.C[k][q];
    const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
    const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * q + e;
      h[n] = ex2(dk * a2[n]) * h[n] + du * bv[e];
      acc += h[n] * cv[e];
    }
  }
  if (live) *yk = acc + dd * uk;
}

// NT: the states kept in registers, 4, 8 or 16 (N padded with zero states)
template <int NT>
__global__ void __launch_bounds__(kFwdThreads, 4)
ssm_scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ Dv,
                    float* __restrict__ y, float* __restrict__ h_final,
                    float* __restrict__ states,
                    int L, int Din, int N) {
  __shared__ Stage<NT> ring[2];
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const int d0 = blockIdx.x * kFwdThreads;
  const int d = d0 + j;
  const bool live = d < Din;
  const int nc = num_chunks(L);
  const long long row = (long long)b * L;          // row of (b, t = 0)
  const bool vec_u = Din % 4 == 0 && aligned16(u) && aligned16(dt);
  const bool vec_bc = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);

  copy_chunk<NT>(ring[0], u, dt, Bm, Cm, row, min(kChunk, L), d0, Din, N,
                 vec_u, vec_bc);
  cp_async_commit();

  float a2[NT], h[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    a2[n] = (live && n < N) ? A[(long long)d * N + n] * kLog2e : 0.f;
    h[n] = 0.f;
  }
  const float dd = live ? Dv[d] : 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk;
    const int kn = min(kChunk, L - t0);
    // chunk c has landed in every thread, and every thread is done with
    // chunk c - 1, whose stage the next copies overwrite
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < nc) {
      copy_chunk<NT>(ring[(c + 1) & 1], u, dt, Bm, Cm, row + t0 + kChunk,
                     min(kChunk, L - t0 - kChunk), d0, Din, N, vec_u,
                     vec_bc);
      cp_async_commit();
    }
    if (states && live) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < N) states[state_index(b, c, nc, n, N, d, Din)] = h[n];
    }
    const Stage<NT>& st = ring[c & 1];
    float* yk = y + (row + t0) * Din + d;           // moved a row a step
    if (kn == kChunk) {                    // no branch between the steps
#pragma unroll
      for (int k = 0; k < kChunk; ++k, yk += Din)
        step<NT>(st, k, j, a2, h, dd, live, yk);
    } else {
      for (int k = 0; k < kn; ++k, yk += Din)
        step<NT>(st, k, j, a2, h, dd, live, yk);
    }
  }
  if (h_final && live) {
    const long long chan = (long long)b * Din + d;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < N) h_final[chan * N + n] = h[n];
  }
}

const void* fwd_kernel_for(int N) {
  const int nt = state_tile(N);
  if (nt == 4) return (const void*)ssm_scan_fwd_kernel<4>;
  if (nt == 8) return (const void*)ssm_scan_fwd_kernel<8>;
  return (const void*)ssm_scan_fwd_kernel<16>;
}

}  // namespace

// Floats of the checkpoints: (batch, nchunks, N, Din).
extern "C" long long ssm_scan_states_floats(int batch, int L, int Din, int N) {
  return (long long)batch * num_chunks(L) * N * Din;
}

// h_final and states may be null.  Returns cudaGetLastError() after the
// launch.
extern "C" int ssm_scan_f32(const float* u, const float* dt, const float* A,
                            const float* B, const float* C, const float* D,
                            float* y, float* h_final, float* states,
                            int batch, int L, int Din, int N, void* stream) {
  if (bad_shape(batch, L, Din, N)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Din + kFwdThreads - 1) / kFwdThreads, batch);
  void* args[] = {&u, &dt, &A, &B, &C, &D, &y, &h_final, &states,
                  &L, &Din, &N};
  cudaError_t err = cudaLaunchKernel(fwd_kernel_for(N), grid,
                                     dim3(kFwdThreads), args, 0,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the forward kernel for N one SM holds at once (-1 on error).
extern "C" int ssm_scan_occupancy(int N) {
  int blocks = -1;
  if (N <= 0 || N > 16 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fwd_kernel_for(N), kFwdThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}
