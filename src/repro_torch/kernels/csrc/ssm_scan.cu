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
// other operations take a third of that.
//
// Design.  The TPU kernel tiles Din into VPU lanes and streams time in
// chunks with the (block, N) state in VMEM.  Here the time loop is inside
// one thread: a thread owns one (b, d) channel and keeps its N states in
// registers for the whole sequence, so the state never leaves the SM.  A
// block covers 128 consecutive channels of one b, so the loads of u and dt
// and the stores of y are coalesced; B_t and C_t (N floats per (b, t)) are
// staged in shared memory one chunk of kChunk steps at a time and read by
// every thread as broadcasts, and a chunk's u and dt are loaded into
// registers before its steps run, so the loads overlap.  N is a template
// parameter (4, 8 or 16, a smaller N padded with zero states), so the
// state arrays stay in registers.
//
// With a states buffer it also writes h at the start of every chunk,
// (batch, nchunks, N, Din): the checkpoints ssm_scan_backward.cu
// recomputes from.  h_final is written on request (the prefill's state).
#include <cuda_runtime.h>

#include "ssm_scan.cuh"

namespace {

using namespace repro_ssm;

constexpr int kFwdThreads = 128;  // channels per block

template <int NT>
__global__ void __launch_bounds__(kFwdThreads)
ssm_scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ Dv,
                    float* __restrict__ y, float* __restrict__ h_final,
                    float* __restrict__ states,
                    int L, int Din, int N) {
  __shared__ float sB[kChunk][NT];
  __shared__ float sC[kChunk][NT];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kFwdThreads + threadIdx.x;
  const bool live = d < Din;
  const int nc = num_chunks(L);
  const long long row = (long long)b * L;           // row of (b, t = 0)
  const long long chan = (long long)b * Din + d;    // (b, d) channel

  float a[NT], h[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    a[n] = (live && n < N) ? A[(long long)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dd = live ? Dv[d] : 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk;
    const int kn = min(kChunk, L - t0);
    for (int i = threadIdx.x; i < kChunk * NT; i += kFwdThreads) {
      const int k = i / NT, n = i % NT;
      const bool in = k < kn && n < N;
      sB[k][n] = in ? Bm[(row + t0 + k) * N + n] : 0.f;
      sC[k][n] = in ? Cm[(row + t0 + k) * N + n] : 0.f;
    }
    if (states && live) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < N) states[state_index(b, c, nc, n, N, d, Din)] = h[n];
    }
    float uk[kChunk], dk[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const bool in = live && k < kn;
      const long long idx = (row + t0 + k) * Din + d;
      uk[k] = in ? u[idx] : 0.f;
      dk[k] = in ? dt[idx] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < kn) {                                 // the same in the block
        const float du = dk[k] * uk[k];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          h[n] = exp_(dk[k] * a[n]) * h[n] + du * sB[k][n];
          acc += h[n] * sC[k][n];
        }
        if (live) y[(row + t0 + k) * Din + d] = acc + dd * uk[k];
      }
    }
    __syncthreads();                    // before the next chunk's staging
  }
  if (h_final && live) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < N) h_final[chan * N + n] = h[n];
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Din + kFwdThreads - 1) / kFwdThreads, batch);
#define REPRO_SSM_FWD(NT)                                                    \
  ssm_scan_fwd_kernel<NT><<<grid, kFwdThreads, 0, s>>>(                      \
      u, dt, A, B, C, D, y, h_final, states, L, Din, N)
  const int nt = state_tile(N);
  if (nt == 4) REPRO_SSM_FWD(4);
  else if (nt == 8) REPRO_SSM_FWD(8);
  else REPRO_SSM_FWD(16);
#undef REPRO_SSM_FWD
  return (int)cudaGetLastError();
}
