// Mamba selective scan for Hopper (sm_90a), float32 or bfloat16, forward:
//
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * u_t * B_t      (per channel, N states)
//   y_t = C_t . h_t + D * u_t
//
// u, dt, y: (batch, L, Din) row-major; A: (Din, N); B, C: (batch, L, N);
// D: (Din,); h_final: (batch, Din, N).  N <= 16.  The state starts at 0.
// In bfloat16 (the reference's default dtype: its Mamba block hands the
// scan bfloat16 u, dt, B and C, and float32 A and D) u, dt, B, C and y are
// bfloat16 and A, D, h_final and the checkpoints float32; every value is
// widened as it is read from shared memory, the recurrence runs in float32
// as in float32, and y is rounded once, as the TPU kernel writes u's dtype.
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
// bfloat16 is the same kernel over the element type of u and dt: the ring
// holds them as bfloat16 (half the bytes), copied 16 bytes (8 values) at a
// time where Din % 8 == 0 and the rows align, else by plain loads and
// stores (cp.async moves no fewer than 4 bytes), and each thread widens
// its own u and dt as it reads them.  B and C, which every thread of the
// block reads at every step, are widened once, as they are staged (plain
// loads; a chunk's B and C are 16 x N values), so that a step's float4
// broadcasts and its arithmetic are the float32 kernel's.
//
// With a states buffer it also writes h at the start of every chunk,
// (batch, nchunks, N, Din): the checkpoints ssm_scan_backward.cu
// recomputes from.  h_final is written on request (the prefill's state).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssm_scan.cuh"

namespace {

using namespace repro_ssm;
using bf16 = __nv_bfloat16;

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

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float narrow(float v, float*) { return v; }
__device__ __forceinline__ bf16 narrow(float v, bf16*) {
  return __float2bfloat16_rn(v);
}


// One chunk's operands: u and dt of the block's channels in their type T,
// B and C in float32, padded to NT states (zeros past N)
template <int NT, typename T>
struct Stage {
  T u[kChunk][kFwdThreads];
  T dt[kChunk][kFwdThreads];
  alignas(16) float B[kChunk][NT];
  alignas(16) float C[kChunk][NT];
};

// values of T a 16-byte copy moves
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// A chunk's u and dt (and float B and C) move 16 bytes a copy where every
// row starts on a 16-byte boundary (vec_u: Din a multiple of kVec<T> and
// u, dt aligned; vec_bc: N % 4 == 0 and B, C aligned), one value a copy
// otherwise: 4 bytes through cp.async for float, a plain load and store
// for bfloat16; bfloat16 B and C are widened by plain loads and stores.
template <int NT, typename T>
__device__ __forceinline__ void copy_chunk(
    Stage<NT, T>& st, const T* __restrict__ u, const T* __restrict__ dt,
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    long long row0, int kn, int d0, int Din, int N, bool vec_u,
    bool vec_bc) {
  constexpr int E = kVec<T>;
  if (vec_u) {
    constexpr int Q = kFwdThreads / E;
    for (int i = threadIdx.x; i < kChunk * Q; i += kFwdThreads) {
      const int k = i / Q, j = E * (i % Q);
      const bool in = k < kn && d0 + j < Din;
      const long long off = in ? (row0 + k) * Din + d0 + j : 0;
      cp_async16(&st.u[k][j], u + off, in);
      cp_async16(&st.dt[k][j], dt + off, in);
    }
  } else if constexpr (sizeof(T) == 2) {
    for (int i = threadIdx.x; i < kChunk * kFwdThreads; i += kFwdThreads) {
      const int k = i / kFwdThreads, j = i % kFwdThreads;
      const bool in = k < kn && d0 + j < Din;
      const long long off = (row0 + k) * Din + d0 + j;
      st.u[k][j] = in ? u[off] : T(0.f);
      st.dt[k][j] = in ? dt[off] : T(0.f);
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
  if constexpr (sizeof(T) == 2) {
    for (int i = threadIdx.x; i < kChunk * NT; i += kFwdThreads) {
      const int k = i / NT, n = i % NT;
      const bool in = k < kn && n < N;
      const long long off = (row0 + k) * N + n;
      st.B[k][n] = in ? widen(Bm[off]) : 0.f;
      st.C[k][n] = in ? widen(Cm[off]) : 0.f;
    }
  } else if (vec_bc) {
    constexpr int Q = NT / 4;
    for (int i = threadIdx.x; i < kChunk * Q; i += kFwdThreads) {
      const int k = i / Q, q = i % Q;
      const bool in = k < kn && 4 * q < N;
      const long long off = in ? (row0 + k) * N + 4 * q : 0;
      cp_async16(&st.B[k][4 * q], Bm + off, in);
      cp_async16(&st.C[k][4 * q], Cm + off, in);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * NT; i += kFwdThreads) {
      const int k = i / NT, n = i % NT;
      const bool in = k < kn && n < N;
      const long long off = in ? (row0 + k) * N + n : 0;
      cp_async4(&st.B[k][n], Bm + off, in);
      cp_async4(&st.C[k][n], Cm + off, in);
    }
  }
}

// One step k of the recurrence for channel j's NT states; y_t to *yk.
template <int NT, typename T>
__device__ __forceinline__ void step(const Stage<NT, T>& st, int k, int j,
                                     const float (&a2)[NT], float (&h)[NT],
                                     float dd, bool live, T* yk) {
  const float uk = widen(st.u[k][j]);
  const float dk = widen(st.dt[k][j]);
  const float du = dk * uk;
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < NT / 4; ++q) {
    const float4 bq = *reinterpret_cast<const float4*>(&st.B[k][4 * q]);
    const float4 cq = *reinterpret_cast<const float4*>(&st.C[k][4 * q]);
    const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
    const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * q + e;
      h[n] = ex2(dk * a2[n]) * h[n] + du * bv[e];
      acc += h[n] * cv[e];
    }
  }
  if (live) *yk = narrow(acc + dd * uk, yk);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// NT: the states kept in registers, 4, 8 or 16 (N padded with zero
// states); T: the type of u, dt, B, C and y (A, D, h_final and the
// checkpoints are float32)
template <int NT, typename T>
__global__ void __launch_bounds__(kFwdThreads, 4)
ssm_scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dv,
                    T* __restrict__ y, float* __restrict__ h_final,
                    float* __restrict__ states,
                    int L, int Din, int N) {
  __shared__ Stage<NT, T> ring[2];
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const int d0 = blockIdx.x * kFwdThreads;
  const int d = d0 + j;
  const bool live = d < Din;
  const int nc = num_chunks(L);
  const long long row = (long long)b * L;          // row of (b, t = 0)
  const bool vec_u = Din % kVec<T> == 0 && aligned16(u) && aligned16(dt);
  const bool vec_bc = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);

  copy_chunk<NT, T>(ring[0], u, dt, Bm, Cm, row, min(kChunk, L), d0, Din, N,
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
      copy_chunk<NT, T>(ring[(c + 1) & 1], u, dt, Bm, Cm, row + t0 + kChunk,
                        min(kChunk, L - t0 - kChunk), d0, Din, N, vec_u,
                        vec_bc);
      cp_async_commit();
    }
    if (states && live) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < N) states[state_index(b, c, nc, n, N, d, Din)] = h[n];
    }
    const Stage<NT, T>& st = ring[c & 1];
    T* yk = y + (row + t0) * Din + d;               // moved a row a step
    if (kn == kChunk) {                    // no branch between the steps
#pragma unroll
      for (int k = 0; k < kChunk; ++k, yk += Din)
        step<NT, T>(st, k, j, a2, h, dd, live, yk);
    } else {
      for (int k = 0; k < kn; ++k, yk += Din)
        step<NT, T>(st, k, j, a2, h, dd, live, yk);
    }
  }
  if (h_final && live) {
    const long long chan = (long long)b * Din + d;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < N) h_final[chan * N + n] = h[n];
  }
}

template <typename T>
const void* fwd_kernel_for(int N) {
  const int nt = state_tile(N);
  if (nt == 4) return (const void*)ssm_scan_fwd_kernel<4, T>;
  if (nt == 8) return (const void*)ssm_scan_fwd_kernel<8, T>;
  return (const void*)ssm_scan_fwd_kernel<16, T>;
}

template <typename T>
int scan(const T* u, const T* dt, const float* A, const T* B, const T* C,
         const float* D, T* y, float* h_final, float* states, int batch,
         int L, int Din, int N, void* stream) {
  if (bad_shape(batch, L, Din, N)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Din + kFwdThreads - 1) / kFwdThreads, batch);
  void* args[] = {&u, &dt, &A, &B, &C, &D, &y, &h_final, &states,
                  &L, &Din, &N};
  cudaError_t err = cudaLaunchKernel(fwd_kernel_for<T>(N), grid,
                                     dim3(kFwdThreads), args, 0,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
  return scan<float>(u, dt, A, B, C, D, y, h_final, states, batch, L, Din, N,
                     stream);
}

// u, dt, B, C and y bfloat16; A, D, h_final and states float32; otherwise
// as ssm_scan_f32.
extern "C" int ssm_scan_bf16(const void* u, const void* dt, const float* A,
                             const void* B, const void* C, const float* D,
                             void* y, float* h_final, float* states,
                             int batch, int L, int Din, int N, void* stream) {
  return scan<bf16>(static_cast<const bf16*>(u), static_cast<const bf16*>(dt),
                    A, static_cast<const bf16*>(B),
                    static_cast<const bf16*>(C), D, static_cast<bf16*>(y),
                    h_final, states, batch, L, Din, N, stream);
}

// Blocks of the forward kernel for N one SM holds at once (-1 on error).
extern "C" int ssm_scan_occupancy(int N) {
  int blocks = -1;
  if (N <= 0 || N > 16 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fwd_kernel_for<float>(N), kFwdThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}
