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
// chunks with the (block, N) state in VMEM.  Here LANES threads own one
// (b, d) channel, each keeping NT / LANES of its states in registers for
// the whole sequence, so the state never leaves the SM; a block of 128
// threads covers 128 / LANES consecutive channels of one b.
// - Lanes a channel, a rule of the shape (kernels/ssm_scan.py
//   scan_lanes): one where one lane a channel gives the card at least a
//   block an SM (the training shape: 512 blocks), else NT / 4, four states
//   a lane (Jamba's prefill, B=1 and Din=8192: 64 blocks of one lane a
//   channel left half the SMs idle, each thread walking 32 steps of 16
//   states alone; four lanes make 256 blocks).  A step's y is joined over
//   the lanes by shuffles in a fixed order ((l0 + l1) + (l2 + l3)); every
//   lane ends with the same bits, and the first stores them.
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
// - The decay and the state update are ssm_scan.cuh's decay() and
//   update(): a * log2(e) formed once per state, one multiply and one
//   ex2.approx a decay, one rounding order, which the backward repeats.
// Tried on the card and not kept (PERF.md): two lanes a channel at the
// training shape, where one lane a channel fills the card (twice the warps
// an SM, more instructions an exponential: slower), y staged in shared
// memory and stored a chunk late, a third ring stage, and eight lanes a
// channel (two states a lane) at the prefill (slower than four).
// Every sum has a fixed order (the states in n order, then the lanes), so
// two calls give the same bits.
// bfloat16 is the same kernel over the element type of u and dt: the ring
// holds them as bfloat16 (half the bytes), copied 16 bytes (8 values) at a
// time where Din % 8 == 0 and the rows align, else by plain loads and
// stores (cp.async moves no fewer than 4 bytes), and each thread widens
// its own u and dt as it reads them.  B and C, which every thread of the
// block reads at every step, are copied raw by cp.async with the chunk's
// u and dt, a chunk ahead (where N % 8 == 0 and they align; plain loads
// otherwise; the first port loaded them with plain loads after the
// barrier and waited on them before its steps), by threads spread over the
// block's warps; when the chunk comes up each copying thread waits on its
// own copies and widens them into float32 rows of the same stage, before
// the barrier that publishes the chunk, so a step's float4 broadcasts and
// arithmetic are the float32 kernel's.
//
// With a states buffer it also writes h at the start of every chunk,
// (batch, nchunks, N, Din): the checkpoints ssm_scan_backward.cu
// recomputes from.  h_final is written on request (the prefill's state).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssm_scan.cuh"

namespace {

using namespace repro_ssm;

constexpr int kFwdThreads = 128;

// bfloat16 B and C as copied, before they are widened; none for float32,
// whose B and C are copied into the float rows directly (an empty base,
// which takes no bytes: a member would pad the stage by 16 and put the
// second stage's B and C rows across 128-byte lines, two wavefronts a
// float4 broadcast)
template <int NT, typename T>
struct RawBC {
  alignas(16) T raw[2][kChunk][NT];
};
template <int NT>
struct RawBC<NT, float> {};

// One chunk's operands: u and dt (ud[0], ud[1]) of the block's CPB
// channels in their type T, B and C (bc[0], bc[1]) in float32, padded to
// NT states (zeros past N)
template <int NT, int CPB, typename T>
struct Stage : RawBC<NT, T> {
  alignas(16) T ud[2][kChunk][CPB];
  alignas(16) float bc[2][kChunk][NT];
};

// The copy index of B and C: the block's threads taken lane-major across
// its 4 warps, so that the few copies of B and C (64 at N = 16), and the
// widening that follows them, spread over every warp
__device__ __forceinline__ int bc_index() {
  return (threadIdx.x % kWarp) * (kFwdThreads / kWarp) + threadIdx.x / kWarp;
}

// Issues the copies of one chunk (rows row0 .. row0 + kn - 1): u and dt
// 16 bytes a copy where vec_u (Din a multiple of kVec<T>, u and dt
// aligned), B and C where vec_bc (N a multiple of kVec<T>, aligned)
template <int NT, int CPB, typename T>
__device__ __forceinline__ void copy_chunk(
    Stage<NT, CPB, T>& st, const T* __restrict__ u, const T* __restrict__ dt,
    const T* __restrict__ Bm, const T* __restrict__ Cm, long long row0,
    int kn, int d0, int Din, int N, bool vec_u, bool vec_bc) {
  const T* const ud[2] = {u, dt};
  const T* const bc[2] = {Bm, Cm};
  copy_tiles<kFwdThreads>(st.ud, ud, row0, Din, kn, d0, Din - d0, vec_u);
  if constexpr (sizeof(T) == 2)
    copy_tiles<kFwdThreads>(st.raw, bc, row0, N, kn, 0, N, vec_bc,
                            bc_index());
  else
    copy_tiles<kFwdThreads>(st.bc, bc, row0, N, kn, 0, N, vec_bc,
                            bc_index());
}

// After this thread's cp_async_wait_all: the bfloat16 B and C entries it
// copied (copy_tiles' assignment at bc_index()), widened into the stage's
// float rows, 16 bytes (8 values) read and two float4 written at a time
// where vec
template <int NT, int CPB, typename T>
__device__ __forceinline__ void widen_bc(Stage<NT, CPB, T>& st, bool vec) {
  if constexpr (sizeof(T) == 2) {
    constexpr int E = kVec<T>;
    if constexpr (NT % E == 0) {
      if (vec) {
        for (int i = bc_index(); i < kChunk * (NT / E); i += kFwdThreads) {
          const int r = i / (NT / E), j = E * (i % (NT / E));
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const uint4 v =
                *reinterpret_cast<const uint4*>(&st.raw[q][r][j]);
            const __nv_bfloat162* p =
                reinterpret_cast<const __nv_bfloat162*>(&v);
            const float2 f0 = __bfloat1622float2(p[0]);
            const float2 f1 = __bfloat1622float2(p[1]);
            const float2 f2 = __bfloat1622float2(p[2]);
            const float2 f3 = __bfloat1622float2(p[3]);
            float4* out = reinterpret_cast<float4*>(&st.bc[q][r][j]);
            out[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
            out[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
          }
        }
        return;
      }
    }
    for (int i = bc_index(); i < kChunk * NT; i += kFwdThreads)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        st.bc[q][i / NT][i % NT] = widen(st.raw[q][i / NT][i % NT]);
  }
}

// S floats of a 16-byte aligned shared row as float4 broadcasts
template <int S>
__device__ __forceinline__ void load_row(float (&v)[S], const float* p) {
  static_assert(S % 4 == 0, "float4 broadcasts of a lane's states");
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// One step k of the recurrence for S = NT / LANES states (n0 .. n0 + S - 1)
// of channel j; the channel's lanes join y_t, the first stores it to *yk.
template <int NT, int LANES, typename T>
__device__ __forceinline__ void step(
    const Stage<NT, kFwdThreads / LANES, T>& st, int k, int j, int n0,
    const float (&a2)[NT / LANES], float (&h)[NT / LANES], float dd,
    bool store, T* yk) {
  constexpr int S = NT / LANES;
  const float uk = widen(st.ud[0][k][j]);
  const float dk = widen(st.ud[1][k][j]);
  const float du = __fmul_rn(dk, uk);
  float bv[S], cv[S];
  load_row(bv, &st.bc[0][k][n0]);
  load_row(cv, &st.bc[1][k][n0]);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    h[i] = update(decay(dk, a2[i]), h[i], du, bv[i]);
    acc = __fmaf_rn(h[i], cv[i], acc);
  }
#pragma unroll
  for (int off = 1; off < LANES; off *= 2)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (store) *yk = narrow<T>(__fmaf_rn(dd, uk, acc));
}

// NT: the states kept in registers, 4, 8 or 16 (N padded with zero
// states); LANES: the threads a channel, each with NT / LANES >= 4 states;
// T: the type of u, dt, B, C and y (A, D, h_final and the checkpoints are
// float32)
template <int NT, int LANES, typename T>
__global__ void __launch_bounds__(kFwdThreads, 4)
ssm_scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dv,
                    T* __restrict__ y, float* __restrict__ h_final,
                    float* __restrict__ states,
                    int L, int Din, int N) {
  constexpr int S = NT / LANES, CPB = kFwdThreads / LANES;
  __shared__ Stage<NT, CPB, T> ring[2];
  const int b = blockIdx.y;
  const int j = threadIdx.x / LANES;
  const int n0 = S * (threadIdx.x % LANES);
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + j;
  const bool live = d < Din;
  const bool store = live && n0 == 0;
  const int nc = num_chunks(L);
  const long long row = (long long)b * L;          // row of (b, t = 0)
  const bool vec_u = Din % kVec<T> == 0 && aligned16(u) && aligned16(dt);
  const bool vec_bc = N % kVec<T> == 0 && aligned16(Bm) && aligned16(Cm);

  copy_chunk(ring[0], u, dt, Bm, Cm, row, min(kChunk, L), d0, Din, N, vec_u,
             vec_bc);
  cp_async_commit();

  float a2[S], h[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    a2[i] = (live && n0 + i < N)
                ? __fmul_rn(A[(long long)d * N + n0 + i], kLog2e) : 0.f;
    h[i] = 0.f;
  }
  const float dd = live ? Dv[d] : 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk;
    const int kn = min(kChunk, L - t0);
    // chunk c is in every thread's view (its bfloat16 B and C widened by
    // the threads that copied them), and every thread is done with chunk
    // c - 1, whose stage the next copies overwrite
    cp_async_wait_all();
    widen_bc(ring[c & 1], vec_bc);
    __syncthreads();
    if (c + 1 < nc) {
      copy_chunk(ring[(c + 1) & 1], u, dt, Bm, Cm, row + t0 + kChunk,
                 min(kChunk, L - t0 - kChunk), d0, Din, N, vec_u, vec_bc);
      cp_async_commit();
    }
    if (states && live) {
#pragma unroll
      for (int i = 0; i < S; ++i)
        if (n0 + i < N)
          states[state_index(b, c, nc, n0 + i, N, d, Din)] = h[i];
    }
    const Stage<NT, CPB, T>& st = ring[c & 1];
    T* yk = y + (row + t0) * Din + d;               // moved a row a step
    if (kn == kChunk) {                    // no branch between the steps
#pragma unroll
      for (int k = 0; k < kChunk; ++k, yk += Din)
        step<NT, LANES>(st, k, j, n0, a2, h, dd, store, yk);
    } else {
      for (int k = 0; k < kn; ++k, yk += Din)
        step<NT, LANES>(st, k, j, n0, a2, h, dd, store, yk);
    }
  }
  if (h_final && live) {
    const long long chan = (long long)b * Din + d;
#pragma unroll
    for (int i = 0; i < S; ++i)
      if (n0 + i < N) h_final[chan * N + n0 + i] = h[i];
  }
}

// the kernel for N's state tile and ``lanes`` threads a channel: 1, or
// state_tile(N) / 4 where that is more (null for any other)
template <typename T>
const void* fwd_kernel_for(int N, int lanes) {
  const int nt = state_tile(N);
  if (lanes == 1) {
    if (nt == 4) return (const void*)ssm_scan_fwd_kernel<4, 1, T>;
    if (nt == 8) return (const void*)ssm_scan_fwd_kernel<8, 1, T>;
    return (const void*)ssm_scan_fwd_kernel<16, 1, T>;
  }
  if (nt == 8 && lanes == 2) return (const void*)ssm_scan_fwd_kernel<8, 2, T>;
  if (nt == 16 && lanes == 4)
    return (const void*)ssm_scan_fwd_kernel<16, 4, T>;
  return nullptr;
}

template <typename T>
int scan(const T* u, const T* dt, const float* A, const T* B, const T* C,
         const float* D, T* y, float* h_final, float* states, int batch,
         int L, int Din, int N, int lanes, void* stream) {
  if (bad_shape(batch, L, Din, N)) return (int)cudaErrorInvalidValue;
  const void* kernel = fwd_kernel_for<T>(N, lanes);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const int cpb = kFwdThreads / lanes;
  const dim3 grid((Din + cpb - 1) / cpb, batch);
  void* args[] = {&u, &dt, &A, &B, &C, &D, &y, &h_final, &states,
                  &L, &Din, &N};
  cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(kFwdThreads), args,
                                     0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the checkpoints: (batch, nchunks, N, Din).
extern "C" long long ssm_scan_states_floats(int batch, int L, int Din, int N) {
  return (long long)batch * num_chunks(L) * N * Din;
}

// h_final and states may be null; lanes: threads a channel, 1 or
// state_tile(N) / 4 (kernels/ssm_scan.py scan_lanes picks it).  Returns
// cudaGetLastError() after the launch.
extern "C" int ssm_scan_f32(const float* u, const float* dt, const float* A,
                            const float* B, const float* C, const float* D,
                            float* y, float* h_final, float* states,
                            int batch, int L, int Din, int N, int lanes,
                            void* stream) {
  return scan<float>(u, dt, A, B, C, D, y, h_final, states, batch, L, Din, N,
                     lanes, stream);
}

// u, dt, B, C and y bfloat16; A, D, h_final and states float32; otherwise
// as ssm_scan_f32.
extern "C" int ssm_scan_bf16(const void* u, const void* dt, const float* A,
                             const void* B, const void* C, const float* D,
                             void* y, float* h_final, float* states,
                             int batch, int L, int Din, int N, int lanes,
                             void* stream) {
  return scan<bf16>(static_cast<const bf16*>(u), static_cast<const bf16*>(dt),
                    A, static_cast<const bf16*>(B),
                    static_cast<const bf16*>(C), D, static_cast<bf16*>(y),
                    h_final, states, batch, L, Din, N, lanes, stream);
}

// Blocks of the float32 forward kernel for N and ``lanes`` one SM holds at
// once (-1 on error).
extern "C" int ssm_scan_occupancy(int N, int lanes) {
  int blocks = -1;
  const void* kernel =
      (N > 0 && N <= 16) ? fwd_kernel_for<float>(N, lanes) : nullptr;
  if (!kernel || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, kernel, kFwdThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}
