// Shared by the selective-scan kernels (ssm_scan.cu, ssm_scan_backward.cu):
// the chunk of steps between the forward's state checkpoints, the layout
// of those checkpoints, and the register tile of the N states.
#pragma once

#include <cuda_runtime.h>

namespace repro_ssm {

constexpr int kChunk = 16;        // steps per chunk (state checkpoints)
constexpr int kWarp = 32;

// N is kept in registers as a tile of 4, 8 or 16 (zero-padded states)
inline int state_tile(int N) { return N <= 4 ? 4 : (N <= 8 ? 8 : 16); }

__host__ __device__ inline int num_chunks(int L) { return (L + kChunk - 1) / kChunk; }

inline bool bad_shape(int batch, int L, int Din, int N) {
  return batch <= 0 || batch > 65535 || L <= 0 || Din <= 0 || N <= 0 ||
         N > 16;
}

// The backward's exponential, __expf (ex2.approx after a multiply):
// against expf it was chosen by the 1e-5 check of both scans against their
// plain version on the card, which it holds at ~1e-7 (chip_smoke.py).  The
// forward folds log2(e) into A once per state instead (ssm_scan.cu).
__device__ __forceinline__ float exp_(float x) { return __expf(x); }

// index of state n of channel (b, d) at the start of chunk c, in the
// forward's checkpoints (batch, nchunks, N, Din): coalesced over d
__device__ __forceinline__ long long state_index(int b, int c, int nc, int n,
                                                 int N, int d, int Din) {
  return (((long long)b * nc + c) * N + n) * Din + d;
}

}  // namespace repro_ssm
