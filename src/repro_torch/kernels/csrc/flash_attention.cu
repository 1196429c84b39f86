// FlashAttention-2 style attention for Hopper (sm_90a): float32 in and out
// with the products on the tensor cores at float32 accuracy (3xTF32), or
// bfloat16 in and out with bfloat16 products (below).
//
//   o[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / G]) @ v[b, :, h / G]
//
// q and o are (B, Sq, H, D), k and v are (B, Sk, KH, D), all row-major,
// G = H / KH (grouped-query attention by index: kv is never repeated).
// Masks: causal (q_pos >= k_pos), sliding window (q_pos - k_pos < window
// when window > 0), with q_pos = i + q_offset; a masked score is the finite
// -1e30 of the TPU kernel, so a row with every key masked averages the
// values uniformly.  Keys past Sk (the ragged end) take no part.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_pallas
//   (_flash_kernel).
//
// Bound: operations.  4 * Sq * Sk * D flops per head against 16 * S * D
// bytes of q, k, v and o; on the tensor cores each product is three TF32
// products (below), so the floor is 3 * flops at the TF32 rate, or the
// exponentials, or the bytes, whichever is largest (chip_smoke.py).
//
// Design.
// - Products: mma.sync m16n8k8 with TF32 operands and float32 accumulators.
//   TF32 keeps 10 mantissa bits, too few for the port's 1e-5 against its
//   float32 plain version, so every operand x is split into big =
//   tf32(x) and small = tf32(x - big) (cvt.rna) and each product is
//   big*small + small*big + big*big, small terms first, into the same
//   float32 accumulator: the small*small term it drops is 2^-22 of the
//   product (CUTLASS's OpMultiplyAddFastF32).  Both S = Q K^T and O = P V.
// - Accumulation: the tensor cores add into their float32 accumulator
//   without rounding to nearest, so a long chain of mma into one
//   accumulator drifts.  Each key tile's P V goes into a fresh
//   accumulator that is added to O with an IEEE add, so no chain is
//   longer than one tile.  At llava's prefill (S = 3008, D = 128) one
//   chain over all the keys put the kernel up to 1.04e-5 from its float32
//   plain version on an H100; with a chain per tile, at most 4.5e-6, at
//   the same speed.
// - Tiling: one block of four warps per (b, h, 64-query tile); each warp
//   owns 16 query rows (the mma's M) for the whole key loop, so the online
//   softmax never leaves its registers.  Q is staged once in shared memory
//   and its fragments are split as they are read (holding them split in
//   registers would take D registers a thread, 128 at D = 128).  K and V come in
//   tiles of BK keys (64 for D <= 64, 32 for D = 128, by registers).
// - Copies: K and V tiles through cp.async, 16 bytes a thread, coalesced,
//   in a ring of two stages: the next tile is in flight while the current
//   one is computed.  Keys past Sk are zero-filled by the copy.
// - Bank conflicts: shared rows are D + 4 floats apart.  The B fragment of
//   S reads K at (key g, feature t) and that of O reads V at (key 2t or
//   2t + 1, feature g), g = lane / 4, t = lane % 4: both land on 32
//   distinct banks.
// - P from accumulator to operand: the accumulator of S holds, per thread,
//   keys 2t and 2t + 1 of each 8-key column block, while the A operand of
//   O = P V wants keys t and t + 4.  A sum over keys does not care in which
//   order the keys come, so the k index t of the P V product stands for
//   key 2t and k index t + 4 for key 2t + 1, and V's B fragment is read in
//   the same order: P goes from accumulator to operand in place, with no
//   shuffle and no trip through shared memory.
// - Softmax: scale * log2(e) is folded into the scores and exp2f taken;
//   row max by two __shfl_xor_sync steps across the quad that shares a
//   row; the row sum is kept per thread and summed across the quad once at
//   the end; one rescale of O per tile; l clamped at 1e-30.
// - Masks: tiles that causal or window masking empties for every row of
//   the block are skipped (all tiles are visited when some row of the
//   block has every key masked, for its uniform average); inside a partly
//   masked tile a masked score is -1e30 and a key past Sk is -inf.
// - Output: each warp stages its 16 rows in its part of the Q buffer and
//   writes them out with 16-byte coalesced stores.
// - bfloat16 (the reference's default dtype; its TPU kernel casts each tile
//   to float32 and writes q's dtype): the same kernel over the element
//   type, with tiles of half the bytes (rows D + 8 values apart: the
//   fragments' 4-byte reads land on 32 distinct banks).  S = Q K^T is one
//   mma.sync m16n8k16 with bfloat16 operands and a float32 accumulator: a
//   product of two bfloat16 values is exact in float32, so one pass gives
//   what 3xTF32's three give float32.  The softmax statistics stay
//   float32.  O = P V rounds P to bfloat16 for the same instruction (the
//   row sum l is taken from the float32 P): the accumulator of S holds
//   keys 2t, 2t + 1 (and 2t + 8, 2t + 9 in the next 8-key block), exactly
//   the A operand's k indices of a 16-key step, so P goes in as it stands;
//   V's B fragment pairs keys 2t and 2t + 1 of one feature, two 2-byte
//   reads.  Each key tile's P V again goes into a fresh accumulator.  The
//   output is rounded once to bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;     // query rows per block
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of a block in values of T (float or bfloat16)
template <int D, typename T>
struct Tile {
  static constexpr int BK = D <= 64 ? 64 : 32;   // keys per K/V tile
  static constexpr int LD = D + 16 / sizeof(T);  // shared row stride
  static constexpr int kQ = kBQ * LD;
  static constexpr int kKv = BK * LD;            // one K or V tile
  // Q, then a ring of two stages of a K and a V tile
  static constexpr int kValues = kQ + 2 * 2 * kKv;
  static constexpr int kBytes = kValues * (int)sizeof(T);
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: a (rows g, g+8 by columns t, t+4) split once and
// reused over several b; b (rows t, t+4 of column g) as float32
__device__ __forceinline__ void mma3_split(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const float (&b)[2]) {
  uint32_t bb[2], bs[2];
  split(b[0], bb[0], bs[0]);
  split(b[1], bb[1], bs[1]);
  mma(c, ab[0], ab[1], ab[2], ab[3], bs[0], bs[1]);
  mma(c, as[0], as[1], as[2], as[3], bb[0], bb[1]);
  mma(c, ab[0], ab[1], ab[2], ab[3], bb[0], bb[1]);
}

// c += a b on bfloat16 operands: a (rows g, g+8 by columns 2t, 2t+1 and
// 2t+8, 2t+9), b (rows 2t, 2t+1 and 2t+8, 2t+9 of column g), two values a
// register, the lower index in the lower half
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two consecutive bfloat16 values as one register
__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to bfloat16, lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bfloat16 values from two rows, the first in the lower half
__device__ __forceinline__ uint32_t pair_bf16(const bf16* lo,
                                              const bf16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo) |
         ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

// S (16 rows of the warp x the tile's BK keys) = Q K^T in 3xTF32
template <int D, int LD, int NS>
__device__ __forceinline__ void qk_tile(float (&s)[NS][4], const float* qw,
                                        const float* ks, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ab[4], as[4];
    split(qw[g * LD + kk * 8 + t], ab[0], as[0]);
    split(qw[(g + 8) * LD + kk * 8 + t], ab[1], as[1]);
    split(qw[g * LD + kk * 8 + t + 4], ab[2], as[2]);
    split(qw[(g + 8) * LD + kk * 8 + t + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float* kr = ks + (j * 8 + g) * LD + kk * 8 + t;
      const float bf[2] = {kr[0], kr[4]};
      mma3_split(s[j], ab, as, bf);
    }
  }
}

// the same in bfloat16: one m16n8k16 per 8 keys and 16 features
template <int D, int LD, int NS>
__device__ __forceinline__ void qk_tile(float (&s)[NS][4], const bf16* qw,
                                        const bf16* ks, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* q0 = qw + g * LD + kk * 16 + 2 * t;
    const bf16* q8 = q0 + 8 * LD;
    const uint32_t a0 = ld2(q0), a1 = ld2(q8), a2 = ld2(q0 + 8),
                   a3 = ld2(q8 + 8);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const bf16* kr = ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(s[j], a0, a1, a2, a3, ld2(kr), ld2(kr + 8));
    }
  }
}

// ot = P V for the tile (P the softmax weights in s) in 3xTF32: k index t
// is key 2t, k index t + 4 is key 2t + 1 of each 8-key block, so S's
// accumulator is P's operand as it stands
template <int D, int LD, int NS>
__device__ __forceinline__ void pv_tile(float (&ot)[D / 8][4],
                                        const float (&s)[NS][4],
                                        const float* vs, int g, int t) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    uint32_t ab[4], as[4];
    split(s[j][0], ab[0], as[0]);     // row g,     key 2t
    split(s[j][2], ab[1], as[1]);     // row g + 8, key 2t
    split(s[j][1], ab[2], as[2]);     // row g,     key 2t + 1
    split(s[j][3], ab[3], as[3]);     // row g + 8, key 2t + 1
    const float* vr = vs + (j * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float bf[2] = {vr[n * 8], vr[LD + n * 8]};
      mma3_split(ot[n], ab, as, bf);
    }
  }
}

// the same in bfloat16, P rounded: a 16-key step takes two 8-key blocks
// of S's accumulator (keys 2t, 2t + 1 and 2t + 8, 2t + 9) as its A operand
template <int D, int LD, int NS>
__device__ __forceinline__ void pv_tile(float (&ot)[D / 8][4],
                                        const float (&s)[NS][4],
                                        const bf16* vs, int g, int t) {
#pragma unroll
  for (int j = 0; j < NS; j += 2) {
    const uint32_t a0 = pack_bf16(s[j][0], s[j][1]);          // row g
    const uint32_t a1 = pack_bf16(s[j][2], s[j][3]);          // row g + 8
    const uint32_t a2 = pack_bf16(s[j + 1][0], s[j + 1][1]);
    const uint32_t a3 = pack_bf16(s[j + 1][2], s[j + 1][3]);
    const bf16* vr = vs + (j * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* c = vr + n * 8;
      mma_bf16(ot[n], a0, a1, a2, a3, pair_bf16(c, c + LD),
               pair_bf16(c + 8 * LD, c + 9 * LD));
    }
  }
}

// 16 bytes from global to shared, asynchronously; zero-filled unless valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N));
}

// rows [row0, row0 + ROWS) of a (rows, stride) matrix of T, its first D
// columns, into shared memory at LD values a row; rows >= nrows are zero
template <int ROWS, int D, int LD, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int row0,
                                          int nrows) {
  constexpr int E = 16 / sizeof(T);        // values a 16-byte copy moves
  constexpr int kChunks = ROWS * D / E;
#pragma unroll
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const int r = i / (D / E);
    const int c = (i % (D / E)) * E;
    const bool valid = row0 + r < nrows;
    cp_async16(dst + r * LD + c,
               src + (valid ? (long long)(row0 + r) * stride + c : 0), valid);
  }
}

// T: the element type of q, k, v and o (float or bfloat16)
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq,
             int sk, int heads, int kv_heads, int causal, int window,
             int q_offset, float scale) {
  using L = Tile<D, T>;
  constexpr int BK = L::BK;
  constexpr int LD = L::LD;
  constexpr int NS = BK / 8;       // 8-key column blocks of S per tile
  constexpr int NO = D / 8;        // 8-feature column blocks of O
  extern __shared__ __align__(16) float smem[];
  T* qs = reinterpret_cast<T*>(smem);                // [kBQ][LD]
  T* kvs = qs + L::kQ;                               // [stage][K, V][BK][LD]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kBQ;
  const long long q_stride = (long long)heads * D;
  const long long kv_stride = (long long)kv_heads * D;
  const T* qb = q + b * sq * q_stride + (long long)h * D;
  const T* kb = k + b * sk * kv_stride + (long long)kvh * D;
  const T* vb = v + b * sk * kv_stride + (long long)kvh * D;

  // the key tiles some row of this block can see
  const int qlo = q0 + q_offset;
  const int qhi = min(q0 + kBQ, sq) - 1 + q_offset;
  const bool some_row_blind = (causal && qlo < 0) ||
                              (window > 0 && qhi - window + 1 > sk - 1);
  int kmin = 0, kmax = sk - 1;
  if (!some_row_blind) {
    if (window > 0) kmin = max(0, qlo - window + 1);
    if (causal) kmax = min(sk - 1, qhi);
  }
  const int t_lo = kmin / BK;
  const int t_hi = kmax / BK + 1;

  auto load_kv = [&](int tile, int stage) {
    T* ks = kvs + stage * 2 * L::kKv;
    load_rows<BK, D, LD>(ks, kb, kv_stride, tile * BK, sk);
    load_rows<BK, D, LD>(ks + L::kKv, vb, kv_stride, tile * BK, sk);
  };
  load_rows<kBQ, D, LD>(qs, qb, q_stride, q0, sq);
  load_kv(t_lo, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  const int row_g = q0 + warp * 16 + g;        // this thread's two rows
  const int pos_g = row_g + q_offset;
  const int pos_g8 = pos_g + 8;
  const T* qw = qs + warp * 16 * LD;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m_g = kMasked, m_g8 = kMasked;   // running max (log2 domain)
  float l_g = 0.f, l_g8 = 0.f;           // this thread's share of the sum

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int stage = (tile - t_lo) & 1;
    if (tile + 1 < t_hi) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                 // this tile (and Q) have landed
    __syncthreads();
    const T* ks = kvs + stage * 2 * L::kKv;
    const T* vs = ks + L::kKv;
    const int k0 = tile * BK;

    // S = Q K^T for the warp's 16 rows and the tile's BK keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    qk_tile<D, LD, NS>(s, qw, ks, g, t);

    // mask, scale into the log2 domain, row max across the quad
    float tmax_g = kMasked, tmax_g8 = kMasked;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + j * 8 + 2 * t + (i & 1);
        const int qpos = i < 2 ? pos_g : pos_g8;
        bool keep = true;
        if (causal) keep = keep && qpos >= kpos;
        if (window > 0) keep = keep && qpos - kpos < window;
        const float x = kpos < sk ? (keep ? s[j][i] * sl2 : kMasked)
                                  : -CUDART_INF_F;
        s[j][i] = x;
        if (i < 2) tmax_g = fmaxf(tmax_g, x);
        else tmax_g8 = fmaxf(tmax_g8, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      tmax_g = fmaxf(tmax_g, __shfl_xor_sync(0xffffffffu, tmax_g, off));
      tmax_g8 = fmaxf(tmax_g8, __shfl_xor_sync(0xffffffffu, tmax_g8, off));
    }
    const float mn_g = fmaxf(m_g, tmax_g), mn_g8 = fmaxf(m_g8, tmax_g8);
    const float al_g = exp2f(m_g - mn_g), al_g8 = exp2f(m_g8 - mn_g8);
    m_g = mn_g;
    m_g8 = mn_g8;
    float ps_g = 0.f, ps_g8 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - mn_g);
      s[j][1] = exp2f(s[j][1] - mn_g);
      s[j][2] = exp2f(s[j][2] - mn_g8);
      s[j][3] = exp2f(s[j][3] - mn_g8);
      ps_g += s[j][0] + s[j][1];
      ps_g8 += s[j][2] + s[j][3];
    }
    l_g = al_g * l_g + ps_g;
    l_g8 = al_g8 * l_g8 + ps_g8;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= al_g;
      acc[n][1] *= al_g;
      acc[n][2] *= al_g8;
      acc[n][3] *= al_g8;
    }

    // O += P V, into a fresh accumulator for the tile
    float ot[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) ot[n][i] = 0.f;
    pv_tile<D, LD, NS>(ot, s, vs, g, t);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += ot[n][i];
    __syncthreads();                    // the stage is free for a load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_g += __shfl_xor_sync(0xffffffffu, l_g, off);
    l_g8 += __shfl_xor_sync(0xffffffffu, l_g8, off);
  }
  const float inv_g = 1.f / fmaxf(l_g, 1e-30f);
  const float inv_g8 = 1.f / fmaxf(l_g8, 1e-30f);
  // the warp's rows of Q are read for the last time: stage O there
  T* ow = qs + warp * 16 * LD;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(ow + g * LD + n * 8 + 2 * t) =
          make_float2(acc[n][0] * inv_g, acc[n][1] * inv_g);
      *reinterpret_cast<float2*>(ow + (g + 8) * LD + n * 8 + 2 * t) =
          make_float2(acc[n][2] * inv_g8, acc[n][3] * inv_g8);
    } else {
      *reinterpret_cast<uint32_t*>(ow + g * LD + n * 8 + 2 * t) =
          pack_bf16(acc[n][0] * inv_g, acc[n][1] * inv_g);
      *reinterpret_cast<uint32_t*>(ow + (g + 8) * LD + n * 8 + 2 * t) =
          pack_bf16(acc[n][2] * inv_g8, acc[n][3] * inv_g8);
    }
  }
  __syncwarp();
  constexpr int E = 16 / sizeof(T);        // values a 16-byte store moves
  const int rows = min(16, sq - (q0 + warp * 16));
  for (int i = lane; i < rows * (D / E); i += 32) {
    const int r = i / (D / E);
    const int c = (i % (D / E)) * E;
    *reinterpret_cast<uint4*>(
        o + (b * sq + q0 + warp * 16 + r) * q_stride + (long long)h * D + c) =
        *reinterpret_cast<const uint4*>(ow + r * LD + c);
  }
}

template <int D, typename T>
cudaError_t prepare() {
  // above 48 kB, dynamic shared memory must be asked for (per device)
  return cudaFuncSetAttribute(flash_kernel<D, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<D, T>::kBytes);
}

template <int D, typename T>
cudaError_t launch(dim3 grid, cudaStream_t s, const T* q, const T* k,
                   const T* v, T* o, int sq, int sk, int heads, int kv_heads,
                   int causal, int window, int q_offset, float scale) {
  cudaError_t e = prepare<D, T>();
  if (e != cudaSuccess) return e;
  flash_kernel<D, T><<<grid, kThreads, Tile<D, T>::kBytes, s>>>(
      q, k, v, o, sq, sk, heads, kv_heads, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <int D>
int occupancy() {
  if (prepare<D, float>() != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_kernel<D, float>, kThreads,
          Tile<D, float>::kBytes) != cudaSuccess)
    return -1;
  return blocks;
}

template <typename T>
int attention(const T* q, const T* k, const T* v, T* o, int batch, int sq,
              int sk, int heads, int kv_heads, int head_dim, int causal,
              int window, int q_offset, float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || sq <= 0 || sk <= 0 || kv_heads <= 0 ||
      heads <= 0 || heads > 65535 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return (int)launch<16>(grid, s, q, k, v, o, sq, sk, heads,
                                    kv_heads, causal, window, q_offset, scale);
    case 32: return (int)launch<32>(grid, s, q, k, v, o, sq, sk, heads,
                                    kv_heads, causal, window, q_offset, scale);
    case 64: return (int)launch<64>(grid, s, q, k, v, o, sq, sk, heads,
                                    kv_heads, causal, window, q_offset, scale);
    case 128: return (int)launch<128>(grid, s, q, k, v, o, sq, sk, heads,
                                      kv_heads, causal, window, q_offset,
                                      scale);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// head_dim in {16, 32, 64, 128}; heads % kv_heads == 0; sq, sk >= 1; every
// pointer 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int batch,
                                   int sq, int sk, int heads, int kv_heads,
                                   int head_dim, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  return attention<float>(q, k, v, o, batch, sq, sk, heads, kv_heads,
                          head_dim, causal, window, q_offset, scale, stream);
}

// q, k, v and o bfloat16; otherwise as flash_attention_f32.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int sq, int sk, int heads, int kv_heads,
                                    int head_dim, int causal, int window,
                                    int q_offset, float scale, void* stream) {
  return attention<bf16>(static_cast<const bf16*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<bf16*>(o),
                         batch, sq, sk, heads, kv_heads, head_dim, causal,
                         window, q_offset, scale, stream);
}

// Blocks of the kernel for head_dim one SM holds at once (-1 on error).
extern "C" int flash_attention_occupancy(int head_dim) {
  switch (head_dim) {
    case 16: return occupancy<16>();
    case 32: return occupancy<32>();
    case 64: return occupancy<64>();
    case 128: return occupancy<128>();
    default: return -1;
  }
}
