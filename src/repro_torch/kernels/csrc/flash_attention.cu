// FlashAttention for Hopper (sm_90a): float32 in and out with the products
// on the tensor cores at float32 accuracy (3xTF32, FlashAttention-2's
// shape), or bfloat16 in and out with bfloat16 products (below; at D in
// {64, 128} FlashAttention-3's shape on wgmma and TMA).
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
//   to float32 and writes q's dtype), D in {16, 32}: the same kernel over
//   the element type, with tiles of half the bytes (rows D + 8 values
//   apart: the fragments' 4-byte reads land on 32 distinct banks).  S =
//   Q K^T is one mma.sync m16n8k16 with bfloat16 operands and a float32
//   accumulator: a product of two bfloat16 values is exact in float32, so
//   one pass gives what 3xTF32's three give float32.  The softmax
//   statistics stay float32.  O = P V rounds P to bfloat16 for the same
//   instruction (the row sum l is taken from the float32 P): the
//   accumulator of S holds keys 2t, 2t + 1 (and 2t + 8, 2t + 9 in the next
//   8-key block), exactly the A operand's k indices of a 16-key step, so P
//   goes in as it stands; V's B fragment pairs keys 2t and 2t + 1 of one
//   feature, two 2-byte reads.  Each key tile's P V again goes into a fresh
//   accumulator.  The output is rounded once to bfloat16.
// - bfloat16, D in {64, 128} (the DiT, yi-6b, granite, llava): a kernel of
//   its own on wgmma, fed by TMA (namespace wg below).  The kernel above
//   reached 14% of its bound at llava's prefill, 3.7x SDPA's time: every
//   fragment came through scalar shared-memory loads (about 224 a thread
//   for 64 mma.sync per 32-key tile at D = 128, Q re-read every tile), the
//   key tile was sized for float32's registers, and a warp's 16 rows fed
//   each K and V fragment to a single m16 tile.  wgmma reads its operands
//   from shared memory itself, 64 rows a warpgroup.

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// bfloat16 at D in {64, 128}: FlashAttention-3's shape on Hopper.  NC
// consumer warpgroups of 64 query rows each (a block of 64 NC rows) and
// one producer warpgroup, whose first thread keeps K and V tiles of 128
// keys in flight in a ring of three stages with TMA (tensor maps built on
// the host, passed as __grid_constant__), each stage behind two "full"
// mbarriers (K's bytes landed, so S can start; V's) and an "empty" one
// (every consumer is done with it).  S = Q K^T is a wgmma.m64n128k16 with Q and K from shared
// memory (both K-major, 128-byte swizzle), P V a wgmma.m64nDk16 with P
// from registers (S's accumulator regrouped in place, rounded to
// bfloat16; the row sum takes the float32 P) and V from shared memory
// through a transposed (MN-major) descriptor.
// - Overlap inside a warpgroup: tile j's S is issued, then O is rescaled
//   and tile j - 1's P V issued behind it; the softmax of tile j runs
//   while that P V is on the tensor cores.
// - Two consumers (NC = 2) take turns (two named barriers): one issues
//   its products only after the other has issued its own, so the tensor
//   cores run one warpgroup's products while the other computes its
//   softmax.  Where two-consumer blocks would not fill the SMs (the
//   DiT's, yi-6b's and granite's prefill), a block takes one consumer and
//   64 rows, and twice the blocks spread the work, two an SM where their
//   shared memory allows (D = 64).
// - The softmax stays float32: exp2 of scores pre-scaled by scale * log2 e
//   (one FFMA before each ex2 outside the masked tiles); only tiles that
//   a mask or the ragged end reaches pay for the mask.
// - P V accumulates into O itself: the fresh accumulator per tile that
//   guards float32's 1e-5 bar (the tensor cores' accumulator does not
//   round to nearest; over 3008 keys it drifted 1e-5) is below the 2e-2
//   of bfloat16.
// - Causal query tiles launch longest first (the grid's slowest dimension
//   runs backwards over the query tiles).
// - Bound: operations at llava's prefill (the bfloat16 products at 989
//   TFLOP/s, 0.131 ms), bytes at the small shapes.  Measured on an H100
//   (PERF.md, row 2b): 0.241 ms at llava's prefill (the mma.sync kernel
//   0.93, SDPA 0.250), 0.0062-0.0069 ms at the DiT, yi-6b and granite
//   shapes (SDPA 0.0078-0.0085).
// - Tried on the card and not kept: one K and V barrier a stage, two
//   stages, no overlap inside a warpgroup and no turns (0.418 ms at
//   llava's prefill: the two consumers waited on the same tiles and ran
//   their softmax at the same time, leaving the tensor cores idle), and
//   two-consumer blocks at the small shapes (granite 0.0086 ms, slower
//   than the mma.sync kernel's 0.0083).  The library builds in 22.7 s
//   (seven sources in parallel; 11.8 s without this kernel).
namespace wg {

constexpr int kBK = 128;                   // keys a tile
constexpr int kStages = 3;
constexpr int kRow = 128;                  // bytes a swizzled row: 64 values

template <int D, int NC>
struct Smem {
  static constexpr int kBM = 64 * NC;      // query rows a block
  static constexpr int kSub = D / 64;      // 64-value slices of a row
  static constexpr int kQ = kBM * D * 2;   // bytes: kSub slices of kBM rows
  static constexpr int kKv = kBK * D * 2;  // one K or V tile
  static constexpr int kK = kQ;            // offsets from a 1024-byte base
  static constexpr int kV = kK + kStages * kKv;
  static constexpr int kBar = kV + kStages * kKv;
  static constexpr int kBytes = kBar + 128 + 1024;  // + the alignment slack
  static_assert(kBytes <= 232448, "more shared memory than a block has");
  // registers a thread: at launch (one block an SM with two consumers, two
  // with one), then the producer's and a consumer's after setmaxnreg
  static constexpr int kMinBlocks = NC == 2 ? 1 : 2;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = NC == 2 ? 232 : 216;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// a box of the 4-D map (values, head, row, batch) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// the tensor map into the cache ahead of its first copy
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// a shared-memory matrix descriptor, 128-byte swizzle: lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// 2^x on the special-function unit, denormals flushed
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, shared) B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n128(d, a, db);
}


template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), Smem<D, NC>::kMinBlocks)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ o, int sq, int sk, int heads,
                   int kv_heads, int causal, int window, int q_offset,
                   float scale) {
  using L = Smem<D, NC>;
  constexpr int kBM = L::kBM;
  extern __shared__ unsigned char raw[];
  // the swizzled tiles want 1024-byte alignment
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_k = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;
  uint64_t* qbar = empty + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // last rows first
  const int kvh = h / (heads / kv_heads);

  // the key tiles some row of the block can see (all of them where some
  // row sees none, for its uniform average)
  const int qlo = q0 + q_offset;
  const int qhi = min(q0 + kBM, sq) - 1 + q_offset;
  const bool some_row_blind = (causal && qlo < 0) ||
                              (window > 0 && qhi - window + 1 > sk - 1);
  int kmin = 0, kmax = sk - 1;
  if (!some_row_blind) {
    if (window > 0) kmin = max(0, qlo - window + 1);
    if (causal) kmax = min(sk - 1, qhi);
  }
  const int t_lo = kmin / kBK;
  const int ntiles = kmax / kBK + 1 - t_lo;

  if (threadIdx.x == 0) {
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full_k[s], 1);
      bar_init(&full_v[s], 1);
      bar_init(&empty[s], 128 * NC);
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: its first thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(L::kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      bar_expect(qbar, L::kQ);
      for (int s = 0; s < L::kSub; ++s)
        tma_load(base + s * kBM * kRow, &tq, qbar, 64 * s, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) bar_wait(&empty[st], (it / kStages - 1) & 1);
        const int k0 = (t_lo + it) * kBK;
        bar_expect(&full_k[st], L::kKv);   // K first: S may start on it
        for (int s = 0; s < L::kSub; ++s)
          tma_load(base + L::kK + st * L::kKv + s * kBK * kRow, &tk,
                   &full_k[st], 64 * s, kvh, k0, b);
        bar_expect(&full_v[st], L::kKv);
        for (int s = 0; s < L::kSub; ++s)
          tma_load(base + L::kV + st * L::kKv + s * kBK * kRow, &tv,
                   &full_v[st], 64 * s, kvh, k0, b);
      }
    }
  } else {
    // a consumer warpgroup: 64 query rows, every key tile of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(L::kConsumerRegs) : "memory");
    const int cw = (threadIdx.x - 128) / 128;
    const int wt = threadIdx.x % 128;
    const int lane = wt % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = cw * 64 + (wt / 32) * 16 + g;   // rows r0, r0 + 8
    const int pos0 = q0 + r0 + q_offset;
    const int pos1 = pos0 + 8;
    const int wlo = q0 + cw * 64 + q_offset;       // the warpgroup's rows'
    const int whi = wlo + 63;                      // first and last position
    const float sl2 = scale * kLog2e;
    const uint32_t qaddr = smem_u32(base) + cw * 64 * kRow;
    // the consumers' turns (NC = 2): consumer c waits on barrier 3 + c
    // before issuing its products and lets the other go after
    auto turn_wait = [&] {
      if constexpr (NC == 2)
        asm volatile("bar.sync %0, 256;" :: "r"(3 + cw) : "memory");
    };
    auto turn_pass = [&] {
      if constexpr (NC == 2)
        asm volatile("bar.arrive %0, 256;" :: "r"(4 - cw) : "memory");
    };
    if constexpr (NC == 2)
      if (cw == 1) asm volatile("bar.arrive 3, 256;" ::: "memory");

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m0 = kMasked, m1 = kMasked;      // running max (log2 domain)
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the sum
    float al0 = 1.f, al1 = 1.f;            // O's rescale owed to the last P
    float s[kBK / 2];                      // S, then P in float32
    uint32_t pa[kBK / 16][4];              // P in bfloat16, P V's A operand

    // S = Q K^T into s: Q's and K's 64-value slices, 16 values a step
    auto issue_s = [&](int st) {
      const uint32_t kaddr = smem_u32(base + L::kK + st * L::kKv);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(s,
                      desc(qaddr + (kk / 4) * kBM * kRow + (kk % 4) * 32, 16,
                           8 * kRow),
                      desc(kaddr + (kk / 4) * kBK * kRow + (kk % 4) * 32, 16,
                           8 * kRow),
                      kk > 0);
    };
    // O = alpha O + P V for the P in pa and the V tile of tile it
    auto issue_pv = [&](int it) {
      const int st = it % kStages;
      bar_wait(&full_v[st], (it / kStages) & 1);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= al0;
        oacc[4 * j + 1] *= al0;
        oacc[4 * j + 2] *= al1;
        oacc[4 * j + 3] *= al1;
      }
      const uint32_t vaddr = smem_u32(base + L::kV + st * L::kKv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs(oacc, pa[kk],
                 desc(vaddr + kk * 16 * kRow, kBK * kRow, 8 * kRow));
    };
    // the online softmax of tile it: s becomes P (float32), m and l move
    // on, al takes O's rescale
    auto softmax = [&](int it) {
      const int k0 = (t_lo + it) * kBK;
      const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > wlo) ||
                        (window > 0 && whi - k0 >= window);
      float tmax0 = kMasked, tmax1 = kMasked;
      if (edge) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = e < 2 ? pos0 : pos1;
            bool keep = true;
            if (causal) keep = keep && qpos >= kpos;
            if (window > 0) keep = keep && qpos - kpos < window;
            const float x = kpos < sk ? (keep ? s[4 * j + e] * sl2 : kMasked)
                                      : -CUDART_INF_F;
            s[4 * j + e] = x;
            if (e < 2) tmax0 = fmaxf(tmax0, x);
            else tmax1 = fmaxf(tmax1, x);
          }
        }
      } else {                             // the max of the raw scores
        float r0m = -CUDART_INF_F, r1m = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          r0m = fmaxf(r0m, fmaxf(s[4 * j], s[4 * j + 1]));
          r1m = fmaxf(r1m, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        tmax0 = r0m * sl2;
        tmax1 = r1m * sl2;
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
        tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
      }
      const float mn0 = fmaxf(m0, tmax0), mn1 = fmaxf(m1, tmax1);
      al0 = ex2(m0 - mn0);
      al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
      // edge tiles hold scaled scores, the others raw: p = 2^(x c - m)
      const float c = edge ? 1.f : sl2;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], c, -mn0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -mn0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -mn1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -mn1));
        ps0 += s[4 * j] + s[4 * j + 1];
        ps1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = al0 * l0 + ps0;
      l1 = al1 * l1 + ps1;
    };
    // P to bfloat16 in the A operand's order: two 8-key blocks a step
    auto pack_p = [&] {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    bar_wait(qbar, 0);
    bar_wait(&full_k[0], 0);
    turn_wait();
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    turn_pass();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    pack_p();
    for (int it = 1; it < ntiles; ++it) {
      const int st = it % kStages;
      bar_wait(&full_k[st], (it / kStages) & 1);
      turn_wait();
      wgmma_fence();
      issue_s(st);                         // tile it's S ...
      wgmma_commit();
      issue_pv(it - 1);                    // ... then tile it - 1's P V
      wgmma_commit();
      turn_pass();
      wgmma_wait<1>();                     // S has landed
      fence_regs(s);
      softmax(it);
      wgmma_wait<0>();                     // P V has landed
      fence_regs(oacc);
      bar_arrive(&empty[(it - 1) % kStages]);
      pack_p();
    }
    turn_wait();
    issue_pv(ntiles - 1);
    wgmma_commit();
    turn_pass();
    wgmma_wait<0>();
    fence_regs(oacc);
    bar_arrive(&empty[(ntiles - 1) % kStages]);
    if constexpr (NC == 2)                 // the turn consumer 1 passed last
      if (cw == 0) asm volatile("bar.sync 3, 256;" ::: "memory");

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    // the warpgroup's rows of Q are read for the last time: stage O there
    // in the same swizzle (16-byte chunk c of row r at c ^ (r % 8))
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* slice = base + (j / 8) * kBM * kRow;
      *reinterpret_cast<uint32_t*>(slice + r0 * kRow +
                                   (((j % 8) ^ (r0 % 8)) * 16) + 4 * t) =
          pack_bf16(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(slice + (r0 + 8) * kRow +
                                   (((j % 8) ^ (r0 % 8)) * 16) + 4 * t) =
          pack_bf16(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
    }
    asm volatile("bar.sync %0, 128;" :: "r"(1 + cw) : "memory");
    for (int i = wt; i < 64 * (D / 8); i += 128) {
      const int lr = i / (D / 8);
      const int j = i % (D / 8);
      const int row = q0 + cw * 64 + lr;
      if (row >= sq) continue;
      const int br = cw * 64 + lr;
      *reinterpret_cast<uint4*>(
          o + (((long long)b * sq + row) * heads + h) * D + 8 * j) =
          *reinterpret_cast<const uint4*>(base + (j / 8) * kBM * kRow +
                                          br * kRow +
                                          (((j % 8) ^ (br % 8)) * 16));
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), found through the runtime's entry-point
// lookup, so the library links against nothing new
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return e == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the 4-D map (values, head, row, batch) of a row-major (batch, rows,
// heads, D) bfloat16 tensor, in boxes of 64 values by box_rows rows
bool tensor_map(CUtensorMap* map, const void* ptr, int d, int heads,
                int rows, int batch, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)rows * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NC>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_wgmma_kernel<D, NC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Smem<D, NC>::kBytes);
}

template <int D, int NC>
cudaError_t launch_nc(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                      int batch, int sq, int sk, int heads, int kv_heads,
                      int causal, int window, int q_offset, float scale,
                      cudaStream_t s) {
  constexpr int kBM = Smem<D, NC>::kBM;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, D, heads, sq, batch, kBM) ||
      !tensor_map(&tk, k, D, kv_heads, sk, batch, kBK) ||
      !tensor_map(&tv, v, D, kv_heads, sk, batch, kBK))
    return cudaErrorInvalidValue;
  cudaError_t e = prepare<D, NC>();
  if (e != cudaSuccess) return e;
  const dim3 grid(heads, batch, (sq + kBM - 1) / kBM);
  flash_wgmma_kernel<D, NC><<<grid, 128 * (NC + 1), Smem<D, NC>::kBytes,
                              s>>>(tq, tk, tv, o, sq, sk, heads, kv_heads,
                                   causal, window, q_offset, scale);
  return cudaGetLastError();
}

// The bfloat16 kernel that a call at these shapes takes, the one place this
// is decided: 0 for the mma.sync kernel (head_dim 16 or 32), else the
// wgmma kernel's consumer warpgroups a block: two where that fills the SMs,
// else one (twice the blocks of half the rows); -1 if the card's SM count
// cannot be read.
int consumers(int batch, int sq, int heads, int head_dim) {
  if (head_dim != 64 && head_dim != 128) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return (long long)heads * batch * ((sq + 127) / 128) >= sms ? 2 : 1;
}

template <int D>
cudaError_t launch(int nc, const bf16* q, const bf16* k, const bf16* v,
                   bf16* o, int batch, int sq, int sk, int heads,
                   int kv_heads, int causal, int window, int q_offset,
                   float scale, cudaStream_t s) {
  if (nc == 2)
    return launch_nc<D, 2>(q, k, v, o, batch, sq, sk, heads, kv_heads,
                           causal, window, q_offset, scale, s);
  return launch_nc<D, 1>(q, k, v, o, batch, sq, sk, heads, kv_heads, causal,
                         window, q_offset, scale, s);
}

template <int D, int NC>
int occupancy() {
  if (prepare<D, NC>() != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_wgmma_kernel<D, NC>, 128 * (NC + 1),
          Smem<D, NC>::kBytes) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace wg


template <typename T>
int attention(const T* q, const T* k, const T* v, T* o, int batch, int sq,
              int sk, int heads, int kv_heads, int head_dim, int causal,
              int window, int q_offset, float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || sq <= 0 || sk <= 0 || kv_heads <= 0 ||
      heads <= 0 || heads > 65535 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {       // bfloat16 at D 64, 128: wgmma
    const int nc = wg::consumers(batch, sq, heads, head_dim);
    if (nc < 0) return (int)cudaErrorUnknown;
    if (nc > 0)
      return (int)(head_dim == 64
                       ? wg::launch<64>(nc, q, k, v, o, batch, sq, sk, heads,
                                        kv_heads, causal, window, q_offset,
                                        scale, s)
                       : wg::launch<128>(nc, q, k, v, o, batch, sq, sk,
                                         heads, kv_heads, causal, window,
                                         q_offset, scale, s));
  }
  switch (head_dim) {
    case 16: return (int)launch<16>(grid, s, q, k, v, o, sq, sk, heads,
                                    kv_heads, causal, window, q_offset, scale);
    case 32: return (int)launch<32>(grid, s, q, k, v, o, sq, sk, heads,
                                    kv_heads, causal, window, q_offset, scale);
    case 64:
      if constexpr (sizeof(T) == 4)
        return (int)launch<64>(grid, s, q, k, v, o, sq, sk, heads, kv_heads,
                               causal, window, q_offset, scale);
      break;
    case 128:
      if constexpr (sizeof(T) == 4)
        return (int)launch<128>(grid, s, q, k, v, o, sq, sk, heads, kv_heads,
                                causal, window, q_offset, scale);
      break;
  }
  return (int)cudaErrorInvalidValue;
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

// Which bfloat16 kernel flash_attention_bf16 launches at these shapes: 0
// for the mma.sync kernel, else the wgmma kernel's consumer warpgroups a
// block (1 or 2); -1 on error.
extern "C" int flash_attention_bf16_consumers(int batch, int sq, int heads,
                                              int head_dim) {
  return wg::consumers(batch, sq, heads, head_dim);
}

// Blocks of the bfloat16 wgmma kernel for head_dim (64 or 128) one SM holds
// at once (-1 on error).
extern "C" int flash_attention_bf16_occupancy(int head_dim) {
  switch (head_dim) {
    case 64: return wg::occupancy<64, 2>();
    case 128: return wg::occupancy<128, 2>();
    default: return -1;
  }
}
