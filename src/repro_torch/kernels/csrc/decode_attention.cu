// Single-token decode attention against a KV cache for Hopper (sm_90a),
// float32, or a bfloat16 cache with a float32 or bfloat16 query:
//
//   o[b, h] = softmax_j(scale * q[b, h] . k[b, j, h / G]) @ v[b, :, h / G]
//
// over cache positions j in [0, lengths[b]).  q and o are (B, H, D), the
// caches (B, S, KH, D), all row-major; lengths is (B,) int32; G = H / KH
// query heads share one kv head (read by index, never repeated).  A masked
// score is the finite -1e30 of the TPU kernel, so a row with length <= 0
// gets the uniform average of its S values; lengths >= S attend to all S.
//
// Replaces: src/repro/kernels/decode_attention.py :: decode_attention_pallas
//   (_decode_kernel), which casts q, k and v to float32 and writes q's
//   dtype: the bfloat16 variant reads the cache as bfloat16 (the reference's
//   default cache dtype) and q as the model's dtype, bfloat16 or, where
//   float32 parameters write a bfloat16 cache, float32.
//
// Bound: bytes.  Every cache row is read once and used for G dot products
// and G axpys of length D: 4 * G flops per 4 (bfloat16) or 8 bytes of k and
// v, far below the card's operations-per-byte balance.  At the launcher's
// shape (B = 1, a 24-row cache, 131 kB) the bytes take 0.04 us, so a call
// is bound by latency there: the launch, one round trip to memory and the
// chain of dependent steps inside a block.
//
// What held the previous design back (one template over the element
// type, a key per lane): its time did not depend on the dtype, so it was
// not bound by its bytes.  Two chains of latency bounded it.  The
// split merge ran on B * KH blocks (8 at llava's and deepseek's shapes),
// each thread walking every split twice, serially, from device memory.
// And only hpb / hpw of a block's warps computed: at a head a block the
// other three warps only copied, while the one that computed walked each
// 32-key tile in two dependent loops of D / 4 and 32 steps.
//
// Design.
// - Grid (b * KH + kh, head group, split), 4 warps a block.  The wrapper's
//   decode_grid picks splits and head groups from the shapes alone (the
//   lengths never leave the card): as many splits as fill two blocks an SM,
//   but at least two tiles a split (so short caches take one split and no
//   merge), then the G query heads of a kv head in as many groups (a
//   divisor of G) as keep the blocks within one an SM.  A split takes
//   ceil(tiles / splits) whole tiles from its start (the wrapper's
//   split_keys, passed in; the kernel only refuses keys that are not
//   whole tiles of its own or that leave a split empty).
// - Every warp computes: each staged tile of TK keys is divided between
//   the four warps, and each warp takes its own TK / 4 keys for all of the
//   block's heads, with its own running (m, l, acc).  At the end the warps'
//   partials go through shared memory and are merged in warp order with
//   the log-sum-exp rule; a warp whose keys all lie past the end adds
//   nothing (l = 0).
// - Staging: a ring of three stages of K and V tiles through cp.async, 16
//   bytes a thread, two tiles in flight while one is computed; q and the
//   first two tiles are copied before lengths[b] is read, so that round
//   trip overlaps theirs.  A tile's rows past the split's end are
//   zero-filled by the copy, and V rows past the length that the first
//   copies brought in are zeroed by the thread that copied them, so every
//   row a product reads is finite: a weight of 0 never meets a NaN.
// - bfloat16 q over a bfloat16 cache: the tensor cores.  Tiles of 64 keys,
//   16 a warp.  S = Q K^T and O = P V are mma.sync m16n8k16 in bfloat16
//   with float32 accumulators; the block's query heads (at most 8) are the
//   A operand's rows 0-7 (rows 8-15 zero), Q's fragments held in registers
//   for the whole loop.  K's B fragments come through ldmatrix and V's
//   through ldmatrix.trans, from rows D + 8 values apart (each 8-row
//   matrix read lands on 8 distinct 16-byte bank groups).  S's accumulator
//   is P's A operand in place (keys 2t, 2t + 1 and 2t + 8, 2t + 9 of the
//   warp's 16), rounded to bfloat16 for the product, while the row sum l
//   takes the float32 P.  Scores, max, sum and the partials stay float32;
//   the output is rounded once.
// - float32 q (over a float32 or a bfloat16 cache): the CUDA cores, within
//   1e-5 of the plain version.  Tiles of 32 keys, 8 a warp, four lanes a
//   key: lane (key kk = lane % 8, part pp = lane / 8) forms the dot
//   products of its quarter of the row with float4 reads of K (rows D + 4
//   floats apart, so the 8 lanes of a quarter warp read 8 distinct bank
//   groups) and broadcast reads of q, for all of the block's heads (HPB, a
//   power of two, compiled), then two shuffles join the quarters.  P goes
//   to shared memory as [key][head]; in P V lane (key group, dl) owns dims
//   4 dl .. 4 dl + 3 and takes 128 / D of the warp's keys at a time.  A
//   float32 query over a bfloat16 cache stays here: rounded to bfloat16
//   for the tensor cores it would miss 1e-5.
// - The merge of the splits (splits > 1): one warp per (b, query head),
//   its lanes covering D.  Each split's (m, l) is read once into a lane's
//   registers, the maximum and the sum taken with shuffles in a fixed
//   order; the accumulators of 32 splits are read at once, with (m, l),
//   and summed in split order.  It is launched as a programmatic
//   dependent of the split kernel, so its launch overlaps the split
//   kernel's last blocks.  No floating atomics: a second call gives the
//   same bits.
// - Online softmax in float32, masked scores at -1e30, keys past the end
//   at -inf (weight 0), l clamped at 1e-30, as in the TPU kernel.
// - Measured on an H100 (PERF.md, row 3 / 3b): the merge took 0.079 of
//   0.094 ms at llava's G=7 and 0.091 of 0.106 at deepseek's G=8 in the
//   previous design; here the two kernels take 0.007 + 0.002 ms in
//   bfloat16 (0.013 ms a call) and the split kernel moves B=8, S=4096's
//   float32 cache at 95% of the memory rate.
// - Tried on the card and not kept: a merge warp whose lanes walked the
//   splits four scalar loads at a time (8.4-8.5 us at llava's and
//   deepseek's shapes, where reading every split at once takes 2.0-2.3).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarp = 32;
constexpr int kWarps = 4;                  // warps a block, all computing
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxG = 8;                   // query heads per kv head
constexpr int kStages = 3;                 // stages of the copy ring
constexpr int kMergeWarps = 4;             // warps a block of the merge
constexpr int kMaxSplits = 4 * kWarp;      // the merge's (m, l) registers
constexpr float kMasked = -1e30f;

// The shared memory of a block.  TC: the tensor-core path (bfloat16 q and
// cache); else the CUDA cores.  T: the cache's element type.
template <int D, typename T, bool TC>
struct Smem {
  static constexpr int TK = TC ? 64 : 32;             // keys a tile
  static constexpr int KPW = TK / kWarps;             // keys a warp
  static constexpr int E = 16 / sizeof(T);            // values in 16 bytes
  static constexpr int LDK = TC || sizeof(T) == 2 ? D + 8 : D + 4;
  static constexpr int LDV = TC ? D + 8 : D;
  // q of the block's heads (float32; bfloat16 on the tensor cores), then
  // the warps' p as [warp][key][head], then the ring
  static constexpr int kQBytes = kMaxG * D * 4;
  static constexpr int kPBytes = TC ? 0 : kWarps * KPW * kMaxG * 4;
  static constexpr int kStage = TK * (LDK + LDV);       // values of T
  static constexpr int kRing = kQBytes + kPBytes;        // byte offset
  static constexpr int kBytes = kRing + kStages * kStage * (int)sizeof(T);
  // after the loop the ring holds the warps' partials for the merge
  static constexpr int kMergeBytes = kWarps * kMaxG * (D + 2) * 4;
  static_assert(kMergeBytes <= kStages * kStage * (int)sizeof(T),
                "the merge buffer must fit in the ring");
};

// four consecutive values as float32: one 16-byte read of floats, one
// 8-byte read of bfloat16
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(pair[0]);
  const float2 b = __bfloat1622float2(pair[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zero-filled unless valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// two floats rounded to bfloat16, lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b, bfloat16 operands, a's rows 8-15 zero (a1 = a3 = 0)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// keys [t0, t0 + TK) of one (b, kv head) into a stage: rows >= end are
// zero-filled, and a tile that starts at or past end is not copied
template <int D, typename T, bool TC>
__device__ __forceinline__ void load_tile(T* sk, T* sv, const T* kb,
                                          const T* vb, long long key_stride,
                                          int t0, int end) {
  using L = Smem<D, T, TC>;
  constexpr int CPR = D / L::E;            // 16-byte chunks a row
  if (t0 >= end) return;
#pragma unroll 4
  for (int i = threadIdx.x; i < L::TK * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = (i % CPR) * L::E;
    const bool valid = t0 + r < end;
    const long long off = valid ? (long long)(t0 + r) * key_stride + c : 0;
    cp_async16(sk + r * L::LDK + c, kb + off, valid);
    cp_async16(sv + r * L::LDV + c, vb + off, valid);
  }
}

// the V rows in [k1, end) of a tile copied before the length was known,
// zeroed by the threads that copied them (after their own copies landed)
template <int D, typename T, bool TC>
__device__ __forceinline__ void zero_past(T* sv, int t0, int k1, int end) {
  using L = Smem<D, T, TC>;
  constexpr int CPR = D / L::E;
  if (t0 >= end || t0 + L::TK <= k1) return;
#pragma unroll 4
  for (int i = threadIdx.x; i < L::TK * CPR; i += kThreads) {
    const int r = i / CPR;
    if (t0 + r >= k1 && t0 + r < end)
      *reinterpret_cast<uint4*>(sv + r * L::LDV + (i % CPR) * L::E) =
          make_uint4(0, 0, 0, 0);
  }
}

// HPB: the block's query heads rounded up to a power of two (the CUDA-core
// path's registers; the tensor-core path takes up to 8 at run time).
// TQ: q's and o's type, TKV: the caches'; TC: bfloat16 q and cache on the
// tensor cores.
template <int D, int HPB, bool TC, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int* __restrict__ lengths,
              TQ* __restrict__ o, float* __restrict__ ws_acc,
              float* __restrict__ ws_ml, int seq, int heads, int kv_heads,
              int G, int hpb, int splits, int chunk, float scale) {
  using L = Smem<D, TKV, TC>;
  constexpr int TK = L::TK;
  constexpr int KPW = L::KPW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sp = reinterpret_cast<float*>(smem + L::kQBytes);
  TKV* ring = reinterpret_cast<TKV*>(smem + L::kRing);

  const int pair = blockIdx.x;             // b * KH + kh
  const int b = pair / kv_heads;
  const int kh = pair % kv_heads;
  const int g0 = blockIdx.y * hpb;         // the block's first head in G
  const int split = blockIdx.z;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int wk0 = warp * KPW;              // the warp's keys in a tile

  // q, and the split's first tiles before the length is known
  const int k0 = split * chunk;
  const int end0 = min(k0 + chunk, seq);
  const long long q_off = ((long long)b * heads + (long long)kh * G + g0) * D;
  {
    constexpr int QE = 16 / sizeof(TQ);
    TQ* sq = reinterpret_cast<TQ*>(smem);
    for (int i = threadIdx.x; i < hpb * D / QE; i += kThreads)
      cp_async16(sq + i * QE, q + q_off + i * QE, true);
    if constexpr (!TC)                     // heads hpb .. HPB - 1 read 0
      for (int i = hpb * D + threadIdx.x; i < HPB * D; i += kThreads)
        reinterpret_cast<float*>(smem)[i] = 0.f;
  }
  const long long key_stride = (long long)kv_heads * D;
  const long long base = ((long long)b * seq * kv_heads + kh) * D;
  const TKV* kb = k + base;
  const TKV* vb = v + base;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    TKV* s = ring + st * L::kStage;
    load_tile<D, TKV, TC>(s, s + TK * L::LDK, kb, vb, key_stride,
                          k0 + st * TK, end0);
    cp_async_commit();
  }

  const int len = lengths[b];
  const bool masked_all = len <= 0;
  const int n = masked_all ? seq : min(len, seq);
  const int k1 = min(end0, n);
  const int ntiles = k1 > k0 ? (k1 - k0 + TK - 1) / TK : 0;

  // the CUDA cores: lane (key kk, quarter pp) scores; (key group, dl) in
  // P V.  The tensor cores: (g, t) of the mma fragments.
  constexpr int DL = D / 4;
  constexpr int KG = kWarp / DL;
  const int kk = lane % 8, pp = lane / 8;
  const int kg = lane / DL, dl = lane % DL;
  const int g = lane / 4, t = lane % 4;

  float m[TC ? 1 : HPB], l[TC ? 1 : HPB];
  float4 acc[TC ? 1 : HPB];
  float oacc[TC ? D / 8 : 1][4];
  uint32_t qa[TC ? D / 16 : 1][2];
#pragma unroll
  for (int h = 0; h < (TC ? 1 : HPB); ++h) {
    m[h] = -CUDART_INF_F;
    l[h] = 0.f;
    acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if constexpr (TC) {
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
      for (int i = 0; i < 4; ++i) oacc[n8][i] = 0.f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = k0 + tile * TK;
    TKV* sk = ring + (tile % kStages) * L::kStage;
    TKV* sv = sk + TK * L::LDK;
    cp_async_wait<kStages - 2>();          // this tile's copies have landed
    if (tile < kStages - 1) zero_past<D, TKV, TC>(sv, t0, k1, end0);
    __syncthreads();                       // ... for every thread, and the
    {                                      // tile before is done with
      const int ahead = tile + kStages - 1;
      TKV* s = ring + (ahead % kStages) * L::kStage;
      load_tile<D, TKV, TC>(s, s + TK * L::LDK, kb, vb, key_stride,
                            k0 + ahead * TK, k1);
      cp_async_commit();
    }
    if constexpr (TC) {
      if (tile == 0) {                     // Q's fragments, once
        const bf16* sq = reinterpret_cast<const bf16*>(smem) + g * D + 2 * t;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          qa[c][0] = g < hpb ? *reinterpret_cast<const uint32_t*>(
                                   sq + c * 16) : 0u;
          qa[c][1] = g < hpb ? *reinterpret_cast<const uint32_t*>(
                                   sq + c * 16 + 8) : 0u;
        }
      }
    }
    const int nk = min(TK, k1 - t0);
    if (wk0 >= nk) continue;               // warp-uniform: no key here

    if constexpr (TC) {
      // S = Q K^T over the warp's 16 keys: s[nb] holds keys nb*8 + 2t, +1
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int mat = lane / 8, row = lane % 8;
      const TKV* kr = sk + (wk0 + (mat / 2) * 8 + row) * L::LDK +
                      (mat % 2) * 8;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t r[4];
        ldmatrix_x4(r, kr + c * 16);
        mma_bf16(s[0], qa[c][0], qa[c][1], r[0], r[1]);
        mma_bf16(s[1], qa[c][0], qa[c][1], r[2], r[3]);
      }
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = wk0 + nb * 8 + 2 * t + e < nk;
          const float x = valid ? (masked_all ? kMasked : s[nb][e] * scale)
                                : -CUDART_INF_F;
          s[nb][e] = x;
          tmax = fmaxf(tmax, x);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mx = fmaxf(m[0], tmax);  // finite: key wk0 is valid
      const float alpha = expf(m[0] - mx);
      float ps = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nb][e] = expf(s[nb][e] - mx);
          ps += s[nb][e];
        }
      l[0] = l[0] * alpha + ps;
      m[0] = mx;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        oacc[n8][0] *= alpha;
        oacc[n8][1] *= alpha;
      }
      // O += P V: P's A fragment is S's accumulator, V's B fragments come
      // transposed, two 8-feature blocks a load
      const uint32_t a0 = pack_bf16(s[0][0], s[0][1]);
      const uint32_t a2 = pack_bf16(s[1][0], s[1][1]);
      const TKV* vr = sv + (wk0 + (mat % 2) * 8 + row) * L::LDV +
                      (mat / 2) * 8;
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vr + np * 16);
        mma_bf16(oacc[2 * np], a0, a2, r[0], r[1]);
        mma_bf16(oacc[2 * np + 1], a0, a2, r[2], r[3]);
      }
    } else {
      // scores: lane (kk, pp) takes quarter pp of key kk's row for every
      // head, then two shuffles join the quarters
      constexpr int DP = D / 4;            // dims a quarter
      const TKV* kr = sk + (wk0 + kk) * L::LDK + pp * DP;
      const float* qp = reinterpret_cast<const float*>(smem) + pp * DP;
      float4 dot[HPB];
#pragma unroll
      for (int h = 0; h < HPB; ++h) dot[h] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        const float4 kv = load4(kr + 4 * c);
#pragma unroll
        for (int h = 0; h < HPB; ++h) {
          const float4 qv = *reinterpret_cast<const float4*>(qp + h * D +
                                                             4 * c);
          dot[h].x += qv.x * kv.x;
          dot[h].y += qv.y * kv.y;
          dot[h].z += qv.z * kv.z;
          dot[h].w += qv.w * kv.w;
        }
      }
      const bool valid = wk0 + kk < nk;
      float* spw = sp + warp * KPW * kMaxG;
#pragma unroll
      for (int h = 0; h < HPB; ++h) {
        float sc = (dot[h].x + dot[h].y) + (dot[h].z + dot[h].w);
        sc += __shfl_xor_sync(0xffffffffu, sc, 8);
        sc += __shfl_xor_sync(0xffffffffu, sc, 16);
        sc = valid ? (masked_all ? kMasked : sc * scale) : -CUDART_INF_F;
        float tmax = sc;
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
        const float mx = fmaxf(m[h], tmax);  // finite: key wk0 is valid
        const float alpha = expf(m[h] - mx);
        const float p = expf(sc - mx);       // 0 for a key past the end
        l[h] = l[h] * alpha + p;
        acc[h].x *= alpha;
        acc[h].y *= alpha;
        acc[h].z *= alpha;
        acc[h].w *= alpha;
        m[h] = mx;
        if (pp == 0) spw[kk * kMaxG + h] = p;
      }
      __syncwarp();
      // P V: KG keys at a time, every row finite (zero past the end)
      const TKV* vw = sv + wk0 * L::LDV + 4 * dl;
#pragma unroll
      for (int j = 0; j < KPW; j += KG) {
        const int jj = j + kg;
        const float4 vv = load4(vw + jj * L::LDV);
        float pj[HPB];
        if constexpr (HPB >= 4) {
#pragma unroll
          for (int h = 0; h < HPB; h += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                spw + jj * kMaxG + h);
            pj[h] = p4.x;
            pj[h + 1] = p4.y;
            pj[h + 2] = p4.z;
            pj[h + 3] = p4.w;
          }
        } else {
#pragma unroll
          for (int h = 0; h < HPB; ++h) pj[h] = spw[jj * kMaxG + h];
        }
#pragma unroll
        for (int h = 0; h < HPB; ++h) {
          acc[h].x += pj[h] * vv.x;
          acc[h].y += pj[h] * vv.y;
          acc[h].z += pj[h] * vv.z;
          acc[h].w += pj[h] * vv.w;
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free

  // each warp's partials into the ring: acc [warp][head][D], then (m, l)
  float* macc = reinterpret_cast<float*>(ring);
  float* mml = macc + kWarps * kMaxG * D;
  if constexpr (TC) {
    float ls = l[0];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    if (g < hpb) {
      float* dst = macc + (warp * kMaxG + g) * D + 2 * t;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        *reinterpret_cast<float2*>(dst + n8 * 8) =
            make_float2(oacc[n8][0], oacc[n8][1]);
      if (t == 0) {
        mml[2 * (warp * kMaxG + g)] = m[0];
        mml[2 * (warp * kMaxG + g) + 1] = ls;
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < HPB; ++h) {
      // the key groups' sums, then the keys' running sums, fixed order
#pragma unroll
      for (int off = DL; off < kWarp; off <<= 1) {
        acc[h].x += __shfl_xor_sync(0xffffffffu, acc[h].x, off);
        acc[h].y += __shfl_xor_sync(0xffffffffu, acc[h].y, off);
        acc[h].z += __shfl_xor_sync(0xffffffffu, acc[h].z, off);
        acc[h].w += __shfl_xor_sync(0xffffffffu, acc[h].w, off);
      }
      float ls = l[h];
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      ls += __shfl_xor_sync(0xffffffffu, ls, 4);
      if (h < hpb) {
        if (kg == 0)
          *reinterpret_cast<float4*>(macc + (warp * kMaxG + h) * D + 4 * dl) =
              acc[h];
        if (lane == 0) {
          mml[2 * (warp * kMaxG + h)] = m[h];
          mml[2 * (warp * kMaxG + h) + 1] = ls;
        }
      }
    }
  }
  __syncthreads();

  // the warps' partials merged in warp order: the output, or the split's
  // partial (acc, m, l) per head for the merge kernel
  for (int idx = threadIdx.x; idx < hpb * D; idx += kThreads) {
    const int h = idx / D;
    const int d = idx % D;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (mml[2 * (w * kMaxG + h) + 1] > 0.f)
        mx = fmaxf(mx, mml[2 * (w * kMaxG + h)]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = mml[2 * (w * kMaxG + h) + 1];
      if (lw > 0.f) {
        const float e = expf(mml[2 * (w * kMaxG + h)] - mx);
        ls += lw * e;
        a += macc[(w * kMaxG + h) * D + d] * e;
      }
    }
    const int gh = g0 + h;
    if (splits == 1) {
      narrow(o + ((long long)b * heads + (long long)kh * G + gh) * D + d,
             a / fmaxf(ls, 1e-30f));
    } else {
      const long long ws = ((long long)pair * splits + split) * G + gh;
      ws_acc[ws * D + d] = a;
      if (d == 0) {
        ws_ml[2 * ws] = mx;
        ws_ml[2 * ws + 1] = ls;
      }
    }
  }
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// The splits of one (b, query head) merged by a warp.  Lane s % 32 reads
// split s's (m, l) once; the lanes cover D four values at a time (LPD
// lanes a row, SPL rows side by side), each lane taking every SPL-th split
// of a chunk of 32 with all its loads issued before the first is used,
// so a chunk costs one round trip to memory.  The lanes' sums and the row
// groups' partial sums are added in a fixed order: the same bits on every
// call.
template <int D, typename TQ>
__global__ void __launch_bounds__(kMergeWarps * kWarp)
merge_kernel(const float* __restrict__ ws_acc,
             const float* __restrict__ ws_ml, TQ* __restrict__ o, int rows,
             int heads, int kv_heads, int G, int splits) {
  constexpr int R = kMaxSplits / kWarp;
  constexpr int LPD = D / 4;               // lanes a row of D
  constexpr int SPL = kWarp / LPD;         // rows a pass
  constexpr int NS = kWarp / SPL;          // splits a lane takes of 32
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / kWarp;
  if (row >= rows) return;                 // warp-uniform
  const int lane = threadIdx.x % kWarp;
  const int part = lane / LPD;
  const int dl = lane % LPD;
  const int b = row / heads;
  const int h = row % heads;
  const long long first =
      ((long long)(b * kv_heads + h / G) * splits) * G + h % G;
  // launched early (programmatic dependent launch): wait for the split
  // kernel's partials
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float ms[R], ls[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = r * kWarp + lane;
    const bool valid = s < splits;
    const long long ws = first + (long long)(valid ? s : 0) * G;
    ms[r] = valid ? ws_ml[2 * ws] : -CUDART_INF_F;
    ls[r] = valid ? ws_ml[2 * ws + 1] : 0.f;
  }
  // the first chunk's accumulators are in flight with (m, l)
  float4 x[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int s = part + SPL * i;
    x[i] = s < splits ? *reinterpret_cast<const float4*>(
                            ws_acc + (first + (long long)s * G) * D + 4 * dl)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (ls[r] > 0.f) mx = fmaxf(mx, ms[r]);
  mx = warp_max(mx);
  float lsum = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r * kWarp >= splits) break;
    if (r > 0) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int s = r * kWarp + part + SPL * i;
        x[i] = s < splits
                   ? *reinterpret_cast<const float4*>(
                         ws_acc + (first + (long long)s * G) * D + 4 * dl)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    const float w = ls[r] > 0.f ? expf(ms[r] - mx) : 0.f;
    lsum += ls[r] * w;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float wi = __shfl_sync(0xffffffffu, w, part + SPL * i);
      a.x += wi * x[i].x;
      a.y += wi * x[i].y;
      a.z += wi * x[i].z;
      a.w += wi * x[i].w;
    }
  }
#pragma unroll
  for (int off = LPD; off < kWarp; off <<= 1) {
    a.x += __shfl_xor_sync(0xffffffffu, a.x, off);
    a.y += __shfl_xor_sync(0xffffffffu, a.y, off);
    a.z += __shfl_xor_sync(0xffffffffu, a.z, off);
    a.w += __shfl_xor_sync(0xffffffffu, a.w, off);
  }
  lsum = warp_sum(lsum);
  if (part != 0) return;
  const float inv = 1.0f / fmaxf(lsum, 1e-30f);
  TQ* dst = o + (long long)row * D + 4 * dl;
  narrow(dst, a.x * inv);
  narrow(dst + 1, a.y * inv);
  narrow(dst + 2, a.z * inv);
  narrow(dst + 3, a.w * inv);
}

template <int D, int HPB, bool TC, typename TQ, typename TKV>
cudaError_t launch(dim3 grid, cudaStream_t s, const TQ* q, const TKV* k,
                   const TKV* v, const int* lengths, TQ* o, float* ws_acc,
                   float* ws_ml, int seq, int heads, int kv_heads, int G,
                   int hpb, int splits, int chunk, float scale) {
  constexpr int bytes = Smem<D, TKV, TC>::kBytes;
  // above 48 kB, dynamic shared memory must be asked for (per device)
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<D, HPB, TC, TQ, TKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  decode_kernel<D, HPB, TC, TQ, TKV><<<grid, kThreads, bytes, s>>>(
      q, k, v, lengths, o, ws_acc, ws_ml, seq, heads, kv_heads, G, hpb,
      splits, chunk, scale);
  return cudaGetLastError();
}

template <int D, int HPB, bool TC, typename TKV>
int occupancy() {
  using TQ = typename std::conditional<TC, bf16, float>::type;
  constexpr int bytes = Smem<D, TKV, TC>::kBytes;
  if (cudaFuncSetAttribute(decode_kernel<D, HPB, TC, TQ, TKV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, decode_kernel<D, HPB, TC, TQ, TKV>, kThreads, bytes) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// the kernel for head width D: the tensor cores for bfloat16 q over a
// bfloat16 cache, else the CUDA cores with the block's heads rounded up to
// a power of two
template <int D, typename TQ, typename TKV>
cudaError_t launch_d(dim3 grid, cudaStream_t s, const TQ* q, const TKV* k,
                     const TKV* v, const int* lengths, TQ* o, float* ws_acc,
                     float* ws_ml, int seq, int heads, int kv_heads, int G,
                     int hpb, int splits, int chunk, float scale) {
  if constexpr (sizeof(TQ) == 2) {
    return launch<D, kMaxG, true>(grid, s, q, k, v, lengths, o, ws_acc,
                                  ws_ml, seq, heads, kv_heads, G, hpb,
                                  splits, chunk, scale);
  } else {
#define REPRO_DECODE_HPB(N)                                                   \
  if (hpb <= N)                                                               \
    return launch<D, N, false>(grid, s, q, k, v, lengths, o, ws_acc, ws_ml,   \
                               seq, heads, kv_heads, G, hpb, splits, chunk,   \
                               scale);
    REPRO_DECODE_HPB(1)
    REPRO_DECODE_HPB(2)
    REPRO_DECODE_HPB(4)
    REPRO_DECODE_HPB(8)
#undef REPRO_DECODE_HPB
    return cudaErrorInvalidValue;
  }
}

// both variants' launch: the split kernel, then (splits > 1) the merge
template <typename TQ, typename TKV>
int decode(const TQ* q, const TKV* k, const TKV* v, const int* lengths,
           TQ* o, float* ws_acc, float* ws_ml, int batch, int seq, int heads,
           int kv_heads, int head_dim, int splits, int head_groups,
           int chunk, float scale, void* stream) {
  // the split's keys come from the wrapper; they must be whole tiles of
  // this kernel's and leave no split empty
  const int tk = sizeof(TQ) == 2 ? Smem<16, bf16, true>::TK
                                 : Smem<16, TKV, false>::TK;
  if (batch <= 0 || seq <= 0 || kv_heads <= 0 || heads <= 0 ||
      heads % kv_heads != 0 || heads / kv_heads > kMaxG || splits < 1 ||
      splits > kMaxSplits || head_groups < 1 ||
      (heads / kv_heads) % head_groups != 0 || chunk <= 0 ||
      chunk % tk != 0 || (long long)(splits - 1) * chunk >= seq ||
      (long long)splits * chunk < seq ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = heads / kv_heads;
  const int hpb = G / head_groups;               // heads a block takes
  const dim3 grid(batch * kv_heads, head_groups, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
#define REPRO_DECODE_LAUNCH(DIM)                                              \
  case DIM:                                                                   \
    err = launch_d<DIM>(grid, s, q, k, v, lengths, o, ws_acc, ws_ml, seq,     \
                        heads, kv_heads, G, hpb, splits, chunk, scale);       \
    break;
    REPRO_DECODE_LAUNCH(16)
    REPRO_DECODE_LAUNCH(32)
    REPRO_DECODE_LAUNCH(64)
    REPRO_DECODE_LAUNCH(128)
#undef REPRO_DECODE_LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  // the merge may launch while the split kernel's last blocks run; it
  // waits for their results (griddepcontrol.wait) before reading them
  const int rows = batch * heads;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kMergeWarps - 1) / kMergeWarps);
  cfg.blockDim = dim3(kMergeWarps * kWarp);
  cfg.stream = s;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  switch (head_dim) {
#define REPRO_DECODE_MERGE(DIM)                                               \
  case DIM:                                                                   \
    err = cudaLaunchKernelEx(&cfg, merge_kernel<DIM, TQ>, ws_acc, ws_ml, o,   \
                             rows, heads, kv_heads, G, splits);               \
    break;
    REPRO_DECODE_MERGE(16)
    REPRO_DECODE_MERGE(32)
    REPRO_DECODE_MERGE(64)
    REPRO_DECODE_MERGE(128)
#undef REPRO_DECODE_MERGE
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// head_dim in {16, 32, 64, 128}; heads % kv_heads == 0 with at most 8 query
// heads per kv head; head_groups divides heads / kv_heads; seq >= 1;
// batch * kv_heads < 2^31, head_groups <= 65535, splits <= 128 (the
// wrapper's decode_grid).  Split s takes keys [s * chunk, (s + 1) * chunk):
// chunk a multiple of the kernel's tile of TK keys (64 for bfloat16 q over
// a bfloat16 cache, else 32), (splits - 1) * chunk < seq <= splits * chunk
// (the wrapper's split_keys); other values are refused.
// With splits > 1, ws_acc holds batch * kv_heads * splits * (heads /
// kv_heads) * head_dim floats and ws_ml twice batch * kv_heads * splits *
// (heads / kv_heads).  All pointers 16-byte aligned.  Returns
// cudaGetLastError() after the launches.
extern "C" int decode_attention_f32(const float* q, const float* k,
                                    const float* v, const int* lengths,
                                    float* o, float* ws_acc, float* ws_ml,
                                    int batch, int seq, int heads,
                                    int kv_heads, int head_dim, int splits,
                                    int head_groups, int chunk, float scale,
                                    void* stream) {
  return decode<float, float>(q, k, v, lengths, o, ws_acc, ws_ml, batch, seq,
                              heads, kv_heads, head_dim, splits, head_groups,
                              chunk, scale, stream);
}

// The caches bfloat16, q and o bfloat16 (q_bf16 = 1, the tensor cores) or
// float32 (0, the CUDA cores), the workspaces float32; otherwise as
// decode_attention_f32 (the caches' rows then need 16-byte alignment,
// which head_dim >= 16 gives a contiguous cache that starts on 16 bytes).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const int* lengths,
                                     void* o, float* ws_acc, float* ws_ml,
                                     int batch, int seq, int heads,
                                     int kv_heads, int head_dim, int splits,
                                     int head_groups, int chunk, int q_bf16,
                                     float scale, void* stream) {
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  if (q_bf16)
    return decode<bf16, bf16>(static_cast<const bf16*>(q), kb, vb, lengths,
                              static_cast<bf16*>(o), ws_acc, ws_ml, batch,
                              seq, heads, kv_heads, head_dim, splits,
                              head_groups, chunk, scale, stream);
  return decode<float, bf16>(static_cast<const float*>(q), kb, vb, lengths,
                             static_cast<float*>(o), ws_acc, ws_ml, batch,
                             seq, heads, kv_heads, head_dim, splits,
                             head_groups, chunk, scale, stream);
}

// Blocks of the kernel for head_dim one SM holds at once (-1 on error):
// the CUDA-core kernel over a float32 cache with 8 heads a block
// (tensor_cores = 0), or the tensor-core kernel (1).
extern "C" int decode_attention_occupancy(int head_dim, int tensor_cores) {
  switch (head_dim * 2 + (tensor_cores != 0)) {
    case 32: return occupancy<16, kMaxG, false, float>();
    case 33: return occupancy<16, kMaxG, true, bf16>();
    case 64: return occupancy<32, kMaxG, false, float>();
    case 65: return occupancy<32, kMaxG, true, bf16>();
    case 128: return occupancy<64, kMaxG, false, float>();
    case 129: return occupancy<64, kMaxG, true, bf16>();
    case 256: return occupancy<128, kMaxG, false, float>();
    case 257: return occupancy<128, kMaxG, true, bf16>();
    default: return -1;
  }
}
