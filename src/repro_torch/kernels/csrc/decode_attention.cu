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
// and G axpys of length D: 4 * G flops per 8 bytes of k and v, far below
// the card's float32 operations-per-byte balance.  At the launcher's shape
// (B = 1, a 24-row cache, 131 kB) the bytes take 0.04 us, so a call is
// bound by latency there: the launch, one round trip to memory and the
// chain of dependent steps inside a block.
//
// Design.  The first port (one block per (b, kv head, split), a 32-lane
// shuffle butterfly per key and head, loads issued only at the top of each
// 4-key step) launched 4 blocks at the launcher's shape and reached a
// third of the memory rate on long caches.  Here:
// - Grid (b * KH + kh, head group, split).  The wrapper's decode_grid
//   picks both from the shapes alone (the lengths never leave the card):
//   splits = min(2 blocks an SM / (B * KH), floor(S / 64)), then the G
//   query heads of a kv head go into as many groups (a divisor of G) as
//   keep the blocks within one an SM.  At the launcher's B = 1, KH = 4,
//   S = 24: 1 split, 8 groups of one head: 32 blocks (was 4).  At B = 8,
//   S = 4096: 8 splits of 512 keys, 1 group: 256 blocks, each tile read
//   once from device memory for all 8 heads.  With one split the kernel
//   writes the output itself; with more, each split leaves a partial
//   (acc, m, l) per head and a second kernel merges the splits in split
//   order with the log-sum-exp rule, so the result does not depend on
//   scheduling (no atomics).
// - Staging: tiles of 32 keys of K and V go to shared memory through
//   cp.async, 16 bytes a thread, in a ring of two stages (one where the
//   split is one tile): the next tile's copy is in flight while the
//   current one is scored.  A block has at least four warps, and all of
//   them copy, whether or not they compute.  q and the split's first tile
//   are copied before lengths[b] is read, so that round trip overlaps
//   theirs.  Rows past the split's valid end are not copied and never
//   weighed (scores past the end are -inf by a select, and their V rows
//   are not read), so garbage there cannot leak in.  K rows are D + 4
//   floats apart, so a key per lane reading the same 16 bytes of its row
//   hits 8 distinct 4-bank groups per quarter warp; V rows are read along
//   the row and need no pad.
// - Scoring: a key per lane.  A warp takes two query heads where the
//   block's head count is even, else one, and each lane forms its key's
//   dot products from its K row and q (a broadcast read); one max and the
//   exponentials per tile and head, the running sum kept per lane and
//   summed once at the end.
// - P V: p goes to the warp's slice of shared memory as [key][head], so a
//   key's weights for both heads are one 8-byte broadcast read; lane (key
//   group, dl) owns dims 4 dl .. 4 dl + 3 (a float4) and takes 128 / D of
//   the tile's keys at a time (one at D = 128); the key groups' sums are
//   added by a butterfly at the end.
// - Tried on the card and not kept (PERF.md): three blocks an SM or a
//   three-stage ring for long caches (no faster), four heads a warp or
//   one (slower at B = 8, S = 4096).
// - Online softmax in float32, masked scores at -1e30, keys past the end
//   at -inf (weight 0), l clamped at 1e-30, as in the TPU kernel.
// - bfloat16: the same kernel over the cache's element type.  Its tiles
//   come through the same cp.async ring at half the bytes (K rows D + 8
//   values apart, so every row still starts on 16 bytes), and every value
//   is widened to float32 as it is read: q once, into shared memory, K and
//   V four at a time (8 bytes) in place of a float4.  Scores, max, sum and
//   the P V accumulator stay float32 (so do the splits' partials); the
//   output is rounded once to q's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarp = 32;
constexpr int kTile = 32;          // keys per tile: one per lane
constexpr int kMaxG = 8;           // query heads per kv head
constexpr int kMaxWarps = kMaxG;   // a warp takes at least one head
constexpr int kMinWarps = 4;       // warps that share the copies
constexpr int kMaxHpw = 2;         // query heads a warp takes
constexpr int kCombineThreads = 128;
constexpr float kMasked = -1e30f;

// shared memory of a block: q and p in float32 (kHead floats), then the
// ring's stages of K and V tiles in the cache's type T
template <int D, typename T>
struct Smem {
  static constexpr int LDK = D + 16 / sizeof(T);  // K row stride, values
  static constexpr int LDV = D;                   // V row stride
  static constexpr int kQ = kMaxG * D;            // q of the block's heads
  static constexpr int kP = kTile * kMaxHpw;      // a warp's p, [key][head]
  static constexpr int kHead = kQ + kMaxWarps * kP;
  static constexpr int kStage = kTile * (LDK + LDV);   // values of T
  // q, p and the ring's stages (one or two tiles)
  static constexpr int bytes(int stages) {
    return kHead * 4 + stages * kStage * (int)sizeof(T);
  }
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

// four values from float32, rounded once to the output's type
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes from global to shared, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src));
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

// keys [t0, min(t0 + kTile, end)) of one (b, kv head) into a stage; the
// rows past end are left as they are (the kernel never weighs them)
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* sk, T* sv, const T* kb,
                                          const T* vb, long long key_stride,
                                          int t0, int end) {
  using L = Smem<D, T>;
  constexpr int E = 16 / sizeof(T);        // values a 16-byte copy moves
  const int rows = min(kTile, end - t0);
  for (int i = threadIdx.x; i < rows * (D / E); i += blockDim.x) {
    const int r = i / (D / E);
    const int c = (i % (D / E)) * E;
    const long long off = (long long)(t0 + r) * key_stride + c;
    cp_async16(sk + r * L::LDK + c, kb + off);
    cp_async16(sv + r * L::LDV + c, vb + off);
  }
}

// HPW: query heads a warp takes; warps [0, hpb / HPW) compute, and every
// warp of the block (at least kMinWarps) shares the copies.  TQ: q's and
// o's type, TKV: the caches' (float, or bfloat16 with q in either)
template <int D, int HPW, typename TQ, typename TKV>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int* __restrict__ lengths,
              TQ* __restrict__ o, float* __restrict__ ws_acc,
              float* __restrict__ ws_ml, int seq, int heads, int kv_heads,
              int G, int hpb, int splits, int chunk, int stages,
              float scale) {
  using L = Smem<D, TKV>;
  constexpr int DL = D / 4;                // lanes per key in P V
  constexpr int KG = kWarp / DL;           // keys a warp's P V step takes
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  // stage i of the ring: a K tile, then a V tile
  TKV* ring = reinterpret_cast<TKV*>(smem + L::kHead);

  const int pair = blockIdx.x;             // b * KH + kh
  const int b = pair / kv_heads;
  const int kh = pair % kv_heads;
  const int g0 = blockIdx.y * hpb;         // the block's first head in G
  const int split = blockIdx.z;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int kg = lane / DL;
  const int dl = lane % DL;

  // q and the split's first tile are copied before the length is known,
  // so the length's round trip overlaps theirs: keys of the first tile past
  // the length are read but never weighed
  const int k0 = split * chunk;
  const long long q_off = ((long long)b * heads + (long long)kh * G + g0) * D;
  if constexpr (sizeof(TQ) == 4) {
    for (int i = threadIdx.x; i < hpb * DL; i += blockDim.x)
      cp_async16(sq + 4 * i, q + q_off + 4 * i);
  } else {                 // widened as it is stored (the tile loop's
    for (int i = threadIdx.x; i < hpb * D; i += blockDim.x)   // barrier
      sq[i] = widen(q[q_off + i]);                  // publishes it)
  }
  const long long key_stride = (long long)kv_heads * D;
  const long long base = ((long long)b * seq * kv_heads + kh) * D;
  const TKV* kb = k + base;
  const TKV* vb = v + base;
  load_tile<D, TKV>(ring, ring + kTile * L::LDK, kb, vb, key_stride, k0,
                    min(k0 + chunk, seq));
  cp_async_commit();

  const int len = lengths[b];
  const bool masked_all = len <= 0;
  const int n = masked_all ? seq : min(len, seq);
  const int k1 = min(k0 + chunk, n);
  const int ntiles = k1 > k0 ? (k1 - k0 + kTile - 1) / kTile : 0;
  const bool computes = warp < hpb / HPW;    // warp-uniform

  float m[HPW], l[HPW];
  float4 acc[HPW];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    m[h] = -CUDART_INF_F;
    l[h] = 0.f;
    acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* qw = sq + warp * HPW * D;   // this warp's heads
  float* sp = smem + L::kQ + warp * L::kP;   // this warp's p

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = k0 + t * kTile;
    // two stages: the next tile's copy goes out before this one is waited
    // for (a group is committed per tile, empty past the end, so the wait
    // is the same every time); one stage holds a split of one tile
    if (stages == 2) {
      if (t + 1 < ntiles) {
        TKV* st = ring + ((t + 1) & 1) * L::kStage;
        load_tile<D, TKV>(st, st + kTile * L::LDK, kb, vb, key_stride,
                          t0 + kTile, k1);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const TKV* sk = ring + (t & 1) * L::kStage;
    const TKV* sv = sk + kTile * L::LDK;
    const int nk = min(kTile, k1 - t0);
    if (!computes) {
      __syncthreads();
      continue;
    }

    // scores: lane j takes key j of the tile
    float4 dot[HPW];
#pragma unroll
    for (int h = 0; h < HPW; ++h) dot[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    const TKV* kr = sk + lane * L::LDK;
#pragma unroll 8
    for (int c = 0; c < DL; ++c) {
      const float4 kv = load4(kr + 4 * c);
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        const float4 qv = reinterpret_cast<const float4*>(qw + h * D)[c];
        dot[h].x += qv.x * kv.x;
        dot[h].y += qv.y * kv.y;
        dot[h].z += qv.z * kv.z;
        dot[h].w += qv.w * kv.w;
      }
    }
    float p[HPW];
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      float s = (dot[h].x + dot[h].y) + (dot[h].z + dot[h].w);
      s = lane < nk ? (masked_all ? kMasked : s * scale) : -CUDART_INF_F;
      const float mx = fmaxf(m[h], warp_max(s));
      const float alpha = expf(m[h] - mx);   // 0 while m is still -inf
      p[h] = expf(s - mx);                   // 0 for a key past the end
      l[h] = l[h] * alpha + p[h];
      acc[h].x *= alpha;
      acc[h].y *= alpha;
      acc[h].z *= alpha;
      acc[h].w *= alpha;
      m[h] = mx;
      sp[lane * HPW + h] = p[h];
    }
    __syncwarp();

    // P V: KG keys at a time, p_j from lane j; a row past the end (not
    // copied) is never read into the sum
#pragma unroll 4
    for (int j = 0; j < nk; j += KG) {
      const int jj = j + kg;
      // at D < 128 a step's last keys may pass nk (kg > 0)
      const float4 vv = KG == 1 || jj < nk
                            ? load4(sv + jj * L::LDV + 4 * dl)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      float pj[HPW];                         // p_jj of each head: one read
      if constexpr (HPW == 2) {
        const float2 t = *reinterpret_cast<const float2*>(sp + jj * 2);
        pj[0] = t.x;
        pj[1] = t.y;
      } else {
        pj[0] = sp[jj];
      }
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        acc[h].x += pj[h] * vv.x;
        acc[h].y += pj[h] * vv.y;
        acc[h].z += pj[h] * vv.z;
        acc[h].w += pj[h] * vv.w;
      }
    }
    __syncthreads();                         // the stage may be refilled
  }
  cp_async_wait<0>();
  if (!computes) return;

#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    // the key groups' sums, then the lanes' running sums, in fixed order
#pragma unroll
    for (int off = DL; off < kWarp; off <<= 1) {
      acc[h].x += __shfl_xor_sync(0xffffffffu, acc[h].x, off);
      acc[h].y += __shfl_xor_sync(0xffffffffu, acc[h].y, off);
      acc[h].z += __shfl_xor_sync(0xffffffffu, acc[h].z, off);
      acc[h].w += __shfl_xor_sync(0xffffffffu, acc[h].w, off);
    }
    const float lsum = warp_sum(l[h]);
    const int g = g0 + warp * HPW + h;
    if (kg != 0) continue;
    if (splits == 1) {
      const float inv = 1.0f / fmaxf(lsum, 1e-30f);
      store4(o + ((long long)b * heads + (long long)kh * G + g) * D + 4 * dl,
             make_float4(acc[h].x * inv, acc[h].y * inv, acc[h].z * inv,
                         acc[h].w * inv));
    } else {
      const long long ws = ((long long)pair * splits + split) * G + g;
      reinterpret_cast<float4*>(ws_acc + ws * D)[dl] = acc[h];
      if (dl == 0) {
        ws_ml[2 * ws] = m[h];
        ws_ml[2 * ws + 1] = lsum;
      }
    }
  }
}

// Merge the splits of one (b, kv head) in split order.
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ ws_acc,
               const float* __restrict__ ws_ml, TQ* __restrict__ o,
               int heads, int kv_heads, int G, int D, int splits) {
  const int pair = blockIdx.x;
  const int b = pair / kv_heads;
  const int kh = pair % kv_heads;
  for (int idx = threadIdx.x; idx < G * D; idx += kCombineThreads) {
    const int g = idx / D;
    const int d = idx % D;
    const long long first = (long long)pair * splits * G + g;
    float mx = -CUDART_INF_F;
    for (int s = 0; s < splits; ++s) {
      const long long ws = first + (long long)s * G;
      if (ws_ml[2 * ws + 1] > 0.f) mx = fmaxf(mx, ws_ml[2 * ws]);
    }
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long long ws = first + (long long)s * G;
      const float ls = ws_ml[2 * ws + 1];
      if (ls > 0.f) {
        const float w = expf(ws_ml[2 * ws] - mx);
        lsum += ls * w;
        a += ws_acc[ws * D + d] * w;
      }
    }
    narrow(o + ((long long)b * heads + (long long)kh * G + g) * D + d,
           a / fmaxf(lsum, 1e-30f));
  }
}

template <int D, int HPW, typename TQ, typename TKV>
cudaError_t prepare(int bytes) {
  // above 48 kB, dynamic shared memory must be asked for (per device)
  return bytes <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(decode_kernel<D, HPW, TQ, TKV>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    bytes);
}

template <int D, int HPW, typename TQ, typename TKV>
cudaError_t launch(dim3 grid, int warps, cudaStream_t s, const TQ* q,
                   const TKV* k, const TKV* v, const int* lengths, TQ* o,
                   float* ws_acc, float* ws_ml, int seq, int heads,
                   int kv_heads, int G, int hpb, int splits, int chunk,
                   float scale) {
  const int stages = chunk > kTile ? 2 : 1;
  const int bytes = Smem<D, TKV>::bytes(stages);
  cudaError_t e = prepare<D, HPW, TQ, TKV>(bytes);
  if (e != cudaSuccess) return e;
  decode_kernel<D, HPW, TQ, TKV><<<grid, warps * kWarp, bytes, s>>>(
      q, k, v, lengths, o, ws_acc, ws_ml, seq, heads, kv_heads, G, hpb,
      splits, chunk, stages, scale);
  return cudaGetLastError();
}

template <int D, int HPW>
int occupancy(int warps, int stages) {
  const int bytes = Smem<D, float>::bytes(stages);
  if (prepare<D, HPW, float, float>(bytes) != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, decode_kernel<D, HPW, float, float>, warps * kWarp,
          bytes) != cudaSuccess)
    return -1;
  return blocks;
}

// the kernel for head width D and hpw heads a warp
template <int D, typename TQ, typename TKV>
cudaError_t launch_d(int hpw, dim3 grid, int warps, cudaStream_t s,
                     const TQ* q, const TKV* k, const TKV* v,
                     const int* lengths, TQ* o, float* ws_acc, float* ws_ml,
                     int seq, int heads, int kv_heads, int G, int hpb,
                     int splits, int chunk, float scale) {
  switch (hpw) {
    case 1: return launch<D, 1>(grid, warps, s, q, k, v, lengths, o, ws_acc,
                                ws_ml, seq, heads, kv_heads, G, hpb, splits,
                                chunk, scale);
    case 2: return launch<D, 2>(grid, warps, s, q, k, v, lengths, o, ws_acc,
                                ws_ml, seq, heads, kv_heads, G, hpb, splits,
                                chunk, scale);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
int occupancy_d(int hpw, int warps, int stages) {
  switch (hpw) {
    case 1: return occupancy<D, 1>(warps, stages);
    case 2: return occupancy<D, 2>(warps, stages);
    default: return -1;
  }
}

// both variants' launch: the split kernel, then (splits > 1) the merge
template <typename TQ, typename TKV>
int decode(const TQ* q, const TKV* k, const TKV* v, const int* lengths,
           TQ* o, float* ws_acc, float* ws_ml, int batch, int seq, int heads,
           int kv_heads, int head_dim, int splits, int head_groups,
           float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || kv_heads <= 0 || heads <= 0 ||
      heads % kv_heads != 0 || heads / kv_heads > kMaxG || splits < 1 ||
      splits > 65535 || head_groups < 1 ||
      (heads / kv_heads) % head_groups != 0 ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = heads / kv_heads;
  const int hpb = G / head_groups;               // heads a block takes
  const int hpw = hpb % kMaxHpw == 0 ? kMaxHpw : 1;  // heads a warp takes
  const int warps = max(kMinWarps, hpb / hpw);
  const int chunk = (seq + splits - 1) / splits;
  const dim3 grid(batch * kv_heads, head_groups, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
#define REPRO_DECODE_LAUNCH(DIM)                                              \
  case DIM:                                                                   \
    err = launch_d<DIM>(hpw, grid, warps, s, q, k, v, lengths, o, ws_acc,     \
                        ws_ml, seq, heads, kv_heads, G, hpb, splits, chunk,   \
                        scale);                                               \
    break;
    REPRO_DECODE_LAUNCH(16)
    REPRO_DECODE_LAUNCH(32)
    REPRO_DECODE_LAUNCH(64)
    REPRO_DECODE_LAUNCH(128)
#undef REPRO_DECODE_LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  combine_kernel<TQ><<<batch * kv_heads, kCombineThreads, 0, s>>>(
      ws_acc, ws_ml, o, heads, kv_heads, G, head_dim, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// head_dim in {16, 32, 64, 128}; heads % kv_heads == 0 with at most 8 query
// heads per kv head; head_groups divides heads / kv_heads; seq >= 1;
// batch * kv_heads < 2^31, head_groups and splits <= 65535 (the wrapper's
// decode_grid).  With splits > 1, ws_acc holds batch * kv_heads * splits *
// (heads / kv_heads) * head_dim floats and ws_ml twice batch * kv_heads *
// splits * (heads / kv_heads).  All pointers 16-byte aligned.  Returns
// cudaGetLastError() after the launches.
extern "C" int decode_attention_f32(const float* q, const float* k,
                                    const float* v, const int* lengths,
                                    float* o, float* ws_acc, float* ws_ml,
                                    int batch, int seq, int heads,
                                    int kv_heads, int head_dim, int splits,
                                    int head_groups, float scale,
                                    void* stream) {
  return decode<float, float>(q, k, v, lengths, o, ws_acc, ws_ml, batch, seq,
                              heads, kv_heads, head_dim, splits, head_groups,
                              scale, stream);
}

// The caches bfloat16, q and o bfloat16 (q_bf16 = 1) or float32 (0), the
// workspaces float32; otherwise as decode_attention_f32 (the caches' rows
// then need 16-byte alignment, which head_dim >= 16 gives a contiguous
// cache that starts on 16 bytes).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const int* lengths,
                                     void* o, float* ws_acc, float* ws_ml,
                                     int batch, int seq, int heads,
                                     int kv_heads, int head_dim, int splits,
                                     int head_groups, int q_bf16, float scale,
                                     void* stream) {
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  if (q_bf16)
    return decode<bf16, bf16>(static_cast<const bf16*>(q), kb, vb, lengths,
                              static_cast<bf16*>(o), ws_acc, ws_ml, batch,
                              seq, heads, kv_heads, head_dim, splits,
                              head_groups, scale, stream);
  return decode<float, bf16>(static_cast<const float*>(q), kb, vb, lengths,
                             static_cast<float*>(o), ws_acc, ws_ml, batch,
                             seq, heads, kv_heads, head_dim, splits,
                             head_groups, scale, stream);
}

// Blocks of the kernel for (head_dim, heads a warp takes, warps a block,
// stages of its copy ring) one SM holds at once (-1 on error).
extern "C" int decode_attention_occupancy(int head_dim, int hpw, int warps,
                                          int stages) {
  if (warps < 1 || warps > kMaxWarps || stages < 1 || stages > 2) return -1;
  switch (head_dim) {
    case 16: return occupancy_d<16>(hpw, warps, stages);
    case 32: return occupancy_d<32>(hpw, warps, stages);
    case 64: return occupancy_d<64>(hpw, warps, stages);
    case 128: return occupancy_d<128>(hpw, warps, stages);
    default: return -1;
  }
}
