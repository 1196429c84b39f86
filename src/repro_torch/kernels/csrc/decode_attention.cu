// Single-token decode attention against a KV cache for Hopper (sm_90a),
// float32:
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
//   (_decode_kernel).
//
// Bound: bytes.  Every cache row is read once and used for G dot products
// and G axpys of length D: 4 * G flops per 8 bytes of k and v, far below
// the card's float32 operations-per-byte balance.
//
// Design: the TPU kernel walks the cache of one (b, kv head) in sequence,
// carrying m / l / acc in scratch.  On Hopper one block per (b, kv head)
// would launch only B * KH blocks (4 at the launcher's B = 1) on 132 SMs,
// so the cache is split: block (pair, split) takes one contiguous chunk of
// the valid keys and produces a partial (acc, m, l) per query head, and a
// second kernel merges the splits in a fixed order with the log-sum-exp
// rule (the statistics the split-K flash decode of distributed/flash_decode
// combines), so the result does not depend on scheduling.  With one split
// the first kernel writes the output itself.  Inside a block, a group of
// D / 4 lanes owns one key at a time, each lane one 16-byte slice of the k
// and v rows, so a warp's loads are contiguous; the G query heads sit in
// registers and each score is a shuffle reduction inside the group.  Four
// keys are loaded before any is used, and the running max is rescaled once
// per four keys.  Only the valid keys are read; keys past lengths[b] would
// weigh exp(-1e30 - m) = 0.  The groups' states are merged through shared
// memory in a fixed order, with l clamped at 1e-30 as in the TPU kernel.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarp * kWarps;
constexpr int kMaxG = 8;      // query heads per kv head
constexpr int kUnroll = 4;    // keys in flight per lane group
constexpr float kNegInf = -1e30f;

template <int D>
struct Layout {
  static constexpr int LPK = D / 4;          // lanes per key, a float4 each
  static constexpr int KPW = kWarp / LPK;    // keys a warp reads at once
  static constexpr int NG = kWarps * KPW;    // lane groups per block
  static constexpr int kStates = NG * kMaxG;
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ o, float* __restrict__ ws_acc,
              float* __restrict__ ws_ml, int seq, int heads, int kv_heads,
              int G, int splits, int chunk, float scale) {
  using L = Layout<D>;
  __shared__ float s_m[L::kStates];
  __shared__ float s_l[L::kStates];
  __shared__ __align__(16) float s_acc[L::kStates * D];

  const int pair = blockIdx.x;               // b * KH + kh
  const int split = blockIdx.y;
  const int b = pair / kv_heads;
  const int kh = pair % kv_heads;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int grp = lane / L::LPK;
  const int sl = lane % L::LPK;
  const int sg = warp * L::KPW + grp;        // this lane group's index

  const int len = lengths[b];
  const bool masked_all = len <= 0;
  const int n = masked_all ? seq : min(len, seq);
  const int k0 = split * chunk;
  const int k1 = min(k0 + chunk, n);

  const float* qb = q + ((long long)b * heads + (long long)kh * G) * D;
  float4 qv[kMaxG];
  float m[kMaxG], l[kMaxG];
  float4 acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    qv[g] = g < G ? reinterpret_cast<const float4*>(qb + g * D)[sl]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const long long key_stride = (long long)kv_heads * D;
  const long long off = ((long long)b * seq * kv_heads + kh) * D + sl * 4;
  const float* kb = k + off;
  const float* vb = v + off;
  // the loop bound depends on the warp only, so every lane of a warp takes
  // part in every shuffle; a lane group past the end computes on zeros and
  // skips the update
  for (int base = k0 + warp * L::KPW; base < k1; base += L::NG * kUnroll) {
    float4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * L::NG + grp;
      ok[u] = j < k1;
      any |= ok[u];
      kr[u] = ok[u] ? *reinterpret_cast<const float4*>(kb + j * key_stride)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      vr[u] = ok[u] ? *reinterpret_cast<const float4*>(vb + j * key_stride)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;                     // uniform across the block
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float p = dot4(qv[g], kr[u]);
#pragma unroll
        for (int w = L::LPK / 2; w > 0; w >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, w);
        s[u] = ok[u] ? (masked_all ? kNegInf : p * scale) : -CUDART_INF_F;
      }
      if (any) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, s[u]);
        const float alpha = expf(m[g] - mx);  // 0 while m is still -inf
        float sum = 0.f;
        float4 add = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float pu = expf(s[u] - mx);   // 0 for a key past the end
          sum += pu;
          add.x += pu * vr[u].x;
          add.y += pu * vr[u].y;
          add.z += pu * vr[u].z;
          add.w += pu * vr[u].w;
        }
        l[g] = l[g] * alpha + sum;
        acc[g].x = acc[g].x * alpha + add.x;
        acc[g].y = acc[g].y * alpha + add.y;
        acc[g].z = acc[g].z * alpha + add.z;
        acc[g].w = acc[g].w * alpha + add.w;
        m[g] = mx;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    const int st = sg * kMaxG + g;
    if (sl == 0) {
      s_m[st] = m[g];
      s_l[st] = l[g];
    }
    reinterpret_cast<float4*>(s_acc + st * D)[sl] = acc[g];
  }
  __syncthreads();

  // merge the lane groups in a fixed order
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = -CUDART_INF_F;
    for (int i = 0; i < L::NG; ++i)
      if (s_l[i * kMaxG + g] > 0.f) mx = fmaxf(mx, s_m[i * kMaxG + g]);
    float lsum = 0.f, a = 0.f;
    for (int i = 0; i < L::NG; ++i) {
      const int st = i * kMaxG + g;
      if (s_l[st] > 0.f) {
        const float w = expf(s_m[st] - mx);
        lsum += s_l[st] * w;
        a += s_acc[st * D + d] * w;
      }
    }
    if (splits == 1) {
      o[(qb - q) + g * D + d] = a / fmaxf(lsum, 1e-30f);
    } else {
      const long long ws = ((long long)pair * splits + split) * G + g;
      ws_acc[ws * D + d] = a;
      if (d == 0) {
        ws_ml[2 * ws] = mx;
        ws_ml[2 * ws + 1] = lsum;
      }
    }
  }
}

// Merge the splits of one (b, kv head) in split order.
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws_acc,
               const float* __restrict__ ws_ml, float* __restrict__ o,
               int heads, int kv_heads, int G, int D, int splits) {
  const int pair = blockIdx.x;
  const int b = pair / kv_heads;
  const int kh = pair % kv_heads;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
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
    o[((long long)b * heads + (long long)kh * G + g) * D + d] =
        a / fmaxf(lsum, 1e-30f);
  }
}

}  // namespace

// head_dim in {16, 32, 64, 128}; heads % kv_heads == 0 with at most 8 query
// heads per kv head; seq >= 1; 1 <= splits <= 65535.  With splits > 1,
// ws_acc holds batch * kv_heads * splits * (heads / kv_heads) * head_dim
// floats and ws_ml twice batch * kv_heads * splits * (heads / kv_heads).
// All pointers 16-byte aligned.  Returns cudaGetLastError() after the
// launches.
extern "C" int decode_attention_f32(const float* q, const float* k,
                                    const float* v, const int* lengths,
                                    float* o, float* ws_acc, float* ws_ml,
                                    int batch, int seq, int heads,
                                    int kv_heads, int head_dim, int splits,
                                    float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || kv_heads <= 0 || heads <= 0 ||
      heads % kv_heads != 0 || heads / kv_heads > kMaxG || splits < 1 ||
      splits > 65535 || (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = heads / kv_heads;
  const int chunk = (seq + splits - 1) / splits;
  const dim3 grid(batch * kv_heads, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_LAUNCH(DIM)                                             \
  decode_kernel<DIM><<<grid, kThreads, 0, s>>>(q, k, v, lengths, o, ws_acc,  \
                                               ws_ml, seq, heads, kv_heads,  \
                                               G, splits, chunk, scale)
  switch (head_dim) {
    case 16: REPRO_DECODE_LAUNCH(16); break;
    case 32: REPRO_DECODE_LAUNCH(32); break;
    case 64: REPRO_DECODE_LAUNCH(64); break;
    case 128: REPRO_DECODE_LAUNCH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  combine_kernel<<<batch * kv_heads, kThreads, 0, s>>>(
      ws_acc, ws_ml, o, heads, kv_heads, G, head_dim, splits);
  return (int)cudaGetLastError();
}
