// FlashAttention-2 style attention for Hopper (sm_90a), float32.
//
//   o[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / G]) @ v[b, :, h / G]
//
// q and o are (B, Sq, H, D), k and v are (B, Sk, KH, D), all row-major,
// G = H / KH (grouped-query attention by index: kv is never repeated).
// Masks: causal (q_pos >= k_pos), sliding window (q_pos - k_pos < window
// when window > 0), with q_pos = i + q_offset; a masked score is the finite
// -1e30 of the TPU kernel.  Keys past Sk (the ragged end) take no part.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_pallas
//   (_flash_kernel).
//
// Bound: operations.  In strict float32 (no TF32) the products run on the
// CUDA cores; at the DiT's shapes (S = 256, D = 64) the 4 * S * D flops per
// query row against 16 * D bytes of q/k/v/o per row put it far above the
// card's float32 operations-per-byte balance.
//
// Design: one block per (b, h, 32-query tile).  Each lane owns one query
// row and keeps q and the output accumulator in registers; the block's four
// warps split the key sequence into four contiguous slices, so four times
// as many threads are in flight as query rows.  Each warp stages its keys
// and values through shared memory in tiles of BK rows (synchronising only
// itself), and every lane of the warp reads the same k/v row at the same
// time, a broadcast without bank conflicts, as 16-byte vectors.  The online
// softmax (running max m, denominator l, accumulator) is float32 per lane,
// one rescale per tile.  At the end the four partial (m, l, acc) states of
// each row are merged through shared memory in a fixed warp order, with l
// clamped at 1e-30 as in the TPU kernel, and the block writes its output
// tile with coalesced stores.  Moving the products to the tensor cores
// (wgmma) and the copies to TMA is the next step for speed.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBQ = kWarp;   // query rows per block, one per lane
constexpr int kSplits = 4;   // warps per block, one key slice each
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int BK = D <= 64 ? 16 : 8;          // keys per smem tile
  static constexpr int kFloats = 2 * kSplits * BK * D;  // k and v tiles
  static_assert(D * (kBQ + 1) <= kFloats, "output tile must fit the kv tiles");
};

template <int D>
__global__ void __launch_bounds__(kWarp * kSplits)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int sq,
             int sk, int heads, int kv_heads, int causal, int window,
             int q_offset, float scale) {
  constexpr int BK = Tile<D>::BK;
  constexpr int D4 = D / 4;
  // kv tiles during the loop; afterwards the same bytes hold the merged
  // output tile, laid out [D][kBQ + 1] so both its write (by lane) and its
  // read (by feature) are free of bank conflicts
  __shared__ __align__(16) float smem[Tile<D>::kFloats];
  __shared__ float m_sh[kSplits][kBQ];
  __shared__ float l_sh[kSplits][kBQ];

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + lane;
  const bool active = qi < sq;
  const int qpos = qi + q_offset;
  const long long q_stride = (long long)heads * D;
  const long long kv_stride = (long long)kv_heads * D;

  float qr[D];
  float acc[D];
  {
    const float* qp = q + (b * sq + (active ? qi : 0)) * q_stride + (long long)h * D;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      qr[dd] = active ? qp[dd] : 0.f;
      acc[dd] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  float* ks = smem + warp * (2 * BK * D);
  float* vs = ks + BK * D;
  const float* kb = k + b * sk * kv_stride + (long long)kvh * D;
  const float* vb = v + b * sk * kv_stride + (long long)kvh * D;
  const int n_tiles = (sk + BK - 1) / BK;
  const int per_warp = (n_tiles + kSplits - 1) / kSplits;
  const int t_end = min(n_tiles, (warp + 1) * per_warp);

  for (int t = warp * per_warp; t < t_end; ++t) {
    const int kstart = t * BK;
    const int nvalid = min(BK, sk - kstart);
    __syncwarp();  // the previous tile's reads are done
    for (int idx = lane; idx < BK * D; idx += kWarp) {
      const int j = idx / D;
      const int dd = idx % D;
      float kval = 0.f, vval = 0.f;
      if (j < nvalid) {
        const long long off = (long long)(kstart + j) * kv_stride + dd;
        kval = kb[off];
        vval = vb[off];
      }
      ks[idx] = kval;
      vs[idx] = vval;
    }
    __syncwarp();

    float s[BK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 kk = kr[c];
        dot += qr[4 * c] * kk.x;
        dot += qr[4 * c + 1] * kk.y;
        dot += qr[4 * c + 2] * kk.z;
        dot += qr[4 * c + 3] * kk.w;
      }
      const int kpos = kstart + j;
      bool keep = true;
      if (causal) keep = keep && qpos >= kpos;
      if (window > 0) keep = keep && qpos - kpos < window;
      // keys past the ragged end get exp(-inf) = 0 weight; masked keys get
      // the TPU kernel's finite -1e30
      s[j] = j < nvalid ? (keep ? dot * scale : kNegInf) : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      p_sum += s[j];
    }
    l = alpha * l + p_sum;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) acc[dd] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 vv = vr[c];
        acc[4 * c] += p * vv.x;
        acc[4 * c + 1] += p * vv.y;
        acc[4 * c + 2] += p * vv.z;
        acc[4 * c + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  // merge the kSplits partial states of each query row
  m_sh[warp][lane] = m;
  l_sh[warp][lane] = l;
  __syncthreads();  // every warp is past its kv tiles: smem is free
  float m_tot = kNegInf;
#pragma unroll
  for (int w = 0; w < kSplits; ++w) m_tot = fmaxf(m_tot, m_sh[w][lane]);
  float l_tot = 0.f;
#pragma unroll
  for (int w = 0; w < kSplits; ++w)
    l_tot += expf(m_sh[w][lane] - m_tot) * l_sh[w][lane];
  const float wgt = expf(m - m_tot) / fmaxf(l_tot, 1e-30f);
  float* out_t = smem;  // [D][kBQ + 1]
  for (int w = 0; w < kSplits; ++w) {
    if (warp == w) {
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        const float part = wgt * acc[dd];
        out_t[dd * (kBQ + 1) + lane] =
            w == 0 ? part : out_t[dd * (kBQ + 1) + lane] + part;
      }
    }
    __syncthreads();
  }

  const int rows = min(kBQ, sq - q0);
  for (int idx = threadIdx.x; idx < rows * D; idx += kWarp * kSplits) {
    const int r = idx / D;
    const int dd = idx % D;
    o[(b * sq + q0 + r) * q_stride + (long long)h * D + dd] =
        out_t[dd * (kBQ + 1) + r];
  }
}

}  // namespace

// head_dim in {16, 32, 64, 128}; heads % kv_heads == 0; sq, sk >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int batch,
                                   int sq, int sk, int heads, int kv_heads,
                                   int head_dim, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 || heads <= 0 ||
      heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  const dim3 block(kWarp * kSplits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_LAUNCH(DIM)                                              \
  flash_kernel<DIM><<<grid, block, 0, s>>>(q, k, v, o, sq, sk, heads,        \
                                           kv_heads, causal, window,         \
                                           q_offset, scale)
  switch (head_dim) {
    case 16: REPRO_FLASH_LAUNCH(16); break;
    case 32: REPRO_FLASH_LAUNCH(32); break;
    case 64: REPRO_FLASH_LAUNCH(64); break;
    case 128: REPRO_FLASH_LAUNCH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_LAUNCH
  return (int)cudaGetLastError();
}
