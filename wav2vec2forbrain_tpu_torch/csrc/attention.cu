// Fused multi-head attention, forward and backward, with train-mode hash
// dropout on the probabilities.
//
// Replaces: wav2vec2forbrain_tpu/ops/pallas_attention.py::_call from
// _fwd_impl (the Pallas kernel _fwd_kernel, dropout mask _keep_mask/_mix)
// and from _bwd_impl (_bwd_kernel). On (B, T, H*D) operands, per (batch,
// head):
//   forward:  s = (q_cd . k_cd^T) * scale        (f32 accumulation)
//             p = softmax(s) over the whole row, in f32
//             p = p * mask * (1/keep)             train mode only
//             o = p_cd . v_cd                     (f32 accumulation), stream dtype
//   backward: p recomputed, mask recomputed from the same hash
//             dv = pd_cd^T . g_cd;  dp = (g_cd . v_cd^T) * mask * (1/keep)
//             ds = p * (dp - sum_j dp * p)
//             dq = ds_cd . k_cd * scale;  dk = ds_cd^T . q_cd * scale
// where _cd means rounded to the compute dtype before the product, as the
// JAX kernel's dot_generals do. There is no padding mask: like the JAX path,
// every query attends over all T frames, pad frames included. The mask is a
// pure function of (seed, batch row, head, q row, k col) (common.cuh
// attn_keep), so forward and backward, the plain PyTorch version and the
// JAX package all drop the same probabilities.
//
// What bounds it on the H100: nothing big. At the slice's shape (B=32,
// T=89, 16 heads of 64) one layer's forward reads and writes 4 x 11.7 MB
// (~14 us at 3.35 TB/s) and does ~1 GFLOP (~1 us on the bf16 tensor cores);
// the (T, T) scores of one head are 32 KB. The cost is latency: the loads
// of each block's tiles and the blocks in flight.
//
// Forward at bf16 compute (the main path): one kernel on the tensor cores
// (mma.sync.m16n8k16, bf16 inputs, f32 accumulators) for any T' and D <=
// 128, one block of 4 warps per (64 query rows, head, batch row), 1,024
// blocks at the slice's shape. Q, K and V are staged in shared memory as
// bf16, rounded on the way in from an f32 stream, head columns zero-padded
// to 64 or 128; each warp keeps its 16 rows' Q fragments in registers. A
// head's key tiles stay resident while the block's shared memory stays under
// 72 KB (T' <= 192 at D <= 64), else they stream through one tile buffer.
// Two passes over the key tiles, as the dq launch below: pass 1 S = Q K^T and
// the row max and sum (RowStats: per thread, then over the 4 threads of a
// row); pass 2 S again, p = exp(s - m) / l, the mask hashed per accumulator
// element from its (row, column), rounded to bf16 straight into A fragments,
// O += P V with V's fragments gathered by ldmatrix.trans. p is normalised
// before it is rounded, as JAX does (a one-pass FlashAttention rescale would
// round unnormalised p: another function). S is recomputed in pass 2 even
// where all keys are resident: keeping it in registers would cost 32
// registers per 64-key tile and a shape-dependent count of them.
//
// Forward at f32 compute (TF32 would change the numbers): SIMT kernels. One
// block (4 warps) per (batch, head): the head's K and V (T x D each, f32)
// sit in shared memory; K rows are padded to D + 1 floats so that 32 lanes
// reading 32 different keys hit 32 different banks. Each warp takes four
// query rows at a time, so every K and V value it reads from shared memory
// feeds four FMAs: lanes compute the scores of keys lane, lane+32, ... for
// the four rows into a per-warp buffer, each row's max and sum are warp
// shuffles (whole-row f32 softmax; the ragged edge of T = 89 is just the
// loop bound), the dropout mask is hashed in place, and then lanes own
// output columns and sum p * V over all keys. Where a head's K and V do not
// fit (T > 393 at D = 64), the wrapper takes a second kernel that streams
// 64-key tiles twice: the row max and sum, then p = exp(s - m) / l masked
// and summed into p . v (any T, D <= 128). Both are bound by
// shared-memory load instructions of the broadcast q and p rows.
//
// Backward at bf16 compute (the main path): two launches on the tensor cores
// (mma.sync.m16n8k16, bf16 inputs, f32 accumulators), the same split as the
// SIMT kernels below, so no atomics and a deterministic result. Tiles are
// staged in shared memory as bf16, rounded on the way in from an f32 stream
// (the JAX `.astype(cd)`), head columns zero-padded to 64 or 128.
//  1. dq and the row statistics, over (64 query rows, head, batch row);
//     each warp owns 16 rows and streams 64-key tiles of K and V twice.
//     Pass 1: S = Q K^T and dP = dO V^T in registers; per thread an online
//     max, sum and sum of dp * mask * e over its columns, combined over the
//     4 threads of a row into m, l and D_i = sum_j dp_ij p_ij (dp masked and
//     scaled, p before dropout: not FlashAttention's rowsum(dO o O), since O
//     was formed from pd rounded to bf16). Pass 2: ds = p * (dp - D_i) from
//     the accumulators, rounded, packed straight into A fragments; dQ +=
//     ds_cd . K with K's fragments gathered by ldmatrix.trans.
//  2. dk and dv, over (64 keys, head, batch row); each warp owns 16 keys and
//     streams 64-query tiles of q and dO with their statistics: S^T = K Q^T,
//     dP^T = V dO^T, then pd = p * mask / keep and ds rounded as A
//     fragments: dV += pd_cd^T . dO, dK += ds_cd^T . Q.
// The mask is hashed per accumulator element from its (row, column) in the
// fragment layout, with common.cuh's attn_keep. The scale is applied after
// the dq and dk products, as in JAX. Columns past T take no part in the
// statistics or the sums; rows past T are never stored.
//
// Backward at f32 compute: two SIMT launches (TF32 would change the
// numbers) whose shared memory does not grow with T (any T; D <= 128), no
// atomics, deterministic.
//  1. dq, over (query tile of 16 rows, head, batch row); 4 warps of 4 rows,
//     as in the forward. The block streams 64-key tiles of K and V through
//     shared memory twice. Pass 1: lanes over keys compute s and dp = g . v
//     for the warp's 4 rows and keep a lane-local online softmax max m, sum
//     l and sum of dp * mask * e; warp shuffles combine the lanes into the
//     row statistics m, l and D_i = sum_j dp_ij p_ij (dp masked and
//     scaled), written to a (3, B, heads, T) f32 scratch. Pass 2: p = exp(s
//     - m) / l, ds = p * (dp - D_i) into a per-warp buffer, then lanes over
//     columns sum ds . k for the 4 rows.
//  2. dk and dv, over (key tile of 16 keys, head, batch row); each warp
//     takes 4 keys. The block streams 32-query tiles of q and g with their
//     row statistics; lanes over queries recompute s, dp, p and the mask and
//     store pd = p * mask / keep and ds, then lanes over columns
//     sum pd^T . g and ds^T . q for the 4 keys.
// Each score is recomputed three times (the price of shared memory linear
// in tiles instead of the old kernel's (T, T) tiles, which stopped at T =
// 117); the cost is latency and shared-memory loads, as in the forward.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;  // query rows a warp takes at once

template <typename T>
__global__ void attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, T* __restrict__ o, int Tn, int NH,
                                     int D, float scale, bool drop, uint32_t seed,
                                     float keep_prob, float inv_keep) {
  extern __shared__ float sm[];
  const int ldk = D + 1;
  float* ks = sm;                          // [Tn][D + 1]
  float* vs = ks + Tn * ldk;               // [Tn][D]
  float* qs = vs + Tn * D;                 // [kWarps][kRows][D]
  float* ps = qs + kWarps * kRows * D;     // [kWarps][kRows][Tn]
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, b, h);

  for (int i = threadIdx.x; i < Tn * D; i += blockDim.x) {
    const int r = i / D;
    const int c = i - r * D;
    const size_t g = base + (size_t)r * HD + c;
    ks[r * ldk + c] = w2vb::to_f32(k[g]);
    vs[r * D + c] = w2vb::to_f32(v[g]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qw = qs + warp * kRows * D;
  float* pw = ps + warp * kRows * Tn;
  for (int r0 = warp * kRows; r0 < Tn; r0 += kWarps * kRows) {
    const int nr = min(kRows, Tn - r0);
    // rows past the ragged end get q = 0 (a harmless uniform softmax) and
    // are never stored
    for (int i = lane; i < kRows * D; i += 32) {
      const int rr = i / D;
      const int c = i - rr * D;
      qw[i] = rr < nr ? w2vb::to_f32(q[base + (size_t)(r0 + rr) * HD + c]) : 0.f;
    }
    __syncwarp();

    float mx[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) mx[rr] = __int_as_float(0xff800000);  // -inf
    for (int c = lane; c < Tn; c += 32) {
      const float* kr = ks + c * ldk;
      float acc[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) acc[rr] = fmaf(qw[rr * D + d], kv, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float s = acc[rr] * scale;
        pw[rr * Tn + c] = s;
        mx[rr] = fmaxf(mx[rr], s);
      }
    }
    float sum[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      mx[rr] = w2vb::warp_max(mx[rr]);
      sum[rr] = 0.f;
    }
    for (int c = lane; c < Tn; c += 32) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float e = expf(pw[rr * Tn + c] - mx[rr]);
        pw[rr * Tn + c] = e;
        sum[rr] += e;
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) sum[rr] = w2vb::warp_sum(sum[rr]);
    for (int c = lane; c < Tn; c += 32) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        float p = pw[rr * Tn + c] / sum[rr];
        if (drop) p = w2vb::attn_keep(mix, r0 + rr, c, keep_prob) ? p * inv_keep : 0.f;
        pw[rr * Tn + c] = p;
      }
    }
    __syncwarp();

    for (int c = lane; c < D; c += 32) {
      float acc[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
      for (int j = 0; j < Tn; ++j) {
        const float vv = vs[j * D + c];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) acc[rr] = fmaf(pw[rr * Tn + j], vv, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        if (rr < nr) o[base + (size_t)(r0 + rr) * HD + c] = w2vb::from_f32<T>(acc[rr]);
    }
    __syncwarp();
  }
}

constexpr int kQT = kWarps * kRows;  // query rows per block of the dq and streaming forward kernels
constexpr int kKT = 64;              // keys per tile they stream
constexpr int kKeys = 4;             // keys a warp takes at once in the dk/dv kernel
constexpr int kKT2 = kWarps * kKeys;  // keys per block there
constexpr int kQT2 = 32;             // queries per tile it streams, one per lane
constexpr int kMaxCols = 4;          // head columns per lane: D <= 128

// rows [r0, r0 + n) of one head into shared memory [n][D + 1] as f32; rows
// at or past Tn are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, size_t base, int r0,
                                          int n, int Tn, int HD, int D) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * (D + 1) + c] =
        r0 + r < Tn ? w2vb::to_f32(src[base + (size_t)(r0 + r) * HD + c]) : 0.f;
  }
}

// The forward where a head's K and V do not fit in shared memory (T' > 393
// at D = 64): one block per (query tile of kQT rows, head, batch row), 4
// warps of 4 rows, streaming 64-key tiles twice, as the dq kernel does.
// Pass 1: lane-local online row max and sum over the lane's keys, combined
// by warp shuffles. Pass 2: p = exp(s - m) / l, masked and scaled, into a
// per-warp buffer, then lanes over columns sum p . v.
template <typename T>
__global__ void attention_fwd_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v, T* __restrict__ o, int Tn,
                                            int NH, int D, float scale, bool drop,
                                            uint32_t seed, float keep_prob, float inv_keep) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  float* qs = sm;               // [kQT][D + 1]
  float* ks = qs + kQT * ld;    // [kKT][D + 1]
  float* vs = ks + kKT * ld;    // [kKT][D + 1]
  float* pb = vs + kKT * ld;    // [kWarps][kRows][kKT] p
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qw = qs + warp * kRows * ld;
  float* pw = pb + warp * kRows * kKT;
  const int r0 = q0 + warp * kRows;
  load_rows(qs, q, base, q0, kQT, Tn, HD, D);

  auto scores = [&](int jj, float (&s)[kRows]) {
    const float* kr = ks + jj * ld;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) s[rr] = fmaf(qw[rr * ld + d], kv, s[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] *= scale;
  };

  float m[kRows], l[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = __int_as_float(0xff800000);  // -inf
    l[rr] = 0.f;
  }
  for (int j0 = 0; j0 < Tn; j0 += kKT) {
    __syncthreads();  // the previous tile is done with
    load_rows(ks, k, base, j0, kKT, Tn, HD, D);
    __syncthreads();
    for (int jj = lane; jj < kKT && j0 + jj < Tn; jj += 32) {
      float s[kRows];
      scores(jj, s);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        if (s[rr] > m[rr]) {
          l[rr] = fmaf(l[rr], expf(m[rr] - s[rr]), 1.f);
          m[rr] = s[rr];
        } else {
          l[rr] += expf(s[rr] - m[rr]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const float mx = w2vb::warp_max(m[rr]);
    l[rr] = w2vb::warp_sum(l[rr] > 0.f ? l[rr] * expf(m[rr] - mx) : 0.f);  // a lane that saw no key has l = 0
    m[rr] = mx;
  }

  float acc[kRows][kMaxCols];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) acc[rr][cc] = 0.f;
  for (int j0 = 0; j0 < Tn; j0 += kKT) {
    __syncthreads();
    load_rows(ks, k, base, j0, kKT, Tn, HD, D);
    load_rows(vs, v, base, j0, kKT, Tn, HD, D);
    __syncthreads();
    const int nk = min(kKT, Tn - j0);
    for (int jj = lane; jj < nk; jj += 32) {
      float s[kRows];
      scores(jj, s);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        float p = expf(s[rr] - m[rr]) / l[rr];
        if (drop) p = w2vb::attn_keep(mix, r0 + rr, j0 + jj, keep_prob) ? p * inv_keep : 0.f;
        pw[rr * kKT + jj] = p;
      }
    }
    __syncwarp();
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c >= D) break;
      for (int j = 0; j < nk; ++j) {
        const float vv = vs[j * ld + c];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) acc[rr][cc] = fmaf(pw[rr * kKT + j], vv, acc[rr][cc]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    if (r0 + rr >= Tn) break;
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c < D) o[base + (size_t)(r0 + rr) * HD + c] = w2vb::from_f32<T>(acc[rr][cc]);
    }
  }
}

__device__ __forceinline__ float keep_scale(bool drop, uint32_t mix, int r, int c, float keep_prob,
                                            float inv_keep) {
  return drop ? (w2vb::attn_keep(mix, r, c, keep_prob) ? inv_keep : 0.f) : 1.f;
}

template <typename T>
__global__ void attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const T* __restrict__ g,
                                        T* __restrict__ dq, float* __restrict__ stats, int Tn,
                                        int NH, int D, float scale, bool drop,
                                        uint32_t seed, float keep_prob, float inv_keep) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  float* qs = sm;                // [kQT][D + 1]
  float* gs = qs + kQT * ld;     // [kQT][D + 1]
  float* ks = gs + kQT * ld;     // [kKT][D + 1]
  float* vs = ks + kKT * ld;     // [kKT][D + 1]
  float* dsb = vs + kKT * ld;    // [kWarps][kRows][kKT] ds
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qw = qs + warp * kRows * ld;
  const float* gw = gs + warp * kRows * ld;
  float* dw = dsb + warp * kRows * kKT;
  const int r0 = q0 + warp * kRows;
  load_rows(qs, q, base, q0, kQT, Tn, HD, D);
  load_rows(gs, g, base, q0, kQT, Tn, HD, D);

  // s (scaled) and dp of the warp's rows against key jj of the staged tile
  auto dots = [&](int jj, float (&s)[kRows], float (&dp)[kRows]) {
    const float* kr = ks + jj * ld;
    const float* vr = vs + jj * ld;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] = dp[rr] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d], vv = vr[d];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        s[rr] = fmaf(qw[rr * ld + d], kv, s[rr]);
        dp[rr] = fmaf(gw[rr * ld + d], vv, dp[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] *= scale;
  };
  auto load_keys = [&](int j0) {
    __syncthreads();  // the previous tile is done with
    load_rows(ks, k, base, j0, kKT, Tn, HD, D);
    load_rows(vs, v, base, j0, kKT, Tn, HD, D);
    __syncthreads();
  };

  // pass 1: lane-local online max, sum and sum of dp * e over the lane's keys
  float m[kRows], l[kRows], dn[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = __int_as_float(0xff800000);  // -inf
    l[rr] = dn[rr] = 0.f;
  }
  for (int j0 = 0; j0 < Tn; j0 += kKT) {
    load_keys(j0);
    for (int jj = lane; jj < kKT && j0 + jj < Tn; jj += 32) {
      float s[kRows], dp[kRows];
      dots(jj, s, dp);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float dpm = dp[rr] * keep_scale(drop, mix, r0 + rr, j0 + jj, keep_prob, inv_keep);
        if (s[rr] > m[rr]) {
          const float f = expf(m[rr] - s[rr]);
          l[rr] = fmaf(l[rr], f, 1.f);
          dn[rr] = fmaf(dn[rr], f, dpm);
          m[rr] = s[rr];
        } else {
          const float e = expf(s[rr] - m[rr]);
          l[rr] += e;
          dn[rr] = fmaf(dpm, e, dn[rr]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const float mx = w2vb::warp_max(m[rr]);
    const float f = l[rr] > 0.f ? expf(m[rr] - mx) : 0.f;  // a lane that saw no key has l = 0
    l[rr] = w2vb::warp_sum(l[rr] * f);
    dn[rr] = w2vb::warp_sum(dn[rr] * f) / l[rr];
    m[rr] = mx;
  }
  if (lane == 0) {
    const size_t nrow = (size_t)gridDim.z * NH * Tn;
    float* st = stats + ((size_t)b * NH + h) * Tn;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      if (r0 + rr < Tn) {
        st[r0 + rr] = m[rr];
        st[nrow + r0 + rr] = l[rr];
        st[2 * nrow + r0 + rr] = dn[rr];
      }
    }
  }

  // pass 2: dq[i, :] = scale * sum_j ds[i, j] k[j, :]
  float acc[kRows][kMaxCols];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) acc[rr][cc] = 0.f;
  for (int j0 = 0; j0 < Tn; j0 += kKT) {
    load_keys(j0);
    for (int jj = lane; jj < kKT; jj += 32) {
      if (j0 + jj < Tn) {
        float s[kRows], dp[kRows];
        dots(jj, s, dp);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const float p = expf(s[rr] - m[rr]) / l[rr];
          const float dpm = dp[rr] * keep_scale(drop, mix, r0 + rr, j0 + jj, keep_prob, inv_keep);
          dw[rr * kKT + jj] = p * (dpm - dn[rr]);
        }
      } else {
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) dw[rr * kKT + jj] = 0.f;
      }
    }
    __syncwarp();
    const int nk = min(kKT, Tn - j0);
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c >= D) break;
      for (int j = 0; j < nk; ++j) {
        const float kv = ks[j * ld + c];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) acc[rr][cc] = fmaf(dw[rr * kKT + j], kv, acc[rr][cc]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    if (r0 + rr >= Tn) break;
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c < D) dq[base + (size_t)(r0 + rr) * HD + c] = w2vb::from_f32<T>(acc[rr][cc] * scale);
    }
  }
}

template <typename T>
__global__ void attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                          const T* __restrict__ v, const T* __restrict__ g,
                                          const float* __restrict__ stats, T* __restrict__ dk,
                                          T* __restrict__ dv, int Tn, int NH, int D, float scale,
                                          bool drop, uint32_t seed, float keep_prob,
                                          float inv_keep) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  float* ks = sm;                      // [kKT2][D + 1]
  float* vs = ks + kKT2 * ld;          // [kKT2][D + 1]
  float* qs = vs + kKT2 * ld;          // [kQT2][D + 1]
  float* gs = qs + kQT2 * ld;          // [kQT2][D + 1]
  float* st = gs + kQT2 * ld;          // [3][kQT2] m, l, D of the staged rows
  float* pdb = st + 3 * kQT2;          // [kWarps][kKeys][kQT2] pd
  float* dsb = pdb + kWarps * kKeys * kQT2;  // [kWarps][kKeys][kQT2] ds
  const int k0 = blockIdx.x * kKT2, h = blockIdx.y, b = blockIdx.z;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp * kKeys;  // the warp's first key in the tile
  float* pw = pdb + warp * kKeys * kQT2;
  float* dw = dsb + warp * kKeys * kQT2;
  const size_t nrow = (size_t)gridDim.z * NH * Tn;
  const float* sb = stats + ((size_t)b * NH + h) * Tn;
  load_rows(ks, k, base, k0, kKT2, Tn, HD, D);
  load_rows(vs, v, base, k0, kKT2, Tn, HD, D);

  float ak[kKeys][kMaxCols], av[kKeys][kMaxCols];
#pragma unroll
  for (int kk = 0; kk < kKeys; ++kk)
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) ak[kk][cc] = av[kk][cc] = 0.f;
  for (int i0 = 0; i0 < Tn; i0 += kQT2) {
    __syncthreads();  // the previous tile is done with
    load_rows(qs, q, base, i0, kQT2, Tn, HD, D);
    load_rows(gs, g, base, i0, kQT2, Tn, HD, D);
    for (int i = threadIdx.x; i < kQT2; i += blockDim.x) {
      const bool in = i0 + i < Tn;
      st[i] = in ? sb[i0 + i] : 0.f;
      st[kQT2 + i] = in ? sb[nrow + i0 + i] : 1.f;
      st[2 * kQT2 + i] = in ? sb[2 * nrow + i0 + i] : 0.f;
    }
    __syncthreads();
    const int i = i0 + lane;  // this lane's query row
    float s[kKeys], dp[kKeys];
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) s[kk] = dp[kk] = 0.f;
    const float* qr = qs + lane * ld;
    const float* gr = gs + lane * ld;
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d], gv = gr[d];
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) {
        s[kk] = fmaf(qv, ks[(kw + kk) * ld + d], s[kk]);
        dp[kk] = fmaf(gv, vs[(kw + kk) * ld + d], dp[kk]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) {
      float pd = 0.f, ds = 0.f;
      if (i < Tn) {
        const float p = expf(s[kk] * scale - st[lane]) / st[kQT2 + lane];
        const float mk = keep_scale(drop, mix, i, k0 + kw + kk, keep_prob, inv_keep);
        pd = p * mk;
        ds = p * (dp[kk] * mk - st[2 * kQT2 + lane]);
      }
      pw[kk * kQT2 + lane] = pd;
      dw[kk * kQT2 + lane] = ds;
    }
    __syncwarp();
    // dv[j, :] += sum_i pd[i, j] g[i, :];  dk[j, :] += sum_i ds[i, j] q[i, :]
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c >= D) break;
      for (int ii = 0; ii < kQT2; ++ii) {
        const float gv = gs[ii * ld + c], qv = qs[ii * ld + c];
#pragma unroll
        for (int kk = 0; kk < kKeys; ++kk) {
          av[kk][cc] = fmaf(pw[kk * kQT2 + ii], gv, av[kk][cc]);
          ak[kk][cc] = fmaf(dw[kk * kQT2 + ii], qv, ak[kk][cc]);
        }
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < kKeys; ++kk) {
    const int j = k0 + kw + kk;
    if (j >= Tn) break;
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c >= D) break;
      dk[base + (size_t)j * HD + c] = w2vb::from_f32<T>(ak[kk][cc] * scale);
      dv[base + (size_t)j * HD + c] = w2vb::from_f32<T>(av[kk][cc]);
    }
  }
}

// ---- the backward at bf16 compute, on the tensor cores (header note) ----

constexpr int kMmaRows = 64;  // query rows (dq) or keys (dk/dv) per block: 4 warps x 16

template <int DP>
struct MmaTile {
  static constexpr int kN = DP <= 64 ? 64 : 32;  // keys (dq) or queries (dk/dv) per streamed tile
  static constexpr int kLd = DP + 8;             // bf16 row pitch: 16-byte rows, conflict-free fragments
  static constexpr size_t kSmem = (size_t)(2 * kMmaRows + 2 * kN) * kLd * 2;  // + 3 kN f32 for dk/dv
};

using w2vb::ld_pair;
using w2vb::mma_bf16;
using w2vb::pack_bf16;

// A fragment of rows m0 .. m0 + 15, columns kk .. kk + 15 of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* t, int ld, int m0, int kk) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* p = t + (m0 + gq) * ld + kk + 2 * tq;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// B fragments (k = kk .. kk + 15, n = n0 .. n0 + 7) of B = T^T, T a
// row-major [n][k] tile: the pairs along k are contiguous
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const __nv_bfloat16* t, int ld, int n0, int kk) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* p = t + (n0 + gq) * ld + kk + 2 * tq;
  b[0] = ld_pair(p);
  b[1] = ld_pair(p + 8);
}

// B fragments of two n-tiles (n0, n0 + 8), k = k0 .. k0 + 15, of B = T, T a
// row-major [k][n] tile: ldmatrix.trans gathers the pairs along k
__device__ __forceinline__ void frag_b_trans(uint32_t (&b)[2][2], const __nv_bfloat16* t, int ld, int k0,
                                             int n0) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p = t + (k0 + (mat & 1) * 8 + r) * ld + n0 + (mat >> 1) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
               : "r"(addr));
}

// rows [r0, r0 + kRows) of one head into a bf16 tile [kRows][DP + 8],
// rounded to nearest even; rows at or past Tn and columns at or past D are
// zero. Each of the block's threads takes kRows x DP / 8 / 128 chunks of 8
// columns, a count fixed at compile time, and issues all its loads before
// its first store, so a tile costs one round trip to L2 and not one per
// chunk. vec: D % 8 == 0 and 16-byte aligned operands, so a chunk loads as
// one or two 16-byte vectors
template <typename T, int DP, int kRows>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const T* __restrict__ src, size_t base,
                                               int r0, int Tn, int HD, int D, bool vec) {
  constexpr int kChunks = DP / 8, kThreads = kWarps * 32, kPer = kRows * kChunks / kThreads;
  static_assert(kPer * kThreads == kRows * kChunks, "a tile is a whole number of chunks per thread");
  uint4 out[kPer];
  if (vec) {
    constexpr int kW = sizeof(T) == 2 ? 1 : 2;  // 16-byte loads per chunk
    uint4 raw[kPer][kW];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = threadIdx.x + i * kThreads, row = r0 + p / kChunks, c = (p % kChunks) * 8;
      const uint4* g = reinterpret_cast<const uint4*>(src + base + (size_t)row * HD + c);
      const bool ok = row < Tn && c < D;
#pragma unroll
      for (int w = 0; w < kW; ++w) raw[i][w] = ok ? g[w] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if constexpr (sizeof(T) == 2) {
        out[i] = raw[i][0];
      } else {
        const uint4 x = raw[i][0], y = raw[i][kW - 1];
        out[i] = make_uint4(pack_bf16(__uint_as_float(x.x), __uint_as_float(x.y)),
                            pack_bf16(__uint_as_float(x.z), __uint_as_float(x.w)),
                            pack_bf16(__uint_as_float(y.x), __uint_as_float(y.y)),
                            pack_bf16(__uint_as_float(y.z), __uint_as_float(y.w)));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = threadIdx.x + i * kThreads, row = r0 + p / kChunks, c = (p % kChunks) * 8;
      const T* g = src + base + (size_t)row * HD + c;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = row < Tn && c + e < D ? w2vb::to_f32(g[e]) : 0.f;
      out[i] = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                          pack_bf16(f[6], f[7]));
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(dst + (p / kChunks) * (DP + 8) + (p % kChunks) * 8) = out[i];
  }
}

// acc (a warp's 16 x 8 NT outputs, NT n-tiles) += a (16 x 16) . T[k0 .. k0 +
// 16, 0 .. 8 NT], T a row-major [k][n] tile
template <int NT>
__device__ __forceinline__ void mma_rows(float* acc, const uint32_t (&a)[4], const __nv_bfloat16* t, int ld,
                                         int k0) {
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    uint32_t b[2][2];
    frag_b_trans(b, t, ld, k0, 8 * n);
    mma_bf16(acc + 4 * n, a, b[0]);
    mma_bf16(acc + 4 * n + 4, a, b[1]);
  }
}

// Accumulator element i of a warp's 16 x 8 NT fragment: row gq (i & 2 == 0)
// or gq + 8, column 8 (i >> 2) + 2 tq + (i & 1).
__device__ __forceinline__ int frag_col(int i, int tq) { return 8 * (i >> 2) + 2 * tq + (i & 1); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The online softmax statistics of a warp's two fragment rows (gq, gq + 8):
// each thread keeps the max m and the sum l of exp(s - m) over its own
// columns, tile by tile; `combine` then merges the 4 threads of a row (tq).
// A sum kept beside l (the backward's sum of dp * e) is rescaled by the
// factors that `fold_max` and `combine` return.
struct RowStats {
  float m[2], l[2];

  __device__ __forceinline__ RowStats() {
    m[0] = m[1] = __int_as_float(0xff800000);  // -inf
    l[0] = l[1] = 0.f;
  }

  // the tile's max over its valid columns (j0 + column < Tn) into m;
  // f[rr]: the factor l[rr] was multiplied by
  template <int N>
  __device__ __forceinline__ void fold_max(const float (&s)[N], int j0, int Tn, int tq, float (&f)[2]) {
    float tm[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (j0 + frag_col(i, tq) < Tn) tm[(i >> 1) & 1] = fmaxf(tm[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      f[rr] = 1.f;
      if (tm[rr] > m[rr]) {
        f[rr] = expf(m[rr] - tm[rr]);
        l[rr] *= f[rr];
        m[rr] = tm[rr];
      }
    }
  }

  // e = exp(s - m) of a valid element of row rr, added to l
  __device__ __forceinline__ float add(int rr, float s) {
    const float e = expf(s - m[rr]);
    l[rr] += e;
    return e;
  }

  // m and l of the whole row, the same in the row's 4 threads; f[rr]: the
  // factor for this thread's sums before they are added over the 4
  __device__ __forceinline__ void combine(float (&f)[2]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float mx = quad_max(m[rr]);
      f[rr] = l[rr] > 0.f ? expf(m[rr] - mx) : 0.f;  // a thread that saw no key has l = 0
      l[rr] = quad_sum(l[rr] * f[rr]);
      m[rr] = mx;
    }
  }
};

// The forward at bf16 compute, on the tensor cores: block (64 query rows,
// head, batch row), warp w owns rows 16 w .. +16 and holds their Q
// fragments in registers. Key tiles of kN are either all resident in shared
// memory (n_res tiles, loaded once, where they fit) or streamed through one
// tile buffer, twice. Pass 1: S = Q K^T, the row statistics m, l. Pass 2: S
// again, p = exp(s - m) / l masked and scaled, rounded to bf16 straight into
// A fragments, O += P V with V's fragments from ldmatrix.trans. p is
// normalised before it is rounded, as JAX and mha_dense_bth do.
template <typename T, int DP>
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             T* __restrict__ o, int Tn, int NH, int D, float scale, bool drop, uint32_t seed,
                             float keep_prob, float inv_keep, bool vec, int n_res) {
  using L = MmaTile<DP>;
  constexpr int kN = L::kN, kLd = L::kLd, kNT = kN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][kLd]
  __nv_bfloat16* ks = qs + kMmaRows * kLd;                          // [n_res or 1][kN][kLd]
  __nv_bfloat16* vs = ks + (n_res > 0 ? n_res : 1) * kN * kLd;      // the same for V
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * warp;
  const int rows[2] = {q0 + m0 + gq, q0 + m0 + gq + 8};
  const int n_tiles = (Tn + kN - 1) / kN;
  const bool resident = n_res > 0;
  load_tile_bf16<T, DP, kMmaRows>(qs, q, base, q0, Tn, HD, D, vec);
  if (resident) {
    for (int t = 0; t < n_tiles; ++t) {
      load_tile_bf16<T, DP, kN>(ks + t * kN * kLd, k, base, t * kN, Tn, HD, D, vec);
      load_tile_bf16<T, DP, kN>(vs + t * kN * kLd, v, base, t * kN, Tn, HD, D, vec);
    }
  }
  __syncthreads();
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) frag_a(qa[kk], qs, kLd, m0, 16 * kk);

  // the tile's K (and V) in shared memory: resident, or loaded now
  auto stage = [&](int t, bool with_v) -> int {
    if (resident) return t * kN * kLd;
    __syncthreads();  // the previous tile is done with
    load_tile_bf16<T, DP, kN>(ks, k, base, t * kN, Tn, HD, D, vec);
    if (with_v) load_tile_bf16<T, DP, kN>(vs, v, base, t * kN, Tn, HD, D, vec);
    __syncthreads();
    return 0;
  };
  float s[4 * kNT];
  auto scores = [&](const __nv_bfloat16* kt) {
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t bf[2];
        frag_b(bf, kt, kLd, 8 * j, 16 * kk);
        mma_bf16(s + 4 * j, qa[kk], bf);
      }
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] *= scale;
  };

  RowStats rs;
  for (int t = 0; t < n_tiles; ++t) {
    scores(ks + stage(t, false));
    float f[2];
    rs.fold_max(s, t * kN, Tn, tq, f);
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i)
      if (t * kN + frag_col(i, tq) < Tn) rs.add((i >> 1) & 1, s[i]);
  }
  float f[2];
  rs.combine(f);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int off = stage(t, true);
    scores(ks + off);
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      const int col = t * kN + frag_col(i, tq), rr = (i >> 1) & 1;
      const float p = expf(s[i] - rs.m[rr]) / rs.l[rr];
      s[i] = col < Tn ? p * keep_scale(drop, mix, rows[rr], col, keep_prob, inv_keep) : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const float* c0 = s + 8 * kk;  // n-tiles 2 kk and 2 kk + 1: keys 16 kk .. +16
      const uint32_t a[4] = {pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]), pack_bf16(c0[4], c0[5]),
                             pack_bf16(c0[6], c0[7])};
      mma_rows<DP / 8>(acc, a, vs + off, kLd, 16 * kk);
    }
  }
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int row = rows[(i >> 1) & 1], col = frag_col(i, tq);
    if (row >= Tn || col >= D) continue;
    T* dst = o + base + (size_t)row * HD + col;
    if (vec) {  // col even, D % 8 == 0: the pair is whole and aligned
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[i], acc[i + 1]);
      }
    } else {
      dst[0] = w2vb::from_f32<T>(acc[i]);
      if (col + 1 < D) dst[1] = w2vb::from_f32<T>(acc[i + 1]);
    }
  }
}

// dq and the row statistics: block (64 query rows, head, batch row); warp w
// owns rows 16 w .. +16 (accumulator elements as frag_col).
template <typename T, int DP>
__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ stats,
                                int Tn, int NH, int D, float scale, bool drop, uint32_t seed,
                                float keep_prob, float inv_keep, bool vec) {
  using L = MmaTile<DP>;
  constexpr int kN = L::kN, kLd = L::kLd, kNT = kN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][kLd]
  __nv_bfloat16* gs = qs + kMmaRows * kLd;                          // [64][kLd]
  __nv_bfloat16* ks = gs + kMmaRows * kLd;                          // [kN][kLd]
  __nv_bfloat16* vs = ks + kN * kLd;                                // [kN][kLd]
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * warp;
  const int rows[2] = {q0 + m0 + gq, q0 + m0 + gq + 8};
  load_tile_bf16<T, DP, kMmaRows>(qs, q, base, q0, Tn, HD, D, vec);
  load_tile_bf16<T, DP, kMmaRows>(gs, g, base, q0, Tn, HD, D, vec);

  // s (scaled) = q . k^T and dp = g . v^T of the warp's rows against the staged keys
  float s[4 * kNT], dp[4 * kNT];
  auto scores = [&]() {
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t aq[4], ag[4];
      frag_a(aq, qs, kLd, m0, kk);
      frag_a(ag, gs, kLd, m0, kk);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t b[2];
        frag_b(b, ks, kLd, 8 * j, kk);
        mma_bf16(s + 4 * j, aq, b);
        frag_b(b, vs, kLd, 8 * j, kk);
        mma_bf16(dp + 4 * j, ag, b);
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] *= scale;
  };
  auto load_keys = [&](int j0) {
    __syncthreads();  // the previous tile is done with
    load_tile_bf16<T, DP, kN>(ks, k, base, j0, Tn, HD, D, vec);
    load_tile_bf16<T, DP, kN>(vs, v, base, j0, Tn, HD, D, vec);
    __syncthreads();
  };

  // pass 1: per thread, online max, sum and sum of dp * mask * e over its
  // columns; then the 4 threads of a row (tq) combine
  RowStats rs;
  float dn[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < Tn; j0 += kN) {
    load_keys(j0);
    scores();
    float f[2];
    rs.fold_max(s, j0, Tn, tq, f);
    dn[0] *= f[0];
    dn[1] *= f[1];
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      const int col = j0 + frag_col(i, tq), rr = (i >> 1) & 1;
      if (col < Tn) {
        const float e = rs.add(rr, s[i]);
        dn[rr] = fmaf(dp[i] * keep_scale(drop, mix, rows[rr], col, keep_prob, inv_keep), e, dn[rr]);
      }
    }
  }
  float f[2];
  rs.combine(f);
  const float* m = rs.m;
  const float* l = rs.l;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) dn[rr] = quad_sum(dn[rr] * f[rr]) / l[rr];
  if (tq == 0) {
    const size_t nrow = (size_t)gridDim.z * NH * Tn;
    float* st = stats + ((size_t)b * NH + h) * Tn;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (rows[rr] < Tn) {
        st[rows[rr]] = m[rr];
        st[nrow + rows[rr]] = l[rr];
        st[2 * nrow + rows[rr]] = dn[rr];
      }
    }
  }

  // pass 2: ds = p * (dp - D_i), rounded, straight from the accumulators
  // into A fragments; dq += ds_cd . k_cd
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < Tn; j0 += kN) {
    load_keys(j0);
    scores();
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      const int col = j0 + frag_col(i, tq), rr = (i >> 1) & 1;
      const float p = expf(s[i] - m[rr]) / l[rr];
      const float dpm = dp[i] * keep_scale(drop, mix, rows[rr], col, keep_prob, inv_keep);
      s[i] = col < Tn ? p * (dpm - dn[rr]) : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const float* c0 = s + 8 * kk;  // n-tiles 2 kk and 2 kk + 1: keys 16 kk .. +16
      const uint32_t a[4] = {pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]), pack_bf16(c0[4], c0[5]),
                             pack_bf16(c0[6], c0[7])};
      mma_rows<DP / 8>(acc, a, ks, kLd, 16 * kk);
    }
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int row = rows[(i >> 1) & 1], col = frag_col(i, tq);
    if (row < Tn && col < D) dq[base + (size_t)row * HD + col] = w2vb::from_f32<T>(acc[i] * scale);
  }
}

// dk and dv: block (64 keys, head, batch row); warp w owns keys 16 w .. +16
// and streams query tiles with their statistics: s^T = k . q^T, dp^T = v .
// g^T, then pd and ds (rounded) as A fragments: dv += pd^T . g, dk += ds^T . q
template <typename T, int DP>
__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                  const T* __restrict__ g, const float* __restrict__ stats,
                                  T* __restrict__ dk, T* __restrict__ dv, int Tn, int NH, int D, float scale,
                                  bool drop, uint32_t seed, float keep_prob, float inv_keep, bool vec) {
  using L = MmaTile<DP>;
  constexpr int kN = L::kN, kLd = L::kLd, kNT = kN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][kLd]
  __nv_bfloat16* vs = ks + kMmaRows * kLd;                          // [64][kLd]
  __nv_bfloat16* qs = vs + kMmaRows * kLd;                          // [kN][kLd]
  __nv_bfloat16* gs = qs + kN * kLd;                                // [kN][kLd]
  float* st = reinterpret_cast<float*>(gs + kN * kLd);              // [3][kN] m, l, D of the staged rows
  const int k0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * warp;
  const int keys[2] = {k0 + m0 + gq, k0 + m0 + gq + 8};
  const size_t nrow = (size_t)gridDim.z * NH * Tn;
  const float* sb = stats + ((size_t)b * NH + h) * Tn;
  load_tile_bf16<T, DP, kMmaRows>(ks, k, base, k0, Tn, HD, D, vec);
  load_tile_bf16<T, DP, kMmaRows>(vs, v, base, k0, Tn, HD, D, vec);

  float ak[DP / 2], av[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) ak[i] = av[i] = 0.f;
  for (int i0 = 0; i0 < Tn; i0 += kN) {
    __syncthreads();  // the previous tile is done with
    load_tile_bf16<T, DP, kN>(qs, q, base, i0, Tn, HD, D, vec);
    load_tile_bf16<T, DP, kN>(gs, g, base, i0, Tn, HD, D, vec);
    for (int i = threadIdx.x; i < kN; i += blockDim.x) {
      const bool in = i0 + i < Tn;
      st[i] = in ? sb[i0 + i] : 0.f;
      st[kN + i] = in ? sb[nrow + i0 + i] : 1.f;
      st[2 * kN + i] = in ? sb[2 * nrow + i0 + i] : 0.f;
    }
    __syncthreads();
    float s[4 * kNT], dp[4 * kNT];
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t ak_[4], av_[4];
      frag_a(ak_, ks, kLd, m0, kk);
      frag_a(av_, vs, kLd, m0, kk);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t b[2];
        frag_b(b, qs, kLd, 8 * j, kk);
        mma_bf16(s + 4 * j, ak_, b);
        frag_b(b, gs, kLd, 8 * j, kk);
        mma_bf16(dp + 4 * j, av_, b);
      }
    }
    // element i: key keys[(i >> 1) & 1], query i0 + 8 (i >> 2) + 2 tq + (i & 1)
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      const int qq = frag_col(i, tq), qi = i0 + qq;
      float pd = 0.f, ds = 0.f;
      if (qi < Tn) {
        const float p = expf(s[i] * scale - st[qq]) / st[kN + qq];
        const float mk = keep_scale(drop, mix, qi, keys[(i >> 1) & 1], keep_prob, inv_keep);
        pd = p * mk;
        ds = p * (dp[i] * mk - st[2 * kN + qq]);
      }
      s[i] = pd;
      dp[i] = ds;
    }
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const float* p0 = s + 8 * kk;
      const float* d0 = dp + 8 * kk;
      const uint32_t apd[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]), pack_bf16(p0[4], p0[5]),
                               pack_bf16(p0[6], p0[7])};
      const uint32_t ads[4] = {pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]), pack_bf16(d0[4], d0[5]),
                               pack_bf16(d0[6], d0[7])};
      mma_rows<DP / 8>(av, apd, gs, kLd, 16 * kk);
      mma_rows<DP / 8>(ak, ads, qs, kLd, 16 * kk);
    }
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int key = keys[(i >> 1) & 1], col = frag_col(i, tq);
    if (key < Tn && col < D) {
      dk[base + (size_t)key * HD + col] = w2vb::from_f32<T>(ak[i] * scale);
      dv[base + (size_t)key * HD + col] = w2vb::from_f32<T>(av[i]);
    }
  }
}

template <typename T, int DP>
int launch_bwd_mma(const T* q, const T* k, const T* v, const T* g, T* dq, T* dk, T* dv, float* stats, int B,
                   int Tn, int NH, int D, float scale, uint32_t seed, float keep_prob, float inv_keep,
                   cudaStream_t s) {
  using L = MmaTile<DP>;
  const bool drop = keep_prob < 1.f;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g);
  const bool vec = D % 8 == 0 && addr % 16 == 0;
  const size_t smem_kv = L::kSmem + 3 * L::kN * sizeof(float);
  cudaError_t e = w2vb::allow_smem(attention_bwd_dq_mma_kernel<T, DP>, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = w2vb::allow_smem(attention_bwd_dkdv_mma_kernel<T, DP>, smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Tn + kMmaRows - 1) / kMmaRows, NH, B);
  attention_bwd_dq_mma_kernel<T, DP><<<grid, kWarps * 32, L::kSmem, s>>>(
      q, k, v, g, dq, stats, Tn, NH, D, scale, drop, seed, keep_prob, inv_keep, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_dkdv_mma_kernel<T, DP><<<grid, kWarps * 32, smem_kv, s>>>(
      q, k, v, g, stats, dk, dv, Tn, NH, D, scale, drop, seed, keep_prob, inv_keep, vec);
  return static_cast<int>(cudaGetLastError());
}

// a head's K and V tiles stay resident in the tensor-core forward while its
// block's shared memory stays under this (three blocks an SM): T' <= 192 at
// D <= 64, T' <= 96 at D <= 128; longer rows stream one tile at a time
constexpr size_t kResidentSmem = 72 * 1024;

template <typename T, int DP>
int launch_fwd_mma(const T* q, const T* k, const T* v, T* o, int B, int Tn, int NH, int D, float scale,
                   uint32_t seed, float keep_prob, float inv_keep, cudaStream_t s) {
  using L = MmaTile<DP>;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const bool vec = D % 8 == 0 && addr % 16 == 0;
  const int n_tiles = (Tn + L::kN - 1) / L::kN;
  const size_t q_bytes = (size_t)kMmaRows * L::kLd * sizeof(__nv_bfloat16);
  const size_t tile_bytes = (size_t)L::kN * L::kLd * sizeof(__nv_bfloat16);
  const int n_res = q_bytes + 2 * n_tiles * tile_bytes <= kResidentSmem ? n_tiles : 0;
  const size_t smem = q_bytes + 2 * (n_res > 0 ? n_res : 1) * tile_bytes;
  cudaError_t e = w2vb::allow_smem(attention_fwd_mma_kernel<T, DP>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_fwd_mma_kernel<T, DP><<<dim3((Tn + kMmaRows - 1) / kMmaRows, NH, B), kWarps * 32, smem, s>>>(
      q, k, v, o, Tn, NH, D, scale, keep_prob < 1.f, seed, keep_prob, inv_keep, vec, n_res);
  return static_cast<int>(cudaGetLastError());
}

// bf16 compute: the tensor-core kernel (any T', D <= 128); f32 compute: the
// SIMT kernels (TF32 would change the numbers), stream_keys choosing the
// streaming one (the wrapper chooses it where the resident kernel's K and V
// do not fit in shared memory; D <= 128 there)
template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B, int Tn, int NH, int D,
               float scale, bool cd_bf16, bool stream_keys, uint32_t seed, float keep_prob,
               float inv_keep, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (cd_bf16) {
    if (D > 32 * kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
    if (D <= 64)
      return launch_fwd_mma<T, 64>(qt, kt, vt, static_cast<T*>(o), B, Tn, NH, D, scale, seed, keep_prob,
                                   inv_keep, s);
    return launch_fwd_mma<T, 128>(qt, kt, vt, static_cast<T*>(o), B, Tn, NH, D, scale, seed, keep_prob,
                                  inv_keep, s);
  }
  const bool drop = keep_prob < 1.f;
  if (stream_keys) {
    if (D > 32 * kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = ((size_t)(kQT + 2 * kKT) * (D + 1) + kWarps * kRows * kKT) * sizeof(float);
    cudaError_t e = w2vb::allow_smem(attention_fwd_stream_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attention_fwd_stream_kernel<T><<<dim3((Tn + kQT - 1) / kQT, NH, B), kWarps * 32, smem, s>>>(
        qt, kt, vt, static_cast<T*>(o), Tn, NH, D, scale, drop, seed, keep_prob, inv_keep);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem =
      ((size_t)Tn * (2 * D + 1) + (size_t)kWarps * kRows * (D + Tn)) * sizeof(float);
  cudaError_t e = w2vb::allow_smem(attention_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_fwd_kernel<T><<<dim3(NH, B), kWarps * 32, smem, s>>>(
      qt, kt, vt, static_cast<T*>(o), Tn, NH, D, scale, drop, seed, keep_prob, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

// bf16 compute: the tensor-core kernels (head columns padded to 64 or
// 128); f32 compute: the SIMT kernels (TF32 would change the numbers)
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, float* stats, int B, int Tn, int NH, int D, float scale, bool cd_bf16,
               uint32_t seed, float keep_prob, float inv_keep, cudaStream_t s) {
  if (D > 32 * kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  if (cd_bf16) {
    const auto* qt = static_cast<const T*>(q);
    const auto* kt = static_cast<const T*>(k);
    const auto* vt = static_cast<const T*>(v);
    const auto* gt = static_cast<const T*>(g);
    auto* dqt = static_cast<T*>(dq);
    auto* dkt = static_cast<T*>(dk);
    auto* dvt = static_cast<T*>(dv);
    if (D <= 64)
      return launch_bwd_mma<T, 64>(qt, kt, vt, gt, dqt, dkt, dvt, stats, B, Tn, NH, D, scale, seed,
                                   keep_prob, inv_keep, s);
    return launch_bwd_mma<T, 128>(qt, kt, vt, gt, dqt, dkt, dvt, stats, B, Tn, NH, D, scale, seed,
                                  keep_prob, inv_keep, s);
  }
  const bool drop = keep_prob < 1.f;
  const size_t smem_dq = ((size_t)(2 * kQT + 2 * kKT) * (D + 1) + kWarps * kRows * kKT) * sizeof(float);
  const size_t smem_kv =
      ((size_t)(2 * kKT2 + 2 * kQT2) * (D + 1) + 3 * kQT2 + 2 * kWarps * kKeys * kQT2) * sizeof(float);
  cudaError_t e = w2vb::allow_smem(attention_bwd_dq_kernel<T>, smem_dq);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = w2vb::allow_smem(attention_bwd_dkdv_kernel<T>, smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  attention_bwd_dq_kernel<T><<<dim3((Tn + kQT - 1) / kQT, NH, B), kWarps * 32, smem_dq, s>>>(
      qt, kt, vt, gt, static_cast<T*>(dq), stats, Tn, NH, D, scale, drop, seed, keep_prob,
      inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_dkdv_kernel<T><<<dim3((Tn + kKT2 - 1) / kKT2, NH, B), kWarps * 32, smem_kv, s>>>(
      qt, kt, vt, gt, stats, static_cast<T*>(dk), static_cast<T*>(dv), Tn, NH, D, scale, drop,
      seed, keep_prob, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io_bf16: q/k/v/o are bf16 (the activation stream dtype) rather than f32;
// cd_bf16: the compute dtype is bf16 (the tensor-core kernel). keep_prob < 1
// turns the dropout on (keep_prob and inv_keep = 1/keep_prob as f32, seed the
// site's int32). stream_keys, at f32 compute: the streaming SIMT kernel
// instead of the one that holds a head's K and V in shared memory.
extern "C" int w2vb_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                  int io_bf16, int cd_bf16, int stream_keys, int B, int T, int NH,
                                  int D, float scale, int seed, float keep_prob, float inv_keep,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  if (io_bf16)
    return launch_fwd<__nv_bfloat16>(q, k, v, o, B, T, NH, D, scale, cd_bf16 != 0, stream_keys != 0,
                                     sd, keep_prob, inv_keep, s);
  return launch_fwd<float>(q, k, v, o, B, T, NH, D, scale, cd_bf16 != 0, stream_keys != 0, sd,
                           keep_prob, inv_keep, s);
}

// g, dq, dk, dv share q's dtype (io_bf16); stats is a (3, B, NH, T) f32
// scratch (the softmax max, sum and D_i of every query row).
extern "C" int w2vb_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                  void* dq, void* dk, void* dv, float* stats, int io_bf16,
                                  int cd_bf16, int B, int T, int NH, int D, float scale, int seed,
                                  float keep_prob, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  if (io_bf16)
    return launch_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, stats, B, T, NH, D, scale,
                                     cd_bf16 != 0, sd, keep_prob, inv_keep, s);
  return launch_bwd<float>(q, k, v, g, dq, dk, dv, stats, B, T, NH, D, scale, cd_bf16 != 0, sd,
                           keep_prob, inv_keep, s);
}
