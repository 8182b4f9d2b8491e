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
// and does ~1 GFLOP; the (T, T) scores of one head are 32 KB. The cost is
// latency, shared-memory load instructions and the number of blocks in
// flight.
//
// Forward design: one block (4 warps) per (batch, head), 512 blocks at the
// slice's shape. The head's K and V (T x 64 each, rounded to the compute
// dtype, f32) sit in shared memory; K rows are padded to D + 1 floats so
// that 32 lanes reading 32 different keys hit 32 different banks. Each warp
// takes four query rows at a time, so every K and V value it reads from
// shared memory feeds four FMAs: lanes compute the scores of keys lane,
// lane+32, ... for the four rows into a per-warp buffer, each row's max and
// sum are warp shuffles (whole-row f32 softmax; the ragged edge of T = 89 is
// just the loop bound), the dropout mask is hashed in place, and then lanes
// own output columns and sum p * V over all keys. Scores and probabilities
// never leave shared memory.
//
// Backward design: two launches whose shared memory does not grow with T
// (any T the forward takes; D <= 128), no atomics, deterministic.
//  1. dq, over (query tile of 16 rows, head, batch row); 4 warps of 4 rows,
//     as in the forward. The block streams 64-key tiles of K and V (rounded
//     to the compute dtype) through shared memory twice. Pass 1: lanes over
//     keys compute s and dp = g . v for the warp's 4 rows and keep a
//     lane-local online softmax max m, sum l and sum of dp * mask * e; warp
//     shuffles combine the lanes into the row statistics m, l and D_i =
//     sum_j dp_ij p_ij (dp masked and scaled), written to a (3, B, heads, T)
//     f32 scratch. Pass 2: p = exp(s - m) / l, ds = p * (dp - D_i) rounded to
//     the compute dtype into a per-warp buffer, then lanes over columns sum
//     ds . k for the 4 rows.
//  2. dk and dv, over (key tile of 16 keys, head, batch row); each warp
//     takes 4 keys. The block streams 32-query tiles of q and g with their
//     row statistics; lanes over queries recompute s, dp, p and the mask and
//     store the rounded pd = p * mask / keep and ds, then lanes over columns
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
                                     int D, float scale, bool cd_bf16, bool drop, uint32_t seed,
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
    ks[r * ldk + c] = w2vb::round_cd(w2vb::to_f32(k[g]), cd_bf16);
    vs[r * D + c] = w2vb::round_cd(w2vb::to_f32(v[g]), cd_bf16);
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
      qw[i] = rr < nr ? w2vb::round_cd(w2vb::to_f32(q[base + (size_t)(r0 + rr) * HD + c]), cd_bf16)
                      : 0.f;
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
        pw[rr * Tn + c] = w2vb::round_cd(p, cd_bf16);
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

constexpr int kQT = kWarps * kRows;  // query rows per block of the dq kernel
constexpr int kKT = 64;              // keys per tile it streams
constexpr int kKeys = 4;             // keys a warp takes at once in the dk/dv kernel
constexpr int kKT2 = kWarps * kKeys;  // keys per block there
constexpr int kQT2 = 32;             // queries per tile it streams, one per lane
constexpr int kMaxCols = 4;          // head columns per lane: D <= 128

// rows [r0, r0 + n) of one head into shared memory [n][D + 1], rounded to
// the compute dtype; rows at or past Tn are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, size_t base, int r0,
                                          int n, int Tn, int HD, int D, bool cd_bf16) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * (D + 1) + c] =
        r0 + r < Tn ? w2vb::round_cd(w2vb::to_f32(src[base + (size_t)(r0 + r) * HD + c]), cd_bf16)
                    : 0.f;
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
                                        int NH, int D, float scale, bool cd_bf16, bool drop,
                                        uint32_t seed, float keep_prob, float inv_keep) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  float* qs = sm;                // [kQT][D + 1]
  float* gs = qs + kQT * ld;     // [kQT][D + 1]
  float* ks = gs + kQT * ld;     // [kKT][D + 1]
  float* vs = ks + kKT * ld;     // [kKT][D + 1]
  float* dsb = vs + kKT * ld;    // [kWarps][kRows][kKT] ds, rounded to cd
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qw = qs + warp * kRows * ld;
  const float* gw = gs + warp * kRows * ld;
  float* dw = dsb + warp * kRows * kKT;
  const int r0 = q0 + warp * kRows;
  load_rows(qs, q, base, q0, kQT, Tn, HD, D, cd_bf16);
  load_rows(gs, g, base, q0, kQT, Tn, HD, D, cd_bf16);

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
    load_rows(ks, k, base, j0, kKT, Tn, HD, D, cd_bf16);
    load_rows(vs, v, base, j0, kKT, Tn, HD, D, cd_bf16);
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
          dw[rr * kKT + jj] = w2vb::round_cd(p * (dpm - dn[rr]), cd_bf16);
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
                                          bool cd_bf16, bool drop, uint32_t seed, float keep_prob,
                                          float inv_keep) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  float* ks = sm;                      // [kKT2][D + 1]
  float* vs = ks + kKT2 * ld;          // [kKT2][D + 1]
  float* qs = vs + kKT2 * ld;          // [kQT2][D + 1]
  float* gs = qs + kQT2 * ld;          // [kQT2][D + 1]
  float* st = gs + kQT2 * ld;          // [3][kQT2] m, l, D of the staged rows
  float* pdb = st + 3 * kQT2;          // [kWarps][kKeys][kQT2] pd, rounded to cd
  float* dsb = pdb + kWarps * kKeys * kQT2;  // [kWarps][kKeys][kQT2] ds, rounded to cd
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
  load_rows(ks, k, base, k0, kKT2, Tn, HD, D, cd_bf16);
  load_rows(vs, v, base, k0, kKT2, Tn, HD, D, cd_bf16);

  float ak[kKeys][kMaxCols], av[kKeys][kMaxCols];
#pragma unroll
  for (int kk = 0; kk < kKeys; ++kk)
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) ak[kk][cc] = av[kk][cc] = 0.f;
  for (int i0 = 0; i0 < Tn; i0 += kQT2) {
    __syncthreads();  // the previous tile is done with
    load_rows(qs, q, base, i0, kQT2, Tn, HD, D, cd_bf16);
    load_rows(gs, g, base, i0, kQT2, Tn, HD, D, cd_bf16);
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
        pd = w2vb::round_cd(p * mk, cd_bf16);
        ds = w2vb::round_cd(p * (dp[kk] * mk - st[2 * kQT2 + lane]), cd_bf16);
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

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B, int Tn, int NH, int D,
               float scale, bool cd_bf16, uint32_t seed, float keep_prob, float inv_keep,
               cudaStream_t s) {
  const size_t smem =
      ((size_t)Tn * (2 * D + 1) + (size_t)kWarps * kRows * (D + Tn)) * sizeof(float);
  cudaError_t e = w2vb::allow_smem(attention_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(NH, B);
  attention_fwd_kernel<T><<<grid, kWarps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Tn, NH, D, scale, cd_bf16, keep_prob < 1.f, seed, keep_prob, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, float* stats, int B, int Tn, int NH, int D, float scale, bool cd_bf16,
               uint32_t seed, float keep_prob, float inv_keep, cudaStream_t s) {
  if (D > 32 * kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
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
      qt, kt, vt, gt, static_cast<T*>(dq), stats, Tn, NH, D, scale, cd_bf16, drop, seed, keep_prob,
      inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_dkdv_kernel<T><<<dim3((Tn + kKT2 - 1) / kKT2, NH, B), kWarps * 32, smem_kv, s>>>(
      qt, kt, vt, gt, stats, static_cast<T*>(dk), static_cast<T*>(dv), Tn, NH, D, scale, cd_bf16,
      drop, seed, keep_prob, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io_bf16: q/k/v/o are bf16 (the activation stream dtype) rather than f32;
// cd_bf16: the compute dtype is bf16. keep_prob < 1 turns the dropout on
// (keep_prob and inv_keep = 1/keep_prob as f32, seed the site's int32).
extern "C" int w2vb_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                  int io_bf16, int cd_bf16, int B, int T, int NH, int D,
                                  float scale, int seed, float keep_prob, float inv_keep,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  if (io_bf16)
    return launch_fwd<__nv_bfloat16>(q, k, v, o, B, T, NH, D, scale, cd_bf16 != 0, sd, keep_prob,
                                     inv_keep, s);
  return launch_fwd<float>(q, k, v, o, B, T, NH, D, scale, cd_bf16 != 0, sd, keep_prob, inv_keep,
                           s);
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
