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
// Backward design: one block (8 warps) per (batch, head). At T = 89 the
// whole (T, T) tile fits: q, k, v, g (T x (D + 1) each) and two (T, T + 1)
// tiles, 157 KB. A warp owns a query row: lanes over keys compute the
// scores, the row softmax, dp and the row sum of dp * p, and store the
// rounded dropped probabilities pd and ds in the two tiles. After one block
// barrier, dq rows (lanes over columns, keys in the inner loop) and the dk
// and dv rows (lanes over columns, query rows in the inner loop) are
// reductions inside the block: no atomics, no partials in device memory.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;  // query rows a warp takes at once
constexpr int kBwdWarps = 8;

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

template <typename T>
__global__ void attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, const T* __restrict__ g,
                                     T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                                     int Tn, int NH, int D, float scale, bool cd_bf16, bool drop,
                                     uint32_t seed, float keep_prob, float inv_keep) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  const int ldp = Tn + 1;
  float* qs = sm;               // [Tn][D + 1], compute-dtype values
  float* ks = qs + Tn * ld;
  float* vs = ks + Tn * ld;
  float* gs = vs + Tn * ld;
  float* pd = gs + Tn * ld;     // [Tn][Tn + 1] dropped probs, rounded to cd
  float* dss = pd + Tn * ldp;   // [Tn][Tn + 1] ds, rounded to cd
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, b, h);

  for (int i = threadIdx.x; i < Tn * D; i += blockDim.x) {
    const int r = i / D;
    const int c = i - r * D;
    const size_t gi = base + (size_t)r * HD + c;
    qs[r * ld + c] = w2vb::round_cd(w2vb::to_f32(q[gi]), cd_bf16);
    ks[r * ld + c] = w2vb::round_cd(w2vb::to_f32(k[gi]), cd_bf16);
    vs[r * ld + c] = w2vb::round_cd(w2vb::to_f32(v[gi]), cd_bf16);
    gs[r * ld + c] = w2vb::round_cd(w2vb::to_f32(g[gi]), cd_bf16);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < Tn; i += kBwdWarps) {
    const float* qr = qs + i * ld;
    const float* gr = gs + i * ld;
    float* pr = pd + i * ldp;   // scores, then probabilities, then pd
    float* dr = dss + i * ldp;  // dp, then ds
    float mx = __int_as_float(0xff800000);
    for (int j = lane; j < Tn; j += 32) {
      const float* kr = ks + j * ld;
      const float* vr = vs + j * ld;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(gr[d], vr[d], dp);
      }
      s *= scale;
      pr[j] = s;
      dr[j] = dp;
      mx = fmaxf(mx, s);
    }
    mx = w2vb::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    sum = w2vb::warp_sum(sum);
    // a lane touches only its own columns j, so the passes need no
    // __syncwarp between them; the reductions are shuffles
    float dot = 0.f;  // sum_j dp * p
    for (int j = lane; j < Tn; j += 32) {
      const float p = pr[j] / sum;
      const float m = drop ? (w2vb::attn_keep(mix, i, j, keep_prob) ? inv_keep : 0.f) : 1.f;
      const float dp = dr[j] * m;
      pr[j] = p;
      dr[j] = dp;
      dot = fmaf(dp, p, dot);
    }
    dot = w2vb::warp_sum(dot);
    for (int j = lane; j < Tn; j += 32) {
      const float p = pr[j];
      const float m = drop ? (w2vb::attn_keep(mix, i, j, keep_prob) ? inv_keep : 0.f) : 1.f;
      dr[j] = w2vb::round_cd(p * (dr[j] - dot), cd_bf16);
      pr[j] = w2vb::round_cd(p * m, cd_bf16);
    }
  }
  __syncthreads();

  // dq[i, :] = scale * sum_j ds[i, j] k[j, :]
  for (int i = warp; i < Tn; i += kBwdWarps) {
    const float* dr = dss + i * ldp;
    for (int c = lane; c < D; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < Tn; ++j) acc = fmaf(dr[j], ks[j * ld + c], acc);
      dq[base + (size_t)i * HD + c] = w2vb::from_f32<T>(acc * scale);
    }
  }
  // dk[j, :] = scale * sum_i ds[i, j] q[i, :];  dv[j, :] = sum_i pd[i, j] g[i, :]
  for (int j = warp; j < Tn; j += kBwdWarps) {
    for (int c = lane; c < D; c += 32) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < Tn; ++i) {
        ak = fmaf(dss[i * ldp + j], qs[i * ld + c], ak);
        av = fmaf(pd[i * ldp + j], gs[i * ld + c], av);
      }
      dk[base + (size_t)j * HD + c] = w2vb::from_f32<T>(ak * scale);
      dv[base + (size_t)j * HD + c] = w2vb::from_f32<T>(av);
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
               void* dv, int B, int Tn, int NH, int D, float scale, bool cd_bf16, uint32_t seed,
               float keep_prob, float inv_keep, cudaStream_t s) {
  const size_t smem = ((size_t)4 * Tn * (D + 1) + (size_t)2 * Tn * (Tn + 1)) * sizeof(float);
  cudaError_t e = w2vb::allow_smem(attention_bwd_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(NH, B);
  attention_bwd_kernel<T><<<grid, kBwdWarps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), Tn,
      NH, D, scale, cd_bf16, keep_prob < 1.f, seed, keep_prob, inv_keep);
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

// g, dq, dk, dv share q's dtype (io_bf16).
extern "C" int w2vb_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                  void* dq, void* dk, void* dv, int io_bf16, int cd_bf16, int B,
                                  int T, int NH, int D, float scale, int seed, float keep_prob,
                                  float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  if (io_bf16)
    return launch_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, B, T, NH, D, scale, cd_bf16 != 0, sd,
                                     keep_prob, inv_keep, s);
  return launch_bwd<float>(q, k, v, g, dq, dk, dv, B, T, NH, D, scale, cd_bf16 != 0, sd, keep_prob,
                           inv_keep, s);
}
