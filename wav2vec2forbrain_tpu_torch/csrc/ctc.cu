// CTC loss per sample and its gradient, each sum in a fixed order.
//
// Replaces: no TPU kernel. The JAX package takes optax.ctc_loss
// (wav2vec2forbrain_tpu/ops/ctc.py:43), a lax.scan that XLA runs. The port
// ran F.ctc_loss, whose CUDA backward is not reproducible at w2v-base's
// batch: at B 64 and T' 169 or 230 every one of 19 repeated backward calls
// gave another gradient (bits 1e-11 apart), at T' 89 and at B 32 none did
// (probe_determinism.py), so two w2v-base trainings from one seed drifted
// apart. This kernel computes what F.ctc_loss(log_probs, targets,
// in_lens, tgt_lens, blank, reduction="none", zero_infinity=True) and its
// backward compute, deterministically.
//
// For sample b (one block), with T_b = in_lens[b], L = tgt_lens[b], the
// extended labels l'(s), s < S_b = 2 L + 1 (blank at even s, target
// (s - 1) / 2 at odd s), and lp = log_probs[b] (T, K):
//   alpha_0(s) = lp[0][l'(s)] for s < 2, else -inf
//   alpha_t(s) = lp[t][l'(s)] + lse(alpha_{t-1}(s), alpha_{t-1}(s - 1),
//                alpha_{t-1}(s - 2) where l'(s) != blank, l'(s) != l'(s - 2))
//   nll = -lse(alpha_{T_b-1}(S_b - 1), alpha_{T_b-1}(S_b - 2))
//   beta_{T_b-1}(s) = lp[T_b-1][l'(s)] for s >= S_b - 2, else -inf
//   beta_t(s) = lp[t][l'(s)] + lse(beta_{t+1}(s), beta_{t+1}(s + 1),
//               beta_{t+1}(s + 2) where l'(s) != blank, l'(s + 2) != l'(s))
//   grad[t][c] = exp(lp[t][c]) - exp(lse_{s: l'(s) = c}(alpha_t(s) +
//                beta_t(s)) + nll - lp[t][c])    for t < T_b, else 0
// which is F.ctc_loss's gradient with respect to log_probs (it folds in the
// log_softmax Jacobian's exp(lp) term, as torch does). An infinite nll (no
// alignment) gives nll 0 and a zero gradient (zero_infinity). lse of three
// terms is torch's: the max taken out, a max of -inf taken as 0.
//
// Design: one block of 256 threads per sample. The alpha recursion runs in
// two shared-memory rows, threads over s, one __syncthreads a step, and
// each row is also written to a (B, T, S) f32 scratch in global memory. The
// beta rows then run backwards in time in two more shared rows; at each t
// the alpha row comes back from the scratch into a shared row (the alpha
// rows, free by then, double-buffered), and the threads over classes c sum
// alpha + beta over the positions of c in increasing s (an online
// log-sum-exp, no atomics), so the result has the same bits every call.
// What bounds it is the chain of T dependent steps a sample, each a few
// hundred cycles: it is latency-bound, far from the bytes it moves
// (log_probs read twice, the gradient written once).

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxU = 1200;  // targets a sample: the shared rows take 20 (2 U + 1) bytes, under 48 KiB

__device__ __forceinline__ float lse3(float a, float b, float c) {
  float m = fmaxf(a, fmaxf(b, c));
  if (m == -CUDART_INF_F) m = 0.f;
  return logf(expf(a - m) + expf(b - m) + expf(c - m)) + m;
}

// One sample's nll, and where grad is given, its gradient (B, T, K).
__global__ void __launch_bounds__(kThreads) ctc_kernel(const float* __restrict__ lp, const int* __restrict__ targets,
                                                       const int* __restrict__ in_lens,
                                                       const int* __restrict__ tgt_lens, float* __restrict__ alpha,
                                                       float* __restrict__ nll, float* __restrict__ grad, int T, int K,
                                                       int U, int blank) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1;
  float* arow = smem;                                   // 2 rows of S: alpha
  float* beta = smem + 2 * S;                           // 2 rows of S
  int* lab = reinterpret_cast<int*>(smem + 4 * S);      // S extended labels
  __shared__ float nll_s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int Tb = min(max(in_lens[b], 0), T);
  const int L = min(max(tgt_lens[b], 0), U);
  const int Sb = 2 * L + 1;
  const float* lpb = lp + static_cast<size_t>(b) * T * K;
  float* al = alpha + static_cast<size_t>(b) * T * S;

  for (int s = tid; s < Sb; s += kThreads) lab[s] = (s & 1) ? targets[static_cast<size_t>(b) * U + (s >> 1)] : blank;
  __syncthreads();

  if (Tb > 0) {
    for (int s = tid; s < Sb; s += kThreads) al[s] = arow[s] = s < 2 ? lpb[lab[s]] : -CUDART_INF_F;
    __syncthreads();
    for (int t = 1; t < Tb; ++t) {
      const float* prev = arow + ((t - 1) & 1) * S;
      float* cur = arow + (t & 1) * S;
      float* out = al + static_cast<size_t>(t) * S;
      const float* lpt = lpb + static_cast<size_t>(t) * K;
      for (int s = tid; s < Sb; s += kThreads) {
        const int l = lab[s];
        const float a1 = s > 0 ? prev[s - 1] : -CUDART_INF_F;
        const float a2 = (s > 1 && l != blank && l != lab[s - 2]) ? prev[s - 2] : -CUDART_INF_F;
        out[s] = cur[s] = lse3(prev[s], a1, a2) + lpt[l];
      }
      __syncthreads();
    }
  }
  if (tid == 0) {
    float v = CUDART_INF_F;
    if (Tb > 0) {
      const float* last = arow + ((Tb - 1) & 1) * S;
      const float l1 = last[Sb - 1];
      const float l2 = Sb > 1 ? last[Sb - 2] : -CUDART_INF_F;
      float m = fmaxf(l1, l2);
      if (m == -CUDART_INF_F) m = 0.f;
      v = -(logf(expf(l1 - m) + expf(l2 - m)) + m);
    }
    nll_s = v;
    nll[b] = v == CUDART_INF_F ? 0.f : v;  // zero_infinity
  }
  if (grad == nullptr) return;
  __syncthreads();  // nll_s written; the alpha rows are free for the staged rows below
  const float nv = nll_s;
  float* gb = grad + static_cast<size_t>(b) * T * K;
  const int live = nv == CUDART_INF_F ? 0 : Tb;  // no alignment: a zero gradient
  for (size_t i = static_cast<size_t>(live) * K + tid; i < static_cast<size_t>(T) * K; i += kThreads) gb[i] = 0.f;

  for (int t = live - 1; t >= 0; --t) {
    float* bt = beta + (t & 1) * S;
    const float* bn = beta + ((t + 1) & 1) * S;
    const float* lpt = lpb + static_cast<size_t>(t) * K;
    float* at = arow + (t & 1) * S;  // alpha_t, staged from the scratch
    const float* al_t = al + static_cast<size_t>(t) * S;
    for (int s = tid; s < Sb; s += kThreads) {
      const int l = lab[s];
      at[s] = al_t[s];
      if (t == live - 1) {
        bt[s] = s >= Sb - 2 ? lpt[l] : -CUDART_INF_F;
      } else {
        const float b1 = s + 1 < Sb ? bn[s + 1] : -CUDART_INF_F;
        const float b2 = (s + 2 < Sb && l != blank && lab[s + 2] != l) ? bn[s + 2] : -CUDART_INF_F;
        bt[s] = lse3(bn[s], b1, b2) + lpt[l];
      }
    }
    __syncthreads();  // beta_t and alpha_t complete; the next step writes the other rows
    for (int c = tid; c < K; c += kThreads) {
      float m = -CUDART_INF_F, sum = 0.f;
      const int first = c == blank ? 0 : 1;
      for (int s = first; s < Sb; s += 2) {
        if (c != blank && lab[s] != c) continue;
        const float x = at[s] + bt[s];
        if (x == -CUDART_INF_F) continue;
        if (x > m) {
          sum = sum * expf(m - x) + 1.f;
          m = x;
        } else {
          sum += expf(x - m);
        }
      }
      const float lcab = m == -CUDART_INF_F ? -CUDART_INF_F : m + logf(sum);
      const float lpv = lpt[c];
      gb[static_cast<size_t>(t) * K + c] = expf(lpv) - expf(lcab + nv - lpv);
    }
  }
}

}  // namespace

// lp (B, T, K) f32 log-probabilities; targets (B, U) int32 (any value past
// tgt_lens); in_lens, tgt_lens (B) int32; alpha (B, T, 2 U + 1) f32
// scratch; nll (B) f32; grad (B, T, K) f32, or null for the nll alone
extern "C" int w2vb_ctc(const float* lp, const int* targets, const int* in_lens, const int* tgt_lens, float* alpha,
                        float* nll, float* grad, int B, int T, int K, int U, int blank, void* stream) {
  if (B < 1 || T < 1 || K < 1 || U < 0 || U > kMaxU || blank < 0 || blank >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2 * U + 1) * (4 * sizeof(float) + sizeof(int));
  ctc_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(lp, targets, in_lens, tgt_lens, alpha, nll,
                                                                      grad, T, K, U, blank);
  return static_cast<int>(cudaGetLastError());
}
