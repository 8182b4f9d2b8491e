// Row LayerNorm, forward and backward.
//
// Replaces: wav2vec2forbrain_tpu/ops/pallas_layernorm.py::_fwd_impl (the
// Pallas kernel _fwd_kernel) and ::_bwd_impl (_bwd_kernel). For each row of
// x (B, T, C) in the activation-stream dtype (f32 or bf16), in f32:
//   mu = mean(x);  xc = x - mu;  var = mean(xc * xc);  rstd = 1 / sqrt(var + eps)
//   y = (xc * rstd) * scale + bias          emitted in x's dtype
// Backward, for the upstream gradient dy (already in x's dtype, as the JAX
// _vjp_bwd casts it), stats recomputed from x:
//   xhat = xc * rstd;  w = dy * scale
//   dx = rstd * (w - mean(w) - xhat * mean(w * xhat))      in x's dtype
//   dgamma_part[b] = sum_t dy * xhat,  dbeta_part[b] = sum_t dy   (B, C) f32
// The sum of the partials over B runs outside, in the wrapper, in a fixed
// order (the JAX package leaves it to XLA outside the kernel too).
//
// What bounds it on the H100: bytes. One read of x and one write of y
// (forward), reads of x and dy and a write of dx (backward): a few flops per
// byte, far below the ~20 flops/byte where f32 CUDA-core arithmetic would
// take over. At 64 x 89 x 768 f32 the forward moves ~35 MB: ~10 us at
// 3.35 TB/s.
//
// Design: one warp per row (C <= 1024, so a lane holds at most 32 values in
// registers); neighbouring lanes read neighbouring channels, so every load
// and store is coalesced, and x is read once. The row sums are warp
// butterflies (every lane ends with the same bits). The backward's dx pass
// is the same warp-per-row layout and also stores each row's (mu, rstd);
// the (B, C) partials come from a second launch with one block per batch
// element and 256 columns, which walks its T rows in order: no atomics,
// deterministic.
#include "common.cuh"

namespace {

constexpr int kMaxPerLane = 32;  // C <= 32 * 32 = 1024
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// mu and rstd of one row held as v[k] = x[lane + 32 k]
__device__ __forceinline__ void row_stats(const float (&v)[kMaxPerLane], int lane, int C, float eps,
                                          float& mu, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k)
    if (lane + 32 * k < C) s += v[k];
  mu = w2vb::warp_sum(s) / static_cast<float>(C);
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k)
    if (lane + 32 * k < C) {
      const float c = v[k] - mu;
      q = fmaf(c, c, q);
    }
  const float var = w2vb::warp_sum(q) / static_cast<float>(C);
  rstd = 1.f / sqrtf(var + eps);
}

template <typename T>
__global__ void layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                     const float* __restrict__ bias, T* __restrict__ y, int rows,
                                     int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * C;
  float v[kMaxPerLane];
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < C ? load_f32(x, base + c) : 0.f;
  }
  float mu, rstd;
  row_stats(v, lane, C, eps, mu, rstd);
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < C) y[base + c] = w2vb::from_f32<T>(((v[k] - mu) * rstd) * scale[c] + bias[c]);
  }
}

template <typename T>
__global__ void layernorm_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                        const T* __restrict__ dy, T* __restrict__ dx,
                                        float2* __restrict__ stats, int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * C;
  float v[kMaxPerLane], w[kMaxPerLane];
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < C ? load_f32(x, base + c) : 0.f;
    w[k] = c < C ? load_f32(dy, base + c) * scale[c] : 0.f;
  }
  float mu, rstd;
  row_stats(v, lane, C, eps, mu, rstd);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    if (lane + 32 * k < C) {
      v[k] = (v[k] - mu) * rstd;  // xhat from here on
      s1 += w[k];
      s2 = fmaf(w[k], v[k], s2);
    }
  }
  const float m1 = w2vb::warp_sum(s1) / static_cast<float>(C);
  const float m2 = w2vb::warp_sum(s2) / static_cast<float>(C);
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < C) dx[base + c] = w2vb::from_f32<T>(rstd * (w[k] - m1 - v[k] * m2));
  }
  if (lane == 0) stats[row] = make_float2(mu, rstd);
}

// dg[b, c] = sum_t dy[b, t, c] * xhat[b, t, c];  db[b, c] = sum_t dy[b, t, c]
template <typename T>
__global__ void layernorm_bwd_param_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                           const float2* __restrict__ stats, float* __restrict__ dg,
                                           float* __restrict__ db, int Tn, int C) {
  const int b = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sg = 0.f, sb = 0.f;
  for (int t = 0; t < Tn; ++t) {
    const size_t row = (size_t)b * Tn + t;
    const float2 st = stats[row];
    const float g = load_f32(dy, row * C + c);
    sg = fmaf(g, (load_f32(x, row * C + c) - st.x) * st.y, sg);
    sb += g;
  }
  dg[(size_t)b * C + c] = sg;
  db[(size_t)b * C + c] = sb;
}

template <typename T>
int launch_fwd(const void* x, const float* scale, const float* bias, void* y, int rows, int C,
               float eps, cudaStream_t s) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layernorm_fwd_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const float* scale, const void* dy, void* dx, float* stats, float* dg,
               float* db, int B, int Tn, int C, float eps, cudaStream_t s) {
  const int rows = B * Tn;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  float2* st = reinterpret_cast<float2*>(stats);
  layernorm_bwd_dx_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy), static_cast<T*>(dx), st, rows, C,
      eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B, (C + 255) / 256);
  layernorm_bwd_param_kernel<T><<<grid, 256, 0, s>>>(static_cast<const T*>(x),
                                                     static_cast<const T*>(dy), st, dg, db, Tn, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y (rows, C) in the stream dtype (io_bf16: bf16, else f32); scale, bias (C,) f32
extern "C" int w2vb_layernorm_fwd(const void* x, const float* scale, const float* bias, void* y,
                                  int io_bf16, int rows, int C, float eps, void* stream) {
  if (C > 32 * kMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io_bf16) return launch_fwd<__nv_bfloat16>(x, scale, bias, y, rows, C, eps, s);
  return launch_fwd<float>(x, scale, bias, y, rows, C, eps, s);
}

// x, dy, dx (B, T, C) in the stream dtype; stats a (B * T, 2) f32 scratch;
// dg, db (B, C) f32 per-batch-element partials
extern "C" int w2vb_layernorm_bwd(const void* x, const float* scale, const void* dy, void* dx,
                                  float* stats, float* dg, float* db, int io_bf16, int B, int T,
                                  int C, float eps, void* stream) {
  if (C > 32 * kMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io_bf16) return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, stats, dg, db, B, T, C, eps, s);
  return launch_bwd<float>(x, scale, dy, dx, stats, dg, db, B, T, C, eps, s);
}
