// Fused B2P2T preprocessing, forward.
//
// Replaces: wav2vec2forbrain_tpu/ops/pallas_preproc.py::_fused_fwd_impl
// (the Pallas kernel _fwd_kernel): per sample, a 20-tap gaussian smoothing
// over time with torch 'same' padding ((k-1)/2 = 9 frames left, k/2 = 10
// right), the day-conditioned affine x @ W[day] + b[day] (256 x 256, day
// picked per sample), softsign, and an unfold (window 32, stride 4) into
// (T', 256 * 32) rows in channel-major order c * 32 + j.
//
// What bounds it on the H100: bytes written. At the serving shape (B=32,
// T=384) the output is 32 x 89 x 8192 f32 = 93 MB, eight times the input
// and sixteen times the smoothed/affined intermediate. The affine is 1.6
// GFLOP of f32 FMA, well under the card's f32 rate.
//
// Design, two launches:
//  1. smooth_affine: one block per (sample, 32-row time tile), one thread per
//     channel. The block smooths its 32 rows into shared memory, then each
//     thread walks the 256 rows of W[day] (read once per block, coalesced,
//     resident in the 50 MB L2 across blocks) and keeps 32 f32 accumulators,
//     so every W load feeds 32 FMAs. The day index is read by the block
//     itself, standing in for the TPU kernel's scalar prefetch. The result
//     z (B, T, 256) f32 is 12.6 MB and stays in L2 for the next launch.
//  2. unfold: one block per (sample, output row t'). The block stages the 32
//     z rows of its window in shared memory (row pitch 257 floats, so the
//     transposed read below is free of bank conflicts) and writes the 8192
//     output floats of row t' with consecutive threads on consecutive
//     addresses: the 93 MB write is fully coalesced.
// The f32 affine is computed in the kernel (FMA), not by a library GEMM.
// An out-of-range day index is clamped to [0, n_days), as XLA's gather
// clamps it in the JAX package; no memory outside W is read.
//
// Backward (replaces ::_fused_bwd_impl, the Pallas kernel _bwd_kernel), for
// the upstream g (B, T', 256 * 32), channel-major like the forward's output:
//   y = smooth(x) and pre = y @ W[day] + b[day], recomputed (not saved)
//   dz[t, c] = sum over the windows t' and offsets j with t'*4 + j = t of
//              g[t', c*32 + j], divided by (1 + |pre[t, c]|)^2
//   dW_b = y^T dz and db_b = sum_t dz per sample (summed into the day
//   tables outside, ops/preproc.py); dy = dz @ W[day]^T; dx = the smoothing
//   with the reversed taps and swapped padding applied to dy.
// What bounds it: reading g (93 MB at B=32, T=384) and the per-sample dW
// product (32 x 256 x 384 x 256 = 0.8 GFLOP f32 FMA).
// Design, three launches:
//  1. dz_dy: one block per (sample, 32-row time tile), a thread per channel,
//     like the forward's affine: smooth and affine its rows again (pre in
//     32 registers), then walk the ~16 windows that overlap the tile. Each
//     window's 8192-float g row is staged in shared memory with a row pitch
//     of 33 floats (the forward's transposed staging in reverse: the row is
//     read coalesced, and the transposed read c*33 + j is free of bank
//     conflicts), and every thread adds its channel's entries into its 32
//     row accumulators. Then dz = acc / (1 + |pre|)^2 goes to shared memory
//     and to a (B, T, 256) scratch, and dy = dz @ W^T is the forward's
//     affine again, reading a transposed copy of W[day] so that the reads
//     stay coalesced. g is read about twice in all (windows overlap two
//     tiles).
//  2. dw: per sample, a tiled shared-memory product y^T dz over T, one
//     block per (64 x 64 tile of dW, sample), y recomputed from a staged
//     block of x (32 rows plus the 19-row smoothing halo), 4 x 4 outputs per
//     thread; the blocks of the first row tile also sum db. Every output is
//     summed by one thread in a fixed order: no atomics.
//  3. dx: a thread per (row, channel) runs the 20 reversed taps over dy.
#include "common.cuh"

namespace {

constexpr int kRows = 32;  // time rows per block in the affine pass

__global__ void smooth_affine_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                     const float* __restrict__ bias,
                                     const int* __restrict__ day_idxs,
                                     const float* __restrict__ taps, float* __restrict__ z,
                                     int T, int C, int n_taps, int n_days) {
  extern __shared__ float ys[];  // [kRows][C] smoothed rows
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int c = threadIdx.x;
  const int left = (n_taps - 1) / 2;
  const float* xb = x + (size_t)b * T * C;

  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + r;
    float acc = 0.f;
    if (t < T) {
      for (int i = 0; i < n_taps; ++i) {
        const int s = t - left + i;
        const float xv = (s >= 0 && s < T) ? xb[(size_t)s * C + c] : 0.f;
        acc = acc + taps[i] * xv;
      }
    }
    ys[r * C + c] = acc;
  }
  __syncthreads();

  int day = day_idxs[b];
  day = day < 0 ? 0 : (day >= n_days ? n_days - 1 : day);
  const float* wd = w + (size_t)day * C * C;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int d = 0; d < C; ++d) {
    const float wv = wd[(size_t)d * C + c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(ys[r * C + d], wv, acc[r]);
  }
  const float bv = bias[(size_t)day * C + c];
  float* zb = z + (size_t)b * T * C;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + r;
    if (t < T) {
      const float v = acc[r] + bv;
      zb[(size_t)t * C + c] = v / (1.f + fabsf(v));
    }
  }
}

__global__ void unfold_kernel(const float* __restrict__ z, float* __restrict__ out, int T, int C,
                              int k, int stride, int t_out) {
  extern __shared__ float win[];  // [k][C + 1]
  const int b = blockIdx.y;
  const int to = blockIdx.x;
  const int ld = C + 1;
  const float* zb = z + ((size_t)b * T + (size_t)to * stride) * C;
  for (int i = threadIdx.x; i < k * C; i += blockDim.x) {
    const int j = i / C;
    const int c = i - j * C;
    win[j * ld + c] = zb[(size_t)j * C + c];
  }
  __syncthreads();
  float* ob = out + ((size_t)b * t_out + to) * (size_t)(C * k);
  for (int o = threadIdx.x; o < C * k; o += blockDim.x) {
    const int c = o / k;
    const int j = o - c * k;
    ob[o] = win[j * ld + c];
  }
}

__device__ __forceinline__ int clamp_day(const int* day_idxs, int b, int n_days) {
  const int day = day_idxs[b];
  return day < 0 ? 0 : (day >= n_days ? n_days - 1 : day);
}

__global__ void bwd_dz_dy_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                 const float* __restrict__ w_t, const float* __restrict__ bias,
                                 const int* __restrict__ day_idxs, const float* __restrict__ taps,
                                 const float* __restrict__ g, float* __restrict__ dz,
                                 float* __restrict__ dy, int T, int C, int n_taps, int n_days,
                                 int k, int stride, int t_out) {
  extern __shared__ float sm[];
  float* ys = sm;              // [kRows][C]: smoothed rows, then dz rows
  float* gs = ys + kRows * C;  // [C][k + 1]: one window row of g, transposed
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int c = threadIdx.x;
  const int left = (n_taps - 1) / 2;
  const int ldg = k + 1;
  const float* xb = x + (size_t)b * T * C;

  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + r;
    float acc = 0.f;
    if (t < T) {
      for (int i = 0; i < n_taps; ++i) {
        const int s = t - left + i;
        const float xv = (s >= 0 && s < T) ? xb[(size_t)s * C + c] : 0.f;
        acc = acc + taps[i] * xv;
      }
    }
    ys[r * C + c] = acc;
  }
  __syncthreads();

  const int day = clamp_day(day_idxs, b, n_days);
  const float* wd = w + (size_t)day * C * C;
  float pre[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) pre[r] = 0.f;
  for (int d = 0; d < C; ++d) {
    const float wv = wd[(size_t)d * C + c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) pre[r] = fmaf(ys[r * C + d], wv, pre[r]);
  }
  const float bv = bias[(size_t)day * C + c];

  // d unfold: windows t' with t'*stride <= t0 + kRows - 1 and t'*stride + k - 1 >= t0
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  const int lo = max(0, (t0 - k + stride) / stride);
  const int hi = min(t_out - 1, (t0 + kRows - 1) / stride);
  const int ck = C * k;
  for (int tw = lo; tw <= hi; ++tw) {
    __syncthreads();  // the previous window's reads are done
    const float* gr = g + ((size_t)b * t_out + tw) * ck;
    for (int o = threadIdx.x; o < ck; o += blockDim.x) {
      const int cc = o / k;
      gs[cc * ldg + (o - cc * k)] = gr[o];
    }
    __syncthreads();
    const int jbase = t0 - tw * stride;  // j of row r is jbase + r
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = jbase + r;
      if (j >= 0 && j < k) acc[r] += gs[c * ldg + j];
    }
  }
  __syncthreads();  // every thread is past its reads of ys (and gs)

  float* dzb = dz + (size_t)b * T * C;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + r;
    const float den = 1.f + fabsf(pre[r] + bv);
    const float v = t < T ? acc[r] / (den * den) : 0.f;
    ys[r * C + c] = v;
    if (t < T) dzb[(size_t)t * C + c] = v;
  }
  __syncthreads();

  // dy[t, c] = sum_e dz[t, e] * W[day][c, e] = sum_e dz[t, e] * W^T[day][e, c]
  const float* wtd = w_t + (size_t)day * C * C;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int e = 0; e < C; ++e) {
    const float wv = wtd[(size_t)e * C + c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(ys[r * C + e], wv, acc[r]);
  }
  float* dyb = dy + (size_t)b * T * C;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (t0 + r < T) dyb[(size_t)(t0 + r) * C + c] = acc[r];
}

constexpr int kTile = 64;   // dW output tile
constexpr int kChunk = 32;  // time rows per staged chunk
constexpr int kMaxTaps = 32;

// dw[b][d, c] = sum_t y[t, d] dz[t, c] with y = smooth(x) recomputed; the
// blocks of the first d tile also write db[b][c] = sum_t dz[t, c]
__global__ void bwd_dw_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                              const float* __restrict__ dz, float* __restrict__ dw,
                              float* __restrict__ db, int T, int C, int n_taps) {
  __shared__ float xs[kChunk + kMaxTaps][kTile];
  __shared__ float as[kChunk][kTile];  // y rows, columns d0 ..
  __shared__ float bs[kChunk][kTile];  // dz rows, columns c0 ..
  const int c0 = blockIdx.x * kTile;
  const int d0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int left = (n_taps - 1) / 2;
  const int halo = n_taps - 1;
  const float* xb = x + (size_t)b * T * C;
  const float* dzb = dz + (size_t)b * T * C;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
  float dbacc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    for (int e = threadIdx.x; e < (kChunk + halo) * kTile; e += blockDim.x) {
      const int rr = e / kTile;
      const int s = t0 - left + rr;
      xs[rr][e - rr * kTile] = (s >= 0 && s < T) ? xb[(size_t)s * C + d0 + e - rr * kTile] : 0.f;
    }
    for (int e = threadIdx.x; e < kChunk * kTile; e += blockDim.x) {
      const int rr = e / kTile;
      const int cc = e - rr * kTile;
      bs[rr][cc] = t0 + rr < T ? dzb[(size_t)(t0 + rr) * C + c0 + cc] : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kChunk * kTile; e += blockDim.x) {
      const int rr = e / kTile;
      const int cc = e - rr * kTile;
      float yv = 0.f;
      if (t0 + rr < T)
        for (int i = 0; i < n_taps; ++i) yv = yv + taps[i] * xs[rr + i][cc];
      as[rr][cc] = yv;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kChunk; ++rr) {
      float a[4], bv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = as[rr][ty * 4 + m];
#pragma unroll
      for (int n = 0; n < 4; ++n) bv[n] = bs[rr][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
      if (ty == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n) dbacc[n] += bv[n];
      }
    }
    __syncthreads();
  }
  float* dwb = dw + (size_t)b * C * C;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) dwb[(size_t)(d0 + ty * 4 + m) * C + c0 + tx + 16 * n] = acc[m][n];
  if (blockIdx.y == 0 && ty == 0) {
#pragma unroll
    for (int n = 0; n < 4; ++n) db[(size_t)b * C + c0 + tx + 16 * n] = dbacc[n];
  }
}

// dx[t, c] = sum_i taps[n-1-i] * dy[t + i - n/2, c]
__global__ void bwd_dx_kernel(const float* __restrict__ dy, const float* __restrict__ taps,
                              float* __restrict__ dx, int T, int C, int n_taps) {
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int c = threadIdx.x;
  const int left = n_taps / 2;
  const float* dyb = dy + (size_t)b * T * C;
  float acc = 0.f;
  for (int i = 0; i < n_taps; ++i) {
    const int s = t + i - left;
    const float v = (s >= 0 && s < T) ? dyb[(size_t)s * C + c] : 0.f;
    acc = acc + taps[n_taps - 1 - i] * v;
  }
  dx[((size_t)b * T + t) * C + c] = acc;
}

}  // namespace

extern "C" int w2vb_preproc_fwd(const float* x, const float* w, const float* bias,
                                const int* day_idxs, const float* taps, float* z, float* out,
                                int B, int T, int C, int n_taps, int n_days, int k, int stride,
                                int t_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g1((T + kRows - 1) / kRows, B);
  smooth_affine_kernel<<<g1, C, kRows * C * sizeof(float), s>>>(x, w, bias, day_idxs, taps, z, T,
                                                                 C, n_taps, n_days);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (t_out > 0) {
    const dim3 g2(t_out, B);
    unfold_kernel<<<g2, 256, k * (C + 1) * sizeof(float), s>>>(z, out, T, C, k, stride, t_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward. w_t is W transposed per day (n_days, C, C); dz and dy are
// (B, T, C) f32 scratch; dx (B, T, C), dw (B, C, C) and db (B, 1, C) f32.
// Needs C == 256 threads' worth of channels (a multiple of 64) and at most
// 32 taps.
extern "C" int w2vb_preproc_bwd(const float* x, const float* w, const float* w_t,
                                const float* bias, const int* day_idxs, const float* taps,
                                const float* g, float* dz, float* dy, float* dx, float* dw,
                                float* db, int B, int T, int C, int n_taps, int n_days, int k,
                                int stride, int t_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % kTile != 0 || C > 1024 || n_taps > kMaxTaps + 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 = ((size_t)kRows * C + (size_t)C * (k + 1)) * sizeof(float);
  cudaError_t e = w2vb::allow_smem(bwd_dz_dy_kernel, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g1((T + kRows - 1) / kRows, B);
  bwd_dz_dy_kernel<<<g1, C, smem1, s>>>(x, w, w_t, bias, day_idxs, taps, g, dz, dy, T, C, n_taps,
                                        n_days, k, stride, t_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g2(C / kTile, C / kTile, B);
  bwd_dw_kernel<<<g2, 256, 0, s>>>(x, taps, dz, dw, db, T, C, n_taps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g3(T, B);
  bwd_dx_kernel<<<g3, C, 0, s>>>(dy, taps, dx, T, C, n_taps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* w2vb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
