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
// The sum of the partials over B runs outside the kernel, in a fixed order
// (the JAX package leaves it to XLA outside the kernel too).
//
// What bounds it on the H100: bytes. One read of x and one write of y
// (forward), reads of x and dy and a write of dx (backward): a few flops per
// byte, far below the ~20 flops/byte where f32 CUDA-core arithmetic would
// take over. At 64 x 89 x 768 f32 the forward moves ~35 MB (~10 us at 3.35
// TB/s), the backward ~52 MB (~16 us).
//
// Forward design, at the encoders' widths (C = 768 and 1024, 16-byte
// aligned operands): a row is one warp's, as 16-byte vectors (float4, or 8
// bf16), C / (32 x 4 or 8) of them per lane, a count fixed at compile time.
// As many blocks of 8 warps as the SMs hold at once walk the rows (grid
// stride); each block stages scale and bias in shared memory once, and each
// warp loads its next row while it normalises the current one, so two rows
// per warp are in flight to cover the DRAM latency. The statistics are
// exact two-pass f32 sums over the registers, each a warp butterfly (every
// lane ends with the same bits). Any other C <= 1024 (or a misaligned
// operand) takes the generic kernel: one warp per row, scalar loads, up to
// 32 values a lane.
//
// Backward design: one launch. A block owns the rows of one (batch element,
// T chunk) tile; the host picks as many chunks per batch element as fill the
// SMs once (grid B x chunks). Each warp takes a row at a time (rows t0 + w,
// + 8, ...): x and dy in registers (at C 768 / 1024 with 16-byte aligned
// operands as 16-byte vectors, a count per lane fixed at compile time, scale
// staged in shared memory; any other C <= 1024 as scalars, up to 32 a lane),
// mu and rstd recomputed exactly as the forward does (no stats scratch), the
// two row means of the dx formula as warp butterflies, dx written in the
// stream dtype. Each lane keeps the dgamma / dbeta sums of its columns in
// registers over the block's rows; at the end the 8 warps' sums go through
// shared memory and are added in warp order into the block's (C) partial.
// So x and dy are read once, and the result is deterministic: the (B,
// chunks, C) partials are summed over the chunks by the wrapper, over B
// outside it, each in a fixed order.
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

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {  // bf16 pairs, low half first
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {  // to bf16, round to nearest even
  using w2vb::pack_bf16;
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// The forward at C fixed at compile time (C = 32 x kVec x 16-byte vectors):
// blocks walk the rows (grid stride), a warp per row, the next row's
// vectors loaded before the current row is normalised.
template <typename T, int C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    layernorm_fwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                             const float* __restrict__ bias, T* __restrict__ y, int rows, float eps) {
  constexpr int kV = 16 / sizeof(T);  // values in a 16-byte vector
  constexpr int kVec = C / (32 * kV);  // vectors per lane
  static_assert(kVec * 32 * kV == C, "C must be a whole number of vectors per lane");
  __shared__ __align__(16) float sc[C];
  __shared__ __align__(16) float bi[C];
  for (int i = threadIdx.x; i < C / 4; i += blockDim.x) {
    reinterpret_cast<float4*>(sc)[i] = reinterpret_cast<const float4*>(scale)[i];
    reinterpret_cast<float4*>(bi)[i] = reinterpret_cast<const float4*>(bias)[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarpsPerBlock;
  int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  auto load = [&](uint4 (&dst)[kVec], int r) {
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)r * C);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[j] = src[lane + 32 * j];
  };
  uint4 cur[kVec];
  if (row < rows) load(cur, row);
  for (; row < rows; row += stride) {
    uint4 nxt[kVec];
    if (row + stride < rows) load(nxt, row + stride);
    float v[kVec][kV];
#pragma unroll
    for (int j = 0; j < kVec; ++j) unpack(cur[j], v[j]);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int e = 0; e < kV; ++e) sum += v[j][e];
    const float mu = w2vb::warp_sum(sum) / static_cast<float>(C);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float c = v[j][e] - mu;
        sq = fmaf(c, c, sq);
      }
    const float rstd = 1.f / sqrtf(w2vb::warp_sum(sq) / static_cast<float>(C) + eps);
    uint4* dst = reinterpret_cast<uint4*>(y + (size_t)row * C);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c0 = (lane + 32 * j) * kV;
      float out[kV];
#pragma unroll
      for (int e4 = 0; e4 < kV; e4 += 4) {
        const float4 g = *reinterpret_cast<const float4*>(sc + c0 + e4);
        const float4 b = *reinterpret_cast<const float4*>(bi + c0 + e4);
        out[e4] = ((v[j][e4] - mu) * rstd) * g.x + b.x;
        out[e4 + 1] = ((v[j][e4 + 1] - mu) * rstd) * g.y + b.y;
        out[e4 + 2] = ((v[j][e4 + 2] - mu) * rstd) * g.z + b.z;
        out[e4 + 3] = ((v[j][e4 + 3] - mu) * rstd) * g.w + b.w;
      }
      dst[lane + 32 * j] = pack(out);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) cur[j] = nxt[j];
  }
}

// The block's partial: out[c] = sum over warps w, in order, of red[w][c]
__device__ __forceinline__ void sum_warps(const float* red, int C, float* out) {
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) s += red[w * C + c];
    out[c] = s;
  }
  __syncthreads();  // red is free again
}

// Rows [t0, t1) of batch element b (grid: chunks x B, chunk rows per block)
__device__ __forceinline__ void chunk_rows(int Tn, int chunk, int& t0, int& t1) {
  t0 = blockIdx.x * chunk;
  t1 = min(Tn, t0 + chunk);
}

// The backward at C fixed at compile time (C = 32 x kVec x 16-byte vectors)
template <typename T, int C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    layernorm_bwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                             const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ dgp,
                             float* __restrict__ dbp, int Tn, int chunk, float eps) {
  constexpr int kV = 16 / sizeof(T);  // values in a 16-byte vector
  constexpr int kVec = C / (32 * kV);  // vectors per lane
  static_assert(kVec * 32 * kV == C, "C must be a whole number of vectors per lane");
  __shared__ __align__(16) float sc[C];
  __shared__ float red[kWarpsPerBlock * C];
  for (int i = threadIdx.x; i < C / 4; i += blockDim.x)
    reinterpret_cast<float4*>(sc)[i] = reinterpret_cast<const float4*>(scale)[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int t0, t1;
  chunk_rows(Tn, chunk, t0, t1);
  float ag[kVec][kV], ab[kVec][kV];  // this lane's columns: sum dy * xhat, sum dy
#pragma unroll
  for (int j = 0; j < kVec; ++j)
#pragma unroll
    for (int e = 0; e < kV; ++e) ag[j][e] = ab[j][e] = 0.f;
  for (int t = t0 + warp; t < t1; t += kWarpsPerBlock) {
    const size_t off = ((size_t)blockIdx.y * Tn + t) * C;
    const uint4* xs = reinterpret_cast<const uint4*>(x + off);
    const uint4* gs = reinterpret_cast<const uint4*>(dy + off);
    uint4 xv[kVec], gv[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      xv[j] = xs[lane + 32 * j];
      gv[j] = gs[lane + 32 * j];
    }
    float v[kVec][kV], g[kVec][kV];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      unpack(xv[j], v[j]);
      unpack(gv[j], g[j]);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int e = 0; e < kV; ++e) sum += v[j][e];
    const float mu = w2vb::warp_sum(sum) / static_cast<float>(C);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float c = v[j][e] - mu;
        sq = fmaf(c, c, sq);
      }
    const float rstd = 1.f / sqrtf(w2vb::warp_sum(sq) / static_cast<float>(C) + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c0 = (lane + 32 * j) * kV;
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float xh = (v[j][e] - mu) * rstd;
        const float wv = g[j][e] * sc[c0 + e];
        ag[j][e] = fmaf(g[j][e], xh, ag[j][e]);
        ab[j][e] += g[j][e];
        s1 += wv;
        s2 = fmaf(wv, xh, s2);
        v[j][e] = xh;  // xhat and w from here on
        g[j][e] = wv;
      }
    }
    const float m1 = w2vb::warp_sum(s1) / static_cast<float>(C);
    const float m2 = w2vb::warp_sum(s2) / static_cast<float>(C);
    uint4* dst = reinterpret_cast<uint4*>(dx + off);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float out[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) out[e] = rstd * (g[j][e] - m1 - v[j][e] * m2);
      dst[lane + 32 * j] = pack(out);
    }
  }
  const size_t part = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * C;
#pragma unroll
  for (int j = 0; j < kVec; ++j)
#pragma unroll
    for (int e = 0; e < kV; ++e) red[warp * C + (lane + 32 * j) * kV + e] = ag[j][e];
  sum_warps(red, C, dgp + part);
#pragma unroll
  for (int j = 0; j < kVec; ++j)
#pragma unroll
    for (int e = 0; e < kV; ++e) red[warp * C + (lane + 32 * j) * kV + e] = ab[j][e];
  sum_warps(red, C, dbp + part);
}

// The backward at any C <= 1024 (or misaligned operands): column lane + 32 k
// of a row is lane's k-th value, scalar loads
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ dgp,
                         float* __restrict__ dbp, int Tn, int C, int chunk, float eps) {
  __shared__ float red[kWarpsPerBlock * kMaxPerLane * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int t0, t1;
  chunk_rows(Tn, chunk, t0, t1);
  float ag[kMaxPerLane], ab[kMaxPerLane];
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) ag[k] = ab[k] = 0.f;
  for (int t = t0 + warp; t < t1; t += kWarpsPerBlock) {
    const size_t base = ((size_t)blockIdx.y * Tn + t) * C;
    float v[kMaxPerLane], g[kMaxPerLane];
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      const int c = lane + 32 * k;
      v[k] = c < C ? load_f32(x, base + c) : 0.f;
      g[k] = c < C ? load_f32(dy, base + c) : 0.f;
    }
    float mu, rstd;
    row_stats(v, lane, C, eps, mu, rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < C) {
        const float xh = (v[k] - mu) * rstd;
        const float wv = g[k] * scale[c];
        ag[k] = fmaf(g[k], xh, ag[k]);
        ab[k] += g[k];
        s1 += wv;
        s2 = fmaf(wv, xh, s2);
        v[k] = xh;
        g[k] = wv;
      }
    }
    const float m1 = w2vb::warp_sum(s1) / static_cast<float>(C);
    const float m2 = w2vb::warp_sum(s2) / static_cast<float>(C);
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < C) dx[base + c] = w2vb::from_f32<T>(rstd * (g[k] - m1 - v[k] * m2));
    }
  }
  const size_t part = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * C;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k)
    if (lane + 32 * k < C) red[warp * C + lane + 32 * k] = ag[k];
  sum_warps(red, C, dgp + part);
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k)
    if (lane + 32 * k < C) red[warp * C + lane + 32 * k] = ab[k];
  sum_warps(red, C, dbp + part);
}

// as many blocks as the SMs hold at once, or fewer where the rows run out
template <typename T, int C>
int launch_fwd_vec(const T* x, const float* scale, const float* bias, T* y, int rows, float eps,
                   cudaStream_t s) {
  static int per_sm = 0;  // blocks of this instantiation an SM holds
  cudaError_t e = cudaSuccess;
  if (per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layernorm_fwd_vec_kernel<T, C>,
                                                      32 * kWarpsPerBlock, 0);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int needed = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = needed < per_sm * sms ? needed : per_sm * sms;
  layernorm_fwd_vec_kernel<T, C><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(x, scale, bias, y, rows, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* x, const float* scale, const float* bias, void* y, int rows, int C,
               float eps, cudaStream_t s) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(bias);
  if (addr % 16 == 0 && rows > 0) {
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    if (C == 768) return launch_fwd_vec<T, 768>(xt, scale, bias, yt, rows, eps, s);
    if (C == 1024) return launch_fwd_vec<T, 1024>(xt, scale, bias, yt, rows, eps, s);
  }
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layernorm_fwd_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a kernel an SM holds at once (the 768 / 1024 vector kernels,
// else the generic one), queried once per instantiation
template <typename T>
int bwd_blocks_per_sm(int C, int* per_sm) {
  static int vec768 = 0, vec1024 = 0, generic = 0;
  int* cached = C == 768 ? &vec768 : C == 1024 ? &vec1024 : &generic;
  cudaError_t e = cudaSuccess;
  if (*cached == 0) {
    if (C == 768)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(cached, layernorm_bwd_vec_kernel<T, 768>,
                                                        32 * kWarpsPerBlock, 0);
    else if (C == 1024)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(cached, layernorm_bwd_vec_kernel<T, 1024>,
                                                        32 * kWarpsPerBlock, 0);
    else
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(cached, layernorm_bwd_kernel<T>,
                                                        32 * kWarpsPerBlock, 0);
  }
  *per_sm = *cached;
  return static_cast<int>(e);
}

template <typename T>
int launch_bwd(const void* x, const float* scale, const void* dy, void* dx, float* dgp, float* dbp,
               int B, int Tn, int C, int chunks, float eps, cudaStream_t s) {
  if (chunks < 1 || chunks > Tn) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (Tn + chunks - 1) / chunks;
  const dim3 grid(chunks, B);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(scale);
  if (addr % 16 == 0 && C == 768)
    layernorm_bwd_vec_kernel<T, 768><<<grid, 32 * kWarpsPerBlock, 0, s>>>(xt, scale, gt, dxt, dgp, dbp,
                                                                         Tn, chunk, eps);
  else if (addr % 16 == 0 && C == 1024)
    layernorm_bwd_vec_kernel<T, 1024><<<grid, 32 * kWarpsPerBlock, 0, s>>>(xt, scale, gt, dxt, dgp,
                                                                          dbp, Tn, chunk, eps);
  else
    layernorm_bwd_kernel<T><<<grid, 32 * kWarpsPerBlock, 0, s>>>(xt, scale, gt, dxt, dgp, dbp, Tn, C,
                                                                chunk, eps);
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

// The T chunks per batch element that fill the SMs once with the backward's
// blocks (at least 1, at most T); a negative CUDA error code on failure
extern "C" int w2vb_layernorm_bwd_chunks(int io_bf16, int B, int T, int C) {
  if (B < 1 || T < 1 || C > 32 * kMaxPerLane) return -static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, dev = 0, sms = 0;
  int e = io_bf16 ? bwd_blocks_per_sm<__nv_bfloat16>(C, &per_sm) : bwd_blocks_per_sm<float>(C, &per_sm);
  if (e == 0) e = static_cast<int>(cudaGetDevice(&dev));
  if (e == 0) e = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (e != 0) return -e;
  const int per_batch = per_sm * sms / B;
  return per_batch < 1 ? 1 : per_batch > T ? T : per_batch;
}

// x, dy, dx (B, T, C) in the stream dtype; dgp, dbp (B, chunks, C) f32: the
// dgamma and dbeta partials of each (batch element, T chunk); 1 <= chunks <= T
extern "C" int w2vb_layernorm_bwd(const void* x, const float* scale, const void* dy, void* dx,
                                  float* dgp, float* dbp, int io_bf16, int B, int T, int C,
                                  int chunks, float eps, void* stream) {
  if (C > 32 * kMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io_bf16) return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dgp, dbp, B, T, C, chunks, eps, s);
  return launch_bwd<float>(x, scale, dy, dx, dgp, dbp, B, T, C, chunks, eps, s);
}
