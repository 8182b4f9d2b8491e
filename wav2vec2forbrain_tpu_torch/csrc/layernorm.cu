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
// Backward design: the dx pass is the generic forward's warp-per-row layout
// and also stores each row's (mu, rstd); the (B, C) partials come from a
// second launch with one block per batch element and 256 columns, which
// walks its T rows in order: no atomics, deterministic.
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
