// Fused GLU -> depthwise conv (the middle of the conformer conv module),
// forward and backward.
//
// Replaces: wav2vec2forbrain_tpu/ops/pallas_conv_glu.py::_fwd_impl (the
// Pallas kernel _fwd_kernel) and ::_bwd_impl (_bwd_kernel). y (B, T, 2C) in
// the stream dtype, taps w (ks, C):
//   g = (a * sigmoid(gate)) in f32, rounded to the compute dtype
//   z[t, c] = sum_k g[t + k - (ks-1)/2, c] * w_cd[k, c]  ('same', zero pad),
//             f32 accumulation, rounded through the compute dtype, then
//             stored in the stream dtype
// Backward, for dz (B, T, C) in the stream dtype:
//   dK[b, k, c] = sum_t g[t + k - left, c] * dz[t, c]   per-sample partials, f32
//   dg[s, c] = sum_k dz[s + k - right, c] * w_cd[ks - 1 - k, c]
//   da = dg * sig;  dgate = dg * a * sig * (1 - sig)     f32, stored in y's dtype
// The batch sum of the dK partials runs outside the kernel (ops/conv_glu.py),
// as in the JAX package.
//
// What bounds it on the H100: bytes. At the slice's shape (B=32, T=89,
// C=1024) the forward reads 23 MB of y (f32) and writes 11.7 MB, for ~90
// MFLOP; the backward reads y and dz (35 MB) and writes dy and the dK
// partials (27 MB), for ~360 MFLOP.
//
// Forward design: one block per (sample, 64-channel tile, 64-frame time
// tile), 64 x 4 threads. The block computes the GLU of its 64 frames plus a
// halo of (ks-1)/2 = 15 frames on each side straight into shared memory
// (rows of 64 consecutive channels, so the 2C-wide input rows are read
// coalesced), loads its 31 x 64 taps once, and each thread then runs the
// 31-tap stencil along time for one channel and every fourth frame. The GLU
// output never goes to device memory.
//
// Backward design: one block per (sample, 64-channel tile) over the whole
// sequence (T = 89 frames plus the 15-frame halos on both sides: 2 x 119 x
// 64 f32 in shared memory), 64 x 4 threads. The recomputed GLU and dz sit
// in shared memory; a thread sums the dK partial of one tap over all T
// frames of its channel (a reduction inside the block, no atomics), then
// the flipped-tap stencil gives dg and the GLU backward runs in f32 in
// registers. g never goes to device memory.
#include "common.cuh"

namespace {

constexpr int kCh = 64;   // channels per block
constexpr int kRows = 64;  // output frames per block

template <typename T>
__global__ void conv_glu_fwd_kernel(const T* __restrict__ y, const float* __restrict__ w,
                                    T* __restrict__ z, int Tn, int C, int ks, bool cd_bf16) {
  extern __shared__ float sm[];
  const int rows = kRows + ks - 1;
  float* g = sm;               // [rows][kCh] GLU output (compute-dtype values)
  float* ws = g + rows * kCh;  // [ks][kCh] taps (compute-dtype values)
  const int cl = threadIdx.x;
  const int c = blockIdx.x * kCh + cl;
  const int t0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int left = (ks - 1) / 2;
  const T* yb = y + (size_t)b * Tn * 2 * C;

  for (int r = threadIdx.y; r < rows; r += blockDim.y) {
    const int t = t0 - left + r;
    float gv = 0.f;
    if (c < C && t >= 0 && t < Tn) {
      const float a = w2vb::to_f32(yb[(size_t)t * 2 * C + c]);
      const float gate = w2vb::to_f32(yb[(size_t)t * 2 * C + C + c]);
      gv = w2vb::round_cd(a * w2vb::sigmoidf(gate), cd_bf16);
    }
    g[r * kCh + cl] = gv;
  }
  for (int kk = threadIdx.y; kk < ks; kk += blockDim.y)
    ws[kk * kCh + cl] = c < C ? w2vb::round_cd(w[(size_t)kk * C + c], cd_bf16) : 0.f;
  __syncthreads();
  if (c >= C) return;

  for (int tl = threadIdx.y; tl < kRows; tl += blockDim.y) {
    const int t = t0 + tl;
    if (t >= Tn) break;
    float acc = 0.f;
    for (int kk = 0; kk < ks; ++kk) acc = fmaf(g[(tl + kk) * kCh + cl], ws[kk * kCh + cl], acc);
    z[((size_t)b * Tn + t) * C + c] = w2vb::from_f32<T>(w2vb::round_cd(acc, cd_bf16));
  }
}

template <typename T>
__global__ void conv_glu_bwd_kernel(const T* __restrict__ y, const float* __restrict__ w,
                                    const T* __restrict__ dz, T* __restrict__ dy,
                                    float* __restrict__ dk, int Tn, int C, int ks, bool cd_bf16) {
  extern __shared__ float sm[];
  const int rows = Tn + ks - 1;
  const int left = (ks - 1) / 2;
  const int right = ks / 2;
  float* gs = sm;                 // [rows][kCh]: gs[r] = g[r - left]
  float* dzs = gs + rows * kCh;   // [rows][kCh]: dzs[r] = dz[r - right]
  float* ws = dzs + rows * kCh;   // [ks][kCh] taps (compute-dtype values)
  const int cl = threadIdx.x;
  const int c = blockIdx.x * kCh + cl;
  const int b = blockIdx.y;
  const bool live = c < C;
  const T* yb = y + (size_t)b * Tn * 2 * C;

  for (int r = threadIdx.y; r < rows; r += blockDim.y) {
    const int tg = r - left;
    float gv = 0.f;
    if (live && tg >= 0 && tg < Tn) {
      const float a = w2vb::to_f32(yb[(size_t)tg * 2 * C + c]);
      const float gate = w2vb::to_f32(yb[(size_t)tg * 2 * C + C + c]);
      gv = w2vb::round_cd(a * w2vb::sigmoidf(gate), cd_bf16);
    }
    gs[r * kCh + cl] = gv;
    const int td = r - right;
    dzs[r * kCh + cl] =
        live && td >= 0 && td < Tn ? w2vb::to_f32(dz[((size_t)b * Tn + td) * C + c]) : 0.f;
  }
  for (int kk = threadIdx.y; kk < ks; kk += blockDim.y)
    ws[kk * kCh + cl] = live ? w2vb::round_cd(w[(size_t)kk * C + c], cd_bf16) : 0.f;
  __syncthreads();
  if (!live) return;

  // dK partial of tap kk: sum over the frames t of g[t + kk - left] * dz[t]
  for (int kk = threadIdx.y; kk < ks; kk += blockDim.y) {
    float acc = 0.f;
    for (int t = 0; t < Tn; ++t) acc = fmaf(gs[(t + kk) * kCh + cl], dzs[(t + right) * kCh + cl], acc);
    dk[((size_t)b * ks + kk) * C + c] = acc;
  }
  // dg through the flipped taps, then the GLU backward in f32
  for (int t = threadIdx.y; t < Tn; t += blockDim.y) {
    float dg = 0.f;
    for (int kk = 0; kk < ks; ++kk) dg = fmaf(dzs[(t + kk) * kCh + cl], ws[(ks - 1 - kk) * kCh + cl], dg);
    const float a = w2vb::to_f32(yb[(size_t)t * 2 * C + c]);
    const float sig = w2vb::sigmoidf(w2vb::to_f32(yb[(size_t)t * 2 * C + C + c]));
    T* dyr = dy + ((size_t)b * Tn + t) * 2 * C;
    dyr[c] = w2vb::from_f32<T>(dg * sig);
    dyr[C + c] = w2vb::from_f32<T>(dg * a * sig * (1.f - sig));
  }
}

template <typename T>
int launch_bwd(const void* y, const float* w, const void* dz, void* dy, float* dk, int B, int Tn,
               int C, int ks, bool cd_bf16, cudaStream_t s) {
  const size_t smem = (size_t)(2 * (Tn + ks - 1) + ks) * kCh * sizeof(float);
  cudaError_t e = w2vb::allow_smem(conv_glu_bwd_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((C + kCh - 1) / kCh, B);
  const dim3 block(kCh, 4);
  conv_glu_bwd_kernel<T><<<grid, block, smem, s>>>(static_cast<const T*>(y), w,
                                                    static_cast<const T*>(dz), static_cast<T*>(dy),
                                                    dk, Tn, C, ks, cd_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* y, const float* w, void* z, int B, int Tn, int C, int ks, bool cd_bf16,
           cudaStream_t s) {
  const size_t smem = (size_t)(kRows + 2 * ks - 1) * kCh * sizeof(float);
  cudaError_t e = w2vb::allow_smem(conv_glu_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((C + kCh - 1) / kCh, (Tn + kRows - 1) / kRows, B);
  const dim3 block(kCh, 4);
  conv_glu_fwd_kernel<T><<<grid, block, smem, s>>>(static_cast<const T*>(y), w,
                                                    static_cast<T*>(z), Tn, C, ks, cd_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io_bf16: y and z are bf16 (the activation stream dtype) rather than f32;
// cd_bf16: the compute dtype is bf16. w is f32 (ks, C).
extern "C" int w2vb_conv_glu_fwd(const void* y, const float* w, void* z, int io_bf16, int cd_bf16,
                                 int B, int T, int C, int ks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io_bf16) return launch<__nv_bfloat16>(y, w, z, B, T, C, ks, cd_bf16 != 0, s);
  return launch<float>(y, w, z, B, T, C, ks, cd_bf16 != 0, s);
}

// y, dz and dy share the stream dtype (io_bf16); w is f32 (ks, C); dk is
// the f32 (B, ks, C) per-sample partials.
extern "C" int w2vb_conv_glu_bwd(const void* y, const float* w, const void* dz, void* dy,
                                 float* dk, int io_bf16, int cd_bf16, int B, int T, int C, int ks,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io_bf16) return launch_bwd<__nv_bfloat16>(y, w, dz, dy, dk, B, T, C, ks, cd_bf16 != 0, s);
  return launch_bwd<float>(y, w, dz, dy, dk, B, T, C, ks, cd_bf16 != 0, s);
}
