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
// MFLOP (10.5 us at 3.35 TB/s); the backward reads y and dz (35 MB) and
// writes dy and the dK partials (27 MB), for ~360 MFLOP.
//
// Both kernels are register windows over time chunks and take any T: one
// block per (sample, 32-channel tile), 32 x 6 threads, looping over chunks
// of 96 frames (the conformer's T = 89 in one, so no input row is staged
// twice there), shared memory fixed whatever T. A chunk's rows are staged
// once, from 16-byte loads coalesced along the channels (load16: several
// in flight a thread, scalar loads where C is off the 16-byte grid), with
// 16-byte shared stores. Each thread owns one channel, so every output is
// summed by one thread in a fixed order (no atomics). A 32-channel row is
// 128 bytes at an f32 stream and 64 at bf16: whole 32-byte sectors either
// way, so both stream dtypes keep the tile.
//
// Forward design: a chunk stages its GLU g (compute-dtype values) with the
// 15-frame halos, 127 rows; the taps once a block. Warp w owns a run of 16
// output frames and slides a window of 16 g values over the taps in
// registers: one new g value and one tap from shared memory per 16 FMAs,
// where a stencil that reads both operands from shared memory per FMA is
// bound by shared-memory bandwidth. The GLU output never goes to device
// memory.
//
// Backward design: a chunk stages its recomputed g and dz, each with its
// halo rows, and a and the gate of its own frames, so the GLU backward reads
// no y again. For dg, warp w owns a run of 16 frames and slides a window of
// 16 dz values over the taps (2 shared loads for 16 FMAs); for dK, warp w
// owns a group of 6 taps and slides a window of 6 g values over the chunk's
// frames (2 shared loads for 6 FMAs). A thread's dK sums stay in registers
// across the chunks, so they are per-sample (B, ks, C) partials, written
// once. The GLU backward runs in f32 in registers. g never goes to device
// memory.
#include "common.cuh"

namespace {

// ---- register windows over time chunks, forward and backward (header note) ----

constexpr int kCh = 32;     // channels per block: one per lane
constexpr int kRun = 16;    // consecutive frames of a thread's window (z, dg)
constexpr int kWarps = 6;   // a warp per run of a chunk (z, dg) and per tap group (dK)
constexpr int kChunk = kRun * kWarps;  // 96 frames: the conformer's T = 89 in one chunk
constexpr int kBwdGroup = 6;   // taps of a dK group: one group a warp at ks <= 36
constexpr int kBwdMaxGroups = 2;  // dK groups a warp takes: ks <= 72
constexpr int kThreads = kCh * kWarps;

// taps padded to a whole number of windows (zeros past ks)
__host__ __device__ constexpr int padded_taps(int ks) { return (ks + kRun - 1) / kRun * kRun; }
// the forward's staged g rows: the chunk and the padded taps' reach past it
__host__ __device__ constexpr int fwd_rows(int ks) { return kChunk + padded_taps(ks) - 1; }
// g rows and the taps
__host__ __device__ constexpr size_t fwd_smem(int ks) {
  return (size_t)(fwd_rows(ks) + padded_taps(ks)) * kCh * sizeof(float);
}
// staged rows of g and dz: the chunk, the taps and the dK window's reach past them
__host__ __device__ constexpr int bwd_rows(int ks) { return kChunk + padded_taps(ks) + kBwdGroup - 1; }
// g and dz rows, the flipped taps, a and gate of the chunk's own frames
__host__ __device__ constexpr size_t bwd_smem(int ks) {
  return (size_t)(2 * bwd_rows(ks) + padded_taps(ks) + 2 * kChunk) * kCh * sizeof(float);
}

// 16 bytes of p (16 / sizeof(T) values) as raw bits: one vector load where
// vec (16-byte aligned, all in range), else one load per value in range
// (zeros past it)
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int n_valid, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec && n_valid >= V) return *reinterpret_cast<const uint4*>(p);
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = j < n_valid ? p[j] : w2vb::from_f32<T>(0.f);
  return raw;
}

template <typename T>
__device__ __forceinline__ float raw_at(const uint4& raw, int j) {
  return w2vb::to_f32(reinterpret_cast<const T*>(&raw)[j]);
}

// Block (32-channel tile, sample), 32 x 6 threads: lane = channel. Per chunk
// of 96 frames, the GLU of rows t0 - left + r (compute-dtype values, zeros
// outside [0, T)) is staged once in shared memory from 16-byte loads of a
// and the gate; warp w owns frames s0 = 16 w .. + 15 and slides a window of
// 16 g values over the taps in registers (one new value a tap):
// z[s] = sum_kk g[s + kk - left] w_cd[kk], summed in tap order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_glu_fwd_kernel(const T* __restrict__ y, const float* __restrict__ w, T* __restrict__ z, int Tn, int C,
                        int ks, bool cd_bf16, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = kRun;
  constexpr int kRowCopies = kCh / V;            // 16-byte copies per staged row and operand
  constexpr int kPer = sizeof(T) == 4 ? 6 : 3;   // copies a thread has in flight (a chunk's rows in one pass)
  extern __shared__ __align__(16) float smf[];
  const int taps = padded_taps(ks), rows = fwd_rows(ks), left = (ks - 1) / 2;
  float* gs = smf;              // [rows][32]: gs[r] = g[t0 - left + r]
  float* ws = gs + rows * kCh;  // [taps][32]: w_cd[kk], zeros past ks
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * kCh + lane;
  const int c0 = blockIdx.x * kCh, c = c0 + lane, b = blockIdx.y;
  const T* yb = y + (size_t)b * Tn * 2 * C;

  for (int i = tid; i < taps * kCh; i += kThreads) {
    const int kk = i / kCh, cc = c0 + i % kCh;
    ws[i] = kk < ks && cc < C ? w2vb::round_cd(w[(size_t)kk * C + cc], cd_bf16) : 0.f;
  }
  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    for (int base = 0; base < rows * kRowCopies; base += kPer * kThreads) {
      uint4 ra[kPer], rg[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = base + j * kThreads + tid;
        const int r = i / kRowCopies, cc = c0 + (i % kRowCopies) * V, n_valid = C - cc, tg = t0 - left + r;
        ra[j] = rg[j] = make_uint4(0, 0, 0, 0);
        if (i < rows * kRowCopies && n_valid > 0 && tg >= 0 && tg < Tn) {
          ra[j] = load16<T>(yb + (size_t)tg * 2 * C + cc, n_valid, vec);
          rg[j] = load16<T>(yb + (size_t)tg * 2 * C + C + cc, n_valid, vec);
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = base + j * kThreads + tid;
        if (i >= rows * kRowCopies) break;
        const int r = i / kRowCopies, cl = (i % kRowCopies) * V;
#pragma unroll
        for (int q = 0; q < V; q += 4) {  // 16-byte shared stores
          float f[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)  // 0 where a = 0
            f[u] = w2vb::round_cd(raw_at<T>(ra[j], q + u) * w2vb::sigmoidf(raw_at<T>(rg[j], q + u)), cd_bf16);
          *reinterpret_cast<float4*>(gs + r * kCh + cl + q) = make_float4(f[0], f[1], f[2], f[3]);
        }
      }
    }
    __syncthreads();
    const int s0 = warp * R;
    if (t0 + s0 < Tn) {  // the same for the whole warp
      float gw[R], acc[R];  // g rows s0 + kk .. + R - 1, row e in slot e % R
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] = 0.f;
        if (i < R - 1) gw[i] = gs[(s0 + i) * kCh + lane];
      }
      for (int k0 = 0; k0 < taps; k0 += R) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int kk = k0 + j;
          gw[(j + R - 1) % R] = gs[(s0 + kk + R - 1) * kCh + lane];
          const float wv = ws[kk * kCh + lane];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] = fmaf(gw[(j + i) % R], wv, acc[i]);
        }
      }
      if (c < C) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int t = t0 + s0 + i;
          if (t >= Tn) break;
          z[((size_t)b * Tn + t) * C + c] = w2vb::from_f32<T>(w2vb::round_cd(acc[i], cd_bf16));
        }
      }
    }
    __syncthreads();  // the chunk's rows are free
  }
}

// Block (32-channel tile, sample), 32 x 6 threads: lane = channel. Per chunk
// of 96 frames, staged in shared memory: g (compute-dtype values) of rows t0
// - left + r, dz of rows t0 - right + r (zeros outside [0, T)), and a and
// the gate of the chunk's own frames. Then
//  dg: warp w owns frames s0 = 16 w .. + 15 and slides a window of 16 dz
//      values over the taps in registers (one new value a tap):
//      dg[s] += dz[s + kk - right] w[ks - 1 - kk];
//  dK: warp w owns the taps of group w (and w + 6 at ks > 36) and slides a
//      window of 6 g values over the chunk's frames (one new value a frame):
//      dK[kk] += g[s + kk - left] dz[s], summed per chunk, then over the
//      chunks in order in registers (no atomics);
// and the GLU backward in f32 from the staged a and gate.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    conv_glu_bwd_kernel(const T* __restrict__ y, const float* __restrict__ w, const T* __restrict__ dz,
                        T* __restrict__ dy, float* __restrict__ dk, int Tn, int C, int ks, bool cd_bf16,
                        bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = kRun, G = kBwdGroup;
  constexpr int kRowCopies = kCh / V;  // 16-byte copies per staged row
  constexpr int kPer = 3;                 // copies a thread has in flight
  extern __shared__ __align__(16) float smb[];
  const int taps = padded_taps(ks), rows = bwd_rows(ks);
  const int left = (ks - 1) / 2, right = ks / 2;
  float* gs = smb;                       // [rows][32]: gs[r] = g[t0 - left + r]
  float* dzs = gs + rows * kCh;       // [rows][32]: dzs[r] = dz[t0 - right + r]
  float* wf = dzs + rows * kCh;       // [taps][32]: w_cd[ks - 1 - kk], zeros past ks
  float* as = wf + taps * kCh;        // [96][32]: a of frame t0 + s
  float* gts = as + kChunk * kCh;  // [96][32]: the gate of frame t0 + s
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * kCh + lane;
  const int c0 = blockIdx.x * kCh, c = c0 + lane, b = blockIdx.y;
  const T* yb = y + (size_t)b * Tn * 2 * C;
  const T* dzb = dz + (size_t)b * Tn * C;

  for (int i = tid; i < taps * kCh; i += kThreads) {
    const int kk = i / kCh, cc = c0 + i % kCh;
    wf[i] = kk < ks && cc < C ? w2vb::round_cd(w[(size_t)(ks - 1 - kk) * C + cc], cd_bf16) : 0.f;
  }
  float dka[kBwdMaxGroups][G];  // this thread's dK taps, summed over the chunks
#pragma unroll
  for (int m = 0; m < kBwdMaxGroups; ++m)
#pragma unroll
    for (int i = 0; i < G; ++i) dka[m][i] = 0.f;

  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    // stage the chunk, V channels of a row per 16-byte copy; a thread issues
    // the loads of kPer copies before it stores any
    for (int base = 0; base < rows * kRowCopies; base += kPer * kThreads) {
      uint4 ra[kPer], rg[kPer], rd[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = base + j * kThreads + tid;
        const int r = i / kRowCopies, cc = c0 + (i % kRowCopies) * V, n_valid = C - cc;
        const int tg = t0 - left + r, td = t0 - right + r;
        const bool live = i < rows * kRowCopies && n_valid > 0;
        ra[j] = rg[j] = rd[j] = make_uint4(0, 0, 0, 0);
        if (live && tg >= 0 && tg < Tn) {
          ra[j] = load16<T>(yb + (size_t)tg * 2 * C + cc, n_valid, vec);
          rg[j] = load16<T>(yb + (size_t)tg * 2 * C + C + cc, n_valid, vec);
        }
        if (live && td >= 0 && td < Tn) rd[j] = load16<T>(dzb + (size_t)td * C + cc, n_valid, vec);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = base + j * kThreads + tid;
        if (i >= rows * kRowCopies) break;
        const int r = i / kRowCopies, cl = (i % kRowCopies) * V, own = r - left;
#pragma unroll
        for (int q = 0; q < V; q += 4) {  // 16-byte shared stores
          float fa[4], fg[4], fgl[4], fd[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            fa[u] = raw_at<T>(ra[j], q + u);
            fg[u] = raw_at<T>(rg[j], q + u);
            fgl[u] = w2vb::round_cd(fa[u] * w2vb::sigmoidf(fg[u]), cd_bf16);  // 0 where a = 0
            fd[u] = raw_at<T>(rd[j], q + u);
          }
          *reinterpret_cast<float4*>(gs + r * kCh + cl + q) = make_float4(fgl[0], fgl[1], fgl[2], fgl[3]);
          *reinterpret_cast<float4*>(dzs + r * kCh + cl + q) = make_float4(fd[0], fd[1], fd[2], fd[3]);
          if (own >= 0 && own < kChunk) {
            *reinterpret_cast<float4*>(as + own * kCh + cl + q) = make_float4(fa[0], fa[1], fa[2], fa[3]);
            *reinterpret_cast<float4*>(gts + own * kCh + cl + q) = make_float4(fg[0], fg[1], fg[2], fg[3]);
          }
        }
      }
    }
    __syncthreads();
    const int nfr = min(kChunk, Tn - t0);  // frames of this chunk
    // dK: tap groups kk0 = 6 (w + 6 m); frames s in steps of G (dz is 0 past T)
#pragma unroll
    for (int m = 0; m < kBwdMaxGroups; ++m) {
      const int kk0 = G * (warp + kWarps * m);
      if (kk0 >= ks) break;  // the same for the whole warp
      float gw[G], p[G];  // g rows s + kk0 .. + G - 1, row e in slot e % G
#pragma unroll
      for (int i = 0; i < G; ++i) {
        p[i] = 0.f;
        if (i < G - 1) gw[i] = gs[(kk0 + i) * kCh + lane];
      }
      for (int s0 = 0; s0 < nfr; s0 += G) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int s = s0 + j;
          gw[(j + G - 1) % G] = gs[(s + kk0 + G - 1) * kCh + lane];
          const float dv = dzs[(s + right) * kCh + lane];
#pragma unroll
          for (int i = 0; i < G; ++i) p[i] = fmaf(gw[(j + i) % G], dv, p[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) dka[m][i] += p[i];
    }
    // dg over the taps for the run's frames, then the GLU backward
    const int s0 = warp * R;
    if (s0 < nfr) {  // the same for the whole warp
      float dw[R], dg[R];  // dz rows s0 + kk .. + R - 1, row e in slot e % R
#pragma unroll
      for (int i = 0; i < R; ++i) {
        dg[i] = 0.f;
        if (i < R - 1) dw[i] = dzs[(s0 + i) * kCh + lane];
      }
      for (int k0 = 0; k0 < taps; k0 += R) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int kk = k0 + j;
          dw[(j + R - 1) % R] = dzs[(s0 + kk + R - 1) * kCh + lane];
          const float wv = wf[kk * kCh + lane];
#pragma unroll
          for (int i = 0; i < R; ++i) dg[i] = fmaf(dw[(j + i) % R], wv, dg[i]);
        }
      }
      if (c < C) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int s = s0 + i, t = t0 + s;
          if (t >= Tn) break;
          const float a = as[s * kCh + lane];
          const float sig = w2vb::sigmoidf(gts[s * kCh + lane]);
          T* dyr = dy + ((size_t)b * Tn + t) * 2 * C;
          dyr[c] = w2vb::from_f32<T>(dg[i] * sig);
          dyr[C + c] = w2vb::from_f32<T>(dg[i] * a * sig * (1.f - sig));
        }
      }
    }
    __syncthreads();  // the chunk's rows are free
  }
  if (c < C) {
#pragma unroll
    for (int m = 0; m < kBwdMaxGroups; ++m)
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int kk = G * (warp + kWarps * m) + i;
        if (kk < ks) dk[((size_t)b * ks + kk) * C + c] = dka[m][i];
      }
  }
}

template <typename T>
int launch_bwd(const void* y, const float* w, const void* dz, void* dy, float* dk, int B, int Tn,
               int C, int ks, bool cd_bf16, cudaStream_t s) {
  if (ks > kBwdGroup * kWarps * kBwdMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(ks);
  cudaError_t e = w2vb::allow_smem(conv_glu_bwd_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = C % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dz) % 16 == 0;
  const dim3 grid((C + kCh - 1) / kCh, B);
  conv_glu_bwd_kernel<T><<<grid, dim3(kCh, kWarps), smem, s>>>(
      static_cast<const T*>(y), w, static_cast<const T*>(dz), static_cast<T*>(dy), dk, Tn, C, ks,
      cd_bf16, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* y, const float* w, void* z, int B, int Tn, int C, int ks, bool cd_bf16,
               cudaStream_t s) {
  if (ks > 64) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(ks);
  cudaError_t e = w2vb::allow_smem(conv_glu_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = C % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((C + kCh - 1) / kCh, B);
  conv_glu_fwd_kernel<T><<<grid, dim3(kCh, kWarps), smem, s>>>(static_cast<const T*>(y), w, static_cast<T*>(z),
                                                               Tn, C, ks, cd_bf16, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io_bf16: y and z are bf16 (the activation stream dtype) rather than f32;
// cd_bf16: the compute dtype is bf16. w is f32 (ks, C).
extern "C" int w2vb_conv_glu_fwd(const void* y, const float* w, void* z, int io_bf16, int cd_bf16,
                                 int B, int T, int C, int ks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io_bf16) return launch_fwd<__nv_bfloat16>(y, w, z, B, T, C, ks, cd_bf16 != 0, s);
  return launch_fwd<float>(y, w, z, B, T, C, ks, cd_bf16 != 0, s);
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
