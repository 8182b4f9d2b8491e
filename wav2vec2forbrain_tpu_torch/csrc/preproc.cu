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
// the upstream g (B, T', 256 * k), channel-major like the forward's output:
//   y = smooth(x) and pre = y @ W[day] + b[day], recomputed (not saved)
//   dz[t, c] = sum over the windows t' and offsets j with t'*stride + j = t
//              of g[t', c*k + j], divided by (1 + |pre[t, c]|)^2
//   dW_b = y^T dz and db_b = sum_t dz per sample (summed into the day
//   tables outside, ops/preproc.py); dy = dz @ W[day]^T; dx = the smoothing
//   with the reversed taps and swapped padding applied to dy.
// What bounds it on the H100: bytes. g is the one large input (93 MB at
// B=32, T=384; 187 MB at B=64), read once: ~40 us at B=32 with x, W, dx and
// dW. The three 256-wide products (pre, dy, dW; 4.8 GFLOP at B=32) are f32
// products: on the f32 FMA pipe they need 72 us, as split-TF32 tensor-core
// products (below) 29 us at the published rate.
//
// The products are split-TF32 mma.sync.m16n8k8, as attention.cu's f32
// kernels form theirs (common.cuh): each f32 operand x = big + small with
// big = tf32(x), small = tf32(x - big), and a . b = a_big b_small + a_small
// b_big + a_big b_big in f32, the small products first: ~22 bits a product
// where one TF32 pass keeps 11 and misses the f32 tolerance. Operand tiles
// stay f32 in shared memory; a warp splits each fragment in registers as it
// loads it (a W element is read by one warp only), and runs the three
// products of its tiles in turn, so that independent products separate two
// that add into one accumulator.
//
// Design, three launches, no atomics (every output summed by one thread in
// a fixed order, so two runs are bitwise equal):
//  1. gather: the d unfold of g into a (B, T, 256) scratch dzs, a pure
//     stream of g. Main path (kernel_len 32, stride 4, compile-time): row t
//     = 4 s + r takes g[s - m, c*32 + 4 m + r] for m = 0 .. 7, so one
//     16-byte piece (t', c, m) of a window row is the r = 0 .. 3 terms of
//     rows 4 (t' + m) .. + 3 of channel c. A block of 8 warps owns 32
//     channels and 8 s values: it stages the 32 KB of pieces its rows take
//     from 15 window rows, each piece of g once in all (16-byte cp.async,
//     coalesced, all in flight together, L2 told to evict them first so
//     that W and the scratch stay), three blocks an SM; piece (c, m) sits
//     at c*8 + (m ^ (c & 7)) of its row, so that warp w, which sums row s0
//     + w of its 32 channels in m order (the plain version's order), reads
//     them with 16-byte loads free of bank conflicts. Other windows take a
//     scalar gather with one division a row.
//  2. dz_dy: one block of 8 warps per (sample, 64-row tile), two blocks an
//     SM (101 KB of shared memory, at most 128 registers): a 64-row A tile
//     (y, then pre, then dz; pitch 260 floats) and three buffers of 8-deep
//     W[day] chunks (cp.async, two in flight; all 24 days' tables, 6.3 MB,
//     sit in L2).
//     a. y: a thread per channel smooths its rows from register windows of
//        x (16 rows a window), into the A tile and into a (B, T, 256)
//        scratch for launch 3 (L2-resident: 12.6 MB at B=32), while W's
//        first chunks land.
//     b. pre = y W[day] on the tensor cores: warp w owns columns 32 w ..
//        + 31 of all 64 rows (4 x 4 m16n8 tiles); pre + b goes back into
//        the A tile.
//     c. dz = dzs / (1 + |pre|)^2, in place in dzs and into the A tile.
//     d. dy = dz W[day]^T on the tensor cores: W[day] read row-major as the
//        [n][k] tile B fragments take (no transposed copy); dy to a scratch.
//  3. dw_dx: per sample, 4 blocks for the 128 x 128 tiles of dW = y^T dz
//     (split-TF32; y and dz chunks of 32 rows from the L2-resident scratch,
//     cp.async, three stages, two in flight; A read as transposed fragments
//     of the [t][d] tile, pitch 136 floats, conflict-free); the two blocks
//     of the first row tile also sum db over t in order. One block an SM
//     where those blocks fill the SMs once, else two. The same launch runs
//     one block per (sample, 64-row tile) for dx: a thread per channel
//     slides register windows of dy over the 20 reversed taps, as 2a does
//     over x.
// A day index is clamped to [0, n_days), as XLA's gather clamps it.
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

// ---- backward (header note) ----

constexpr int kC = 256;             // channels: the backward takes no other
constexpr int kThreads = 256;       // 8 warps; one thread a channel in the row phases
constexpr int kTile = 64;           // time rows per dz_dy block
constexpr int kMT = kTile / 16;     // m16 tiles of a warp's rows (all of the block's)
constexpr int kLdA = kC + 4;        // A tile pitch: banks 4 g + t for row-major fragments
constexpr int kKc = 8;              // K rows of a staged W chunk: one k step
constexpr int kChunks = kC / kKc;   // W chunks a product
constexpr int kLdWk = kC + 8;       // W chunk [k][n] (pre): banks 8 t + g
constexpr int kLdWn = kKc + 4;      // W chunk [n][k] (dy): banks 12 g + t, distinct mod 32
constexpr int kWBuf = kC * kLdWn;   // floats of one W buffer (the larger of the two layouts)
constexpr int kWBufs = 3;           // W chunk buffers: two chunks in flight
constexpr int kMaxTaps = 32;
constexpr int kRun = 16;            // rows of a smoothing register window
static_assert(kKc * kLdWk <= kWBuf, "a pre chunk fits a W buffer");
constexpr size_t kDzDySmem = (size_t)(kTile * kLdA + kWBufs * kWBuf) * sizeof(float);

constexpr int kGCh = 32;            // channels of a gather block
constexpr int kGSpan = 8;           // s values of a gather block (rows 4 s .. 4 s + 3): one a warp
constexpr int kGRows = kGSpan + 7;  // g window rows a gather block reads (main path)
constexpr size_t kGatherSmem = (size_t)kGRows * kGCh * 8 * 4 * sizeof(float);

constexpr int kDwTile = 128;        // dW output tile (d and c)
constexpr int kDwKc = 32;           // time rows of a staged dW chunk
constexpr int kLdDw = kDwTile + 8;  // [t][d] and [t][c] chunk pitch: banks 8 t + g for both fragments
constexpr int kDwStage = 2 * kDwKc * kLdDw;  // floats of one stage (y and dz chunks)
constexpr size_t kDwDxSmem = (size_t)3 * kDwStage * sizeof(float);

// 16 bytes into shared memory by cp.async, L2 told to evict them first: g
// is read once, and W[day] and the scratch should stay in L2 around it
__device__ __forceinline__ void cp_async16_stream(void* dst, const void* src, uint64_t policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "l"(policy));
}

// dzs[b, t, c] = sum over the windows t' and offsets j with t' stride + j =
// t of g[b, t', c k + j]: the d unfold, before the softsign's derivative.
// Main path (kernel_len 32, stride 4, compile-time): row t = 4 s + r takes
// g[s - m, c*32 + 4 m + r] for m = 0 .. 7, so one 16-byte piece (t', c, m)
// of a window row is the r = 0 .. 3 terms of rows 4 (t' + m) .. + 3 of
// channel c. Block (32 channels, 8 s values, sample): the pieces its rows
// take from window rows s0 - 7 .. s0 + 7, 32 KB, each staged once (16-byte
// cp.async, coalesced, all in flight together; three blocks an SM) at
// c*8 + (m ^ (c & 7)) of its row, so that warp w, which sums s0 + w for its
// 32 channels in m order (the plain version's order), reads them with
// 16-byte loads free of bank conflicts. Other windows: a scalar gather, one
// division a row.
template <bool kMain>
__global__ void __launch_bounds__(kThreads)
    preproc_bwd_gather_kernel(const float* __restrict__ g, float* __restrict__ dzs, int T, int k, int stride,
                              int t_out) {
  extern __shared__ __align__(16) float gsm[];  // [kGRows][kGCh][8] pieces
  const int c0 = blockIdx.x * kGCh, s0 = blockIdx.y * kGSpan, b = blockIdx.z;
  const int cl = threadIdx.x & 31, sl = threadIdx.x >> 5;
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (kMain) {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
    const float* gb = g + (size_t)b * t_out * kC * 32 + c0 * 32;
#pragma unroll
    for (int i = 0; i < kGRows; ++i) {  // piece (c0 + e / nm, mlo + e % nm) of row s0 - 7 + i
      constexpr int kLast = kGRows - 1;
      const int mlo = i < 7 ? 7 - i : 0, mhi = i > kLast - 7 ? kLast - i : 7, nm = mhi - mlo + 1;
      const int tp = s0 - 7 + i, e = threadIdx.x;
      if (e < kGCh * nm && tp >= 0 && tp < t_out) {
        const int c = e / nm, m = mlo + e - c * nm;
        cp_async16_stream(gsm + ((i * kGCh + c) * 8 + (m ^ (c & 7))) * 4, gb + (size_t)tp * kC * 32 + c * 32 + 4 * m,
                          policy);
      }
    }
    w2vb::cp_async_commit();
    w2vb::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int tp = s0 + sl - m;
      if (tp >= 0 && tp < t_out) {
        const float4 v =
            *reinterpret_cast<const float4*>(gsm + (((sl + 7 - m) * kGCh + cl) * 8 + (m ^ (cl & 7))) * 4);
        sum[0] += v.x;
        sum[1] += v.y;
        sum[2] += v.z;
        sum[3] += v.w;
      }
    }
  }
  const int c = c0 + cl;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = 4 * (s0 + sl) + r;
    if (t >= T) break;
    if constexpr (!kMain) {
      const int lo = max(0, (t - k + stride) / stride), hi = min(t_out - 1, t / stride);
      const size_t ck = (size_t)kC * k;
      for (int tp = lo; tp <= hi; ++tp) sum[r] += g[((size_t)b * t_out + tp) * ck + (size_t)c * k + t - tp * stride];
    }
    dzs[((size_t)b * T + t) * kC + c] = sum[r];
  }
}

// out[i] = sum_{j < n_taps} tp[j] * src[(t0 + i - left + j) * kC], zero
// outside rows [0, T): kRun outputs of a correlation along time for one
// channel, from a register window of kRun + n_taps - 1 rows (loads issued
// together); the terms of each output summed in tap order
__device__ __forceinline__ void smooth_run(const float* __restrict__ src, int T, int t0, int left,
                                           const float (&tp)[kMaxTaps], int n_taps, float (&out)[kRun]) {
  float xr[kRun + kMaxTaps - 1];
#pragma unroll
  for (int j = 0; j < kRun + kMaxTaps - 1; ++j) {
    const int s = t0 - left + j;
    xr[j] = j < kRun + n_taps - 1 && s >= 0 && s < T ? src[(size_t)s * kC] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) out[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j) {
    if (j < n_taps) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) out[i] = fmaf(tp[j], xr[i + j], out[i]);
    }
  }
}

// W[day] chunk kc into buf (no commit): pre (kNK false) takes rows d = 8
// kc .. + 7, all columns, as a [k][n] tile; dy (kNK true) columns 8 kc .. +
// 7 of all rows, as an [n][k] tile. 512 16-byte copies, 2 a thread.
template <bool kNK>
__device__ __forceinline__ void stage_w(float* buf, const float* __restrict__ wd, int kc) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if constexpr (kNK) {
      const int n = i >> 1, q = (i & 1) * 4;
      w2vb::cp_async16(buf + n * kLdWn + q, wd + (size_t)n * kC + kc * kKc + q);
    } else {
      const int r = i >> 6, q = (i & 63) * 4;
      w2vb::cp_async16(buf + r * kLdWk + q, wd + (size_t)(kc * kKc + r) * kC + q);
    }
  }
}

// acc (a warp's 4 m16n8 tiles of one row block) += a . b for one 8-deep k
// step, split operands: the three TF32 products of the four tiles in turn,
// the small ones first, so that four independent products separate two
// that add into one accumulator
__device__ __forceinline__ void mma_row(float (&acc)[4][4], const uint32_t (&ab)[4], const uint32_t (&asm_)[4],
                                        const uint32_t (&bb)[4][2], const uint32_t (&bs)[4][2]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) w2vb::mma_tf32(acc[nt], ab, bs[nt]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) w2vb::mma_tf32(acc[nt], asm_, bb[nt]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) w2vb::mma_tf32(acc[nt], ab, bb[nt]);
}

// acc (a warp's 64 x 32 tile) += A[:, k0 .. k0 + 7] B[k0 .. k0 + 7, n_base
// ..], A the row-major tile `as`, B a staged W chunk. The B fragments are
// split once; each row block's A fragment is loaded and split in turn, so
// that the operands take 24 registers and two blocks fit an SM.
template <bool kNK>
__device__ __forceinline__ void mma_chunk(float (&acc)[kMT][4][4], const float* as, int k0, const float* bw,
                                          int n_base) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  uint32_t bb[4][2], bs[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n_base + 8 * nt + gq;
    const float* p = kNK ? bw + n * kLdWn + tq : bw + tq * kLdWk + n;
    w2vb::split_tf32(p[0], bb[nt][0], bs[nt][0]);
    w2vb::split_tf32(p[kNK ? 4 : 4 * kLdWk], bb[nt][1], bs[nt][1]);
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    uint32_t ab[4], asm_[4];
    const float* p = as + (16 * mt + gq) * kLdA + k0 + tq;
    w2vb::split_tf32(p[0], ab[0], asm_[0]);
    w2vb::split_tf32(p[8 * kLdA], ab[1], asm_[1]);
    w2vb::split_tf32(p[4], ab[2], asm_[2]);
    w2vb::split_tf32(p[8 * kLdA + 4], ab[3], asm_[3]);
    mma_row(acc[mt], ab, asm_, bb, bs);
  }
}

// acc = `as` (64 x 256) times W[day] (kNK false) or W[day]^T (kNK true):
// 32 chunks through three buffers, two in flight. The caller staged chunks
// 0 and 1 (one committed group each) into buffers 0 and 1.
template <bool kNK>
__device__ __forceinline__ void product(float (&acc)[kMT][4][4], const float* as, const float* __restrict__ wd,
                                        float* wbufs) {
  const int n_base = (threadIdx.x >> 5) * 32;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int kc = 0; kc < kChunks; ++kc) {
    w2vb::cp_async_wait<1>();  // chunk kc has landed (chunk kc + 1 may be in flight)
    __syncthreads();           // for every thread; and chunk kc - 1's buffer is free
    if (kc + 2 < kChunks) stage_w<kNK>(wbufs + (kc + 2) % kWBufs * kWBuf, wd, kc + 2);
    w2vb::cp_async_commit();  // empty past the last chunk: the wait count holds
    mma_chunk<kNK>(acc, as, kc * kKc, wbufs + kc % kWBufs * kWBuf, n_base);
  }
}

// Block (64-row tile, sample): y = smooth(x) into the A tile and the ys
// scratch; pre = y W[day] + b[day]; dz = dzs / (1 + |pre|)^2, in place in
// dzs and into the A tile; dy = dz W[day]^T.
__global__ void __launch_bounds__(kThreads, 2)
    preproc_bwd_dz_dy_kernel(const float* __restrict__ x, const float* __restrict__ w,
                             const float* __restrict__ bias, const int* __restrict__ day_idxs,
                             const float* __restrict__ taps, float* __restrict__ ys, float* __restrict__ dz,
                             float* __restrict__ dy, int T, int n_taps, int n_days) {
  extern __shared__ __align__(16) float sm[];
  float* as = sm;                    // [kTile][kLdA]: y, then pre + b, then dz
  float* wbufs = as + kTile * kLdA;  // three W chunk buffers
  const int b = blockIdx.y, t0 = blockIdx.x * kTile, c = threadIdx.x;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3, n_base = (threadIdx.x >> 5) * 32;
  const int day = clamp_day(day_idxs, b, n_days);
  const float* wd = w + (size_t)day * kC * kC;
  const size_t row0 = (size_t)b * T;
  stage_w<false>(wbufs, wd, 0);  // W's first chunks land while the smoothing runs
  w2vb::cp_async_commit();
  stage_w<false>(wbufs + kWBuf, wd, 1);
  w2vb::cp_async_commit();

  // y = smooth(x), thread = channel
  {
    float tp[kMaxTaps];
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) tp[j] = j < n_taps ? taps[j] : 0.f;
    for (int r0 = 0; r0 < kTile; r0 += kRun) {
      float yv[kRun];
      smooth_run(x + row0 * kC + c, T, t0 + r0, (n_taps - 1) / 2, tp, n_taps, yv);
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int t = t0 + r0 + i;
        as[(r0 + i) * kLdA + c] = t < T ? yv[i] : 0.f;
        if (t < T) ys[(row0 + t) * kC + c] = yv[i];
      }
    }
  }

  // pre = y W[day] + b[day], back into the A tile
  float acc[kMT][4][4];
  product<false>(acc, as, wd, wbufs);
  __syncthreads();  // every warp is done with y and the W buffers
  stage_w<true>(wbufs, wd, 0);  // dy's first chunks land during the dz phase
  w2vb::cp_async_commit();
  stage_w<true>(wbufs + kWBuf, wd, 1);
  w2vb::cp_async_commit();
  {
    const float* bd = bias + (size_t)day * kC;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n_base + 8 * nt + 2 * tq;
      const float b0 = bd[col], b1 = bd[col + 1];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int row = 16 * mt + gq;
        *reinterpret_cast<float2*>(as + row * kLdA + col) = make_float2(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
        *reinterpret_cast<float2*>(as + (row + 8) * kLdA + col) =
            make_float2(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
      }
    }
  }
  __syncthreads();

  // dz = dzs / (1 + |pre|)^2 for channel c's rows (dzs: the gather launch)
  {
    float sv[kTile];
#pragma unroll
    for (int row = 0; row < kTile; ++row) sv[row] = t0 + row < T ? dz[(row0 + t0 + row) * kC + c] : 0.f;
#pragma unroll
    for (int row = 0; row < kTile; ++row) {
      const float den = 1.f + fabsf(as[row * kLdA + c]);
      const float v = sv[row] / (den * den);
      as[row * kLdA + c] = v;
      if (t0 + row < T) dz[(row0 + t0 + row) * kC + c] = v;
    }
  }

  // dy = dz W[day]^T (the first barrier of product orders the dz writes)
  product<true>(acc, as, wd, wbufs);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + 16 * mt + gq + 8 * h;
      if (t >= T) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(dy + (row0 + t) * kC + n_base + 8 * nt + 2 * tq) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
}

// Blocks [0, 4 B): dW_b tile (d0, c0) = y^T dz over all T (and db_b for the
// tiles of d0 = 0); blocks [4 B, 4 B + B * ceil(T / kTile)): dx of one
// sample's row tile. kPerSm: the blocks an SM holds. Where the dW blocks
// fill the SMs once (4 B <= SMs) one an SM (up to 255 registers); else two,
// so that they fill them once (at most 128 registers).
template <int kPerSm>
__global__ void __launch_bounds__(kThreads, kPerSm)
    preproc_bwd_dw_dx_kernel(const float* __restrict__ ys, const float* __restrict__ dz,
                             const float* __restrict__ dy, const float* __restrict__ taps, float* __restrict__ dw,
                             float* __restrict__ db, float* __restrict__ dx, int B, int T, int n_taps) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  if (blockIdx.x >= 4 * B) {  // dx = the reversed-tap smoothing of dy
    const int nt = (T + kTile - 1) / kTile, i = blockIdx.x - 4 * B;
    const int b = i / nt, t0 = (i - b * nt) * kTile;
    float tp[kMaxTaps];
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) tp[j] = j < n_taps ? taps[n_taps - 1 - j] : 0.f;
    const size_t row0 = (size_t)b * T;
    for (int r0 = 0; r0 < kTile; r0 += kRun) {
      float v[kRun];
      smooth_run(dy + row0 * kC + tid, T, t0 + r0, n_taps / 2, tp, n_taps, v);
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        if (t0 + r0 + r < T) dx[(row0 + t0 + r0 + r) * kC + tid] = v[r];
    }
    return;
  }
  const int b = blockIdx.x >> 2, d0 = (blockIdx.x >> 1 & 1) * kDwTile, c0 = (blockIdx.x & 1) * kDwTile;
  const int lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int m_base = (warp >> 2) * 64, n_base = (warp & 3) * 32;
  const float* yb = ys + (size_t)b * T * kC + d0;
  const float* zb = dz + (size_t)b * T * kC + c0;
  const int n_chunks = (T + kDwKc - 1) / kDwKc;
  // chunk kc: rows 32 kc .. + 31 of y (columns d0 ..) and dz (columns c0 ..), zeros past T
  auto stage = [&](int kc) {
    float* st = sm + kc % 3 * kDwStage;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = tid + u * kThreads, which = i >> 10, r = (i >> 5) & 31, q = (i & 31) * 4;
      const int t = kc * kDwKc + r;
      const float* src = (which ? zb : yb) + (size_t)min(t, T - 1) * kC + q;
      w2vb::cp_async16_zfill(st + which * kDwKc * kLdDw + r * kLdDw + q, src, t < T ? 16 : 0);
    }
    w2vb::cp_async_commit();
  };
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float dbs = 0.f;
  const bool sums_db = d0 == 0 && tid < kDwTile;
  stage(0);  // three stages, two in flight
  if (n_chunks > 1) stage(1); else w2vb::cp_async_commit();
  for (int kc = 0; kc < n_chunks; ++kc) {
    const float* ysm = sm + kc % 3 * kDwStage;  // [t][d]
    const float* zsm = ysm + kDwKc * kLdDw;     // [t][c]
    w2vb::cp_async_wait<1>();  // stage kc has landed
    __syncthreads();           // for every thread; and stage kc - 1 is free
    if (kc + 2 < n_chunks) stage(kc + 2); else w2vb::cp_async_commit();
    if (sums_db) {
#pragma unroll 8
      for (int r = 0; r < kDwKc; ++r) dbs += zsm[r * kLdDw + tid];
    }
#pragma unroll
    for (int kk = 0; kk < kDwKc; kk += 8) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = zsm + (kk + tq) * kLdDw + n_base + 8 * nt + gq;
        w2vb::split_tf32(p[0], bb[nt][0], bs[nt][0]);
        w2vb::split_tf32(p[4 * kLdDw], bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {  // A[m = d][k = t] = y[t][d]: transposed fragments
        uint32_t ab[4], asm_[4];
        const float* p = ysm + (kk + tq) * kLdDw + m_base + 16 * mt + gq;
        w2vb::split_tf32(p[0], ab[0], asm_[0]);
        w2vb::split_tf32(p[8], ab[1], asm_[1]);
        w2vb::split_tf32(p[4 * kLdDw], ab[2], asm_[2]);
        w2vb::split_tf32(p[4 * kLdDw + 8], ab[3], asm_[3]);
        mma_row(acc[mt], ab, asm_, bb, bs);
      }
    }
  }
  float* dwb = dw + (size_t)b * kC * kC + (size_t)d0 * kC + c0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = m_base + 16 * mt + gq, col = n_base + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(dwb + (size_t)row * kC + col) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(dwb + (size_t)(row + 8) * kC + col) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  if (sums_db) db[(size_t)b * kC + c0 + tid] = dbs;
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

// Backward: g (B, T', 256 k) f32; ys, dz and dy are (B, T, 256) f32
// scratch; dx (B, T, 256), dw (B, 256, 256) and db (B, 1, 256) f32. Needs
// C == 256, 1 <= n_taps <= 32 and t_out >= 1; kernel_len 32 with stride 4
// takes the vector gather, any other pair the scalar one.
extern "C" int w2vb_preproc_bwd(const float* x, const float* w, const float* bias, const int* day_idxs,
                                const float* taps, const float* g, float* ys, float* dz, float* dy, float* dx,
                                float* dw, float* db, int B, int T, int C, int n_taps, int n_days, int k,
                                int stride, int t_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C != kC || n_taps < 1 || n_taps > kMaxTaps || t_out < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g0(kC / kGCh, (T + 4 * kGSpan - 1) / (4 * kGSpan), B);
  cudaError_t e;
  if (k == 32 && stride == 4) {
    e = w2vb::allow_smem(preproc_bwd_gather_kernel<true>, kGatherSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    preproc_bwd_gather_kernel<true><<<g0, kThreads, kGatherSmem, s>>>(g, dz, T, k, stride, t_out);
  } else {
    preproc_bwd_gather_kernel<false><<<g0, kThreads, 0, s>>>(g, dz, T, k, stride, t_out);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = w2vb::allow_smem(preproc_bwd_dz_dy_kernel, kDzDySmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  preproc_bwd_dz_dy_kernel<<<dim3((T + kTile - 1) / kTile, B), kThreads, kDzDySmem, s>>>(
      x, w, bias, day_idxs, taps, ys, dz, dy, T, n_taps, n_days);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, n_sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_blocks = 4 * B + B * ((T + kTile - 1) / kTile);
  if (4 * B <= n_sms) {
    e = w2vb::allow_smem(preproc_bwd_dw_dx_kernel<1>, kDwDxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    preproc_bwd_dw_dx_kernel<1><<<n_blocks, kThreads, kDwDxSmem, s>>>(ys, dz, dy, taps, dw, db, dx, B, T, n_taps);
  } else {
    e = w2vb::allow_smem(preproc_bwd_dw_dx_kernel<2>, kDwDxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    preproc_bwd_dw_dx_kernel<2><<<n_blocks, kThreads, kDwDxSmem, s>>>(ys, dz, dy, taps, dw, db, dx, B, T, n_taps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* w2vb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
