// Fused B2P2T preprocessing, forward and backward.
//
// Forward (replaces wav2vec2forbrain_tpu/ops/pallas_preproc.py::
// _fused_fwd_impl, the Pallas kernel _fwd_kernel): per sample, a 20-tap
// gaussian smoothing over time with torch 'same' padding ((k-1)/2 = 9
// frames left, k/2 = 10 right), the day-conditioned affine x @ W[day] +
// b[day] (256 x 256, day picked per sample), softsign, and an unfold
// (window 32, stride 4) into (T', 256 * 32) rows in channel-major order
// c * 32 + j.
//
// What bounds it on the H100: its least time is the bytes written. At the
// serving shape (B=32, T=384) the output is 32 x 89 x 8192 f32 = 93 MB
// (187 MB at the w2v batch of 64), eight times the input: 28 us at 3.35
// TB/s. The affine is
// 1.6 GFLOP, an f32 product: 24 us on the f32 FMA pipe, 10 us as
// split-TF32 tensor-core products (below) at the published TF32 rate;
// mma.sync reaches about a quarter of that rate on this card (PERF.md), so
// in practice the products, not the bytes, take most of the time.
//
// Design, two launches:
//  1. affine: one block of 8 warps per (sample, tile of 64 rows, or 32 where
//     that gives the busiest SM fewer rows), two blocks an SM: the
//     backward's dz_dy block (below) up to its pre. y = smooth(x) from
//     register windows into the A tile while W[day]'s first chunks land;
//     pre = y W[day] on split-TF32 mma.sync (product<false>, the backward's
//     code); b[day] and softsign in registers, z back into the A tile;
//     then z leaves in pieces of four rows of one channel, z4[b, s, c, r] =
//     z[b, 4 s + r, c] (16-byte stores, 512 contiguous bytes a warp). z4
//     (B, ceil(T / 4), 256, 4) is 12.6 MB at B=32 and stays in L2 for
//     launch 2. Rows turn into channel-major pieces here, where z passes
//     through shared memory anyway.
//  2. unfold, one stream of the output. Main path (kernel_len 32, stride 4,
//     compile-time): piece (t', c, q) of output row t' (floats c*32 + 4 q
//     .. + 3) is z rows 4 (t' + q) .. + 3 of channel c: z4 piece (t' + q,
//     c). A block owns 8 output rows of one sample; it stages the 15 z4
//     groups of their windows (61 KB, each piece once, 16-byte cp.async,
//     three blocks an SM) with piece (s, c) at s*256 + (c ^ (s & 7)), so
//     that the pieces q = 0 .. 7 of one channel, which a quarter warp
//     reads, lie in distinct bank groups. Each output piece is then one
//     16-byte shared load and one 16-byte streaming store (st.global.cs:
//     the output must not push z4 out of L2), consecutive threads on
//     consecutive pieces, a warp's store 512 contiguous bytes; no
//     division. Other windows: a scalar copy, one division an output
//     float.
// No library GEMM. An out-of-range day index is clamped to [0, n_days), as
// XLA's gather clamps it in the JAX package; no memory outside W is read.
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

__device__ __forceinline__ int clamp_day(const int* day_idxs, int b, int n_days) {
  const int day = day_idxs[b];
  return day < 0 ? 0 : (day >= n_days ? n_days - 1 : day);
}

constexpr int kC = 256;             // channels: the kernels take no other
constexpr int kThreads = 256;       // 8 warps; one thread a channel in the row phases
constexpr int kTile = 64;           // time rows per dz_dy block and wide affine block
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
// shared memory of an affine or dz_dy block of mt m16 tiles: the A tile and the W buffers
constexpr size_t tile_smem(int mt) { return (size_t)(16 * mt * kLdA + kWBufs * kWBuf) * sizeof(float); }

constexpr int kURows = 8;              // output rows of an unfold block
constexpr int kUGroups = kURows + 7;   // z4 groups their windows span (main path)
constexpr size_t kUnfoldSmem = (size_t)kUGroups * kC * 4 * sizeof(float);

constexpr int kGCh = 32;            // channels of a gather block
constexpr int kGSpan = 8;           // s values of a gather block (rows 4 s .. 4 s + 3): one a warp
constexpr int kGRows = kGSpan + 7;  // g window rows a gather block reads (main path)
constexpr size_t kGatherSmem = (size_t)kGRows * kGCh * 8 * 4 * sizeof(float);

constexpr int kDwTile = 128;        // dW output tile (d and c)
constexpr int kDwKc = 32;           // time rows of a staged dW chunk
constexpr int kLdDw = kDwTile + 8;  // [t][d] and [t][c] chunk pitch: banks 8 t + g for both fragments
constexpr int kDwStage = 2 * kDwKc * kLdDw;  // floats of one stage (y and dz chunks)
constexpr size_t kDwDxSmem = (size_t)3 * kDwStage * sizeof(float);

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

// acc (a warp's 16 MT x 32 tile) += A[:, k0 .. k0 + 7] B[k0 .. k0 + 7,
// n_base ..], A the row-major tile `as`, B a staged W chunk. The B fragments are
// split once; each row block's A fragment is loaded and split in turn, so
// that the operands take 24 registers and two blocks fit an SM.
template <bool kNK, int MT>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][4][4], const float* as, int k0, const float* bw,
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
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t ab[4], asm_[4];
    const float* p = as + (16 * mt + gq) * kLdA + k0 + tq;
    w2vb::split_tf32(p[0], ab[0], asm_[0]);
    w2vb::split_tf32(p[8 * kLdA], ab[1], asm_[1]);
    w2vb::split_tf32(p[4], ab[2], asm_[2]);
    w2vb::split_tf32(p[8 * kLdA + 4], ab[3], asm_[3]);
    mma_row(acc[mt], ab, asm_, bb, bs);
  }
}

// acc = `as` (16 MT x 256) times W[day] (kNK false) or W[day]^T (kNK true):
// 32 chunks through three buffers, two in flight. The caller staged chunks
// 0 and 1 (one committed group each) into buffers 0 and 1.
template <bool kNK, int MT>
__device__ __forceinline__ void product(float (&acc)[MT][4][4], const float* as, const float* __restrict__ wd,
                                        float* wbufs) {
  const int n_base = (threadIdx.x >> 5) * 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int kc = 0; kc < kChunks; ++kc) {
    w2vb::cp_async_wait<1>();  // chunk kc has landed (chunk kc + 1 may be in flight)
    __syncthreads();           // for every thread; and chunk kc - 1's buffer is free
    if (kc + 2 < kChunks) stage_w<kNK>(wbufs + (kc + 2) % kWBufs * kWBuf, wd, kc + 2);
    w2vb::cp_async_commit();  // empty past the last chunk: the wait count holds
    mma_chunk<kNK, MT>(acc, as, kc * kKc, wbufs + kc % kWBufs * kWBuf, n_base);
  }
}

// y = smooth(x) for channel c = threadIdx.x over rows t0 .. t0 + 16 MT - 1
// of one sample (x: that sample's rows): into the A tile (zeros past T)
// and, where kKeepY, into that sample's rows of the ys scratch
template <bool kKeepY, int MT>
__device__ __forceinline__ void smooth_tile(const float* __restrict__ x, int T, int t0,
                                            const float* __restrict__ taps, int n_taps, float* as,
                                            float* __restrict__ ys) {
  const int c = threadIdx.x;
  float tp[kMaxTaps];
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j) tp[j] = j < n_taps ? taps[j] : 0.f;
  for (int r0 = 0; r0 < 16 * MT; r0 += kRun) {
    float yv[kRun];
    smooth_run(x + c, T, t0 + r0, (n_taps - 1) / 2, tp, n_taps, yv);
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int t = t0 + r0 + i;
      as[(r0 + i) * kLdA + c] = t < T ? yv[i] : 0.f;
      if (kKeepY && t < T) ys[(size_t)t * kC + c] = yv[i];
    }
  }
}

// The A tile = acc (the product of `as` and W[day]) + b[day], through the
// softsign where kSoftsign
template <bool kSoftsign, int MT>
__device__ __forceinline__ void store_pre(const float (&acc)[MT][4][4], float* as, const float* __restrict__ bd) {
  const int tq = threadIdx.x & 3, gq = (threadIdx.x & 31) >> 2, n_base = (threadIdx.x >> 5) * 32;
  const auto out = [](float v) { return kSoftsign ? v / (1.f + fabsf(v)) : v; };
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n_base + 8 * nt + 2 * tq;
    const float b0 = bd[col], b1 = bd[col + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = 16 * mt + gq;
      *reinterpret_cast<float2*>(as + row * kLdA + col) =
          make_float2(out(acc[mt][nt][0] + b0), out(acc[mt][nt][1] + b1));
      *reinterpret_cast<float2*>(as + (row + 8) * kLdA + col) =
          make_float2(out(acc[mt][nt][2] + b0), out(acc[mt][nt][3] + b1));
    }
  }
}

// ---- forward ----

// Block (16 MT-row tile, sample): y = smooth(x) into the A tile; pre = y
// W[day]; z = softsign(pre + b[day]) into z4 (B, ceil(T / 4), 256, 4),
// z4[b, s, c, r] = z[b, 4 s + r, c]: a thread per channel, one 16-byte
// piece a group. Two blocks an SM (at most 128 registers).
template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
    preproc_fwd_affine_kernel(const float* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ bias, const int* __restrict__ day_idxs,
                              const float* __restrict__ taps, float* __restrict__ z4, int T, int n_taps,
                              int n_days) {
  extern __shared__ __align__(16) float sm[];
  float* as = sm;                      // [16 MT][kLdA]: y, then z
  float* wbufs = as + 16 * MT * kLdA;  // three W chunk buffers
  const int b = blockIdx.y, t0 = blockIdx.x * 16 * MT, c = threadIdx.x;
  const int day = clamp_day(day_idxs, b, n_days);
  const float* wd = w + (size_t)day * kC * kC;
  stage_w<false>(wbufs, wd, 0);  // W's first chunks land while the smoothing runs
  w2vb::cp_async_commit();
  stage_w<false>(wbufs + kWBuf, wd, 1);
  w2vb::cp_async_commit();
  smooth_tile<false, MT>(x + (size_t)b * T * kC, T, t0, taps, n_taps, as, nullptr);
  float acc[MT][4][4];
  product<false>(acc, as, wd, wbufs);
  __syncthreads();  // every warp is done with y
  store_pre<true>(acc, as, bias + (size_t)day * kC);
  __syncthreads();
  const int tg = (T + 3) >> 2, s0 = t0 >> 2;
  float* zb = z4 + ((size_t)b * tg + s0) * kC * 4 + c * 4;
#pragma unroll
  for (int i = 0; i < 4 * MT; ++i) {
    if (s0 + i >= tg) break;
    const float* p = as + 4 * i * kLdA + c;
    *reinterpret_cast<float4*>(zb + (size_t)i * kC * 4) = make_float4(p[0], p[kLdA], p[2 * kLdA], p[3 * kLdA]);
  }
}

// out[b, t', c k + j] = z[b, t' stride + j, c], z read from z4. Block (8
// output rows t0 .., sample). Main path (kernel_len 32, stride 4,
// compile-time): z4 groups t0 .. t0 + 14 staged (each piece once, 16-byte
// cp.async; piece (s, c) at s*256 + (c ^ (s & 7))); output piece p = 8 c +
// q of row t0 + r is staged piece (r + q, c): one 16-byte shared load free
// of bank conflicts (a quarter warp reads q = 0 .. 7 of one channel) and
// one 16-byte streaming store, consecutive threads on consecutive pieces.
// Other windows: a scalar copy, one division an output float.
template <bool kMain>
__global__ void __launch_bounds__(kThreads)
    preproc_fwd_unfold_kernel(const float* __restrict__ z4, float* __restrict__ out, int T, int k, int stride,
                              int t_out) {
  extern __shared__ __align__(16) float zsm[];  // [kUGroups][kC] pieces of 4 floats
  const int t0 = blockIdx.x * kURows, b = blockIdx.y, tid = threadIdx.x;
  const int tg = (T + 3) >> 2, rows = min(kURows, t_out - t0);
  const int row_len = kC * k;
  float* ob = out + ((size_t)b * t_out + t0) * row_len;
  if constexpr (kMain) {
    const float* zb = z4 + ((size_t)b * tg + t0) * kC * 4;  // groups t0 .. t0 + rows + 6: contiguous
#pragma unroll
    for (int s = 0; s < kUGroups; ++s)  // piece (s, c = tid)
      if (s < rows + 7) w2vb::cp_async16(zsm + (s * kC + (tid ^ (s & 7))) * 4, zb + (s * kC + tid) * 4);
    w2vb::cp_async_commit();
    w2vb::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kURows; ++r) {
      if (r >= rows) break;
      float4* orow = reinterpret_cast<float4*>(ob + (size_t)r * row_len);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int p = tid + u * kThreads, c = p >> 3, s = r + (p & 7);
        __stcs(orow + p, *reinterpret_cast<const float4*>(zsm + (s * kC + (c ^ (s & 7))) * 4));
      }
    }
  } else {
    const float* zb = z4 + (size_t)b * tg * kC * 4;
    for (int r = 0; r < rows; ++r)
      for (int o = tid; o < row_len; o += kThreads) {
        const int c = o / k, t = (t0 + r) * stride + o - c * k;
        ob[(size_t)r * row_len + o] = zb[((size_t)(t >> 2) * kC + c) * 4 + (t & 3)];
      }
  }
}

// ---- backward ----

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

  smooth_tile<true, kMT>(x + row0 * kC, T, t0, taps, n_taps, as, ys + row0 * kC);  // y = smooth(x)

  // pre = y W[day] + b[day], back into the A tile
  float acc[kMT][4][4];
  product<false>(acc, as, wd, wbufs);
  __syncthreads();  // every warp is done with y and the W buffers
  stage_w<true>(wbufs, wd, 0);  // dy's first chunks land during the dz phase
  w2vb::cp_async_commit();
  stage_w<true>(wbufs + kWBuf, wd, 1);
  w2vb::cp_async_commit();
  store_pre<false>(acc, as, bias + (size_t)day * kC);
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

cudaError_t sm_count(int* n_sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  return e == cudaSuccess ? cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev) : e;
}

template <int MT>
cudaError_t launch_affine(const float* x, const float* w, const float* bias, const int* day_idxs, const float* taps,
                          float* z, int B, int T, int n_taps, int n_days, cudaStream_t s) {
  const cudaError_t e = w2vb::allow_smem(preproc_fwd_affine_kernel<MT>, tile_smem(MT));
  if (e != cudaSuccess) return e;
  preproc_fwd_affine_kernel<MT><<<dim3((T + 16 * MT - 1) / (16 * MT), B), kThreads, tile_smem(MT), s>>>(
      x, w, bias, day_idxs, taps, z, T, n_taps, n_days);
  return cudaGetLastError();
}

}  // namespace

// Forward: x (B, T, 256) f32; z (B, 4 ceil(T / 4), 256) f32 scratch (z4);
// out (B, T', 256 k) f32. Needs C == 256, 1 <= n_taps <= 32 and t_out >=
// 1; kernel_len 32 with stride 4 takes the staged unfold, any other pair
// the scalar one.
extern "C" int w2vb_preproc_fwd(const float* x, const float* w, const float* bias, const int* day_idxs,
                                const float* taps, float* z, float* out, int B, int T, int C, int n_taps,
                                int n_days, int k, int stride, int t_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C != kC || n_taps < 1 || n_taps > kMaxTaps || t_out < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_sms = 0;
  cudaError_t e = sm_count(&n_sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the tensor-core products bound an affine block, so the SM given the most rows sets the time:
  // 64-row tiles unless 32-row tiles give that SM fewer (they stage W twice as often)
  const int per_sm64 = (B * ((T + 63) / 64) + n_sms - 1) / n_sms, per_sm32 = (B * ((T + 31) / 32) + n_sms - 1) / n_sms;
  e = 2 * per_sm64 <= per_sm32
          ? launch_affine<kMT>(x, w, bias, day_idxs, taps, z, B, T, n_taps, n_days, s)
          : launch_affine<kMT / 2>(x, w, bias, day_idxs, taps, z, B, T, n_taps, n_days, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g2((t_out + kURows - 1) / kURows, B);
  if (k == 32 && stride == 4) {
    e = w2vb::allow_smem(preproc_fwd_unfold_kernel<true>, kUnfoldSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    preproc_fwd_unfold_kernel<true><<<g2, kThreads, kUnfoldSmem, s>>>(z, out, T, k, stride, t_out);
  } else {
    preproc_fwd_unfold_kernel<false><<<g2, kThreads, 0, s>>>(z, out, T, k, stride, t_out);
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
  e = w2vb::allow_smem(preproc_bwd_dz_dy_kernel, tile_smem(kMT));
  if (e != cudaSuccess) return static_cast<int>(e);
  preproc_bwd_dz_dy_kernel<<<dim3((T + kTile - 1) / kTile, B), kThreads, tile_smem(kMT), s>>>(
      x, w, bias, day_idxs, taps, ys, dz, dy, T, n_taps, n_days);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int n_sms = 0;
  e = sm_count(&n_sms);
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
