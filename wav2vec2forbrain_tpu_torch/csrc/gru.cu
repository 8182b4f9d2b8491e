// Bidirectional GRU recurrence, forward (both directions in one launch).
//
// Replaces: wav2vec2forbrain_tpu/ops/pallas_gru.py::_fwd_impl (the Pallas
// kernel _fwd_kernel); ::_fwd_impl_dir (the same math one direction after
// the other, used there for H = 512 / 1024) has a kernel of its own, the
// per-direction forward at the end of this note. Per direction d and step t:
//   gh = h_cd @ W_hh[d]_cd + b_hh[d]          (f32 accumulation)
//   r = sig(gi_r + gh_r); z = sig(gi_z + gh_z); n = tanh(gi_n + r * gh_n)
//   h' = (1 - z) * n + z * h                  (h carried in f32)
// where _cd means rounded to the compute dtype (the JAX kernel's `_mm`): the
// caller passes W_hh already in the compute dtype, and the kernel keeps a
// rounded copy of h next to the f32 carry. gi = x @ W_ih + b_ih comes in
// precomputed (one large GEMM outside, as in the JAX package); the backward
// direction's gi is already time-flipped by the caller.
//
// What bounds it on the H100: the sequential dependence over T and the
// bytes of W_hh each block reads per step. One direction's W_hh at H=256 is
// 256 x 768 f32 = 768 KiB (384 KiB in bf16), more than the 227 KB of shared
// memory a block can hold, so the weight cannot stay on chip in one block.
//
// Design: W_hh stays in global memory, where it is resident in the 50 MB L2.
// One block owns one direction and kBatch batch rows for all T steps; it
// holds h (f32 carry plus its compute-dtype copy) in shared memory, double
// buffered, and synchronises once per step inside the block. No grid-wide
// sync is needed because the directions and the batch rows are independent.
// Thread i owns hidden unit i (and i + blockDim, ...): it accumulates the r,
// z and n columns of W_hh for all kBatch rows, so each W_hh element read
// from L2 feeds kBatch FMAs and the reads are coalesced across threads.
// Any H whose shared memory (16 * kBatch * H bytes) fits takes this kernel.
// Splitting W_hh across a thread-block cluster (distributed shared memory)
// is the next step for speed.
//
// Backward (replaces ::_bwd_impl, the Pallas kernel _bwd_kernel): reverse-
// time BPTT from the saved ys. Per step t, going down:
//   hprev = ys[t-1] (h0 at t = 0); gh and the gates recomputed as above
//   dh = dh_carry + g[t]
//   dgr, dgz, dgn -> dgi[t];  dgh = [dgr, dgz, dgn * r]
//   dh_carry = dh * z + dgh_cd @ W_hh_cd^T
// and, summed over all steps and batch rows,
//   dW_hh = sum hprev_cd^T dgh_cd   (H x 3H per direction),  db_hh = sum dgh
// The JAX kernel keeps dW_hh (2 x 256 x 768 f32 = 1.5 MiB at H = 256)
// resident across the reverse loop; no H100 block can hold that, and a
// rank-kBatch update of a global partial at every step would move ~90 x
// 1.5 MiB per block. So the backward is three launches:
//  1. the recurrence, with the forward's layout (one block per direction
//     and kBatch batch rows, W_hh read from L2, hprev and the dh carry in
//     shared memory; the product with W_hh^T reads a transposed copy of
//     W_hh so that the reads stay coalesced across threads). It writes dgi
//     and dgh (T, 2, B, 3H) to device memory and dh0 at the end. Two block
//     barriers per step.
//  2. dW_hh as a tiled shared-memory product over the T * B rows (2848 at
//     the conformer slice's shape): one block per 64 x 64 output tile and
//     direction, 32-row chunks of hprev and dgh staged in shared memory,
//     4 x 4 outputs per thread. Each output is summed by one thread in a
//     fixed order: no atomics, deterministic. Both operands are rounded to
//     the compute dtype first, as the JAX `_mm` in _bwd_kernel does.
//  3. db_hh: one thread per column sums dgh over the rows in order.
// cuBLAS is not used: the JAX kernel computes dW_hh in its own body.
//
// Per-direction backward (replaces ::_bwd_impl_dir, the Pallas kernel
// _bwd_kernel_dir): the same BPTT, at the widths where the JAX package runs
// the directions one after the other (H = 512 / 1024). JAX computes dW_hh
// and db_hh outside that kernel, as an f32 einsum over all steps
// (::_vjp_bwd_dir); so does the port (ops/gru.py::gru_dir_dw_db, a plain
// f32 matmul). The kernel below computes dgi, dgh and dh0 only.
//
// What bounds it on the H100: the sequential dependence over T. Per step,
// the carry's product dgh_cd[t+1] . W^T (B x 3H by 3H x H) reads all of
// W_hh (6 MiB bf16, 12 MiB f32 per direction). Spread over the SMs that is
// tens of MB per step from the 50 MB L2, where W_hh of both directions
// stays resident: L2 bandwidth and latency bound a step at ~10-20 us. One
// block per direction and 4 batch rows (the fused kernel's layout, 32
// blocks at B = 64) used a quarter of the SMs and streamed W_hh as
// scalars, twice, ~1 ms a step.
//
// Design: gh does not depend on the carry, so one launch computes it for
// every step first: gh = hprev_cd . W_cd over all T x B rows (a block per
// 32 rows, 32 hidden units of each gate and direction; thousands of
// blocks). Then one launch per time step; the kernel boundary is the
// barrier between steps (no grid barrier, no cooperative launch). The host
// function loops t = T-1 .. 0, then one launch forms dh0. A step's block
// owns kU = 32 hidden units S of one direction and kBB = 32 batch rows: at
// H = 1024, B = 64 that is 32 x 2 x 2 = 128 blocks. Step t in a block:
//  (a) c1 = dgh_cd[t+1] . W_cd[S, :]^T over K = 3H: the whole dgh_cd row of
//      the previous launch (every block of it wrote its columns) against
//      the block's kU rows of W, which are contiguous: no transposed copy;
//  (b) dh = dhz + c1 + g[t] (dhz = the previous step's dh * z of the same
//      units, kept in device memory), the gates from gi[t] and gh[t], and
//      the outputs dgi[t], dgh[t] (f32), dgh_cd[t] (ping-pong buffer) and
//      dhz.
// Both products (gh's and c1) stage their operands in shared memory in
// 128-byte K-chunks through a 3-deep cp.async pipeline (an 8-deep one
// measured no faster for the step's product on the H100).
// bf16: mma.sync.m16n8k16 (bf16 inputs, f32 accumulators) on the tensor
// cores, each of the 4 warps a 16-row x 16-unit slab. f32: SIMT f32 FMAs (no TF32), 2 rows x 4 units (x 3 gates)
// per thread. The wrapper pads: W_hh to (Hp, 3 x Hp) with each gate block
// Hp wide and hprev_cd / dgh_cd to Bp rows, Hp = H rounded up to 64 and Bp
// = B to 32, zeros in the padding; so every chunk is whole and 16-byte
// aligned, any H and B are taken, and only the last step's writes mask
// the ragged edge.
//
// Per-direction forward (replaces ::_fwd_impl_dir, the Pallas kernel
// _fwd_kernel_dir): the forward counterpart of the step launches above.
// What bounds it: the same sequential dependence; per step, gh = h_cd[t-1]
// . W_cd reads all of W_hh from L2. The fused forward's layout (a block per
// direction and 4 batch rows, W_hh read as scalars) left 100 SMs idle:
// 20 ms at H = 1024, B = 64, 4x cuDNN. Design: one launch per time step
// (the host function loops t = 0 .. T-1) over the same 32-unit x 32-row x
// direction blocks. Step t in a block: gh = h_cd[t-1] . W_cd[:, the
// block's 32 units of each gate] over K = Hp, through the 3-deep cp.async
// pipeline (mma.sync at bf16, SIMT f32 FMAs at f32); then the gates with
// b_hh added after the product and the f32 carry read from ys[t-1] (h0 at
// t = 0); then ys[t] (f32) and h_cd[t], rounded, into a zero-padded
// ping-pong buffer that every block of step t+1 reads whole. W_hh goes in
// transposed, laid out once per call as (ND, 3 Hp, Hp), so that the
// block's 3 x 32 gate rows are K-contiguous and the mma B fragments load as
// 32-bit pairs (as the backward's carry product does); the backward's
// (Hp, 3 Hp) layout would need 16-bit scalar packing (the gh launch's) or
// ldmatrix.trans on the step's critical path. The copy is ~12 MB at H =
// 1024, once per call.
#include "common.cuh"

namespace {

constexpr int kBatch = 4;  // batch rows per block

template <typename W>
__global__ void gru_fwd_kernel(const float* __restrict__ gi, const W* __restrict__ w_hh,
                               const float* __restrict__ b_hh, const float* __restrict__ h0,
                               float* __restrict__ ys, int T, int ND, int B, int H) {
  constexpr bool cd_bf16 = sizeof(W) == 2;
  extern __shared__ float sm[];
  // two buffers, each [kBatch][H] f32 carry followed by [kBatch][H] rounded copy
  const int buf = 2 * kBatch * H;
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kBatch;
  const int nb = min(kBatch, B - b0);
  const int H3 = 3 * H;
  const W* w = w_hh + (size_t)d * H * H3;
  const float* bh = b_hh + (size_t)d * H3;

  for (int i = threadIdx.x; i < kBatch * H; i += blockDim.x) {
    const int bb = i / H;
    const int j = i - bb * H;
    const float v = bb < nb ? h0[((size_t)d * B + b0 + bb) * H + j] : 0.f;
    sm[i] = v;
    sm[kBatch * H + i] = w2vb::round_cd(v, cd_bf16);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* h = sm + (t & 1) * buf;
    const float* hc = h + kBatch * H;
    float* hn = sm + ((t + 1) & 1) * buf;
    float* hnc = hn + kBatch * H;
    const float* git = gi + (((size_t)t * ND + d) * B + b0) * H3;
    float* yt = ys + (((size_t)t * ND + d) * B + b0) * H;

    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      float a0[kBatch], a1[kBatch], a2[kBatch];
#pragma unroll
      for (int bb = 0; bb < kBatch; ++bb) a0[bb] = a1[bb] = a2[bb] = 0.f;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const W* wr = w + (size_t)j * H3;
        const float w0 = w2vb::to_f32(wr[i]);
        const float w1 = w2vb::to_f32(wr[H + i]);
        const float w2 = w2vb::to_f32(wr[2 * H + i]);
#pragma unroll
        for (int bb = 0; bb < kBatch; ++bb) {
          const float hv = hc[bb * H + j];
          a0[bb] = fmaf(hv, w0, a0[bb]);
          a1[bb] = fmaf(hv, w1, a1[bb]);
          a2[bb] = fmaf(hv, w2, a2[bb]);
        }
      }
      const float br = bh[i], bz = bh[H + i], bn = bh[2 * H + i];
#pragma unroll
      for (int bb = 0; bb < kBatch; ++bb) {
        if (bb < nb) {
          const float* g = git + (size_t)bb * H3;
          const float gh_r = a0[bb] + br;
          const float gh_z = a1[bb] + bz;
          const float gh_n = a2[bb] + bn;
          const float r = w2vb::sigmoidf(g[i] + gh_r);
          const float zg = w2vb::sigmoidf(g[H + i] + gh_z);
          const float n = tanhf(g[2 * H + i] + r * gh_n);
          const float hv = (1.f - zg) * n + zg * h[bb * H + i];
          hn[bb * H + i] = hv;
          hnc[bb * H + i] = w2vb::round_cd(hv, cd_bf16);
          yt[(size_t)bb * H + i] = hv;
        } else {
          hn[bb * H + i] = 0.f;
          hnc[bb * H + i] = 0.f;
        }
      }
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const float* gi, const void* w_hh, const float* b_hh, const float* h0, float* ys, int T,
           int ND, int B, int H, cudaStream_t s) {
  const size_t smem = (size_t)4 * kBatch * H * sizeof(float);
  cudaError_t e = w2vb::allow_smem(gru_fwd_kernel<W>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + kBatch - 1) / kBatch, ND);
  // one thread per hidden unit up to 512 threads (70-80 registers a thread
  // rule out 1024); larger H loops over units i, i + 512, ...
  const int threads = H < 512 ? ((H + 31) / 32) * 32 : 512;
  gru_fwd_kernel<W><<<grid, threads, smem, s>>>(gi, static_cast<const W*>(w_hh), b_hh, h0, ys, T,
                                                ND, B, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
__global__ void gru_bwd_kernel(const float* __restrict__ gi, const W* __restrict__ w_hh,
                               const W* __restrict__ w_t, const float* __restrict__ b_hh,
                               const float* __restrict__ h0, const float* __restrict__ ys,
                               const float* __restrict__ g, float* __restrict__ dgi,
                               float* __restrict__ dgh, float* __restrict__ dh0, int T, int ND,
                               int B, int H) {
  constexpr bool cd_bf16 = sizeof(W) == 2;
  extern __shared__ float sm[];
  const int H3 = 3 * H;
  float* hp = sm;                   // [kBatch][H] hprev, f32
  float* hpc = hp + kBatch * H;     // [kBatch][H] hprev rounded to the compute dtype
  float* dhs = hpc + kBatch * H;    // [kBatch][H] dh carry, f32
  float* dghc = dhs + kBatch * H;   // [kBatch][3H] dgh rounded to the compute dtype
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kBatch;
  const int nb = min(kBatch, B - b0);
  const W* w = w_hh + (size_t)d * H * H3;
  const W* wt = w_t + (size_t)d * H3 * H;
  const float* bh = b_hh + (size_t)d * H3;

  // hprev of step t: ys[t-1], or h0 at t = 0
  auto load_hprev = [&](int t) {
    for (int i = threadIdx.x; i < kBatch * H; i += blockDim.x) {
      const int bb = i / H;
      const int j = i - bb * H;
      float v = 0.f;
      if (bb < nb)
        v = t > 0 ? ys[(((size_t)(t - 1) * ND + d) * B + b0 + bb) * H + j]
                  : h0[((size_t)d * B + b0 + bb) * H + j];
      hp[i] = v;
      hpc[i] = w2vb::round_cd(v, cd_bf16);
    }
  };
  for (int i = threadIdx.x; i < kBatch * H; i += blockDim.x) dhs[i] = 0.f;
  load_hprev(T - 1);
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const size_t row0 = ((size_t)t * ND + d) * B + b0;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      float a0[kBatch], a1[kBatch], a2[kBatch];
#pragma unroll
      for (int bb = 0; bb < kBatch; ++bb) a0[bb] = a1[bb] = a2[bb] = 0.f;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const W* wr = w + (size_t)j * H3;
        const float w0 = w2vb::to_f32(wr[i]);
        const float w1 = w2vb::to_f32(wr[H + i]);
        const float w2 = w2vb::to_f32(wr[2 * H + i]);
#pragma unroll
        for (int bb = 0; bb < kBatch; ++bb) {
          const float hv = hpc[bb * H + j];
          a0[bb] = fmaf(hv, w0, a0[bb]);
          a1[bb] = fmaf(hv, w1, a1[bb]);
          a2[bb] = fmaf(hv, w2, a2[bb]);
        }
      }
      const float br = bh[i], bz = bh[H + i], bn = bh[2 * H + i];
#pragma unroll
      for (int bb = 0; bb < kBatch; ++bb) {
        float* dc = dghc + bb * H3;
        if (bb < nb) {
          const float* gr = gi + (row0 + bb) * H3;
          const float gh_n = a2[bb] + bn;
          const float r = w2vb::sigmoidf(gr[i] + (a0[bb] + br));
          const float z = w2vb::sigmoidf(gr[H + i] + (a1[bb] + bz));
          const float n = tanhf(gr[2 * H + i] + r * gh_n);
          const float dh = dhs[bb * H + i] + g[(row0 + bb) * H + i];
          const float dn = dh * (1.f - z);
          const float dzv = dh * (hp[bb * H + i] - n);
          const float dgn = dn * (1.f - n * n);
          const float dr = dgn * gh_n;
          const float dgz = dzv * z * (1.f - z);
          const float dgr = dr * r * (1.f - r);
          const float dghn = dgn * r;
          float* o = dgi + (row0 + bb) * H3;
          o[i] = dgr;
          o[H + i] = dgz;
          o[2 * H + i] = dgn;
          float* oh = dgh + (row0 + bb) * H3;
          oh[i] = dgr;
          oh[H + i] = dgz;
          oh[2 * H + i] = dghn;
          dc[i] = w2vb::round_cd(dgr, cd_bf16);
          dc[H + i] = w2vb::round_cd(dgz, cd_bf16);
          dc[2 * H + i] = w2vb::round_cd(dghn, cd_bf16);
          dhs[bb * H + i] = dh * z;  // the carry's first term; only this thread touches it
        } else {
          dc[i] = dc[H + i] = dc[2 * H + i] = 0.f;
        }
      }
    }
    __syncthreads();
    // dh_carry = dh * z + dgh_cd @ W_hh_cd^T (W^T row j is contiguous over i)
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      float acc[kBatch];
#pragma unroll
      for (int bb = 0; bb < kBatch; ++bb) acc[bb] = 0.f;
#pragma unroll 4
      for (int j = 0; j < H3; ++j) {
        const float wv = w2vb::to_f32(wt[(size_t)j * H + i]);
#pragma unroll
        for (int bb = 0; bb < kBatch; ++bb) acc[bb] = fmaf(dghc[bb * H3 + j], wv, acc[bb]);
      }
#pragma unroll
      for (int bb = 0; bb < kBatch; ++bb) dhs[bb * H + i] += acc[bb];
    }
    if (t > 0) load_hprev(t - 1);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kBatch * H; i += blockDim.x) {
    const int bb = i / H;
    if (bb < nb) dh0[((size_t)d * B + b0 + bb) * H + (i - bb * H)] = dhs[i];
  }
}

constexpr int kTile = 64;   // dW output tile (rows of H x columns of 3H)
constexpr int kChunk = 32;  // T*B rows staged per step

// dw[d] = sum over rows (t, b) of hprev_cd[t, d, b, :]^T dgh_cd[t, d, b, :]
__global__ void gru_dw_kernel(const float* __restrict__ h0, const float* __restrict__ ys,
                              const float* __restrict__ dgh, float* __restrict__ dw, int T,
                              int ND, int B, int H, bool round_bf16) {
  __shared__ float as[kChunk][kTile];  // hprev rows, columns i0 ..
  __shared__ float bs[kChunk][kTile];  // dgh rows, columns j0 ..
  const int H3 = 3 * H;
  const int j0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const int d = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int R = T * B;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

  for (int r0 = 0; r0 < R; r0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += blockDim.x) {
      const int rr = e / kTile;
      const int cc = e - rr * kTile;
      const int r = r0 + rr;
      float av = 0.f, bv = 0.f;
      if (r < R) {
        const int t = r / B;
        const int bb = r - t * B;
        const int i = i0 + cc;
        const int j = j0 + cc;
        if (i < H)
          av = t > 0 ? ys[(((size_t)(t - 1) * ND + d) * B + bb) * H + i]
                     : h0[((size_t)d * B + bb) * H + i];
        if (j < H3) bv = dgh[(((size_t)t * ND + d) * B + bb) * H3 + j];
      }
      as[rr][cc] = w2vb::round_cd(av, round_bf16);
      bs[rr][cc] = w2vb::round_cd(bv, round_bf16);
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kChunk; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = as[rr][ty * 4 + m];
#pragma unroll
      for (int n = 0; n < 4; ++n) b[n] = bs[rr][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty * 4 + m;
    if (i >= H) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j0 + tx + 16 * n;
      if (j < H3) dw[((size_t)d * H + i) * H3 + j] = acc[m][n];
    }
  }
}

// db[d, j] = sum over rows (t, b) of dgh[t, d, b, j], f32, rows in order
__global__ void gru_db_kernel(const float* __restrict__ dgh, float* __restrict__ db, int T, int ND,
                              int B, int H3) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int d = blockIdx.y;
  if (j >= H3) return;
  float acc = 0.f;
  for (int t = 0; t < T; ++t)
    for (int bb = 0; bb < B; ++bb) acc += dgh[(((size_t)t * ND + d) * B + bb) * H3 + j];
  db[(size_t)d * H3 + j] = acc;
}

template <typename W>
int launch_bwd(const float* gi, const void* w_hh, const void* w_t, const float* b_hh,
               const float* h0, const float* ys, const float* g, float* dgi, float* dgh,
               float* dw, float* db, float* dh0, int T, int ND, int B, int H, cudaStream_t s) {
  const size_t smem = (size_t)6 * kBatch * H * sizeof(float);
  cudaError_t e = w2vb::allow_smem(gru_bwd_kernel<W>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + kBatch - 1) / kBatch, ND);
  const int threads = H < 512 ? ((H + 31) / 32) * 32 : 512;
  gru_bwd_kernel<W><<<grid, threads, smem, s>>>(gi, static_cast<const W*>(w_hh),
                                                static_cast<const W*>(w_t), b_hh, h0, ys, g, dgi,
                                                dgh, dh0, T, ND, B, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gdw((3 * H + kTile - 1) / kTile, (H + kTile - 1) / kTile, ND);
  gru_dw_kernel<<<gdw, 256, 0, s>>>(h0, ys, dgh, dw, T, ND, B, H, sizeof(W) == 2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gdb((3 * H + 255) / 256, ND);
  gru_db_kernel<<<gdb, 256, 0, s>>>(dgh, db, T, ND, B, 3 * H);
  return static_cast<int>(cudaGetLastError());
}

// ---- per-direction backward: one launch per step (header note above) ----

constexpr int kU = 32;           // hidden units per block
constexpr int kBB = 32;          // batch rows per block
constexpr int kStages = 3;        // cp.async pipeline depth
constexpr int kDirThreads = 128;  // 4 warps
constexpr int kLdC1 = kU + 1;      // c1 [kBB][kU] in shared memory, padded
constexpr int kLdC2 = 3 * kU + 1;  // c2 [kBB][3 kU]

template <typename W>
struct DirTile {
  static constexpr int kKC = 128 / sizeof(W);  // K per chunk: 128 bytes of a row
  static constexpr int kVec = 16 / sizeof(W);  // elements per 16-byte copy; also the row padding
  static constexpr int kLdA = kKC + kVec;      // A rows, and B rows of the carry product
  static constexpr int kLdB2 = 3 * kU + kVec;  // B rows of the gh product (one per k)
  // B: K rows of 3 kU columns, or up to 3 kU rows of K (the forward's W^T)
  static constexpr int kBSize = kKC * kLdB2 > 3 * kU * kLdA ? kKC * kLdB2 : 3 * kU * kLdA;
  static constexpr int kStage = kBB * kLdA + kBSize;  // elements of one pipeline stage
  // the shared memory of a block: the stages, then the product in f32
  static constexpr size_t kSmem =
      (size_t)kStages * kStage * sizeof(W) + (size_t)kBB * kLdC2 * sizeof(float);
};

template <typename W>
struct DirArgs {
  const float* gi;    // (T, ND, B, 3H)
  const W* w;         // (ND, Hp, 3 Hp): W_hh in the compute dtype, each gate block Hp wide
  const float* b_hh;  // (ND, 3H)
  const float* h0;    // (ND, B, H)
  const float* ys;    // (T, ND, B, H)
  const float* g;     // (T, ND, B, H)
  W* hpc;             // (T, ND, Bp, Hp): hprev in the compute dtype, zero padded
  W* dghc;            // (2, ND, Bp, 3 Hp): dgh in the compute dtype, ping-pong, zero padded
  float* dhz;         // (ND, Bp, Hp): dh * z of the last step
  float* dgi;         // (T, ND, B, 3H)
  float* dgh;         // (T, ND, B, 3H)
  float* gh;          // (T, ND, Bp, 3 Hp): hprev_cd . W_cd, without b_hh
  float* dh0;         // (ND, B, H)
  int T, ND, B, H, Bp, Hp;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

using w2vb::ld_pair;
using w2vb::mma_bf16;

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The products share one pipeline; N = NG kU columns in NG segments of kU.
// NK (the backward's carry product, NG = 1; the forward's gh, NG = 3): B is
// N rows, K contiguous, segment g's kU rows at row g * seg of Bm. !NK (the
// backward's gh, NG = 3): B is K rows of W, of which the kU columns at
// column g * seg are taken. A is kBB rows.
template <typename W, bool NK, int NG>
__device__ __forceinline__ void load_chunk(W* st, const W* A, int lda, const W* Bm, int ldb,
                                           int seg, int c) {
  using L = DirTile<W>;
  constexpr int kPerRow = L::kKC / L::kVec;  // 16-byte copies per row of a chunk
  W* as = st;
  W* bs = st + kBB * L::kLdA;
  const int k0 = c * L::kKC;
  for (int p = threadIdx.x; p < kBB * kPerRow; p += kDirThreads) {
    const int r = p / kPerRow, q = (p % kPerRow) * L::kVec;
    cp_async16(as + r * L::kLdA + q, A + (size_t)r * lda + k0 + q);
  }
  if constexpr (NK) {
    for (int p = threadIdx.x; p < NG * kU * kPerRow; p += kDirThreads) {
      const int r = p / kPerRow, q = (p % kPerRow) * L::kVec;
      cp_async16(bs + r * L::kLdA + q, Bm + (size_t)((r / kU) * seg + r % kU) * ldb + k0 + q);
    }
  } else {
    constexpr int kPerK = NG * kU / L::kVec;
    for (int p = threadIdx.x; p < L::kKC * kPerK; p += kDirThreads) {
      const int kk = p / kPerK, col = (p % kPerK) * L::kVec;
      cp_async16(bs + kk * L::kLdB2 + col,
                 Bm + (size_t)(k0 + kk) * ldb + (col / kU) * seg + col % kU);
    }
  }
}

// bf16: warp w takes rows 16 (w / 2) .. +16 and units 16 (w % 2) .. +16 (of
// each segment): n-tile j covers columns (j / 2) kU + 16 (w % 2) + 8 (j % 2).
template <bool NK, int NG>
__device__ __forceinline__ void compute_chunk(const __nv_bfloat16* st, float* acc) {
  using L = DirTile<__nv_bfloat16>;
  const __nv_bfloat16* as = st;
  const __nv_bfloat16* bs = st + kBB * L::kLdA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int mr = 16 * (warp >> 1), nu = 16 * (warp & 1);
#pragma unroll
  for (int kk = 0; kk < L::kKC; kk += 16) {
    uint32_t af[4];
    const __nv_bfloat16* ap = as + (mr + gq) * L::kLdA + kk + 2 * tq;
    af[0] = ld_pair(ap);
    af[1] = ld_pair(ap + 8 * L::kLdA);
    af[2] = ld_pair(ap + 8);
    af[3] = ld_pair(ap + 8 * L::kLdA + 8);
#pragma unroll
    for (int j = 0; j < 2 * NG; ++j) {
      const int n = (j >> 1) * kU + nu + 8 * (j & 1) + gq;
      uint32_t bf[2];
      if constexpr (NK) {
        const __nv_bfloat16* bp = bs + n * L::kLdA + kk + 2 * tq;
        bf[0] = ld_pair(bp);
        bf[1] = ld_pair(bp + 8);
      } else {
        const __nv_bfloat16* bp = bs + (kk + 2 * tq) * L::kLdB2 + n;
        bf[0] = pack_pair(bp[0], bp[L::kLdB2]);
        bf[1] = pack_pair(bp[8 * L::kLdB2], bp[9 * L::kLdB2]);
      }
      mma_bf16(acc + 4 * j, af, bf);
    }
  }
}

// f32: thread i takes rows 2 (i / 8), +1 and units i % 8 + 8 j (j < 4; of
// each segment); acc[j] row 2 (i / 8), acc[nj + j] the next row.
template <bool NK, int NG>
__device__ __forceinline__ void compute_chunk(const float* st, float* acc) {
  using L = DirTile<float>;
  constexpr int nj = 4 * NG;
  const float* as = st;
  const float* bs = st + kBB * L::kLdA;
  const int r0 = (threadIdx.x >> 3) * 2, u0 = threadIdx.x & 7;
#pragma unroll 4
  for (int kk = 0; kk < L::kKC; ++kk) {
    const float a0 = as[r0 * L::kLdA + kk], a1 = as[(r0 + 1) * L::kLdA + kk];
#pragma unroll
    for (int j = 0; j < nj; ++j) {
      const int u = (j >> 2) * kU + u0 + 8 * (j & 3);
      const float bv = NK ? bs[u * L::kLdA + kk] : bs[kk * L::kLdB2 + u];
      acc[j] = fmaf(a0, bv, acc[j]);
      acc[nj + j] = fmaf(a1, bv, acc[nj + j]);
    }
  }
}

template <typename W, int NG>
__device__ __forceinline__ void store_acc(const float* acc, float* C, int ldc) {
  if constexpr (sizeof(W) == 2) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const int row = 16 * (warp >> 1) + gq;
#pragma unroll
    for (int j = 0; j < 2 * NG; ++j) {
      const int col = (j >> 1) * kU + 16 * (warp & 1) + 8 * (j & 1) + 2 * tq;
      C[row * ldc + col] = acc[4 * j];
      C[row * ldc + col + 1] = acc[4 * j + 1];
      C[(row + 8) * ldc + col] = acc[4 * j + 2];
      C[(row + 8) * ldc + col + 1] = acc[4 * j + 3];
    }
  } else {
    constexpr int nj = 4 * NG;
    const int r0 = (threadIdx.x >> 3) * 2, u0 = threadIdx.x & 7;
#pragma unroll
    for (int j = 0; j < nj; ++j) {
      const int col = (j >> 2) * kU + u0 + 8 * (j & 3);
      C[r0 * ldc + col] = acc[j];
      C[(r0 + 1) * ldc + col] = acc[nj + j];
    }
  }
}

// C = A . B over nchunks chunks of K (see load_chunk), into shared memory
template <typename W, bool NK, int NG>
__device__ void block_product(W* stage, const W* A, int lda, const W* Bm, int ldb, int seg,
                              int nchunks, float* C, int ldc) {
  using L = DirTile<W>;
  constexpr int kStage = L::kStage;
  float acc[8 * NG];
#pragma unroll
  for (int j = 0; j < 8 * NG; ++j) acc[j] = 0.f;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) load_chunk<W, NK, NG>(stage + c * kStage, A, lda, Bm, ldb, seg, c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is in; every thread is done with chunk c - 1's stage
    const int nxt = c + kStages - 1;
    if (nxt < nchunks)
      load_chunk<W, NK, NG>(stage + (nxt % kStages) * kStage, A, lda, Bm, ldb, seg, nxt);
    cp_async_commit();
    compute_chunk<NK, NG>(stage + (c % kStages) * kStage, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free for the next product
  store_acc<W, NG>(acc, C, ldc);
}

// hpc[t, d, b, k] = hprev (ys[t-1], h0 at t = 0) in the compute dtype; 0 in the padding
template <typename W>
__global__ void gru_dir_hprev_kernel(DirArgs<W> a) {
  const size_t n = (size_t)a.T * a.ND * a.Bp * a.Hp;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int k = static_cast<int>(e % a.Hp);
    size_t rest = e / a.Hp;
    const int b = static_cast<int>(rest % a.Bp);
    rest /= a.Bp;
    const int d = static_cast<int>(rest % a.ND);
    const int t = static_cast<int>(rest / a.ND);
    float v = 0.f;
    if (b < a.B && k < a.H)
      v = t > 0 ? a.ys[(((size_t)(t - 1) * a.ND + d) * a.B + b) * a.H + k]
                : a.h0[((size_t)d * a.B + b) * a.H + k];
    a.hpc[e] = w2vb::from_f32<W>(v);
  }
}

// gh for every step: block (unit tile, tile of kBB rows of the T x Bp rows, direction)
template <typename W>
__global__ void __launch_bounds__(kDirThreads) gru_dir_gh_kernel(DirArgs<W> a) {
  using L = DirTile<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stage = reinterpret_cast<W*>(smem_raw);
  float* c2 = reinterpret_cast<float*>(smem_raw + (size_t)kStages * L::kStage * sizeof(W));
  const int i0 = blockIdx.x * kU, d = blockIdx.z;
  const int t = blockIdx.y * kBB / a.Bp, b0 = blockIdx.y * kBB % a.Bp;  // Bp % kBB == 0
  const int H3p = 3 * a.Hp;
  const W* wd = a.w + (size_t)d * a.Hp * H3p;
  const size_t row0 = ((size_t)t * a.ND + d) * a.Bp + b0;
  block_product<W, false, 3>(stage, a.hpc + row0 * a.Hp, a.Hp, wd + i0, H3p, a.Hp, a.Hp / L::kKC, c2,
                             kLdC2);
  __syncthreads();
  for (int e = threadIdx.x; e < kBB * 3 * kU; e += kDirThreads) {
    const int r = e / (3 * kU), col = e % (3 * kU);
    a.gh[(row0 + r) * H3p + (col / kU) * a.Hp + i0 + col % kU] = c2[r * kLdC2 + col];
  }
}

// Step t (T-1 down to 0), or t = -1: dh0 = dhz + dgh_cd[0] . W^T
template <typename W>
__global__ void __launch_bounds__(kDirThreads) gru_dir_bwd_step_kernel(DirArgs<W> a, int t) {
  using L = DirTile<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stage = reinterpret_cast<W*>(smem_raw);
  float* c1 = reinterpret_cast<float*>(smem_raw + (size_t)kStages * L::kStage * sizeof(W));
  const int i0 = blockIdx.x * kU, b0 = blockIdx.y * kBB, d = blockIdx.z;
  const int H = a.H, H3 = 3 * H, H3p = 3 * a.Hp;
  const W* wd = a.w + (size_t)d * a.Hp * H3p;
  const bool first = t == a.T - 1;  // no carry yet
  if (!first) {  // (a) c1 = dgh_cd[t+1] . W[S, :]^T
    const W* arows = a.dghc + ((size_t)(((t + 1) & 1) * a.ND + d) * a.Bp + b0) * H3p;
    block_product<W, true, 1>(stage, arows, H3p, wd + (size_t)i0 * H3p, H3p, 0, H3p / L::kKC, c1,
                              kLdC1);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBB * kU; e += kDirThreads) {
    const int r = e / kU, u = e % kU;
    const int b = b0 + r, i = i0 + u;
    if (b >= a.B || i >= H) continue;
    const size_t zi = ((size_t)d * a.Bp + b) * a.Hp + i;
    float dh = first ? 0.f : a.dhz[zi] + c1[r * kLdC1 + u];
    if (t < 0) {
      a.dh0[((size_t)d * a.B + b) * H + i] = dh;
      continue;
    }
    const size_t row = ((size_t)t * a.ND + d) * a.B + b;
    dh += a.g[row * H + i];
    const float* gr = a.gi + row * H3;
    const float* bh = a.b_hh + (size_t)d * H3;
    const float* cr = a.gh + (((size_t)t * a.ND + d) * a.Bp + b) * H3p + i;
    const float gh_n = cr[2 * a.Hp] + bh[2 * H + i];
    const float rg = w2vb::sigmoidf(gr[i] + (cr[0] + bh[i]));
    const float z = w2vb::sigmoidf(gr[H + i] + (cr[a.Hp] + bh[H + i]));
    const float n = tanhf(gr[2 * H + i] + rg * gh_n);
    const float hprev = t > 0 ? a.ys[(row - (size_t)a.ND * a.B) * H + i]
                              : a.h0[((size_t)d * a.B + b) * H + i];
    const float dn = dh * (1.f - z);
    const float dzv = dh * (hprev - n);
    const float dgn = dn * (1.f - n * n);
    const float dr = dgn * gh_n;
    const float dgz = dzv * z * (1.f - z);
    const float dgr = dr * rg * (1.f - rg);
    const float dghn = dgn * rg;
    float* o = a.dgi + row * H3;
    o[i] = dgr;
    o[H + i] = dgz;
    o[2 * H + i] = dgn;
    float* oh = a.dgh + row * H3;
    oh[i] = dgr;
    oh[H + i] = dgz;
    oh[2 * H + i] = dghn;
    W* dc = a.dghc + ((size_t)((t & 1) * a.ND + d) * a.Bp + b) * H3p;
    dc[i] = w2vb::from_f32<W>(dgr);
    dc[a.Hp + i] = w2vb::from_f32<W>(dgz);
    dc[2 * a.Hp + i] = w2vb::from_f32<W>(dghn);
    a.dhz[zi] = dh * z;
  }
}

template <typename W>
int launch_dir_bwd(const DirArgs<W>& a, cudaStream_t s) {
  using L = DirTile<W>;
  if (a.Hp % 64 || a.Bp % kBB || a.Hp < a.H || a.Bp < a.B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = w2vb::allow_smem(gru_dir_bwd_step_kernel<W>, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = w2vb::allow_smem(gru_dir_gh_kernel<W>, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t n = (size_t)a.T * a.ND * a.Bp * a.Hp;
  const unsigned blocks = static_cast<unsigned>(n / 256 + 1 < 8192 ? n / 256 + 1 : 8192);
  gru_dir_hprev_kernel<W><<<blocks, 256, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int units = (a.H + kU - 1) / kU;
  gru_dir_gh_kernel<W><<<dim3(units, a.T * a.Bp / kBB, a.ND), kDirThreads, L::kSmem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(units, a.Bp / kBB, a.ND);
  for (int t = a.T - 1; t >= -1; --t) {
    gru_dir_bwd_step_kernel<W><<<grid, kDirThreads, L::kSmem, s>>>(a, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// ---- per-direction forward: one launch per step (header note above) ----

template <typename W>
struct DirFwdArgs {
  const float* gi;    // (T, ND, B, 3H)
  const W* wt;        // (ND, 3 Hp, Hp): W_hh^T in the compute dtype, gate g's rows at g Hp
  const float* b_hh;  // (ND, 3H)
  const float* h0;    // (ND, B, H)
  W* hc;              // (2, ND, Bp, Hp): h in the compute dtype, ping-pong (h0 in slot 0), zero padded
  float* ys;          // (T, ND, B, H)
  int T, ND, B, H, Bp, Hp;
};

// Step t: gh = h_cd[t-1] . W_cd[:, the block's units of each gate], then the
// gates; writes ys[t] and h_cd[t] (slot (t + 1) & 1)
template <typename W>
__global__ void __launch_bounds__(kDirThreads) gru_dir_fwd_step_kernel(DirFwdArgs<W> a, int t) {
  using L = DirTile<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stage = reinterpret_cast<W*>(smem_raw);
  float* c = reinterpret_cast<float*>(smem_raw + (size_t)kStages * L::kStage * sizeof(W));
  const int i0 = blockIdx.x * kU, b0 = blockIdx.y * kBB, d = blockIdx.z;
  const int H = a.H, H3 = 3 * H, Hp = a.Hp;
  const W* arows = a.hc + ((size_t)((t & 1) * a.ND + d) * a.Bp + b0) * Hp;
  block_product<W, true, 3>(stage, arows, Hp, a.wt + ((size_t)d * 3 * Hp + i0) * Hp, Hp, Hp,
                            Hp / L::kKC, c, kLdC2);
  __syncthreads();
  W* hn = a.hc + (size_t)(((t + 1) & 1) * a.ND + d) * a.Bp * Hp;
  const float* bh = a.b_hh + (size_t)d * H3;
  for (int e = threadIdx.x; e < kBB * kU; e += kDirThreads) {
    const int r = e / kU, u = e % kU;
    const int b = b0 + r, i = i0 + u;
    if (b >= a.B || i >= H) continue;
    const size_t row = ((size_t)t * a.ND + d) * a.B + b;
    const float* gr = a.gi + row * H3;
    const float* cr = c + r * kLdC2 + u;
    const float gh_n = cr[2 * kU] + bh[2 * H + i];
    const float rg = w2vb::sigmoidf(gr[i] + (cr[0] + bh[i]));
    const float z = w2vb::sigmoidf(gr[H + i] + (cr[kU] + bh[H + i]));
    const float n = tanhf(gr[2 * H + i] + rg * gh_n);
    const float hprev = t > 0 ? a.ys[(row - (size_t)a.ND * a.B) * H + i]
                              : a.h0[((size_t)d * a.B + b) * H + i];
    const float h = (1.f - z) * n + z * hprev;
    a.ys[row * H + i] = h;
    hn[(size_t)b * Hp + i] = w2vb::from_f32<W>(h);
  }
}

template <typename W>
int launch_dir_fwd(const DirFwdArgs<W>& a, cudaStream_t s) {
  using L = DirTile<W>;
  if (a.Hp % 64 || a.Bp % kBB || a.Hp < a.H || a.Bp < a.B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = w2vb::allow_smem(gru_dir_fwd_step_kernel<W>, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.H + kU - 1) / kU, a.Bp / kBB, a.ND);
  for (int t = 0; t < a.T; ++t) {
    gru_dir_fwd_step_kernel<W><<<grid, kDirThreads, L::kSmem, s>>>(a, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// w_bf16: W_hh is bf16 (compute dtype bfloat16) rather than f32.
extern "C" int w2vb_gru_fwd(const float* gi, const void* w_hh, int w_bf16, const float* b_hh,
                            const float* h0, float* ys, int T, int ND, int B, int H,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16) return launch<__nv_bfloat16>(gi, w_hh, b_hh, h0, ys, T, ND, B, H, s);
  return launch<float>(gi, w_hh, b_hh, h0, ys, T, ND, B, H, s);
}

// Backward of the fused kernel: w_hh (ND, H, 3H) and w_t = its transpose
// (ND, 3H, H), both in the compute dtype (w_bf16); dgh is a (T, ND, B, 3H)
// f32 scratch; dw (ND, H, 3H), db (ND, 3H) and dh0 (ND, B, H) f32.
extern "C" int w2vb_gru_bwd(const float* gi, const void* w_hh, const void* w_t, int w_bf16,
                            const float* b_hh, const float* h0, const float* ys, const float* g,
                            float* dgi, float* dgh, float* dw, float* db, float* dh0, int T,
                            int ND, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return launch_bwd<__nv_bfloat16>(gi, w_hh, w_t, b_hh, h0, ys, g, dgi, dgh, dw, db, dh0, T, ND,
                                     B, H, s);
  return launch_bwd<float>(gi, w_hh, w_t, b_hh, h0, ys, g, dgi, dgh, dw, db, dh0, T, ND, B, H, s);
}

// Per-direction forward (ys; DirFwdArgs above for the layouts). wt and hc
// are in the compute dtype (w_bf16); hc must hold h0 in slot 0 and zeros in
// its padding. Hp % 64 == 0, Bp % 32 == 0.
extern "C" int w2vb_gru_dir_fwd(const float* gi, const void* wt, int w_bf16, const float* b_hh,
                                const float* h0, void* hc, float* ys, int T, int ND, int B, int H,
                                int Bp, int Hp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    using W = __nv_bfloat16;
    const DirFwdArgs<W> a{gi, static_cast<const W*>(wt), b_hh, h0, static_cast<W*>(hc), ys,
                          T, ND, B, H, Bp, Hp};
    return launch_dir_fwd(a, s);
  }
  const DirFwdArgs<float> a{gi, static_cast<const float*>(wt), b_hh, h0, static_cast<float*>(hc), ys,
                            T, ND, B, H, Bp, Hp};
  return launch_dir_fwd(a, s);
}

// Per-direction backward (dgi, dgh, dh0; DirArgs above for the layouts).
// w, hpc and dghc are in the compute dtype (w_bf16); dghc must hold zeros
// in its padding; hpc, dhz and gh need no initial values. Hp % 64 == 0,
// Bp % 32 == 0.
extern "C" int w2vb_gru_dir_bwd(const float* gi, const void* w, int w_bf16, const float* b_hh,
                                const float* h0, const float* ys, const float* g, void* hpc,
                                void* dghc, float* dhz, float* gh, float* dgi, float* dgh,
                                float* dh0, int T, int ND, int B, int H, int Bp, int Hp,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    using W = __nv_bfloat16;
    const DirArgs<W> a{gi, static_cast<const W*>(w), b_hh, h0, ys, g, static_cast<W*>(hpc),
                       static_cast<W*>(dghc), dhz, dgi, dgh, gh, dh0, T, ND, B, H, Bp, Hp};
    return launch_dir_bwd(a, s);
  }
  const DirArgs<float> a{gi, static_cast<const float*>(w), b_hh, h0, ys, g, static_cast<float*>(hpc),
                         static_cast<float*>(dghc), dhz, dgi, dgh, gh, dh0, T, ND, B, H, Bp, Hp};
  return launch_dir_bwd(a, s);
}
