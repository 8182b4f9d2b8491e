// Bidirectional GRU recurrence, forward (both directions in one launch).
//
// Replaces: wav2vec2forbrain_tpu/ops/pallas_gru.py::_fwd_impl (the Pallas
// kernel _fwd_kernel) and, for the forward, ::_fwd_impl_dir (the same math
// one direction after the other, used there for H = 512 / 1024). Per
// direction d and step t:
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
//     the conformer slice's shape, 5696 at the wav2vec2-base sweep's): one
//     block per 64 x 64 output tile and direction, 32-row chunks of hprev
//     and dgh staged in shared memory, 4 x 4 outputs per thread. Each
//     output is summed by one thread in a fixed order: no atomics,
//     deterministic. dw_cd = 1 rounds both operands to the compute dtype,
//     as the JAX `_mm` in _bwd_kernel does; dw_cd = 0 keeps them f32, as the
//     einsum outside the per-direction kernel does (::_vjp_bwd_dir).
//  3. db_hh: one thread per column sums dgh over the rows in order.
// cuBLAS is not used: the JAX kernel computes dW_hh in its own body.
//
// Per-direction variant (replaces ::_bwd_impl_dir, the Pallas kernel
// _bwd_kernel_dir, and the dW einsum of ::_vjp_bwd_dir): the JAX package
// runs the directions one after the other there because one direction's
// W_hh fits VMEM and two do not (H = 512 / 1024). Here each block already
// owns one direction and streams W_hh from L2, so the same three launches
// compute that function at any H <= 2400; at H = 1024 the recurrence
// holds 96 KiB of shared memory per block (hprev f32 and rounded, the dh
// carry, dgh rounded) and W_hh (12 MiB f32, 6 MiB bf16 per direction)
// stays in L2. dgi and dgh are written to device memory (the JAX kernel
// emits dgi and r, and rebuilds dgh = [dgr, dgz, dgn * r] outside).
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
               float* dw, float* db, float* dh0, int T, int ND, int B, int H, bool dw_cd,
               cudaStream_t s) {
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
  gru_dw_kernel<<<gdw, 256, 0, s>>>(h0, ys, dgh, dw, T, ND, B, H, dw_cd && sizeof(W) == 2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gdb((3 * H + 255) / 256, ND);
  gru_db_kernel<<<gdb, 256, 0, s>>>(dgh, db, T, ND, B, 3 * H);
  return static_cast<int>(cudaGetLastError());
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

// Backward: w_hh (ND, H, 3H) and w_t = its transpose (ND, 3H, H), both in
// the compute dtype (w_bf16); dgh is a (T, ND, B, 3H) f32 scratch; dw (ND,
// H, 3H), db (ND, 3H) and dh0 (ND, B, H) f32. dw_cd: 1 takes dW's product in
// the compute dtype (_bwd_impl), 0 in f32 (the per-direction _bwd_impl_dir).
extern "C" int w2vb_gru_bwd(const float* gi, const void* w_hh, const void* w_t, int w_bf16,
                            const float* b_hh, const float* h0, const float* ys, const float* g,
                            float* dgi, float* dgh, float* dw, float* db, float* dh0, int T,
                            int ND, int B, int H, int dw_cd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return launch_bwd<__nv_bfloat16>(gi, w_hh, w_t, b_hh, h0, ys, g, dgi, dgh, dw, db, dh0, T, ND,
                                     B, H, dw_cd != 0, s);
  return launch_bwd<float>(gi, w_hh, w_t, b_hh, h0, ys, g, dgi, dgh, dw, db, dh0, T, ND, B, H,
                           dw_cd != 0, s);
}
