// Bidirectional GRU recurrence, forward and backward.
//
// Replaces four Pallas kernels of wav2vec2forbrain_tpu/ops/pallas_gru.py:
// ::_fwd_impl (_fwd_kernel) and ::_bwd_impl (_bwd_kernel), the fused entry
// `gru_recurrence` that the conformer's biGRU (H = 256) runs; ::_fwd_impl_dir
// and ::_bwd_impl_dir (_fwd_kernel_dir, _bwd_kernel_dir), the per-direction
// entry `gru_recurrence_dir` that JAX runs for H = 512 / 1024. Per direction
// d and step t:
//   gh = h_cd @ W_hh[d]_cd + b_hh[d]          (f32 accumulation)
//   r = sig(gi_r + gh_r); z = sig(gi_z + gh_z); n = tanh(gi_n + r * gh_n)
//   h' = (1 - z) * n + z * h                  (h carried in f32)
// where _cd means rounded to the compute dtype (the JAX kernel's `_mm`). gi =
// x @ W_ih + b_ih comes in precomputed (one large GEMM outside, as in the JAX
// package); the backward direction's gi is already time-flipped by the caller.
// Backward, reverse-time BPTT from the saved ys, per step t going down:
//   hprev = ys[t-1] (h0 at t = 0); gh and the gates recomputed as above
//   dh = dh_carry + g[t]
//   dgr, dgz, dgn -> dgi[t];  dgh = [dgr, dgz, dgn * r]
//   dh_carry = dh * z + dgh_cd @ W_hh_cd^T
// and, summed over all steps and batch rows, dW_hh and db_hh: the fused
// entry as the JAX `_bwd_kernel` forms them in its body, dW_hh = sum hprev_cd^T
// dgh_cd (both rounded to the compute dtype, f32 sums) and db_hh = sum dgh
// (f32); the per-direction entry outside the kernels, as an f32 product of the
// unrounded values (JAX's ::_vjp_bwd_dir einsum; the port's
// ops/gru.py::gru_dir_dw_db).
//
// What bounds it on the H100: the sequential dependence over T. Per step,
// the forward's gh = h_cd . W_cd and the backward's carry product dgh_cd .
// W_cd^T read all of one direction's W_hh (H = 256: 384 KiB bf16; H = 1024:
// 6 MiB) from the 50 MB L2, where W_hh of both directions stays resident.
// No block can hold it (227 KB of shared memory), so every step is spread
// over many blocks, each reading its slice of W_hh from L2: L2 latency and
// bandwidth and the launch gap bound a step.
//
// Fused forward (gru_fwd_kernel): one block per direction and kBatch = 4
// batch rows for all T steps, h (f32 carry and its compute-dtype copy) in
// shared memory, one block barrier per step; thread i accumulates hidden
// unit i's r, z, n columns of W_hh (scalar L2 reads) for the kBatch rows.
// Any H whose shared memory (16 * kBatch * H bytes) fits takes it.
//
// Per-direction forward (gru_dir_fwd_step_kernel): one launch per time step
// (the host function loops t = 0 .. T-1; the kernel boundary is the barrier
// between steps: no grid barrier, no cooperative launch) over blocks of 32
// hidden units x 32 batch rows x direction. Step t in a block: gh = h_cd[t-1]
// . W_cd[:, the block's 32 units of each gate] over K = Hp, then the gates
// with b_hh added after the product and the f32 carry read from ys[t-1] (h0
// at t = 0); then ys[t] (f32) and h_cd[t], rounded, into a zero-padded
// ping-pong buffer that every block of step t+1 reads whole. W_hh goes in
// transposed, laid out once per call as (ND, 3 Hp, Hp), so that the block's
// 3 x 32 gate rows are K-contiguous and the mma B fragments load as 32-bit
// pairs.
//
// Backward, both entries, one set of kernels (launch_bwd):
//  1. gru_hprev_kernel: hprev in the compute dtype, row-major (T, ND, Bp, Hp)
//     for gh; for the fused entry also transposed (ND, Hp, Rp), rows r = t Bp
//     + b, through a 32 x 32 tile in shared memory.
//  2. gru_gh_kernel: gh does not depend on the carry, so one launch computes
//     it for every step: hprev_cd . W_cd over all T x Bp rows (thousands of
//     blocks).
//  3. gru_bwd_step_kernel, one launch per step t = T-1 .. 0 and one for dh0.
//     A block owns BU hidden units S of one direction and BM batch rows:
//     (a) c1 = dgh_cd[t+1] . W_cd[S, :]^T over K = 3 Hp: the whole dgh_cd row
//         of the previous launch (every block of it wrote its columns) against
//         the block's BU rows of W, which are contiguous;
//     (b) dh = dhz + c1 + g[t] (dhz = the previous step's dh * z of the same
//         units, in device memory; it, g[t], gi[t], gh[t] and hprev are
//         loaded before (a) starts), the gates from gi[t] and gh[t], and the
//         outputs dgi[t], dgh_cd[t] (ping-pong buffer) and dhz; the
//         per-direction entry also writes dgh[t] (f32) for its dW outside; the
//         fused entry writes dgh_cd[t] transposed (ND, 3 Hp, Rp) for dW and
//         adds dgh into a per-batch-row f32 sum dbp (fixed order: step by
//         step).
//     The tile: 32 units x 32 rows where that gives at least 64 blocks (H =
//     1024, B = 64: 128 blocks), else 16 x 16 (H = 256, B = 32: 64 blocks,
//     where 32 x 32 gave 16). A 16 x 16 tile has one 16 x 16 mma output, so
//     its 4 warps split each K chunk four ways and add their partials in
//     shared memory in a fixed order, and its pipeline is 12 chunks deep, so
//     that a step's K chunks (12 at H = 256, bf16) are all in flight at once.
//  4. gru_dw_kernel (fused entry): dW_hh[d] = hprev_cd^T . dgh_cd over the Rp
//     rows of all steps and batch rows, both operands K-contiguous from
//     their transposed copies: 32 x 96 output tiles, each summed by one
//     thread (or one mma accumulator) in a fixed order, no atomics; the
//     blocks of the first row tile also sum dbp over the batch rows into
//     db_hh. The JAX kernel accumulates dW per step; here one product runs
//     over the T Bp rows: the same terms in another order.
// Every product stages its operands in shared memory in 128-byte K chunks
// through a 3-deep cp.async pipeline. bf16: mma.sync.m16n8k16 (bf16 inputs,
// f32 accumulators) on the tensor cores; f32: SIMT f32 FMAs (no TF32), 2 rows
// x 4 units (x gates) per thread. The wrapper pads: W_hh to (Hp, 3 x Hp) with
// each gate block Hp wide, hprev_cd and dgh_cd to Bp rows and Rp = T Bp
// rounded up to 64, Hp = H rounded up to 64 and Bp = B to 32, zeros in the
// padding; so every chunk is whole and 16-byte aligned, any H and B are
// taken, and only the steps' writes mask the ragged edge.
#include "common.cuh"

namespace {

constexpr int kBatch = 4;  // batch rows per block of the fused forward

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

// ---- the step kernels' products (header note above) ----

constexpr int kDirThreads = 128;  // 4 warps
constexpr int kMinStepBlocks = 64;  // the 32 x 32 step tile where it gives at least this many blocks

// A block's output tile: BM rows (batch rows, or dW rows) x BU units of each
// gate segment. It has kSub 16 x 16 sub-tiles; where that is fewer than the
// 4 warps, KS warps (or thread groups, at f32) share each sub-tile, each a
// 1 / KS share of every K chunk, and their partials are added in a fixed
// order. S: the cp.async pipeline's depth.
template <int BM_, int BU_, int S_>
struct Tile {
  static constexpr int BM = BM_, BU = BU_, S = S_;
  static constexpr int kSub = (BM / 16) * (BU / 16);
  static constexpr int KS = 4 / kSub;
  static_assert(kSub * KS == 4, "a tile has 1, 2 or 4 sub-tiles of 16 x 16");
};
using Big = Tile<32, 32, 3>;
// all of a 16 x 16 step's K chunks in flight at H = 256 (3 Hp / 64 = 12 at bf16)
using Small = Tile<16, 16, 12>;

template <typename W, class Tl>
struct DirTile {
  static constexpr int kKC = 128 / sizeof(W);  // K per chunk: 128 bytes of a row
  static constexpr int kVec = 16 / sizeof(W);  // elements per 16-byte copy; also the row padding
  static constexpr int kLdA = kKC + kVec;      // A rows, and B rows of the NK products
  static constexpr int kLdB2 = 3 * Tl::BU + kVec;  // B rows of the gh product (one per k)
  // B: K rows of 3 BU columns (gh), or up to 3 BU rows of K (the others)
  static constexpr int kBSize =
      kKC * kLdB2 > 3 * Tl::BU * kLdA ? kKC * kLdB2 : 3 * Tl::BU * kLdA;
  static constexpr int kStage = Tl::BM * kLdA + kBSize;  // elements of one pipeline stage
  static constexpr int kLdC = 3 * Tl::BU + 1;            // the product in f32, KS copies
  // the shared memory of a block: the stages, then the product
  static constexpr size_t kSmem = (size_t)Tl::S * kStage * sizeof(W) +
                                  (size_t)Tl::KS * Tl::BM * kLdC * sizeof(float);
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
  W* hpct;            // (ND, Hp, Rp) or null: hpc transposed, rows r = t Bp + b, zero past T Bp
  W* dghc;            // (2, ND, Bp, 3 Hp): dgh in the compute dtype, ping-pong, zero padded
  W* dghct;           // (ND, 3 Hp, Rp) or null: dgh_cd of every step, transposed like hpct
  float* dbp;         // (ND, Bp, 3 Hp) or null: dgh summed over the steps, per batch row
  float* dhz;         // (ND, Bp, Hp): dh * z of the last step
  float* dgi;         // (T, ND, B, 3H)
  float* dgh;         // (T, ND, B, 3H) or null
  float* gh;          // (T, ND, Bp, 3 Hp): hprev_cd . W_cd, without b_hh
  float* dh0;         // (ND, B, H)
  int T, ND, B, H, Bp, Hp, Rp;
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

// The products share one pipeline; N = NG BU columns in NG segments of BU.
// NK (B is N rows, K contiguous: segment g's BU rows at row g * seg of Bm) or
// !NK (the gh product: B is K rows of W, of which the BU columns at column g *
// seg are taken). A is BM rows.
template <typename W, class Tl, bool NK, int NG>
__device__ __forceinline__ void load_chunk(W* st, const W* A, int lda, const W* Bm, int ldb,
                                           int seg, int c) {
  using L = DirTile<W, Tl>;
  constexpr int kPerRow = L::kKC / L::kVec;  // 16-byte copies per row of a chunk
  W* as = st;
  W* bs = st + Tl::BM * L::kLdA;
  const int k0 = c * L::kKC;
  for (int p = threadIdx.x; p < Tl::BM * kPerRow; p += kDirThreads) {
    const int r = p / kPerRow, q = (p % kPerRow) * L::kVec;
    cp_async16(as + r * L::kLdA + q, A + (size_t)r * lda + k0 + q);
  }
  if constexpr (NK) {
    for (int p = threadIdx.x; p < NG * Tl::BU * kPerRow; p += kDirThreads) {
      const int r = p / kPerRow, q = (p % kPerRow) * L::kVec;
      cp_async16(bs + r * L::kLdA + q,
                 Bm + (size_t)((r / Tl::BU) * seg + r % Tl::BU) * ldb + k0 + q);
    }
  } else {
    constexpr int kPerK = NG * Tl::BU / L::kVec;
    for (int p = threadIdx.x; p < L::kKC * kPerK; p += kDirThreads) {
      const int kk = p / kPerK, col = (p % kPerK) * L::kVec;
      cp_async16(bs + kk * L::kLdB2 + col,
                 Bm + (size_t)(k0 + kk) * ldb + (col / Tl::BU) * seg + col % Tl::BU);
    }
  }
}

// bf16: warp w takes sub-tile s = w % kSub (rows mr .. +16, units nu .. +16
// of each segment) and the k16 steps j of a chunk with j % KS == w / kSub;
// n-tile j covers columns (j / 2) BU + nu + 8 (j % 2).
template <class Tl, bool NK, int NG>
__device__ __forceinline__ void compute_chunk(const __nv_bfloat16* st, float* acc) {
  using L = DirTile<__nv_bfloat16, Tl>;
  const __nv_bfloat16* as = st;
  const __nv_bfloat16* bs = st + Tl::BM * L::kLdA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int s = warp % Tl::kSub, q = warp / Tl::kSub;
  const int mr = 16 * (s / (Tl::BU / 16)), nu = 16 * (s % (Tl::BU / 16));
#pragma unroll
  for (int kk = 0; kk < L::kKC; kk += 16) {
    if ((kk / 16) % Tl::KS != q) continue;
    uint32_t af[4];
    const __nv_bfloat16* ap = as + (mr + gq) * L::kLdA + kk + 2 * tq;
    af[0] = ld_pair(ap);
    af[1] = ld_pair(ap + 8 * L::kLdA);
    af[2] = ld_pair(ap + 8);
    af[3] = ld_pair(ap + 8 * L::kLdA + 8);
#pragma unroll
    for (int j = 0; j < 2 * NG; ++j) {
      const int n = (j >> 1) * Tl::BU + nu + 8 * (j & 1) + gq;
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

// f32: the threads form KS groups, group q the K share q of each chunk;
// thread l of a group takes rows 2 (l / (BU / 4)), +1 and units l % (BU / 4)
// + (BU / 4) j (j < 4; of each segment); acc[j] the first row, acc[nj + j]
// the second.
template <class Tl, bool NK, int NG>
__device__ __forceinline__ void compute_chunk(const float* st, float* acc) {
  using L = DirTile<float, Tl>;
  constexpr int nj = 4 * NG;
  constexpr int kGroup = kDirThreads / Tl::KS, kUq = Tl::BU / 4, kK = L::kKC / Tl::KS;
  const float* as = st;
  const float* bs = st + Tl::BM * L::kLdA;
  const int q = threadIdx.x / kGroup, l = threadIdx.x % kGroup;
  const int r0 = 2 * (l / kUq), u0 = l % kUq;
#pragma unroll 4
  for (int kk = q * kK; kk < (q + 1) * kK; ++kk) {
    const float a0 = as[r0 * L::kLdA + kk], a1 = as[(r0 + 1) * L::kLdA + kk];
#pragma unroll
    for (int j = 0; j < nj; ++j) {
      const int u = (j >> 2) * Tl::BU + u0 + kUq * (j & 3);
      const float bv = NK ? bs[u * L::kLdA + kk] : bs[kk * L::kLdB2 + u];
      acc[j] = fmaf(a0, bv, acc[j]);
      acc[nj + j] = fmaf(a1, bv, acc[nj + j]);
    }
  }
}

// The accumulators into C (BM rows of ldc), K share q into copy q; with KS >
// 1 the copies are then added into copy 0 in the order q = 0, 1, ...
template <typename W, class Tl, int NG>
__device__ __forceinline__ void store_acc(const float* acc, float* C, int ldc) {
  if constexpr (sizeof(W) == 2) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const int s = warp % Tl::kSub;
    float* Cq = C + (warp / Tl::kSub) * Tl::BM * ldc;
    const int row = 16 * (s / (Tl::BU / 16)) + gq, nu = 16 * (s % (Tl::BU / 16));
#pragma unroll
    for (int j = 0; j < 2 * NG; ++j) {
      const int col = (j >> 1) * Tl::BU + nu + 8 * (j & 1) + 2 * tq;
      Cq[row * ldc + col] = acc[4 * j];
      Cq[row * ldc + col + 1] = acc[4 * j + 1];
      Cq[(row + 8) * ldc + col] = acc[4 * j + 2];
      Cq[(row + 8) * ldc + col + 1] = acc[4 * j + 3];
    }
  } else {
    constexpr int nj = 4 * NG;
    constexpr int kGroup = kDirThreads / Tl::KS, kUq = Tl::BU / 4;
    const int l = threadIdx.x % kGroup;
    float* Cq = C + (threadIdx.x / kGroup) * Tl::BM * ldc;
    const int r0 = 2 * (l / kUq), u0 = l % kUq;
#pragma unroll
    for (int j = 0; j < nj; ++j) {
      const int col = (j >> 2) * Tl::BU + u0 + kUq * (j & 3);
      Cq[r0 * ldc + col] = acc[j];
      Cq[(r0 + 1) * ldc + col] = acc[nj + j];
    }
  }
  if constexpr (Tl::KS > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < Tl::BM * NG * Tl::BU; e += kDirThreads) {
      const int idx = (e / (NG * Tl::BU)) * ldc + e % (NG * Tl::BU);
      float v = C[idx];
#pragma unroll
      for (int q = 1; q < Tl::KS; ++q) v += C[q * Tl::BM * ldc + idx];
      C[idx] = v;
    }
  }
}

// C = A . B over nchunks chunks of K (see load_chunk), into shared memory
template <typename W, class Tl, bool NK, int NG>
__device__ void block_product(W* stage, const W* A, int lda, const W* Bm, int ldb, int seg,
                              int nchunks, float* C, int ldc) {
  using L = DirTile<W, Tl>;
  constexpr int kStage = L::kStage;
  float acc[8 * NG];
#pragma unroll
  for (int j = 0; j < 8 * NG; ++j) acc[j] = 0.f;
#pragma unroll
  for (int c = 0; c < Tl::S - 1; ++c) {
    if (c < nchunks) load_chunk<W, Tl, NK, NG>(stage + c * kStage, A, lda, Bm, ldb, seg, c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<Tl::S - 2>();
    __syncthreads();  // chunk c is in; every thread is done with chunk c - 1's stage
    const int nxt = c + Tl::S - 1;
    if (nxt < nchunks)
      load_chunk<W, Tl, NK, NG>(stage + (nxt % Tl::S) * kStage, A, lda, Bm, ldb, seg, nxt);
    cp_async_commit();
    compute_chunk<Tl, NK, NG>(stage + (c % Tl::S) * kStage, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free for the next product
  store_acc<W, Tl, NG>(acc, C, ldc);
}

// hpc[t, d, b, k] = hprev (ys[t-1], h0 at t = 0) in the compute dtype, 0 in
// the padding; with hpct also hpct[d, k, t Bp + b] (through the shared tile,
// so that both writes are coalesced) and zeros in dghct's rows past T Bp.
// Block (32, 8) threads over rows r0 .. +32 of the Rp rows, columns k0 .. +32.
template <typename W>
__global__ void gru_hprev_kernel(DirArgs<W> a) {
  __shared__ float tile[32][33];  // the rounded values, exact in f32
  const int r0 = blockIdx.x * 32, k0 = blockIdx.y * 32, d = blockIdx.z;
  const int R = a.T * a.Bp;
  for (int rr = threadIdx.y; rr < 32; rr += 8) {
    const int r = r0 + rr, k = k0 + threadIdx.x;
    const int t = r / a.Bp, b = r % a.Bp;
    float v = 0.f;
    if (r < R && b < a.B && k < a.H)
      v = t > 0 ? a.ys[(((size_t)(t - 1) * a.ND + d) * a.B + b) * a.H + k]
                : a.h0[((size_t)d * a.B + b) * a.H + k];
    const W wv = w2vb::from_f32<W>(v);
    if (r < R) a.hpc[(((size_t)t * a.ND + d) * a.Bp + b) * a.Hp + k] = wv;
    tile[rr][threadIdx.x] = w2vb::to_f32(wv);
  }
  if (a.hpct == nullptr) return;  // the same for every thread of the launch
  __syncthreads();
  for (int kk = threadIdx.y; kk < 32; kk += 8) {
    const int k = k0 + kk, r = r0 + threadIdx.x;
    a.hpct[((size_t)d * a.Hp + k) * a.Rp + r] = w2vb::from_f32<W>(tile[threadIdx.x][kk]);
    if (r >= R)
      for (int gg = 0; gg < 3; ++gg)
        a.dghct[((size_t)d * 3 * a.Hp + gg * a.Hp + k) * a.Rp + r] = w2vb::from_f32<W>(0.f);
  }
}

// gh for every step: block (unit tile, tile of 32 rows of the T x Bp rows, direction)
template <typename W>
__global__ void __launch_bounds__(kDirThreads) gru_gh_kernel(DirArgs<W> a) {
  using L = DirTile<W, Big>;
  constexpr int kLdC = L::kLdC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stage = reinterpret_cast<W*>(smem_raw);
  float* c2 = reinterpret_cast<float*>(smem_raw + (size_t)Big::S * L::kStage * sizeof(W));
  const int i0 = blockIdx.x * Big::BU, d = blockIdx.z;
  const int t = blockIdx.y * Big::BM / a.Bp, b0 = blockIdx.y * Big::BM % a.Bp;  // Bp % 32 == 0
  const int H3p = 3 * a.Hp;
  const W* wd = a.w + (size_t)d * a.Hp * H3p;
  const size_t row0 = ((size_t)t * a.ND + d) * a.Bp + b0;
  block_product<W, Big, false, 3>(stage, a.hpc + row0 * a.Hp, a.Hp, wd + i0, H3p, a.Hp,
                                  a.Hp / L::kKC, c2, kLdC);
  __syncthreads();
  for (int e = threadIdx.x; e < Big::BM * 3 * Big::BU; e += kDirThreads) {
    const int r = e / (3 * Big::BU), col = e % (3 * Big::BU);
    a.gh[(row0 + r) * H3p + (col / Big::BU) * a.Hp + i0 + col % Big::BU] = c2[r * kLdC + col];
  }
}

// The step's operands that do not depend on the carry, per element of a thread
enum StepOperand { kGiR, kGiZ, kGiN, kGhR, kGhZ, kGhN, kBhR, kBhZ, kBhN, kG, kHprev, kDbR, kDbZ, kDbN, kOps };

// Step t (T-1 down to 0), or t = -1: dh0 = dhz + dgh_cd[0] . W^T
template <typename W, class Tl>
__global__ void __launch_bounds__(kDirThreads) gru_bwd_step_kernel(DirArgs<W> a, int t) {
  using L = DirTile<W, Tl>;
  constexpr int kLdC = Tl::BU + 1, kPer = Tl::BM * Tl::BU / kDirThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stage = reinterpret_cast<W*>(smem_raw);
  float* c1 = reinterpret_cast<float*>(smem_raw + (size_t)Tl::S * L::kStage * sizeof(W));
  const int i0 = blockIdx.x * Tl::BU, b0 = blockIdx.y * Tl::BM, d = blockIdx.z;
  const int H = a.H, H3 = 3 * H, Hp = a.Hp, H3p = 3 * Hp;
  const W* wd = a.w + (size_t)d * Hp * H3p;
  const bool first = t == a.T - 1;  // no carry yet
  // Element k of this thread: e = threadIdx.x + k kDirThreads, row e / BU,
  // unit e % BU. Its operands are loaded before the carry product, so that
  // their latency hides behind it.
  float dhz[kPer], op[kPer][kOps];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kDirThreads;
    const int b = b0 + e / Tl::BU, i = i0 + e % Tl::BU;
    dhz[k] = 0.f;
#pragma unroll
    for (int j = 0; j < kOps; ++j) op[k][j] = 0.f;
    if (i >= H || b >= a.B) continue;
    if (!first) dhz[k] = a.dhz[((size_t)d * a.Bp + b) * Hp + i];
    if (t < 0) continue;
    const size_t row = ((size_t)t * a.ND + d) * a.B + b;
    const float* gr = a.gi + row * H3 + i;
    const float* cr = a.gh + (((size_t)t * a.ND + d) * a.Bp + b) * H3p + i;
    const float* bh = a.b_hh + (size_t)d * H3 + i;
    op[k][kGiR] = gr[0];
    op[k][kGiZ] = gr[H];
    op[k][kGiN] = gr[2 * H];
    op[k][kGhR] = cr[0];
    op[k][kGhZ] = cr[Hp];
    op[k][kGhN] = cr[2 * Hp];
    op[k][kBhR] = bh[0];
    op[k][kBhZ] = bh[H];
    op[k][kBhN] = bh[2 * H];
    op[k][kG] = a.g[row * H + i];
    op[k][kHprev] = t > 0 ? a.ys[(row - (size_t)a.ND * a.B) * H + i]
                          : a.h0[((size_t)d * a.B + b) * H + i];
    if (a.dbp && !first) {
      const float* p = a.dbp + ((size_t)d * a.Bp + b) * H3p + i;
      op[k][kDbR] = p[0];
      op[k][kDbZ] = p[Hp];
      op[k][kDbN] = p[2 * Hp];
    }
  }
  if (!first) {  // (a) c1 = dgh_cd[t+1] . W[S, :]^T
    const W* arows = a.dghc + ((size_t)(((t + 1) & 1) * a.ND + d) * a.Bp + b0) * H3p;
    block_product<W, Tl, true, 1>(stage, arows, H3p, wd + (size_t)i0 * H3p, H3p, 0, H3p / L::kKC,
                                  c1, kLdC);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kDirThreads;
    const int r = e / Tl::BU, u = e % Tl::BU;
    const int b = b0 + r, i = i0 + u;
    if (i >= H) continue;
    if (b >= a.B) {  // a padding row: zeros in dgh_cd^T, which dW reads over all Bp rows
      if (t >= 0 && a.dghct)
        for (int gg = 0; gg < 3; ++gg)
          a.dghct[((size_t)d * H3p + gg * Hp + i) * a.Rp + (size_t)t * a.Bp + b] =
              w2vb::from_f32<W>(0.f);
      continue;
    }
    float dh = first ? 0.f : dhz[k] + c1[r * kLdC + u];
    if (t < 0) {
      a.dh0[((size_t)d * a.B + b) * H + i] = dh;
      continue;
    }
    const float* o_ = op[k];
    dh += o_[kG];
    const float gh_n = o_[kGhN] + o_[kBhN];
    const float rg = w2vb::sigmoidf(o_[kGiR] + (o_[kGhR] + o_[kBhR]));
    const float z = w2vb::sigmoidf(o_[kGiZ] + (o_[kGhZ] + o_[kBhZ]));
    const float n = tanhf(o_[kGiN] + rg * gh_n);
    const float dn = dh * (1.f - z);
    const float dzv = dh * (o_[kHprev] - n);
    const float dgn = dn * (1.f - n * n);
    const float dr = dgn * gh_n;
    const float dgz = dzv * z * (1.f - z);
    const float dgr = dr * rg * (1.f - rg);
    const float dghn = dgn * rg;
    const size_t row = ((size_t)t * a.ND + d) * a.B + b;
    float* o = a.dgi + row * H3;
    o[i] = dgr;
    o[H + i] = dgz;
    o[2 * H + i] = dgn;
    if (a.dgh) {
      float* oh = a.dgh + row * H3;
      oh[i] = dgr;
      oh[H + i] = dgz;
      oh[2 * H + i] = dghn;
    }
    const W cgr = w2vb::from_f32<W>(dgr), cgz = w2vb::from_f32<W>(dgz), cgn = w2vb::from_f32<W>(dghn);
    W* dc = a.dghc + ((size_t)((t & 1) * a.ND + d) * a.Bp + b) * H3p;
    dc[i] = cgr;
    dc[Hp + i] = cgz;
    dc[2 * Hp + i] = cgn;
    if (a.dghct) {
      W* dt = a.dghct + ((size_t)d * H3p + i) * a.Rp + (size_t)t * a.Bp + b;
      dt[0] = cgr;
      dt[(size_t)Hp * a.Rp] = cgz;
      dt[(size_t)2 * Hp * a.Rp] = cgn;
    }
    if (a.dbp) {  // db_hh's sum over the steps, per batch row, step by step
      float* p = a.dbp + ((size_t)d * a.Bp + b) * H3p + i;
      p[0] = o_[kDbR] + dgr;
      p[Hp] = o_[kDbZ] + dgz;
      p[2 * Hp] = o_[kDbN] + dghn;
    }
    a.dhz[((size_t)d * a.Bp + b) * Hp + i] = dh * z;
  }
}

// dW_hh[d] = hpct[d] . dghct[d]^T over the Rp rows (a 32 x 96 tile of (Hp,
// 3 Hp) per block), written unpadded as (ND, H, 3H); the blocks of the first
// row tile also sum dbp over the batch rows, in order, into db (ND, 3H).
template <typename W>
__global__ void __launch_bounds__(kDirThreads) gru_dw_kernel(DirArgs<W> a, float* __restrict__ dw,
                                                             float* __restrict__ db) {
  using L = DirTile<W, Big>;
  constexpr int kLdC = L::kLdC, kN = 3 * Big::BU;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stage = reinterpret_cast<W*>(smem_raw);
  float* c = reinterpret_cast<float*>(smem_raw + (size_t)Big::S * L::kStage * sizeof(W));
  const int j0 = blockIdx.x * kN, i0 = blockIdx.y * Big::BM, d = blockIdx.z;
  const int H = a.H, H3 = 3 * H, Hp = a.Hp, H3p = 3 * Hp;
  block_product<W, Big, true, 3>(stage, a.hpct + ((size_t)d * Hp + i0) * a.Rp, a.Rp,
                                 a.dghct + ((size_t)d * H3p + j0) * a.Rp, a.Rp, Big::BU,
                                 a.Rp / L::kKC, c, kLdC);
  __syncthreads();
  for (int e = threadIdx.x; e < Big::BM * kN; e += kDirThreads) {
    const int r = e / kN, col = e % kN;
    const int i = i0 + r, j = j0 + col, gg = j / Hp, u = j % Hp;
    if (i < H && u < H) dw[((size_t)d * H + i) * H3 + gg * H + u] = c[r * kLdC + col];
  }
  if (blockIdx.y != 0) return;
  for (int col = threadIdx.x; col < kN; col += kDirThreads) {
    const int j = j0 + col, gg = j / Hp, u = j % Hp;
    if (u >= H) continue;
    float s = 0.f;
    for (int b = 0; b < a.B; ++b) s += a.dbp[((size_t)d * a.Bp + b) * H3p + j];
    db[(size_t)d * H3 + gg * H + u] = s;
  }
}

template <typename W, class Tl>
int launch_steps(const DirArgs<W>& a, cudaStream_t s) {
  const size_t smem = DirTile<W, Tl>::kSmem;
  cudaError_t e = w2vb::allow_smem(gru_bwd_step_kernel<W, Tl>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.H + Tl::BU - 1) / Tl::BU, a.Bp / Tl::BM, a.ND);
  for (int t = a.T - 1; t >= -1; --t) {
    gru_bwd_step_kernel<W, Tl><<<grid, kDirThreads, smem, s>>>(a, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// The backward of both entries (header note): dgi, dh0 and either dgh (dw
// null: the per-direction entry) or dw and db (the fused entry, which sets
// hpct, dghct and dbp).
template <typename W>
int launch_bwd(const DirArgs<W>& a, float* dw, float* db, cudaStream_t s) {
  using L = DirTile<W, Big>;
  const bool fused = dw != nullptr;
  if (a.Hp % 64 || a.Bp % 32 || a.Rp % 64 || a.Hp < a.H || a.Bp < a.B || a.Rp < a.T * a.Bp ||
      fused != (db && a.hpct && a.dghct && a.dbp) || fused == (a.dgh != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = w2vb::allow_smem(gru_gh_kernel<W>, L::kSmem);
  if (e == cudaSuccess && fused) e = w2vb::allow_smem(gru_dw_kernel<W>, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  gru_hprev_kernel<W><<<dim3(a.Rp / 32, a.Hp / 32, a.ND), dim3(32, 8), 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int units = (a.H + Big::BU - 1) / Big::BU;
  gru_gh_kernel<W><<<dim3(units, a.T * a.Bp / Big::BM, a.ND), kDirThreads, L::kSmem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int code = units * (a.Bp / Big::BM) * a.ND >= kMinStepBlocks ? launch_steps<W, Big>(a, s)
                                                                   : launch_steps<W, Small>(a, s);
  if (code != 0 || !fused) return code;
  gru_dw_kernel<W><<<dim3(a.Hp / Big::BU, a.Hp / Big::BM, a.ND), kDirThreads, L::kSmem, s>>>(a, dw,
                                                                                            db);
  return static_cast<int>(cudaGetLastError());
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
  using L = DirTile<W, Big>;
  constexpr int kLdC = L::kLdC, kU = Big::BU;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stage = reinterpret_cast<W*>(smem_raw);
  float* c = reinterpret_cast<float*>(smem_raw + (size_t)Big::S * L::kStage * sizeof(W));
  const int i0 = blockIdx.x * kU, b0 = blockIdx.y * Big::BM, d = blockIdx.z;
  const int H = a.H, H3 = 3 * H, Hp = a.Hp;
  const W* arows = a.hc + ((size_t)((t & 1) * a.ND + d) * a.Bp + b0) * Hp;
  block_product<W, Big, true, 3>(stage, arows, Hp, a.wt + ((size_t)d * 3 * Hp + i0) * Hp, Hp, Hp,
                                 Hp / L::kKC, c, kLdC);
  __syncthreads();
  W* hn = a.hc + (size_t)(((t + 1) & 1) * a.ND + d) * a.Bp * Hp;
  const float* bh = a.b_hh + (size_t)d * H3;
  for (int e = threadIdx.x; e < Big::BM * kU; e += kDirThreads) {
    const int r = e / kU, u = e % kU;
    const int b = b0 + r, i = i0 + u;
    if (b >= a.B || i >= H) continue;
    const size_t row = ((size_t)t * a.ND + d) * a.B + b;
    const float* gr = a.gi + row * H3;
    const float* cr = c + r * kLdC + u;
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
  using L = DirTile<W, Big>;
  if (a.Hp % 64 || a.Bp % Big::BM || a.Hp < a.H || a.Bp < a.B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = w2vb::allow_smem(gru_dir_fwd_step_kernel<W>, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.H + Big::BU - 1) / Big::BU, a.Bp / Big::BM, a.ND);
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

// Backward of both entries (DirArgs above for the layouts): dgi and dh0, and
// either dgh (the per-direction entry: dw, db, hpct, dghct and dbp null) or
// dw (ND, H, 3H) and db (ND, 3H) (the fused entry: dgh null). w, hpc, hpct,
// dghc and dghct are in the compute dtype (w_bf16); dghc must hold zeros in
// its padding; the other scratch needs no initial values. Hp % 64 == 0, Bp
// % 32 == 0, Rp % 64 == 0, Rp >= T Bp.
extern "C" int w2vb_gru_bwd(const float* gi, const void* w, int w_bf16, const float* b_hh,
                            const float* h0, const float* ys, const float* g, void* hpc, void* hpct,
                            void* dghc, void* dghct, float* dbp, float* dhz, float* gh, float* dgi,
                            float* dgh, float* dw, float* db, float* dh0, int T, int ND, int B,
                            int H, int Bp, int Hp, int Rp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    using W = __nv_bfloat16;
    const DirArgs<W> a{gi, static_cast<const W*>(w), b_hh, h0, ys, g,
                       static_cast<W*>(hpc), static_cast<W*>(hpct), static_cast<W*>(dghc),
                       static_cast<W*>(dghct), dbp, dhz, dgi, dgh, gh, dh0,
                       T, ND, B, H, Bp, Hp, Rp};
    return launch_bwd(a, dw, db, s);
  }
  using W = float;
  const DirArgs<W> a{gi, static_cast<const W*>(w), b_hh, h0, ys, g,
                     static_cast<W*>(hpc), static_cast<W*>(hpct), static_cast<W*>(dghc),
                     static_cast<W*>(dghct), dbp, dhz, dgi, dgh, gh, dh0,
                     T, ND, B, H, Bp, Hp, Rp};
  return launch_bwd(a, dw, db, s);
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
