// Fused multi-head attention, forward and backward, with train-mode hash
// dropout on the probabilities.
//
// Replaces: wav2vec2forbrain_tpu/ops/pallas_attention.py::_call from
// _fwd_impl (the Pallas kernel _fwd_kernel, dropout mask _keep_mask/_mix)
// and from _bwd_impl (_bwd_kernel). On (B, T, H*D) operands, per (batch,
// head):
//   forward:  s = (q_cd . k_cd^T) * scale        (f32 accumulation)
//             p = softmax(s) over the whole row, in f32
//             p = p * mask * (1/keep)             train mode only
//             o = p_cd . v_cd                     (f32 accumulation), stream dtype
//   backward: p recomputed, mask recomputed from the same hash
//             dv = pd_cd^T . g_cd;  dp = (g_cd . v_cd^T) * mask * (1/keep)
//             ds = p * (dp - sum_j dp * p)
//             dq = ds_cd . k_cd * scale;  dk = ds_cd^T . q_cd * scale
// where _cd means rounded to the compute dtype before the product, as the
// JAX kernel's dot_generals do (nothing is rounded at f32 compute). There is
// no padding mask: like the JAX path, every query attends over all T frames,
// pad frames included. The mask is a pure function of (seed, batch row,
// head, q row, k col) (common.cuh attn_keep), so forward and backward, the
// plain PyTorch version and the JAX package all drop the same probabilities.
// The batch row is global, row0 + b: a data-parallel rank passes the index
// of its first row, so its masks are its rows of the whole batch's (the JAX
// kernel's row-id vector, which shards with q). So is the head, head0 + h: a
// tensor-parallel rank holds heads [head0, head0 + NH) of the layer's, and
// its masks are those heads of the whole layer's (the JAX kernel's global
// head ids under a head-partitioned call).
//
// What bounds it on the H100: nothing big. At the slice's shape (B=32,
// T=89, 16 heads of 64) one layer's forward reads and writes 4 x 11.7 MB
// (~14 us at 3.35 TB/s) and does ~1 GFLOP (~1 us on the bf16 tensor cores,
// ~6 us as three TF32 products); the (T, T) scores of one head are 32 KB.
// The cost is latency: the loads of each block's tiles and the blocks in
// flight, and at f32 compute the tensor-core issue of three products.
//
// The products. Every head width the models run (D <= 128) takes
// tensor-core kernels whose bodies are shared by two product policies:
//  - MmaBf16 (bf16 compute): mma.sync.m16n8k16 on bf16 operands, rounded
//    from the stream on their way into shared memory (the JAX `.astype(cd)`),
//    f32 accumulators; tiles of bf16 rows padded to DP + 8 elements.
//  - MmaTf32x3 (f32 compute): mma.sync.m16n8k8 on TF32 operands, each
//    product split in three ("3xTF32", the scheme of CUTLASS's
//    OpMultiplyAddFastF32, which PyTorch's f32 memory-efficient attention
//    runs). An f32 operand x is split as big = tf32(x) and small = tf32(x -
//    big), rounded to nearest as cvt.rna.tf32.f32 rounds (by an integer add
//    and mask: tf32_rna), and a . b is summed in f32 as a_big b_small +
//    a_small b_big + a_big b_big, the small products first. big holds x's
//    leading 11 significant bits and small the next 11, so each product
//    keeps ~22 bits (the dropped a_small b_small is ~2^-22 of it) where one
//    TF32 pass keeps 11, and a product of two TF32 values is exact in f32.
//    That is why this route is f32-class and single-pass TF32 is not. At
//    logits of unit scale it is held to the f32 tolerances of the plain
//    version (2e-5; the CPU test
//    test_split_tf32_attention_holds_the_f32_tolerance emulates the split).
//    At logits 8x larger (scale 1, q not pre-scaled) the f32 rounding of s,
//    amplified by the softmax, is most of any f32 version's error, and two
//    f32 versions can differ by more than 2e-5: there it is held to within
//    twice the plain f32 version's own error of the f64 result (chip_smoke's
//    precision rows; PERF.md).
//    Tiles stay f32 in shared memory, rows of DP + 4 floats: 16-byte rows,
//    and a pitch of 4 banks (mod 32) under which both fragment patterns
//    below are free of bank conflicts. ldmatrix moves 16-bit elements, so
//    the fragments are plain 32-bit shared loads. A tile that only B
//    fragments read (K and V; the streamed q and dO of dk/dv), which all 4
//    warps read, is split once as it is loaded, into a tile of big parts and
//    one of small parts; an A fragment, read by one warp, is split in
//    registers as it is loaded (splitting every fragment in registers was
//    slower: PERF.md).
//    m16n8k8's f32 accumulator has m16n8k16's layout (c0, c1 at row g,
//    columns 2t, 2t + 1; c2, c3 at row g + 8), so frag_col and the mask
//    hash per element carry over. Fed back as the A operand of the next
//    product (P . V, dS . K, Pd^T . dO, dS^T . Q) it would want columns t
//    and t + 4; instead of a shuffle within the quad, that product takes its
//    k order permuted within each 8-key group, k-slot t being key 2t and
//    k-slot t + 4 key 2t + 1, and the B fragments (V, K, dO or Q) are loaded
//    from the same rows. A sum over k does not depend on its order.
// At f32 compute a head wider than 128 takes a SIMT kernel that holds the
// head's K and V in shared memory where they fit (no model has such heads).
//
// Forward: one block of 4 warps per (64 query rows, head, batch row), 1,024
// blocks at the slice's shape; each warp owns 16 rows (at bf16 it keeps
// their Q fragments in registers; at f32 it loads and splits them from
// shared memory, as 64 registers of split fragments would not fit at D =
// 128). Q, K and V are staged in shared memory, head columns zero-padded to
// 64 or 128. A head's key tiles stay resident while the block's shared
// memory stays under 72 KB (T' <= 192 at D <= 64 in bf16, T' <= 32 in f32),
// else they stream through one tile buffer. Two passes over the key tiles,
// as the dq launch below: pass 1 S = Q K^T and the row max and sum
// (RowStats: per thread, then over the 4 threads of a row); pass 2 S again,
// p = exp(s - m) / l, the mask hashed per accumulator element from its
// (row, column), fed straight into A fragments, O += P V. p is normalised
// before the product, as JAX does (at bf16 a one-pass FlashAttention
// rescale would round unnormalised p: another function). S is recomputed in
// pass 2 even where all keys are resident: keeping it in registers would
// cost a shape-dependent count of them.
//
// Backward: two launches on the tensor cores, no atomics, a deterministic
// result.
//  1. dq and the row statistics, over (64 query rows, head, batch row);
//     each warp owns 16 rows and streams key tiles of K and V twice.
//     Pass 1: S = Q K^T and dP = dO V^T in registers; per thread an online
//     max, sum and sum of dp * mask * e over its columns, combined over the
//     4 threads of a row into m, l and D_i = sum_j dp_ij p_ij (dp masked and
//     scaled, p before dropout: not FlashAttention's rowsum(dO o O), since at
//     bf16 O was formed from pd rounded to bf16), written to a (3, B, heads,
//     T) f32 scratch. Pass 2: ds = p * (dp - D_i) from the accumulators,
//     straight into A fragments; dQ += ds_cd . K.
//  2. dk and dv, over (64 keys, head, batch row); each warp owns 16 keys and
//     streams query tiles of q and dO with their statistics: S^T = K Q^T,
//     dP^T = V dO^T, then pd = p * mask / keep and ds as A fragments: dV +=
//     pd_cd^T . dO, dK += ds_cd^T . Q.
// Key (or query) tiles are 64 rows at bf16 and D <= 64, else 32 (at T' = 89
// a 32-row tile computes 96 columns, not 128). A warp whose 16 rows (keys)
// all lie past T computes nothing; it only loads its share of the tiles.
// The mask is hashed per accumulator element from its (row, column) in the
// fragment layout, with common.cuh's attn_keep. The scale is applied after
// the dq and dk products, as in JAX. Columns past T take no part in the
// statistics or the sums; rows past T are never stored.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;  // query rows a warp takes at once in the SIMT forward

// The SIMT forward at f32 compute, for heads wider than 128: one block (4
// warps) per (batch, head) holds the head's K and V (T x D each, f32) in
// shared memory, K rows padded to D + 1 floats so that 32 lanes reading 32
// keys hit 32 banks. Each warp takes four query rows at a time: lanes
// compute the scores of keys lane, lane + 32, ... into a per-warp buffer,
// each row's max and sum are warp shuffles, the mask is hashed in place,
// then lanes own output columns and sum p * V over all keys.
template <typename T>
__global__ void attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, T* __restrict__ o, int Tn, int NH,
                                     int D, float scale, bool drop, uint32_t seed, int row0, int head0,
                                     float keep_prob, float inv_keep) {
  extern __shared__ float sm[];
  const int ldk = D + 1;
  float* ks = sm;                          // [Tn][D + 1]
  float* vs = ks + Tn * ldk;               // [Tn][D]
  float* qs = vs + Tn * D;                 // [kWarps][kRows][D]
  float* ps = qs + kWarps * kRows * D;     // [kWarps][kRows][Tn]
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, row0 + b, head0 + h);

  for (int i = threadIdx.x; i < Tn * D; i += blockDim.x) {
    const int r = i / D;
    const int c = i - r * D;
    const size_t g = base + (size_t)r * HD + c;
    ks[r * ldk + c] = w2vb::to_f32(k[g]);
    vs[r * D + c] = w2vb::to_f32(v[g]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qw = qs + warp * kRows * D;
  float* pw = ps + warp * kRows * Tn;
  for (int r0 = warp * kRows; r0 < Tn; r0 += kWarps * kRows) {
    const int nr = min(kRows, Tn - r0);
    // rows past the ragged end get q = 0 (a harmless uniform softmax) and
    // are never stored
    for (int i = lane; i < kRows * D; i += 32) {
      const int rr = i / D;
      const int c = i - rr * D;
      qw[i] = rr < nr ? w2vb::to_f32(q[base + (size_t)(r0 + rr) * HD + c]) : 0.f;
    }
    __syncwarp();

    float mx[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) mx[rr] = __int_as_float(0xff800000);  // -inf
    for (int c = lane; c < Tn; c += 32) {
      const float* kr = ks + c * ldk;
      float acc[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) acc[rr] = fmaf(qw[rr * D + d], kv, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float s = acc[rr] * scale;
        pw[rr * Tn + c] = s;
        mx[rr] = fmaxf(mx[rr], s);
      }
    }
    float sum[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      mx[rr] = w2vb::warp_max(mx[rr]);
      sum[rr] = 0.f;
    }
    for (int c = lane; c < Tn; c += 32) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float e = expf(pw[rr * Tn + c] - mx[rr]);
        pw[rr * Tn + c] = e;
        sum[rr] += e;
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) sum[rr] = w2vb::warp_sum(sum[rr]);
    for (int c = lane; c < Tn; c += 32) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        float p = pw[rr * Tn + c] / sum[rr];
        if (drop) p = w2vb::attn_keep(mix, r0 + rr, c, keep_prob) ? p * inv_keep : 0.f;
        pw[rr * Tn + c] = p;
      }
    }
    __syncwarp();

    for (int c = lane; c < D; c += 32) {
      float acc[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
      for (int j = 0; j < Tn; ++j) {
        const float vv = vs[j * D + c];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) acc[rr] = fmaf(pw[rr * Tn + j], vv, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        if (rr < nr) o[base + (size_t)(r0 + rr) * HD + c] = w2vb::from_f32<T>(acc[rr]);
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float keep_scale(bool drop, uint32_t mix, int r, int c, float keep_prob,
                                            float inv_keep) {
  return drop ? (w2vb::attn_keep(mix, r, c, keep_prob) ? inv_keep : 0.f) : 1.f;
}

// ---- the tensor-core kernels (header note) ----

constexpr int kMmaRows = 64;     // query rows (forward, dq) or keys (dk/dv) per block: 4 warps x 16
constexpr int kMaxHeadDim = 128;  // the widest head they take (columns padded to 64 or 128)

using w2vb::ld_pair;
using w2vb::mma_bf16;
using w2vb::pack_bf16;

// the split-TF32 helpers, shared with preproc.cu's backward (common.cuh)
using w2vb::mma_tf32;
using w2vb::split_tf32;

// rows [r0, r0 + kRows) of one head into a bf16 tile [kRows][DP + 8],
// rounded to nearest even; rows at or past Tn and columns at or past D are
// zero. Each of the block's threads takes kRows x DP / 8 / 128 chunks of 8
// columns, a count fixed at compile time, and issues all its loads before
// its first store, so a tile costs one round trip to L2 and not one per
// chunk. vec: D % 8 == 0 and 16-byte aligned operands, so a chunk loads as
// one or two 16-byte vectors
template <typename T, int DP, int kRows>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const T* __restrict__ src, size_t base,
                                               int r0, int Tn, int HD, int D, bool vec) {
  constexpr int kChunks = DP / 8, kThreads = kWarps * 32, kPer = kRows * kChunks / kThreads;
  static_assert(kPer * kThreads == kRows * kChunks, "a tile is a whole number of chunks per thread");
  uint4 out[kPer];
  if (vec) {
    constexpr int kW = sizeof(T) == 2 ? 1 : 2;  // 16-byte loads per chunk
    uint4 raw[kPer][kW];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = threadIdx.x + i * kThreads, row = r0 + p / kChunks, c = (p % kChunks) * 8;
      const uint4* g = reinterpret_cast<const uint4*>(src + base + (size_t)row * HD + c);
      const bool ok = row < Tn && c < D;
#pragma unroll
      for (int w = 0; w < kW; ++w) raw[i][w] = ok ? g[w] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if constexpr (sizeof(T) == 2) {
        out[i] = raw[i][0];
      } else {
        const uint4 x = raw[i][0], y = raw[i][kW - 1];
        out[i] = make_uint4(pack_bf16(__uint_as_float(x.x), __uint_as_float(x.y)),
                            pack_bf16(__uint_as_float(x.z), __uint_as_float(x.w)),
                            pack_bf16(__uint_as_float(y.x), __uint_as_float(y.y)),
                            pack_bf16(__uint_as_float(y.z), __uint_as_float(y.w)));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = threadIdx.x + i * kThreads, row = r0 + p / kChunks, c = (p % kChunks) * 8;
      const T* g = src + base + (size_t)row * HD + c;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = row < Tn && c + e < D ? w2vb::to_f32(g[e]) : 0.f;
      out[i] = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                          pack_bf16(f[6], f[7]));
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(dst + (p / kChunks) * (DP + 8) + (p % kChunks) * 8) = out[i];
  }
}

// The same into an f32 tile [kRows][DP + 4], values as they are (a bf16
// stream widened exactly); kSplit: split once here into the TF32 parts of
// each value, big in the tile and small in a second one `plane` floats on
template <typename T, int DP, int kRows, bool kSplit>
__device__ __forceinline__ void load_tile_f32(float* dst, const T* __restrict__ src, size_t base, int r0,
                                              int Tn, int HD, int D, bool vec, int plane) {
  constexpr int kChunks = DP / 8, kThreads = kWarps * 32, kPer = kRows * kChunks / kThreads;
  static_assert(kPer * kThreads == kRows * kChunks, "a tile is a whole number of chunks per thread");
  float f[kPer][8];
  if (vec) {
    constexpr int kW = sizeof(T) == 2 ? 1 : 2;  // 16-byte loads per chunk
    uint4 raw[kPer][kW];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = threadIdx.x + i * kThreads, row = r0 + p / kChunks, c = (p % kChunks) * 8;
      const uint4* g = reinterpret_cast<const uint4*>(src + base + (size_t)row * HD + c);
      const bool ok = row < Tn && c < D;
#pragma unroll
      for (int w = 0; w < kW; ++w) raw[i][w] = ok ? g[w] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(raw[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if constexpr (sizeof(T) == 2) {  // bf16 pairs, the lower element in the low half
          f[i][e] = __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
        } else {
          f[i][e] = __uint_as_float(w[e]);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = threadIdx.x + i * kThreads, row = r0 + p / kChunks, c = (p % kChunks) * 8;
      const T* g = src + base + (size_t)row * HD + c;
#pragma unroll
      for (int e = 0; e < 8; ++e) f[i][e] = row < Tn && c + e < D ? w2vb::to_f32(g[e]) : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = threadIdx.x + i * kThreads;
    uint4* d = reinterpret_cast<uint4*>(dst + (p / kChunks) * (DP + 4) + (p % kChunks) * 8);
    uint32_t big[8], small[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (kSplit) {
        split_tf32(f[i][e], big[e], small[e]);
      } else {
        big[e] = __float_as_uint(f[i][e]);
      }
    }
    d[0] = make_uint4(big[0], big[1], big[2], big[3]);
    d[1] = make_uint4(big[4], big[5], big[6], big[7]);
    if constexpr (kSplit) {
      d = reinterpret_cast<uint4*>(reinterpret_cast<uint32_t*>(d) + plane);
      d[0] = make_uint4(small[0], small[1], small[2], small[3]);
      d[1] = make_uint4(small[4], small[5], small[6], small[7]);
    }
  }
}

// The product of bf16 compute: mma.sync.m16n8k16 on bf16 operands. Fragment
// coordinates: lane = 4 g + t.
struct MmaBf16 {
  using E = __nv_bfloat16;              // the element of a tile in shared memory
  static constexpr int kK = 16;         // the depth of one product
  static constexpr int kPad = 8;        // row pitch DP + 8: 16-byte rows, conflict-free fragments
  static constexpr int kN64 = 64;       // key (query) tile rows at DP 64
  static constexpr int kN128 = 32;      // at DP 128
  static constexpr bool kHoldQ = true;  // the forward keeps its Q fragments in registers
  static constexpr int kBPlanes = 1;    // tiles per B-operand tile (K, V, or the streamed Q, dO)
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };

  template <typename T, int DP, int kRows>
  static __device__ __forceinline__ void load(E* dst, const T* __restrict__ src, size_t base, int r0, int Tn,
                                              int HD, int D, bool vec) {
    load_tile_bf16<T, DP, kRows>(dst, src, base, r0, Tn, HD, D, vec);
  }

  // a tile read by B fragments alone (frag_b, mma_rows)
  template <typename T, int DP, int kRows>
  static __device__ __forceinline__ void load_b(E* dst, const T* __restrict__ src, size_t base, int r0, int Tn,
                                                int HD, int D, bool vec, int) {
    load_tile_bf16<T, DP, kRows>(dst, src, base, r0, Tn, HD, D, vec);
  }

  // rows m0 .. m0 + 15, columns kk .. kk + 15 of a row-major tile
  static __device__ __forceinline__ A frag_a(const E* t, int ld, int m0, int kk) {
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const E* p = t + (m0 + gq) * ld + kk + 2 * tq;
    return {{ld_pair(p), ld_pair(p + 8 * ld), ld_pair(p + 8), ld_pair(p + 8 * ld + 8)}};
  }

  // k = kk .. kk + 15, n = n0 .. n0 + 7 of B = T^T, T a row-major [n][k]
  // tile: the pairs along k are contiguous
  static __device__ __forceinline__ B frag_b(const E* t, int ld, int, int n0, int kk) {
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const E* p = t + (n0 + gq) * ld + kk + 2 * tq;
    return {{ld_pair(p), ld_pair(p + 8)}};
  }

  // the A fragment (16 rows x 16 columns) of a warp's accumulators c of
  // n-tiles 2 i and 2 i + 1, rounded to bf16
  static __device__ __forceinline__ A frag_acc(const float* c) {
    return {{pack_bf16(c[0], c[1]), pack_bf16(c[2], c[3]), pack_bf16(c[4], c[5]), pack_bf16(c[6], c[7])}};
  }

  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) { mma_bf16(c, a.r, b.r); }

  // acc (a warp's 16 x 8 NT outputs) += a . T[k0 .. k0 + 15][0 .. 8 NT], T a
  // row-major [k][n] tile: ldmatrix.trans gathers the pairs along k, two
  // n-tiles at a time
  template <int NT>
  static __device__ __forceinline__ void mma_rows(float* acc, const A& a, const E* t, int ld, int, int k0) {
    const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      const E* p = t + (k0 + (mat & 1) * 8 + r) * ld + 8 * n + (mat >> 1) * 8;
      const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
      B b0, b1;
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(b0.r[0]), "=r"(b0.r[1]), "=r"(b1.r[0]), "=r"(b1.r[1])
                   : "r"(addr));
      mma(acc + 4 * n, a, b0);
      mma(acc + 4 * n + 4, a, b1);
    }
  }
};

// The product of f32 compute: three mma.sync.m16n8k8 TF32 products of split
// operands (header note). A fragment: a0 (g, t), a1 (g + 8, t), a2 (g, t +
// 4), a3 (g + 8, t + 4); B fragment: b0 (k = t, n = g), b1 (k = t + 4, n = g).
struct MmaTf32x3 {
  using E = float;
  static constexpr int kK = 8;
  static constexpr int kPad = 4;  // row pitch DP + 4 floats: 16-byte rows, 4 banks mod 32
  static constexpr int kN64 = 32;
  static constexpr int kN128 = 32;
  static constexpr bool kHoldQ = false;
  static constexpr int kBPlanes = 2;  // B-operand tiles are split once, as they are loaded: big, then small
  struct A {
    uint32_t big[4], small[4];
  };
  struct B {
    uint32_t big[2], small[2];
  };

  template <typename T, int DP, int kRows>
  static __device__ __forceinline__ void load(E* dst, const T* __restrict__ src, size_t base, int r0, int Tn,
                                              int HD, int D, bool vec) {
    load_tile_f32<T, DP, kRows, false>(dst, src, base, r0, Tn, HD, D, vec, 0);
  }

  template <typename T, int DP, int kRows>
  static __device__ __forceinline__ void load_b(E* dst, const T* __restrict__ src, size_t base, int r0, int Tn,
                                                int HD, int D, bool vec, int plane) {
    load_tile_f32<T, DP, kRows, true>(dst, src, base, r0, Tn, HD, D, vec, plane);
  }

  // rows m0 .. m0 + 15, columns kk .. kk + 7 of a row-major tile (banks 4 g + t)
  static __device__ __forceinline__ A frag_a(const E* t, int ld, int m0, int kk) {
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const E* p = t + (m0 + gq) * ld + kk + tq;
    A a;
    split_tf32(p[0], a.big[0], a.small[0]);
    split_tf32(p[8 * ld], a.big[1], a.small[1]);
    split_tf32(p[4], a.big[2], a.small[2]);
    split_tf32(p[8 * ld + 4], a.big[3], a.small[3]);
    return a;
  }

  // k = kk .. kk + 7, n = n0 .. n0 + 7 of B = T^T, T a row-major [n][k]
  // tile split by load_b (small `plane` floats after big)
  static __device__ __forceinline__ B frag_b(const E* t, int ld, int plane, int n0, int kk) {
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(t) + (n0 + gq) * ld + kk + tq;
    return {{p[0], p[4]}, {p[plane], p[plane + 4]}};
  }

  // the A fragment (16 rows x 8 columns) of a warp's accumulators c of one
  // n-tile, in the permuted k order: k-slot t is column 2 t (c0, c2), k-slot
  // t + 4 column 2 t + 1 (c1, c3)
  static __device__ __forceinline__ A frag_acc(const float* c) {
    A a;
    split_tf32(c[0], a.big[0], a.small[0]);
    split_tf32(c[2], a.big[1], a.small[1]);
    split_tf32(c[1], a.big[2], a.small[2]);
    split_tf32(c[3], a.big[3], a.small[3]);
    return a;
  }

  // the small products first, then the big one
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
    mma_tf32(c, a.big, b.small);
    mma_tf32(c, a.small, b.big);
    mma_tf32(c, a.big, b.big);
  }

  // acc (a warp's 16 x 8 NT outputs) += a . T[k0 .. k0 + 7][0 .. 8 NT], T a
  // row-major [k][n] tile split by load_b, k in frag_acc's order: b0 from row
  // k0 + 2 t, b1 from row k0 + 2 t + 1 (banks 8 t + g and 8 t + 4 + g)
  template <int NT>
  static __device__ __forceinline__ void mma_rows(float* acc, const A& a, const E* t, int ld, int plane,
                                                  int k0) {
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(t) + (k0 + 2 * tq) * ld + gq;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma(acc + 4 * n, a, B{{p[8 * n], p[ld + 8 * n]}, {p[plane + 8 * n], p[plane + ld + 8 * n]}});
  }
};

template <typename M, int DP>
struct MmaTile {
  static constexpr int kN = DP <= 64 ? M::kN64 : M::kN128;  // keys (dq) or queries (dk/dv) per streamed tile
  static constexpr int kLd = DP + M::kPad;                   // row pitch in elements
  static constexpr int kPlane = kN * kLd;                    // elements from a B tile's big part to its small
  static constexpr int kBTile = M::kBPlanes * kPlane;        // elements of a B-operand tile
  // the backward's tiles (+ 3 kN f32 statistics for dk/dv)
  static constexpr size_t kSmem = (2 * (size_t)kMmaRows * kLd + 2 * (size_t)kBTile) * sizeof(typename M::E);
};

// Accumulator element i of a warp's 16 x 8 NT fragment: row gq (i & 2 == 0)
// or gq + 8, column 8 (i >> 2) + 2 tq + (i & 1).
__device__ __forceinline__ int frag_col(int i, int tq) { return 8 * (i >> 2) + 2 * tq + (i & 1); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The online softmax statistics of a warp's two fragment rows (gq, gq + 8):
// each thread keeps the max m and the sum l of exp(s - m) over its own
// columns, tile by tile; `combine` then merges the 4 threads of a row (tq).
// A sum kept beside l (the backward's sum of dp * e) is rescaled by the
// factors that `fold_max` and `combine` return.
struct RowStats {
  float m[2], l[2];

  __device__ __forceinline__ RowStats() {
    m[0] = m[1] = __int_as_float(0xff800000);  // -inf
    l[0] = l[1] = 0.f;
  }

  // the tile's max over its valid columns (j0 + column < Tn) into m;
  // f[rr]: the factor l[rr] was multiplied by
  template <int N>
  __device__ __forceinline__ void fold_max(const float (&s)[N], int j0, int Tn, int tq, float (&f)[2]) {
    float tm[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (j0 + frag_col(i, tq) < Tn) tm[(i >> 1) & 1] = fmaxf(tm[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      f[rr] = 1.f;
      if (tm[rr] > m[rr]) {
        f[rr] = expf(m[rr] - tm[rr]);
        l[rr] *= f[rr];
        m[rr] = tm[rr];
      }
    }
  }

  // e = exp(s - m) of a valid element of row rr, added to l
  __device__ __forceinline__ float add(int rr, float s) {
    const float e = expf(s - m[rr]);
    l[rr] += e;
    return e;
  }

  // m and l of the whole row, the same in the row's 4 threads; f[rr]: the
  // factor for this thread's sums before they are added over the 4
  __device__ __forceinline__ void combine(float (&f)[2]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float mx = quad_max(m[rr]);
      f[rr] = l[rr] > 0.f ? expf(m[rr] - mx) : 0.f;  // a thread that saw no key has l = 0
      l[rr] = quad_sum(l[rr] * f[rr]);
      m[rr] = mx;
    }
  }
};

// The forward: block (64 query rows, head, batch row), warp w owns rows 16 w
// .. +16. Key tiles of kN are either all resident in shared memory (n_res
// tiles, loaded once, where they fit) or streamed through one tile buffer,
// twice. Pass 1: S = Q K^T, the row statistics m, l. Pass 2: S again, p =
// exp(s - m) / l masked and scaled, straight into A fragments (rounded at
// bf16), O += P V. p is normalised before the product, as JAX and
// mha_dense_bth do.
template <typename M, typename T, int DP>
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             T* __restrict__ o, int Tn, int NH, int D, float scale, bool drop, uint32_t seed,
                             int row0, int head0, float keep_prob, float inv_keep, bool vec, int n_res) {
  using L = MmaTile<M, DP>;
  using E = typename M::E;
  using A = typename M::A;
  constexpr int kN = L::kN, kLd = L::kLd, kNT = kN / 8, kPlane = L::kPlane, kBTile = L::kBTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* qs = reinterpret_cast<E*>(smem_raw);                 // [64][kLd]
  E* ks = qs + kMmaRows * kLd;                            // [n_res or 1] B tiles of kN keys
  E* vs = ks + (n_res > 0 ? n_res : 1) * kBTile;          // the same for V
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, row0 + b, head0 + h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * warp;
  const int rows[2] = {q0 + m0 + gq, q0 + m0 + gq + 8};
  const bool active = q0 + m0 < Tn;  // the warp has a row to compute
  const int n_tiles = (Tn + kN - 1) / kN;
  const bool resident = n_res > 0;
  M::template load<T, DP, kMmaRows>(qs, q, base, q0, Tn, HD, D, vec);
  if (resident) {
    for (int t = 0; t < n_tiles; ++t) {
      M::template load_b<T, DP, kN>(ks + t * kBTile, k, base, t * kN, Tn, HD, D, vec, kPlane);
      M::template load_b<T, DP, kN>(vs + t * kBTile, v, base, t * kN, Tn, HD, D, vec, kPlane);
    }
  }
  __syncthreads();
  A qa[M::kHoldQ ? DP / M::kK : 1];
  if constexpr (M::kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < DP / M::kK; ++kk) qa[kk] = M::frag_a(qs, kLd, m0, M::kK * kk);
  }

  // the tile's K (and V) in shared memory: resident, or loaded now
  auto stage = [&](int t, bool with_v) -> int {
    if (resident) return t * kBTile;
    __syncthreads();  // the previous tile is done with
    M::template load_b<T, DP, kN>(ks, k, base, t * kN, Tn, HD, D, vec, kPlane);
    if (with_v) M::template load_b<T, DP, kN>(vs, v, base, t * kN, Tn, HD, D, vec, kPlane);
    __syncthreads();
    return 0;
  };
  float s[4 * kNT];
  auto scores = [&](const E* kt) {
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / M::kK; ++kk) {
      A a;
      if constexpr (M::kHoldQ) {
        a = qa[kk];
      } else {
        a = M::frag_a(qs, kLd, m0, M::kK * kk);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) M::mma(s + 4 * j, a, M::frag_b(kt, kLd, kPlane, 8 * j, M::kK * kk));
    }
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] *= scale;
  };

  RowStats rs;
  for (int t = 0; t < n_tiles; ++t) {
    const int off = stage(t, false);
    if (!active) continue;
    scores(ks + off);
    float f[2];
    rs.fold_max(s, t * kN, Tn, tq, f);
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i)
      if (t * kN + frag_col(i, tq) < Tn) rs.add((i >> 1) & 1, s[i]);
  }
  float f[2];
  rs.combine(f);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int off = stage(t, true);
    if (!active) continue;
    scores(ks + off);
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      const int col = t * kN + frag_col(i, tq), rr = (i >> 1) & 1;
      const float p = expf(s[i] - rs.m[rr]) / rs.l[rr];
      s[i] = col < Tn ? p * keep_scale(drop, mix, rows[rr], col, keep_prob, inv_keep) : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kN; kk += M::kK)
      M::template mma_rows<DP / 8>(acc, M::frag_acc(s + kk / 2), vs + off, kLd, kPlane, kk);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int row = rows[(i >> 1) & 1], col = frag_col(i, tq);
    if (row >= Tn || col >= D) continue;
    T* dst = o + base + (size_t)row * HD + col;
    if (vec) {  // col even, D % 8 == 0: the pair is whole and aligned
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[i], acc[i + 1]);
      }
    } else {
      dst[0] = w2vb::from_f32<T>(acc[i]);
      if (col + 1 < D) dst[1] = w2vb::from_f32<T>(acc[i + 1]);
    }
  }
}

// dq and the row statistics: block (64 query rows, head, batch row); warp w
// owns rows 16 w .. +16 (accumulator elements as frag_col).
template <typename M, typename T, int DP>
__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ stats,
                                int Tn, int NH, int D, float scale, bool drop, uint32_t seed, int row0,
                                int head0, float keep_prob, float inv_keep, bool vec) {
  using L = MmaTile<M, DP>;
  using E = typename M::E;
  using A = typename M::A;
  constexpr int kN = L::kN, kLd = L::kLd, kNT = kN / 8, kPlane = L::kPlane;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* qs = reinterpret_cast<E*>(smem_raw);  // [64][kLd]
  E* gs = qs + kMmaRows * kLd;             // [64][kLd]
  E* ks = gs + kMmaRows * kLd;             // a B tile of kN keys
  E* vs = ks + L::kBTile;                  // the same for V
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, row0 + b, head0 + h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * warp;
  const int rows[2] = {q0 + m0 + gq, q0 + m0 + gq + 8};
  const bool active = q0 + m0 < Tn;  // the warp has a row to compute
  M::template load<T, DP, kMmaRows>(qs, q, base, q0, Tn, HD, D, vec);
  M::template load<T, DP, kMmaRows>(gs, g, base, q0, Tn, HD, D, vec);

  // s (scaled) = q . k^T and dp = g . v^T of the warp's rows against the staged keys
  float s[4 * kNT], dp[4 * kNT];
  auto scores = [&]() {
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += M::kK) {
      const A aq = M::frag_a(qs, kLd, m0, kk);
      const A ag = M::frag_a(gs, kLd, m0, kk);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        M::mma(s + 4 * j, aq, M::frag_b(ks, kLd, kPlane, 8 * j, kk));
        M::mma(dp + 4 * j, ag, M::frag_b(vs, kLd, kPlane, 8 * j, kk));
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] *= scale;
  };
  auto load_keys = [&](int j0) {
    __syncthreads();  // the previous tile is done with
    M::template load_b<T, DP, kN>(ks, k, base, j0, Tn, HD, D, vec, kPlane);
    M::template load_b<T, DP, kN>(vs, v, base, j0, Tn, HD, D, vec, kPlane);
    __syncthreads();
  };

  // pass 1: per thread, online max, sum and sum of dp * mask * e over its
  // columns; then the 4 threads of a row (tq) combine
  RowStats rs;
  float dn[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < Tn; j0 += kN) {
    load_keys(j0);
    if (!active) continue;
    scores();
    float f[2];
    rs.fold_max(s, j0, Tn, tq, f);
    dn[0] *= f[0];
    dn[1] *= f[1];
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      const int col = j0 + frag_col(i, tq), rr = (i >> 1) & 1;
      if (col < Tn) {
        const float e = rs.add(rr, s[i]);
        dn[rr] = fmaf(dp[i] * keep_scale(drop, mix, rows[rr], col, keep_prob, inv_keep), e, dn[rr]);
      }
    }
  }
  float f[2];
  rs.combine(f);
  const float* m = rs.m;
  const float* l = rs.l;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) dn[rr] = quad_sum(dn[rr] * f[rr]) / l[rr];
  if (tq == 0) {
    const size_t nrow = (size_t)gridDim.z * NH * Tn;
    float* st = stats + ((size_t)b * NH + h) * Tn;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (rows[rr] < Tn) {
        st[rows[rr]] = m[rr];
        st[nrow + rows[rr]] = l[rr];
        st[2 * nrow + rows[rr]] = dn[rr];
      }
    }
  }

  // pass 2: ds = p * (dp - D_i) straight from the accumulators into A
  // fragments (rounded at bf16); dq += ds_cd . k_cd
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < Tn; j0 += kN) {
    load_keys(j0);
    if (!active) continue;
    scores();
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      const int col = j0 + frag_col(i, tq), rr = (i >> 1) & 1;
      const float p = expf(s[i] - m[rr]) / l[rr];
      const float dpm = dp[i] * keep_scale(drop, mix, rows[rr], col, keep_prob, inv_keep);
      s[i] = col < Tn ? p * (dpm - dn[rr]) : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kN; kk += M::kK)
      M::template mma_rows<DP / 8>(acc, M::frag_acc(s + kk / 2), ks, kLd, kPlane, kk);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int row = rows[(i >> 1) & 1], col = frag_col(i, tq);
    if (row < Tn && col < D) dq[base + (size_t)row * HD + col] = w2vb::from_f32<T>(acc[i] * scale);
  }
}

// dk and dv: block (64 keys, head, batch row); warp w owns keys 16 w .. +16
// and streams query tiles with their statistics: s^T = k . q^T, dp^T = v .
// g^T, then pd and ds as A fragments: dv += pd^T . g, dk += ds^T . q
template <typename M, typename T, int DP>
__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                  const T* __restrict__ g, const float* __restrict__ stats,
                                  T* __restrict__ dk, T* __restrict__ dv, int Tn, int NH, int D, float scale,
                                  bool drop, uint32_t seed, int row0, int head0, float keep_prob,
                                  float inv_keep, bool vec) {
  using L = MmaTile<M, DP>;
  using E = typename M::E;
  using A = typename M::A;
  constexpr int kN = L::kN, kLd = L::kLd, kNT = kN / 8, kPlane = L::kPlane;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ks = reinterpret_cast<E*>(smem_raw);                // [64][kLd]
  E* vs = ks + kMmaRows * kLd;                           // [64][kLd]
  E* qs = vs + kMmaRows * kLd;                           // a B tile of kN queries
  E* gs = qs + L::kBTile;                                // the same for dO
  float* st = reinterpret_cast<float*>(gs + L::kBTile);  // [3][kN] m, l, D of the staged rows
  const int k0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int HD = NH * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const uint32_t mix = w2vb::attn_mix(seed, row0 + b, head0 + h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * warp;
  const int keys[2] = {k0 + m0 + gq, k0 + m0 + gq + 8};
  const bool active = k0 + m0 < Tn;  // the warp has a key to compute
  const size_t nrow = (size_t)gridDim.z * NH * Tn;
  const float* sb = stats + ((size_t)b * NH + h) * Tn;
  M::template load<T, DP, kMmaRows>(ks, k, base, k0, Tn, HD, D, vec);
  M::template load<T, DP, kMmaRows>(vs, v, base, k0, Tn, HD, D, vec);

  float ak[DP / 2], av[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) ak[i] = av[i] = 0.f;
  for (int i0 = 0; i0 < Tn; i0 += kN) {
    __syncthreads();  // the previous tile is done with
    M::template load_b<T, DP, kN>(qs, q, base, i0, Tn, HD, D, vec, kPlane);
    M::template load_b<T, DP, kN>(gs, g, base, i0, Tn, HD, D, vec, kPlane);
    for (int i = threadIdx.x; i < kN; i += blockDim.x) {
      const bool in = i0 + i < Tn;
      st[i] = in ? sb[i0 + i] : 0.f;
      st[kN + i] = in ? sb[nrow + i0 + i] : 1.f;
      st[2 * kN + i] = in ? sb[2 * nrow + i0 + i] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    float s[4 * kNT], dp[4 * kNT];
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += M::kK) {
      const A ak_ = M::frag_a(ks, kLd, m0, kk);
      const A av_ = M::frag_a(vs, kLd, m0, kk);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        M::mma(s + 4 * j, ak_, M::frag_b(qs, kLd, kPlane, 8 * j, kk));
        M::mma(dp + 4 * j, av_, M::frag_b(gs, kLd, kPlane, 8 * j, kk));
      }
    }
    // element i: key keys[(i >> 1) & 1], query i0 + 8 (i >> 2) + 2 tq + (i & 1)
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      const int qq = frag_col(i, tq), qi = i0 + qq;
      float pd = 0.f, ds = 0.f;
      if (qi < Tn) {
        const float p = expf(s[i] * scale - st[qq]) / st[kN + qq];
        const float mk = keep_scale(drop, mix, qi, keys[(i >> 1) & 1], keep_prob, inv_keep);
        pd = p * mk;
        ds = p * (dp[i] * mk - st[2 * kN + qq]);
      }
      s[i] = pd;
      dp[i] = ds;
    }
#pragma unroll
    for (int kk = 0; kk < kN; kk += M::kK) {
      M::template mma_rows<DP / 8>(av, M::frag_acc(s + kk / 2), gs, kLd, kPlane, kk);
      M::template mma_rows<DP / 8>(ak, M::frag_acc(dp + kk / 2), qs, kLd, kPlane, kk);
    }
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int key = keys[(i >> 1) & 1], col = frag_col(i, tq);
    if (key < Tn && col < D) {
      dk[base + (size_t)key * HD + col] = w2vb::from_f32<T>(ak[i] * scale);
      dv[base + (size_t)key * HD + col] = w2vb::from_f32<T>(av[i]);
    }
  }
}

template <typename M, typename T, int DP>
int launch_bwd_mma(const T* q, const T* k, const T* v, const T* g, T* dq, T* dk, T* dv, float* stats, int B,
                   int Tn, int NH, int D, float scale, uint32_t seed, int row0, int head0, float keep_prob,
                   float inv_keep, cudaStream_t s) {
  using L = MmaTile<M, DP>;
  const bool drop = keep_prob < 1.f;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g);
  const bool vec = D % 8 == 0 && addr % 16 == 0;
  const size_t smem_kv = L::kSmem + 3 * L::kN * sizeof(float);
  cudaError_t e = w2vb::allow_smem(attention_bwd_dq_mma_kernel<M, T, DP>, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = w2vb::allow_smem(attention_bwd_dkdv_mma_kernel<M, T, DP>, smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Tn + kMmaRows - 1) / kMmaRows, NH, B);
  attention_bwd_dq_mma_kernel<M, T, DP><<<grid, kWarps * 32, L::kSmem, s>>>(
      q, k, v, g, dq, stats, Tn, NH, D, scale, drop, seed, row0, head0, keep_prob, inv_keep, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_dkdv_mma_kernel<M, T, DP><<<grid, kWarps * 32, smem_kv, s>>>(
      q, k, v, g, stats, dk, dv, Tn, NH, D, scale, drop, seed, row0, head0, keep_prob, inv_keep, vec);
  return static_cast<int>(cudaGetLastError());
}

// a head's K and V tiles stay resident in the tensor-core forward while its
// block's shared memory stays under this (three blocks an SM): T' <= 192 at
// D <= 64, T' <= 96 at D <= 128 in bf16; T' <= 32 at D <= 64 in f32 (its key
// tiles are split in two); longer rows stream one tile at a time
constexpr size_t kResidentSmem = 72 * 1024;

template <typename M, typename T, int DP>
int launch_fwd_mma(const T* q, const T* k, const T* v, T* o, int B, int Tn, int NH, int D, float scale,
                   uint32_t seed, int row0, int head0, float keep_prob, float inv_keep, cudaStream_t s) {
  using L = MmaTile<M, DP>;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const bool vec = D % 8 == 0 && addr % 16 == 0;
  const int n_tiles = (Tn + L::kN - 1) / L::kN;
  const size_t q_bytes = (size_t)kMmaRows * L::kLd * sizeof(typename M::E);
  const size_t tile_bytes = (size_t)L::kBTile * sizeof(typename M::E);
  const int n_res = q_bytes + 2 * n_tiles * tile_bytes <= kResidentSmem ? n_tiles : 0;
  const size_t smem = q_bytes + 2 * (n_res > 0 ? n_res : 1) * tile_bytes;
  cudaError_t e = w2vb::allow_smem(attention_fwd_mma_kernel<M, T, DP>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_fwd_mma_kernel<M, T, DP><<<dim3((Tn + kMmaRows - 1) / kMmaRows, NH, B), kWarps * 32, smem, s>>>(
      q, k, v, o, Tn, NH, D, scale, keep_prob < 1.f, seed, row0, head0, keep_prob, inv_keep, vec, n_res);
  return static_cast<int>(cudaGetLastError());
}

// D <= 128: the tensor-core kernel of the compute dtype's product (bf16, or
// split TF32 at f32 compute), head columns padded to 64 or 128. simt, at f32
// compute: the SIMT kernel that holds a head's K and V in shared memory
// (heads wider than 128; the wrapper checks that they fit)
template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B, int Tn, int NH, int D,
               float scale, bool cd_bf16, bool simt, uint32_t seed, int row0, int head0, float keep_prob,
               float inv_keep, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (simt && !cd_bf16) {
    const size_t smem =
        ((size_t)Tn * (2 * D + 1) + (size_t)kWarps * kRows * (D + Tn)) * sizeof(float);
    cudaError_t e = w2vb::allow_smem(attention_fwd_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attention_fwd_kernel<T><<<dim3(NH, B), kWarps * 32, smem, s>>>(qt, kt, vt, ot, Tn, NH, D, scale,
                                                                   keep_prob < 1.f, seed, row0, head0,
                                                                   keep_prob, inv_keep);
    return static_cast<int>(cudaGetLastError());
  }
  if (simt || D > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  if (cd_bf16) {
    if (D <= 64)
      return launch_fwd_mma<MmaBf16, T, 64>(qt, kt, vt, ot, B, Tn, NH, D, scale, seed, row0, head0, keep_prob,
                                            inv_keep, s);
    return launch_fwd_mma<MmaBf16, T, 128>(qt, kt, vt, ot, B, Tn, NH, D, scale, seed, row0, head0, keep_prob,
                                           inv_keep, s);
  }
  if (D <= 64)
    return launch_fwd_mma<MmaTf32x3, T, 64>(qt, kt, vt, ot, B, Tn, NH, D, scale, seed, row0, head0, keep_prob,
                                            inv_keep, s);
  return launch_fwd_mma<MmaTf32x3, T, 128>(qt, kt, vt, ot, B, Tn, NH, D, scale, seed, row0, head0, keep_prob,
                                           inv_keep, s);
}

// the tensor-core kernels of the compute dtype's product (D <= 128)
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, float* stats, int B, int Tn, int NH, int D, float scale, bool cd_bf16,
               uint32_t seed, int row0, int head0, float keep_prob, float inv_keep, cudaStream_t s) {
  if (D > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* gt = static_cast<const T*>(g);
  auto* dqt = static_cast<T*>(dq);
  auto* dkt = static_cast<T*>(dk);
  auto* dvt = static_cast<T*>(dv);
  if (cd_bf16) {
    if (D <= 64)
      return launch_bwd_mma<MmaBf16, T, 64>(qt, kt, vt, gt, dqt, dkt, dvt, stats, B, Tn, NH, D, scale, seed,
                                            row0, head0, keep_prob, inv_keep, s);
    return launch_bwd_mma<MmaBf16, T, 128>(qt, kt, vt, gt, dqt, dkt, dvt, stats, B, Tn, NH, D, scale, seed,
                                           row0, head0, keep_prob, inv_keep, s);
  }
  if (D <= 64)
    return launch_bwd_mma<MmaTf32x3, T, 64>(qt, kt, vt, gt, dqt, dkt, dvt, stats, B, Tn, NH, D, scale, seed,
                                            row0, head0, keep_prob, inv_keep, s);
  return launch_bwd_mma<MmaTf32x3, T, 128>(qt, kt, vt, gt, dqt, dkt, dvt, stats, B, Tn, NH, D, scale, seed,
                                           row0, head0, keep_prob, inv_keep, s);
}

}  // namespace

// io_bf16: q/k/v/o are bf16 (the activation stream dtype) rather than f32;
// cd_bf16: the compute dtype is bf16 (else f32: the split-TF32 kernels).
// keep_prob < 1 turns the dropout on (keep_prob and inv_keep = 1/keep_prob
// as f32, seed the site's int32, row0 the global batch index of row 0: a
// data-parallel rank's first row, whose mask rows are the whole batch's;
// head0 the global index of head 0: a tensor-parallel rank's first head).
// simt, at f32 compute: the SIMT kernel instead, for heads wider than 128.
extern "C" int w2vb_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                  int io_bf16, int cd_bf16, int simt, int B, int T, int NH,
                                  int D, float scale, int seed, int row0, int head0, float keep_prob,
                                  float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  if (io_bf16)
    return launch_fwd<__nv_bfloat16>(q, k, v, o, B, T, NH, D, scale, cd_bf16 != 0, simt != 0, sd,
                                     row0, head0, keep_prob, inv_keep, s);
  return launch_fwd<float>(q, k, v, o, B, T, NH, D, scale, cd_bf16 != 0, simt != 0, sd, row0, head0,
                           keep_prob, inv_keep, s);
}

// g, dq, dk, dv share q's dtype (io_bf16); stats is a (3, B, NH, T) f32
// scratch (the softmax max, sum and D_i of every query row).
extern "C" int w2vb_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                  void* dq, void* dk, void* dv, float* stats, int io_bf16,
                                  int cd_bf16, int B, int T, int NH, int D, float scale, int seed,
                                  int row0, int head0, float keep_prob, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  if (io_bf16)
    return launch_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, stats, B, T, NH, D, scale,
                                     cd_bf16 != 0, sd, row0, head0, keep_prob, inv_keep, s);
  return launch_bwd<float>(q, k, v, g, dq, dk, dv, stats, B, T, NH, D, scale, cd_bf16 != 0, sd,
                           row0, head0, keep_prob, inv_keep, s);
}
