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
// 6 MiB). No block can hold it (227 KB of shared memory), so every step is
// spread over many blocks: the step kernels read their slices from the 50
// MB L2, where W_hh of both directions stays resident, and L2 latency and
// the launch gap bound a step; the fused forward's cluster holds its slices
// in shared memory for all steps, and the cluster barrier bounds a step.
//
// Fused forward (gru_fwd_cluster_kernel): one launch for all T steps. A
// thread-block cluster of cn = 8 CTAs (else 4) serves one direction and 16
// batch rows (the mma row tile); CTA q owns hidden units q U .. q U + U - 1
// (U = H / cn, padded to Up, a multiple of 8) of all three gates. Its slice
// of W_hh (H x 3 Up in the compute dtype: 48 KiB at H = 256, bf16) is loaded
// once into shared memory and stays there, so no step reads W_hh from L2.
// Each CTA keeps the group's whole h_cd (16 x H) in a ping-pong pair of
// buffers, and each thread the f32 carry, gi and b_hh of its own 4 elements
// in registers (gi of step t+1 loaded while the cluster waits at the end of
// step t). Step t: c = h_cd[t-1] . W slice (bf16: mma.sync.m16n8k16, f32
// accumulators; f32: SIMT f32 FMAs, no TF32, K split over 4 thread groups
// whose partials group 0 adds in order); the gates with b_hh added after the
// product; ys[t]; the new h_cd
// of the CTA's units stored into the other buffer of every CTA of the
// cluster through distributed shared memory; one cluster barrier (arrive
// with release, wait with acquire: with the ping-pong pair one barrier a step
// is enough). No atomics: the result is the same from run to run. A width
// takes it where the CTA's shared memory fits (cluster_smem; ops/gru.py::
// _fwd_route): bf16 H <= 480, f32 H <= 320; wider layers of the fused entry
// take the per-direction step kernel below, which computes the same numbers.
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
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

// ---- fused forward: one cluster-resident launch (header note above) ----

constexpr int kClusterRows = 16;     // batch rows of a cluster: the mma row tile
constexpr int kClusterMaxCtas = 8;   // the widest portable cluster
constexpr int kF32KSplit = 4;        // f32: thread groups that each take a quarter of K

template <typename W>
__host__ __device__ constexpr int k_split() { return sizeof(W) == 2 ? 1 : kF32KSplit; }
// threads of a CTA: 4 Up (bf16, Up <= 64), 4 x 4 Up (f32, Up <= 40)
template <typename W>
__host__ __device__ constexpr int cluster_max_threads() { return sizeof(W) == 2 ? 256 : 640; }

__host__ __device__ constexpr int round_up8(int n) { return (n + 7) / 8 * 8; }

// The row pitch (elements) of the bf16 tiles: 16 bytes of padding keep the
// mma fragments' 32-bit loads free of bank conflicts.
__host__ __device__ constexpr int cluster_pitch(int H) { return H + 8; }

// Shared memory of one CTA: its W_hh slice and the ping-pong pair of h_cd.
// bf16: W^T slice [3 Up][H + 8] + h [2][16][H + 8]; f32: W slice [H][3 Up]
// + h^T [2][H][16] + the partial products of K groups 1-3, [3][12][4 Up].
// ops/gru.py::_cluster_smem mirrors it.
template <typename W>
__host__ __device__ constexpr size_t cluster_smem(int H, int Up) {
  return sizeof(W) == 2 ? (size_t)(3 * Up + 2 * kClusterRows) * cluster_pitch(H) * sizeof(W)
                        : (size_t)(3 * Up + 2 * kClusterRows) * H * sizeof(W) +
                              (size_t)(kF32KSplit - 1) * 12 * 4 * Up * sizeof(float);
}

template <typename W>
struct ClusterArgs {
  const float* gi;    // (T, ND, B, 3H)
  const W* w;         // (ND, H, 3H): W_hh in the compute dtype
  const float* b_hh;  // (ND, 3H)
  const float* h0;    // (ND, B, H)
  float* ys;          // (T, ND, B, H)
  int T, ND, B, H, U, Up;  // U = H / cluster size units per CTA, Up = U rounded up to 8
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the shared::cluster address of p (a shared address of this CTA) in CTA rank q
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int q) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(q));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}

// Block (rank in the cluster, batch group, direction): 4 Up threads (f32: 4
// groups of them, group q summing K quarter q; group 0 adds the others'
// partials in order and goes on alone). Each thread of group 0 owns 4
// elements, rows r0 and r1 x units u0 and u0 + 1 of the CTA's slice (element
// e = 2 * row index + unit index), and keeps their f32 carry, gi and b_hh in
// registers. bf16: warp w takes the mma n-tiles of units 8w .. 8w+7 in each
// gate (r0 = g, r1 = g + 8, u0 = 8w + 2t: the accumulator layout of
// m16n8k16); f32: thread (rho, p) takes rows 2 rho, 2 rho + 1 and units 2p,
// 2p + 1.
template <typename W>
__global__ void __launch_bounds__(cluster_max_threads<W>()) gru_fwd_cluster_kernel(ClusterArgs<W> a) {
  constexpr bool bf = sizeof(W) == 2;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cn = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int d = blockIdx.z, b0 = blockIdx.y * kClusterRows;
  const int H = a.H, H3 = 3 * H, U = a.U, Up = a.Up, ld = cluster_pitch(H);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* ws = reinterpret_cast<W*>(smem_raw);
  W* hs = ws + (bf ? 3 * Up * ld : H * 3 * Up);
  const int hbuf = kClusterRows * (bf ? ld : H);  // elements of one h buffer
  float* part = reinterpret_cast<float*>(hs + 2 * hbuf);  // f32: [3][12][4 Up]
  const int nt = 4 * Up, kq = threadIdx.x / nt, lt = threadIdx.x - kq * nt;
  const bool owner = kq == 0;  // the group that applies the gates

  // the CTA's W_hh slice (columns g H + rank U + u of every gate g), zeros
  // past U; bf16 transposed (n-major, K contiguous) for the B fragments
  const W* wd = a.w + (size_t)d * H * H3 + rank * U;
  for (int i = threadIdx.x; i < H * 3 * Up; i += blockDim.x) {
    const int k = i / (3 * Up), n = i % (3 * Up), g = n / Up, u = n % Up;
    const W v = u < U ? wd[(size_t)k * H3 + g * H + u] : w2vb::from_f32<W>(0.f);
    ws[bf ? n * ld + k : k * 3 * Up + n] = v;
  }
  // h_cd of the whole group from h0 into buffer 0 (zeros in the rows past B)
  for (int i = threadIdx.x; i < kClusterRows * H; i += blockDim.x) {
    const int row = i / H, k = i % H, b = b0 + row;
    const float v = b < a.B ? a.h0[((size_t)d * a.B + b) * H + k] : 0.f;
    hs[bf ? row * ld + k : k * kClusterRows + row] = w2vb::from_f32<W>(v);
  }

  int r0, r1, u0;
  if constexpr (bf) {
    const int warp = lt >> 5, lane = lt & 31;
    r0 = lane >> 2;
    r1 = r0 + 8;
    u0 = 8 * warp + 2 * (lane & 3);
  } else {
    const int rho = lt / (Up / 2);
    r0 = 2 * rho;
    r1 = r0 + 1;
    u0 = 2 * (lt % (Up / 2));
  }
  const bool live = owner && u0 < U;  // U is a multiple of 4: u0 + 1 < U too
  const int gu = rank * U + u0;  // the global unit of u0
  const int rows[2] = {r0, r1};
  float hc[4], bias[3][2], gcur[3][4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int ui = 0; ui < 2; ++ui) bias[g][ui] = live ? a.b_hh[(size_t)d * H3 + g * H + gu + ui] : 0.f;
  auto load_gi = [&](int t, float (&dst)[3][4]) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int b = b0 + rows[ri];
      const bool ok = live && b < a.B;
      const float* p = a.gi + (((size_t)t * a.ND + d) * a.B + (ok ? b : 0)) * H3 + gu;
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int ui = 0; ui < 2; ++ui) dst[g][2 * ri + ui] = ok ? p[g * H + ui] : 0.f;
    }
  };
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int b = b0 + rows[ri];
#pragma unroll
    for (int ui = 0; ui < 2; ++ui)
      hc[2 * ri + ui] = live && b < a.B ? a.h0[((size_t)d * a.B + b) * H + gu + ui] : 0.f;
  }
  load_gi(0, gcur);
  // h_cd of step t goes into buffer (t + 1) & 1 of every CTA of the cluster
  uint32_t remote[kClusterMaxCtas];
#pragma unroll
  for (int q = 0; q < kClusterMaxCtas; ++q) remote[q] = cluster_addr(hs, q < cn ? q : 0);
  cluster.sync();  // every CTA has started and holds its slice and h0

  for (int t = 0; t < a.T; ++t) {
    if (t > 0) cluster_wait();  // h_cd[t-1] is complete in this CTA's buffer t & 1
    const W* hb = hs + (t & 1) * hbuf;
    float acc[3][4];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
    if constexpr (bf) {
      // c = h_cd (16 x H) . W slice (H x 3 Up) on the tensor cores; the odd
      // k16 steps sum into a second set of accumulators (two chains)
      const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
      const __nv_bfloat16* ap0 = hb + gq * ld + 2 * tq;
      const __nv_bfloat16* bp0 = ws + (size_t)(u0 - 2 * tq + gq) * ld + 2 * tq;
      float acc2[3][4];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc2[g][e] = 0.f;
#pragma unroll 2
      for (int k = 0; k < H; k += 32) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kk = k + 16 * half;
          uint32_t af[4];
          const __nv_bfloat16* ap = ap0 + kk;
          af[0] = w2vb::ld_pair(ap);
          af[1] = w2vb::ld_pair(ap + 8 * ld);
          af[2] = w2vb::ld_pair(ap + 8);
          af[3] = w2vb::ld_pair(ap + 8 * ld + 8);
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const __nv_bfloat16* bp = bp0 + (size_t)g * Up * ld + kk;
            const uint32_t bfr[2] = {w2vb::ld_pair(bp), w2vb::ld_pair(bp + 8)};
            w2vb::mma_bf16(half ? acc2[g] : acc[g], af, bfr);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] += acc2[g][e];
    } else {
      // SIMT f32 FMAs (no TF32): per k one float2 of h (rows r0, r1) and
      // one float2 of W per gate (units u0, u0 + 1), over K quarter kq
      const float* hp = reinterpret_cast<const float*>(hb) + r0;
      const float* wp = reinterpret_cast<const float*>(ws) + u0;
      const int kn = H / kF32KSplit;
#pragma unroll 4
      for (int k = kq * kn; k < (kq + 1) * kn; ++k) {
        const float2 hv = *reinterpret_cast<const float2*>(hp + k * kClusterRows);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float2 wv = *reinterpret_cast<const float2*>(wp + (size_t)k * 3 * Up + g * Up);
          acc[g][0] = fmaf(hv.x, wv.x, acc[g][0]);
          acc[g][1] = fmaf(hv.x, wv.y, acc[g][1]);
          acc[g][2] = fmaf(hv.y, wv.x, acc[g][2]);
          acc[g][3] = fmaf(hv.y, wv.y, acc[g][3]);
        }
      }
      if (!owner) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[(((kq - 1) * 3 + g) * 4 + e) * nt + lt] = acc[g][e];
      }
      __syncthreads();
      if (owner) {
#pragma unroll
        for (int q = 0; q < kF32KSplit - 1; ++q)
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] += part[((q * 3 + g) * 4 + e) * nt + lt];
      }
    }
    // the gates, b_hh added after the product; h carried in f32
    float hn[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ui = e & 1;
      const float gh_n = acc[2][e] + bias[2][ui];
      const float rg = w2vb::sigmoidf(gcur[0][e] + (acc[0][e] + bias[0][ui]));
      const float z = w2vb::sigmoidf(gcur[1][e] + (acc[1][e] + bias[1][ui]));
      const float n = tanhf(gcur[2][e] + rg * gh_n);
      hn[e] = (1.f - z) * n + z * hc[e];
    }
    if (t + 1 < a.T) {
      // h_cd[t] of the thread's elements into every CTA's buffer (t + 1) & 1
      if (live) {
        const int nb = ((t + 1) & 1) * hbuf;
        if constexpr (bf) {  // rows r0, r1: a pair of units each (bytes: 2 an element)
          const uint32_t p0 = w2vb::pack_bf16(hn[0], hn[1]), p1 = w2vb::pack_bf16(hn[2], hn[3]);
          const uint32_t o0 = 2 * (nb + r0 * ld + gu), o1 = 2 * (nb + r1 * ld + gu);
#pragma unroll
          for (int q = 0; q < kClusterMaxCtas; ++q) {
            if (q >= cn) break;
            st_cluster(remote[q] + o0, p0);
            st_cluster(remote[q] + o1, p1);
          }
        } else {  // units u0, u0 + 1: a pair of rows each (bytes: 4 an element)
          const uint32_t o0 = 4 * (nb + gu * kClusterRows + r0), o1 = o0 + 4 * kClusterRows;
#pragma unroll
          for (int q = 0; q < kClusterMaxCtas; ++q) {
            if (q >= cn) break;
            st_cluster(remote[q] + o0, hn[0], hn[2]);
            st_cluster(remote[q] + o1, hn[1], hn[3]);
          }
        }
      }
      cluster_arrive();  // also frees `part` for the next step's partials
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int b = b0 + rows[ri];
      if (live && b < a.B) {
        float* y = a.ys + (((size_t)t * a.ND + d) * a.B + b) * H + gu;
        y[0] = hn[2 * ri];
        y[1] = hn[2 * ri + 1];
      }
    }
    // gi of the next step, in flight while the cluster waits and multiplies
    if (t + 1 < a.T) load_gi(t + 1, gcur);
#pragma unroll
    for (int e = 0; e < 4; ++e) hc[e] = hn[e];
  }
}

// The launch configuration of the cluster kernel with cn CTAs per cluster
template <typename W>
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int cn, int B, int ND, int H, cudaStream_t s) {
    const int up = round_up8(H / cn);
    cfg.gridDim = dim3(cn, (B + kClusterRows - 1) / kClusterRows, ND);
    cfg.blockDim = dim3(4 * up * k_split<W>());
    cfg.dynamicSmemBytes = cluster_smem<W>(H, up);
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cn;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The cluster size the kernel takes at width H: 8 CTAs, else 4, where the
// CTA's shared memory fits and the card can schedule one such cluster; 0 if
// neither (a negative value: a CUDA error code)
template <typename W>
int cluster_size(int H) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  for (int cn = kClusterMaxCtas; cn >= 4; cn /= 2) {
    if (H % (4 * cn)) continue;  // U = H / cn a multiple of 4
    ClusterLaunch<W> l(cn, 1, 1, H, nullptr);
    if (l.cfg.dynamicSmemBytes > (size_t)smem_max || l.cfg.blockDim.x > (unsigned)cluster_max_threads<W>()) continue;
    e = w2vb::allow_smem(gru_fwd_cluster_kernel<W>, l.cfg.dynamicSmemBytes);
    int n = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, gru_fwd_cluster_kernel<W>, &l.cfg);
    if (e != cudaSuccess) return -static_cast<int>(e);
    if (n > 0) return cn;
  }
  return 0;
}

template <typename W>
int launch_cluster(const ClusterArgs<W>& base, int cn, cudaStream_t s) {
  if (cn < 1 || cn > kClusterMaxCtas || base.H % (4 * cn)) return static_cast<int>(cudaErrorInvalidValue);
  ClusterLaunch<W> l(cn, base.B, base.ND, base.H, s);
  ClusterArgs<W> a = base;
  a.U = base.H / cn;
  a.Up = round_up8(a.U);
  cudaError_t e = w2vb::allow_smem(gru_fwd_cluster_kernel<W>, l.cfg.dynamicSmemBytes);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&l.cfg, gru_fwd_cluster_kernel<W>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
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

using w2vb::cp_async16;
using w2vb::cp_async_commit;
using w2vb::cp_async_wait;

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

// The fused forward's cluster size at width H (w_bf16: compute dtype
// bfloat16): 8 or 4 CTAs, 0 if no cluster of the kernel fits the card; a
// negative value is a CUDA error code.
extern "C" int w2vb_gru_fwd_cluster_size(int H, int w_bf16) {
  return w_bf16 ? cluster_size<__nv_bfloat16>(H) : cluster_size<float>(H);
}

// Fused forward, one cluster-resident launch for all T steps (ys; ClusterArgs
// above for the layouts); w_hh (ND, H, 3H) in the compute dtype (w_bf16);
// cn from w2vb_gru_fwd_cluster_size; H a multiple of 4 cn.
extern "C" int w2vb_gru_fwd_cluster(const float* gi, const void* w_hh, int w_bf16, const float* b_hh,
                                    const float* h0, float* ys, int T, int ND, int B, int H, int cn,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    using W = __nv_bfloat16;
    return launch_cluster(ClusterArgs<W>{gi, static_cast<const W*>(w_hh), b_hh, h0, ys, T, ND, B, H, 0, 0},
                          cn, s);
  }
  return launch_cluster(ClusterArgs<float>{gi, static_cast<const float*>(w_hh), b_hh, h0, ys, T, ND, B, H, 0, 0},
                        cn, s);
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
