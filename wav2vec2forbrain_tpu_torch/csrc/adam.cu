// Adam's update of every trained leaf in one launch: the multi-tensor form of
// train/optim.py::Optimizer.step's per-leaf loop.
//
// Replaces: no TPU kernel. The JAX package has no Pallas kernel for the
// optimizer: XLA fuses optax's update (wav2vec2forbrain_tpu/train/optim.py)
// into a few loops over the whole tree. The port ran it as a loop of ~13
// PyTorch ops a leaf, ~10.9k launches a conformer step over ~800 leaves,
// each a few microseconds of device work: the host's launches set the
// pace, and the card idled 142-237 ms a step (PERF.md §5).
//
// Bound: bytes. Each element reads p, g, m and v and writes p, m and v: 28
// bytes with f32 moments (20 with both in bf16; 24 without a gradient),
// ~17 GB for the conformer's ~600M trained parameters, 5.1 ms at 3.35 TB/s.
// About 15 flops an element is far under the card's ridge, so the design
// is about bytes alone: 16-byte loads and stores where the pointers allow,
// every element touched once, and enough blocks in flight to fill HBM.
//
// Arithmetic: the loop's, operation for operation, in f32, each product,
// sum, quotient and root rounded on its own (the _rn intrinsics: nothing is
// contracted into an FMA), so the card's result equals the loop's bit for
// bit:
//   g' = g + p * wd                        (weight decay on; no gradient: g = 0)
//   stock optax (nu_dtype None):
//     m' = g' * (1 - b1) + [m * b1m]_M     b1m: b1 rounded to M; [x]_M: x
//     v' = (g' g') * (1 - b2) + [v * b2v]_V     rounded to M and back (the
//                                          product PyTorch takes in m's dtype)
//   otherwise (f32 throughout):
//     m' = m * b1 + g' * (1 - b1),  v' = v * b2 + (g' g') * (1 - b2)
//   u  = (m' * r1) / (sqrt(v' * r2) + eps) r1, r2: the f32 reciprocals of the
//                                          bias corrections (PyTorch divides
//                                          a CUDA tensor by a scalar so; the
//                                          loop writes it out)
//   p += u * (-lr);  m, v stored in their dtypes (bf16: round to nearest even)
// with every scalar rounded to f32 as PyTorch rounds a Python scalar operand.
//
// Design: ops/adam.py builds a table of entries, one a leaf (a ZeRO-1
// piece of it under --optimizer_state_sharding=zero1), and copies it to the
// card once a step from pinned memory on the launch's stream. An entry
// holds the four pointers, the leaf's -lr, and p and g as n / inner rows of
// inner elements, rows p_stride (g_stride) apart (a piece narrowed on any
// dim is such rows; a whole leaf is one row); m and v are dense. A leaf is
// cut into chunks of `chunk` elements, numbered over the table (chunk0: an
// entry's first); blocks take the chunks in a grid-stride loop, each finding
// its entry by a binary search of chunk0, and its threads walk the chunk in
// groups of 4 elements (one 16-byte access of p and g, 16 or 8 of m and v)
// where the entry's pointers, strides and row length allow (`vec`), else
// one element at a time. One launch serves every entry whose moments have
// the launch's dtypes (templated: M, V in {float, bf16}).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Entry {
  float* p;
  const float* g;  // null: no gradient (LayerDrop's skipped layers), read as zeros
  void* m;
  void* v;
  long long p_stride;  // elements between rows of p (and of g)
  long long g_stride;
  long long n;      // elements: n / inner rows
  long long inner;  // elements a row
  int chunk0;       // the entry's first chunk
  int vec;          // 16-byte accesses: 16-byte p and g, m and v aligned to 4 elements, inner and strides % 4 == 0
  float neg_lr;
  int pad;
};
static_assert(sizeof(Entry) == 80, "ops/adam.py::ENTRY has this layout");

struct Scalars {
  float wd, c1, c2, b1, b2, inv_bc1, inv_bc2, eps;
  int has_wd;
};

template <typename T>
__device__ __forceinline__ float stored(float x) {
  return w2vb::to_f32(w2vb::from_f32<T>(x));
}

template <typename M, typename V, bool kStock>
__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v, const Scalars& s, float neg_lr) {
  if (s.has_wd) g = __fadd_rn(g, __fmul_rn(p, s.wd));
  const float g2 = __fmul_rn(g, g);
  float m2, v2;
  if (kStock) {
    m2 = __fadd_rn(__fmul_rn(g, s.c1), stored<M>(__fmul_rn(m, s.b1)));
    v2 = __fadd_rn(__fmul_rn(g2, s.c2), stored<V>(__fmul_rn(v, s.b2)));
  } else {
    m2 = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.c1));
    v2 = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(g2, s.c2));
  }
  const float u = __fdiv_rn(__fmul_rn(m2, s.inv_bc1), __fadd_rn(__fsqrt_rn(__fmul_rn(v2, s.inv_bc2)), s.eps));
  p = __fadd_rn(p, __fmul_rn(u, neg_lr));
  m = m2;
  v = v2;
}

__device__ __forceinline__ void load4(const float* a, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(a);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* a, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(a);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}

__device__ __forceinline__ void store4(float* a, const float (&x)[4]) {
  *reinterpret_cast<float4*>(a) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* a, const float (&x)[4]) {
  *reinterpret_cast<uint2*>(a) = make_uint2(w2vb::pack_bf16(x[0], x[1]), w2vb::pack_bf16(x[2], x[3]));
}

template <typename M, typename V, bool kStock>
__global__ void __launch_bounds__(kThreads) adam_kernel(const Entry* __restrict__ table, int n_entries, int n_chunks,
                                                        long long chunk, Scalars s) {
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int lo = 0, hi = n_entries - 1;  // the last entry with chunk0 <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table[mid].chunk0 <= c) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const Entry e = table[lo];
    M* m = static_cast<M*>(e.m);
    V* v = static_cast<V*>(e.v);
    const long long begin = static_cast<long long>(c - e.chunk0) * chunk;
    const long long end = min(begin + chunk, e.n);
    const bool rows = e.inner != e.n;
    if (e.vec) {
      for (long long i = begin + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
        long long ip = i, ig = i;
        if (rows) {
          const long long r = i / e.inner, col = i - r * e.inner;
          ip = r * e.p_stride + col;
          ig = r * e.g_stride + col;
        }
        float pv[4], gv[4] = {0.f, 0.f, 0.f, 0.f}, mv[4], vv[4];
        load4(e.p + ip, pv);
        if (e.g != nullptr) load4(e.g + ig, gv);
        load4(m + i, mv);
        load4(v + i, vv);
#pragma unroll
        for (int k = 0; k < 4; ++k) adam_elem<M, V, kStock>(pv[k], gv[k], mv[k], vv[k], s, e.neg_lr);
        store4(e.p + ip, pv);
        store4(m + i, mv);
        store4(v + i, vv);
      }
    } else {
      for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
        long long ip = i, ig = i;
        if (rows) {
          const long long r = i / e.inner, col = i - r * e.inner;
          ip = r * e.p_stride + col;
          ig = r * e.g_stride + col;
        }
        float pv = e.p[ip], gv = e.g != nullptr ? e.g[ig] : 0.f;
        float mv = w2vb::to_f32(m[i]), vv = w2vb::to_f32(v[i]);
        adam_elem<M, V, kStock>(pv, gv, mv, vv, s, e.neg_lr);
        e.p[ip] = pv;
        m[i] = w2vb::from_f32<M>(mv);
        v[i] = w2vb::from_f32<V>(vv);
      }
    }
  }
}

template <typename M, typename V>
void launch(const Entry* table, int n_entries, int n_chunks, long long chunk, int grid, bool stock, const Scalars& s,
            cudaStream_t stream) {
  if (stock) {
    adam_kernel<M, V, true><<<grid, kThreads, 0, stream>>>(table, n_entries, n_chunks, chunk, s);
  } else {
    adam_kernel<M, V, false><<<grid, kThreads, 0, stream>>>(table, n_entries, n_chunks, chunk, s);
  }
}

}  // namespace

// table: n_entries Entry rows on the card (chunk0 ascending from 0, n_chunks
// in all); chunk: elements a chunk (a multiple of 4); m_bf16 / v_bf16: the
// moments' dtypes; stock: optax's scale_by_adam (nu_dtype None); the
// scalars as the header gives them, already rounded to f32
extern "C" int w2vb_adam(const void* table, int n_entries, int n_chunks, int chunk, int grid, int m_bf16,
                         int v_bf16, int stock, int has_wd, float wd, float c1, float c2, float b1, float b2,
                         float inv_bc1, float inv_bc2, float eps, void* stream) {
  if (n_entries < 1 || n_chunks < 1 || chunk < 4 || chunk % 4 != 0 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scalars s{wd, c1, c2, b1, b2, inv_bc1, inv_bc2, eps, has_wd};
  const Entry* t = static_cast<const Entry*>(table);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m_bf16 && v_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(t, n_entries, n_chunks, chunk, grid, stock, s, st);
  } else if (m_bf16) {
    launch<__nv_bfloat16, float>(t, n_entries, n_chunks, chunk, grid, stock, s, st);
  } else if (v_bf16) {
    launch<float, __nv_bfloat16>(t, n_entries, n_chunks, chunk, grid, stock, s, st);
  } else {
    launch<float, float>(t, n_entries, n_chunks, chunk, grid, stock, s, st);
  }
  return static_cast<int>(cudaGetLastError());
}
