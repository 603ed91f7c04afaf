// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// two kernels, one for dk/dv and one for dq, on the tensor cores.
//
// Replaces the Pallas TPU kernels `_bwd_dkv_kernel`
// (bigdl_tpu/ops/flash_attention.py:199) and `_bwd_dq_kernel` (:262),
// both launched by `_flash_bwd` (:330).  They compute what those kernels
// compute, from the forward's saved lse and the row scalars
// delta = rowsum(do * o) (computed by the wrapper) and dlse (the lse
// cotangent):
//
//   s  = scale * q k^T            (float32 sums)
//   p  = mask ? exp(s - lse) : 0  (a select, never exp(.) * mask: a row
//                                  with no visible key has lse = -1e30 and
//                                  exp(s - lse) overflows there)
//   dv = p^T do                   (p rounded to bf16 first for bf16 inputs)
//   dp = do v^T
//   ds = p * (dp - (delta - dlse))
//   dk = scale * ds^T q,  dq = scale * ds k  (ds rounded to bf16 first)
//
// with the forward's masks: keys past Tk and queries past Tq masked by
// position, bottom-right causality (key j visible to query i iff
// j <= i + Tk - Tq), optional q-side and kv-side segment ids compared for
// equality.  All sums are float32.
//
// What bounds it on this card: at the training shapes (T = 1024, D = 64)
// the backward does O(T^2 D) operations on O(T D) bytes, so it is bound
// by operations, and only the tensor cores reach the card's operation
// rate.  Every product of both kernels is an `mma.sync`:
//
// - bf16: m16n8k16 bf16 x bf16 -> float32 (989 TFLOP/s peak).  Tiles stay
//   bf16 in shared memory; operands come from `ldmatrix` (`.trans` where a
//   product reads a tile along its rows).
// - float32: 3xTF32 on m16n8k8 (495 / 3 = 165 TFLOP/s peak).  Each operand
//   x splits into hi = tf32(x) and lo = tf32(x - hi), both rounded to
//   nearest, and a product sums lo*hi + hi*lo + hi*hi in float32: about
//   float32's accuracy (a single TF32 product misses the 1e-4 tolerance of
//   the float32 backward; three stay 100x inside it).  There is no
//   single-pass TF32 path.  Fragments are plain 32-bit shared loads,
//   split as they are used; those loads and splits, several instructions
//   for each `mma`, are what holds this path below the bf16 one's share
//   of its peak (PERF.md).
//
// Shared tiles are row-major with an XOR swizzle of their 16-byte chunks
// (chunk ^ (row & 7)): a row of 64 bf16 values is 128 bytes, so without
// it the 8 rows an `ldmatrix` or a fragment load reads would hit one bank
// group 8 times.
//
// - dk/dv: one block per (batch, head, 64-key tile), 4 warps of 16 key
//   rows.  K and V stay in shared memory; the query tiles (BQ rows of Q and
//   dO, and their lse, delta, dlse and segment ids) stream through a
//   2-stage ring filled by `cp.async` (16 bytes a thread; rows past T are
//   zero-filled from a clamped in-bounds address), the next tile's copy in
//   flight while the current one is computed.  The walk starts at the first
//   query tile whose causal row reaches the key tile.  The warp computes
//   the transposed tiles S^T = K Q^T and dP^T = V dO^T, so it owns whole
//   key rows and P^T and dS^T come out of the accumulators already laid out
//   as the A operand of dV += P^T dO and dK += dS^T Q: no pass through
//   shared memory.  In bf16 two adjacent n8 accumulator tiles are one k16 A
//   fragment after `__floats2bfloat162_rn` (the rounding the semantics ask
//   for).  In tf32 the A fragment holds columns (c, c + 4) where the
//   accumulator holds (2c, 2c + 1), so the B operand's k rows are read
//   permuted to match (row 2c where the fragment wants c, 2c + 1 where it
//   wants c + 4).  The query-side scalars belong to the accumulator's
//   column here, and are read from the ring.
// - dq: one block per (batch, head, 64-query tile), 4 warps of 16 query
//   rows.  Q and dO stay in shared memory; K and V tiles (and the key
//   segment ids) stream through the same kind of ring up to the last tile
//   a causal row reaches.  S = Q K^T and dP = dO V^T; dS comes out of its
//   accumulator as the A fragment of dQ += dS K, with K read along its rows
//   (`ldmatrix.trans`, or the permuted rows in tf32).
//
// The streamed tiles (BQ of dk/dv, BK of dq) have 64 rows for bf16 at
// D = 64 and 32 rows otherwise: float32's split operands and D = 128's
// accumulators leave fewer registers for the score tiles, and the smaller
// tiles measured faster there.  Dynamic shared memory above 48 KB is
// enabled with cudaFuncSetAttribute.
//
// Softmax: exp(x) is computed as exp2(x log2 e), with scale log2 e folded
// into one multiply-add.  A warp whose 16 x BQ (or 16 x BK) tile is visible
// everywhere (inside T, below the causal diagonal, no segments) skips the
// mask; the tiles on the diagonal and at the ragged edge take it.
//
// Neither kernel uses atomics: every output element is summed by one
// thread in a fixed order, so results are bitwise repeatable.  The split
// into two kernels recomputes s and dp in both (8 D + 6 D operations a
// visible pair against 10 D for one fused backward); dq without atomics is
// what keeps the result repeatable.  `wgmma` and TMA are later work.
//
// The device helpers named above (swz, cp.async, ldmatrix and mma.sync
// wrappers, the 3xTF32 split, mma_abt, mma_pb, store_rows) live in
// sm90_mma.cuh, shared with the forward in flash_fwd.cu.
#include "sm90_mma.cuh"

#include <type_traits>

namespace {

constexpr int BK_DKV = 64;    // key rows of a dk/dv block
constexpr int BQ_DQ = 64;     // query rows of a dq block

template <typename T, int D, int BQ>
constexpr size_t dkv_smem_bytes() {
  // K, V; two stages of (Q, dO); two stages of lse, delta, dlse, seg
  return sizeof(T) * (size_t)(2 * BK_DKV * D + 4 * BQ * D) +
         sizeof(float) * (size_t)(2 * 4 * BQ);
}

template <typename T, int D, int BK>
constexpr size_t dq_smem_bytes() {
  // Q, dO; two stages of (K, V); two stages of the key segment ids
  return sizeof(T) * (size_t)(2 * BQ_DQ * D + 4 * BK * D) +
         sizeof(int) * (size_t)(2 * BK);
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dlse,
                     const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, int causal,
                     float scale) {
  constexpr int BK = BK_DKV;
  constexpr int NQ = BQ / 8;  // n8 tiles of queries in S^T
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BK * D;
  T* ring = Vs + BK * D;  // stage s: Q at ring + 2 s BQ D, dO after it
  float* scalars = reinterpret_cast<float*>(ring + 4 * BQ * D);
  // stage s: lse, delta, dlse, seg (int) at scalars + 4 s BQ, BQ each

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const T* qb = q + bh * Tq * D;
  const T* dob = dout + bh * Tq * D;
  const bool segmented = seg_q != nullptr;
  const int shift = Tk - Tq;
  const float scale_l2 = scale * kLog2e;  // exp(x) = exp2(x log2 e)

  load_tile<T, D, BK>(Ks, k + bh * Tk * D, k0, Tk);
  load_tile<T, D, BK>(Vs, v + bh * Tk * D, k0, Tk);
  cp_async_commit();

  auto prefetch = [&](int iq, int stage) {
    T* Qs = ring + 2 * stage * BQ * D;
    const int q0 = iq * BQ;
    load_tile<T, D, BQ>(Qs, qb, q0, Tq);
    load_tile<T, D, BQ>(Qs + BQ * D, dob, q0, Tq);
    float* sc = scalars + 4 * stage * BQ;
    const int n_rows = segmented ? 4 * BQ : 3 * BQ;
    for (int i = threadIdx.x; i < n_rows; i += THREADS) {
      const int which = i / BQ, r = i % BQ, qi = q0 + r;
      const bool in = qi < Tq;
      const size_t at = in ? bh * Tq + qi : 0;
      const void* from =
          which == 0   ? (const void*)(lse + at)
          : which == 1 ? (const void*)(delta + at)
          : which == 2 ? (const void*)(dlse + at)
                       : (const void*)(seg_q + (in ? (size_t)b * Tq + qi : 0));
      cp_async4(smem_u32(sc + i), from, in);
    }
  };

  // the first query tile holding a row whose causal reach includes k0
  int iq0 = 0;
  if (causal) {
    const int first = k0 - shift;
    iq0 = first <= 0 ? 0 : first / BQ;
  }
  const int n_q = (Tq + BQ - 1) / BQ;
  prefetch(iq0, 0);
  cp_async_commit();

  // the thread's two key rows: accumulator rows g and g + 8 of its warp
  int kj[2], segk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kj[h] = k0 + warp * 16 + g + 8 * h;
    segk[h] = (segmented && kj[h] < Tk) ? seg_k[(size_t)b * Tk + kj[h]] : -2;
  }

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int iq = iq0; iq < n_q; ++iq) {
    const int stage = (iq - iq0) & 1;
    if (iq + 1 < n_q) {
      prefetch(iq + 1, stage ^ 1);  // in flight while this tile is computed
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qs = ring + 2 * stage * BQ * D;
    const T* dOs = Qs + BQ * D;
    const float* sc = scalars + 4 * stage * BQ;
    const int* segq = reinterpret_cast<const int*>(sc + 3 * BQ);

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    mma_abt<T, D, NQ>(st, Ks, warp * 16, Qs, lane);
    mma_abt<T, D, NQ>(dpt, Vs, warp * 16, dOs, lane);

    // P^T into st, dS^T into dpt
    const int q0 = iq * BQ;
    auto probs = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + 2 * t + (e & 1);
          bool vis = true;
          if constexpr (decltype(masked)::value) {
            const int qi = q0 + ql, key = kj[e >> 1];
            vis = qi < Tq && key < Tk;
            if (causal) vis = vis && key <= qi + shift;
            if (segmented) vis = vis && segq[ql] == segk[e >> 1];
          }
          const float p =
              vis ? exp2f(st[j][e] * scale_l2 - sc[ql] * kLog2e) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - (sc[BQ + ql] - sc[2 * BQ + ql]));
        }
    };
    // no mask to compute where every pair of the warp's tile is visible
    const int kw_last = k0 + warp * 16 + 15;
    if (!segmented && q0 + BQ <= Tq && kw_last < Tk &&
        (!causal || kw_last <= q0 + shift))
      probs(std::false_type{});
    else
      probs(std::true_type{});

    mma_pb<T, D, NQ>(acc_v, st, dOs, lane);  // dV += P^T dO
    mma_pb<T, D, NQ>(acc_k, dpt, Qs, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with this stage
  }

  store_rows<T, D>(dk + bh * Tk * D, acc_k, k0 + warp * 16, Tk, scale, lane);
  store_rows<T, D>(dv + bh * Tk * D, acc_v, k0 + warp * 16, Tk, 1.f, lane);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dlse,
                    const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k, T* __restrict__ dq, int H,
                    int Tq, int Tk, int causal, float scale) {
  constexpr int BQ = BQ_DQ;
  constexpr int NK = BK / 8;  // n8 tiles of keys in S
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BQ * D;
  T* ring = dOs + BQ * D;  // stage s: K at ring + 2 s BK D, V after it
  int* segk_ring = reinterpret_cast<int*>(ring + 4 * BK * D);  // BK a stage

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  const bool segmented = seg_q != nullptr;
  const int shift = Tk - Tq;
  const float scale_l2 = scale * kLog2e;  // exp(x) = exp2(x log2 e)

  load_tile<T, D, BQ>(Qs, q + bh * Tq * D, q0, Tq);
  load_tile<T, D, BQ>(dOs, dout + bh * Tq * D, q0, Tq);
  cp_async_commit();

  auto prefetch = [&](int j, int stage) {
    T* Ks = ring + 2 * stage * BK * D;
    const int k0 = j * BK;
    load_tile<T, D, BK>(Ks, kb, k0, Tk);
    load_tile<T, D, BK>(Ks + BK * D, vb, k0, Tk);
    if (segmented)
      for (int i = threadIdx.x; i < BK; i += THREADS) {
        const bool in = k0 + i < Tk;
        cp_async4(smem_u32(segk_ring + stage * BK + i),
                  seg_k + (in ? (size_t)b * Tk + k0 + i : 0), in);
      }
  };

  // key tiles that hold at least one visible key for some real row
  int n_k = (Tk + BK - 1) / BK;
  if (causal) {
    const int last_visible = min(q0 + BQ, Tq) - 1 + shift;
    n_k = last_visible < 0 ? 0 : min(n_k, last_visible / BK + 1);
  }
  if (n_k > 0) prefetch(0, 0);
  cp_async_commit();

  // the thread's two query rows: accumulator rows g and g + 8 of its warp
  int qi[2], segq[2];
  float row_lse[2], rest[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + warp * 16 + g + 8 * h;
    const bool in = qi[h] < Tq;
    const size_t at = bh * Tq + qi[h];
    row_lse[h] = in ? lse[at] : 0.f;
    rest[h] = in ? delta[at] - dlse[at] : 0.f;
    segq[h] = (segmented && in) ? seg_q[(size_t)b * Tq + qi[h]] : -1;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_k; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_k) {
      prefetch(j + 1, stage ^ 1);  // in flight while this tile is computed
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Ks = ring + 2 * stage * BK * D;
    const T* Vs = Ks + BK * D;
    const int* segk = segk_ring + stage * BK;

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int jj = 0; jj < NK; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
    mma_abt<T, D, NK>(s, Qs, warp * 16, Ks, lane);
    mma_abt<T, D, NK>(dp, dOs, warp * 16, Vs, lane);

    // dS into dp
    const int k0 = j * BK;
    auto probs = [&](auto masked) {
#pragma unroll
      for (int jj = 0; jj < NK; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = jj * 8 + 2 * t + (e & 1);
          const int h = e >> 1;
          bool vis = true;
          if constexpr (decltype(masked)::value) {
            const int key = k0 + kl;
            vis = qi[h] < Tq && key < Tk;
            if (causal) vis = vis && key <= qi[h] + shift;
            if (segmented) vis = vis && segq[h] == segk[kl];
          }
          const float p =
              vis ? exp2f(s[jj][e] * scale_l2 - row_lse[h] * kLog2e) : 0.f;
          dp[jj][e] = p * (dp[jj][e] - rest[h]);
        }
    };
    // no mask to compute where every pair of the warp's tile is visible
    const int qw0 = q0 + warp * 16;
    if (!segmented && qw0 + 16 <= Tq && k0 + BK <= Tk &&
        (!causal || k0 + BK - 1 <= qw0 + shift))
      probs(std::false_type{});
    else
      probs(std::true_type{});

    mma_pb<T, D, NK>(acc, dp, Ks, lane);  // dQ += dS K
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // nothing left in flight when no key tile ran

  store_rows<T, D>(dq + bh * Tq * D, acc, q0 + warp * 16, Tq, scale, lane);
}

struct Ptrs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *dlse;
  const int *seg_q, *seg_k;
};

template <typename T, int D, int BQ>
int launch_dkv(const Ptrs& p, void* dk, void* dv, int B, int H, int Tq,
               int Tk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<T, D, BQ>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + BK_DKV - 1) / BK_DKV, H, B);
  flash_bwd_dkv_kernel<T, D, BQ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k),
      static_cast<const T*>(p.v), static_cast<const T*>(p.dout), p.lse,
      p.delta, p.dlse, p.seg_q, p.seg_k, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int BK>
int launch_dq(const Ptrs& p, void* dq, int B, int H, int Tq, int Tk,
              int causal, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<T, D, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ_DQ - 1) / BQ_DQ, H, B);
  flash_bwd_dq_kernel<T, D, BK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k),
      static_cast<const T*>(p.v), static_cast<const T*>(p.dout), p.lse,
      p.delta, p.dlse, p.seg_q, p.seg_k, static_cast<T*>(dq), H, Tq, Tk,
      causal, scale);
  return (int)cudaGetLastError();
}

Ptrs make_ptrs(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* dlse,
               const void* seg_q, const void* seg_k) {
  return Ptrs{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<const float*>(dlse), static_cast<const int*>(seg_q),
              static_cast<const int*>(seg_k)};
}

}  // namespace

extern "C" {

// q/dout: (B, H, Tq, D), k/v: (B, H, Tk, D), dk/dv like k, all contiguous
// and of one dtype (0 = float32, 1 = bfloat16); lse/delta/dlse (B, H, Tq)
// float32; seg_q (B, Tq) / seg_k (B, Tk) int32 or both null.  Tq, Tk > 0.
// Returns cudaGetLastError().
int bigdl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* dlse, const void* seg_q, const void* seg_k,
                        void* dk, void* dv, int B, int H, int Tq, int Tk,
                        int D, int dtype, int causal, float scale,
                        void* stream) {
  const Ptrs p = make_ptrs(q, k, v, dout, lse, delta, dlse, seg_q, seg_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64, 32>(p, dk, dv, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128, 32>(p, dk, dv, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 1 && D == 64)
    return launch_dkv<__nv_bfloat16, 64, 64>(p, dk, dv, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16, 128, 32>(p, dk, dv, B, H, Tq, Tk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// the same inputs; dq like q.  Returns cudaGetLastError().
int bigdl_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* dlse, const void* seg_q, const void* seg_k,
                       void* dq, int B, int H, int Tq, int Tk, int D,
                       int dtype, int causal, float scale, void* stream) {
  const Ptrs p = make_ptrs(q, k, v, dout, lse, delta, dlse, seg_q, seg_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64, 32>(p, dq, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128, 32>(p, dq, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16, 64, 64>(p, dq, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16, 128, 32>(p, dq, B, H, Tq, Tk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
