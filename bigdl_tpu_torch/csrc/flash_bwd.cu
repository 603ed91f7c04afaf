// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// two kernels, one for dk/dv and one for dq.
//
// Replaces the Pallas TPU kernels `_bwd_dkv_kernel`
// (bigdl_tpu/ops/flash_attention.py:199) and `_bwd_dq_kernel` (:262),
// both launched by `_flash_bwd` (:330).  They compute what those kernels
// compute, from the forward's saved lse and the row scalars
// delta = rowsum(do * o) (computed by the wrapper) and dlse (the lse
// cotangent):
//
//   s  = scale * q k^T            (float32 products)
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
// Design.  The TPU grids carry dk/dv (or dq) in VMEM scratch across a
// sequential innermost grid axis; blocks of a CUDA grid run in parallel
// with nothing carried between them, so here each block loops itself:
//
// - dk/dv: one block per (batch, head, BK-key tile) holds its K and V
//   tiles in shared memory and walks the 64-row query tiles from the
//   first one whose causal row reaches the key tile (the tiles
//   `block_live` skips are never visited).  Per query tile it forms the
//   64 x BK tiles of s and dp in registers (each of 128 threads owns 4
//   rows x BK/8 keys), turns them into p and ds, and stages both in
//   shared memory, because p^T do and ds^T q read them transposed; then
//   each thread accumulates BK/16 key rows x D/8 columns of dk and dv in
//   registers.
// - dq: one block per (batch, head, 64-query tile) holds its Q and dO
//   tiles and walks the 64-key tiles up to the diagonal, accumulating dq
//   in registers as the forward accumulates o.  A row's ds entries are
//   written and read only by the 8 lanes that own the row, all in one
//   warp, so a warp barrier orders them.
//
// Neither kernel uses atomics: every output element is summed by one
// thread in a fixed order, so results are bitwise repeatable.  Tiles are
// staged in shared memory as float32 with a padded row stride (D + 1,
// BK + 1), so the column reads of every product are free of bank
// conflicts; dynamic shared memory (up to 146 KB for dq at D = 128) is
// enabled with cudaFuncSetAttribute.  For D = 128 the dk/dv kernel takes
// 32-key tiles to keep its two accumulators at 64 registers a thread.
//
// What bounds it on this card: at the training shapes (T = 1024, D = 64)
// the backward does O(T^2 D) operations on O(T D) bytes, so it is bound
// by operations.  This first version runs them as float32 FMAs on the CUDA
// cores (67 TFLOP/s peak), not on the tensor cores; register tiling
// (24 shared loads feed 64 FMAs in the score loop) keeps shared memory
// from being the limit.  The split into two kernels recomputes s and dp
// in both (8 D + 6 D operations a visible pair against 10 D for a single
// fused backward), the price of having no atomics; wgmma, TMA and bf16
// tensor-core products are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per tile (both kernels)
constexpr int BK_DQ = 64;    // key rows per tile of the dq kernel
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// the value a product operand takes in the input type (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// rows [r0, r0 + rows) of a (T, D) matrix into a padded float32 tile;
// rows at or past `limit` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int limit) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < rows * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * LD + c] =
        (r0 + r < limit) ? to_f32(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// s = Q K^T and dp = dO V^T for this thread's 4 query rows (ty * 4 + i)
// and CK keys (tx + 8 j) of the tile, unscaled
template <int D, int CK>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int ty, int tx, float (&s)[4][CK],
                                            float (&dp)[4][CK]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], kk[CK], vv[CK];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty * 4 + i) * LD + d];
      g[i] = dOs[(ty * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      kk[j] = Ks[(tx + 8 * j) * LD + d];
      vv[j] = Vs[(tx + 8 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
}

// per-row inputs of the thread's 4 query rows: lse, delta - dlse, segment
struct Rows {
  float lse[4], rest[4];
  int seg[4];
};

__device__ __forceinline__ Rows load_rows(const float* lse,
                                          const float* delta,
                                          const float* dlse, const int* seg_q,
                                          size_t bh, int b, int q0, int ty,
                                          int Tq) {
  Rows r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    const bool in = qi < Tq;
    const size_t g = bh * Tq + qi;
    r.lse[i] = in ? lse[g] : 0.f;
    r.rest[i] = in ? delta[g] - dlse[g] : 0.f;
    r.seg[i] = (seg_q != nullptr && in) ? seg_q[(size_t)b * Tq + qi] : -1;
  }
  return r;
}

// s, dp -> p, ds in place (p into s, ds into dp), with the kernels' masks
template <int CK>
__device__ __forceinline__ void probs(float (&s)[4][CK], float (&dp)[4][CK],
                                      const Rows& rows, const int (&segk)[CK],
                                      int q0, int k0, int ty, int tx, int Tq,
                                      int Tk, int causal, bool segmented,
                                      float scale) {
  const int shift = Tk - Tq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int kj = k0 + tx + 8 * j;
      bool vis = qi < Tq && kj < Tk;
      if (causal) vis = vis && kj <= qi + shift;
      if (segmented) vis = vis && rows.seg[i] == segk[j];
      const float p = vis ? expf(s[i][j] * scale - rows.lse[i]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - rows.rest[i]);
    }
  }
}

template <int D, int BK>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BK + 1));
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BQ * (D + 1) + 2 * BK_DQ * (D + 1) + BQ * (BK_DQ + 1));
}

template <typename T, int D, int BK>
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
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int CK = BK / 8;    // keys per thread in the score tiles
  constexpr int RK = BK / 16;   // key rows per thread in the accumulators
  constexpr int DPT = D / 8;    // columns per thread in the accumulators
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LP;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const T* qb = q + bh * Tq * D;
  const T* dob = dout + bh * Tq * D;
  const bool segmented = seg_q != nullptr;

  load_tile<T, D>(Ks, k + bh * Tk * D, k0, BK, Tk);
  load_tile<T, D>(Vs, v + bh * Tk * D, k0, BK, Tk);
  int segk[CK];
#pragma unroll
  for (int j = 0; j < CK; ++j) {
    const int kj = k0 + tx + 8 * j;
    segk[j] = (segmented && kj < Tk) ? seg_k[(size_t)b * Tk + kj] : -2;
  }

  float acc_k[RK][DPT], acc_v[RK][DPT];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  // the first query tile holding a row whose causal reach includes k0
  int iq = 0;
  if (causal) {
    const int first = k0 - (Tk - Tq);
    iq = first <= 0 ? 0 : first / BQ;
  }
  const int n_q = (Tq + BQ - 1) / BQ;
  for (; iq < n_q; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, D>(Qs, qb, q0, BQ, Tq);
    load_tile<T, D>(dOs, dob, q0, BQ, Tq);
    __syncthreads();

    float s[4][CK], dp[4][CK];
    score_tiles<D, CK>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    const Rows rows = load_rows(lse, delta, dlse, seg_q, bh, b, q0, ty, Tq);
    probs<CK>(s, dp, rows, segk, q0, k0, ty, tx, Tq, Tk, causal, segmented,
              scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        Ps[(ty * 4 + i) * LP + tx + 8 * j] = round_to<T>(s[i][j]);
        dSs[(ty * 4 + i) * LP + tx + 8 * j] = round_to<T>(dp[i][j]);
      }
    __syncthreads();

    // dv += p^T do, dk += ds^T q over this tile's query rows
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pk[RK], sk[RK];
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        pk[r] = Ps[qq * LP + ty * RK + r];
        sk[r] = dSs[qq * LP + ty * RK + r];
      }
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const float g = dOs[qq * LD + tx + 8 * c];
        const float a = Qs[qq * LD + tx + 8 * c];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          acc_v[r][c] = fmaf(pk[r], g, acc_v[r][c]);
          acc_k[r][c] = fmaf(sk[r], a, acc_k[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int kr = k0 + ty * RK + r;
    if (kr >= Tk) continue;
    const size_t row = (bh * Tk + kr) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[row + tx + 8 * c] = from_f32<T>(acc_k[r][c] * scale);
      dv[row + tx + 8 * c] = from_f32<T>(acc_v[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dlse,
                    const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k, T* __restrict__ dq, int H,
                    int Tq, int Tk, int causal, float scale) {
  constexpr int BK = BK_DQ;
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int CK = BK / 8;
  constexpr int DPT = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  const bool segmented = seg_q != nullptr;

  load_tile<T, D>(Qs, q + bh * Tq * D, q0, BQ, Tq);
  load_tile<T, D>(dOs, dout + bh * Tq * D, q0, BQ, Tq);
  const Rows rows = load_rows(lse, delta, dlse, seg_q, bh, b, q0, ty, Tq);

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;

  // key tiles that hold at least one visible key for some real row
  int n_k = (Tk + BK - 1) / BK;
  if (causal) {
    const int last_visible = min(q0 + BQ, Tq) - 1 + (Tk - Tq);
    n_k = last_visible < 0 ? 0 : min(n_k, last_visible / BK + 1);
  }

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done reading the previous K/V tile
    load_tile<T, D>(Ks, kb, k0, BK, Tk);
    load_tile<T, D>(Vs, vb, k0, BK, Tk);
    __syncthreads();

    int segk[CK];
#pragma unroll
    for (int jj = 0; jj < CK; ++jj) {
      const int kj = k0 + tx + 8 * jj;
      segk[jj] = (segmented && kj < Tk) ? seg_k[(size_t)b * Tk + kj] : -2;
    }
    float s[4][CK], dp[4][CK];
    score_tiles<D, CK>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    probs<CK>(s, dp, rows, segk, q0, k0, ty, tx, Tq, Tk, causal, segmented,
              scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < CK; ++jj)
        dSs[(ty * 4 + i) * LP + tx + 8 * jj] = round_to<T>(dp[i][jj]);
    // a row's ds entries are written and read only by the 8 lanes that
    // own the row, all in this warp
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const float kv = Ks[kk * LD + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
      }
    }
    __syncwarp();  // ds is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Tq) continue;
    T* row = dq + (bh * Tq + qi) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) row[tx + 8 * c] = from_f32<T>(acc[i][c] * scale);
  }
}

struct Ptrs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *dlse;
  const int *seg_q, *seg_k;
};

template <typename T, int D, int BK>
int launch_dkv(const Ptrs& p, void* dk, void* dv, int B, int H, int Tq,
               int Tk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<T, D, BK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k),
      static_cast<const T*>(p.v), static_cast<const T*>(p.dout), p.lse,
      p.delta, p.dlse, p.seg_q, p.seg_k, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Ptrs& p, void* dq, int B, int H, int Tq, int Tk,
              int causal, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
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
    return launch_dkv<float, 64, 64>(p, dk, dv, B, H, Tq, Tk, causal, scale, st);
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
    return launch_dq<float, 64>(p, dq, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(p, dq, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(p, dq, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(p, dq, B, H, Tq, Tk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
