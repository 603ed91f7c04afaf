// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++ on
// the tensor cores.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (bigdl_tpu/ops/flash_attention.py:39, launched by `_flash_fwd` :145).
// It computes what that kernel computes: o = softmax(scale * q k^T) v per
// (batch, head) with float32 products and softmax, -1e30 as the mask
// value, bottom-right causal alignment (key j visible to query i iff
// j <= i + Tk - Tq), keys past Tk masked by position, optional q-side and
// kv-side segment ids compared for equality, o = acc / l with l == 0 taken
// as 1, and lse = m + log l in float32.  For bf16 inputs the probabilities
// are rounded to bf16 before the value product, as the TPU kernel's
// `p.astype(vb.dtype)`, while l sums the unrounded float32 p.
//
// What bounds it on this card: at the prefill and training shapes
// (T = 1024, D = 64) attention does O(T^2 D) operations on O(T D) bytes,
// so it is bound by operations, and only the tensor cores reach the
// card's operation rate.  Every product is an `mma.sync` (the helpers of
// sm90_mma.cuh, shared with the backward in flash_bwd.cu):
//
// - bf16: m16n8k16 bf16 x bf16 -> float32 (989 TFLOP/s peak), operands
//   from `ldmatrix` on bf16 tiles in XOR-swizzled shared memory.
// - float32: 3xTF32 on m16n8k8 (495 / 3 = 165 TFLOP/s peak): each operand
//   splits into tf32 hi and lo, and a product sums lo*hi + hi*lo + hi*hi
//   in float32, about float32's accuracy (a single TF32 product misses
//   the float32 tolerance; tests/test_torch_port_ops.py emulates both).
//
// Design.  The TPU grid carries acc/m/l in VMEM across its innermost
// key-block axis; blocks of a CUDA grid run in parallel with nothing
// carried between them, so one thread block owns 64 query rows of one
// (batch, head), 4 warps of 16 rows, and loops over the key tiles itself:
//
// - Q is copied once into swizzled shared memory by `cp.async`; K and V
//   tiles (and the key segment ids) stream through a 2-stage `cp.async`
//   ring, the next tile's copy in flight while the current one is
//   computed, rows past Tk zero-filled.  The walk stops at the last tile a
//   causal row reaches; tiles of key padding are never visited, and a
//   warp whose 16 rows see no key of a tile skips it.
// - S = Q K^T is `mma_abt`.  The online softmax runs in registers: each
//   thread holds rows g and g + 8 of its warp's tile, the row max reduces
//   over the 4 lanes of a quad with two shuffles, the accumulator is
//   rescaled by alpha = exp(m_old - m_new), and p = exp2(s scale log2 e -
//   m log2 e) with the scale folded into one multiply-add.  m stays in the
//   units of s * scale, so a row that sees no key keeps m = -1e30 and
//   gives lse = -1e30 exactly and o = 0.  The row sum l is kept per
//   thread and reduced over the quad once, at the end.  Warp tiles that
//   are visible everywhere skip the mask.
// - O += P V is `mma_pb`, with P fed back from the S accumulators as the A
//   operand (bf16: rounded to nearest, the `astype` above; tf32: split,
//   with V's k rows permuted to the accumulator's column order).  No P
//   tile goes through shared memory.
// - o = acc / l is stored by `store_rows`; lse by one lane of each quad.
//
// The streamed tiles have 64 keys for bf16 at D = 64 and 32 otherwise, as
// in the backward (float32's split operands and D = 128's accumulators
// leave fewer registers for the score tile).  Blocks are issued with the
// last query tile first: under causality it has the most key tiles.  No
// atomics: every output is summed by one thread in a fixed order, so
// results are bitwise repeatable.  `wgmma` and TMA are later work.
#include "sm90_mma.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;  // query rows of a block
constexpr float NEG = -1e30f;

template <typename T, int D, int BK>
constexpr size_t smem_bytes() {
  // Q; two stages of (K, V); two stages of the key segment ids
  return sizeof(T) * (size_t)(BQ * D + 4 * BK * D) +
         sizeof(int) * (size_t)(2 * BK);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_k, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, int causal,
                 float scale) {
  constexpr int NK = BK / 8;  // n8 tiles of keys in S
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = Qs + BQ * D;  // stage s: K at ring + 2 s BK D, V after it
  int* segk_ring = reinterpret_cast<int*>(ring + 4 * BK * D);  // BK a stage

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // last tile first
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  const bool segmented = seg_q != nullptr;
  const int shift = Tk - Tq;
  const float scale_l2 = scale * kLog2e;  // exp(x) = exp2(x log2 e)

  load_tile<T, D, BQ>(Qs, q + bh * Tq * D, q0, Tq);
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

  // the thread's two query rows: accumulator rows g and g + 8 of its warp;
  // m in the units of s * scale, l the thread's share of the row sum
  const int qw0 = q0 + warp * 16;
  int qi[2], segq[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = qw0 + g + 8 * h;
    segq[h] = (segmented && qi[h] < Tq) ? seg_q[(size_t)b * Tq + qi[h]] : -1;
    m[h] = NEG;
    l[h] = 0.f;
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
    const int k0 = j * BK;

    // a warp whose rows see no key of this tile leaves m, l and acc as
    // they are: skip it
    if (!causal || k0 <= qw0 + 15 + shift) {
      float s[NK][4];
#pragma unroll
      for (int jj = 0; jj < NK; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
      mma_abt<T, D, NK>(s, Qs, warp * 16, Ks, lane);

      // masked scores become -inf: they leave the row max alone and give
      // p = exp2(-inf) = 0
      const bool full = !segmented && qw0 + 16 <= Tq && k0 + BK <= Tk &&
                        (!causal || k0 + BK - 1 <= qw0 + shift);
      if (!full) {
#pragma unroll
        for (int jj = 0; jj < NK; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = jj * 8 + 2 * t + (e & 1), key = k0 + kl;
            const int h = e >> 1;
            bool vis = qi[h] < Tq && key < Tk;
            if (causal) vis = vis && key <= qi[h] + shift;
            if (segmented) vis = vis && segq[h] == segk[kl];
            if (!vis) s[jj][e] = -INFINITY;
          }
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jj = 0; jj < NK; ++jj) {
        mx[0] = fmaxf(mx[0], fmaxf(s[jj][0], s[jj][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[jj][2], s[jj][3]));
      }
      float alpha[2], m_l2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // scale > 0, so the max of the scaled scores is the scaled max
        const float m_new = fmaxf(m[h], mx[h] * scale);
        alpha[h] = exp2f((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        m_l2[h] = m_new * kLog2e;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int jj = 0; jj < NK; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[jj][e], scale_l2, -m_l2[e >> 1]));
          s[jj][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

      mma_pb<T, D, NK>(acc, s, Vs, lane);  // O += P V
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // nothing left in flight when no key tile ran

  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l_safe[h] = l[h] == 0.f ? 1.f : l[h];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] / l_safe[e >> 1];
  store_rows<T, D>(o + bh * Tq * D, acc, qw0, Tq, 1.f, lane);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qi[h] < Tq) lse[bh * Tq + qi[h]] = m[h] + logf(l_safe[h]);
  }
}

template <typename T, int D, int BK>
int launch(const void* q, const void* k, const void* v, const int* seg_q,
           const int* seg_k, void* o, float* lse, int B, int H, int Tq,
           int Tk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D, BK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg_q, seg_k, static_cast<T*>(o), lse, H, Tq,
      Tk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, H, Tq, D), k/v: (B, H, Tk, D), o like q, lse (B, H, Tq) float32,
// all contiguous; seg_q (B, Tq) / seg_k (B, Tk) int32 or both null.
// dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
int bigdl_flash_fwd(const void* q, const void* k, const void* v,
                    const void* seg_q, const void* seg_k, void* o, void* lse,
                    int B, int H, int Tq, int Tk, int D, int dtype, int causal,
                    float scale, void* stream) {
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64, 32>(q, k, v, sq, sk, o, ls, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128, 32>(q, k, v, sq, sk, o, ls, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64, 64>(q, k, v, sq, sk, o, ls, B, H, Tq, Tk, causal, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128, 32>(q, k, v, sq, sk, o, ls, B, H, Tq, Tk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
