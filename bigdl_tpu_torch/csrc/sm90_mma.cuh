// Device helpers shared by the port's tensor-core attention kernels
// (flash_fwd.cu, flash_bwd.cu) for Hopper (sm_90a): shared-memory
// addressing with an XOR swizzle, cp.async copies, ldmatrix and mma.sync
// wrappers, bf16 packing, the 3xTF32 split of float32 operands, and the
// warp-level products and row stores built from them.
//
// Everything here is a force-inlined device function or a constant in an
// unnamed namespace, so each source that includes it compiles its own
// copy into its own library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (r, c) in a row-major tile of D columns whose 16-byte
// chunks are XOR-swizzled by the row
template <typename T, int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int E = 16 / (int)sizeof(T);
  return r * D + (((c / E) ^ (r & 7)) * E) + (c % E);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a (rows, D) matrix into a swizzled tile, 16
// bytes a copy; rows at or past `limit` are zero-filled (source clamped)
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int limit) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int CPR = D / E;  // chunks a row
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * E;
    const bool in = r0 + r < limit;
    const T* from = src + (in ? (size_t)(r0 + r) * D + c : 0);
    cp_async16(smem_u32(dst + swz<T, D>(r, c)), from, in);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 to nearest, ties away from zero: the bits of
// cvt.rna.tf32.f32 for finite x, in two integer operations (the cvt
// instruction costs more on this card)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both tf32, each rounded to nearest
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// c += a b in float32 by three tf32 products (the small terms first)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[j] += A[a0 : a0 + 16, :] . B[8 j : 8 j + 8, :]^T for j < NT, the
// warp's 16 x (8 NT) tile of a product over all D columns of two swizzled
// row-major tiles
template <typename T, int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const T* A,
                                        int a0, const T* B, int lane) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(A + swz<T, D>(a0 + (lane & 15),
                                        kk * 16 + (lane >> 4) * 8)));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];  // n tiles j (b[0], b[1]) and j + 1 (b[2], b[3])
        ldsm_x4(b, smem_u32(B + swz<T, D>(8 * j + (lane & 7) +
                                              ((lane >> 4) << 3),
                                          kk * 16 + ((lane >> 3) & 1) * 8)));
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    // fully unrolled at D = 128 the dk/dv instantiation spills registers
    constexpr int kUnroll = D == 128 ? 4 : D / 8;
#pragma unroll(kUnroll)
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = kk * 8 + t;
      const float a[4] = {A[swz<T, D>(a0 + g, c)], A[swz<T, D>(a0 + g + 8, c)],
                          A[swz<T, D>(a0 + g, c + 4)],
                          A[swz<T, D>(a0 + g + 8, c + 4)]};
      uint32_t ah[4], al[4];
      split_tf32(a, ah, al);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float b[2] = {B[swz<T, D>(8 * j + g, c)],
                            B[swz<T, D>(8 * j + g, c + 4)]};
        uint32_t bh[2], bl[2];
        split_tf32(b, bh, bl);
        mma_3xtf32(acc[j], ah, al, bh, bl);
      }
    }
  }
}

// out[n] += P . B[0 : 8 NK, 8 n : 8 n + 8] for n < D / 8: P is the warp's
// float32 accumulator tile (16 rows x 8 NK columns), fed back as the A
// operand (bf16: rounded to nearest; float32: split into tf32 hi and lo,
// with B's k rows permuted to the accumulator's column order); B a
// swizzled row-major tile read along its rows
template <typename T, int D, int NK>
__device__ __forceinline__ void mma_pb(float (&out)[D / 8][4],
                                       const float (&P)[NK][4], const T* B,
                                       int lane) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int m = 0; m < NK / 2; ++m) {
      const uint32_t a[4] = {
          pack_bf16(P[2 * m][0], P[2 * m][1]),
          pack_bf16(P[2 * m][2], P[2 * m][3]),
          pack_bf16(P[2 * m + 1][0], P[2 * m + 1][1]),
          pack_bf16(P[2 * m + 1][2], P[2 * m + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t b[4];  // n tiles 2n (b[0], b[1]) and 2n + 1 (b[2], b[3])
        ldsm_x4_t(b, smem_u32(B + swz<T, D>(m * 16 + (lane & 7) +
                                                ((lane >> 3) & 1) * 8,
                                            n * 16 + (lane >> 4) * 8)));
        mma_bf16(out[2 * n], a, b[0], b[1]);
        mma_bf16(out[2 * n + 1], a, b[2], b[3]);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < NK; ++m) {
      // fragment column t holds accumulator column 2t, column t + 4 holds
      // 2t + 1
      const float a[4] = {P[m][0], P[m][2], P[m][1], P[m][3]};
      uint32_t ah[4], al[4];
      split_tf32(a, ah, al);
      const int r = m * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float b[2] = {B[swz<T, D>(r, n * 8 + g)],
                            B[swz<T, D>(r + 1, n * 8 + g)]};
        uint32_t bh[2], bl[2];
        split_tf32(b, bh, bl);
        mma_3xtf32(out[n], ah, al, bh, bl);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// the warp's 16 accumulator rows (r0 + g, r0 + g + 8) times `mul` into
// rows of a (rows, D) matrix; rows at or past `limit` are not written
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 8][4],
                                           int r0, int limit, float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= limit) continue;
    T* row = out + (size_t)r * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<T>(row + n * 8 + 2 * t, acc[n][2 * h] * mul,
                acc[n][2 * h + 1] * mul);
  }
}

}  // namespace
