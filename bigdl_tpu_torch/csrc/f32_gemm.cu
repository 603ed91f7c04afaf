// Float32 matrix product C = A B on Hopper's tensor cores (sm_90a),
// hand-written CUDA C++, by the 3xTF32 split.
//
// It replaces no TPU kernel: the JAX package leaves its weight products to
// XLA (`jnp.matmul`).  It takes the place of cuBLAS's float32 GEMM, which
// runs on the CUDA cores (67 TFLOP/s on an H100), for the TransformerLM's
// weight products: the projections, the MLP halves and the LM head, in the
// forward pass and in both products of the backward pass.
//
// Arithmetic.  Each float32 operand x is split into two TF32 values,
// hi = rna(x) and lo = rna(x - hi) (`split_tf32`), and each k-step adds
// lo*hi, hi*lo and then hi*hi into float32 accumulators (the order of
// `mma_3xtf32`); lo*lo is below float32's rounding.  The tensor cores add
// into their accumulators with truncation, an error that grows with the
// length of the sum (float64 error over |A||B| 1.1e-5 at K = 32,768, 1.5e-6
// at 768 on an H100), so each K tile of 32 starts a fresh accumulator and
// the tiles' sums are added in float32, rounded to nearest.  The split happens in
// registers and shared memory: no hi or lo copy of an operand is kept in
// device memory.  Nothing is summed by atomics: a split of K writes its
// partial product to a workspace, and a second kernel adds the partials in
// split order, so two identical calls give identical bits.
//
// What bounds it on this card.  At the training shapes (32,768 rows) the
// product does 2 K operations for every element of C: it is bound by the
// tensor cores, 165 TFLOP/s for three TF32 passes.  At decode (64 rows) it
// reads every weight once for 384 operations per 4 bytes: GPT-2 XL's 6.2
// GB of weights take 1.86 ms at 3.35 TB/s, and the operations about as
// long, so decode wants both a card full of loads in flight and the tensor
// cores busy.
//
// Design.  Two kernels share the loads, the layouts and the split of K:
// - Many rows (tile 0, `f32_gemm_wg_kernel`): two warpgroups own a 128 x
//   128 tile, 64 rows each, through `wgmma.m64n128k8` with A from
//   registers and B from shared memory.  wgmma takes TF32 only K-major, so
//   per K tile all threads split the raw B tile into hi and lo tiles,
//   K-major with the 128-byte swizzle (two buffers: one tile is split
//   while the products of the one before run), and each warp splits its A
//   fragments in registers after the products before are done with them.
// - Few rows (tile 1, `f32_gemm_kernel`): 64 x 128 tiles, four warps of
//   `mma.sync.m16n8k8` that read fragments of any layout from shared
//   memory and split them in registers; two blocks an SM.  At decode it is
//   faster than the warpgroup kernel, which would compute 64 rows of
//   padding or leave a block of one warpgroup to split its B alone.
// - Raw tiles arrive in a ring of STAGES by `cp.async`, each in its global
//   layout, rows padded so that fragment reads fall in distinct banks.  The
//   layouts are template parameters: A with K contiguous (activations) or
//   M contiguous (the weight gradient's X^T, read in place), B with N
//   contiguous (an (in, out) weight) or K contiguous (a transposed weight,
//   the tied head's embedding).  Rows that are not 16-byte aligned (the
//   vocabulary's 50,257 floats) and every ragged edge load by 4-byte
//   copies with zero fill; the wrapper says per operand whether 16-byte
//   copies are safe.
// - Few output tiles (decode, the weight gradients) split K over
//   `gridDim.y`; the wrapper picks the tile and the split from (M, N, K).
//   Tiles are walked in groups of 8 tile rows, so a wave of blocks shares
//   its A rows and B columns in L2.
#include <atomic>

#include "sm90_mma.cuh"

namespace {

constexpr int GROUP_M = 8;  // tile rows walked together
constexpr int BK = 32;      // K columns a stage

// What one launch computes: C[m0 : m0 + BM, n0 : n0 + BN] (+ a split's
// offset) from A (M x K) and B (K x N) over K columns [k_begin, k_begin +
// k_per_split).  A_KC: element (m, k) of A at m lda + k, else at k lda + m.
// B_NC: (k, n) of B at k ldb + n, else at n ldb + k.  C's rows are ldc
// floats apart.  vec_*: 16-byte copies (A, B) or 8-byte stores (C) are safe.
struct Args {
  const float* A;
  const float* B;
  float* C;
  int M, N, K;
  long long lda, ldb, ldc, c_split_stride;
  int k_per_split, vec_a, vec_b, vec_c;
};

// One operand's tile in shared memory: ROWS x COLS floats, COLS contiguous
// as in device memory, rows LD floats apart.  A row along K (COLS = BK)
// is padded by 4 floats, a row along M or N (COLS a multiple of 32) by 8:
// either way the 8 x 4 fragment reads of a warp hit 32 distinct banks.
template <int ROWS, int COLS>
struct Smem {
  static constexpr int LD = COLS + (COLS % 32 == 0 && COLS > 32 ? 8 : 4);
  static constexpr int FLOATS = ROWS * LD;
};

// the raw A and B tiles of a BM x BN x BK stage, in their layouts
template <int BM, int BN, bool A_KC, bool B_NC>
struct Raw {
  using SA = Smem<A_KC ? BM : BK, A_KC ? BK : BM>;
  using SB = Smem<B_NC ? BK : BN, B_NC ? BN : BK>;
  static constexpr int FLOATS = SA::FLOATS + SB::FLOATS;
};

// rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a matrix whose rows
// are `ld` floats apart into a tile; elements at or past (rlim, clim) are
// zero-filled.  `vec`: rows and base are 16-byte aligned, so whole chunks
// of 4 go as one copy
template <int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld, int r0, int c0,
                                          int rlim, int clim, bool vec) {
  constexpr int LD = Smem<ROWS, COLS>::LD;
  constexpr int CPR = COLS / 4;  // 16-byte chunks a row
  constexpr int CHUNKS = ROWS * CPR;
  static_assert(CHUNKS % NTHREADS == 0, "tile chunks per thread");
#pragma unroll
  for (int i = 0; i < CHUNKS / NTHREADS; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int r = idx / CPR, c = (idx % CPR) * 4;
    const int gr = r0 + r, gc = c0 + c;
    const bool rin = gr < rlim;
    const float* row = src + (rin ? (long long)gr * ld : 0);
    const uint32_t d = smem_u32(dst + r * LD + c);
    if (vec && gc + 4 <= clim) {
      cp_async16(d, row + gc, rin);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = rin && gc + e < clim;
        cp_async4(d + 4 * e, in ? row + gc + e : src, in);
      }
    }
  }
}

// The block's place in C and its K range, and the stage loads, fragment
// reads and stores both kernels share
template <int BM, int BN, int NTHREADS, bool A_KC, bool B_NC>
struct Block {
  using R = Raw<BM, BN, A_KC, B_NC>;
  const Args& g;
  int m0, n0, k_begin, k_end, ktiles;

  __device__ __forceinline__ explicit Block(const Args& args) : g(args) {
    const int tiles_m = (g.M + BM - 1) / BM;
    const int tiles_n = (g.N + BN - 1) / BN;
    const int per_group = GROUP_M * tiles_n;
    const int first_m = (blockIdx.x / per_group) * GROUP_M;
    const int rows_in_group = min(tiles_m - first_m, GROUP_M);
    const int in_group = blockIdx.x % per_group;
    m0 = (first_m + in_group % rows_in_group) * BM;
    n0 = (in_group / rows_in_group) * BN;
    k_begin = blockIdx.y * g.k_per_split;
    k_end = min(g.K, k_begin + g.k_per_split);
    ktiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  }

  // K tile kt into a raw slot of R::FLOATS floats; columns of K at or past
  // k_end (another split's) are zero-filled
  __device__ __forceinline__ void load(float* raw, int kt) const {
    const int k0 = k_begin + kt * BK;
    float* as = raw;
    float* bs = raw + R::SA::FLOATS;
    if constexpr (A_KC)
      load_tile<BM, BK, NTHREADS>(as, g.A, g.lda, m0, k0, g.M, k_end,
                                  g.vec_a);
    else
      load_tile<BK, BM, NTHREADS>(as, g.A, g.lda, k0, m0, k_end, g.M,
                                  g.vec_a);
    if constexpr (B_NC)
      load_tile<BK, BN, NTHREADS>(bs, g.B, g.ldb, k0, n0, k_end, g.N,
                                  g.vec_b);
    else
      load_tile<BN, BK, NTHREADS>(bs, g.B, g.ldb, n0, k0, g.N, k_end,
                                  g.vec_b);
  }

  // element (r, k) of a raw slot's A tile, r a row of the block's tile
  __device__ __forceinline__ static float a_at(const float* raw, int r,
                                               int k) {
    return A_KC ? raw[r * R::SA::LD + k] : raw[k * R::SA::LD + r];
  }
  // element (k, n) of a raw slot's B tile
  __device__ __forceinline__ static const float& b_at(const float* raw,
                                                      int k, int n) {
    const float* bs = raw + R::SA::FLOATS;
    return B_NC ? bs[k * R::SB::LD + n] : bs[n * R::SB::LD + k];
  }

  // an accumulator quad: C (or this split's part of the workspace) at rows
  // r and r + 8, columns c and c + 1
  __device__ __forceinline__ void store(int r, int c, float v0, float v1,
                                        float v2, float v3) const {
    float* out = g.C + blockIdx.y * g.c_split_stride;
    const float v[4] = {v0, v1, v2, v3};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      if (rr >= g.M) continue;
      float* row = out + (long long)rr * g.ldc;
      if (g.vec_c && c + 1 < g.N) {
        *reinterpret_cast<float2*>(row + c) =
            make_float2(v[2 * h], v[2 * h + 1]);
      } else {
        if (c < g.N) row[c] = v[2 * h];
        if (c + 1 < g.N) row[c + 1] = v[2 * h + 1];
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Tile 1: mma.sync, 64 x 128, four warps of 32 x 64
namespace sync_tile {
constexpr int BM = 64, BN = 128, WN = 2, STAGES = 4, NTHREADS = 128;
constexpr int TM = 32, TN = 64, MT = TM / 16, NT = TN / 8;
constexpr int JC = 4;  // n tiles split at once
}  // namespace sync_tile

template <bool A_KC, bool B_NC>
__global__ void __launch_bounds__(sync_tile::NTHREADS, 2)
f32_gemm_kernel(const __grid_constant__ Args args) {
  using namespace sync_tile;
  using Blk = Block<BM, BN, NTHREADS, A_KC, B_NC>;
  extern __shared__ __align__(16) float smem[];
  const Blk blk(args);

  // acc: the tensor cores' sum over one K tile; total: the sum of the
  // tiles' sums, by float32 adds
  float acc[MT][NT][4], total[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = total[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < blk.ktiles) blk.load(smem + s * Blk::R::FLOATS, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / WN) * TM;  // the warp's rows in the tile
  const int wc = (warp % WN) * TN;  // and its columns

  for (int kt = 0; kt < blk.ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free to refill
    const int next = kt + STAGES - 1;
    if (next < blk.ktiles)
      blk.load(smem + (next % STAGES) * Blk::R::FLOATS, next);
    cp_async_commit();

    const float* raw = smem + (kt % STAGES) * Blk::R::FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wr + i * 16 + g;
        const float a[4] = {Blk::a_at(raw, r, kk + t),
                            Blk::a_at(raw, r + 8, kk + t),
                            Blk::a_at(raw, r, kk + t + 4),
                            Blk::a_at(raw, r + 8, kk + t + 4)};
        split_tf32(a, ah[i], al[i]);
      }
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += JC) {
        uint32_t bh[JC][2], bl[JC][2];
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          const int c = wc + (j0 + j) * 8 + g;
          const float b[2] = {Blk::b_at(raw, kk + t, c),
                              Blk::b_at(raw, kk + t + 4, c)};
          split_tf32(b, bh[j], bl[j]);
        }
        // lo hi, hi lo, then hi hi into each accumulator, each pass over
        // every tile, so dependent products are a pass apart
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < JC; ++j)
            mma_tf32(acc[i][j0 + j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < JC; ++j)
            mma_tf32(acc[i][j0 + j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < JC; ++j)
            mma_tf32(acc[i][j0 + j], ah[i], bh[j][0], bh[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          total[i][j][e] += acc[i][j][e];
          acc[i][j][e] = 0.f;
        }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      blk.store(blk.m0 + wr + i * 16 + g, blk.n0 + wc + j * 8 + 2 * t,
                total[i][j][0], total[i][j][1], total[i][j][2],
                total[i][j][3]);
}

// ---------------------------------------------------------------------------
// Tile 0: wgmma, 128 x 128, two warpgroups of 64 x 128
namespace wg_tile {
constexpr int BM = 128, BN = 128, STAGES = 4, NTHREADS = 256;
constexpr int BC_BYTES = BN * BK * 4;  // one split (hi or lo) B tile
}  // namespace wg_tile

__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  // start address, leading offset 16 B (unused: k-steps stay inside the
  // 128-byte swizzle row), stride 1024 B between 8-row groups, 128-byte
  // swizzle
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// holds a value in its register at this point, for the compiler
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (64 rows x 128) = a (64 x 8, registers) b (8 x 128, shared memory),
// plus d unless `add` is 0
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}

template <bool A_KC, bool B_NC>
__global__ void __launch_bounds__(wg_tile::NTHREADS, 1)
f32_gemm_wg_kernel(const __grid_constant__ Args args) {
  using namespace wg_tile;
  using Blk = Block<BM, BN, NTHREADS, A_KC, B_NC>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // the split B tiles first, 1024-byte aligned for the swizzle: [buffer]
  // [hi, lo] of BC_BYTES each; then the raw ring
  unsigned char* base =
      wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  float* ring = reinterpret_cast<float*>(base + 4 * BC_BYTES);
  const Blk blk(args);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16;  // the warp's 16 rows

  if (blk.ktiles == 0) {  // an empty split of K adds zeros
#pragma unroll
    for (int j = 0; j < 16; ++j)
      blk.store(blk.m0 + wrow + g, blk.n0 + 8 * j + 2 * t, 0.f, 0.f, 0.f,
                0.f);
    return;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < blk.ktiles) blk.load(ring + s * Blk::R::FLOATS, s);
    cp_async_commit();
  }

  const uint32_t bc0 = smem_u32(base);
  // acc: the tensor cores' sum over one K tile; total: the sum of the
  // tiles' sums, by float32 adds.  No instruction but a wgmma writes acc
  // (each tile's first product overwrites it), and `keep` holds it in
  // place for the compiler: else ptxas serialises every wgmma
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = 0.f;

  for (int kt = 0; kt < blk.ktiles; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // raw tile kt landed; tile kt - 2's products are done
    const int next = kt + STAGES - 1;
    if (next < blk.ktiles)
      blk.load(ring + (next % STAGES) * Blk::R::FLOATS, next);
    cp_async_commit();

    // while tile kt - 1's products run: split B into the other buffer,
    // element (n, k) at byte (n / 8) 1024 + (n % 8) 128 + ((k / 4) ^ (n %
    // 8)) 16 + (k % 4) 4, and read this thread's A fragments
    const float* raw = ring + (kt % STAGES) * Blk::R::FLOATS;
    unsigned char* hi_tile = base + (2 * buf) * BC_BYTES;
#pragma unroll
    for (int i = 0; i < BN * (BK / 4) / NTHREADS; ++i) {
      const int idx = threadIdx.x + i * NTHREADS;
      const int n = idx % BN, kc = idx / BN;
      float v[4];
      if constexpr (B_NC) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = Blk::b_at(raw, 4 * kc + e, n);
      } else {  // one 16-byte read: 4 loads of a column would conflict
        const float4 x = *reinterpret_cast<const float4*>(
            &Blk::b_at(raw, 4 * kc, n));
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
      }
      uint32_t h[4], l[4];
      split_tf32(v, h, l);
      const int off = (n >> 3) * 1024 + (n & 7) * 128 + ((kc ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(hi_tile + off) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(hi_tile + BC_BYTES + off) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
    float a[4][4];  // rows wrow + g (+ 8), columns 8 s + t (+ 4)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[s][e] = Blk::a_at(raw, wrow + g + (e & 1) * 8,
                            8 * s + t + (e >> 1) * 4);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    wg_wait_all();  // tile kt - 1's products are done: its sum is in acc
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(acc[i]);
    if (kt > 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc[i];
    }
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) split_tf32(a[s], ah[s], al[s]);
    wg_fence();
    const uint32_t hi = bc0 + (2 * buf) * BC_BYTES, lo = hi + BC_BYTES;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // a k-step is 32 bytes along the swizzled 128-byte row
      wgmma_tf32(acc, al[s], wg_desc(hi + 32 * s), s > 0);
      wgmma_tf32(acc, ah[s], wg_desc(lo + 32 * s), 1);
      wgmma_tf32(acc, ah[s], wg_desc(hi + 32 * s), 1);
    }
    wg_commit();
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(acc[i]);
  }
  wg_wait_all();
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    keep(acc[i]);
    total[i] += acc[i];
  }
  cp_async_wait<0>();

  // accumulator quad j: rows wrow + g (+ 8), columns 8 j + 2 t (+ 1)
#pragma unroll
  for (int j = 0; j < 16; ++j)
    blk.store(blk.m0 + wrow + g, blk.n0 + 8 * j + 2 * t, total[4 * j],
              total[4 * j + 1], total[4 * j + 2], total[4 * j + 3]);
}

// C[i] = sum over s of ws[s][i], s in order, for the M N elements of C
__global__ void __launch_bounds__(256)
f32_gemm_reduce_kernel(const float* __restrict__ ws, float* __restrict__ C,
                       long long mn, int split) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if ((mn & 3) == 0) {
    const long long n4 = mn >> 2;
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    float4* c4 = reinterpret_cast<float4*>(C);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n4; i += stride) {
      float4 s = w4[i];
      for (int z = 1; z < split; ++z) {
        const float4 v = w4[z * n4 + i];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      c4[i] = s;
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < mn; i += stride) {
      float s = ws[i];
      for (int z = 1; z < split; ++z) s += ws[z * mn + i];
      C[i] = s;
    }
  }
}

// Grants `kernel` `smem` bytes of dynamic shared memory on the current
// device, once a device: `granted` holds a bit for each device done.
cudaError_t grant_smem(void (*kernel)(const Args), size_t smem,
                       std::atomic<unsigned long long>& granted) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (granted.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <bool A_KC, bool B_NC>
cudaError_t launch(int tile, const Args& args, int split,
                   cudaStream_t stream) {
  static std::atomic<unsigned long long> granted[2];
  void (*kernel)(const Args);
  size_t smem;
  int threads, bm, bn;
  if (tile == 0) {
    kernel = f32_gemm_wg_kernel<A_KC, B_NC>;
    smem = 1024 + 4 * wg_tile::BC_BYTES +
           sizeof(float) * wg_tile::STAGES *
               Raw<wg_tile::BM, wg_tile::BN, A_KC, B_NC>::FLOATS;
    threads = wg_tile::NTHREADS;
    bm = wg_tile::BM;
    bn = wg_tile::BN;
  } else {
    kernel = f32_gemm_kernel<A_KC, B_NC>;
    smem = sizeof(float) * sync_tile::STAGES *
           Raw<sync_tile::BM, sync_tile::BN, A_KC, B_NC>::FLOATS;
    threads = sync_tile::NTHREADS;
    bm = sync_tile::BM;
    bn = sync_tile::BN;
  }
  const cudaError_t err = grant_smem(kernel, smem, granted[tile != 0]);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (unsigned)((args.M + bm - 1) / bm) *
                         (unsigned)((args.N + bn - 1) / bn);
  kernel<<<dim3(tiles, split), threads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// C = A B for float32 A (M x K) and B (K x N), layouts as in `Args`; tile
// 0 is the 128 x 128 warpgroup kernel, tile 1 the 64 x 128 mma.sync one.
// With split > 1, C is the (split, M, ldc) workspace, `c_split_stride`
// floats a split, that bigdl_f32_gemm_reduce adds up; each split covers
// k_per_split columns of K (a multiple of 32).
int bigdl_f32_gemm(const float* A, const float* B, float* C, int M, int N,
                   int K, long long lda, long long ldb, long long ldc,
                   long long c_split_stride, int a_kc, int b_nc, int tile,
                   int split, int k_per_split, int vec_a, int vec_b,
                   int vec_c, void* stream) {
  const Args args{A,   B,   C,   M,   N,   K,     lda,   ldb,
                  ldc, c_split_stride, k_per_split, vec_a, vec_b, vec_c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_kc && b_nc) return launch<true, true>(tile, args, split, s);
  if (a_kc) return launch<true, false>(tile, args, split, s);
  if (b_nc) return launch<false, true>(tile, args, split, s);
  return launch<false, false>(tile, args, split, s);
}

// C (mn floats, contiguous) = the sum of the `split` partials of ws, in
// split order
int bigdl_f32_gemm_reduce(const float* ws, float* C, long long mn, int split,
                          void* stream) {
  const long long work = (mn & 3) == 0 ? mn >> 2 : mn;
  long long blocks = (work + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  f32_gemm_reduce_kernel<<<(unsigned)blocks, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(ws, C, mn,
                                                                split);
  return cudaGetLastError();
}

const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
