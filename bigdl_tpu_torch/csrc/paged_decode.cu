// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (bigdl_tpu/ops/paged_attention.py:34, launched by
// `paged_decode_attention` :65).  It computes what that kernel computes:
// for each slot s and head h, one query row attends the slot's keys at
// positions 0..pos[s], read in place from the (N, H, block_len, D) arenas
// through the slot's row of the block table: float32 q . k divided by
// sqrt(D), softmax, float32 w . v, output float32 for float32 and bf16
// arenas alike.
//
// What bounds it on this card: decode attention does 4 D operations for
// every 2 D elements of K/V it reads, far below the ~20 float32 FLOP per
// byte where the H100 stops being bound by memory, so it is bound by the
// bytes of the live K/V rows: at the served shapes a few MB, a few
// microseconds at 3.35 TB/s.  Reaching that needs many loads in flight
// across the whole card, not one block walking a long context.
//
// Design (split across the context).  The TPU kernel copies the slot's
// whole M * block_len context into VMEM and attends once at the last grid
// column.  Here each (slot, head) is split into chunks of C keys (C a
// multiple of block_len: chunk_blocks table entries), one thread block a
// chunk, on a grid of (H, S, n_split):
//
// - A block whose chunk starts past pos[s] returns at once.  No block
//   reads a K/V row past pos[s], nor the scratch block that pads the
//   table; a chunk reads its table entries once.
// - The chunk's V rows are copied into shared memory by `cp.async` (16
//   bytes a copy) while the scores are computed, so the two reads of K
//   and V overlap.
// - Scores: 4 lanes a key, each dotting D/4 elements of the row in 16-byte
//   vector loads (4 floats or 8 bf16) against q held in registers; the 4
//   lanes' vectors interleave so each load instruction reads whole 64-byte
//   pieces of 8 rows.  Two shuffles finish a dot.
// - One warp takes the chunk's max m and p = exp(s - m) with their sum l;
//   then every thread accumulates a 16-byte column slice of p . V over a
//   strided subset of the rows, and the slices' partial sums add up in a
//   fixed order.  The chunk writes (m, l, acc[D]) to a float32 workspace
//   of (S, H, n_split, D + 2), allocated by the caller.
// - A second kernel, on the same stream and behind the same C entry
//   point, merges each (slot, head)'s live chunks in chunk order:
//   M = max m_c, L = sum l_c exp(m_c - M), o = sum acc_c exp(m_c - M) / L.
//
// No atomics: every sum runs in a fixed order, so results are bitwise
// repeatable.
#include "sm90_mma.cuh"

namespace {

constexpr int LPK = 4;              // lanes a key in the score pass
constexpr int KPP = THREADS / LPK;  // keys a score pass
constexpr float NEG = -1e30f;

// 16 bytes at p (global or shared) as float32
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 pair =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = pair.x;
    f[2 * i + 1] = pair.y;
  }
}

// table entries a chunk: the same in both kernels
__device__ __forceinline__ int chunk_blocks(int M, int n_split) {
  return (M + n_split - 1) / n_split;
}

// rows the value pass reads at once: the threads over the vectors a row
template <typename T, int D>
__host__ __device__ constexpr int value_groups() {
  return THREADS / (D * (int)sizeof(T) / 16);
}

template <typename T, int D>
size_t chunk_smem_bytes(int C, int cb) {
  // V rows; scores; the value pass's partial sums; the chunk's block ids
  return sizeof(T) * (size_t)C * D +
         sizeof(float) * ((size_t)C + (size_t)value_groups<T, D>() * D) +
         sizeof(int) * (size_t)cb;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_chunk_kernel(const float* __restrict__ q, const T* __restrict__ ka,
                   const T* __restrict__ va, const int* __restrict__ tables,
                   const int* __restrict__ pos, float* __restrict__ ws, int H,
                   int blen, int M, int n_split) {
  constexpr int E = 16 / (int)sizeof(T);  // elements of a 16-byte vector
  constexpr int VPR = D / E;              // vectors a row
  constexpr int KG = value_groups<T, D>();
  constexpr int VPL = VPR / LPK;          // vectors a lane dots a key
  static_assert(VPR % LPK == 0 && THREADS % VPR == 0 && D <= THREADS, "");
  extern __shared__ __align__(16) unsigned char smem[];

  const int h = blockIdx.x, s = blockIdx.y, c = blockIdx.z;
  const int cb = chunk_blocks(M, n_split);
  const int C = cb * blen;
  const int n = min(pos[s] + 1, M * blen);  // live keys of this slot
  const int k0 = c * C;
  if (k0 >= n) return;                       // the chunk starts past pos[s]
  const int nk = min(C, n - k0);             // live keys of this chunk

  T* Vs = reinterpret_cast<T*>(smem);              // C x D
  float* sc = reinterpret_cast<float*>(Vs + (size_t)C * D);  // C
  float* red = sc + C;                                        // KG x D
  int* bid = reinterpret_cast<int*>(red + KG * D);            // cb
  const int tid = threadIdx.x;

  const int* tbl = tables + (size_t)s * M + (size_t)c * cb;
  for (int i = tid; i < (nk + blen - 1) / blen; i += THREADS) bid[i] = tbl[i];
  __syncthreads();
  auto row = [&](const T* arena, int r) {  // chunk row r < nk
    return arena + (((size_t)bid[r / blen] * H + h) * blen + r % blen) * D;
  };

  // V rows into shared memory, in flight during the score pass
  for (int idx = tid; idx < nk * VPR; idx += THREADS) {
    const int r = idx / VPR, vc = idx % VPR;
    cp_async16(smem_u32(Vs + r * D + vc * E), row(va, r) + vc * E, true);
  }
  cp_async_commit();

  // scores: lane `part` of a key dots the row's vectors part, part + 4, ...
  const int part = tid % LPK, kl = tid / LPK;
  float qr[VPL][E];
  const float* qrow = q + ((size_t)s * H + h) * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) qr[i][e] = qrow[(i * LPK + part) * E + e];
  const float sqrt_d = sqrtf((float)D);
  for (int base = 0; base < nk; base += 2 * KPP) {
    float dot[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = base + u * KPP + kl;
      if (r < nk) {
        const T* kr = row(ka, r);
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          float f[E];
          load16(kr + (i * LPK + part) * E, f);
#pragma unroll
          for (int e = 0; e < E; ++e) dot[u] = fmaf(qr[i][e], f[e], dot[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], 1);
      dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], 2);
      const int r = base + u * KPP + kl;
      if (part == 0 && r < nk) sc[r] = dot[u] / sqrt_d;
    }
  }
  __syncthreads();

  // the chunk's max, probabilities and their sum, by one warp
  float* w = ws + (((size_t)s * H + h) * n_split + c) * (D + 2);
  if (tid < 32) {
    float mx = NEG;
    for (int r = tid; r < nk; r += 32) mx = fmaxf(mx, sc[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int r = tid; r < nk; r += 32) {
      const float p = expf(sc[r] - mx);
      sc[r] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (tid == 0) {
      w[0] = mx;
      w[1] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // p . V: thread (kg, vc) sums column slice vc over rows kg, kg + KG, ...
  const int vc = tid % VPR, kg = tid / VPR;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int r = kg; r < nk; r += KG) {
    const float p = sc[r];
    float f[E];
    load16(Vs + r * D + vc * E, f);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(p, f[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) red[kg * D + vc * E + e] = acc[e];
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < KG; ++i) o += red[i * D + tid];
    w[2 + tid] = o;
  }
}

template <int D>
__global__ void __launch_bounds__(D)
paged_combine_kernel(const float* __restrict__ ws, const int* __restrict__ pos,
                     float* __restrict__ out, int H, int blen, int M,
                     int n_split) {
  const int h = blockIdx.x, s = blockIdx.y, d = threadIdx.x;
  const int C = chunk_blocks(M, n_split) * blen;
  const int n = min(pos[s] + 1, M * blen);
  const int live = n > 0 ? (n - 1) / C + 1 : 0;
  const float* w = ws + ((size_t)s * H + h) * n_split * (D + 2);
  float mx = NEG;
  for (int c = 0; c < live; ++c) mx = fmaxf(mx, w[c * (D + 2)]);
  float lt = 0.f, o = 0.f;
  for (int c = 0; c < live; ++c) {
    const float f = expf(w[c * (D + 2)] - mx);
    lt = fmaf(w[c * (D + 2) + 1], f, lt);
    o = fmaf(w[c * (D + 2) + 2 + d], f, o);
  }
  out[((size_t)s * H + h) * D + d] = o / (lt == 0.f ? 1.f : lt);
}

template <typename T, int D>
int launch(const void* q, const void* ka, const void* va, const int* tables,
           const int* pos, float* out, float* ws, int S, int H, int blen,
           int M, int n_split, cudaStream_t stream) {
  const int cb = (M + n_split - 1) / n_split;
  const size_t smem = chunk_smem_bytes<T, D>(cb * blen, cb);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_chunk_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_chunk_kernel<T, D><<<dim3(H, S, n_split), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(ka),
      static_cast<const T*>(va), tables, pos, ws, H, blen, M, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<D><<<dim3(H, S), D, 0, stream>>>(ws, pos, out, H, blen,
                                                        M, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (S, H, D) float32; k/v arenas: (N, H, blen, D) float32 or bf16, 16-byte
// aligned; tables: (S, M) int32 block ids; pos: (S,) int32; out: (S, H, D)
// float32; ws: (S, H, n_split, D + 2) float32 scratch; all contiguous on
// the device.  Each (slot, head) is split into n_split chunks of
// ceil(M / n_split) table entries.  dtype 0 = float32 arenas,
// 1 = bfloat16.  Enqueues the chunk kernel and the combine kernel on
// `stream`; returns cudaGetLastError().
int bigdl_paged_decode(const void* q, const void* k_arena, const void* v_arena,
                       const void* tables, const void* pos, void* out,
                       void* ws, int S, int H, int blen, int D, int M,
                       int n_split, int dtype, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > M) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k_arena, v_arena, tb, ps, o, w, S, H, blen, M, n_split, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k_arena, v_arena, tb, ps, o, w, S, H, blen, M, n_split, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_arena, v_arena, tb, ps, o, w, S, H, blen, M, n_split, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_arena, v_arena, tb, ps, o, w, S, H, blen, M, n_split, st);
  return (int)cudaErrorInvalidValue;
}

const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
