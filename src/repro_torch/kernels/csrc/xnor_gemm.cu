// XNOR-popcount GEMM of the port (B4), for sm_90a, on the tensor cores.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   xnor_gemm  <- repro/kernels/xnor_gemm.py  xnor_gemm_pallas / _xnor_kernel
//
// out(M, N) = A(M, K) @ W(K, N) over operands in {-1, 0, +1} (0 = padding),
// float32 or bfloat16, float32 out, optionally re-binarized with an explicit
// tie sign for acc == 0 (binarize_acc).  -1, 0 and +1 are exact in bf16,
// every product is exact, and every partial sum is an integer below 2^24,
// so float32 accumulation is exact in any order: the result is bit-equal to
// the plain version's float32 product whatever the tiling or split.
//
// What bounds it on an H100: bytes.  At the model path's M = 128 the
// product is 2 M K N operations against 989e12 bf16 tensor-core operations
// per second, while W alone is 4 K N bytes (float32) against 3.35 TB/s: at
// the unembed (896 x 151,936) 545 MB of W take 0.163 ms, the tensor-core
// work 0.035 ms.  So the kernel has to keep HBM busy.
//
// Design.
// * Block tile 128 x 256 x 32, 256 threads = 8 warps of 64 x 64, each a
//   4 x 8 grid of mma.sync m16n8k16 bf16 -> f32.
// * A ring of STAGES shared-memory stages filled by 16-byte cp.async.cg
//   (zero-filling beyond M, the K chunk and N).  The ring is thread-private:
//   each thread converts only the chunks it copied itself, so it needs no
//   barrier; it converts them (float32 -> bf16, or copies bf16) into one of
//   two bf16 tiles laid out for ldmatrix (A row-major, W K-major read with
//   ldmatrix.trans), and one barrier per K step guards that double buffer.
//   The loads of step k + 2 overlap the conversion and MMAs of step k.
//   Shapes whose rows are not 16-byte multiples (or unaligned pointers)
//   take guarded element loads into the same ring instead.
// * Deterministic split-K for grids under one wave: blockIdx.z sums the
//   z-th of `splits` contiguous K chunks (whole BK steps) into float32
//   partials; reduce_kernel, a programmatic dependent launch, adds them in
//   split order and binarizes after the full sum.  The wrapper picks
//   `splits` (kernels/analog_mac.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_k.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int AH_LD = BK + 8;   // bf16 A tile row: 80 bytes, ldmatrix conflict-free
constexpr int BH_LD = BN + 8;   // bf16 W tile row: 528 bytes
constexpr int AH_TILE = BM * AH_LD;
constexpr int BH_TILE = BK * BH_LD;
constexpr int BF16_BYTES = 2 * (AH_TILE + BH_TILE) * 2;   // double buffer

template <typename T>
__host__ __device__ constexpr int ring_stage_bytes() {
  return (BM * BK + BK * BN) * (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * ring_stage_bytes<T>() + BF16_BYTES;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// One 16-byte ring chunk -> bf16 at dst (8 bytes from float32, 16 from bf16).
__device__ __forceinline__ void to_bf16(__nv_bfloat16* dst, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(x.x, x.y),
                                              pack_bf16(x.z, x.w));
}
__device__ __forceinline__ void to_bf16(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ float sign_tie(float y, float tie) {
  return y == 0.0f ? tie : (y > 0.0f ? 1.0f : -1.0f);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    xnor_kernel(const T* __restrict__ a, const T* __restrict__ w,
                float* __restrict__ out, float* __restrict__ ws, int M, int K,
                int N, int splits, int binarize, float tie) {
  constexpr int E = 16 / (int)sizeof(T);               // elements per chunk
  constexpr int A_CHUNKS = BM * BK / E / THREADS;       // per thread
  constexpr int B_CHUNKS = BK * BN / E / THREADS;
  constexpr int RING = ring_stage_bytes<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* bf = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * RING);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  int k_lo, k_hi;
  k_range<BK>(K, splits, blockIdx.z, k_lo, k_hi);
  const int nk = (k_hi - k_lo + BK - 1) / BK;
  launch_dependents();

  // chunk e = tid + THREADS i of a stage: A row e / (BK/E), W row e / (BN/E)
  auto load_stage = [&](int slot, int k0) {
    T* ar = reinterpret_cast<T*>(smem + slot * RING);
    T* br = ar + BM * BK;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BK / E), c = (e % (BK / E)) * E;
      const int gm = m0 + r, gk = k0 + c;
      if (VEC) {
        const bool ok = gm < M && gk < k_hi;
        cp_async16(ar + e * E, ok ? a + (size_t)gm * K + gk : a, ok);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j)
          ar[e * E + j] = (gm < M && gk + j < k_hi) ? a[(size_t)gm * K + gk + j]
                                                    : zero<T>();
      }
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BN / E), c = (e % (BN / E)) * E;
      const int gk = k0 + r, gn = n0 + c;
      if (VEC) {
        const bool ok = gk < k_hi && gn < N;
        cp_async16(br + e * E, ok ? w + (size_t)gk * N + gn : w, ok);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j)
          br[e * E + j] = (gk < k_hi && gn + j < N) ? w[(size_t)gk * N + gn + j]
                                                    : zero<T>();
      }
    }
  };

  auto convert = [&](int slot, int buf) {
    const T* ar = reinterpret_cast<const T*>(smem + slot * RING);
    const T* br = ar + BM * BK;
    __nv_bfloat16* ah = bf + buf * (AH_TILE + BH_TILE);
    __nv_bfloat16* bh = ah + AH_TILE;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BK / E), c = (e % (BK / E)) * E;
      to_bf16(ah + r * AH_LD + c, ar + e * E);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BN / E), c = (e % (BN / E)) * E;
      to_bf16(bh + r * BH_LD + c, br + e * E);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64;   // warp's rows in the block tile
  const int wn = (warp % 4) * 64;   // warp's columns
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, k_lo + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    const int buf = kt & 1;
    convert(kt % STAGES, buf);
    const int nt = kt + STAGES - 1;
    if (nt < nk) load_stage(nt % STAGES, k_lo + nt * BK);
    cp_async_commit();
    __syncthreads();
    const __nv_bfloat16* ah = bf + buf * (AH_TILE + BH_TILE);
    const __nv_bfloat16* bh = ah + AH_TILE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], ah + (wm + i * 16 + lane % 16) * AH_LD + ks +
                               (lane / 16) * 8);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bh + (ks + lane % 8 + ((lane / 8) % 2) * 8) * BH_LD +
                                 wn + jj * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool split = splits > 1;
  float* dst = split ? ws + (size_t)blockIdx.z * M * N : out;
  const bool pairs = (N % 2) == 0;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm + i * 16 + g + 8 * h;
      if (gm >= M) continue;
      float* row = dst + (size_t)gm * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gn = n0 + wn + j * 8 + 2 * t;
        float y0 = acc[i][j][2 * h], y1 = acc[i][j][2 * h + 1];
        if (!split && binarize) {
          y0 = sign_tie(y0, tie);
          y1 = sign_tie(y1, tie);
        }
        if (pairs && gn + 1 < N) {
          *reinterpret_cast<float2*>(&row[gn]) = make_float2(y0, y1);
        } else {
          if (gn < N) row[gn] = y0;
          if (gn + 1 < N) row[gn + 1] = y1;
        }
      }
    }
}

// Split-K second pass: integer partials added in split order (exact), then
// the optional binarize.
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int M,
                  int N, int splits, int binarize, float tie) {
  const size_t mn = (size_t)M * N;
  wait_for_mainloop();
  for (size_t e = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x; e < mn;
       e += (size_t)gridDim.x * REDUCE_THREADS) {
    const float y = sum_partials(ws, mn, e, splits);
    out[e] = binarize ? sign_tie(y, tie) : y;
  }
}

template <typename T, bool VEC>
int launch(const void* a, const void* w, float* out, float* ws, int M, int K,
           int N, int splits, int binarize, float tie, cudaStream_t s) {
  constexpr int smem = smem_bytes<T>();
  static uint64_t done = 0;
  auto* kernel = xnor_kernel<T, VEC>;
  cudaError_t err = allow_smem(kernel, smem, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
                  (unsigned)splits);
  kernel<<<grid, THREADS, smem, s>>>((const T*)a, (const T*)w, out, ws, M, K, N,
                                     splits, binarize, tie);
  if (splits > 1) {
    err = launch_reduce(reduce_kernel, M, N, s, (const float*)ws, out, M, N,
                        splits, binarize, tie);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile geometry (0: BM, 1: BN, 2: BK), read once by kernels/analog_mac.py.
int xnor_gemm_tile(int dim) { return dim == 0 ? BM : dim == 1 ? BN : BK; }

int xnor_gemm_launch(const void* a, const void* w, float* out, float* ws,
                     int M, int K, int N, int splits, int vec, int bf16,
                     int binarize, int tie, int device, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float t = (float)tie;
  return on_device(device, [&] {
    if (bf16)
      return vec ? launch<__nv_bfloat16, true>(a, w, out, ws, M, K, N, splits,
                                               binarize, t, s)
                 : launch<__nv_bfloat16, false>(a, w, out, ws, M, K, N, splits,
                                                binarize, t, s);
    return vec ? launch<float, true>(a, w, out, ws, M, K, N, splits, binarize,
                                     t, s)
               : launch<float, false>(a, w, out, ws, M, K, N, splits, binarize,
                                      t, s);
  });
}

}  // extern "C"
