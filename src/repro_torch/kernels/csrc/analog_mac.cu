// The bit-line MAC with ADC (B3) of the port, for sm_90a.  The fused
// fake-analog MVM (B5, fake_analog.cu) and the XNOR GEMM (B4, xnor_gemm.cu)
// have sources of their own.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   bitline_mac  <- repro/kernels/bitline_mac.py  bitline_mac_pallas / _mac_kernel
//
// One float32 SIMT GEMM, out(M, N) = adc(A(M, K) @ G(K, N)), the epilogue the
// signed mid-tread ADC (adc_quantize) on i_max.
//
// What bounds it on an H100: 2 M K N float32 operations against 67 TFLOP/s.
// At the model path's M = 128 the widest shape (896 x 151,936) is ~35 GFLOP
// over ~0.6 GB, so operations bound it; the other shapes are bound by how
// many SMs their output tiles can keep busy.  IEEE float32 is owed (fmaf,
// -fmad=false, no TF32), so the tensor cores are out of reach.
//
// Design.
// * Block tile 128 x 128 x 16, 256 threads, an 8 x 8 register micro-tile
//   per thread (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise
//   with tx): A is staged K-major (As[k][m]), so a thread reads its
//   fragments as four 16-byte shared loads per 64 fmaf.  Two blocks per SM
//   (128 registers).
// * A ring of STAGES shared-memory stages filled by cp.async (16-byte
//   cp.async.cg for G rows when N % 4 == 0 and the pointer is aligned, else
//   4-byte copies; 4-byte copies transpose A into As), one barrier per K
//   step: the loads of step k + 3 overlap the fmaf of step k.  Shared
//   memory above 48 KB is dynamic.
// * Deterministic split-K: blockIdx.z takes the z-th of `splits` contiguous
//   K chunks (whole BK steps; chunk z = steps [z S / splits, (z+1) S /
//   splits)), sums it in K order and writes float32 partials to a workspace;
//   reduce_kernel adds the partials in split order and applies the
//   epilogue.  No atomics: every call is bit-reproducible.  The reduce grid
//   is a programmatic dependent launch, so its launch overlaps the
//   mainloop.  The wrapper picks `splits` from (M, N, K) and the SM count
//   (analog_mac.py): at most one wave, no empty chunk.  The fake-analog MVM
//   takes the same chunks and sums each output in the same order, so on
//   the same g_diff their raw currents are bit-equal (the reference's pin,
//   tests/test_analog_pipeline.py).
// * Edges are guarded, not padded: A rows beyond M and entries beyond the
//   chunk, G entries beyond the chunk or N, load as 0 (zero-filling
//   cp.async).
// Built with -fmad=false and without fast math, so the ADC's products and
// divisions round one by one, as the plain PyTorch version's separate
// operations do; rintf rounds half to even like jnp.round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "analog_common.cuh"
#include "split_k.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int A_LD = BM + 4;                        // As[k][m] row, floats
constexpr int A_TILE = BK * A_LD;
constexpr int B_TILE = BK * BN;
constexpr int STAGE = A_TILE + B_TILE;
constexpr int A_PER_THREAD = BM * BK / THREADS;     // 8 four-byte copies
constexpr int B_COLS4 = BN / 4;                     // 16-byte chunks per row
constexpr int B_ROWS_PER_PASS = THREADS / B_COLS4;  // 8
constexpr int B_PER_THREAD = BK / B_ROWS_PER_PASS;  // 2 chunks

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    mac_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, float* __restrict__ ws, int M, int K,
               int N, int splits, int adc_bits, float i_max) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  int k_lo, k_hi;
  k_range<BK>(K, splits, blockIdx.z, k_lo, k_hi);
  const int nk = (k_hi - k_lo + BK - 1) / BK;
  launch_dependents();
  // this thread's B chunks: rows b_row + 8 i, columns b_col .. b_col + 3
  const int b_col = (tid % B_COLS4) * 4;
  const int b_row = tid / B_COLS4;

  auto load_stage = [&](int slot, int k0) {
    float* As = smem + slot * STAGE;
    float* Bs = As + A_TILE;
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < k_hi;
      cp_async4(&As[c * A_LD + r], ok ? a + (size_t)gm * K + gk : a, ok);
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int r = b_row + i * B_ROWS_PER_PASS;
      const int gk = k0 + r, gn = n0 + b_col;
      if (VEC) {
        const bool ok = gk < k_hi && gn < N;
        const size_t idx = ok ? (size_t)gk * N + gn : 0;
        cp_async16(&Bs[r * BN + b_col], b + idx, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = gk < k_hi && gn + j < N;
          const size_t idx = ok ? (size_t)gk * N + gn + j : 0;
          cp_async4(&Bs[r * BN + b_col + j], b + idx, ok);
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, k_lo + s * BK);
    cp_async_commit();
  }
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    const int slot = kt % STAGES;
    __syncthreads();
    const int nt = kt + STAGES - 1;
    if (nt < nk) load_stage(nt % STAGES, k_lo + nt * BK);
    cp_async_commit();
    const float* As = smem + slot * STAGE;
    const float* Bs = As + A_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * A_LD + ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk * A_LD + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * BN + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk * BN + 64 + tx * 4]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  const bool split = splits > 1;
  float* dst = split ? ws + (size_t)blockIdx.z * M * N : out;
  const bool vec_out = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
    float* row = dst + (size_t)gm * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y[j] = acc[i][h * 4 + j];
        if (!split && gn + j < N) y[j] = adc(y[j], adc_bits, i_max);
      }
      if (vec_out && gn + 3 < N) {
        *reinterpret_cast<float4*>(&row[gn]) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) row[gn + j] = y[j];
      }
    }
  }
}

// Split-K second pass: the partials added in split order, then the ADC.
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int M,
                  int N, int splits, int adc_bits, float i_max) {
  const size_t mn = (size_t)M * N;
  wait_for_mainloop();
  for (size_t e = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x; e < mn;
       e += (size_t)gridDim.x * REDUCE_THREADS) {
    out[e] = adc(sum_partials(ws, mn, e, splits), adc_bits, i_max);
  }
}

template <bool VEC>
int launch(const float* a, const float* b, float* out, float* ws, int M,
           int K, int N, int splits, int adc_bits, float i_max,
           cudaStream_t s) {
  constexpr int smem = STAGES * STAGE * 4;
  static uint64_t done = 0;
  auto* kernel = mac_kernel<VEC>;
  cudaError_t err = allow_smem(kernel, smem, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
                  (unsigned)splits);
  kernel<<<grid, THREADS, smem, s>>>(a, b, out, ws, M, K, N, splits, adc_bits,
                                     i_max);
  if (splits > 1) {
    err = launch_reduce(reduce_kernel, M, N, s, (const float*)ws, out, M, N,
                        splits, adc_bits, i_max);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile geometry (0: BM, 1: BN, 2: BK), read once by kernels/analog_mac.py.
int analog_mac_tile(int dim) { return dim == 0 ? BM : dim == 1 ? BN : BK; }

int bitline_mac_launch(const float* v, const float* g, float* out, float* ws,
                       int M, int K, int N, int splits, int vec, int adc_bits,
                       float i_max, int device, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    if (vec)
      return launch<true>(v, g, out, ws, M, K, N, splits, adc_bits, i_max, s);
    return launch<false>(v, g, out, ws, M, K, N, splits, adc_bits, i_max, s);
  });
}

}  // extern "C"
