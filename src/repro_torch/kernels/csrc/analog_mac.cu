// Analog in-memory MAC kernels of the port: the bit-line MAC with ADC (B3)
// and the fused fake-analog MVM (B5), for sm_90a.  The XNOR GEMM (B4) has a
// source of its own (xnor_gemm.cu: tensor cores, exact).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   bitline_mac  <- repro/kernels/bitline_mac.py  bitline_mac_pallas / _mac_kernel
//   fake_analog  <- repro/kernels/fake_analog.py  fake_analog_mac_pallas / _fake_kernel
//
// Both are one float32 SIMT GEMM, out(M, N) = epilogue(A(M, K) @ B(K, N)):
//   B3  B = g, epilogue = signed mid-tread ADC (adc_quantize) on i_max;
//   B5  B = att_pos * tp - att_neg * tn, replayed per element from the
//       normalized weights, the fail/fault code plane and the (8, N) aux
//       plane in the operation order of the reference's _tile_g_diff
//       (targets, optional FET/corner round trip, floor -> stuck-on ->
//       dead decode); epilogue = ADC on the per-column i_max row, times
//       the per-column decode gain.
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
//   fragments as four 16-byte shared loads per 64 fmaf.
// * A ring of STAGES shared-memory stages filled by cp.async (16-byte
//   cp.async.cg for B rows when N % 4 == 0 and the pointer is aligned, else
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
//   (analog_mac.py): at most one wave, no empty chunk.
// * B5 stages the wn and fail tiles raw; after a thread's own copies have
//   landed it replays its own elements in place (g_diff_elem, arithmetic
//   unchanged), before the stage's barrier.  It runs one block per SM (the
//   replay needs more than 128 registers), B3 two.  B3 and B5 therefore add the
//   same products in the same order through the same chunks: on the same
//   g_diff their raw currents are bit-equal (the reference's pin,
//   tests/test_analog_pipeline.py).
// * Edges are guarded, not padded: A rows beyond M and entries beyond the
//   chunk, B entries beyond the chunk or N, load as 0 (zero-filling
//   cp.async; the replay keeps them 0).
// Built with -fmad=false and without fast math, so the replay's and the
// ADC's products, sums and divisions round one by one, as the plain
// PyTorch version's separate operations do; rintf rounds half to even like
// jnp.round.
#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int A_PER_THREAD = BM * BK / THREADS;     // 8 four-byte copies
constexpr int B_COLS4 = BN / 4;                     // 16-byte chunks per row
constexpr int B_ROWS_PER_PASS = THREADS / B_COLS4;  // 8
constexpr int B_PER_THREAD = BK / B_ROWS_PER_PASS;  // 2 chunks

// aux-plane rows (kernels/fake_analog.py ROW_*)
constexpr int ROW_ATT_POS = 0;
constexpr int ROW_ATT_NEG = 1;
constexpr int ROW_I_MAX = 2;
constexpr int ROW_DECODE = 3;
constexpr int ROW_G_AP = 4;
constexpr int ROW_G_FS = 5;
constexpr int ROW_G_SCALE = 6;
constexpr int ROW_R_ACCESS = 7;

enum Mode { MODE_MAC = 0, MODE_FAKE = 2 };

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// floor(code * (1 / bit)) mod 2 >= 1 on float32 codes 0..127 (fail_bit)
__device__ __forceinline__ bool fail_bit(float code, float inv_bit) {
  return fmodf(floorf(code * inv_bit), 2.0f) >= 1.0f;
}

__device__ __forceinline__ float fet(float t, float r_access, float g_scale) {
  float g_j = (t / (1.0f - r_access * t)) * g_scale;
  return g_j / (1.0f + r_access * g_j);
}

// One element of the differential conductance tile (_tile_g_diff).
template <bool APPLY_FET, bool USE_FAIL>
__device__ __forceinline__ float g_diff_elem(float wn, float code, float att_p,
                                             float att_n, float g_ap,
                                             float g_fs, float g_scale,
                                             float r_access) {
  float tp = g_ap + fmaxf(wn, 0.0f) * g_fs;
  float tn = g_ap + fmaxf(-wn, 0.0f) * g_fs;
  if (APPLY_FET) {
    tp = fet(tp, r_access, g_scale);
    tn = fet(tn, r_access, g_scale);
  }
  if (USE_FAIL) {
    const float g_on = g_ap + g_fs;
    if (fail_bit(code, 1.0f) || fail_bit(code, 0.25f)) tp = g_ap;      // 1, 4
    if (fail_bit(code, 0.5f) || fail_bit(code, 0.125f)) tn = g_ap;     // 2, 8
    if (fail_bit(code, 0.0625f)) tp = g_on;                            // 16
    if (fail_bit(code, 0.03125f)) tn = g_on;                           // 32
    if (fail_bit(code, 0.015625f)) {                                   // 64
      tp = 0.0f;
      tn = 0.0f;
    }
  }
  return att_p * tp - att_n * tn;
}

// Signed mid-tread ADC (adc_quantize): round(clip(i / i_max, -1, 1) * half)
// / half * i_max, IEEE division, round half to even.
__device__ __forceinline__ float adc(float i, int adc_bits, float i_max) {
  if (adc_bits <= 0) return i;
  const float half = (float)((1 << (adc_bits - 1)) - 1);
  float x = fminf(fmaxf(i / i_max, -1.0f), 1.0f);
  return rintf(x * half) / half * i_max;
}

template <int MODE>
__device__ __forceinline__ float finish(float y, int gn, int N, int adc_bits,
                                        float i_max, const float* aux) {
  if (MODE == MODE_MAC) return adc(y, adc_bits, i_max);
  return adc(y, adc_bits, aux[(size_t)ROW_I_MAX * N + gn]) *
         aux[(size_t)ROW_DECODE * N + gn];
}

template <int MODE, bool FAIL_TILE>
__host__ __device__ constexpr int stage_floats() {
  return A_TILE + B_TILE + (MODE == MODE_FAKE && FAIL_TILE ? B_TILE : 0);
}

// B3 keeps two blocks per SM (128 registers); B5's replay needs more
// registers than that, so it runs one block per SM.
template <int MODE, bool VEC, bool APPLY_FET, bool USE_FAIL>
__global__ void __launch_bounds__(THREADS, MODE == MODE_FAKE ? 1 : 2)
    mac_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ fail, const float* __restrict__ aux,
               float* __restrict__ out, float* __restrict__ ws, int M, int K,
               int N, int splits, int adc_bits, float i_max) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool FAIL_TILE = MODE == MODE_FAKE && USE_FAIL;
  constexpr int STAGE = stage_floats<MODE, USE_FAIL>();
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
    float* Fs = Bs + B_TILE;
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
        if (FAIL_TILE) cp_async16(&Fs[r * BN + b_col], fail + idx, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = gk < k_hi && gn + j < N;
          const size_t idx = ok ? (size_t)gk * N + gn + j : 0;
          cp_async4(&Bs[r * BN + b_col + j], b + idx, ok);
          if (FAIL_TILE) cp_async4(&Fs[r * BN + b_col + j], fail + idx, ok);
        }
      }
    }
  };

  // B5: replay this thread's own landed wn (+ fail) elements into g_diff
  auto replay = [&](int slot, int k0) {
    float* Bs = smem + slot * STAGE + A_TILE;
    const float* Fs = Bs + B_TILE;
    const float g_ap = aux[(size_t)ROW_G_AP * N];
    const float g_fs = aux[(size_t)ROW_G_FS * N];
    const float g_scale = aux[(size_t)ROW_G_SCALE * N];
    const float r_access = aux[(size_t)ROW_R_ACCESS * N];
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int r = b_row + i * B_ROWS_PER_PASS;
      const int gk = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + b_col + j;
        const int s = r * BN + b_col + j;
        float x = 0.0f;
        if (gk < k_hi && gn < N)
          x = g_diff_elem<APPLY_FET, USE_FAIL>(
              Bs[s], FAIL_TILE ? Fs[s] : 0.0f,
              aux[(size_t)ROW_ATT_POS * N + gn],
              aux[(size_t)ROW_ATT_NEG * N + gn], g_ap, g_fs, g_scale,
              r_access);
        Bs[s] = x;
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
    if (MODE == MODE_FAKE) replay(slot, k_lo + kt * BK);
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
        if (!split && gn + j < N)
          y[j] = finish<MODE>(y[j], gn + j, N, adc_bits, i_max, aux);
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

// Split-K second pass: the partials added in split order, then the epilogue.
template <int MODE>
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_kernel(const float* __restrict__ ws, const float* __restrict__ aux,
                  float* __restrict__ out, int M, int N, int splits,
                  int adc_bits, float i_max) {
  const size_t mn = (size_t)M * N;
  wait_for_mainloop();
  for (size_t e = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x; e < mn;
       e += (size_t)gridDim.x * REDUCE_THREADS) {
    out[e] = finish<MODE>(sum_partials(ws, mn, e, splits), (int)(e % N), N,
                          adc_bits, i_max, aux);
  }
}

template <int MODE, bool VEC, bool APPLY_FET, bool USE_FAIL>
int launch(const float* a, const float* b, const float* fail,
           const float* aux, float* out, float* ws, int M, int K, int N,
           int splits, int adc_bits, float i_max, cudaStream_t s) {
  constexpr int smem = STAGES * stage_floats<MODE, USE_FAIL>() * 4;
  static uint64_t done = 0;
  auto* kernel = mac_kernel<MODE, VEC, APPLY_FET, USE_FAIL>;
  cudaError_t err = allow_smem(kernel, smem, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
                  (unsigned)splits);
  kernel<<<grid, THREADS, smem, s>>>(a, b, fail, aux, out, ws, M, K, N, splits,
                                     adc_bits, i_max);
  if (splits > 1) {
    err = launch_reduce(reduce_kernel<MODE>, M, N, s, (const float*)ws, aux,
                        out, M, N, splits, adc_bits, i_max);
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
      return launch<MODE_MAC, true, false, false>(
          v, g, nullptr, nullptr, out, ws, M, K, N, splits, adc_bits, i_max, s);
    return launch<MODE_MAC, false, false, false>(
        v, g, nullptr, nullptr, out, ws, M, K, N, splits, adc_bits, i_max, s);
  });
}

int fake_analog_launch(const float* v, const float* wn, const float* fail,
                       const float* aux, float* out, float* ws, int M, int K,
                       int N, int splits, int vec, int adc_bits, int apply_fet,
                       int use_fail, int device, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
#define FAKE(V, F, U)                                                        \
  return launch<MODE_FAKE, V, F, U>(v, wn, fail, aux, out, ws, M, K, N,      \
                                    splits, adc_bits, 1.0f, s)
    if (vec) {
      if (apply_fet && use_fail) FAKE(true, true, true);
      if (apply_fet) FAKE(true, true, false);
      if (use_fail) FAKE(true, false, true);
      FAKE(true, false, false);
    }
    if (apply_fet && use_fail) FAKE(false, true, true);
    if (apply_fet) FAKE(false, true, false);
    if (use_fail) FAKE(false, false, true);
    FAKE(false, false, false);
#undef FAKE
  });
}

}  // extern "C"
