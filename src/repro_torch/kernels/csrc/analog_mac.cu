// Analog in-memory MAC kernels of the port: bit-line MAC with ADC (B3),
// XNOR-popcount GEMM (B4) and the fused fake-analog MVM (B5), for sm_90a.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   bitline_mac  <- repro/kernels/bitline_mac.py  bitline_mac_pallas / _mac_kernel
//   xnor_gemm    <- repro/kernels/xnor_gemm.py    xnor_gemm_pallas / _xnor_kernel
//   fake_analog  <- repro/kernels/fake_analog.py  fake_analog_mac_pallas / _fake_kernel
//
// All three are one shared-memory tiled float32 SIMT GEMM,
// out(M, N) = epilogue(A(M, K) @ B(K, N)), with a per-mode B prologue and
// epilogue:
//   B3  B = g, epilogue = signed mid-tread ADC (adc_quantize) on i_max;
//   B4  A, B in {-1, +1} (0 = padding), float32 or bfloat16 converted on
//       load; epilogue = optional sign with an explicit tie (binarize_acc);
//       +-1 sums are integers below 2^24, so the float32 result is exact;
//   B5  B = att_pos * tp - att_neg * tn, replayed per element from the
//       normalized weights, the fail/fault code plane and the (8, N) aux
//       plane in the operation order of the reference's _tile_g_diff
//       (targets, optional FET/corner round trip, floor -> stuck-on ->
//       dead decode); epilogue = ADC on the per-column i_max row, times
//       the per-column decode gain.
//
// Design.  A block computes a 64 x 64 output tile with 256 threads, each a
// 4 x 4 register micro-tile (rows ty + 16 i, columns tx + 16 j: conflict-
// free shared-memory reads, coalesced stores), stepping K by 16 through
// shared memory.  Edges are guarded, not padded: A rows beyond M and K,
// and B entries beyond K or N, load as 0 (the reference zero-pads to 128,
// which contributes nothing either).  Every output element is summed by one
// thread over k = 0 .. K-1 in order with fmaf, so B3 and B5 add the same
// products in the same order: on the same g_diff their raw currents are
// bit-equal (the reference's pin, tests/test_analog_pipeline.py).  No
// tensor cores: TF32 would break IEEE float32 parity with the reference.
// Built with -fmad=false and without fast math, so the prologue's and the
// ADC's products, sums and divisions round one by one, as the plain
// PyTorch version's separate operations do; rintf rounds half to even like
// jnp.round.
//
// What bounds it on an H100: at the main path's M = 128 the product is
// 2 M K N float32 operations over K N + M K + M N words; for the widest
// shape (896 x 151,936) that is ~35 GFLOP over ~0.6 GB, so operations
// bound it (67 TFLOP/s FP32), not HBM.  This first version reaches a
// fraction of that: its 64 x 64 tiles fill few SMs at N = 128-896 and
// every product is a SIMT fmaf.  wgmma, TMA and bit-packed popcount are
// later work (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int ROW_GROUPS = BM / TM;               // 16
constexpr int COL_GROUPS = BN / TN;               // 16

// aux-plane rows (kernels/fake_analog.py ROW_*)
constexpr int ROW_ATT_POS = 0;
constexpr int ROW_ATT_NEG = 1;
constexpr int ROW_I_MAX = 2;
constexpr int ROW_DECODE = 3;
constexpr int ROW_G_AP = 4;
constexpr int ROW_G_FS = 5;
constexpr int ROW_G_SCALE = 6;
constexpr int ROW_R_ACCESS = 7;

enum Mode { MODE_MAC = 0, MODE_XNOR = 1, MODE_FAKE = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <int MODE, bool APPLY_FET, bool USE_FAIL, typename T>
__global__ void __launch_bounds__(THREADS)
    analog_mac_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const float* __restrict__ fail,
                      const float* __restrict__ aux, float* __restrict__ out,
                      int M, int K, int N, int adc_bits, float i_max,
                      int binarize, float tie) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % COL_GROUPS;
  const int ty = tid / COL_GROUPS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // B5 scalars: column 0 of the broadcast rows, as the reference's tile
  float g_ap = 0.0f, g_fs = 0.0f, g_scale = 0.0f, r_access = 0.0f;
  if (MODE == MODE_FAKE) {
    g_ap = aux[(size_t)ROW_G_AP * N];
    g_fs = aux[(size_t)ROW_G_FS * N];
    g_scale = aux[(size_t)ROW_G_SCALE * N];
    r_access = aux[(size_t)ROW_R_ACCESS * N];
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      float x = 0.0f;
      if (gm < M && gk < K) x = to_f32(a[(size_t)gm * K + gk]);
      As[c][r] = x;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      float x = 0.0f;
      if (gk < K && gn < N) {
        const size_t idx = (size_t)gk * N + gn;
        if (MODE == MODE_FAKE) {
          x = g_diff_elem<APPLY_FET, USE_FAIL>(
              to_f32(b[idx]), USE_FAIL ? fail[idx] : 0.0f,
              aux[(size_t)ROW_ATT_POS * N + gn],
              aux[(size_t)ROW_ATT_NEG * N + gn], g_ap, g_fs, g_scale,
              r_access);
        } else {
          x = to_f32(b[idx]);
        }
      }
      Bs[r][c] = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM], rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = As[kk][ty + i * ROW_GROUPS];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = Bs[kk][tx + j * COL_GROUPS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * ROW_GROUPS;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * COL_GROUPS;
      if (gn >= N) continue;
      float y = acc[i][j];
      if (MODE == MODE_MAC) {
        y = adc(y, adc_bits, i_max);
      } else if (MODE == MODE_XNOR) {
        if (binarize) y = (y == 0.0f) ? tie : (y > 0.0f ? 1.0f : -1.0f);
      } else {
        y = adc(y, adc_bits, aux[(size_t)ROW_I_MAX * N + gn]) *
            aux[(size_t)ROW_DECODE * N + gn];
      }
      out[(size_t)gm * N + gn] = y;
    }
  }
}

dim3 grid_for(int M, int N) {
  return dim3((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
}

}  // namespace

extern "C" {

int analog_mac_block_threads() { return THREADS; }

int bitline_mac_launch(const float* v, const float* g, float* out, int M,
                       int K, int N, int adc_bits, float i_max,
                       void* stream) {
  analog_mac_kernel<MODE_MAC, false, false, float>
      <<<grid_for(M, N), THREADS, 0, (cudaStream_t)stream>>>(
          v, g, nullptr, nullptr, out, M, K, N, adc_bits, i_max, 0, 0.0f);
  return (int)cudaGetLastError();
}

int xnor_gemm_launch(const void* a, const void* w, float* out, int M, int K,
                     int N, int bf16, int binarize, int tie, void* stream) {
  if (bf16) {
    analog_mac_kernel<MODE_XNOR, false, false, __nv_bfloat16>
        <<<grid_for(M, N), THREADS, 0, (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)a, (const __nv_bfloat16*)w, nullptr,
            nullptr, out, M, K, N, 0, 1.0f, binarize, (float)tie);
  } else {
    analog_mac_kernel<MODE_XNOR, false, false, float>
        <<<grid_for(M, N), THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)a, (const float*)w, nullptr, nullptr, out, M, K, N,
            0, 1.0f, binarize, (float)tie);
  }
  return (int)cudaGetLastError();
}

int fake_analog_launch(const float* v, const float* wn, const float* fail,
                       const float* aux, float* out, int M, int K, int N,
                       int adc_bits, int apply_fet, int use_fail,
                       void* stream) {
  const dim3 grid = grid_for(M, N);
  cudaStream_t s = (cudaStream_t)stream;
  if (apply_fet && use_fail) {
    analog_mac_kernel<MODE_FAKE, true, true, float><<<grid, THREADS, 0, s>>>(
        v, wn, fail, aux, out, M, K, N, adc_bits, 1.0f, 0, 0.0f);
  } else if (apply_fet) {
    analog_mac_kernel<MODE_FAKE, true, false, float><<<grid, THREADS, 0, s>>>(
        v, wn, fail, aux, out, M, K, N, adc_bits, 1.0f, 0, 0.0f);
  } else if (use_fail) {
    analog_mac_kernel<MODE_FAKE, false, true, float><<<grid, THREADS, 0, s>>>(
        v, wn, fail, aux, out, M, K, N, adc_bits, 1.0f, 0, 0.0f);
  } else {
    analog_mac_kernel<MODE_FAKE, false, false, float><<<grid, THREADS, 0, s>>>(
        v, wn, fail, aux, out, M, K, N, adc_bits, 1.0f, 0, 0.0f);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
