// Device helpers shared by the float32 analog MVM sources (analog_mac.cu,
// the bit-line MAC B3; fake_analog.cu, the fused fake-analog MVM B5): the
// 4-byte zero-filling cp.async, the signed mid-tread ADC, the aux-plane row
// layout and the access-FET / corner round trip.  Every operation rounds on
// its own (the sources are built with -fmad=false, without fast math), as
// the plain PyTorch versions' separate operations do.
#pragma once

#include <cuda_runtime.h>

namespace {

// aux-plane rows (kernels/fake_analog.py ROW_*)
constexpr int ROW_ATT_POS = 0;
constexpr int ROW_ATT_NEG = 1;
constexpr int ROW_I_MAX = 2;
constexpr int ROW_DECODE = 3;
constexpr int ROW_G_AP = 4;
constexpr int ROW_G_FS = 5;
constexpr int ROW_G_SCALE = 6;
constexpr int ROW_R_ACCESS = 7;

// 4 bytes global -> shared, asynchronous; zero-filled when !pred.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// The access-FET / corner round trip of one target conductance.
__device__ __forceinline__ float fet(float t, float r_access, float g_scale) {
  float g_j = (t / (1.0f - r_access * t)) * g_scale;
  return g_j / (1.0f + r_access * g_j);
}

// Signed mid-tread ADC (adc_quantize): round(clip(i / i_max, -1, 1) * half)
// / half * i_max, IEEE division, round half to even.
__device__ __forceinline__ float adc(float i, int adc_bits, float i_max) {
  if (adc_bits <= 0) return i;
  const float half = (float)((1 << (adc_bits - 1)) - 1);
  float x = fminf(fmaxf(i / i_max, -1.0f), 1.0f);
  return rintf(x * half) / half * i_max;
}

}  // namespace
