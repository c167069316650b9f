// ADC sizing of the fake-analog MVM's operands (the port's own kernel: the
// JAX package sizes these scalars inside its jitted forward, so no Pallas
// kernel lies behind it).
//
// Writes the (8, N) aux plane that the fake-analog MVM (B5, fake_analog.cu)
// reads, in one launch, from statistics that stay on the card:
//   rows ATT_POS / ATT_NEG  the per-column IR attenuations,
//   row  I_MAX              the ADC full scale
//                             round_2sig(max(fs_sigmas *
//                                 ((v_rms * g_rms) * sqrt(k_rows)), 1e-30)),
//   row  DECODE             the decode gain
//                             (x_scale * w_scale) /
//                                 ((v_read * g_fs) * att_mean),
//   rows G_AP .. R_ACCESS   the cell constants, broadcast.
// The float32 statistics (max |w|, max |x| with 0 read as 1, the mean
// attenuation, the rms of g_diff and of V) are converted to float64
// exactly and every float64 operation is the host's, in the host's order
// (kernels/adc_sizing.py adc_full_scale / decode_gain; -fmad=false, IEEE
// division), so both scalars are the host's floats bit for bit before
// their float32 store (__double2float_rn, round to nearest even, as
// torch's float64 -> float32 conversion).
//
// round_2sig is Python's float(f"{max(s, 1e-30):.2g}") by a lookup: the
// host builds a sorted table from that very rounding (kernels/adc_sizing.py
// rounding_table: each bound the least double that rounds to its value,
// 6,211 entries over [1e-30, 1e39) and a last one sending 1e39 and above
// to +inf, whose float32 store equals that of the value's own rounding:
// both overflow) and copies it to the card once a process; the kernel
// finds the last bound <= y by binary search.  A NaN stays NaN, as
// Python's max keeps it.
//
// Launch: ceil(N / 256) blocks of 256 threads; thread 0 of each block sizes
// the two scalars (a float64 chain and a 13-step search) into shared memory,
// then every thread writes one column of all eight rows.
#include <cuda_runtime.h>
#include <math.h>

#include "analog_common.cuh"
#include "split_k.cuh"

namespace {

constexpr int THREADS = 256;
constexpr double FLOOR = 1e-30;

// float(f"{max(s, 1e-30):.2g}"): bound[0] is the floor, so the search
// starts inside the table.
__device__ double round_2sig(double s, const double* __restrict__ bound,
                             const double* __restrict__ value, int T) {
  const double y = FLOOR > s ? FLOOR : s;
  if (y != y) return y;
  int lo = 0, hi = T;  // bound[lo] <= y < bound[hi], bound[T] read as +inf
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (bound[mid] <= y) lo = mid;
    else hi = mid;
  }
  return value[lo];
}

struct Cell {
  const float *g_ap, *g_fs, *g_scale, *r_access;
};

struct Sizing {
  double sqrt_k, fs_sigmas, v_read, g_fs, i_max;
  int decode, has_imax;
};

__global__ void __launch_bounds__(THREADS)
    aux_kernel(const float* __restrict__ att_p, const float* __restrict__ att_n,
               Cell c, const float* __restrict__ w_max,
               const float* __restrict__ x_max,
               const float* __restrict__ att_mean,
               const float* __restrict__ g_rms,
               const float* __restrict__ v_rms,
               const double* __restrict__ table, int T,
               float* __restrict__ aux, int N, Sizing z) {
  __shared__ float row[6];
  if (threadIdx.x == 0) {
    double i_max = z.i_max;
    if (!z.has_imax) {
      const double i_sigma = ((double)*v_rms * (double)*g_rms) * z.sqrt_k;
      i_max = round_2sig(z.fs_sigmas * i_sigma, table, table + T, T);
    }
    double dec = 1.0;
    if (z.decode) {
      double ws = *w_max, xs = *x_max;
      if (ws == 0.0) ws = 1.0;
      if (xs == 0.0) xs = 1.0;
      const double att = att_mean ? (double)*att_mean : 1.0;
      dec = (xs * ws) / ((z.v_read * z.g_fs) * att);
    }
    row[0] = __double2float_rn(i_max);
    row[1] = __double2float_rn(dec);
    row[2] = *c.g_ap;
    row[3] = *c.g_fs;
    row[4] = *c.g_scale;
    row[5] = *c.r_access;
  }
  __syncthreads();
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  aux[(size_t)ROW_ATT_POS * N + n] = att_p[n];
  aux[(size_t)ROW_ATT_NEG * N + n] = att_n[n];
  aux[(size_t)ROW_I_MAX * N + n] = row[0];
  aux[(size_t)ROW_DECODE * N + n] = row[1];
  aux[(size_t)ROW_G_AP * N + n] = row[2];
  aux[(size_t)ROW_G_FS * N + n] = row[3];
  aux[(size_t)ROW_G_SCALE * N + n] = row[4];
  aux[(size_t)ROW_R_ACCESS * N + n] = row[5];
}

}  // namespace

extern "C" {

// The aux plane of one fake-analog product.  Every pointer is a float32
// on the card: the attenuation rows (N each), the four cell constants,
// max |w| and max |x|, the mean attenuation (null reads 1: no IR drop)
// and the rms of g_diff and of V, read only when the full scale is sized
// here (has_imax 0; else `i_max` is stored); `table` is the (2, T) float64
// rounding table on the card, bounds then values.  Returns 0 or a
// cudaError_t.
int adc_aux_launch(const float* att_p, const float* att_n, const float* g_ap,
                   const float* g_fs, const float* g_scale,
                   const float* r_access, const float* w_max,
                   const float* x_max, const float* att_mean,
                   const float* g_rms, const float* v_rms,
                   const double* table, int T, float* aux, int N,
                   double sqrt_k, double fs_sigmas, double v_read,
                   double g_fs_host, int decode, int has_imax, double i_max,
                   int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Cell c{g_ap, g_fs, g_scale, r_access};
  const Sizing z{sqrt_k, fs_sigmas, v_read, g_fs_host, i_max, decode,
                 has_imax};
  return on_device(device, [&] {
    aux_kernel<<<(unsigned)((N + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        att_p, att_n, c, w_max, x_max, att_mean, g_rms, v_rms, table, T, aux,
        N, z);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
