// Single-junction write of the coupled LLG system (paper Fig. 3).
//
// The CUDA counterpart of core/device.simulate_write's loop, whose plain
// version is kernels/ref.py ref_llg_write (the reference runs it as a
// lax.scan in src/repro/core/device.py, not as a Pallas kernel).  Each lane
// is one junction driven at its own voltage for a fixed horizon of n_steps
// RK4 steps, the STT amplitude re-evaluated from the instantaneous
// conductance at every step:
//   a_J = (pref ((V G) / A)) g_s     (core/device.a_j_from_voltage's order
//                                      times the lane's conductance factor;
//                                      B1 evaluates ((pref V) G) / A)
//   one RK4 step of the deterministic right-hand side (llg_step.cuh)
//   n_z = 0.5 (m1.z - m2.z) (NSUB = 2) or m.z; crossed = dir n_z < -0.9
//     (dir = +1 for the P -> AP write, -1 for the reverse: the negation is
//     exact, so -n_z < -0.9 is n_z > 0.9)
//   t_next = t + dt in float32; the first crossing stamps t_next
//   energy += switched ? 0 : (V^2 (G g_s)) dt, G the conductance after
//     the step
//   t = t_next
// g_s is the lane's junction conductance factor of a sampled process
// corner (core/params.DeviceSample.g_scale; the reference multiplies the
// drive and the conductance of the energy sum by it, src/repro/core/
// device.py).  Without a g_scale array it is 1.0f, and a product with
// 1.0f is exact, so the nominal write is bit-identical to the kernel
// without the factor.
// The initial state arrives from the host, built as the plain version
// builds it (core/llg.initial_state); the conductance of a step's end is
// the next step's drive conductance, the same value the plain version
// recomputes.
//
// Layout: m0 (lanes, NSUB, 3) float32; volts (lanes,); gscale (lanes,) or
// null (1.0f); out (lanes, 3 NSUB + 3): the final state, then t_switch
// (inf if no crossing), switched (1.0 or 0.0) and the energy.  One thread
// per lane, blocks of kBlock threads; any lane count from 1 up.
//
// Arithmetic as in llg_rk4.cu: -fmad=false, no fast math, IEEE division
// and sqrtf, every float32 operation in the plain version's order, so the
// kernel is bit-identical to ref_llg_write.
//
// What bounds it.  Counted from this source per lane-step (each add, mul,
// div and sqrt as one): NSUB = 2: 8 right-hand sides x 54 = 432, RK4
// stage updates 36, combination + renormalization 60, order parameter 2,
// conductance 2, a_J 3, the two torque factors 3, crossing sign 1, time 1,
// energy 3 = 543 float32 operations, of them 31 divisions and 2 sqrtf;
// NSUB = 1: 4 x 54 = 216, 18, 30, 0, 2, 3, 3, 1, 1, 3 = 277, of them 16
// divisions and 1 sqrtf; the conductance factor's 2 multiplies (drive and
// energy) make 545 / 279 per lane-step.  A launch holds a few lanes, so
// one thread's chain of dependent instructions bounds it, not the card's
// issue rate.

#include <cuda_runtime.h>
#include <string.h>

#include "llg_step.cuh"

namespace {

constexpr int kBlock = 32;

template <int NSUB>
__global__ void __launch_bounds__(kBlock)
    llg_write_kernel(const float* __restrict__ m0,
                     const float* __restrict__ volts,
                     const float* __restrict__ gscale, float* __restrict__ out,
                     int lanes, int n_steps, float dir, LLGConsts c) {
  const int lane = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (lane >= lanes) return;
  const float* s = m0 + lane * 3 * NSUB;
  V3 m = {s[0], s[1], s[2]};
  V3 o = NSUB == 2 ? V3{s[3], s[4], s[5]} : m;
  const float v = volts[lane];
  const float v2 = v * v;
  const float gs = gscale != nullptr ? gscale[lane] : 1.0f;
  const V3 none = {0.0f, 0.0f, 0.0f};

  auto order_z = [&]() { return NSUB == 1 ? m.z : 0.5f * (m.z - o.z); };
  auto f = [&](V3 x1, V3 x2, float ga, float gb, V3& d1, V3& d2) {
    if (NSUB == 2) {
      d1 = rhs_one<false>(x1, x2, 1.0f, ga, gb, none, c.alpha, c.denom,
                          c.b_aniso, c);
      d2 = rhs_one<false>(x2, x1, -1.0f, ga, gb, none, c.alpha, c.denom,
                          c.b_aniso, c);
    } else {
      d1 = rhs_one<false>(x1, x1, 1.0f, ga, gb, none, c.alpha, c.denom,
                          c.b_aniso, c);
    }
  };

  float g = c.g_sum + c.g_dif * order_z();
  float t = 0.0f, en = 0.0f;
  float t_sw = __int_as_float(0x7f800000);   // +inf
  bool sw = false;
#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
    const float aj = (c.pref * ((v * g) / c.area)) * gs;
    const float ga = c.gamma * aj;
    const float gb = c.neg_gamma * (c.beta * aj);
    V3 k1a{}, k1b{}, k2a{}, k2b{}, k3a{}, k3b{}, k4a{}, k4b{};
    f(m, o, ga, gb, k1a, k1b);
    f(axpy(m, c.half_dt, k1a), axpy(o, c.half_dt, k1b), ga, gb, k2a, k2b);
    f(axpy(m, c.half_dt, k2a), axpy(o, c.half_dt, k2b), ga, gb, k3a, k3b);
    f(axpy(m, c.dt, k3a), axpy(o, c.dt, k3b), ga, gb, k4a, k4b);
    m = combine(m, k1a, k2a, k3a, k4a, c.dt6);
    if (NSUB == 2) o = combine(o, k1b, k2b, k3b, k4b, c.dt6);
    const float nz = order_z();
    const bool crossed = dir * nz < c.neg_thr;
    const float t_next = t + c.dt;
    if (crossed && !sw) t_sw = t_next;
    sw = sw || crossed;
    g = c.g_sum + c.g_dif * nz;
    en = en + (sw ? 0.0f : v2 * (g * gs) * c.dt);
    t = t_next;
  }

  float* r = out + lane * (3 * NSUB + 3);
  r[0] = m.x;
  r[1] = m.y;
  r[2] = m.z;
  if (NSUB == 2) {
    r[3] = o.x;
    r[4] = o.y;
    r[5] = o.z;
  }
  r[3 * NSUB] = t_sw;
  r[3 * NSUB + 1] = sw ? 1.0f : 0.0f;
  r[3 * NSUB + 2] = en;
}

template <int NSUB>
int launch(const float* m0, const float* volts, const float* gscale,
           float* out, int lanes, int n_steps, float dir, const LLGConsts& c,
           cudaStream_t stream) {
  const unsigned blocks = (unsigned)((lanes + kBlock - 1) / kBlock);
  llg_write_kernel<NSUB><<<blocks, kBlock, 0, stream>>>(
      m0, volts, gscale, out, lanes, n_steps, dir, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int llg_write_n_consts() { return (int)(sizeof(LLGConsts) / sizeof(float)); }

const char* llg_write_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream`: `lanes` junctions of `nsub` sublattices for
// `n_steps` steps, crossing on dir n_z < -threshold (dir = +1 or -1), each
// lane's drive and energy conductance scaled by gscale[lane] (null: 1).
// Returns 0 or a cudaError_t.
int llg_write_launch(const float* m0, const float* volts, const float* gscale,
                     float* out, int lanes, int n_steps, int nsub, float dir,
                     const float* consts, void* stream) {
  if (lanes <= 0 || n_steps < 0 || (nsub != 1 && nsub != 2) ||
      (dir != 1.0f && dir != -1.0f)) {
    return (int)cudaErrorInvalidValue;
  }
  LLGConsts c;
  memcpy(&c, consts, sizeof(c));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nsub == 2
             ? launch<2>(m0, volts, gscale, out, lanes, n_steps, dir, c, st)
             : launch<1>(m0, volts, gscale, out, lanes, n_steps, dir, c, st);
}

}  // extern "C"
