// RK4 integrator of the coupled LLG system for thermal Monte-Carlo
// campaigns, one lane (cell or sample) per thread.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/llg_rk4.py:
// `_llg_kernel` (deterministic, fixed horizon) and `_llg_thermal_kernel`
// (Brown thermal field from the counter-RNG, per-lane sigma and step budget,
// chunked early exit, optional per-lane variation rows).  Template switches:
//   THERMAL    the thermal kernel (seeds + aux plane) vs the deterministic one
//   VARIATION  aux plane of 5 rows (+ alpha, B_k, g_scale) instead of 2
//   NSUB       2 = AFMTJ (staggered Neel STT), 1 = MTJ (single sublattice;
//              the reference runs it through its jnp oracle, not Pallas)
//
// Layout (as the Pallas kernel): state and out are (8, cells) float32,
// rows 0-2 = m1, 3-5 = m2 (zero for NSUB = 1), 6 = drive voltage,
// 7 = first step (1-based, as float32) with n_z < -threshold, n_steps if
// none; seeds (cells,) uint32; aux (2 or 5, cells) float32: row 0 = Brown
// sigma [T], 1 = step budget, 2-4 = alpha, B_k [T], g_scale.  cells is a
// multiple of the block size.
//
// Arithmetic follows the reference's plain version (src/repro/kernels/ref.py
// through core/llg.py) operation by operation in float32: constants that the
// reference folds in double precision arrive in LLGConsts already rounded,
// the file is compiled with -fmad=false and without fast math, and logf,
// sqrtf, sinf, cosf and '/' are the correctly rounded or libdevice
// functions, not the __ intrinsics.  The state is renormalized by dividing
// by sqrtf(|m|^2), as ref.py does; the Pallas kernel multiplies by rsqrt
// instead, which differs by an ulp or two per step.
//
// What bounds it.  Counted from this source per lane and step of the
// thermal kernel (each add, mul, div, sqrt and transcendental as one):
//   NSUB = 2: 8 right-hand sides x 57 = 456, RK4 stage updates 36,
//     combination + renormalization 60, drive 10, noise 42 (3 Box-Muller
//     pairs of 12 + 6 sigma products), crossing order parameter 2 = 606
//     float32 operations, of them 31 IEEE divisions (24 in the right-hand
//     sides, 6 in renormalization, 1 for a_J), 5 sqrtf, 3 logf, 3 sinf,
//     3 cosf;
//   NSUB = 1: 4 x 57 = 228, 18, 30, 8, noise 33 (the sinf half of each
//     Box-Muller pair is drawn but unused, so the compiler drops it) = 317,
//     of them 16 divisions, 4 sqrtf, 3 logf, 3 cosf.
// The deterministic kernel (THERMAL = false) drops the noise and the three
// thermal-field adds of each right-hand side (57 -> 54): 540 (NSUB = 2) and
// 272 (NSUB = 1) float32 operations per lane-step, with the same divisions
// and only the renormalization's sqrtf (2 and 1): 33 and 17 SFU operations.
// In the sm_90a SASS each division issues one MUFU.RCP and each sqrtf one
// MUFU.RSQ on the special-function units; logf, sinf and cosf (libdevice,
// no fast math) are polynomials on the FP32 pipe and issue no MUFU.  So
// 36 (NSUB = 2) and 20 (NSUB = 1) SFU operations per lane-step
// (tools/sass_census.py counts them).  Every input is read once and every
// output written once (64 bytes a lane), so the kernel is bound by FP32
// and SFU issue, never by memory.  The design keeps every lane's whole
// state in registers for the full horizon (no shared memory, no tensor
// cores: the work is elementwise float32), and lets a block of 512 lanes
// leave the loop as soon as all its lanes are done (__syncthreads_and
// every `chunk` steps), which is the Pallas kernel's 512-lane exit group.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlock = 512;   // CELL_TILE: lanes per block = exit group

struct LLGConsts {
  float neg_gamma;  // -GAMMA
  float gamma;      // GAMMA
  float beta;       // field-like ratio beta_flt
  float alpha;      // Gilbert damping (scalar path)
  float denom;      // 1 + alpha^2, folded in double (scalar path)
  float b_aniso;    // B_k [T] (scalar path)
  float neg_be;     // -B_E [T]
  float g_sum;      // 0.5 (G_P + G_AP)
  float g_dif;      // 0.5 (G_P - G_AP)
  float pref;       // STT prefactor a_J / J
  float area;       // junction area [m^2]
  float half_dt;    // 0.5 dt
  float dt;         // dt
  float dt6;        // dt / 6
  float neg_thr;    // -switch_threshold
  float two_pi;     // 2 pi
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 axpy(V3 m, float h, V3 k) {
  return {m.x + h * k.x, m.y + h * k.y, m.z + h * k.z};
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

// kernels/noise.py normal_pair: Box-Muller on two lowbias32 hashes.
__device__ __forceinline__ void normal_pair(uint32_t seed, uint32_t counter,
                                            float two_pi, float& z0,
                                            float& z1) {
  const uint32_t base = seed ^ mix32(counter * 0x9E3779B9u + 1u);
  const uint32_t h1 = mix32(base);
  const uint32_t h2 = mix32(base ^ 0x735A2D97u);
  const float u1 = ((float)(h1 >> 8) + 1.0f) * 5.9604644775390625e-08f;
  const float u2 = ((float)(h2 >> 8) + 1.0f) * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float ang = two_pi * u2;
  z0 = r * cosf(ang);
  z1 = r * sinf(ang);
}

// core/llg.llg_rhs for one sublattice: m its moment, mo the other one (m
// itself for NSUB = 1, where B_E = 0), s its STT sign.  The polarization is
// (0, 0, s), so m x p and m x (m x p) keep only their nonzero products; the
// dropped terms are exact zeros in the reference's full cross products.
template <bool THERMAL>
__device__ __forceinline__ V3 rhs_one(V3 m, V3 mo, float s, float ga,
                                      float gb, V3 bth, float alpha,
                                      float denom, float bk,
                                      const LLGConsts& c) {
  V3 b = {c.neg_be * mo.x, c.neg_be * mo.y, bk * m.z + c.neg_be * mo.z};
  if (THERMAL) b = {b.x + bth.x, b.y + bth.y, b.z + bth.z};
  const V3 mxb = cross(m, b);
  const V3 mxp = {m.y * s, -(m.x * s), 0.0f};
  const V3 mxmxp = {-(m.z * mxp.y), m.z * mxp.x, m.x * mxp.y - m.y * mxp.x};
  V3 t;
  t.x = (c.neg_gamma * mxb.x + ga * mxmxp.x) + gb * mxp.x;
  t.y = (c.neg_gamma * mxb.y + ga * mxmxp.y) + gb * mxp.y;
  t.z = (c.neg_gamma * mxb.z + ga * mxmxp.z) + gb * mxp.z;
  const V3 mxt = cross(m, t);
  return {(t.x + alpha * mxt.x) / denom, (t.y + alpha * mxt.y) / denom,
          (t.z + alpha * mxt.z) / denom};
}

__device__ __forceinline__ V3 renorm(V3 m) {
  const float n = sqrtf(m.x * m.x + m.y * m.y + m.z * m.z);
  return {m.x / n, m.y / n, m.z / n};
}

template <bool THERMAL, bool VARIATION, int NSUB>
__global__ void __launch_bounds__(kBlock)
    llg_rk4_kernel(const float* __restrict__ state,
                   const uint32_t* __restrict__ seeds,
                   const float* __restrict__ aux, float* __restrict__ out,
                   int cells, int n_steps, int chunk, LLGConsts c) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  V3 m1 = {state[lane], state[cells + lane], state[2 * cells + lane]};
  V3 m2 = {state[3 * cells + lane], state[4 * cells + lane],
           state[5 * cells + lane]};
  const float v = state[6 * cells + lane];
  uint32_t seed = 0;
  float sigma = 0.0f;
  float budget = (float)n_steps;
  float alpha = c.alpha, denom = c.denom, bk = c.b_aniso, g_scale = 1.0f;
  if (THERMAL) {
    seed = seeds[lane];
    sigma = aux[lane];
    budget = aux[cells + lane];
  }
  if (VARIATION) {
    alpha = aux[2 * cells + lane];
    denom = 1.0f + alpha * alpha;
    bk = aux[3 * cells + lane];
    g_scale = aux[4 * cells + lane];
  }
  const float never = (float)n_steps;
  float crossed = never;

  auto step = [&](int i) {
    if (THERMAL && !((float)i < budget)) return;   // frozen past its budget
    const float nz = NSUB == 2 ? 0.5f * (m1.z - m2.z) : m1.z;
    const float g = c.g_sum + c.g_dif * nz;
    float aj = c.pref * v * g / c.area;
    if (VARIATION) aj = aj * g_scale;
    const float ga = c.gamma * aj;
    const float gb = c.neg_gamma * (c.beta * aj);
    V3 bth1 = {0.0f, 0.0f, 0.0f}, bth2 = {0.0f, 0.0f, 0.0f};
    if (THERMAL) {
      const uint32_t cu = (uint32_t)i * 3u;
      float a0, b0, a1, b1, a2, b2;
      normal_pair(seed, cu, c.two_pi, a0, b0);
      normal_pair(seed, cu + 1u, c.two_pi, a1, b1);
      normal_pair(seed, cu + 2u, c.two_pi, a2, b2);
      bth1 = {sigma * a0, sigma * a1, sigma * a2};
      bth2 = {sigma * b0, sigma * b1, sigma * b2};
    }
    auto f = [&](V3 x1, V3 x2, V3& d1, V3& d2) {
      if (NSUB == 2) {
        d1 = rhs_one<THERMAL>(x1, x2, 1.0f, ga, gb, bth1, alpha, denom, bk, c);
        d2 = rhs_one<THERMAL>(x2, x1, -1.0f, ga, gb, bth2, alpha, denom, bk,
                              c);
      } else {
        d1 = rhs_one<THERMAL>(x1, x1, 1.0f, ga, gb, bth1, alpha, denom, bk, c);
      }
    };
    V3 k1a{}, k1b{}, k2a{}, k2b{}, k3a{}, k3b{}, k4a{}, k4b{};
    f(m1, m2, k1a, k1b);
    f(axpy(m1, c.half_dt, k1a), axpy(m2, c.half_dt, k1b), k2a, k2b);
    f(axpy(m1, c.half_dt, k2a), axpy(m2, c.half_dt, k2b), k3a, k3b);
    f(axpy(m1, c.dt, k3a), axpy(m2, c.dt, k3b), k4a, k4b);
    auto combine = [&](V3 m, V3 a, V3 b, V3 cc, V3 d) {
      V3 s = {a.x + 2.0f * b.x + 2.0f * cc.x + d.x,
              a.y + 2.0f * b.y + 2.0f * cc.y + d.y,
              a.z + 2.0f * b.z + 2.0f * cc.z + d.z};
      return renorm(axpy(m, c.dt6, s));
    };
    m1 = combine(m1, k1a, k2a, k3a, k4a);
    if (NSUB == 2) m2 = combine(m2, k1b, k2b, k3b, k4b);
    const float nz_new = NSUB == 2 ? 0.5f * (m1.z - m2.z) : m1.z;
    if (nz_new < c.neg_thr && crossed >= never) crossed = (float)(i + 1);
  };

  if (!THERMAL || chunk <= 0) {
    for (int i = 0; i < n_steps; ++i) step(i);
  } else {
    const int n_chunks = (n_steps + chunk - 1) / chunk;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const bool done = crossed < never || (float)(ci * chunk) >= budget;
      if (__syncthreads_and(done)) break;
      for (int j = 0; j < chunk; ++j) step(ci * chunk + j);
    }
  }

  out[lane] = m1.x;
  out[cells + lane] = m1.y;
  out[2 * cells + lane] = m1.z;
  out[3 * cells + lane] = NSUB == 2 ? m2.x : 0.0f;
  out[4 * cells + lane] = NSUB == 2 ? m2.y : 0.0f;
  out[5 * cells + lane] = NSUB == 2 ? m2.z : 0.0f;
  out[6 * cells + lane] = v;
  out[7 * cells + lane] = crossed;
}

template <bool THERMAL, bool VARIATION, int NSUB>
void launch(const float* state, const uint32_t* seeds, const float* aux,
            float* out, int cells, int n_steps, int chunk,
            const LLGConsts& c, cudaStream_t stream) {
  llg_rk4_kernel<THERMAL, VARIATION, NSUB>
      <<<cells / kBlock, kBlock, 0, stream>>>(state, seeds, aux, out, cells,
                                              n_steps, chunk, c);
}

}  // namespace

extern "C" {

int llg_rk4_block_size() { return kBlock; }

int llg_rk4_n_consts() { return (int)(sizeof(LLGConsts) / sizeof(float)); }

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int llg_rk4_launch(const float* state, const void* seeds, const float* aux,
                   float* out, int cells, int n_steps, int chunk, int nsub,
                   int thermal, int variation, const float* consts,
                   void* stream) {
  if (cells <= 0 || cells % kBlock != 0 || n_steps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  LLGConsts c;
  memcpy(&c, consts, sizeof(c));
  const uint32_t* s = static_cast<const uint32_t*>(seeds);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!thermal) {
    if (nsub == 2) {
      launch<false, false, 2>(state, s, aux, out, cells, n_steps, 0, c, st);
    } else {
      launch<false, false, 1>(state, s, aux, out, cells, n_steps, 0, c, st);
    }
  } else if (variation) {
    if (nsub == 2) {
      launch<true, true, 2>(state, s, aux, out, cells, n_steps, chunk, c, st);
    } else {
      launch<true, true, 1>(state, s, aux, out, cells, n_steps, chunk, c, st);
    }
  } else {
    if (nsub == 2) {
      launch<true, false, 2>(state, s, aux, out, cells, n_steps, chunk, c, st);
    } else {
      launch<true, false, 1>(state, s, aux, out, cells, n_steps, chunk, c, st);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
