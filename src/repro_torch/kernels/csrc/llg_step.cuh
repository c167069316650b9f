// One RK4 step of the coupled LLG system, shared by the LLG kernels:
// llg_rk4.cu (the campaign kernel, B1/B2) and llg_write.cu (the
// single-junction write of core/device.simulate_write).  Every function
// repeats the plain version's float32 operations (core/llg.py,
// core/integrator.py) in order; see llg_rk4.cu for the arithmetic rules
// (-fmad=false, no fast math, IEEE division and sqrtf).
#pragma once

namespace {

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

// core/llg.llg_rhs for one sublattice: m its moment, mo the other one (m
// itself for NSUB = 1, where B_E = 0), s its STT sign (+1 or -1: the
// products with it are exact, so a run-time sign gives the bits of a
// literal one).  The polarization is (0, 0, s), so m x p and m x (m x p)
// keep only their nonzero products; the dropped terms are exact zeros in
// the reference's full cross products.
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

// m + dt6 (a + 2 b + 2 c + d), renormalized (core/integrator.rk4_step)
__device__ __forceinline__ V3 combine(V3 m, V3 a, V3 b, V3 cc, V3 d,
                                      float dt6) {
  const V3 s = {a.x + 2.0f * b.x + 2.0f * cc.x + d.x,
                a.y + 2.0f * b.y + 2.0f * cc.y + d.y,
                a.z + 2.0f * b.z + 2.0f * cc.z + d.z};
  return renorm(axpy(m, dt6, s));
}

}  // namespace
