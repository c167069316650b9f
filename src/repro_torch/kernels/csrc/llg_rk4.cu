// RK4 integrator of the coupled LLG system for thermal Monte-Carlo
// campaigns.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/llg_rk4.py:
// `_llg_kernel` (deterministic, fixed horizon) and `_llg_thermal_kernel`
// (Brown thermal field from the counter-RNG, per-lane sigma and step budget,
// chunked early exit, optional per-lane variation rows).  Template switches:
//   THERMAL    the thermal kernel (seeds + aux plane) vs the deterministic one
//   VARIATION  aux plane of 5 rows (+ alpha, B_k, g_scale) instead of 2
//   NSUB       2 = AFMTJ (staggered Neel STT), 1 = MTJ (single sublattice;
//              the reference runs it through its jnp oracle, not Pallas)
//   TPL        threads per lane: 1, or 2 for NSUB = 2 (one per sublattice)
//   CLUSTER    the exit group is a thread-block cluster (chunked exit only)
//   PRODUCE    noise producer threads draw the Brown-field normals a batch
//              of steps ahead into shared memory (chunked exit, C >= 8)
//
// Layout (as the Pallas kernel): state and out are (8, cells) float32
// (out may be state itself: a donated launch, see the end of the kernel),
// rows 0-2 = m1, 3-5 = m2 (zero for NSUB = 1), 6 = drive voltage,
// 7 = first step (1-based, as float32) with n_z < -threshold, n_steps if
// none; seeds (cells,) uint32; aux (2 or 5, cells) float32: row 0 = Brown
// sigma [T], 1 = step budget, 2-4 = alpha, B_k [T], g_scale.  cells is a
// multiple of the exit group (512 lanes).
//
// Arithmetic follows the reference's plain version (src/repro/kernels/ref.py
// through core/llg.py) operation by operation in float32: constants that the
// reference folds in double precision arrive in LLGConsts already rounded,
// the file is compiled with -fmad=false and without fast math, and logf,
// sqrtf, sinf, cosf and '/' are the correctly rounded or libdevice
// functions, not the __ intrinsics.  The state is renormalized by dividing
// by sqrtf(|m|^2), as ref.py does; the Pallas kernel multiplies by rsqrt
// instead, which differs by an ulp or two per step.  Every layout below
// performs each lane's operations in the same order on the same values, so
// every layout is bit-identical to the plain version.
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
// 272 (NSUB = 1) float32 operations per lane-step.  Each division issues
// one MUFU.RCP and each sqrtf one MUFU.RSQ; logf, sinf and cosf are
// polynomials on the FP32 pipe.  In the sm_90a SASS a lane-step issues
// about twice the counted operations (an IEEE division is ~10 instructions
// on its fast path, a libdevice logf or sinf/cosf a few dozen):
// tools/sass_census.py counts the instructions of the step's fast path by
// class, and chip_smoke.py divides them by the card's issue rate (the
// "issue floor").  Every input is read once and every output written once
// (64 bytes a lane), so the kernel is bound by instruction issue, never by
// memory: the campaign (1,536 groups, C = 1) runs at ~87% of its issue
// floor on an H100; launches of a few groups use a few warps per SM and
// are bound instead by the latency of one thread's per-step chain, which
// the layouts below spread and shorten.
//
// Design.  Each lane's whole state stays in registers for the full horizon
// (no tensor cores: the work is elementwise float32).  A 512-lane exit
// group (the Pallas kernel's CELL_TILE) leaves the loop as soon as all its
// lanes are done (a vote every `chunk` steps).  How a group maps onto the
// card is the launch's layout (C, TPL, P):
//   * C blocks per group, C in {1, 2, 4, 8, 16}: each block holds 512 / C
//     lanes.  Lane-warps (32 consecutive lanes) are dealt to the blocks in
//     turn (lane-warp w of the group to block w % C), so the live lanes of
//     a sparse group (the WER ladder: 128 live lanes in lane-warps 0-3)
//     land on different SMs.  With chunked exit the C blocks are one
//     thread-block cluster and vote in two steps: __syncthreads_and in each
//     block, then each block's thread 0 writes its flag into rank 0's
//     shared memory (distributed shared memory), one cluster barrier, and
//     every thread reads all flags back.  The flags are double-buffered by
//     chunk parity, so one cluster barrier per chunk suffices; all blocks
//     of a cluster see the same flags and run the same chunks, and pass a
//     last cluster barrier before leaving, since rank 0's shared memory
//     must outlive the others' reads.  Without chunked exit the blocks are
//     independent and are launched without a cluster.
//   * TPL = 2 (NSUB = 2): threads 2j and 2j + 1 carry sublattice 1 and 2 of
//     one lane and swap the other sublattice's stage input with
//     __shfl_xor_sync (3 floats per RK4 stage).  Both compute the drive and
//     the order parameter 0.5 (m1.z - m2.z), in that operand order.  Of the
//     three Box-Muller pairs, thread 2j draws pair 0 and thread 2j + 1 pair
//     1 whole, both draw pair 2, and one shuffle trades the halves each
//     lacks (the cosines are sublattice 1's normals, the sines sublattice
//     2's), so no warp diverges between sinf and cosf.
//   * P = 1 (PRODUCE, chunked thermal kernel, C >= 8): each block adds one
//     producer thread per lane, in warps of their own.  The producers
//     draw every normal of a batch of kBatch steps into a shared-memory
//     ring (two batches) while the lane threads integrate the batch
//     before, so the Box-Muller draws (about 40% of a thermal step's
//     instructions) leave the lane threads' chain; one __syncthreads per
//     batch hands a batch over (the chunk vote's barrier is the batch
//     barrier at a chunk's end).  The lane threads multiply the same
//     normals by the same sigma, so the bits do not change.
// Launches that fill the card keep C = 1, TPL = 1, P = 0; the wrapper's
// layout rule (kernels/llg_rk4.py) spreads launches of a few groups.
//
// The constants struct, the right-hand side and the RK4 combination live
// in llg_step.cuh, shared with the single-junction write (llg_write.cu).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "llg_step.cuh"

namespace cg = cooperative_groups;

namespace {

// Sizes owned by the wrapper (kernels/llg_rk4.py, BUILD_DEFINES), passed
// by kernels/build.py as -D flags.
#if !defined(LLG_GROUP) || !defined(LLG_MAX_CLUSTER) || !defined(LLG_BATCH) || \
    !defined(LLG_PRODUCER_MIN_C)
#error "build with kernels/build.py and llg_rk4.BUILD_DEFINES"
#endif
constexpr int kGroup = LLG_GROUP;          // CELL_TILE: lanes per exit group
constexpr int kWarp = 32;
constexpr int kMaxCluster = LLG_MAX_CLUSTER;   // non-portable above 8
constexpr int kBatch = LLG_BATCH;          // PRODUCE: steps per ring slot
// PRODUCE: lanes per block at most (C >= LLG_PRODUCER_MIN_C)
constexpr int kProducerLanes = kGroup / LLG_PRODUCER_MIN_C;
static_assert(kMaxCluster == 16,
              "the cluster vote reads one parity's 16 flags as one uint4");
constexpr int kClusterRefused = -1;   // llg_rk4_launch: no cluster fits

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

// The partner thread's value (TPL = 2); `pair` names the two threads.
__device__ __forceinline__ V3 swap_pair(unsigned pair, V3 x) {
  return {__shfl_xor_sync(pair, x.x, 1), __shfl_xor_sync(pair, x.y, 1),
          __shfl_xor_sync(pair, x.z, 1)};
}

template <bool THERMAL, bool VARIATION, int NSUB, int TPL, bool CLUSTER,
          bool PRODUCE>
__global__ void __launch_bounds__(kGroup * TPL)
    llg_rk4_kernel(const float* state, const uint32_t* __restrict__ seeds,
                   const float* __restrict__ aux, float* out, int cells,
                   int n_steps, int chunk, LLGConsts c) {
  static_assert(TPL == 1 || NSUB == 2, "two threads per lane need NSUB = 2");
  // The group's C blocks are consecutive (a cluster's blocks when
  // CLUSTER); lane-warp w of the group lives in block w % C.  With
  // PRODUCE the block's last lanes_blk threads are the producers.
  const int lanes_blk = (int)blockDim.x / (TPL + (PRODUCE ? 1 : 0));
  const int n_blk = kGroup / lanes_blk;      // C
  const int rank = (int)blockIdx.x % n_blk;
  const int group = (int)blockIdx.x / n_blk;
  const int t = (int)threadIdx.x;
  const bool producer = PRODUCE && t >= lanes_blk * TPL;
  // lane within the block, and this thread's sublattice
  const int local = producer ? t - lanes_blk * TPL : t / TPL;
  const int sub = TPL == 2 && !producer ? (t & 1) : 0;
  const int lane = group * kGroup + ((local / kWarp) * n_blk + rank) * kWarp +
                   local % kWarp;
  const unsigned pair = 3u << ((t % kWarp) & ~1);

  // m: this thread's sublattice (m1 for TPL = 1), o: the other one (m2 for
  // TPL = 1; rows 3-5 are zero for NSUB = 1 and unused)
  // (producers read no state: with out == state, a lane thread may write
  // its rows while a producer of its block has not started)
  const int ro = 3 * sub, rt = 3 - 3 * sub;
  V3 m = {0.0f, 0.0f, 0.0f}, o = {0.0f, 0.0f, 0.0f};
  float v = 0.0f;
  if (!producer) {
    m = {state[ro * cells + lane], state[(ro + 1) * cells + lane],
         state[(ro + 2) * cells + lane]};
    o = {state[rt * cells + lane], state[(rt + 1) * cells + lane],
         state[(rt + 2) * cells + lane]};
    v = state[6 * cells + lane];
  }
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
  const float sgn = sub ? -1.0f : 1.0f;
  // PRODUCE: ring[slot][k][n][lane] holds normal n of step k of a batch
  // (n = the three cosines, then for NSUB = 2 the three sines)
  constexpr int kNormals = 3 * NSUB;
  __shared__ float ring[PRODUCE ? 2 * kBatch * kNormals * kProducerLanes : 1];

  // order parameter 0.5 (m1.z - m2.z), m1 first whichever thread computes it
  auto order_z = [&]() {
    if (NSUB == 1) return m.z;
    const float z1 = sub ? o.z : m.z, z2 = sub ? m.z : o.z;
    return 0.5f * (z1 - z2);
  };

  auto step = [&](int i) {
    if (THERMAL && !((float)i < budget)) return;   // frozen past its budget
    const float nz = order_z();
    const float g = c.g_sum + c.g_dif * nz;
    float aj = c.pref * v * g / c.area;
    if (VARIATION) aj = aj * g_scale;
    const float ga = c.gamma * aj;
    const float gb = c.neg_gamma * (c.beta * aj);
    V3 bm = {0.0f, 0.0f, 0.0f}, bo = {0.0f, 0.0f, 0.0f};   // Brown fields
    if (THERMAL && PRODUCE) {
      const float* z = ring +
                       ((i / kBatch) % 2 * kBatch + i % kBatch) * kNormals *
                           lanes_blk + local;
      const float* zm = z + 3 * sub * lanes_blk;   // own sublattice's
      bm = {sigma * zm[0], sigma * zm[lanes_blk], sigma * zm[2 * lanes_blk]};
      if (TPL == 1 && NSUB == 2) {
        const float* zo = z + 3 * lanes_blk;
        bo = {sigma * zo[0], sigma * zo[lanes_blk], sigma * zo[2 * lanes_blk]};
      }
    } else if (THERMAL) {
      const uint32_t cu = (uint32_t)i * 3u;
      if (TPL == 1) {
        float a0, b0, a1, b1, a2, b2;
        normal_pair(seed, cu, c.two_pi, a0, b0);
        normal_pair(seed, cu + 1u, c.two_pi, a1, b1);
        normal_pair(seed, cu + 2u, c.two_pi, a2, b2);
        bm = {sigma * a0, sigma * a1, sigma * a2};
        bo = {sigma * b0, sigma * b1, sigma * b2};
      } else {
        // pair `sub` and pair 2 here; the partner holds the other pair
        float zc, zs, zc2, zs2;
        normal_pair(seed, cu + (uint32_t)sub, c.two_pi, zc, zs);
        normal_pair(seed, cu + 2u, c.two_pi, zc2, zs2);
        const float got = __shfl_xor_sync(pair, sub ? zc : zs, 1);
        bm = sub ? V3{sigma * got, sigma * zs, sigma * zs2}
                 : V3{sigma * zc, sigma * got, sigma * zc2};
      }
    }
    if (TPL == 2) {
      auto f = [&](V3 x, V3 xo) {
        return rhs_one<THERMAL>(x, xo, sgn, ga, gb, bm, alpha, denom, bk, c);
      };
      const V3 k1 = f(m, o);
      V3 x = axpy(m, c.half_dt, k1);
      const V3 k2 = f(x, swap_pair(pair, x));
      x = axpy(m, c.half_dt, k2);
      const V3 k3 = f(x, swap_pair(pair, x));
      x = axpy(m, c.dt, k3);
      const V3 k4 = f(x, swap_pair(pair, x));
      m = combine(m, k1, k2, k3, k4, c.dt6);
      o = swap_pair(pair, m);
    } else {
      auto f = [&](V3 x1, V3 x2, V3& d1, V3& d2) {
        if (NSUB == 2) {
          d1 = rhs_one<THERMAL>(x1, x2, 1.0f, ga, gb, bm, alpha, denom, bk, c);
          d2 = rhs_one<THERMAL>(x2, x1, -1.0f, ga, gb, bo, alpha, denom, bk,
                                c);
        } else {
          d1 = rhs_one<THERMAL>(x1, x1, 1.0f, ga, gb, bm, alpha, denom, bk, c);
        }
      };
      V3 k1a{}, k1b{}, k2a{}, k2b{}, k3a{}, k3b{}, k4a{}, k4b{};
      f(m, o, k1a, k1b);
      f(axpy(m, c.half_dt, k1a), axpy(o, c.half_dt, k1b), k2a, k2b);
      f(axpy(m, c.half_dt, k2a), axpy(o, c.half_dt, k2b), k3a, k3b);
      f(axpy(m, c.dt, k3a), axpy(o, c.dt, k3b), k4a, k4b);
      m = combine(m, k1a, k2a, k3a, k4a, c.dt6);
      if (NSUB == 2) o = combine(o, k1b, k2b, k3b, k4b, c.dt6);
    }
    if (order_z() < c.neg_thr && crossed >= never) crossed = (float)(i + 1);
  };

  // PRODUCE: the normals of steps i0 .. i0 + kBatch - 1 into ring slot
  auto produce = [&](int i0, int slot) {
#pragma unroll 1
    for (int k = 0; k < kBatch; ++k) {
      const uint32_t cu = (uint32_t)(i0 + k) * 3u;
      float* z = ring + (slot * kBatch + k) * kNormals * lanes_blk + local;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float zc, zs;
        normal_pair(seed, cu + (uint32_t)q, c.two_pi, zc, zs);
        z[q * lanes_blk] = zc;
        if (NSUB == 2) z[(3 + q) * lanes_blk] = zs;
      }
    }
  };

  if (!THERMAL || chunk <= 0) {
#pragma unroll 1
    for (int i = 0; i < n_steps; ++i) step(i);
  } else {
    // CLUSTER: rank 0's flags, one byte per block and chunk parity (bytes
    // of absent ranks stay 1)
    __shared__ alignas(16) unsigned char vote[2 * kMaxCluster];
    unsigned char* root = nullptr;
    if (CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      if (t < 2 * kMaxCluster) vote[t] = 1;
      root = cluster.map_shared_rank(vote, 0);
      cluster.sync();   // rank 0's flags set, every block running
    }
    const int n_chunks = (n_steps + chunk - 1) / chunk;
    int g = 0;   // PRODUCE: batches begun; ring slot g % 2 holds batch g
    if (producer) produce(0, 0);
#pragma unroll 1
    for (int ci = 0; ci < n_chunks; ++ci) {
      const bool done =
          producer || crossed < never || (float)(ci * chunk) >= budget;
      bool all = __syncthreads_and(done);
      if (CLUSTER) {
        const int par = ci & 1;
        if (t == 0) root[par * kMaxCluster + rank] = all ? 1 : 0;
        cg::this_cluster().sync();
        const uint4 w =
            *reinterpret_cast<const uint4*>(root + par * kMaxCluster);
        all = (w.x & w.y & w.z & w.w) == 0x01010101u;
      }
      if (all) break;
      if (PRODUCE) {
        // batch g + 1 is drawn while batch g is integrated; the barrier
        // after the chunk's last batch is the next vote's
        const int per_chunk = chunk / kBatch;
#pragma unroll 1
        for (int b = 0; b < per_chunk; ++b, ++g) {
          if (producer) {
            produce((g + 1) * kBatch, (g + 1) % 2);
          } else {
#pragma unroll 1
            for (int k = 0; k < kBatch; ++k) step(g * kBatch + k);
          }
          if (b + 1 < per_chunk) __syncthreads();
        }
      } else {
#pragma unroll 1
        for (int j = 0; j < chunk; ++j) step(ci * chunk + j);
      }
    }
    if (CLUSTER) cg::this_cluster().sync();   // rank 0 outlives the reads
  }
  if (producer) return;

  // out may be state itself (a donated launch): each lane's rows are read
  // above by that lane's threads only, so the one hazard is T = 2, where
  // thread 2j writes rows 0-2 that thread 2j + 1 read as its partner's
  // sublattice; the pair's barrier orders those reads before the writes
  // (a launch with no step has met no shuffle)
  if (TPL == 2) __syncwarp(pair);
  if (sub == 0) {
    out[lane] = m.x;
    out[cells + lane] = m.y;
    out[2 * cells + lane] = m.z;
    out[6 * cells + lane] = v;
    out[7 * cells + lane] = crossed;
  }
  if (TPL == 2 ? sub == 1 : true) {
    const V3 m2 = TPL == 2 ? m : (NSUB == 2 ? o : V3{0.0f, 0.0f, 0.0f});
    out[3 * cells + lane] = m2.x;
    out[4 * cells + lane] = m2.y;
    out[5 * cells + lane] = m2.z;
  }
}

struct Args {
  const float* state;
  const uint32_t* seeds;
  const float* aux;
  float* out;
  int cells, n_steps, chunk;
  LLGConsts c;
};

// One launch of `groups` exit groups of n_blk blocks each; a cluster of
// n_blk blocks per group when CLUSTER.
template <bool THERMAL, bool VARIATION, int NSUB, int TPL, bool CLUSTER,
          bool PRODUCE>
int launch(const Args& a, int n_blk, cudaStream_t stream) {
  auto kern = llg_rk4_kernel<THERMAL, VARIATION, NSUB, TPL, CLUSTER, PRODUCE>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.cells / kGroup * n_blk));
  cfg.blockDim = dim3((unsigned)(kGroup / n_blk * (TPL + (PRODUCE ? 1 : 0))));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (CLUSTER) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
        n_blk > 8 ? 1 : 0);
    if (err != cudaSuccess) return (int)err;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)n_blk;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fit < 1) return kClusterRefused;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a.state, a.seeds, a.aux,
                                       a.out, a.cells, a.n_steps, a.chunk,
                                       a.c);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The C blocks of a group form a cluster only for the chunked thermal
// kernel, the one that votes across them; producers need that kernel.
template <bool THERMAL, bool VARIATION, int NSUB, int TPL>
int launch_tpl(const Args& a, int n_blk, bool cluster, bool produce,
               cudaStream_t stream) {
  if constexpr (THERMAL) {
    if (cluster && produce) {
      return launch<THERMAL, VARIATION, NSUB, TPL, true, true>(a, n_blk,
                                                                stream);
    }
    if (cluster) {
      return launch<THERMAL, VARIATION, NSUB, TPL, true, false>(a, n_blk,
                                                                 stream);
    }
  }
  return launch<THERMAL, VARIATION, NSUB, TPL, false, false>(a, n_blk,
                                                              stream);
}

template <bool THERMAL, bool VARIATION, int NSUB>
int launch_layout(const Args& a, int n_blk, int tpl, bool cluster,
                  bool produce, cudaStream_t stream) {
  if constexpr (NSUB == 2) {
    if (tpl == 2) {
      return launch_tpl<THERMAL, VARIATION, 2, 2>(a, n_blk, cluster, produce,
                                                  stream);
    }
  }
  return launch_tpl<THERMAL, VARIATION, NSUB, 1>(a, n_blk, cluster, produce,
                                                 stream);
}

}  // namespace

extern "C" {

int llg_rk4_n_consts() { return (int)(sizeof(LLGConsts) / sizeof(float)); }

// Message of a code llg_rk4_launch returned.
const char* llg_rk4_error_string(int code) {
  if (code == kClusterRefused) {
    return "the card cannot schedule one cluster of this size "
           "(cudaOccupancyMaxActiveClusters = 0)";
  }
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` with `n_blk` blocks (C) and `tpl` threads per lane
// per 512-lane exit group, with noise producers if `produce`, and returns
// 0, a cudaError_t, or kClusterRefused.
int llg_rk4_launch(const float* state, const void* seeds, const float* aux,
                   float* out, int cells, int n_steps, int chunk, int nsub,
                   int thermal, int variation, const float* consts,
                   void* stream, int n_blk, int tpl, int produce) {
  const bool pow2 = n_blk > 0 && (n_blk & (n_blk - 1)) == 0;
  const bool chunked = thermal && chunk > 0;
  if (cells <= 0 || cells % kGroup != 0 || n_steps < 0 || !pow2 ||
      n_blk > kMaxCluster || (tpl != 1 && tpl != 2) ||
      (tpl == 2 && nsub != 2) || (nsub != 1 && nsub != 2) ||
      (produce && !(chunked && chunk % kBatch == 0 &&
                    kGroup / n_blk <= kProducerLanes))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.state = state;
  a.seeds = static_cast<const uint32_t*>(seeds);
  a.aux = aux;
  a.out = out;
  a.cells = cells;
  a.n_steps = n_steps;
  a.chunk = chunk;
  memcpy(&a.c, consts, sizeof(a.c));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cluster = chunked && n_blk > 1;
  const bool prod = produce != 0;
  if (!thermal) {
    return nsub == 2
               ? launch_layout<false, false, 2>(a, n_blk, tpl, false, false, st)
               : launch_layout<false, false, 1>(a, n_blk, tpl, false, false,
                                                st);
  }
  if (variation) {
    return nsub == 2
               ? launch_layout<true, true, 2>(a, n_blk, tpl, cluster, prod, st)
               : launch_layout<true, true, 1>(a, n_blk, tpl, cluster, prod, st);
  }
  return nsub == 2
             ? launch_layout<true, false, 2>(a, n_blk, tpl, cluster, prod, st)
             : launch_layout<true, false, 1>(a, n_blk, tpl, cluster, prod, st);
}

}  // extern "C"
