// The fused fake-analog MVM (B5) of the port, for sm_90a: a warp-specialised
// float32 SIMT GEMM whose B operand, the differential conductance g_diff, is
// replayed from the normalized weights by producer warps.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   fake_analog  <- repro/kernels/fake_analog.py  fake_analog_mac_pallas / _fake_kernel
//
// out(M, N) = adc(V(M, K) @ g_diff(K, N)) * decode, with
//   g_diff = att_pos * tp - att_neg * tn,
//   tp, tn = G_AP + max(+-wn, 0) G_FS, the optional FET / corner round trip,
//            then the fail / fault code decode (floor -> stuck-on -> dead),
// the operation order of the reference's _tile_g_diff; the ADC on the
// per-column full scale (aux row I_MAX), times the per-column decode gain.
//
// What bounds it on an H100: 2 M K N float32 operations against 67 TFLOP/s
// at the unembed (896 x 151,936 at M = 128: ~35 GFLOP over ~0.6 GB); the
// replay adds 5 operations per (k, n) element on the path (23 with the FET
// round trip and the fail decode).  At the split shapes (every other
// linear of the path) it is SM fill and launch latency: at most 132 blocks
// of 1-19 K steps each.  IEEE float32 is owed (fmaf, -fmad=false, no TF32),
// so the tensor cores are out of reach.
//
// Design (Hopper warp specialisation), one block per SM.
// * Producer warps (one warpgroup for the path's instance, two for the
//   FET / fail ones, whose replay is ~4x longer; setmaxnreg.dec to 72 / 80
//   registers) and two consumer warpgroups (setmaxnreg.inc to 216 / 176).
//   Block tile 128 x 128 x 16 and its K chunks as the bit-line MAC's
//   (analog_mac.cu).
// * Each producer thread copies 16-byte chunks of the raw wn (and fail)
//   tile of each K step into a private RAW-stage ring (cp.async; 4-byte
//   copies unless N % 4 == 0 and the pointers are aligned), replays exactly
//   those elements LAG steps later into the step's g_diff stage (never in
//   place), and arrives on the stage's "full" mbarrier: its own
//   cp.async.wait_group is the only wait before the replay.
// * The consumers copy and transpose V themselves (As[k][m], 4-byte
//   cp.async as the bit-line MAC), each warp the 16 rows its own threads
//   read, so no consumer waits for another warp: a warp waits on its own
//   copies and the stage's "full" mbarrier, runs the bit-line MAC's 8 x 8
//   register micro-tile fmaf mainloop, and releases the stage on its
//   "empty" mbarrier (one arrival per warp); the producer waits on "empty"
//   before it reuses a g_diff stage.  So the replay of the next steps and
//   the copies of step k + 3 run while the consumers compute step k, and
//   no barrier of the whole block is left in the loop.  Copies run from
//   per-thread source pointers advanced one K step at a time.
// * The replay's per-block constants are hoisted: the broadcast scalars,
//   and for each of the producer thread's four columns its attenuations and
//   their products with the conductance of the unweighted side.  One side
//   of every pair gets no weight (wn > 0: tn, wn < 0: tp, wn == 0: both),
//   and its conductance is G_AP (fet(G_AP) with the FET round trip), one
//   constant per block computed with the same operations; so each element
//   takes one FET round trip, and without fail codes g_diff is m * t + c
//   with per-column m and c picked by the sign of wn.  Every value equals
//   the plain formula's bit for bit (finite wn): the products and sums are
//   the same IEEE operations, a - b == a + (-b) and (-x) * y == -(x * y).
// * The fail decode works on integers: for codes in [-2^31, 2^31) bit j of
//   (int)floorf(code), two's complement, is floor(code * 2^-j) mod 2 with
//   a floored mod, as the plain version's fail_bit (torch.remainder, like
//   the reference's jnp.mod) computes it, every step exact; NaN, infinite
//   and larger codes decode to no bit, as that formula does there (beyond
//   2^31 a float has no set bit below 2^7).  Only negative subnormal codes
//   differ (the formula's product underflows to -0).  The wrapper's
//   contract is codes 0 .. FAIL_CODE_MAX (kernels/fake_analog.py).
// * Deterministic split-K as the bit-line MAC: blockIdx.z takes the z-th of
//   `splits` contiguous K chunks (k_range<16>, split_k.cuh; `splits` comes
//   from the bit-line MAC's tile), each output one fmaf chain from 0.0f
//   over its chunk in K order; reduce_kernel adds the partials in split
//   order and applies the epilogue (a programmatic dependent launch).  On
//   the same g_diff the raw currents are bit-equal to the bit-line MAC's.
// * Edges are guarded, not padded: V rows beyond M and entries beyond the
//   chunk load as 0; g_diff rows beyond the chunk are written 0 (columns
//   beyond N feed only outputs that are never stored).
// * Two blocks per SM (the bit-line MAC's occupancy) do not fit: 768
//   threads leave 80 registers a thread, so 32 for the producers and 104
//   for the consumers; a build so split spilled and ran slower than one
//   block per SM.
// * A wait that never completes traps (~8 s of spinning) instead of hanging
//   the card; the launcher refuses (returns -1) if the compiled register
//   count at launch is not LAUNCH_REGS, which the warpgroups' register
//   split assumes (setmaxnreg.inc would otherwise wait for ever).
// Built with -fmad=false and without fast math, so the replay's and the
// ADC's products, sums and divisions round one by one, as the plain
// PyTorch version's separate operations do; rintf rounds half to even like
// jnp.round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "analog_common.cuh"
#include "split_k.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int STAGES = 4;        // V ring and g_diff ring
constexpr int LAG = 2;           // the replay of step t follows copy t + LAG
constexpr int RAW = LAG + 1;     // the producer's raw wn / fail ring
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int A_LD = BM + 4;                          // As[k][m] row, floats
constexpr int A_TILE = BK * A_LD;
constexpr int G_TILE = BK * BN;
constexpr int A_PER_THREAD = BM * BK / CONSUMERS;     // 8 four-byte copies
constexpr int COLS4 = BN / 4;                         // 16-byte chunks per row
// fail-plane bits (kernels/fake_analog.py FAIL_* / FAULT_*)
constexpr int TP_FLOOR = 1 | 4;     // write-verify fail / stuck-off, positive
constexpr int TN_FLOOR = 2 | 8;     // the same, negative
constexpr int TP_ON = 16;
constexpr int TN_ON = 32;
constexpr int DEAD = 64;

// The block of an instance: one producer warpgroup for the path's replay
// (no FET, no fail plane), two for the others (their replay is ~4x
// longer); the warpgroups' register split at one block per SM.
template <bool APPLY_FET, bool USE_FAIL>
struct Block {
  static constexpr int PRODUCERS = (APPLY_FET || USE_FAIL) ? 256 : 128;
  static constexpr int THREADS = PRODUCERS + CONSUMERS;
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;   // 168, 128
  static constexpr int PRODUCER_REGS = PRODUCERS == 128 ? 72 : 80;
  static constexpr int CONSUMER_REGS =
      (THREADS * LAUNCH_REGS - PRODUCERS * PRODUCER_REGS) / CONSUMERS / 8 * 8;
  static constexpr int ROWS_PER_PASS = PRODUCERS / COLS4;
  static constexpr int ROWS_PER_THREAD = BK / ROWS_PER_PASS;
  static constexpr int SMEM =
      (STAGES * (A_TILE + G_TILE) + (USE_FAIL ? 2 : 1) * RAW * G_TILE) * 4;
  static_assert(CONSUMER_REGS >= LAUNCH_REGS && CONSUMER_REGS <= 256, "");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive on the mbarrier at shared address `bar`.
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of parity `parity`; trap
// after ~2^34 cycles (a pipeline that can never complete).
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// The code's bits: (int)floorf(code) for codes in [-2^31, 2^31), else none.
__device__ __forceinline__ int fail_bits(float code) {
  return (code >= -2147483648.0f && code < 2147483648.0f) ? (int)floorf(code)
                                                          : 0;
}

// The producer warpgroups: raw tile copies, replay, "full" arrivals.
// Thread p copies 16-byte chunks (columns col .. col + 3 of rows row0 +
// ROWS_PER_PASS i) of each raw tile and replays exactly those elements.
// Barriers are passed as shared addresses (full[s] = full + 8 s).
template <bool VEC, bool APPLY_FET, bool USE_FAIL>
__device__ __forceinline__ void produce(
    float* g_ring, float* raw_w, float* raw_f, unsigned full, unsigned empty,
    const float* __restrict__ wn, const float* __restrict__ fail,
    const float* __restrict__ aux, int N, int n0, int k_lo, int k_hi,
    int nk) {
  using B = Block<APPLY_FET, USE_FAIL>;
  constexpr int RPT = B::ROWS_PER_THREAD;
  const int p = threadIdx.x;
  const int col = (p % COLS4) * 4;
  const int row0 = p / COLS4;

  // copies: element offset of row row0 at the next step to issue, and the
  // offsets of the thread's other rows from it
  size_t src = (size_t)(k_lo + row0) * N + n0 + col;
  const size_t k_step = (size_t)BK * N;
  const size_t row_step = (size_t)B::ROWS_PER_PASS * N;
  int issue_k0 = k_lo;
  int issue_slot = 0;
  auto issue = [&]() {
    float* Ws = raw_w + issue_slot * G_TILE + row0 * BN + col;
    float* Fs = raw_f + issue_slot * G_TILE + row0 * BN + col;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const bool row_ok = issue_k0 + row0 + i * B::ROWS_PER_PASS < k_hi;
      const int dst = i * B::ROWS_PER_PASS * BN;
      if (VEC) {
        const bool ok = row_ok && n0 + col < N;
        const size_t off = ok ? src + i * row_step : 0;
        cp_async16(Ws + dst, wn + off, ok);
        if (USE_FAIL) cp_async16(Fs + dst, fail + off, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = row_ok && n0 + col + j < N;
          const size_t off = ok ? src + i * row_step + j : 0;
          cp_async4(Ws + dst + j, wn + off, ok);
          if (USE_FAIL) cp_async4(Fs + dst + j, fail + off, ok);
        }
      }
    }
    src += k_step;
    issue_k0 += BK;
    issue_slot = issue_slot + 1 == RAW ? 0 : issue_slot + 1;
  };

  // the copies of the first LAG steps go out before the constants load
#pragma unroll
  for (int t = 0; t < LAG; ++t) {
    if (t < nk) issue();
    cp_async_commit();
  }

  // per-block constants: the broadcast scalars, and this thread's columns'
  const float g_ap = aux[(size_t)ROW_G_AP * N];
  const float g_fs = aux[(size_t)ROW_G_FS * N];
  float r_access = 0.0f, g_scale = 0.0f;
  float fa = g_ap;   // conductance of a side without weight
  if (APPLY_FET) {
    r_access = aux[(size_t)ROW_R_ACCESS * N];
    g_scale = aux[(size_t)ROW_G_SCALE * N];
    fa = fet(g_ap, r_access, g_scale);
  }
  const float g_on = g_ap + g_fs;
  float att_p[4], att_n[4], c_pos[4], c_neg[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + col + j;
    att_p[j] = gn < N ? aux[(size_t)ROW_ATT_POS * N + gn] : 0.0f;
    att_n[j] = gn < N ? aux[(size_t)ROW_ATT_NEG * N + gn] : 0.0f;
    // without fail codes g_diff = m * t + c: (m, c) = (att_p, -(att_n fa))
    // for wn > 0, (-att_n, att_p fa) otherwise
    c_pos[j] = -(att_n[j] * fa);
    c_neg[j] = att_p[j] * fa;
  }

  auto element = [&](int j, float w, float code) {
    // the weighted side's target, G_AP + |wn| G_FS, and its round trip
    float t = g_ap + fabsf(w) * g_fs;
    if (APPLY_FET) t = fet(t, r_access, g_scale);
    const bool pos = w > 0.0f;
    if (!USE_FAIL)
      return (pos ? att_p[j] : -att_n[j]) * t + (pos ? c_pos[j] : c_neg[j]);
    float tp = pos ? t : fa;
    float tn = w < 0.0f ? t : fa;
    const int bits = fail_bits(code);
    if (bits & TP_FLOOR) tp = g_ap;
    if (bits & TN_FLOOR) tn = g_ap;
    if (bits & TP_ON) tp = g_on;
    if (bits & TN_ON) tn = g_on;
    if (bits & DEAD) {
      tp = 0.0f;
      tn = 0.0f;
    }
    return att_p[j] * tp - att_n[j] * tn;
  };

  int k0 = k_lo;          // the step being replayed
  int raw_slot = 0;
  int slot = 0;           // its g_diff stage
  unsigned round = 0;     // times the g_diff ring has wrapped
  for (int t = LAG; t < nk + LAG; ++t) {
    if (t < nk) issue();
    cp_async_commit();
    cp_async_wait<LAG>();     // this thread's copies of step t - LAG
    // the stage's last reader: step t - LAG - STAGES, released by the
    // consumers' completion `round - 1` of its "empty" barrier
    if (round > 0) mbar_wait(empty + 8 * slot, (round - 1) & 1);
    const float* Ws = raw_w + raw_slot * G_TILE + row0 * BN + col;
    const float* Fs = raw_f + raw_slot * G_TILE + row0 * BN + col;
    float* Gs = g_ring + slot * G_TILE + row0 * BN + col;
    float4 w4[RPT], f4[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      w4[i] = *reinterpret_cast<const float4*>(Ws + i * B::ROWS_PER_PASS * BN);
      f4[i] = USE_FAIL ? *reinterpret_cast<const float4*>(
                             Fs + i * B::ROWS_PER_PASS * BN)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    const int rows = k_hi - k0;   // rows of the chunk left (a K tail: < BK)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const bool live = rows >= BK || row0 + i * B::ROWS_PER_PASS < rows;
      float4 x;
      x.x = live ? element(0, w4[i].x, f4[i].x) : 0.0f;
      x.y = live ? element(1, w4[i].y, f4[i].y) : 0.0f;
      x.z = live ? element(2, w4[i].z, f4[i].z) : 0.0f;
      x.w = live ? element(3, w4[i].w, f4[i].w) : 0.0f;
      *reinterpret_cast<float4*>(Gs + i * B::ROWS_PER_PASS * BN) = x;
    }
    mbar_arrive(full + 8 * slot);
    k0 += BK;
    raw_slot = raw_slot + 1 == RAW ? 0 : raw_slot + 1;
    if (++slot == STAGES) {
      slot = 0;
      ++round;
    }
  }
}

template <bool VEC, bool APPLY_FET, bool USE_FAIL>
__global__ void __launch_bounds__((Block<APPLY_FET, USE_FAIL>::THREADS), 1)
    fake_kernel(const float* __restrict__ a, const float* __restrict__ wn,
                const float* __restrict__ fail, const float* __restrict__ aux,
                float* __restrict__ out, float* __restrict__ ws, int M, int K,
                int N, int splits, int adc_bits) {
  using B = Block<APPLY_FET, USE_FAIL>;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  float* a_ring = smem;
  float* g_ring = a_ring + STAGES * A_TILE;
  float* raw_w = g_ring + STAGES * G_TILE;
  float* raw_f = raw_w + RAW * G_TILE;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  int k_lo, k_hi;
  k_range<BK>(K, splits, blockIdx.z, k_lo, k_hi);
  const int nk = (k_hi - k_lo + BK - 1) / BK;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], B::PRODUCERS);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
  }
  __syncthreads();
  launch_dependents();

  const unsigned full_bar = smem_addr(full);
  const unsigned empty_bar = smem_addr(empty);
  if (tid < B::PRODUCERS) {
    setmaxnreg_dec<B::PRODUCER_REGS>();
    produce<VEC, APPLY_FET, USE_FAIL>(g_ring, raw_w, raw_f, full_bar,
                                      empty_bar, wn, fail, aux, N, n0, k_lo,
                                      k_hi, nk);
    return;
  }
  setmaxnreg_inc<B::CONSUMER_REGS>();
  const int c = tid - B::PRODUCERS;

  // V stages, copied and transposed as the bit-line MAC copies them, but
  // each consumer warp copies the 16 rows its own threads read (8w .. 8w +
  // 7 and 64 + 8w .. 64 + 8w + 7), so no other warp waits for its copies:
  // lane l copies column l % 16 of rows 2 i + l / 16 of that list.
  const int lane = c % 32;
  const int warp = c / 32;
  const int a_col = lane % BK;
  const float* a_src[A_PER_THREAD];
  int a_dst[A_PER_THREAD];
  bool a_row_ok[A_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_PER_THREAD; ++i) {
    const int rr = 2 * i + lane / BK;                    // 0 .. 15
    const int r = (rr < 8 ? 0 : 64 - 8) + 8 * warp + rr;
    const int gm = m0 + r;
    a_row_ok[i] = gm < M;
    a_src[i] = a + (size_t)(a_row_ok[i] ? gm : 0) * K + k_lo + a_col;
    a_dst[i] = a_col * A_LD + r;
  }
  int load_k = k_lo + a_col;
  int load_slot = 0;
  auto load_a = [&]() {
    float* As = a_ring + load_slot * A_TILE;
    const bool k_ok = load_k < k_hi;
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const bool ok = k_ok && a_row_ok[i];
      cp_async4(As + a_dst[i], ok ? a_src[i] : a, ok);
      a_src[i] += BK;
    }
    load_k += BK;
    load_slot = load_slot + 1 == STAGES ? 0 : load_slot + 1;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_a();
    cp_async_commit();
  }
  const int tx = c % 16;
  const int ty = c / 16;
  int slot = 0;
  unsigned round = 0;     // times the rings have wrapped
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // this thread's V copies of step kt
    __syncwarp();                  // ... and its warp's
    mbar_wait(full_bar + 8 * slot, round & 1);
    const float* As = a_ring + slot * A_TILE;
    const float* Bs = g_ring + slot * G_TILE;
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
    // this warp is done with step kt: release its g_diff stage, and refill
    // its V stage of step kt - 1 with step kt + STAGES - 1
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * slot);
    if (kt + STAGES - 1 < nk) load_a();
    cp_async_commit();
    if (++slot == STAGES) {
      slot = 0;
      ++round;
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
          y[j] = adc(y[j], adc_bits, aux[(size_t)ROW_I_MAX * N + gn + j]) *
                 aux[(size_t)ROW_DECODE * N + gn + j];
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

// Split-K second pass: the partials added in split order, then the ADC and
// the decode gain.
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_kernel(const float* __restrict__ ws, const float* __restrict__ aux,
                  float* __restrict__ out, int M, int N, int splits,
                  int adc_bits) {
  const size_t mn = (size_t)M * N;
  const size_t stride = (size_t)gridDim.x * REDUCE_THREADS;
  const int stride_n = (int)(stride % N);   // the column advances this much
  size_t e = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  int gn = (int)(e % N);
  wait_for_mainloop();
  for (; e < mn; e += stride) {
    out[e] = adc(sum_partials(ws, mn, e, splits), adc_bits,
                 aux[(size_t)ROW_I_MAX * N + gn]) *
             aux[(size_t)ROW_DECODE * N + gn];
    gn += stride_n;
    if (gn >= N) gn -= N;
  }
}

template <bool VEC, bool APPLY_FET, bool USE_FAIL>
int launch(const float* a, const float* wn, const float* fail,
           const float* aux, float* out, float* ws, int M, int K, int N,
           int splits, int adc_bits, cudaStream_t s) {
  using B = Block<APPLY_FET, USE_FAIL>;
  constexpr int smem = B::SMEM;
  static uint64_t done = 0;
  static int regs = 0;
  auto* kernel = fake_kernel<VEC, APPLY_FET, USE_FAIL>;
  if (regs == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    regs = attr.numRegs;
  }
  if (regs != B::LAUNCH_REGS) return -1;
  cudaError_t err = allow_smem(kernel, smem, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
                  (unsigned)splits);
  kernel<<<grid, B::THREADS, smem, s>>>(a, wn, fail, aux, out, ws, M, K, N,
                                     splits, adc_bits);
  if (splits > 1) {
    err = launch_reduce(reduce_kernel, M, N, s, (const float*)ws, aux, out, M,
                        N, splits, adc_bits);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile geometry (0: BM, 1: BN, 2: BK), read once by kernels/analog_mac.py.
int fake_analog_tile(int dim) { return dim == 0 ? BM : dim == 1 ? BN : BK; }

// Returns 0, a cudaError_t, or -1 when the kernel's compiled register count
// is not the LAUNCH_REGS its warpgroup split assumes.
int fake_analog_launch(const float* v, const float* wn, const float* fail,
                       const float* aux, float* out, float* ws, int M, int K,
                       int N, int splits, int vec, int adc_bits, int apply_fet,
                       int use_fail, int device, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
#define FAKE(V, F, U)                                                        \
  return launch<V, F, U>(v, wn, fail, aux, out, ws, M, K, N, splits,         \
                         adc_bits, s)
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
