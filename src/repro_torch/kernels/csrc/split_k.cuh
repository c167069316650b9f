// Pieces shared by the analog GEMM sources (analog_mac.cu, xnor_gemm.cu):
// 16-byte cp.async with zero fill, the split-K chunk rule, the split-order
// sum of the partials, the dynamic shared-memory opt-in, the dependent
// launch of the split-K reduce grid and the launch on the operands' device.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int REDUCE_THREADS = 256;

// 16 bytes global -> shared, asynchronous; zero-filled when !pred (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K range [lo, hi) of chunk z of `splits`: whole BK steps (chunk z takes
// steps [z S / splits, (z + 1) S / splits) of S), the last one cut at K.
// No chunk is empty while splits <= S (kernels/analog_mac.py split_count).
template <int BK>
__device__ __forceinline__ void k_range(int K, int splits, int z, int& lo,
                                        int& hi) {
  const long long steps = (K + BK - 1) / BK;
  lo = (int)(z * steps / splits) * BK;
  hi = min((int)((z + 1) * steps / splits) * BK, K);
}

// Lets the dependent reduce grid launch; it waits for this grid to finish.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// In the reduce grid: wait until the mainloop grid has finished and its
// partials are visible.
__device__ __forceinline__ void wait_for_mainloop() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ws[0][e] + ws[1][e] + ... in split order; eight loads are issued before
// their adds, so the partials' latencies overlap.
__device__ __forceinline__ float sum_partials(const float* __restrict__ ws,
                                              size_t mn, size_t e, int splits) {
  float y = ws[e];
  int s = 1;
  for (; s + 8 <= splits; s += 8) {
    float p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = ws[(size_t)(s + j) * mn + e];
#pragma unroll
    for (int j = 0; j < 8; ++j) y = y + p[j];
  }
  for (; s < splits; ++s) y = y + ws[(size_t)s * mn + e];
  return y;
}

// Dynamic shared memory above 48 KB is opt-in, once per kernel and device.
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, uint64_t* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// Grid of the reduce pass over M N outputs (grid-stride beyond 4096 blocks).
inline unsigned reduce_blocks(int M, int N) {
  const size_t blocks = ((size_t)M * N + REDUCE_THREADS - 1) / REDUCE_THREADS;
  return (unsigned)(blocks < 4096 ? blocks : 4096);
}

// Launch the split-K reduce grid as a programmatic dependent of the mainloop
// launched just before it on `s`, after checking that launch: the reduce
// grid's launch overlaps the mainloop, and wait_for_mainloop holds it until
// the partials are written.
template <typename... Params, typename... Args>
cudaError_t launch_reduce(void (*kernel)(Params...), int M, int N,
                          cudaStream_t s, Args... args) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(reduce_blocks(M, N));
  cfg.blockDim = dim3(REDUCE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Run `launch` with `device` (the operands' card) current, and give the
// caller's device back after it: the wrappers pass the index, so no device
// switch is paid in Python.
template <typename F>
int on_device(int device, F launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const int rc = launch();
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

}  // namespace
