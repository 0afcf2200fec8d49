// Requirement compatibility of group rows against type (or template) rows.
//
// Replaces the JAX package's Pallas kernel `compat_pallas`
// (karpenter_tpu/ops/pallas_kernels.py, body `_compat_kernel`), and
// lifts its single-word limit: any number of keys K and mask words W.
//
//   out[g,t] = AND_k ( !(g_has[g,k] && t_has[t,k])
//                      || OR_w (g_mask[g,k,w] & t_mask[t,k,w]) != 0
//                      || (g_tol[g,k] && t_tol[t,k]) )
//
// Layout: masks are int32 bit patterns, row-major [rows, K, W]; has/tol
// are one byte per key (torch.bool), row-major [rows, K]; out is one byte
// per (g,t) cell, row-major [G, T].
//
// What bounds it on an H100: bytes. Each type row (K*W words) is read
// once per block of TILE_G group rows, each group row once per block of
// TILE_T types, and the work per byte is one AND, one OR and a compare.
// At the headline (G=32, T=1024, K=9, W=16) the whole input is ~0.6 MB
// and the kernel is launch-bound long before either limit.
//
// Design: a block covers TILE_G group rows × TILE_T types, one thread per
// type. It stages the TILE_G group rows (masks, has, tol) in shared
// memory, so every thread reads them as broadcasts, and each thread
// streams its own type row from global memory once, key by key, word by
// word, testing each word against all TILE_G groups while it sits in a
// register. Threads of a warp read neighbouring type rows (strided, not
// coalesced); the rows are small and stay in L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_T = 128;  // types per block (one per thread)
constexpr int TILE_G = 8;    // group rows staged per block

__global__ void compat_kernel(const int32_t* __restrict__ g_mask,
                              const uint8_t* __restrict__ g_has,
                              const uint8_t* __restrict__ g_tol,
                              const int32_t* __restrict__ t_mask,
                              const uint8_t* __restrict__ t_has,
                              const uint8_t* __restrict__ t_tol,
                              uint8_t* __restrict__ out,
                              int G, int T, int K, int W) {
  extern __shared__ int32_t smem[];
  const int KW = K * W;
  int32_t* s_mask = smem;                                         // [TILE_G][K*W]
  uint8_t* s_has = reinterpret_cast<uint8_t*>(smem + TILE_G * KW);  // [TILE_G][K]
  uint8_t* s_tol = s_has + TILE_G * K;                              // [TILE_G][K]

  const int g0 = blockIdx.y * TILE_G;
  const int ng = min(TILE_G, G - g0);
  for (int i = threadIdx.x; i < ng * KW; i += blockDim.x)
    s_mask[i] = g_mask[(size_t)g0 * KW + i];
  for (int i = threadIdx.x; i < ng * K; i += blockDim.x) {
    s_has[i] = g_has[(size_t)g0 * K + i];
    s_tol[i] = g_tol[(size_t)g0 * K + i];
  }
  __syncthreads();

  const int t = blockIdx.x * TILE_T + threadIdx.x;
  if (t >= T) return;

  bool ok[TILE_G];
#pragma unroll
  for (int g = 0; g < TILE_G; ++g) ok[g] = true;

  const int32_t* tm = t_mask + (size_t)t * KW;
  for (int k = 0; k < K; ++k) {
    // a key the type leaves undefined constrains nothing
    if (!t_has[(size_t)t * K + k]) continue;
    const bool tt = t_tol[(size_t)t * K + k] != 0;
    int32_t ov[TILE_G];
#pragma unroll
    for (int g = 0; g < TILE_G; ++g) ov[g] = 0;
    for (int w = 0; w < W; ++w) {
      const int32_t tw = tm[k * W + w];
#pragma unroll
      for (int g = 0; g < TILE_G; ++g)
        if (g < ng) ov[g] |= s_mask[g * KW + k * W + w] & tw;
    }
#pragma unroll
    for (int g = 0; g < TILE_G; ++g) {
      if (g < ng && s_has[g * K + k] && ov[g] == 0 && !(tt && s_tol[g * K + k]))
        ok[g] = false;
    }
  }
#pragma unroll
  for (int g = 0; g < TILE_G; ++g)
    if (g < ng) out[(size_t)(g0 + g) * T + t] = ok[g] ? 1 : 0;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for K keys of W words.
size_t karpenter_compat_smem_bytes(int K, int W) {
  return (size_t)TILE_G * K * W * sizeof(int32_t) + 2 * (size_t)TILE_G * K;
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success). Does not synchronise and allocates nothing.
int karpenter_compat(const void* g_mask, const void* g_has, const void* g_tol,
                     const void* t_mask, const void* t_has, const void* t_tol,
                     void* out, int G, int T, int K, int W, void* stream) {
  if (G <= 0 || T <= 0) return 0;
  const size_t smem = karpenter_compat_smem_bytes(K, W);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        compat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((T + TILE_T - 1) / TILE_T, (G + TILE_G - 1) / TILE_G);
  compat_kernel<<<grid, TILE_T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(g_mask), static_cast<const uint8_t*>(g_has),
      static_cast<const uint8_t*>(g_tol), static_cast<const int32_t*>(t_mask),
      static_cast<const uint8_t*>(t_has), static_cast<const uint8_t*>(t_tol),
      static_cast<uint8_t*>(out), G, T, K, W);
  return (int)cudaGetLastError();
}

const char* karpenter_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
