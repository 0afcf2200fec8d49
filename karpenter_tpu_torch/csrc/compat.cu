// Requirement compatibility of group rows against type (or template, or
// bin) rows.
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
// What bounds it on an H100: at the solver's shapes (G×T 32×1024, G×M
// 32×2, one group row × 1536 bins, K=9, W=16) the bytes and operations
// are well under a microsecond, so latency bounds it: how many warps are
// in flight and how many dependent global round trips each makes. At
// scale (hundreds of group rows × thousands of types) the AND/OR work
// bounds it; 32-bit logic issues at 64 lanes per clock per SM, a quarter
// of the float32 FMA rate the bound is counted against.
//
// Design:
// - One (g,t) pair per thread, or an RG × RT register tile (4 group rows
//   × 4 types) when the shape has many more pairs than the card has
//   threads: then each 16-byte unit read from shared memory serves four
//   pairs, not one, which is what bounds the large shapes (group words
//   are warp-wide broadcasts, type words one row per lane). A block
//   covers TT types × TG group rows; the wrapper's `compat_tile` picks
//   TT, TG, RG, RT and the key chunk KC from (G, T, K, W) so a launch
//   spreads over the SMs, and passes them here.
// - Rows are staged in shared memory with cp.async, KC keys at a time
//   (the key axis is streamed when a whole row does not fit), with
//   neighbouring threads on neighbouring addresses: 16-byte copies when W
//   is a multiple of 4 and the masks are 16-byte aligned, 4-byte copies
//   otherwise. Each thread issues all its copies before waiting, so a
//   staging phase costs one memory latency, not one per copy. The tile's
//   has/tol bytes are contiguous runs, copied 16 bytes at a time into
//   shared memory at the same offset mod 16 as their source. Type rows
//   are padded to a stride of 4 mod 8 words (16-byte path) or an odd
//   stride (4-byte path), so lanes reading different type rows hit
//   different banks.
// - Dead work is skipped exactly, from the tile's own data: a key that no
//   group row of the tile defines is not visited, and a 16-byte (or
//   4-byte) unit that is zero in every group row defining its key can
//   give no overlap, so it is neither loaded nor tested on the type side.
//   The block lists the live units once per chunk (ballots in warp 0);
//   the type rows' live units are then copied in one coalesced pass.
//   A launch therefore makes two dependent trips to memory: group rows
//   (with every has/tol byte), then the type rows' live units.
// - The [G,T] byte output is written along T: a warp writes 32
//   neighbouring bytes of one group row.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_SMEM = 232448;  // dynamic shared memory per block, H100

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Bytes of shared memory for the has (or tol) bytes of n rows of K keys,
// shifted to their source's offset mod 16.
__host__ __device__ inline int byte_run(int n, int K) { return round_up(n * K + 15, 16); }

__device__ inline void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of n bytes from src to the 16-aligned shared buffer dst
// at src's offset mod 16; returns where the bytes land. 16-byte copies
// for the aligned body; the head and tail bytes are copied by
// `finish_bytes` once every cp.async of the phase is in flight.
__device__ inline uint8_t* start_bytes(uint8_t* dst, const uint8_t* src, int n,
                                       int tid, int nthreads) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min(n, (16 - shift) & 15);
  const int nvec = (n - head) / 16;
  for (int i = tid; i < nvec; i += nthreads)
    cp_async(dst + shift + head + 16 * i, src + head + 16 * i, 16);
  return dst + shift;
}

__device__ inline void finish_bytes(uint8_t* dst, const uint8_t* src, int n,
                                    int tid, int nthreads) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min(n, (16 - shift) & 15);
  const int body_end = head + (n - head) / 16 * 16;
  for (int i = tid; i < head + n - body_end; i += nthreads) {
    const int o = i < head ? i : body_end + i - head;
    dst[o] = src[o];
  }
}

template <int VEC> struct Unit;
template <> struct Unit<4> { using type = int4; };
template <> struct Unit<1> { using type = int32_t; };

__device__ inline int32_t or_all(int4 x) { return x.x | x.y | x.z | x.w; }
__device__ inline int32_t or_all(int32_t x) { return x; }
__device__ inline int32_t and_any(int4 a, int4 b) {
  return (a.x & b.x) | (a.y & b.y) | (a.z & b.z) | (a.w & b.w);
}
__device__ inline int32_t and_any(int32_t a, int32_t b) { return a & b; }

// Calls f(r, c) for this thread's share of a rows × cols grid (cell
// i = r * cols + c for i = tid, tid + nthreads, ...), with one division
// per call instead of one per cell.
template <class F>
__device__ inline void for_cells(int rows, int cols, int tid, int nthreads, F f) {
  if (cols <= 0) return;
  int r = tid / cols, c = tid - r * cols;
  const int dr = nthreads / cols, dc = nthreads - dr * cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// Block: TT types × TG group rows. With TL = TT / RT, thread
// tid < TL * (TG / RG) tests types t0 + tid % TL + q * TL (q < RT) against
// group rows g0 + (tid / TL) * RG + r (r < RG); all blockDim.x threads
// share the staging. A launch that leaves SMs idle gets more threads
// than pairs, so its staging and flag phases are spread wider.
template <int RG, int RT, int VEC>
__global__ void __launch_bounds__(256, 2)
compat_kernel(const int32_t* __restrict__ g_mask,
              const uint8_t* __restrict__ g_has,
              const uint8_t* __restrict__ g_tol,
              const int32_t* __restrict__ t_mask,
              const uint8_t* __restrict__ t_has,
              const uint8_t* __restrict__ t_tol,
              uint8_t* __restrict__ out,
              int G, int T, int K, int W, int TT, int TG, int KC) {
  using U = typename Unit<VEC>::type;
  extern __shared__ __align__(16) int32_t smem[];
  const int KCW = KC * W;
  const int S = round_up(KCW, 8) + (VEC == 4 ? 4 : 1);
  const int SG = round_up(KCW, 8) + 4;
  const int UW = W / VEC;  // units per key
  int32_t* s_t = smem;                 // [TT][S]   live units of type rows
  int32_t* s_g = s_t + TT * S;         // [TG][SG]  group rows
  int32_t* s_units = s_g + TG * SG;    // [KC*UW]   word offset of each live unit
  int32_t* s_kstart = s_units + KCW;   // [KC+1]    first live unit of each key
  int32_t* s_keys = s_kstart + KC + 1; // [KC]      keys some group row defines
  int32_t* s_cnt = s_keys + KC;        // [2]       live units, live keys
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem) +
                   round_up(4 * (TT * S + TG * SG + KCW + 2 * KC + 3), 16);
  uint8_t* b_ghas = bytes;                       // has/tol runs of the tile,
  uint8_t* b_gtol = b_ghas + byte_run(TG, K);    // [rows][K] each, all keys
  uint8_t* b_thas = b_gtol + byte_run(TG, K);
  uint8_t* b_ttol = b_thas + byte_run(TT, K);
  uint8_t* s_flag = b_ttol + byte_run(TT, K);    // [KC*UW] live units
  uint8_t* s_kdef = s_flag + KCW;                // [KC]    defined keys

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int t0 = blockIdx.x * TT, g0 = blockIdx.y * TG;
  const int nt = min(TT, T - t0), ng = min(TG, G - g0);
  const int TL = TT / RT;
  const bool tests = tid < TL * (TG / RG);
  const int ti = tid % TL, gq = (tid / TL) * RG;
  const size_t KW = (size_t)K * W;

  const uint8_t* src_ghas = g_has + (size_t)g0 * K;
  const uint8_t* src_gtol = g_tol + (size_t)g0 * K;
  const uint8_t* src_thas = t_has + (size_t)t0 * K;
  const uint8_t* src_ttol = t_tol + (size_t)t0 * K;
  uint8_t* s_ghas = start_bytes(b_ghas, src_ghas, ng * K, tid, nthreads);
  uint8_t* s_gtol = start_bytes(b_gtol, src_gtol, ng * K, tid, nthreads);
  uint8_t* s_thas = start_bytes(b_thas, src_thas, nt * K, tid, nthreads);
  uint8_t* s_ttol = start_bytes(b_ttol, src_ttol, nt * K, tid, nthreads);

  unsigned ok = ~0u;  // bit r * RT + q: pair (gq + r, ti + q * TL)

  for (int kc0 = 0; kc0 < K; kc0 += KC) {
    const int kcn = min(KC, K - kc0);
    const int nu = kcn * UW;

    // 1. group rows of this chunk (and, with the first chunk, the has/tol
    //    bytes started above): every copy in flight, then one wait
    for_cells(ng, nu, tid, nthreads, [&](int g, int u) {
      cp_async(s_g + g * SG + u * VEC,
               g_mask + (g0 + g) * KW + (size_t)kc0 * W + u * VEC, 4 * VEC);
    });
    for (int u = tid; u < nu; u += nthreads) s_flag[u] = 0;
    for (int k = tid; k < kcn; k += nthreads) s_kdef[k] = 0;
    if (kc0 == 0) {
      finish_bytes(s_ghas, src_ghas, ng * K, tid, nthreads);
      finish_bytes(s_gtol, src_gtol, ng * K, tid, nthreads);
      finish_bytes(s_thas, src_thas, nt * K, tid, nthreads);
      finish_bytes(s_ttol, src_ttol, nt * K, tid, nthreads);
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. a unit is live iff some group row that defines its key has a
    //    nonzero word in it; a key is visited iff some group row defines
    //    it. One (group row, unit) or (group row, key) per thread.
    for_cells(ng, nu, tid, nthreads, [&](int g, int u) {
      if (s_ghas[g * K + kc0 + u / UW] &&
          or_all(*reinterpret_cast<const U*>(s_g + g * SG + u * VEC)) != 0)
        s_flag[u] = 1;
    });
    for_cells(ng, kcn, tid, nthreads, [&](int g, int k) {
      if (s_ghas[g * K + kc0 + k]) s_kdef[k] = 1;
    });
    __syncthreads();

    // 3. warp 0 lists the live units (grouped by key, in order) and the
    //    keys some group row defines
    if (tid < 32) {
      const int lanes = min(32, nthreads);
      const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1;
      const unsigned below = (1u << tid) - 1;
      int base = 0;
      for (int u0 = 0; u0 < nu; u0 += lanes) {
        const int u = u0 + tid;
        const bool live = u < nu && s_flag[u];
        const unsigned m = __ballot_sync(mask, live);
        const int pos = base + __popc(m & below);
        if (live) s_units[pos] = u * VEC;
        if (u < nu && u % UW == 0) s_kstart[u / UW] = pos;
        base += __popc(m);
      }
      int nk = 0;
      for (int k0 = 0; k0 < kcn; k0 += lanes) {
        const int k = k0 + tid;
        const bool def = k < kcn && s_kdef[k];
        const unsigned m = __ballot_sync(mask, def);
        if (def) s_keys[nk + __popc(m & below)] = k;
        nk += __popc(m);
      }
      if (tid == 0) {
        s_kstart[kcn] = base;
        s_cnt[0] = base;
        s_cnt[1] = nk;
      }
    }
    __syncthreads();
    const int nlive = s_cnt[0], nkeys = s_cnt[1];

    // 4. the live units of the tile's type rows, one coalesced pass
    for_cells(nt, nlive, tid, nthreads, [&](int t, int j) {
      const int off = s_units[j];
      cp_async(s_t + t * S + off,
               t_mask + (t0 + t) * KW + (size_t)kc0 * W + off, 4 * VEC);
    });
    cp_async_wait_all();
    __syncthreads();

    // 5. test this thread's pairs, key by key, over the live units only
    for (int kk = 0; tests && kk < nkeys; ++kk) {
      const int k = s_keys[kk];
      unsigned th = 0, tl = 0;  // bit q: type ti + q * TL defines / tolerates k
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int t = ti + q * TL;
        if (t < nt && s_thas[t * K + kc0 + k]) th |= 1u << q;
        if (t < nt && s_ttol[t * K + kc0 + k]) tl |= 1u << q;
      }
      if (!th) continue;
      int32_t ov[RG][RT];
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int q = 0; q < RT; ++q) ov[r][q] = 0;
      const int j1 = s_kstart[k + 1];
      for (int j = s_kstart[k]; j < j1; ++j) {
        const int off = s_units[j];
        U tw[RT];
#pragma unroll
        for (int q = 0; q < RT; ++q)
          tw[q] = *reinterpret_cast<const U*>(s_t + (ti + q * TL) * S + off);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const U gw = *reinterpret_cast<const U*>(s_g + (gq + r) * SG + off);
#pragma unroll
          for (int q = 0; q < RT; ++q) ov[r][q] |= and_any(gw, tw[q]);
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int g = gq + r;
        if (g >= ng || !s_ghas[g * K + kc0 + k]) continue;
        const bool gtol = s_gtol[g * K + kc0 + k] != 0;
#pragma unroll
        for (int q = 0; q < RT; ++q)
          if ((th >> q & 1) && ov[r][q] == 0 && !((tl >> q & 1) && gtol))
            ok &= ~(1u << (r * RT + q));
      }
    }
    __syncthreads();  // the next chunk overwrites the tile
  }

#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const int g = gq + r, t = ti + q * TL;
      if (tests && g < ng && t < nt)
        out[(size_t)(g0 + g) * T + t0 + t] = (ok >> (r * RT + q)) & 1;
    }
}

__global__ void noop_kernel() {}

// The launch arguments, as the wrapper packs them: 20 little-endian int64.
struct CompatArgs {
  int64_t g_mask, g_has, g_tol, t_mask, t_has, t_tol, out;
  int64_t G, T, K, W, tt, tg, rg, rt, kc, threads, smem, device, stream;
};

template <int RG, int RT, int VEC>
int launch(const CompatArgs& a) {
  static unsigned raised = 0;  // devices where the >48 KB opt-in is set
  const int smem = (int)a.smem;
  if (smem > 48 * 1024 && !(raised & (1u << a.device))) {
    cudaError_t e = cudaFuncSetAttribute(
        compat_kernel<RG, RT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    raised |= 1u << a.device;
  }
  const int G = (int)a.G, T = (int)a.T, tt = (int)a.tt, tg = (int)a.tg;
  dim3 grid((T + tt - 1) / tt, (G + tg - 1) / tg);
  compat_kernel<RG, RT, VEC><<<grid, (int)a.threads, smem,
                           reinterpret_cast<cudaStream_t>(a.stream)>>>(
      reinterpret_cast<const int32_t*>(a.g_mask),
      reinterpret_cast<const uint8_t*>(a.g_has),
      reinterpret_cast<const uint8_t*>(a.g_tol),
      reinterpret_cast<const int32_t*>(a.t_mask),
      reinterpret_cast<const uint8_t*>(a.t_has),
      reinterpret_cast<const uint8_t*>(a.t_tol),
      reinterpret_cast<uint8_t*>(a.out), G, T, (int)a.K, (int)a.W, tt, tg,
      (int)a.kc);
  return (int)cudaGetLastError();
}

// The register tiles compat_tile chooses: one pair per thread, or 4 × 4.
template <int VEC>
int launch_tile(const CompatArgs& a) {
  if (a.rg == 1 && a.rt == 1) return launch<1, 1, VEC>(a);
  if (a.rg == 4 && a.rt == 4) return launch<4, 4, VEC>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the kernel on the given device and stream with the tile the
// wrapper chose (`compat_tile`: tt types × tg group rows per block, rg
// group rows × rt types per thread, kc keys per shared-memory chunk,
// threads per block, smem dynamic bytes). `packed` holds the 20 int64 of
// CompatArgs, in that order: one pointer instead of 20 arguments keeps
// the Python call cheap. Returns
// the cudaError_t of the launch (0 on success). Does not synchronise,
// allocates nothing, and leaves the calling thread's device as it was.
int karpenter_compat(const void* packed) {
  CompatArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.G <= 0 || a.T <= 0) return 0;
  if (a.tt <= 0 || a.rg <= 0 || a.rt <= 0 || a.tg % a.rg != 0 ||
      a.tt % a.rt != 0 || a.kc <= 0 || a.smem > MAX_SMEM ||
      (a.tt / a.rt) * (a.tg / a.rg) > a.threads || a.threads > 256 ||
      a.device < 0 || a.device >= 32)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != a.device && (e = cudaSetDevice((int)a.device)) != cudaSuccess)
    return (int)e;
  const bool vec = a.W % 4 == 0 && ((a.g_mask | a.t_mask) & 15) == 0;
  const int rc = vec ? launch_tile<4>(a) : launch_tile<1>(a);
  if (current != a.device) cudaSetDevice(current);
  return rc;
}

// An empty kernel: the least device time any launch takes.
int karpenter_compat_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* karpenter_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
