// Capacity-window place step for one request (the BCPM "place" half).
//
// Replaces src/repro/kernels/place/place.py:35 (_kernel, the Pallas TPU
// kernel launched by place_window_pallas).  It computes, for C (n, K),
// cap (n,) and prefix (K,), all float32 and unpadded:
//
//   P[v,k]  = min over j of cand[v,k,j],
//             cand[v,k,j] = C[v,j] if j <= k and prefix[k]-prefix[j] <= cap[v]+1e-6
//                           BIG    otherwise
//   pj[v,k] = the FIRST (smallest) j that attains the minimum
//
// exactly like the reference's jnp.min/jnp.argmin over the candidate row,
// for any prefix (monotone or not) and any C.  The scan covers only j <= k,
// ascending, seeded with the candidate at j = 0 and a strict <, so it gives
// the first minimum over j <= k.  When that minimum is below BIG it is the
// reference's answer: the BIG candidates (infeasible j, j > k) cannot beat
// it.  When it is BIG at j = 0, the seed, it is the answer too: nothing is
// below it and j = 0 comes first (so a row with no feasible j gives P = BIG,
// pj = 0).  Only a C above BIG leads anywhere else; then the row is scanned
// again exactly as the reference builds it, all K candidates with BIG where
// infeasible.
// Every step is one float32 subtract or compare; the file is built without
// fast-math and with -fmad=false.
//
// Note the tie rule: the DP's own place step (leastcost._place_step and the
// batched superstep kernel) keeps the LARGEST j.  This kernel is the op
// repro.kernels.place.place_window and is not wired into any DP.
//
// What bounds it on an H100: it moves n*K*12 + n*4 + K*4 bytes (C in, P and
// pj out, cap, prefix) for n*K*(K+1)/2 candidates.  At the port's path
// shapes (n <= 4096) the bytes take under 0.2 us, so the launch itself
// dominates; at n = 2^20 rows the bytes bound is 35 us at K = 9 and 125 us at
// K = 33.  The design: a block of 128 threads owns 128 consecutive rows,
// whose C entries are one contiguous range; it copies them into shared
// memory with 16-byte cp.async copies, each thread takes its row into
// registers and scans only j <= k, and P and pj go back through shared
// memory as 16-byte coalesced stores.  prefix[k] - prefix[j] does not depend
// on the row, so the block computes the K x K table once and a candidate
// costs two compares and two predicated copies (see relax), plus a quarter
// of a broadcast shared load.  Instances: K <= 9 and K <= 33 (the unrolled
// k loop stops at the launch's K, so no j > k and no k >= K is scanned).
// A few rows (the op's path shapes, n <= 4096) or a larger K take a
// one-thread-per-(v, k) kernel instead: there the launch is latency.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e18f;
constexpr float kEpsCap = 1e-6f;
constexpr int kRows = 128;  // rows (and threads) per block
// Up to this many rows the one-thread-per-(v, k) kernel is faster than the
// tiled one (NVIDIA H100 80GB HBM3, 700 W, tools/kernel_ab.py).
constexpr int kPairKernelRows = 8192;

__host__ __device__ constexpr int padded(int k) { return (k + 3) & ~3; }

// Shared memory of the tiled kernel, in bytes: the rows' C, P and pj, and
// the prefix-difference table (KT rows of padded(KT)).
__host__ __device__ constexpr int tile_smem(int KT, int K) {
  return 4 * (3 * kRows * K + KT * padded(KT));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

// One candidate j of (v, k): take C[v,j] when d = prefix[k]-prefix[j] <=
// capv and it is strictly below the running minimum.  The taken value and
// j are copied by a predicated FFMA (c * 1 - 0, exact for every float) and
// IMAD (bj * 0 + j) on the FMA pipes, not by selects on the half-rate ALU
// pipe; `one` and `zero` come from the launch so ptxas cannot fold them.
__device__ __forceinline__ void relax(float c, float d, float capv, int j,
                                      float one, int zero, float& best,
                                      int& bj) {
  asm("{\n\t"
      ".reg .pred m, t;\n\t"
      "setp.le.f32 m, %2, %3;\n\t"
      "setp.lt.and.f32 t, %4, %0, m;\n\t"
      "@t fma.rn.f32 %0, %4, %5, 0f80000000;\n\t"
      "@t mad.lo.s32 %1, %1, %7, %6;\n\t"
      "}"
      : "+f"(best), "+r"(bj)
      : "f"(d), "f"(capv), "f"(c), "f"(one), "r"(j), "r"(zero));
}

// K <= KT.  `vec`: C, P and pj are 16-byte aligned (the block's range
// starts at row r0, a multiple of 128, so it is too).
// (No __launch_bounds__(kRows): with it, ptxas of CUDA 12.9 caps the KT = 33
// instance at 64 registers and spills; without it, 72 and no spill.)
template <int KT>
__global__ void place_tile_kernel(const float* __restrict__ C,
                                  const float* __restrict__ cap,
                                  const float* __restrict__ prefix,
                                  float* __restrict__ P, int* __restrict__ pj,
                                  int n, int K, bool vec, float one,
                                  int zero) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KTP = padded(KT);
  float* tile = smem;                                       // C
  float* pt = smem + kRows * K;                             // P
  int* jt = reinterpret_cast<int*>(smem + 2 * kRows * K);   // pj
  float* dt = smem + 3 * kRows * K;                         // prefix differences
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, n - r0);
  const int elems = rows * K;
  const long long base = r0 * K;
  const int quads = vec ? elems / 4 : 0;

  for (int q = tid; q < quads; q += kRows)
    cp_async16(tile + 4 * q, C + base + 4 * q);
  for (int e = 4 * quads + tid; e < elems; e += kRows)
    cp_async4(tile + e, C + base + e);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = tid; e < K * K; e += kRows) {
    const int k = e / K;
    const int j = e - k * K;
    dt[k * KTP + j] = prefix[k] - prefix[j];
  }
  const float capv = tid < rows ? cap[r0 + tid] + kEpsCap : 0.0f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if (tid < rows) {
    float c[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) c[j] = j < K ? tile[tid * K + j] : kBig;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k >= K) break;  // uniform: the launch's K
      const float* dk = dt + k * KTP;
      // the row's differences four at a time (broadcast loads), so that
      // only four of them are live
      float best = dk[0] <= capv ? c[0] : kBig;  // the candidate at j = 0
      int bj = 0;
#pragma unroll
      for (int q = 0; q <= k / 4; ++q) {
        const float4 x = reinterpret_cast<const float4*>(dk)[q];
        const float d[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * q + i;
          if (j >= 1 && j <= k) relax(c[j], d[i], capv, j, one, zero, best, bj);
        }
      }
      if (!(best < kBig || (best == kBig && bj == 0))) {  // C above BIG
        const float* crow = tile + tid * K;
        best = kBig;
        bj = 0;
#pragma unroll 1
        for (int j = 0; j < K; ++j) {
          const float cj = (j <= k && dk[j] <= capv) ? crow[j] : kBig;
          if (j == 0 || cj < best) {
            best = cj;
            bj = j;
          }
        }
      }
      pt[tid * K + k] = best;
      jt[tid * K + k] = bj;
    }
  }
  __syncthreads();

  for (int q = tid; q < quads; q += kRows) {
    reinterpret_cast<float4*>(P + base)[q] = reinterpret_cast<const float4*>(pt)[q];
    reinterpret_cast<int4*>(pj + base)[q] = reinterpret_cast<const int4*>(jt)[q];
  }
  for (int e = 4 * quads + tid; e < elems; e += kRows) {
    P[base + e] = pt[e];
    pj[base + e] = jt[e];
  }
}

// Few rows, or K > 33: one thread per (v, k), scanning j <= k as the tiled
// kernel does, with C, prefix and cap read through L1.  At the port's path
// shapes a launch is mostly latency, and this kernel has no shared memory,
// no barrier and the shortest chain per thread (k candidates).
__global__ void place_pair_kernel(const float* __restrict__ C,
                                  const float* __restrict__ cap,
                                  const float* __restrict__ prefix,
                                  float* __restrict__ P, int* __restrict__ pj,
                                  int n, int K, float one, int zero) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * K) return;
  const int v = (int)(idx / K);
  const int k = (int)(idx - (long long)v * K);
  const float capv = cap[v] + kEpsCap;
  const float pk = prefix[k];
  const float* crow = C + (long long)v * K;
  float best = pk - prefix[0] <= capv ? crow[0] : kBig;  // the seed, j = 0
  int bj = 0;
  for (int j = 1; j <= k; ++j)
    relax(crow[j], pk - prefix[j], capv, j, one, zero, best, bj);
  if (!(best < kBig || (best == kBig && bj == 0))) {  // C above BIG
    best = kBig;
    bj = 0;
    for (int j = 0; j < K; ++j) {
      const float cj = (j <= k && pk - prefix[j] <= capv) ? crow[j] : kBig;
      if (j == 0 || cj < best) {
        best = cj;
        bj = j;
      }
    }
  }
  P[idx] = best;
  pj[idx] = bj;
}

template <int KT>
cudaError_t launch_tile(const float* C, const float* cap, const float* prefix,
                        float* P, int* pj, int n, int K, bool vec,
                        cudaStream_t stream) {
  const int smem = tile_smem(KT, K);
  cudaError_t err = cudaFuncSetAttribute(
      place_tile_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned int blocks = (unsigned int)((n + kRows - 1) / kRows);
  place_tile_kernel<KT><<<blocks, kRows, smem, stream>>>(
      C, cap, prefix, P, pj, n, K, vec, 1.0f, 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" int place_window_launch(const float* C, const float* cap,
                                   const float* prefix, float* P, int* pj,
                                   int n, int K, cudaStream_t stream) {
  const long long total = (long long)n * K;
  if (total == 0) return 0;
  const bool vec = ((unsigned long long)C % 16) == 0 &&
                   ((unsigned long long)P % 16) == 0 &&
                   ((unsigned long long)pj % 16) == 0;
  if (K <= 9 && n > kPairKernelRows)
    return (int)launch_tile<9>(C, cap, prefix, P, pj, n, K, vec, stream);
  if (K <= 33 && n > kPairKernelRows)
    return (int)launch_tile<33>(C, cap, prefix, P, pj, n, K, vec, stream);
  const int threads = 128;
  place_pair_kernel<<<(unsigned int)((total + threads - 1) / threads), threads,
                      0, stream>>>(C, cap, prefix, P, pj, n, K, 1.0f, 0);
  return (int)cudaGetLastError();
}

extern "C" const char* place_window_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
