// Capacity-window place step for one request (the BCPM "place" half).
//
// Replaces repro/kernels/place/place.py::_kernel (the Pallas TPU kernel
// launched by place_window_pallas).  It computes, for C (n, K), cap (n,)
// and prefix (K,), all float32 and unpadded:
//
//   P[v,k]  = min over j of cand[v,k,j],
//             cand[v,k,j] = C[v,j] if j <= k and prefix[k]-prefix[j] <= cap[v]+1e-6
//                           BIG    otherwise
//   pj[v,k] = the FIRST (smallest) j that attains the minimum
//
// exactly like the reference's jnp.min/jnp.argmin over the candidate row:
// an ascending j loop over all K candidates, seeded with j = 0, keeps the
// first minimum with a strict <, so a row with no feasible j gives
// P = BIG, pj = 0.  The TPU kernel's padding (cap -1, prefix BIG) only
// touches padded rows and columns that are sliced away, so nothing here is
// padded.  Every step is one float32 subtract, add or compare; the file is
// built without fast-math and with -fmad=false.
//
// Note the tie rule: the DP's own place step (leastcost._place_step and the
// batched superstep kernel) keeps the LARGEST j.  This kernel is the op
// repro.kernels.place.place_window and is not wired into any DP.
//
// What bounds it on an H100: it moves n*K*12 + n*4 + K*4 bytes (C in, P and
// pj out, cap, prefix) and does about K^2 compare/selects per row, so at
// every shape the port uses (n <= 4096, K <= 33) the bytes take well under
// a microsecond and the launch itself dominates.  One thread per (v, k)
// with the row of C read from L1 is all the design needs.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e18f;
constexpr float kEpsCap = 1e-6f;

__global__ void place_window_kernel(const float* __restrict__ C,
                                    const float* __restrict__ cap,
                                    const float* __restrict__ prefix,
                                    float* __restrict__ P,
                                    int* __restrict__ pj, int n, int K) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * K) return;
  const int v = (int)(idx / K);
  const int k = (int)(idx - (long long)v * K);
  const float capv = cap[v] + kEpsCap;
  const float pk = prefix[k];
  const float* crow = C + (long long)v * K;
  float best = kBig;
  int bj = 0;
  for (int j = 0; j < K; ++j) {  // ascending j: strict < keeps the first j
    const float c = (j <= k && pk - prefix[j] <= capv) ? crow[j] : kBig;
    if (j == 0 || c < best) {
      best = c;
      bj = j;
    }
  }
  P[idx] = best;
  pj[idx] = bj;
}

}  // namespace

extern "C" int place_window_launch(const float* C, const float* cap,
                                   const float* prefix, float* P, int* pj,
                                   int n, int K, cudaStream_t stream) {
  long long total = (long long)n * K;
  if (total == 0) return 0;
  int threads = 256;
  unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  place_window_kernel<<<blocks, threads, 0, stream>>>(C, cap, prefix, P, pj,
                                                      n, K);
  return (int)cudaGetLastError();
}

extern "C" const char* place_window_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
