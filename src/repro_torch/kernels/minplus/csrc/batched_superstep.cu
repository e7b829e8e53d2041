// One fused DP superstep of the batched (min,+) LeastCostMap relaxation,
// for B requests against one shared resource network.
//
// Replaces repro/kernels/minplus/batched.py::_superstep_kernel (the Pallas
// TPU kernel launched by batched_superstep_pallas).  It computes
//
//   place:  P[b,v,k]  = min over j <= k with prefix[b,k]-prefix[b,j] <= cap[v]+1e-6
//                       of C[b,v,j]                     ties -> LARGEST j (pj)
//   move:   C'[b,w,k] = min over v with bw[v,w] >= breq_k[b,k]
//                       of min(P[b,v,k] + lat[v,w], BIG)  ties -> FIRST v
//   update: where C' < C - 1e-9: C = C', par_v = winning v, par_j = pj[b,v,k]
//
// Every step is a float32 compare/select or a single float32 add, written in
// the same order as the plain PyTorch version, so the two agree bit for bit.
// Constants are float literals and the file must be built without fast-math
// (and with -fmad=false, although no product is formed here).
//
// What bounds it on an H100: the move does about B*n^2*K candidates per
// superstep (6.0e8 at B=64, n=1024, K=9), each a handful of FP32-pipe
// compare/select/add operations, against only ~8*n^2 bytes of lat/bw that
// every (b, k) pair shares.  It is bound by CUDA-core compare/select
// throughput, not by memory; min-plus has no tensor-core (wgmma) form.
//
// What the design does about it: the move block stages a (32 v x 32 w) tile
// of lat and bw and a (64 pairs x 32 v) tile of P in shared memory, and each
// thread keeps 8 (b, k) running minima in registers, so one lat/bw load
// from shared memory serves 8 candidates and one P load (a warp broadcast)
// serves one candidate.  Device memory traffic per superstep is a few
// passes over lat/bw/P through L2; the inner loop is compare/select only.
//
// The place phase writes P and its argmin pj to a (B*K, n) scratch (pair
// major, v contiguous) so the move loads P tiles coalesced.  Ragged n, B and
// K are masked, never padded.  The outputs are written out of place.
//
// Optional device control word `flags` = [t, active, changed, max_rounds]
// lets the host enqueue supersteps without reading anything back: a
// superstep with active == 0 copies its input state unchanged, and the
// finish kernel advances t and clears active at the fixpoint or the round
// cap, exactly like the reference's lax.while_loop condition.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e18f;
constexpr float kEpsCap = 1e-6f;
constexpr float kEpsImprove = 1e-9f;

constexpr int kWTile = 32;   // w per block (threadIdx.x)
constexpr int kVTile = 32;   // v per shared-memory stage
constexpr int kRows = 8;     // threadIdx.y
constexpr int kPerThread = 8;
constexpr int kPairTile = kRows * kPerThread;  // (b, k) pairs per block

__global__ void place_kernel(const float* __restrict__ C,
                             const float* __restrict__ cap,
                             const float* __restrict__ prefix,
                             float* __restrict__ P, int* __restrict__ Pj,
                             const int* __restrict__ flags, int B, int n,
                             int K) {
  if (flags != nullptr && flags[1] == 0) return;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)B * K * n;
  if (idx >= total) return;
  int v = (int)(idx % n);
  int q = (int)(idx / n);  // pair index b*K + k
  int b = q / K;
  int k = q - b * K;
  const float capv = cap[v] + kEpsCap;
  const float* pre = prefix + (long long)b * K;
  const float* crow = C + ((long long)b * n + v) * K;
  const float pk = pre[k];
  float best = kBig;
  int bj = 0;
  for (int j = k; j >= 0; --j) {  // descending j: strict < keeps the largest j
    float block = pk - pre[j];
    float c = (block <= capv) ? crow[j] : kBig;
    if (c < best) {
      best = c;
      bj = j;
    }
  }
  P[idx] = best;
  Pj[idx] = bj;
}

__global__ void __launch_bounds__(kWTile * kRows)
move_update_kernel(const float* __restrict__ C, const int* __restrict__ par_v,
                   const int* __restrict__ par_j, const float* __restrict__ lat,
                   const float* __restrict__ bw,
                   const float* __restrict__ breq_k,
                   const float* __restrict__ P, const int* __restrict__ Pj,
                   float* __restrict__ Cn, int* __restrict__ pvn,
                   int* __restrict__ pjn, int* flags, int B, int n, int K) {
  __shared__ float lat_s[kVTile][kWTile + 1];
  __shared__ float bw_s[kVTile][kWTile + 1];
  __shared__ float p_s[kPairTile][kVTile + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kWTile + tx;
  const int w0 = blockIdx.x * kWTile;
  const int q0 = blockIdx.y * kPairTile;
  const int w = w0 + tx;
  const int pairs = B * K;
  const bool active = (flags == nullptr) || (flags[1] != 0);

  if (!active) {  // past the fixpoint: the superstep is a copy
    if (w < n) {
      for (int r = 0; r < kPerThread; ++r) {
        int q = q0 + r * kRows + ty;
        if (q >= pairs) break;
        int b = q / K;
        int k = q - b * K;
        long long o = ((long long)b * n + w) * K + k;
        Cn[o] = C[o];
        pvn[o] = par_v[o];
        pjn[o] = par_j[o];
      }
    }
    return;
  }

  float breq[kPerThread];
  float best[kPerThread];
  int bv[kPerThread];
  for (int r = 0; r < kPerThread; ++r) {
    int q = q0 + r * kRows + ty;
    breq[r] = (q < pairs) ? breq_k[q] : kBig;
    best[r] = kBig;
    bv[r] = 0;
  }

  for (int v0 = 0; v0 < n; v0 += kVTile) {
    // stage lat/bw (v, w) tiles: masked entries can never win
    for (int e = tid; e < kVTile * kWTile; e += kWTile * kRows) {
      int vv = e / kWTile;
      int ww = e - vv * kWTile;
      int v = v0 + vv;
      int wg = w0 + ww;
      bool ok = (v < n) && (wg < n);
      lat_s[vv][ww] = ok ? lat[(long long)v * n + wg] : kBig;
      bw_s[vv][ww] = ok ? bw[(long long)v * n + wg] : -1.0f;
    }
    // stage the P tile: (pair, v), v contiguous in the scratch
    for (int e = tid; e < kPairTile * kVTile; e += kWTile * kRows) {
      int qq = e / kVTile;
      int vv = e - qq * kVTile;
      int q = q0 + qq;
      int v = v0 + vv;
      p_s[qq][vv] = (q < pairs && v < n) ? P[(long long)q * n + v] : kBig;
    }
    __syncthreads();
    const int vcount = min(kVTile, n - v0);
    for (int vv = 0; vv < vcount; ++vv) {
      const float l = lat_s[vv][tx];
      const float bwv = bw_s[vv][tx];
      const int v = v0 + vv;
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        float c = kBig;
        if (bwv >= breq[r]) c = fminf(p_s[r * kRows + ty][vv] + l, kBig);
        if (c < best[r]) {  // ascending v + strict <: first v wins ties
          best[r] = c;
          bv[r] = v;
        }
      }
    }
    __syncthreads();
  }

  if (w >= n) return;
  bool any = false;
  for (int r = 0; r < kPerThread; ++r) {
    int q = q0 + r * kRows + ty;
    if (q >= pairs) break;
    int b = q / K;
    int k = q - b * K;
    long long o = ((long long)b * n + w) * K + k;
    float c = C[o];
    if (best[r] < c - kEpsImprove) {
      Cn[o] = best[r];
      pvn[o] = bv[r];
      pjn[o] = Pj[(long long)q * n + bv[r]];
      any = true;
    } else {
      Cn[o] = c;
      pvn[o] = par_v[o];
      pjn[o] = par_j[o];
    }
  }
  if (any && flags != nullptr) flags[2] = 1;
}

__global__ void finish_kernel(int* flags) {
  if (flags[1] != 0) {
    int t = flags[0] + 1;
    flags[0] = t;
    flags[1] = (flags[2] != 0 && t < flags[3]) ? 1 : 0;
  }
  flags[2] = 0;
}

}  // namespace

extern "C" int batched_superstep_launch(
    const float* C, const int* par_v, const int* par_j, const float* lat,
    const float* bw, const float* cap, const float* prefix,
    const float* breq_k, float* Cn, int* pvn, int* pjn, float* P, int* Pj,
    int* flags, int B, int n, int K, cudaStream_t stream) {
  long long total = (long long)B * K * n;
  int threads = 256;
  unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  place_kernel<<<blocks, threads, 0, stream>>>(C, cap, prefix, P, Pj, flags,
                                               B, n, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 mblock(kWTile, kRows);
  dim3 mgrid((n + kWTile - 1) / kWTile,
             (B * K + kPairTile - 1) / kPairTile);
  move_update_kernel<<<mgrid, mblock, 0, stream>>>(
      C, par_v, par_j, lat, bw, breq_k, P, Pj, Cn, pvn, pjn, flags, B, n, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (flags != nullptr) {
    finish_kernel<<<1, 1, 0, stream>>>(flags);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" const char* batched_superstep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
