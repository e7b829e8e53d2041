// Bandwidth-masked (min,+) move step for one request, with first-v argmin.
//
// Replaces repro/kernels/minplus/minplus.py::_kernel (the Pallas TPU kernel
// launched by masked_minplus_pallas).  For a rectangular link block,
// P (n_v, K), lat and bw (n_v, n_w) row-major, breq_k (K,), all float32:
//
//   C[w,k]  = min over v with bw[v,w] >= breq_k[k] of min(P[v,k] + lat[v,w], BIG)
//             (BIG when no v is feasible)
//   pv[w,k] = the FIRST (smallest) v that attains the minimum (0 if none)
//
// The op repro_torch.kernels.minplus.masked_minplus is the square case; the
// decentralized engine (core/distributed.py) calls it with the lat/bw
// columns its rank owns.  Every candidate is one float32 add, one clamp and
// compares, so the result equals the plain PyTorch version bit for bit (no
// fast-math, -fmad=false).
//
// What bounds it on an H100: for one request K is small (9 at p = 8), so
// the block reads 8*n_v*n_w bytes of lat/bw (8.4 MB at n = 1024) for only
// about 4*n_v*n_w*K compare/select/add operations: it is bound by device
// memory, 2.5 us at 3.35 TB/s, against 1.1 us of FP32-lane work.  What the
// design does about it: every lat/bw element is read from device memory
// exactly once, and each thread keeps all KT (<= 32) running minima of its
// output column in registers, so the link block is never re-streamed per k.
// Warps read 32 consecutive w of one v row (128-byte coalesced loads); the
// P rows of a v tile sit in shared memory and are read as warp broadcasts.
// To fill 132 SMs at n_w = 1024 (only 32 column tiles), the v range is cut
// into splits, one block each: a block reduces its v lanes in shared memory
// and, with more than one split, writes a partial (value, v) pair that a
// second small kernel merges.  Lanes and splits merge on (value, then
// smaller v), which is the first-v rule; an untouched lane holds (BIG, 0),
// which is also what the reference gives a column with no feasible v.
// Min-plus has no tensor-core (wgmma) form.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e18f;
constexpr int kW = 32;      // output columns w per block (threadIdx.x)
constexpr int kVL = 8;      // v lanes per block (threadIdx.y)
constexpr int kVTile = 64;  // v rows of P per shared-memory stage
constexpr int kBlocksPerSm = 2;

struct Plan {
  int kt;       // k values per block (a template instance)
  int splits;   // blocks along v
  int v_chunk;  // v rows per split, a multiple of kVTile
};

Plan make_plan(int n_v, int n_w, int K, int sms) {
  Plan p;
  p.kt = K <= 4 ? 4 : K <= 8 ? 8 : K <= 12 ? 12 : K <= 16 ? 16
         : K <= 24 ? 24 : 32;
  long long tiles = (long long)((n_w + kW - 1) / kW) * ((K + p.kt - 1) / p.kt);
  long long want = ((long long)sms * kBlocksPerSm + tiles - 1) / tiles;
  long long most = (n_v + kVTile - 1) / kVTile;
  long long s = want < most ? want : most;
  if (s < 1) s = 1;
  long long chunk = (n_v + s - 1) / s;
  chunk = (chunk + kVTile - 1) / kVTile * kVTile;
  if (chunk < kVTile) chunk = kVTile;
  p.v_chunk = (int)chunk;
  p.splits = n_v > 0 ? (int)((n_v + chunk - 1) / chunk) : 1;
  return p;
}

__device__ __forceinline__ bool before(float c, int v, float bc, int bv) {
  return c < bc || (c == bc && v < bv);
}

template <int KT>
__global__ void __launch_bounds__(kW * kVL)
move_kernel(const float* __restrict__ P, const float* __restrict__ lat,
            const float* __restrict__ bw, const float* __restrict__ breq_k,
            float* __restrict__ out_c, int* __restrict__ out_v, int n_v,
            int n_w, int K, int v_chunk) {
  __shared__ float p_s[kVTile][KT];
  __shared__ float red_c[kVL][kW];
  __shared__ int red_v[kVL][kW];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kW + tx;
  const int w = blockIdx.x * kW + tx;
  const int k0 = blockIdx.y * KT;
  const int split = blockIdx.z;
  const int v_beg = split * v_chunk;
  const int v_end = min(n_v, v_beg + v_chunk);
  const bool live = w < n_w;

  float bq[KT];
  float best[KT];
  int arg[KT];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    bq[kk] = (k0 + kk < K) ? breq_k[k0 + kk] : kBig;
    best[kk] = kBig;
    arg[kk] = 0;
  }

  for (int v0 = v_beg; v0 < v_end; v0 += kVTile) {
    const int vcount = min(kVTile, v_end - v0);
    for (int e = tid; e < kVTile * KT; e += kW * kVL) {
      const int vv = e / KT;
      const int kk = e - vv * KT;
      p_s[vv][kk] = (vv < vcount && k0 + kk < K)
                        ? P[(long long)(v0 + vv) * K + k0 + kk]
                        : kBig;
    }
    __syncthreads();
    if (live) {
#pragma unroll 2
      for (int vv = ty; vv < vcount; vv += kVL) {
        const int v = v0 + vv;
        const long long o = (long long)v * n_w + w;
        const float l = lat[o];
        const float b = bw[o];
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          const float c = (b >= bq[kk]) ? fminf(p_s[vv][kk] + l, kBig) : kBig;
          if (c < best[kk]) {  // ascending v + strict <: first v per lane
            best[kk] = c;
            arg[kk] = v;
          }
        }
      }
    }
    __syncthreads();
  }

  // merge the kVL lanes of each column: smallest value, then smallest v
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (k0 + kk >= K) break;  // uniform across the block
    red_c[ty][tx] = best[kk];
    red_v[ty][tx] = arg[kk];
    __syncthreads();
    if (ty == 0 && live) {
      float bc = red_c[0][tx];
      int bv = red_v[0][tx];
      for (int y = 1; y < kVL; ++y) {
        if (before(red_c[y][tx], red_v[y][tx], bc, bv)) {
          bc = red_c[y][tx];
          bv = red_v[y][tx];
        }
      }
      const long long o = ((long long)split * n_w + w) * K + k0 + kk;
      out_c[o] = bc;
      out_v[o] = bv;
    }
    __syncthreads();
  }
}

__global__ void merge_kernel(const float* __restrict__ part_c,
                             const int* __restrict__ part_v,
                             float* __restrict__ C, int* __restrict__ pv,
                             int n_w, int K, int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long m = (long long)n_w * K;
  if (idx >= m) return;
  float bc = part_c[idx];
  int bv = part_v[idx];
  for (int s = 1; s < splits; ++s) {
    const float c = part_c[s * m + idx];
    const int v = part_v[s * m + idx];
    if (before(c, v, bc, bv)) {
      bc = c;
      bv = v;
    }
  }
  C[idx] = bc;
  pv[idx] = bv;
}

template <int KT>
void launch_move(dim3 grid, cudaStream_t stream, const float* P,
                 const float* lat, const float* bw, const float* breq_k,
                 float* out_c, int* out_v, int n_v, int n_w, int K,
                 int v_chunk) {
  move_kernel<KT><<<grid, dim3(kW, kVL), 0, stream>>>(
      P, lat, bw, breq_k, out_c, out_v, n_v, n_w, K, v_chunk);
}

}  // namespace

// Number of v splits the launch uses (the size of the partial buffers).
extern "C" int masked_minplus_splits(int n_v, int n_w, int K, int sms) {
  return make_plan(n_v, n_w, K, sms).splits;
}

// part_c / part_v hold splits * n_w * K entries; unused when splits == 1.
extern "C" int masked_minplus_launch(const float* P, const float* lat,
                                     const float* bw, const float* breq_k,
                                     float* C, int* pv, float* part_c,
                                     int* part_v, int n_v, int n_w, int K,
                                     int sms, cudaStream_t stream) {
  if ((long long)n_w * K == 0) return 0;
  const Plan plan = make_plan(n_v, n_w, K, sms);
  float* out_c = plan.splits > 1 ? part_c : C;
  int* out_v = plan.splits > 1 ? part_v : pv;
  dim3 grid((n_w + kW - 1) / kW, (K + plan.kt - 1) / plan.kt, plan.splits);
  switch (plan.kt) {
    case 4: launch_move<4>(grid, stream, P, lat, bw, breq_k, out_c, out_v, n_v, n_w, K, plan.v_chunk); break;
    case 8: launch_move<8>(grid, stream, P, lat, bw, breq_k, out_c, out_v, n_v, n_w, K, plan.v_chunk); break;
    case 12: launch_move<12>(grid, stream, P, lat, bw, breq_k, out_c, out_v, n_v, n_w, K, plan.v_chunk); break;
    case 16: launch_move<16>(grid, stream, P, lat, bw, breq_k, out_c, out_v, n_v, n_w, K, plan.v_chunk); break;
    case 24: launch_move<24>(grid, stream, P, lat, bw, breq_k, out_c, out_v, n_v, n_w, K, plan.v_chunk); break;
    default: launch_move<32>(grid, stream, P, lat, bw, breq_k, out_c, out_v, n_v, n_w, K, plan.v_chunk); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return (int)err;
  const long long m = (long long)n_w * K;
  const int threads = 256;
  merge_kernel<<<(unsigned int)((m + threads - 1) / threads), threads, 0,
                 stream>>>(part_c, part_v, C, pv, n_w, K, plan.splits);
  return (int)cudaGetLastError();
}

extern "C" const char* masked_minplus_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
