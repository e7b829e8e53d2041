// Bandwidth-masked (min,+) move step for one request, with first-v argmin,
// as ONE launch.
//
// Replaces src/repro/kernels/minplus/minplus.py:45 (_kernel, the Pallas TPU
// kernel launched by masked_minplus_pallas).  For a rectangular link block,
// P (n_v, K), lat and bw (n_v, n_w) row-major, breq_k (K,), all float32:
//
//   C[w,k]  = min over v with bw[v,w] >= breq_k[k] of min(P[v,k] + lat[v,w], BIG)
//             (BIG when no v is feasible)
//   pv[w,k] = the FIRST (smallest) v that attains the minimum (0 if none)
//
// The op repro_torch.kernels.minplus.masked_minplus is the square case; the
// decentralized engine (core/distributed.py) calls it with the lat/bw
// columns its rank owns.  The result equals the plain PyTorch version bit
// for bit: every candidate is one float32 add and compares, and the file is
// built without fast-math and with -fmad=false.
//
// No clamp to BIG.  Each running minimum starts at (BIG, 0) and takes a
// candidate only when it is strictly smaller, so a candidate >= BIG is never
// taken, clamped or not.  A column whose candidates are all >= BIG (or that
// has no feasible v) therefore keeps (BIG, 0), which is the reference's
// min/argmin of an all-BIG column (the first v, 0).  A column with a
// candidate below BIG gets the same first minimum with or without the clamp.
//
// What bounds it on an H100: for one request K is small (9 at p = 8), so the
// call reads 8*n_v*n_w bytes of lat/bw (8.4 MB at n = 1024, 134 MB at 4096)
// for n_v*n_w*K candidates: it is bound by device memory (2.5 us and 40 us
// at 3.35 TB/s).  What the design does about it:
//
// - Bytes in flight.  lat/bw tiles (2048 elements each, R = 2048 / W rows of
//   the block's W columns) and the matching P rows stream through a ring of
//   3 or 4 shared-memory stages filled by cp.async: 16-byte copies when the
//   rows are 16-byte aligned (n_w % 4 == 0), 4-byte copies otherwise.  Two
//   to three stages (32-48 KB) per block are in flight while one is reduced.
// - Instructions.  A thread keeps KT x 4 running minima (KT = the block's k
//   count: K itself up to 9, so no dead k at K = 9) for 4 adjacent w; one
//   16-byte shared load of lat (and of bw) serves KT candidates, and the P
//   row of a v is read as float4 broadcasts.  A candidate costs five
//   instructions: FADD, two FSETP, and the two predicated copies of value and
//   argmin as FFMA / IMAD on the FMA pipes (see relax).
// - One launch.  To fill 132 SMs when there are few column tiles, the v
//   range is split over the blocks of a thread block cluster.  Each block
//   merges its v lanes in shared memory and stores each (value, v) pair
//   into the shared memory of the cluster block that owns that output;
//   after one cluster barrier each block reduces its outputs over the
//   splits in split order.  Nothing goes through device memory but the
//   inputs and the outputs.
//
// The launch shape (column tile W, k chunk, v splits, stages) is chosen by
// plan_move in kernels/minplus/minplus.py and checked here.  Ties: each lane
// scans its v ascending with a strict <, and lanes, warps and splits merge on
// (value, then smaller v), which is the first v.  Min-plus has no
// tensor-core (wgmma) form.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e18f;
constexpr int kThreads = 256;
constexpr int kStage = 2048;       // lat (and bw) elements per ring stage
constexpr int kMaxKT = 9;
constexpr int kMaxSplits = 16;
constexpr int kMaxSmem = 232448;   // per block on sm_90

struct Args {
  const float* P;
  const float* lat;
  const float* bw;
  const float* breq_k;
  float* C;
  int* pv;
  int n_v, n_w, K;
  int kchunk, kchunks, w_shift, splits, v_chunk, stages;
  float one;  // 1.0f and 0, opaque to the compiler (see relax)
  int zero;
  bool vec;   // lat/bw rows 16-byte aligned: 16-byte copies
};

__host__ __device__ constexpr int padded(int kt) { return (kt + 3) & ~3; }

// Shared memory, in floats: the split minima this block receives from its
// cluster (splits x ceil(W*KT / splits) values, then as many argmins; at
// most W*KT + 15 each), then a ring of `stages` stages, each lat (kStage), bw
// (kStage) and R rows of P (padded(KT) each).  The lane merge reuses the
// ring: every thread's 4*KT minima (TY lanes x W*KT), then their argmins.
struct Layout {
  int ring, stage, merge;
  __host__ __device__ Layout(int KT, int W, int stages) {
    ring = padded(2 * (W * KT + kMaxSplits - 1));
    stage = 2 * kStage + (kStage / W) * padded(KT);
    merge = 2 * kThreads * 4 * KT;
    const int ring_floats = stages * stage;
    merge = ring_floats > merge ? ring_floats : merge;
  }
  __host__ __device__ int bytes() const { return 4 * (ring + merge); }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0, 1 or 2) of this thread's copy groups
// are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One candidate: take it when bw >= breq and it is strictly below the
// running minimum.  The two compares are the only ALU-pipe instructions:
// the taken value and argmin are copied by a predicated FFMA (cand * 1 - 0,
// exact for every float) and IMAD (arg * 0 + v), which issue on the FMA
// pipes, where a select would take the half-rate ALU pipe again.  `one` and
// `zero` come from the launch so that ptxas cannot fold them into moves.
__device__ __forceinline__ void relax(float cand, float bwv, float breq,
                                      int v, float one, int zero,
                                      float& best, int& arg) {
  asm("{\n\t"
      ".reg .pred m, t;\n\t"
      "setp.ge.f32 m, %2, %3;\n\t"
      "setp.lt.and.f32 t, %4, %0, m;\n\t"
      "@t fma.rn.f32 %0, %4, %5, 0f80000000;\n\t"
      "@t mad.lo.s32 %1, %1, %7, %6;\n\t"
      "}"
      : "+f"(best), "+r"(arg)
      : "f"(bwv), "f"(breq), "f"(cand), "f"(one), "r"(v), "r"(zero));
}

__device__ __forceinline__ bool before(float c, int v, float bc, int bv) {
  return c < bc || (c == bc && v < bv);
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
move_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KTP = padded(KT);

  const int W = 1 << a.w_shift;        // columns per block: 16, 32 or 64
  const int tx_shift = a.w_shift - 2;  // W / 4 threads along w
  const int TX = 1 << tx_shift;
  const int TY = kThreads >> tx_shift;  // v lanes; a stage has 2 * TY rows
  const int R = kStage >> a.w_shift;
  const int tid = threadIdx.x;
  const int tx = tid & (TX - 1);
  const int ty = tid >> tx_shift;
  const int n_v = a.n_v, n_w = a.n_w, K = a.K;

  // block -> v split fastest (the splits of one output tile form one
  // cluster), then k chunk, then column tile
  int bid = blockIdx.x;
  const int split = bid % a.splits;
  bid /= a.splits;
  const int kc = bid % a.kchunks;
  const int wt = bid / a.kchunks;
  const int k0 = kc * a.kchunk;
  const int kcount = min(a.kchunk, K - k0);
  const int w0 = wt * W;
  const int v_beg = split * a.v_chunk;
  const int v_end = min(n_v, v_beg + a.v_chunk);
  const int tiles = (v_end - v_beg + R - 1) / R;
  const int ns = a.stages;

  const Layout L(KT, W, ns);
  const bool clustered = a.splits > 1;
  const int per = (W * KT + a.splits - 1) / a.splits;  // outputs per owner
  float* recv_c = smem;  // [split of the sender][output e / splits]
  int* recv_v = reinterpret_cast<int*>(smem + a.splits * per);
  float* ring = smem + L.ring;
  // peers store into this block's shared memory only after every block of
  // the cluster has started: arrive now, wait before the first store
  if (clustered)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float breq[KT];
  float best[KT][4];
  int arg[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    // k past the chunk (only in the last chunk of a K cut into chunks)
    // is computed and never written out
    breq[kk] = kk < kcount ? a.breq_k[k0 + kk] : kBig;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      best[kk][c] = kBig;
      arg[kk][c] = 0;
    }
  }

  // copy v tile t (if it exists) into ring slot t % ns, as one group
  auto issue = [&](int t) {
    if (t < tiles) {
      float* lat_s = ring + (t % ns) * L.stage;
      float* bw_s = lat_s + kStage;
      float* p_s = bw_s + kStage;
      const int v0 = v_beg + t * R;
      const int vc = min(R, v_end - v0);
      if (a.vec) {  // n_w % 4 == 0: a 4-column chunk is all in or all out
        const int per_row = tx_shift;  // log2 of the float4 chunks of a row
        for (int e = tid; e < (vc << per_row); e += kThreads) {
          const int vv = e >> per_row;
          const int wl = (e - (vv << per_row)) * 4;
          if (w0 + wl < n_w) {
            const long long g = (long long)(v0 + vv) * n_w + w0 + wl;
            cp_async16(lat_s + vv * W + wl, a.lat + g);
            cp_async16(bw_s + vv * W + wl, a.bw + g);
          }
        }
      } else {  // columns past n_w are never written out
        for (int e = tid; e < (vc << a.w_shift); e += kThreads) {
          const int vv = e >> a.w_shift;
          const int wl = e - (vv << a.w_shift);
          if (w0 + wl < n_w) {
            const long long g = (long long)(v0 + vv) * n_w + w0 + wl;
            cp_async4(lat_s + vv * W + wl, a.lat + g);
            cp_async4(bw_s + vv * W + wl, a.bw + g);
          }
        }
      }
      const int kk = tid & 15;  // P rows: 16 rows of 16 k per pass
      if (kk < kcount) {
        for (int vv = tid >> 4; vv < vc; vv += kThreads / 16)
          cp_async4(p_s + vv * KTP + kk, a.P + (long long)(v0 + vv) * K + k0 + kk);
      }
    }
    cp_async_commit();
  };

  // Pipeline: before tile t is reduced, tiles up to t + ns - 2 have been
  // issued; waiting until ns - 2 groups remain lands tile t, and the
  // barrier both publishes it and frees the slot of tile t - 1, into which
  // tile t + ns - 1 is issued.  One barrier per tile.
  for (int t = 0; t < ns - 1; ++t) issue(t);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait(ns - 2);
    __syncthreads();
    issue(t + ns - 1);
    const float* lat_s = ring + (t % ns) * L.stage;
    const float* bw_s = lat_s + kStage;
    const float* p_s = bw_s + kStage;
    const int v0 = v_beg + t * R;
    const int vc = min(R, v_end - v0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // R == 2 * TY: two v rows per lane
      const int vv = ty + i * TY;
      if (vv < vc) {
        float p[KTP];
#pragma unroll
        for (int q = 0; q < KTP / 4; ++q) {
          const float4 x = reinterpret_cast<const float4*>(p_s + vv * KTP)[q];
          p[4 * q] = x.x;
          p[4 * q + 1] = x.y;
          p[4 * q + 2] = x.z;
          p[4 * q + 3] = x.w;
        }
        const float4 l4 = *reinterpret_cast<const float4*>(lat_s + vv * W + tx * 4);
        const float4 b4 = *reinterpret_cast<const float4*>(bw_s + vv * W + tx * 4);
        const float l[4] = {l4.x, l4.y, l4.z, l4.w};
        const float bwv[4] = {b4.x, b4.y, b4.z, b4.w};
        const int v = v0 + vv;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // ascending v + strict <: the first v wins ties in a lane
            relax(p[kk] + l[c], bwv[c], breq[kk], v, a.one, a.zero,
                  best[kk][c], arg[kk][c]);
          }
        }
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();  // the ring is free for the merge

  // merge the v lanes in shared memory on (value, then smaller v): each
  // thread stores its 4*KT minima as float4s (c-major, as outputs are
  // laid out), then each output's TY lanes are reduced in four
  // interleaved chains
  const int outputs = W * KT;  // e -> (column wl, k kk), kk fastest
  float* red_c = ring;
  int* red_v = reinterpret_cast<int*>(ring + TY * outputs);
  {
    float4* mc = reinterpret_cast<float4*>(red_c + ty * outputs + tx * 4 * KT);
    int4* mv = reinterpret_cast<int4*>(red_v + ty * outputs + tx * 4 * KT);
#pragma unroll
    for (int q = 0; q < KT; ++q) {  // flat f = c * KT + kk, 4 per store
      mc[q] = make_float4(best[(4 * q) % KT][(4 * q) / KT],
                          best[(4 * q + 1) % KT][(4 * q + 1) / KT],
                          best[(4 * q + 2) % KT][(4 * q + 2) / KT],
                          best[(4 * q + 3) % KT][(4 * q + 3) / KT]);
      mv[q] = make_int4(arg[(4 * q) % KT][(4 * q) / KT],
                        arg[(4 * q + 1) % KT][(4 * q + 1) / KT],
                        arg[(4 * q + 2) % KT][(4 * q + 2) / KT],
                        arg[(4 * q + 3) % KT][(4 * q + 3) / KT]);
    }
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  if (clustered) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = tid; e < outputs; e += kThreads) {
    const int wl = e / KT;
    const int kk = e - wl * KT;
    if (kk >= kcount || w0 + wl >= n_w) continue;
    float cc[4];
    int cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cc[i] = red_c[i * outputs + e];
      cv[i] = red_v[i * outputs + e];
    }
    for (int y = 4; y < TY; y += 4) {  // TY is 16, 32 or 64
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float c = red_c[(y + i) * outputs + e];
        const int v = red_v[(y + i) * outputs + e];
        if (before(c, v, cc[i], cv[i])) {
          cc[i] = c;
          cv[i] = v;
        }
      }
    }
    float bc = cc[0];
    int bv = cv[0];
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      if (before(cc[i], cv[i], bc, bv)) {
        bc = cc[i];
        bv = cv[i];
      }
    }
    if (a.splits == 1) {
      const long long o = (long long)(w0 + wl) * K + k0 + kk;
      a.C[o] = bc;
      a.pv[o] = bv;
    } else {  // to the block of the cluster that owns output e
      const int owner = e % a.splits;
      const int i = split * per + e / a.splits;
      cluster.map_shared_rank(recv_c, owner)[i] = bc;
      cluster.map_shared_rank(recv_v, owner)[i] = bv;
    }
  }
  if (!clustered) return;

  // merge the splits through distributed shared memory: after a cluster
  // barrier that publishes the stores above, each block reduces the
  // outputs it owns (e = i * splits + split) over the senders in split
  // order (ascending v), from its own shared memory
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  for (int i = tid; i < per; i += kThreads) {
    const int e = i * a.splits + split;
    const int wl = e / KT;
    const int kk = e - wl * KT;
    if (e >= outputs || kk >= kcount || w0 + wl >= n_w) continue;
    float bc = recv_c[i];
    int bv = recv_v[i];
    for (int s = 1; s < a.splits; ++s) {
      const float c = recv_c[s * per + i];
      const int v = recv_v[s * per + i];
      if (before(c, v, bc, bv)) {
        bc = c;
        bv = v;
      }
    }
    const long long o = (long long)(w0 + wl) * K + k0 + kk;
    a.C[o] = bc;
    a.pv[o] = bv;
  }
}

// Once per device, before any plan or launch: every shape's shared memory
// (the default 48 KB limit covers dynamic and static shared memory) and
// clusters above 8 blocks.  The launch itself sets nothing.
template <int KT>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      move_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(move_kernel<KT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t config(unsigned int blocks, int smem, int splits,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int KT>
cudaError_t launch(const Args& a, unsigned int blocks, cudaStream_t stream) {
  const int smem = Layout(KT, 1 << a.w_shift, a.stages).bytes();
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(blocks, smem, a.splits, stream, attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, move_kernel<KT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KT>
int max_clusters(int w_tile, int stages, int splits) {
  const int smem = Layout(KT, w_tile, stages).bytes();
  if (smem > kMaxSmem) return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(splits, smem, splits, 0, attr);
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, move_kernel<KT>, &cfg) !=
      cudaSuccess)
    return -1;
  return count;
}

int log2_tile(int w_tile) {
  return w_tile == 16 ? 4 : w_tile == 32 ? 5 : w_tile == 64 ? 6 : -1;
}

}  // namespace

#define MOVE_KT_CASES(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9)

// Sets every instance's attributes on the current device (see prepare);
// returns a CUDA error code, 0 on success.
extern "C" int masked_minplus_prepare() {
  cudaError_t err = cudaSuccess;
#define F(X) if (err == cudaSuccess) err = prepare<X>();
  MOVE_KT_CASES(F)
#undef F
  return (int)err;
}

// How many clusters of `splits` blocks of this shape the current device
// runs at once, after masked_minplus_prepare (0 if none fits; -1 on a CUDA
// error or a bad shape).
extern "C" int masked_minplus_max_clusters(int kt, int w_tile, int stages,
                                           int splits) {
  if (log2_tile(w_tile) < 0 || splits < 1 || splits > kMaxSplits) return -1;
  switch (kt) {
#define F(X) case X: return max_clusters<X>(w_tile, stages, splits);
    MOVE_KT_CASES(F)
#undef F
    default: return -1;
  }
}

// Dynamic shared memory one launch of this shape uses, in bytes.
extern "C" int masked_minplus_smem(int kt, int w_tile, int stages) {
  return Layout(kt, w_tile, stages).bytes();
}

// kt (1 to 9): k per block, a template instance (K is cut into chunks of
// kt, the last one ragged); w_tile (16, 32 or 64): columns per block; splits
// (1 to 16): blocks along v, one thread block cluster, each over v_chunk (a
// multiple of 32) rows; stages (3 or 4): ring stages.
extern "C" int masked_minplus_launch(const float* P, const float* lat,
                                     const float* bw, const float* breq_k,
                                     float* C, int* pv, int n_v, int n_w,
                                     int K, int kt, int w_tile,
                                     int splits, int v_chunk, int stages,
                                     cudaStream_t stream) {
  if ((long long)n_w * K == 0) return 0;
  Args a;
  a.P = P; a.lat = lat; a.bw = bw; a.breq_k = breq_k; a.C = C; a.pv = pv;
  a.n_v = n_v; a.n_w = n_w; a.K = K;
  a.kchunk = kt; a.splits = splits; a.v_chunk = v_chunk;
  a.stages = stages;
  a.w_shift = log2_tile(w_tile);
  a.one = 1.0f;
  a.zero = 0;
  if (n_v < 1 || a.w_shift < 0 || kt < 1 || kt > kMaxKT || v_chunk < 1 ||
      v_chunk % 32 != 0 || splits < 1 ||
      splits > kMaxSplits || splits != (n_v + v_chunk - 1) / v_chunk ||
      stages < 3 || stages > 4)
    return (int)cudaErrorInvalidValue;
  a.kchunks = (K + kt - 1) / kt;
  a.vec = n_w % 4 == 0 && ((unsigned long long)lat % 16) == 0 &&
          ((unsigned long long)bw % 16) == 0;
  const long long blocks =
      (long long)((n_w + w_tile - 1) / w_tile) * a.kchunks * splits;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (kt) {
#define F(X) case X: err = launch<X>(a, (unsigned int)blocks, stream); break;
    MOVE_KT_CASES(F)
#undef F
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* masked_minplus_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
