// One fused DP superstep of the batched (min,+) LeastCostMap relaxation,
// for B requests against one shared resource network, as ONE launch.
//
// Replaces src/repro/kernels/minplus/batched.py:85 (_superstep_kernel, the
// Pallas TPU kernel launched by batched_superstep_pallas).  It computes
//
//   place:  P[b,v,k]  = min over j <= k with prefix[b,k]-prefix[b,j] <= cap[v]+1e-6
//                       of C[b,v,j]                     ties -> LARGEST j (pj)
//   move:   C'[b,w,k] = min over v with bw[v,w] >= breq_k[b,k]
//                       of P[b,v,k] + lat[v,w]           ties -> FIRST v
//   update: where C' < C - 1e-9: C = C', par_v = winning v, par_j = pj[b,v,k]
//
// Every step is a float32 compare/select or a single float32 add, in the
// same order as the plain PyTorch version, so the two agree bit for bit.
// Constants are float literals and the file must be built without fast-math
// and with -fmad=false.
//
// The move needs no clamp of P + lat to BIG.  The running minimum starts at
// BIG and only takes a candidate that is strictly smaller, so a candidate
// above BIG can never be taken, clamped or not; and P <= BIG and lat <= BIG
// (every state the DP holds is BIG or a finite path cost, and the caller
// passes a finite lat), so P + lat is finite, never inf or NaN.
//
// What bounds it on an H100, in the two regimes the main path launches:
//
// - B = 1 (each one-by-one re-solve of an optimistic conflict: 94 % of the
//   main path's supersteps): 9.4e6 candidates against 8.4 MB of lat/bw at
//   n = 1024, so it is bound by bytes, 2.6 us at 3.35 TB/s.  There are only
//   16 column tiles of 64 w, so the v range is split across the blocks of
//   a thread block cluster (11 at n = 1024: 176 blocks on 132 SMs).  Every
//   lat/bw element is read once; each block leaves its partial (value, v)
//   minima in shared memory, and after a cluster barrier every block of
//   the cluster merges a share of the tile's outputs from its peers'
//   shared memory (in split order) and applies the update.  No partials
//   go through device memory.
// - B = 64 (micro-batches): 6.0e8 candidates against the same 8.4 MB, so
//   it is bound by operations on the FP32 and ALU pipes (min-plus has no
//   tensor-core form).  A candidate costs five instructions: an add, two
//   compares (bandwidth mask, then the running minimum, into one
//   predicate) and two predicated copies of value and argmin, which go to
//   the FMA pipes (see relax) rather than the half-rate ALU pipe a select
//   would use.  Each thread keeps a register tile of KT pairs x 4 w (36
//   running minima at K = 9), so one 16-byte shared load of P serves 4 w
//   and one of lat (and of bw) serves KT pairs.  The block tile is 64 w x
//   tb requests x the K pairs of each, with 16/tb v lanes that are merged
//   in shared memory at the end.
//
// Both regimes: one launch per superstep.  Place is fused: each block
// computes P for its own requests and v tile in shared memory from C rows
// staged coalesced along (v, j), with cap and prefix, and stores beside
// each value its argmin packed with v, (v << jbits) | pj, which the move
// carries as its argmin; so the update needs no Pj scratch and no second
// pass, and packed values order like v.  Every w-tile block places its
// requests' v rows again: K(K+1)/2 compare steps per (b, v) against
// 64 K candidates, about 8 % of the move's work at K = 9.  The v tiles of
// lat/bw/C/cap stream through a ring of 3 or 4 cp.async stages and P is
// placed one tile ahead of the move, so later tiles load and place while
// this one is reduced, with one barrier per tile.  The last block to
// retire (an atomic ticket after __threadfence) advances the control word
// and resets the ticket for the next launch.
//
// The tile shape, the v splits and the stages are chosen by the caller
// (plan_superstep in kernels/minplus/batched.py) and checked here.  Ties:
// place scans j descending with a strict <; each v lane scans its v's
// ascending with a strict <, and lanes and splits merge on (value, then
// smaller v), which is the first v.  An untouched lane holds (BIG, 0).
//
// Optional device control word `flags` = [t, active, changed, max_rounds]:
// a superstep with active == 0 copies its input state unchanged; the last
// block advances t and clears active at the fixpoint or the round cap,
// exactly like the reference's lax.while_loop condition.  The outputs are
// written out of place.  Ragged n, B and K are masked, never padded.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e18f;
constexpr float kEpsCap = 1e-6f;
constexpr float kEpsImprove = 1e-9f;

constexpr int kTX = 16;                // threads along w
constexpr int kRW = 4;                 // w per thread (one 16-byte load)
constexpr int kWT = kTX * kRW;         // w per block
constexpr int kTY = 16;                // thread rows: tb requests x tv v lanes
constexpr int kThreads = kTX * kTY;
constexpr int kVT = 32;                // v per pipeline stage
constexpr int kMaxSmem = 232448;       // per block on sm_90

struct Args {
  const float* C;
  const int* par_v;
  const int* par_j;
  const float* lat;
  const float* bw;
  const float* cap;
  const float* prefix;
  const float* breq_k;
  float* Cn;
  int* pvn;
  int* pjn;
  int* flags;
  int* ticket;    // retire ticket, zero between launches
  int B, n, K;
  int kchunk, kchunks, tb, tv, splits, v_chunk, w_tiles, b_tiles;
  int stages;     // v tiles of lat/bw, cap and C rows in flight
  int jbits;      // a move's argmin is packed as (v << jbits) | pj
  float one;      // 1.0f and 0, opaque to the compiler (see relax)
  int zero;
  bool vec;       // lat/bw rows 16-byte aligned: 16-byte copies
};

__host__ __device__ constexpr int padded(int kt) { return (kt + 3) & ~3; }

// Shared memory, in floats: lat and bw, cap and C rows (a ring of
// `stages` v tiles each); P records of two tiles (per (v, request row)
// padded(KT) values, then padded(KT) packed argmins); prefix.  The lane
// merge at the end reuses it from the start: one record of kRW*KT minima
// (+1 against bank conflicts) per thread.
struct Layout {
  int rec;       // floats per (v, request row) record
  int p_stride;  // floats per v row of P records (+4 against bank conflicts)
  int lat, bw, p, cap, pre, c, stage_floats, merge_floats;
  __host__ __device__ Layout(int KT, int tb, int K, int stages) {
    rec = 2 * padded(KT);
    p_stride = tb * rec + 4;
    lat = 0;
    bw = lat + stages * kVT * kWT;
    p = bw + stages * kVT * kWT;
    cap = p + 2 * kVT * p_stride;
    pre = cap + stages * kVT;
    c = pre + tb * K;
    stage_floats = c + stages * tb * kVT * K;
    merge_floats = 2 * kThreads * (kRW * KT + 1);
  }
  __host__ __device__ int bytes() const {
    return 4 * (stage_floats > merge_floats ? stage_floats : merge_floats);
  }
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

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One move candidate: take it when bw >= breq and it is strictly below the
// running minimum.  The two compares are the only ALU-pipe instructions:
// the taken value and argmin are copied by a predicated FFMA (cand * 1 - 0,
// exact for every float) and IMAD (arg * 0 + packed), which issue on the
// FMA pipes, where a select would take the ALU pipe again (it issues at
// half the FP32 rate).  `one` and `zero` come from the launch so that ptxas
// cannot fold them into moves, and the IMAD reads arg so that it cannot be
// hoisted out of the four w of one pair and turned back into a select.
__device__ __forceinline__ void relax(float cand, float bwv, float breq,
                                      int packed, float one, int zero,
                                      float& best, int& arg) {
  asm("{\n\t"
      ".reg .pred m, t;\n\t"
      "setp.ge.f32 m, %2, %3;\n\t"
      "setp.lt.and.f32 t, %4, %0, m;\n\t"
      "@t fma.rn.f32 %0, %4, %5, 0f80000000;\n\t"
      "@t mad.lo.s32 %1, %1, %7, %6;\n\t"
      "}"
      : "+f"(best), "+r"(arg)
      : "f"(bwv), "f"(breq), "f"(cand), "f"(one), "r"(packed), "r"(zero));
}

// The place rule for one (b, v, k): descending j with a strict <, so ties
// keep the largest j.  An infeasible j would offer BIG, which never beats
// a running minimum that starts at BIG, so feasibility only gates the
// compare.  crow = C[b, v, :], pre = prefix[b, :].
__device__ __forceinline__ float place_min(const float* crow, const float* pre,
                                          float capv, int k, int* bj) {
  const float pk = pre[k];
  float best = kBig;
  int j_best = 0;
  for (int j = k; j >= 0; --j) {
    const float c = crow[j];
    const bool take = (pk - pre[j] <= capv) & (c < best);
    best = take ? c : best;
    j_best = take ? j : j_best;
  }
  *bj = j_best;
  return best;
}

// P and packed argmins of one (request row, v) for the block's k chunk.
template <int KT>
__device__ __forceinline__ void place_row(const float* crow, const float* pre,
                                          float capv, int v, int k0,
                                          int kcount, int K, int jbits,
                                          float* P, int* pack) {
  if (K == KT && k0 == 0) {  // the whole row in registers, fully unrolled
    float pk[KT], c[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      pk[j] = pre[j];
      c[j] = crow[j];
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      float best = kBig;
      int bj = 0;
#pragma unroll
      for (int j = k; j >= 0; --j) {
        const bool take = (pk[k] - pk[j] <= capv) & (c[j] < best);
        best = take ? c[j] : best;
        bj = take ? j : bj;
      }
      P[k] = best;
      pack[k] = (v << jbits) | bj;
    }
  } else {
    for (int kk = 0; kk < kcount; ++kk) {
      int bj;
      P[kk] = place_min(crow, pre, capv, k0 + kk, &bj);
      pack[kk] = (v << jbits) | bj;
    }
  }
}

__device__ __forceinline__ bool before(float c, int v, float bc, int bv) {
  return c < bc || (c == bc && v < bv);
}

// Issue the cp.async copies of one v tile's lat/bw (kVT x kWT).
__device__ __forceinline__ void stage_links(const Args& a, float* lat_s,
                                           float* bw_s, int v0, int vcount,
                                           int w0) {
  const int n = a.n;
  constexpr int kChunks = kWT / 4;
  for (int e = threadIdx.x; e < kVT * kChunks; e += kThreads) {
    const int vv = e / kChunks;
    if (vv >= vcount) break;
    const int wl = (e - vv * kChunks) * 4;
    const int w = w0 + wl;
    const long long g = (long long)(v0 + vv) * n + w;
    float* ls = lat_s + vv * kWT + wl;
    float* bs = bw_s + vv * kWT + wl;
    if (a.vec && w + 4 <= n) {
      cp_async16(ls, a.lat + g);
      cp_async16(bs, a.bw + g);
    } else {
      for (int i = 0; i < 4; ++i) {
        if (w + i < n) {
          cp_async4(ls + i, a.lat + g + i);
          cp_async4(bs + i, a.bw + g + i);
        } else {  // columns past n: never feasible, never written out
          ls[i] = kBig;
          bs[i] = -1.0f;
        }
      }
    }
  }
}

// Issue the cp.async copies of one v tile's cap and the tb requests' C
// rows (kVT x K each, contiguous in C).
__device__ __forceinline__ void stage_rows(const Args& a, float* cap_s,
                                          float* c_s, int v0, int vcount,
                                          int b0) {
  const int tid = threadIdx.x;
  for (int e = tid; e < vcount; e += kThreads) cp_async4(cap_s + e, a.cap + v0 + e);
  const int row = vcount * a.K;
  for (int r = 0; r < a.tb && b0 + r < a.B; ++r) {
    const float* src = a.C + ((long long)(b0 + r) * a.n + v0) * a.K;
    float* dst = c_s + r * kVT * a.K;
    for (int e = tid; e < row; e += kThreads) cp_async4(dst + e, src + e);
  }
}

// One state entry's input, loaded ahead of its update so that the loads
// of several entries are in flight together.
struct Entry {
  long long o;
  float c;
  int pv, pj;
};

__device__ __forceinline__ Entry load_entry(const Args& a, long long o) {
  return Entry{o, a.C[o], a.par_v[o], a.par_j[o]};
}

// Monotone update of one state entry from its move minimum; returns
// whether it improved.
__device__ __forceinline__ bool update(const Args& a, const Entry& x,
                                       float bc, int packed) {
  const bool better = bc < x.c - kEpsImprove;
  a.Cn[x.o] = better ? bc : x.c;
  a.pvn[x.o] = better ? packed >> a.jbits : x.pv;
  a.pjn[x.o] = better ? packed & ((1 << a.jbits) - 1) : x.pj;
  return better;
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
superstep_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KTP = padded(KT);

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int tb = a.tb, tv = a.tv;
  const int bl = ty / tv;  // request row of this thread
  const int vl = ty - bl * tv;  // v lane of this thread
  const int n = a.n, K = a.K, B = a.B;

  // block -> v split fastest (the splits of one output tile form one
  // thread block cluster), then (request tile, k chunk), then w tile:
  // clusters that share a lat/bw column tile run side by side
  const int rtiles = a.b_tiles * a.kchunks;
  int bid = blockIdx.x;
  const int split = bid % a.splits;
  bid /= a.splits;
  const int rt = bid % rtiles;
  const int wt = bid / rtiles;
  const int bt = rt / a.kchunks;
  const int kc = rt - bt * a.kchunks;
  const int b0 = bt * tb;
  const int k0 = kc * a.kchunk;
  const int kcount = min(a.kchunk, K - k0);
  const int w0 = wt * kWT;
  const bool active = a.flags == nullptr || a.flags[1] != 0;

  // the tile's outputs: e -> (request row r, column wl, pair kk), kk fastest
  constexpr int kOut = kWT * KT;
  const int outputs = tb * kOut;

  bool any = false;  // did this thread improve a state entry
  if (!active) {  // past the fixpoint: the superstep is a copy
    for (int e = split * kThreads + tid; e < outputs; e += a.splits * kThreads) {
      const int kk = e % KT;
      const int wl = (e / KT) % kWT;
      const int r = e / kOut;
      const int b = b0 + r, w = w0 + wl;
      if (kk >= kcount || b >= B || w >= n) continue;
      const long long o = ((long long)b * n + w) * K + k0 + kk;
      a.Cn[o] = a.C[o];
      a.pvn[o] = a.par_v[o];
      a.pjn[o] = a.par_j[o];
    }
  } else {
    const Layout L(KT, tb, K, a.stages);
    float* lat_s = smem + L.lat;
    float* bw_s = smem + L.bw;
    float* p_s = smem + L.p;
    float* cap_s = smem + L.cap;
    float* pre_s = smem + L.pre;
    float* c_s = smem + L.c;
    const int b = b0 + bl;
    const bool row_live = b < B;

    float breq[KT];
    float best[KT][kRW];
    int arg[KT][kRW];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      breq[kk] = (row_live && kk < kcount) ? a.breq_k[(long long)b * K + k0 + kk]
                                           : kBig;
#pragma unroll
      for (int c = 0; c < kRW; ++c) {
        best[kk][c] = kBig;
        arg[kk][c] = 0;
      }
    }

    const int v_beg = split * a.v_chunk;
    const int v_end = min(n, v_beg + a.v_chunk);
    const int tiles = (v_end - v_beg + kVT - 1) / kVT;
    auto vcount_of = [&](int t) { return min(kVT, v_end - v_beg - t * kVT); };
    const int ns = a.stages;

    // copy v tile t (if it exists) into ring slot t % ns, as one group
    auto issue = [&](int t) {
      if (t < tiles) {
        const int ring = t % ns;
        const int v0 = v_beg + t * kVT;
        stage_links(a, lat_s + ring * kVT * kWT, bw_s + ring * kVT * kWT, v0,
                    vcount_of(t), w0);
        stage_rows(a, cap_s + ring * kVT, c_s + ring * tb * kVT * K, v0,
                   vcount_of(t), b0);
      }
      cp_async_commit();
    };

    // place of tile t: its C rows -> P records; rows are (request r, v),
    // v fastest across threads
    auto place = [&](int t) {
      const int vc = vcount_of(t);
      const int ring = t % ns;
      const float* c_b = c_s + ring * tb * kVT * K;
      const float* cap_b = cap_s + ring * kVT;
      float* p_b = p_s + (t & 1) * kVT * L.p_stride;
      for (int e = tid; e < tb * kVT; e += kThreads) {
        const int r = e / kVT;
        const int vv = e - r * kVT;
        float* P = p_b + vv * L.p_stride + r * L.rec;
        int* pack = reinterpret_cast<int*>(P + KTP);
        if (vv < vc && b0 + r < B) {
          place_row<KT>(c_b + (r * kVT + vv) * K, pre_s + r * K,
                        cap_b[vv] + kEpsCap, v_beg + t * kVT + vv, k0, kcount,
                        K, a.jbits, P, pack);
        } else {
          for (int kk = 0; kk < KTP; ++kk) {
            P[kk] = kBig;
            pack[kk] = 0;
          }
        }
      }
    };

    // Pipeline: a ring of `ns` (3 or 4) tiles of copies in flight, and P
    // one tile ahead of the move.  Iteration t issues tile t + ns - 1 into
    // the ring slot tile t - 1 freed, places tile t + 1 and moves tile t
    // while the copies land; at its end tile t + 2 is complete (ns - 3
    // groups may stay in flight), so one barrier per tile suffices.
    for (int e = tid; e < tb * K; e += kThreads) {
      const int r = e / K;
      pre_s[e] = (b0 + r < B) ? a.prefix[(long long)(b0 + r) * K + e - r * K] : 0.0f;
    }
    for (int t = 0; t < ns - 1; ++t) issue(t);
    cp_async_wait(ns - 3);
    __syncthreads();
    place(0);
    __syncthreads();

    for (int t = 0; t < tiles; ++t) {
      const int ring = t % ns;
      const int vc = vcount_of(t);
      issue(t + ns - 1);
      if (t + 1 < tiles) place(t + 1);
      // move: each thread's KT x kRW register tile over its v lane
      const float* lat_b = lat_s + ring * kVT * kWT;
      const float* bw_b = bw_s + ring * kVT * kWT;
      const float* p_b = p_s + (t & 1) * kVT * L.p_stride;
      for (int vv = vl; vv < vc; vv += tv) {
        const float* rec = p_b + vv * L.p_stride + bl * L.rec;
        float p[KTP];
        int pk[KTP];
#pragma unroll
        for (int q = 0; q < KTP / 4; ++q) {
          const float4 x = reinterpret_cast<const float4*>(rec)[q];
          const int4 y = reinterpret_cast<const int4*>(rec + KTP)[q];
          p[4 * q] = x.x;
          p[4 * q + 1] = x.y;
          p[4 * q + 2] = x.z;
          p[4 * q + 3] = x.w;
          pk[4 * q] = y.x;
          pk[4 * q + 1] = y.y;
          pk[4 * q + 2] = y.z;
          pk[4 * q + 3] = y.w;
        }
        const float4 l4 = *reinterpret_cast<const float4*>(lat_b + vv * kWT + tx * kRW);
        const float4 b4 = *reinterpret_cast<const float4*>(bw_b + vv * kWT + tx * kRW);
        const float l[kRW] = {l4.x, l4.y, l4.z, l4.w};
        const float bwv[kRW] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
          for (int c = 0; c < kRW; ++c) {
            // ascending v + strict <: the first v wins ties in a lane
            relax(p[kk] + l[c], bwv[c], breq[kk], pk[kk], a.one, a.zero,
                  best[kk][c], arg[kk][c]);
          }
        }
      }
      cp_async_wait(ns - 3);
      __syncthreads();
    }

    // merge the v lanes in shared memory on (value, then smaller v), in
    // place into lane 0's slots
    constexpr int kRec = kRW * KT + 1;  // per thread, odd: no bank conflicts
    float* red_c = smem;
    int* red_v = reinterpret_cast<int*>(smem + kThreads * kRec);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int c = 0; c < kRW; ++c) {
        const int i = tid * kRec + c * KT + kk;
        red_c[i] = best[kk][c];
        red_v[i] = arg[kk][c];
      }
    }
    __syncthreads();
    // the slot of output e = (request row r, column wl, pair kk) in the
    // record of lane 0's thread; lane y's is y * kTX records further
    auto slot = [&](int e) {
      const int kk = e % KT;
      const int wl = (e / KT) % kWT;
      const int r = e / kOut;
      return (r * tv * kTX + wl / kRW) * kRec + (wl % kRW) * KT + kk;
    };
    auto live = [&](int e, long long* o) {
      const int kk = e % KT;
      const int w = w0 + (e / KT) % kWT;
      const int bo = b0 + e / kOut;
      *o = ((long long)bo * n + w) * K + k0 + kk;
      return kk < kcount && bo < B && w < n;
    };
    constexpr int kBatch = 4;  // outputs per thread whose loads overlap
    for (int e0 = tid; e0 < outputs; e0 += kBatch * kThreads) {
      Entry x[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = e0 + q * kThreads;
        long long o = 0;
        ok[q] = e < outputs && live(e, &o);
        if (ok[q] && a.splits == 1) x[q] = load_entry(a, o);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (!ok[q]) continue;
        const int i0 = slot(e0 + q * kThreads);
        float bc = kBig;
        int bv = 0;
        for (int y0 = 0; y0 < tv; y0 += 4) {  // tv is 1, 2 or a multiple of 4
          const int m = min(4, tv - y0);
          float lc[4];
          int lv[4];
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const int i = i0 + (y0 + min(y, m - 1)) * kTX * kRec;
            lc[y] = red_c[i];
            lv[y] = red_v[i];
          }
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            if (before(lc[y], lv[y], bc, bv)) {
              bc = lc[y];
              bv = lv[y];
            }
          }
        }
        if (a.splits == 1) {
          any |= update(a, x[q], bc, bv);
        } else {
          red_c[i0] = bc;
          red_v[i0] = bv;
        }
      }
    }

    if (a.splits > 1) {
      // merge the splits of this tile through distributed shared memory:
      // each block of the cluster takes every splits-th run of 256 outputs
      // and reads the split minima in split order (ascending v)
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      for (int e = split * kThreads + tid; e < outputs; e += a.splits * kThreads) {
        long long o;
        if (!live(e, &o)) continue;
        const int i0 = slot(e);
        const Entry x = load_entry(a, o);
        float bc = kBig;
        int bv = 0;
        for (int s0 = 0; s0 < a.splits; s0 += 8) {  // 8 remote loads in flight
          float pc[8];
          int pv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool ok = s0 + i < a.splits;
            pc[i] = ok ? cluster.map_shared_rank(red_c, s0 + i)[i0] : kBig;
            pv[i] = ok ? cluster.map_shared_rank(red_v, s0 + i)[i0] : 0;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (before(pc[i], pv[i], bc, bv)) {
              bc = pc[i];
              bv = pv[i];
            }
          }
        }
        any |= update(a, x, bc, bv);
      }
    }
  }

  // Retire.  Only flags[2] has to reach the last block, and it is written
  // before a ticket.  With clusters, a cluster barrier (which also keeps
  // every block until its peers have read its shared memory) gathers the
  // cluster's writes and flag reads, and only its first block takes a
  // ticket, so one atomic per cluster, not per block, meets the last one.
  const int block_any = __syncthreads_or(any);
  if (a.flags != nullptr && tid == 0 && block_any) a.flags[2] = 1;
  if (a.splits > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
  if (a.flags != nullptr && split == 0 && tid == 0) {
    __threadfence();
    const unsigned int ticket = atomicAdd(a.ticket, 1);
    if (ticket == gridDim.x / a.splits - 1) {  // the last to retire
      __threadfence();
      volatile int* f = a.flags;
      if (f[1] != 0) {
        const int t = f[0] + 1;
        f[0] = t;
        f[1] = (f[2] != 0 && t < f[3]) ? 1 : 0;
      }
      f[2] = 0;
      *a.ticket = 0;  // ready for the next launch
    }
  }
}

template <int KT>
cudaError_t launch(const Args& a, unsigned int blocks, cudaStream_t stream) {
  const int smem = Layout(KT, a.tb, a.K, a.stages).bytes();
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the default 48 KB limit covers dynamic and static shared memory
  cudaError_t err = cudaFuncSetAttribute(
      superstep_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && a.splits > 8)  // clusters above 8 blocks
    err = cudaFuncSetAttribute(superstep_kernel<KT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, superstep_kernel<KT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KT>
int max_clusters(int tb, int K, int stages, int splits) {
  const int smem = Layout(KT, tb, K, stages).bytes();
  if (smem > kMaxSmem) return 0;
  if (cudaFuncSetAttribute(superstep_kernel<KT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      (splits > 8 &&
       cudaFuncSetAttribute(superstep_kernel<KT>,
                            cudaFuncAttributeNonPortableClusterSizeAllowed,
                            1) != cudaSuccess))
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, superstep_kernel<KT>, &cfg) !=
      cudaSuccess)
    return -1;
  return count;
}

}  // namespace

// How many clusters of `splits` blocks of this shape the current device
// runs at once (0 if none fits; -1 on a CUDA error).
extern "C" int batched_superstep_max_clusters(int kt, int tb, int K,
                                              int stages, int splits) {
  switch (kt) {
    case 2: return max_clusters<2>(tb, K, stages, splits);
    case 3: return max_clusters<3>(tb, K, stages, splits);
    case 4: return max_clusters<4>(tb, K, stages, splits);
    case 6: return max_clusters<6>(tb, K, stages, splits);
    case 9: return max_clusters<9>(tb, K, stages, splits);
    default: return -1;
  }
}

// kt: k per thread (2, 3, 4, 6 or 9); kchunk <= kt: k per block; tb:
// requests per block (1, 2, 4, 8 or 16); splits (1 to 16): blocks along v,
// one thread block cluster, each over v_chunk (a multiple of 32) rows;
// stages (3 or 4): v tiles of copies in flight.
// ticket points to one int32 zero, which the kernel leaves zeroed.
extern "C" int batched_superstep_launch(
    const float* C, const int* par_v, const int* par_j, const float* lat,
    const float* bw, const float* cap, const float* prefix,
    const float* breq_k, float* Cn, int* pvn, int* pjn, int* flags,
    int* ticket, int B, int n, int K, int kt, int kchunk, int tb, int splits,
    int v_chunk, int stages, cudaStream_t stream) {
  if ((long long)B * n * K == 0) return 0;
  Args a;
  a.C = C; a.par_v = par_v; a.par_j = par_j; a.lat = lat; a.bw = bw;
  a.cap = cap; a.prefix = prefix; a.breq_k = breq_k;
  a.Cn = Cn; a.pvn = pvn; a.pjn = pjn; a.flags = flags; a.ticket = ticket;
  a.B = B; a.n = n; a.K = K;
  a.kchunk = kchunk; a.tb = tb; a.splits = splits; a.v_chunk = v_chunk;
  a.stages = stages;
  a.one = 1.0f;
  a.zero = 0;
  a.jbits = 0;
  while ((1 << a.jbits) < K) ++a.jbits;
  const bool tb_ok = tb == 1 || tb == 2 || tb == 4 || tb == 8 || tb == 16;
  if (!tb_ok || kchunk < 1 || kchunk > kt || v_chunk < 1 ||
      v_chunk % kVT != 0 || splits < 1 || splits > 16 || stages < 3 ||
      stages > 4 ||
      splits != (n + v_chunk - 1) / v_chunk || ticket == nullptr ||
      ((long long)n << a.jbits) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  a.tv = kTY / tb;
  a.kchunks = (K + kchunk - 1) / kchunk;
  a.w_tiles = (n + kWT - 1) / kWT;
  a.b_tiles = (B + tb - 1) / tb;
  a.vec = n % 4 == 0 && ((unsigned long long)lat % 16) == 0 &&
          ((unsigned long long)bw % 16) == 0;
  const long long blocks = (long long)a.w_tiles * a.b_tiles * a.kchunks * splits;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (kt) {
    case 2: err = launch<2>(a, (unsigned int)blocks, stream); break;
    case 3: err = launch<3>(a, (unsigned int)blocks, stream); break;
    case 4: err = launch<4>(a, (unsigned int)blocks, stream); break;
    case 6: err = launch<6>(a, (unsigned int)blocks, stream); break;
    case 9: err = launch<9>(a, (unsigned int)blocks, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// Dynamic shared memory one launch of this plan uses, in bytes.
extern "C" int batched_superstep_smem(int kt, int tb, int K, int stages) {
  return Layout(kt, tb, K, stages).bytes();
}

extern "C" const char* batched_superstep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
