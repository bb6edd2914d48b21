// The frontier family alone: per (job, step, stage) of a stacked window
// tensor d[J, N, R, S],
//
//   frontier  max over ranks of the stage prefix P;
//   leader    the lowest rank that holds the max;
//   second    the top-2 second (tied duplicates kept: two ranks at the max
//             give second == frontier; -inf when R == 1);
//   clipped   max over ranks of (P_final - max(0, d - bd)), the Eq. 4
//             recompute by the final-prefix shift identity.
//
// Replaces the Pallas TPU kernel `_frontier_kernel` with its helpers
// `_tile_reduce` and `_merge_second` (src/repro/kernels/frontier/
// frontier.py, reached through `frontier_window_kernel` from
// `fleet_frontier_window`).  One of the three separate launches of the
// four-dispatch reference route, which exists to check the fused tick:
// this source shares no kernel code with `fused_tick.cu`, only the prefix
// order and the top-2 merge of `frontier_common.cuh`.
//
// Bound.  About S operations per float loaded: bound by device-memory
// bytes.  It reads d once (J*N*R*S*4 bytes) and writes four [J, N, S]
// rows.  The baseline arrives as a strided view ([J, S] medians broadcast
// with zero strides), never materialized at window size.
//
// Design.  The TPU folds rank tiles in grid order and keeps the earlier
// leader on ties.  On this card blocks run in no order, so each block
// covers every rank of its (job, step) and nothing is merged across
// blocks.  The top-2 merge (`merge_top2`, an explicit index tie-break:
// equal values keep the lower rank) and max are exact in any order; no
// float atomics.  Two kernels:
//
//   warp fold (S <= 32)  grid J*N; 2 warps a block when J*N >= 1,024,
//     else 4 (a few blocks spread their ranks wider).  A warp holds whole
//     ranks, lane = (rank, two consecutive stages): ceil(S / 2) lanes a
//     rank, floor(32 / ceil(S / 2)) ranks a warp, so its load of a rank
//     group is one contiguous run of d.  The stage prefix is a shuffle
//     chain in `StagePrefix`'s order (`warp_stage_prefix`): a lane adds its
//     two stages in order, so the chain takes ceil(S / 2) - 1 rounds, not
//     S - 1.  kBatch rank groups go side by side, their loads issued
//     together (a rank-broadcast baseline is one load a stage); P_final
//     comes by one shuffle from the rank's last-stage lane, so each row is
//     read once.  Each lane folds its stages' (max, leader, second,
//     clipped) over the ranks it visits in registers, with no shuffle per
//     rank; the rank groups of a warp then merge by shuffles from computed
//     lanes, and the warps through shared memory.  One launch at any R.
//   rank tiles (S > 32)  grid (J*N, ceil(R / 128)), one thread per rank
//     of a tile walking its stages with `StagePrefix`; every 32 stages
//     the block reduces the summaries over its ranks with warp shuffles
//     and a merge across its 4 warps and writes a per-tile partial; a
//     second kernel merges the partials in tile order when R > 128.
//
// Subnormals: built with -ftz=true, as the reference flushes.
#include <cuda_runtime.h>
#include <math.h>

#include "frontier_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kFoldStages = 32;  // the largest S of the warp fold
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // stages per reduction round of the rank tiles
constexpr int kBatch = 4;   // rank groups a warp-fold lane loads at once
constexpr int kLaneStages = 2;  // consecutive stages a warp-fold lane holds
constexpr long long kManyBlocks = 1024;  // J*N from which the fold takes 2 warps
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* d;   // [J, N, R, S] contiguous
  const float* bd;  // clip baseline, strided view of [J, N, R, S]
  // per-tile partials [J*N, T, S] (the outputs themselves when T == 1)
  float* pf;
  int* pl;
  float* ps;
  float* pc;
  // outputs [J*N, S] (written by the fold when T > 1)
  float* f;
  int* fl;
  float* fs;
  float* fc;
  long long bd_st[4];
  int N, R, S, T;
  long long JN;  // J * N
};

template <int E, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    frontier_fold_kernel(const Params p) {
  const long long jn = blockIdx.x;  // job * N + step
  const long long j = jn / p.N;
  const long long n = jn - j * p.N;
  const int S = p.S;
  const int R = p.R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int L = (S + E - 1) / E;    // lanes of a rank
  const int rpw = 32 / L;           // whole ranks per warp
  const int lr = lane / L;          // this lane's rank group in the warp
  const int lp = lane - lr * L;     // its place in the rank
  const int lane0 = lr * L;         // the lane of its rank's stage 0
  const bool group = lr < rpw;
  const int stride = WARPS * rpw;   // ranks of one pass of the block
  const int last = (S - 1) / E;     // the lane of the last stage ...
  const int last_e = (S - 1) % E;   // ... and its place in the lane
  const float NEG_INF = -INFINITY;

  // this lane's stages (an in-bounds stage where lp * E + e >= S)
  int st[E];
  bool live[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    live[e] = lp * E + e < S;
    st[e] = min(lp * E + e, S - 1);
  }
  const float* dstep = p.d + jn * R * S;
  const float* bstep = p.bd + j * p.bd_st[0] + n * p.bd_st[1];
  // the baseline of a rank-broadcast view (the prolog's [J, S] medians)
  // is one value a stage
  const bool bd_ranks = p.bd_st[2] != 0;
  float bd0[E];
#pragma unroll
  for (int e = 0; e < E; ++e) bd0[e] = __ldg(bstep + st[e] * p.bd_st[3]);

  float m[E], sc[E], cl[E];
  int ix[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    m[e] = sc[e] = cl[e] = NEG_INF;
    ix[e] = kBig;
  }
  // warp-uniform walk: the warp's rank groups of kBatch passes at a time
  for (int r0 = warp * rpw; r0 < R; r0 += kBatch * stride) {
    float v[kBatch][E], b[kBatch][E], pw[kBatch][E];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {  // every load up front, in bounds
      const int r = min(r0 + t * stride + lr, R - 1);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[t][e] = __ldg(dstep + (long long)r * S + st[e]);
        b[t][e] = bd_ranks
                      ? __ldg(bstep + r * p.bd_st[2] + st[e] * p.bd_st[3])
                      : bd0[e];
      }
    }
    warp_stage_prefix(v, pw, lp, lane0, S);
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      float fin = pw[t][0];
#pragma unroll
      for (int e = 1; e < E; ++e) fin = last_e == e ? pw[t][e] : fin;
      const float pfin = __shfl_sync(kFull, fin, lane0 + last);
      const int r = r0 + t * stride + lr;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (group && r < R && live[e]) {
          merge_top2(m[e], ix[e], sc[e], pw[t][e], r, NEG_INF);
          cl[e] = fmaxf(cl[e], pfin - fmaxf(0.f, v[t][e] - b[t][e]));
        }
      }
    }
  }
  // the warp's rank groups: group lr takes group lr + off's summaries
  for (int off = 1; off < rpw; off <<= 1) {
    const int src = min(lane + off * L, 31);
    const bool take = group && lr + off < rpw && (lr & (2 * off - 1)) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float m2 = __shfl_sync(kFull, m[e], src);
      const int i2 = __shfl_sync(kFull, ix[e], src);
      const float s2 = __shfl_sync(kFull, sc[e], src);
      const float c2 = __shfl_sync(kFull, cl[e], src);
      if (take) {
        merge_top2(m[e], ix[e], sc[e], m2, i2, s2);
        cl[e] = fmaxf(cl[e], c2);
      }
    }
  }
  __shared__ float sm_m[WARPS][32 * E], sm_s[WARPS][32 * E], sm_c[WARPS][32 * E];
  __shared__ int sm_i[WARPS][32 * E];
  if (lane < L) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = lane * E + e;  // this stage, of rank group 0
      sm_m[warp][k] = m[e];
      sm_i[warp][k] = ix[e];
      sm_s[warp][k] = sc[e];
      sm_c[warp][k] = cl[e];
    }
  }
  __syncthreads();
  if (threadIdx.x < S) {
    const int k = threadIdx.x;
    float bm = sm_m[0][k], bs = sm_s[0][k], bc = sm_c[0][k];
    int bi = sm_i[0][k];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      merge_top2(bm, bi, bs, sm_m[w][k], sm_i[w][k], sm_s[w][k]);
      bc = fmaxf(bc, sm_c[w][k]);
    }
    const long long o = jn * S + k;
    p.f[o] = bm;
    p.fl[o] = bi;
    p.fs[o] = bs;
    p.fc[o] = bc;
  }
}

__global__ void __launch_bounds__(kThreads)
    rank_tiles_kernel(const Params p) {
  const long long jn = blockIdx.x;  // job * N + step
  const int tile = blockIdx.y;
  const int r = tile * kThreads + threadIdx.x;
  const bool valid = r < p.R;
  const int S = p.S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long j = jn / p.N;
  const long long n = jn - j * p.N;
  const float NEG_INF = -INFINITY;

  // double-buffered warp partials of one round of kChunk stages
  __shared__ float sm_m[2][kWarps][kChunk];
  __shared__ float sm_s[2][kWarps][kChunk];
  __shared__ float sm_c[2][kWarps][kChunk];
  __shared__ int sm_i[2][kWarps][kChunk];

  const long long rr = valid ? r : 0;  // in-bounds address for idle lanes
  const float* drow = p.d + (jn * p.R + rr) * S;
  const float* bdp =
      p.bd + j * p.bd_st[0] + n * p.bd_st[1] + rr * p.bd_st[2];

  // the last stage prefix first: every stage's clip needs it
  float pd_final = 0.f;
  {
    StagePrefix pfx;
    for (int s = 0; s < S; ++s) pd_final = pfx.next(drow[s]);
  }

  StagePrefix pfx;
  int round = 0;
  for (int c0 = 0; c0 < S; c0 += kChunk, ++round) {
    const int cn = min(kChunk, S - c0);
    const int buf = round & 1;
    for (int k = 0; k < cn; ++k) {
      const int s = c0 + k;
      const float dv = drow[s];
      const float pd = pfx.next(dv);
      float m = NEG_INF, sc = NEG_INF, cl = NEG_INF;
      int ix = kBig;
      if (valid) {
        m = pd;
        ix = r;
        cl = pd_final - fmaxf(0.f, dv - bdp[s * p.bd_st[3]]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, ix, off);
        const float s2 = __shfl_xor_sync(0xffffffffu, sc, off);
        const float c2 = __shfl_xor_sync(0xffffffffu, cl, off);
        merge_top2(m, ix, sc, m2, i2, s2);
        cl = fmaxf(cl, c2);
      }
      if (lane == 0) {
        sm_m[buf][warp][k] = m;
        sm_i[buf][warp][k] = ix;
        sm_s[buf][warp][k] = sc;
        sm_c[buf][warp][k] = cl;
      }
    }
    // one barrier per round: a buffer is rewritten two rounds later,
    // after every reader of this round has passed the next barrier
    __syncthreads();
    if (threadIdx.x < cn) {
      const int k = threadIdx.x;
      float bm = sm_m[buf][0][k], bs = sm_s[buf][0][k], bc = sm_c[buf][0][k];
      int bi = sm_i[buf][0][k];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        merge_top2(bm, bi, bs, sm_m[buf][w][k], sm_i[buf][w][k],
                   sm_s[buf][w][k]);
        bc = fmaxf(bc, sm_c[buf][w][k]);
      }
      const long long o = (jn * p.T + tile) * S + c0 + k;
      p.pf[o] = bm;
      p.pl[o] = bi;
      p.ps[o] = bs;
      p.pc[o] = bc;
    }
  }
}

// Merge the per-tile partials in tile order: one thread per (job, step,
// stage); ties keep the lower tile, whose ranks are the lower ones.
__global__ void fold_tiles_kernel(const Params p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.JN * p.S) return;
  const long long jn = idx / p.S;
  const long long s = idx - jn * p.S;
  long long o = jn * p.T * p.S + s;
  float m = p.pf[o], sc = p.ps[o], c = p.pc[o];
  int i = p.pl[o];
  for (int t = 1; t < p.T; ++t) {
    o += p.S;
    merge_top2(m, i, sc, p.pf[o], p.pl[o], p.ps[o]);
    c = fmaxf(c, p.pc[o]);
  }
  p.f[idx] = m;
  p.fl[idx] = i;
  p.fs[idx] = sc;
  p.fc[idx] = c;
}

}  // namespace

extern "C" {

// The partial tiles T a call of frontier_window_launch takes: 1 for the
// warp fold (the partials unused) and for one rank tile, else ceil(R /
// 128), one rank tile each.
int frontier_window_tiles(int R, int S) {
  return S <= kFoldStages ? 1 : (R + kThreads - 1) / kThreads;
}

// Launches on `stream` the warp fold (S <= 32: one launch, the partials
// unused), else the rank tiles (and their fold when T > 1): partials
// pf..pc ([J*N, T, S]; the outputs when T == 1), outputs f..fc ([J*N, S]),
// the baseline's four element strides in `bd_st`.  Returns
// cudaErrorInvalidValue when T is not frontier_window_tiles(R, S), else
// cudaGetLastError() after the launches: 0 when they were accepted.
int frontier_window_launch(const void* d, const void* bd, void* pf, void* pl,
                           void* ps, void* pc, void* f, void* fl, void* fs,
                           void* fc, const long long* bd_st, int J, int N,
                           int R, int S, int T, void* stream) {
  Params p;
  p.d = static_cast<const float*>(d);
  p.bd = static_cast<const float*>(bd);
  p.pf = static_cast<float*>(pf);
  p.pl = static_cast<int*>(pl);
  p.ps = static_cast<float*>(ps);
  p.pc = static_cast<float*>(pc);
  p.f = static_cast<float*>(f);
  p.fl = static_cast<int*>(fl);
  p.fs = static_cast<float*>(fs);
  p.fc = static_cast<float*>(fc);
  for (int k = 0; k < 4; ++k) p.bd_st[k] = bd_st[k];
  p.N = N;
  p.R = R;
  p.S = S;
  p.T = T;
  p.JN = (long long)J * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (T != frontier_window_tiles(R, S))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error from earlier work
  if (S <= kFoldStages) {
    // 2 warps a block where the (job, step) blocks fill the card several
    // times over, else 4, so that the ranks of a few blocks spread wider
    const unsigned blocks = static_cast<unsigned>(p.JN);
    if (p.JN >= kManyBlocks)
      frontier_fold_kernel<kLaneStages, 2><<<blocks, 64, 0, st>>>(p);
    else
      frontier_fold_kernel<kLaneStages, kWarps><<<blocks, kThreads, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(p.JN), static_cast<unsigned>(T));
  rank_tiles_kernel<<<grid, kThreads, 0, st>>>(p);
  if (T > 1) {
    const long long total = p.JN * S;
    const int threads = 256;
    fold_tiles_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                        threads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* frontier_window_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
