// The cell walk: the families of the fleet tick that carry state across
// steps, one thread per (job, rank, stage) cell of a stacked window tensor
// d[J, N, R, S].  Shared by `fused_tick.cu` (what-if, regimes, hosts),
// `whatif_matrix.cu` (what-if alone) and `regime_stats.cu` (regimes
// alone), so the routes run the same adds in the same order and agree bit
// for bit.
//
//   what-if  W = sum over steps, in step order, of
//            max(0, amax - max(other, arr - excess_w)), arr = relprev +
//            P[end] - P[start - 1] (P the stage prefix of the imputed work
//            w through the cell's governing segment), other = second on the
//            boundary leader's lane and amax elsewhere;
//   regimes  count, onset (BIG = never), last, runs, streak, sum_e, sum_pfx
//            of the activity excess_w > thr, adds only, in step order;
//   hosts    active-rank counts per (job, step, stage, host): integer
//            atomics, exact in any order.
//
// Design.  Given the prolog's [J, N, S] rows (amax, second, leader,
// relprev and the sync stages' cross-rank minimum wmin), a cell needs
// nothing from other ranks but its own rank's stage prefix, so the cells
// are independent and the step walk is the only serial chain.  Each
// thread walks the N steps in order with its what-if sum, its seven
// regime statistics and its host in registers (`CellState`, the one fold
// of every route), and writes its outputs once, at the end.  The steps go
// in batches whose loads are independent and issue up front, the next
// batch's window loads in flight while this one folds.  The template flag
// WIF turns the what-if family on; without it no stage prefix is needed
// and the walk reads none of the boundary rows.  Two walks:
//
//   warp walk (what-if, S <= 32)  a warp holds whole ranks, floor(32 / S)
//     of them, lane = (rank, stage), so its loads of a step are one
//     contiguous run of d.  The stage prefix is a chain of shuffles: in
//     round k the lane of stage k adds its w to the prefix of stage k - 1,
//     so each add is made once per (rank, step, stage), in the reference's
//     order (two chains of 16 and a block total past 16 stages, as
//     `StagePrefix`).  The segment end's prefix and the previous
//     barrier's come by shuffle too.  No shared memory, no block barrier.
//   flat walk (any S without what-if; what-if past 32 stages)  lane = the
//     flat (rank, stage) index, so every lane is busy at any S.  With the
//     what-if family a segment pass goes first: one thread per (job,
//     step, rank) row takes the rank's prefix in `StagePrefix`'s order,
//     the row's stages staged through shared memory 32 at a time (a fixed
//     17 KB, whatever S), and writes each governing segment's
//     P[end] - P[start - 1] to a scratch row in device memory, which the
//     wrapper allocates at window size (`cell_scratch_floats`).  The flat
//     walk is launched with programmatic stream serialization: its prolog
//     and first window loads run beside the pass, and it waits for the
//     pass before it reads its cell's segment sums.
//
// Nothing in either walk grows with S but the segment pass's loop, so
// every S launches.  The fold of a batch forms its steps' excesses and
// contributions first (they are independent) and then adds them in step
// order: every float sum is the plain version's chain.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "frontier_common.cuh"

namespace {

constexpr int kCellThreads = 128;
constexpr int kWarpStages = 32;  // the warp walk's largest S
constexpr int kWarpBatch = 8;    // steps per batch of the warp walk
constexpr int kTileStages = 32;  // stages per shared tile of the segment pass
constexpr unsigned kFull = 0xffffffffu;

struct CellParams {
  const float* d;      // [J, N, R, S] contiguous
  const float* wmin;   // [J, N, S] cross-rank minimum (any [J, N, S]-sized
                       // address when no stage is a sync stage)
  const float* bw;     // what-if / regime baseline, strided view of d's shape
  const float* amax;   // [J, N, S] governing-boundary release (what-if)
  const float* sec;    // [J, N, S] governing-boundary second arrival
  const int* lead;     // [J, N, S] governing-boundary leader
  const float* relp;   // [J, N, S] previous segment's release
  const unsigned char* sync;  // [S], 1 on sync stages
  const float* thr;    // [J, R, S] activity threshold (regimes / hosts)
  const int* host;     // [J, R] rank -> host index (hosts)
  float* seg;          // scratch [J, N, R, S]: row (j, n, r) holds its
                       // segment sums in stage order (what-if, S > 32)
  float* wif;          // [J, S, R]
  int* count;          // [J, S, R] x5 integer regime statistics
  int* onset;
  int* last;
  int* runs;
  int* streak;
  float* sume;         // [J, S, R]
  float* sumpfx;       // [J, S, R]
  int* hostcnt;        // [J, N, S, H], zeroed by the caller
  long long bw_st[4];
  int N, R, S, H;
};

// What one cell carries across the steps, and its step-ordered fold.
template <bool WIF, bool REG, bool HOSTS>
struct CellState {
  float wacc = 0.f, se = 0.f, sp = 0.f;  // wacc only with WIF
  int cnt = 0, ons = kBig, lst = -1, rns = 0, stk = 0, prv = 0;
  float thr = 0.f;
  int host = -1;

  __device__ __forceinline__ CellState(const CellParams& p, int j, int r,
                                       int s, bool valid) {
    if ((REG || HOSTS) && valid) thr = p.thr[((long long)j * p.R + r) * p.S + s];
    if (HOSTS && valid) {
      host = p.host[(long long)j * p.R + r];
      if (host < 0 || host >= p.H) host = -1;  // out of range: no host row
    }
  }

  // step n of job j, stage s: its what-if contribution and excess
  __device__ __forceinline__ void add(const CellParams& p, int j, int n,
                                      int s, float contrib, float ew) {
    if (WIF) wacc = wacc + contrib;
    if (REG || HOSTS) {
      const bool act = ew > thr;
      if (REG) {
        const int ai = act ? 1 : 0;
        cnt += ai;
        ons = act ? min(ons, n) : ons;
        lst = act ? max(lst, n) : lst;  // n grows: the last active step
        rns += ai * (1 - prv);
        stk = act ? stk + 1 : 0;
        prv = ai;
        se = se + ew;
        sp = sp + se;
      }
      if (HOSTS && act && host >= 0)
        atomicAdd(&p.hostcnt[(((long long)j * p.N + n) * p.S + s) * p.H + host], 1);
    }
  }

  __device__ __forceinline__ void write(const CellParams& p, int j, int r,
                                       int s) const {
    const long long o = ((long long)j * p.S + s) * p.R + r;
    if (WIF) p.wif[o] = wacc;
    if (REG) {
      p.count[o] = cnt;
      p.onset[o] = ons;
      p.last[o] = lst;
      p.runs[o] = rns;
      p.streak[o] = stk;
      p.sume[o] = se;
      p.sumpfx[o] = sp;
    }
  }
};

// The what-if contribution of one cell at one step: the release it
// recovers at its governing barrier when its excess ew is clipped.
__device__ __forceinline__ float whatif_contrib(float am, float other,
                                               float arr, float ew) {
  return fmaxf(0.f, am - fmaxf(other, arr - ew));
}

// ---------------------------------------------------------------------------
// warp walk: the what-if family up to 32 stages
// ---------------------------------------------------------------------------

template <bool REG, bool HOSTS>
__global__ void __launch_bounds__(kCellThreads)
    cell_warp_kernel(const CellParams p) {
  // A kernel launched after this one with programmatic stream
  // serialization (the fused tick's frontier role, which needs nothing
  // from it) may start now and run beside the walk.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int K = kWarpBatch;
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int S = p.S;
  const int N = p.N;
  const int R = p.R;
  const int rpw = 32 / S;  // whole ranks per warp
  const int wid = blockIdx.x * (kCellThreads / 32) + (threadIdx.x >> 5);
  const int lr = lane / S;
  const int pos = lane - lr * S;  // this lane's stage
  const int lane0 = lr * S;       // the lane of its rank's stage 0
  const bool valid = lr < rpw && wid * rpw + lr < R;
  const int r = valid ? wid * rpw + lr : 0;  // in-bounds address when idle
  const int s = valid ? pos : 0;

  // the sync set as bits (lanes 0 .. S-1 hold stages 0 .. S-1), then the
  // governing segment: its end (the first barrier at or after this stage,
  // else the last stage) and the previous barrier (-1: none)
  const unsigned sync_bits =
      __ballot_sync(kFull, p.sync[pos] != 0) & (S == 32 ? kFull : (1u << S) - 1);
  const bool sync_s = (sync_bits >> pos) & 1u;
  const unsigned after = sync_bits & ~((1u << pos) - 1u);
  const unsigned before = sync_bits & ((1u << pos) - 1u);
  const int end = after ? __ffs(after) - 1 : S - 1;
  const int prev = before ? 31 - __clz(before) : -1;
  const int end_lane = lane0 + end;
  const int prev_lane = lane0 + max(prev, 0);

  const long long RS = (long long)R * S;
  const float* dcell = p.d + ((long long)j * N * R + r) * S + s;  // step 0
  const long long row0 = (long long)j * N * S + s;                 // step 0
  const float* bwc = p.bw + j * p.bw_st[0] + r * p.bw_st[2] + s * p.bw_st[3];
  CellState<true, REG, HOSTS> st(p, j, r, s, valid);

  float dcur[K];
#pragma unroll
  for (int t = 0; t < K; ++t) dcur[t] = t < N ? __ldg(dcell + t * RS) : 0.f;
  for (int n0 = 0; n0 < N; n0 += K) {
    // the next batch's window in flight while this one folds
    float dnxt[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int n = n0 + K + t;
      dnxt[t] = n < N ? __ldg(dcell + n * RS) : 0.f;
    }
    // every load of the batch up front and unconditional (a select after
    // it, never a load behind a test), so the batch waits for memory once
    float w[K], pw[K], bwv[K], relp[K], am[K], sec[K];
    int lead[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int n = min(n0 + t, N - 1);
      const long long o = row0 + n * S;
      const float wm = __ldg(p.wmin + o);
      bwv[t] = __ldg(bwc + n * p.bw_st[1]);
      relp[t] = __ldg(p.relp + o);
      am[t] = __ldg(p.amax + o);
      sec[t] = __ldg(p.sec + o);
      lead[t] = __ldg(p.lead + o);
      // imputed work, then its stage prefix: K chains side by side
      w[t] = sync_s ? wm : dcur[t];
      pw[t] = w[t];
    }
    const int pos16 = pos & (kBlock - 1);
#pragma unroll
    for (int k = 1; k < kBlock; ++k) {
      if (k < S) {
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const float up = __shfl_up_sync(kFull, pw[t], 1);
          if (pos16 == k) pw[t] = up + w[t];
        }
      }
    }
    if (S > kBlock) {  // the second block adds the first block's total
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float total = __shfl_sync(kFull, pw[t], lane0 + kBlock - 1);
        if (pos >= kBlock) pw[t] = total + pw[t];
      }
    }
    // segment prefixes, contributions, then the step-ordered fold
    float contrib[K], ew[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float pe = __shfl_sync(kFull, pw[t], end_lane);
      const float pb = __shfl_sync(kFull, pw[t], prev_lane);
      const float seg = prev >= 0 ? pe - pb : pe;
      ew[t] = fmaxf(0.f, w[t] - bwv[t]);
      const float arr = relp[t] + seg;
      const float other = r == lead[t] ? sec[t] : am[t];
      contrib[t] = whatif_contrib(am[t], other, arr, ew[t]);
    }
    if (valid) {
#pragma unroll
      for (int t = 0; t < K; ++t)
        if (n0 + t < N) st.add(p, j, n0 + t, s, contrib[t], ew[t]);
    }
#pragma unroll
    for (int t = 0; t < K; ++t) dcur[t] = dnxt[t];
  }
  if (valid) st.write(p, j, r, s);
}

// ---------------------------------------------------------------------------
// segment pass and flat walk
// ---------------------------------------------------------------------------

// The segment sums of every (job, step, rank) row: row q of the scratch
// holds, for each governing segment g in stage order, P[end] - P[start -
// 1] of the imputed work (P[end] for the first), P the prefix in
// StagePrefix's order.  One thread a row, the prefix state in registers.
// The block's 128 rows are contiguous in d; they go through shared memory
// kTileStages stages at a time, a warp load one 128-byte line, the next
// two tiles' loads in flight while this one's prefixes are taken.
__global__ void __launch_bounds__(kCellThreads)
    cell_segment_kernel(const CellParams p, long long rows) {
  // the flat walk, launched after this pass with programmatic stream
  // serialization, may start its prolog now (it waits for these sums)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int kWarps = kCellThreads / 32;
  constexpr int kRowsPerWarp = kCellThreads / kWarps;
  __shared__ float tile[kCellThreads][kTileStages + 1];  // odd stride: no conflicts
  __shared__ long long wrow[kCellThreads];  // each row's [S] row of wmin
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S = p.S;
  const long long q0 = (long long)blockIdx.x * kCellThreads;
  const long long q = min(q0 + tid, rows - 1);  // idle threads: the last row
  wrow[tid] = q / p.R * S;
  float* out = p.seg + q * S;

  // tile k0: lane = stage, warp w loads rows w, w + kWarps, ...; the imputed
  // work is d, or on a sync stage its step's cross-rank minimum
  auto load = [&](int k0, float (&v)[kRowsPerWarp], unsigned& bits) {
    const int kn = min(kTileStages, S - k0);
    const int k = k0 + min(lane, kn - 1);  // in bounds past the tail
    bits = __ballot_sync(kFull, lane < kn && p.sync[k] != 0);
    const bool sy = (bits >> lane) & 1u;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int lr = warp + kWarps * i;
      const long long row = min(q0 + lr, rows - 1);
      v[i] = __ldg(sy ? p.wmin + wrow[lr] + k : p.d + row * S + k);
    }
  };

  StagePrefix pfx;
  float base = 0.f;  // prefix at the previous barrier
  bool has_base = false;
  int g = 0;
  __syncthreads();  // wrow
  // two tiles in flight: this one's and the next one's loads
  float v[kRowsPerWarp], vn[kRowsPerWarp];
  unsigned bits = 0, bits_n = 0;  // the tiles' sync stages
  load(0, v, bits);
  if (kTileStages < S) load(kTileStages, vn, bits_n);
  for (int k0 = 0; k0 < S; k0 += kTileStages) {
    const int kn = min(kTileStages, S - k0);
    const unsigned sync_bits = bits;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) tile[warp + kWarps * i][lane] = v[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) v[i] = vn[i];
    bits = bits_n;
    if (k0 + 2 * kTileStages < S) load(k0 + 2 * kTileStages, vn, bits_n);
    if (q0 + tid < rows) {
      for (int k = 0; k < kn; ++k) {
        const float pw = pfx.next(tile[tid][k]);
        if (((sync_bits >> k) & 1u) || k0 + k == S - 1) {
          out[g++] = has_base ? pw - base : pw;
          base = pw;
          has_base = true;
        }
      }
    }
    __syncthreads();  // every thread is done with the tile
  }
}

// Sync stages before stage s of a warp's lanes, which is the index of the
// segment s belongs to: the warp takes the sync bytes 32 at a time.
// Every lane of the warp must call it.
__device__ __forceinline__ int segment_of(const unsigned char* sync, int S,
                                          int s) {
  const int lane = threadIdx.x & 31;
  int g = 0;
  for (int k0 = 0; k0 < S; k0 += 32) {
    const unsigned bits = __ballot_sync(kFull, k0 + lane < S && sync[k0 + lane] != 0);
    const int below = s - k0;  // stages of this chunk before s
    g += __popc(below >= 32 ? bits : below > 0 ? bits & ((1u << below) - 1u) : 0u);
  }
  return g;
}

// A batch of K steps of one cell of the flat walk: every load of the
// batch, issued together (the last step again past N - 1).
template <bool WIF, int K>
struct FlatBatch {
  float w[K], bw[K];                    // imputed work, baseline
  float seg[K], relp[K], am[K], sec[K];  // what-if only
  int lead[K];

  // the loads that do not need the segment pass; bw0 is the baseline
  // when it is constant over the steps (bw_st[1] == 0, as with regimes
  // or hosts), read once
  __device__ __forceinline__ void load_rows(const CellParams& p, const float* wp,
                                            long long wst, const float* bwc,
                                            float bw0, long long row0, int n0) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int n = min(n0 + t, p.N - 1);
      w[t] = __ldg(wp + n * wst);
      bw[t] = p.bw_st[1] == 0 ? bw0 : __ldg(bwc + n * p.bw_st[1]);
      if (WIF) {
        const long long o = row0 + (long long)n * p.S;
        relp[t] = __ldg(p.relp + o);
        am[t] = __ldg(p.amax + o);
        sec[t] = __ldg(p.sec + o);
        lead[t] = __ldg(p.lead + o);
      }
    }
  }

  // the segment pass's sums: written while this grid runs (programmatic
  // launch), so read through L2 (ld.global.cg), never the read-only path
  __device__ __forceinline__ void load_seg(const CellParams& p, const float* gp,
                                           long long RS, int n0) {
#pragma unroll
    for (int t = 0; t < K; ++t) seg[t] = __ldcg(gp + min(n0 + t, p.N - 1) * RS);
  }
};

// The flat walk: one thread a cell, lane = the flat (rank, stage) index.
template <bool WIF, bool REG, bool HOSTS>
__global__ void __launch_bounds__(kCellThreads)
    cell_flat_kernel(const CellParams p) {
  // without the what-if family a step is two loads: larger batches
  constexpr int K = WIF ? 8 : 12;
  const int j = blockIdx.y;
  const int S = p.S;
  const int N = p.N;
  const long long RS = (long long)p.R * S;
  const long long c0 = (long long)blockIdx.x * kCellThreads + threadIdx.x;
  const bool valid = c0 < RS;
  const long long c = valid ? c0 : 0;  // in-bounds address when idle
  const int r = static_cast<int>(c / S);
  const int s = static_cast<int>(c - (long long)r * S);
  const bool sync_s = p.sync[s] != 0;
  // the imputed work: the window, or on a sync stage the [J, N, S] row
  const float* wp = sync_s ? p.wmin + (long long)j * N * S + s
                           : p.d + (long long)j * N * RS + c;
  const long long wst = sync_s ? S : RS;
  const float* bwc = p.bw + j * p.bw_st[0] + r * p.bw_st[2] + s * p.bw_st[3];
  const long long row0 = (long long)j * N * S + s;  // step 0 of the rows
  const float* gp = nullptr;                        // step 0 of the segment sum
  if (WIF) gp = p.seg + ((long long)j * N * p.R + r) * S + segment_of(p.sync, S, s);
  CellState<WIF, REG, HOSTS> st(p, j, r, s, valid);
  const float bw0 = __ldg(bwc);

  FlatBatch<WIF, K> cur, nxt;
  cur.load_rows(p, wp, wst, bwc, bw0, row0, 0);
  if (WIF) {
    // the segment pass ran just before: its sums
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    cur.load_seg(p, gp, RS, 0);
  }
  for (int n0 = 0; n0 < N; n0 += K) {
    // the next batch in flight while this one folds
    nxt.load_rows(p, wp, wst, bwc, bw0, row0, n0 + K);
    if (WIF) nxt.load_seg(p, gp, RS, n0 + K);
    float contrib[K], ew[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      ew[t] = fmaxf(0.f, cur.w[t] - cur.bw[t]);
      contrib[t] = 0.f;
      if (WIF) {
        const float arr = cur.relp[t] + cur.seg[t];
        const float other = r == cur.lead[t] ? cur.sec[t] : cur.am[t];
        contrib[t] = whatif_contrib(cur.am[t], other, arr, ew[t]);
      }
    }
    if (valid) {
#pragma unroll
      for (int t = 0; t < K; ++t)
        if (n0 + t < N) st.add(p, j, n0 + t, s, contrib[t], ew[t]);
    }
    cur = nxt;
  }
  if (valid) st.write(p, j, r, s);
}

// Floats of scratch (CellParams::seg) the walk with the what-if family
// needs for a J x N x R x S window: a segment row per (job, step, rank)
// past kWarpStages, else none.
inline long long cell_scratch_floats(int J, int N, int R, int S) {
  return S > kWarpStages ? (long long)J * N * R * S : 0;
}

// Launches the cell walk with the what-if (WIF), regime (REG) and host
// (HOSTS) families on `st`; the caller reads cudaGetLastError() too.  With
// the what-if family past kWarpStages, p.seg holds cell_scratch_floats
// floats.  Returns the flat walk's launch error, else cudaSuccess.
template <bool WIF, bool REG, bool HOSTS>
cudaError_t launch_cell_walk(const CellParams& p, int J, cudaStream_t st) {
  if constexpr (WIF) {
    if (p.S <= kWarpStages) {
      constexpr int kWarps = kCellThreads / 32;
      const int warps = (p.R + 32 / p.S - 1) / (32 / p.S);  // per job
      const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps),
                      static_cast<unsigned>(J));
      cell_warp_kernel<REG, HOSTS><<<grid, kCellThreads, 0, st>>>(p);
      return cudaSuccess;
    }
    const long long rows = (long long)J * p.N * p.R;
    const unsigned blocks = static_cast<unsigned>((rows + kCellThreads - 1) / kCellThreads);
    cell_segment_kernel<<<blocks, kCellThreads, 0, st>>>(p, rows);
  }
  // launched with programmatic stream serialization: the walk's prolog
  // runs beside the segment pass, and it waits for the pass's sums
  const long long cells = (long long)p.R * p.S;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((cells + kCellThreads - 1) / kCellThreads),
                     static_cast<unsigned>(J));
  cfg.blockDim = dim3(kCellThreads);
  cfg.stream = st;
  cudaLaunchAttribute overlap;
  overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &overlap;
  cfg.numAttrs = WIF ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, cell_flat_kernel<WIF, REG, HOSTS>, p);
}

}  // namespace
