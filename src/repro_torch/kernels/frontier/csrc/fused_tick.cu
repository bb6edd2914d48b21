// The fused fleet tick: every per-tick accumulator family of a stacked
// window tensor d[J, N, R, S] in one call.
//
// Replaces the Pallas TPU kernel `_fused_tick_kernel`
// (src/repro/kernels/frontier/fused.py, reached through
// `_fused_tick_impl` and the public `fused_fleet_tick`).  It computes the
// same four families:
//
//   frontier   per (job, step, stage): frontier = max_r P, leader (lowest
//              global rank on ties), second (top-2 merge that keeps tied
//              duplicates) and clipped = max_r (P_final - max(0, d - bd)),
//              P the stage prefix of d;
//   what-if    per (job, stage, rank): sum over steps, in step order, of
//              max(0, amax - max(other, arr - excess_w)), other = second on
//              the leader's lane and amax elsewhere;
//   regimes    per (job, stage, rank): the seven temporal statistics
//              (count, onset with BIG = 2^30, last, runs, streak, sum_e,
//              sum_pfx), adds only, folded in step order;
//   hosts      per (job, step, stage, host): active-rank counts (integer
//              atomics, exact in any order).
//
// Bound.  About S floating-point operations per float loaded: the call is
// bound by device-memory bytes, one read of d (J*N*R*S*4 bytes) and of the
// prolog's rows plus one write of the outputs.  The imputed work w differs
// from d only on sync stages, where it is the per-step cross-rank minimum,
// so w arrives as a [J, N, S] row and never as a second window.
// Baselines arrive as strided views ([J, S] medians broadcast with zero
// strides), never materialized at window size.
//
// Design.  The TPU runs its grid in order and fuses the families to share
// one read of the window on it; here blocks run side by side, so the
// parallelism comes from what is independent.  Given the rows the torch
// prolog computes (amax, second, leader, relprev, wmin, thr) the families
// do not depend on one another, and the call runs them as two roles, each
// a launch on the caller's stream:
//
//   cell role      one thread per (job, rank, stage) cell, walking the
//                  steps in order with its what-if sum, regime statistics
//                  and host in registers (`cell_walk.cuh`, which the
//                  what-if and regime kernels of the four-dispatch route
//                  run too): the only serial chain left is the one the
//                  sums need.  Past 32 stages it is two launches, a
//                  segment pass into the caller's scratch and the walk.
//   frontier role  blocks of (job, chunk of kStepChunk steps, 128-rank
//                  tile), one thread per rank.  No state crosses a step,
//                  so the step axis spreads over the card.  Per step each
//                  block reduces its tile with warp shuffles and a merge
//                  across its 4 warps, with an explicit index tie-break
//                  (equal values keep the lower rank), and writes a
//                  per-tile partial [J, T, N, S]; a third launch merges
//                  the partials in tile order when R > 128 (ties keep the
//                  lower tile).  Up to 16 stages the summaries live in
//                  register arrays (MS = 8 or 16); past that the block
//                  reduces 32 stages per round with running prefixes in
//                  `StagePrefix`'s blocked order, so nothing grows with S.
//
// The frontier role is launched with programmatic stream serialization
// and the cell role's warp walk (S <= 32) releases it at once, so the two
// share the card: the cell role's step chain leaves most SM slots free at
// the service's sizes, and the frontier role fills them.  Past 32 stages
// the flat walk does not release it, so the frontier role starts when the
// walk ends.
//
// Every float sum is the step-ordered add chain the plain version takes,
// with no multiply (nothing contracts to an FMA), and no float atomics
// anywhere.  The cell role rebuilds each arrival with the prolog's adds,
// so the leader's own arrival equals amax bit for bit and its zero-excess
// cell cancels exactly.  Each role reads d; at the service's group size
// (10 MB) the second read comes from L2.
//
// Subnormals: the library is built with -ftz=true, so every float
// operand and result below FLT_MIN flushes to zero, as in the reference;
// the plain torch version flushes at the same operations (`ops.ftz`).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cell_walk.cuh"
#include "frontier_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStepChunk = 2;  // steps per frontier-role block

struct Params {
  // inputs
  const float* d;      // [J, N, R, S] contiguous
  const float* wmin;   // [J, N, S] cross-rank minimum (d itself when no
                       // stage is a sync stage)
  const float* bd;     // frontier baseline, strided view of [J, N, R, S]
  const float* bw;     // what-if / regime baseline, strided view
  const float* amax;   // [J, N, S] governing-boundary release
  const float* sec;    // [J, N, S] governing-boundary second arrival
  const int* lead;     // [J, N, S] governing-boundary leader
  const float* relp;   // [J, N, S] previous segment's release
  const float* thr;    // [J, R, S] activity threshold (regimes / hosts)
  const int* host;     // [J, R] rank -> host index (hosts)
  const unsigned char* sync;  // [S], 1 on sync stages
  float* seg;          // the cell walk's scratch (cell_scratch_floats)
  // frontier partials [J, T, N, S] (the outputs themselves when T == 1)
  float* pf;
  int* pl;
  float* ps;
  float* pc;
  // frontier outputs [J, N, S] (written by the fold when T > 1)
  float* f;
  int* fl;
  float* fs;
  float* fc;
  float* wif;  // [J, S, R]
  int* count;  // [J, S, R] x5 integer regime statistics
  int* onset;
  int* last;
  int* runs;
  int* streak;
  float* sume;    // [J, S, R]
  float* sumpfx;  // [J, S, R]
  int* hostcnt;   // [J, N, S, H], zeroed by the caller
  long long bd_st[4];
  long long bw_st[4];
  int J, N, R, S, H, T;
};

// The frontier role up to MS stages: block (job * chunks + chunk, tile).
template <int MS>
__global__ void __launch_bounds__(kThreads)
    frontier_role_kernel(const Params p) {
  const int chunks = (p.N + kStepChunk - 1) / kStepChunk;
  const int j = blockIdx.x / chunks;
  const int n0 = (blockIdx.x - j * chunks) * kStepChunk;
  const int n1 = min(p.N, n0 + kStepChunk);
  const int tile = blockIdx.y;
  const int r = tile * kThreads + threadIdx.x;
  const bool valid = r < p.R;
  const int S = p.S;
  const int N = p.N;
  const int R = p.R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float NEG_INF = -INFINITY;

  // double-buffered warp partials: one barrier per step suffices
  __shared__ float sm_m[2][kWarps][MS];
  __shared__ float sm_s[2][kWarps][MS];
  __shared__ float sm_c[2][kWarps][MS];
  __shared__ int sm_i[2][kWarps][MS];

  const long long rr = valid ? r : 0;  // in-bounds address for idle lanes
  for (int n = n0; n < n1; ++n) {
    const long long jn = (long long)j * N + n;
    const float* drow = p.d + (jn * R + rr) * S;
    const float* bdp = p.bd + j * p.bd_st[0] + n * p.bd_st[1] + rr * p.bd_st[2];

    float dv[MS], pd[MS];
#pragma unroll
    for (int s = 0; s < MS; ++s) dv[s] = s < S ? drow[s] : 0.f;
    // stage prefix: explicit stage-ordered adds (the prolog's order)
    pd[0] = dv[0];
#pragma unroll
    for (int s = 1; s < MS; ++s) pd[s] = pd[s - 1] + dv[s];
    float pd_final = pd[0];
#pragma unroll
    for (int s = 1; s < MS; ++s)
      if (s == S - 1) pd_final = pd[s];

    float m[MS], sc[MS], cl[MS];
    int ix[MS];
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      if (s < S && valid) {
        m[s] = pd[s];
        ix[s] = r;
        const float bds = bdp[s * p.bd_st[3]];
        cl[s] = pd_final - fmaxf(0.f, dv[s] - bds);
      } else {
        m[s] = NEG_INF;
        ix[s] = kBig;
        cl[s] = NEG_INF;
      }
      sc[s] = NEG_INF;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int s = 0; s < MS; ++s) {
        if (s < S) {
          const float m2 = __shfl_xor_sync(0xffffffffu, m[s], off);
          const int i2 = __shfl_xor_sync(0xffffffffu, ix[s], off);
          const float s2 = __shfl_xor_sync(0xffffffffu, sc[s], off);
          const float c2 = __shfl_xor_sync(0xffffffffu, cl[s], off);
          merge_top2(m[s], ix[s], sc[s], m2, i2, s2);
          cl[s] = fmaxf(cl[s], c2);
        }
      }
    }
    const int buf = n & 1;
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < MS; ++s) {
        if (s < S) {
          sm_m[buf][warp][s] = m[s];
          sm_i[buf][warp][s] = ix[s];
          sm_s[buf][warp][s] = sc[s];
          sm_c[buf][warp][s] = cl[s];
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < S) {
      const int s = threadIdx.x;
      float bm = sm_m[buf][0][s], bs = sm_s[buf][0][s], bc = sm_c[buf][0][s];
      int bi = sm_i[buf][0][s];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        merge_top2(bm, bi, bs, sm_m[buf][w][s], sm_i[buf][w][s],
                   sm_s[buf][w][s]);
        bc = fmaxf(bc, sm_c[buf][w][s]);
      }
      const long long o = (((long long)j * p.T + tile) * N + n) * S + s;
      p.pf[o] = bm;
      p.pl[o] = bi;
      p.ps[o] = bs;
      p.pc[o] = bc;
    }
  }
}

// Stages per frontier-reduction round of the wide role (one lane of the
// reducing warp per stage).
constexpr int kChunk = 32;

// The frontier role for any S (used past 16 stages): the arithmetic of
// `frontier_role_kernel`, with the stage prefixes in the blocked order of
// `StagePrefix` and kChunk stages reduced per round.
__global__ void __launch_bounds__(kThreads)
    frontier_role_wide_kernel(const Params p) {
  const int chunks = (p.N + kStepChunk - 1) / kStepChunk;
  const int j = blockIdx.x / chunks;
  const int n0 = (blockIdx.x - j * chunks) * kStepChunk;
  const int n1 = min(p.N, n0 + kStepChunk);
  const int tile = blockIdx.y;
  const int r = tile * kThreads + threadIdx.x;
  const bool valid = r < p.R;
  const int S = p.S;
  const int N = p.N;
  const int R = p.R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float NEG_INF = -INFINITY;

  // double-buffered warp partials of one round of kChunk stages
  __shared__ float sm_m[2][kWarps][kChunk];
  __shared__ float sm_s[2][kWarps][kChunk];
  __shared__ float sm_c[2][kWarps][kChunk];
  __shared__ int sm_i[2][kWarps][kChunk];

  const long long rr = valid ? r : 0;  // in-bounds address for idle lanes
  int rounds = 0;  // frontier rounds so far: picks the shared buffer
  for (int n = n0; n < n1; ++n) {
    const long long jn = (long long)j * N + n;
    const float* drow = p.d + (jn * R + rr) * S;
    const float* bdp = p.bd + j * p.bd_st[0] + n * p.bd_st[1] + rr * p.bd_st[2];

    // the last stage prefix first: every stage's clip needs it
    float pd_final = 0.f;
    {
      StagePrefix pfx;
      for (int s = 0; s < S; ++s) pd_final = pfx.next(drow[s]);
    }

    StagePrefix pfx_d;
    for (int c0 = 0; c0 < S; c0 += kChunk, ++rounds) {
      const int cn = min(kChunk, S - c0);
      const int buf = rounds & 1;
      for (int k = 0; k < cn; ++k) {
        const int s = c0 + k;
        const float dv = drow[s];
        const float pd = pfx_d.next(dv);
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
        const long long o = (((long long)j * p.T + tile) * N + n) * S + c0 + k;
        p.pf[o] = bm;
        p.pl[o] = bi;
        p.ps[o] = bs;
        p.pc[o] = bc;
      }
    }
  }
}

// Merge the per-tile frontier partials in tile order: one thread per
// (job, step, stage).
__global__ void fold_tiles_kernel(const Params p) {
  const long long per_job = (long long)p.N * p.S;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p.J * per_job) return;
  const long long j = idx / per_job;
  const long long rem = idx - j * per_job;
  long long o = j * p.T * per_job + rem;
  float m = p.pf[o], s = p.ps[o], c = p.pc[o];
  int i = p.pl[o];
  for (int t = 1; t < p.T; ++t) {
    o += per_job;
    merge_top2(m, i, s, p.pf[o], p.pl[o], p.ps[o]);
    c = fmaxf(c, p.pc[o]);
  }
  p.f[idx] = m;
  p.fl[idx] = i;
  p.fs[idx] = s;
  p.fc[idx] = c;
}

CellParams cell_params(const Params& p) {
  CellParams c;
  c.d = p.d;
  c.wmin = p.wmin;
  c.bw = p.bw;
  c.amax = p.amax;
  c.sec = p.sec;
  c.lead = p.lead;
  c.relp = p.relp;
  c.sync = p.sync;
  c.thr = p.thr;
  c.host = p.host;
  c.seg = p.seg;
  c.wif = p.wif;
  c.count = p.count;
  c.onset = p.onset;
  c.last = p.last;
  c.runs = p.runs;
  c.streak = p.streak;
  c.sume = p.sume;
  c.sumpfx = p.sumpfx;
  c.hostcnt = p.hostcnt;
  for (int k = 0; k < 4; ++k) c.bw_st[k] = p.bw_st[k];
  c.N = p.N;
  c.R = p.R;
  c.S = p.S;
  c.H = p.H;
  return c;
}

}  // namespace

extern "C" {

// Pointer slots of `ptrs` (device addresses; 0 where a family is off).
enum {
  kD, kWmin, kBd, kBw, kAmax, kSec, kLead, kRelp, kThr, kHost, kSync, kSeg,
  kPf, kPl, kPs, kPc, kF, kFl, kFs, kFc, kWif,
  kCount, kOnset, kLast, kRuns, kStreak, kSume, kSumpfx, kHostcnt,
  kNumPtrs
};
// Integer slots of `ints`.
enum {
  iJ, iN, iR, iS, iH, iT, iReg, iHosts,
  iBd0, iBd1, iBd2, iBd3, iBw0, iBw1, iBw2, iBw3,
  kNumInts
};

int fused_tick_num_slots(int which) {
  return which == 0 ? static_cast<int>(kNumPtrs) : static_cast<int>(kNumInts);
}

// Floats of the scratch buffer (slot kSeg) a J x N x R x S window needs:
// 0 up to 32 stages.
long long fused_tick_scratch_floats(int J, int N, int R, int S) {
  return cell_scratch_floats(J, N, R, S);
}

// Launches the tick on `stream`: the cell role, the frontier role and,
// when T > 1, the tile fold.  Returns the first launch error, else
// cudaGetLastError() after the launches: 0 when all were accepted.
int fused_tick_launch(void* const* ptrs, const long long* ints,
                      void* stream) {
  Params p;
  p.d = static_cast<const float*>(ptrs[kD]);
  p.wmin = static_cast<const float*>(ptrs[kWmin]);
  p.bd = static_cast<const float*>(ptrs[kBd]);
  p.bw = static_cast<const float*>(ptrs[kBw]);
  p.amax = static_cast<const float*>(ptrs[kAmax]);
  p.sec = static_cast<const float*>(ptrs[kSec]);
  p.lead = static_cast<const int*>(ptrs[kLead]);
  p.relp = static_cast<const float*>(ptrs[kRelp]);
  p.thr = static_cast<const float*>(ptrs[kThr]);
  p.host = static_cast<const int*>(ptrs[kHost]);
  p.sync = static_cast<const unsigned char*>(ptrs[kSync]);
  p.seg = static_cast<float*>(ptrs[kSeg]);
  p.pf = static_cast<float*>(ptrs[kPf]);
  p.pl = static_cast<int*>(ptrs[kPl]);
  p.ps = static_cast<float*>(ptrs[kPs]);
  p.pc = static_cast<float*>(ptrs[kPc]);
  p.f = static_cast<float*>(ptrs[kF]);
  p.fl = static_cast<int*>(ptrs[kFl]);
  p.fs = static_cast<float*>(ptrs[kFs]);
  p.fc = static_cast<float*>(ptrs[kFc]);
  p.wif = static_cast<float*>(ptrs[kWif]);
  p.count = static_cast<int*>(ptrs[kCount]);
  p.onset = static_cast<int*>(ptrs[kOnset]);
  p.last = static_cast<int*>(ptrs[kLast]);
  p.runs = static_cast<int*>(ptrs[kRuns]);
  p.streak = static_cast<int*>(ptrs[kStreak]);
  p.sume = static_cast<float*>(ptrs[kSume]);
  p.sumpfx = static_cast<float*>(ptrs[kSumpfx]);
  p.hostcnt = static_cast<int*>(ptrs[kHostcnt]);
  p.J = static_cast<int>(ints[iJ]);
  p.N = static_cast<int>(ints[iN]);
  p.R = static_cast<int>(ints[iR]);
  p.S = static_cast<int>(ints[iS]);
  p.H = static_cast<int>(ints[iH]);
  p.T = static_cast<int>(ints[iT]);
  for (int k = 0; k < 4; ++k) {
    p.bd_st[k] = ints[iBd0 + k];
    p.bw_st[k] = ints[iBw0 + k];
  }
  const bool reg = ints[iReg] != 0;
  const bool hosts = ints[iHosts] != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaGetLastError();  // clear any stale error from earlier work
  // the cell role first; the frontier role may start beside it (the warp
  // walk lets it at once, the flat walk when it ends)
  const CellParams cp = cell_params(p);
  const cudaError_t err = reg && hosts ? launch_cell_walk<true, true, true>(cp, p.J, st)
                          : reg        ? launch_cell_walk<true, true, false>(cp, p.J, st)
                          : hosts      ? launch_cell_walk<true, false, true>(cp, p.J, st)
                                       : launch_cell_walk<true, false, false>(cp, p.J, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (p.N + kStepChunk - 1) / kStepChunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.J * chunks), static_cast<unsigned>(p.T));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute overlap;
  overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &overlap;
  cfg.numAttrs = 1;
  const cudaError_t front = p.S <= 8    ? cudaLaunchKernelEx(&cfg, frontier_role_kernel<8>, p)
                            : p.S <= 16 ? cudaLaunchKernelEx(&cfg, frontier_role_kernel<16>, p)
                                        : cudaLaunchKernelEx(&cfg, frontier_role_wide_kernel, p);
  if (front != cudaSuccess) return static_cast<int>(front);
  if (p.T > 1) {
    const long long total = (long long)p.J * p.N * p.S;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    fold_tiles_kernel<<<blocks, threads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_tick_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
