// The fused fleet tick: every per-tick accumulator family of a stacked
// window tensor d[J, N, R, S] from one read of the window.
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
// Bound.  About S floating-point operations per float loaded: the kernel
// is bound by device-memory bytes.  It reads d once (J*N*R*S*4 bytes);
// the imputed work w differs from d only on sync stages, where it is the
// per-step cross-rank minimum, so w arrives as a [J, N, S] row and never
// as a second window.  Baselines arrive as strided views ([J, S] medians
// broadcast with zero strides), never materialized at window size.
//
// Design.  Grid (J, ceil(R / 128)), 128 threads, one thread per rank of
// the tile in the natural [J, N, R, S] layout (a warp's loads of one
// step are one contiguous run of 32 * S floats).  Each thread walks the N
// steps in order and keeps its S what-if and regime accumulators in
// registers (S <= 16: arrays sized by the template constant MS = 8 or
// 16), so every float sum is a sequential step-ordered add chain with no
// multiply (nothing contracts to an FMA).  Past 16 stages the wide
// variant takes any S: it keeps its accumulators in the [J, S, R] outputs
// themselves (each thread reads and writes its own cells, coalesced over
// the warp's ranks, in step order), walks the stages as running prefixes
// instead of per-stage arrays (past 16 stages the prefix takes the
// reference's blocked add order, see `StagePrefix` in
// frontier_common.cuh), and reduces the
// frontier family 32 stages per round, so neither registers nor shared
// memory grow with S.  The TPU kernel folds rank tiles into the
// frontier outputs across its sequential grid; on this card blocks run in
// no order, so each block reduces its tile with warp shuffles and writes
// a per-tile partial, and a second kernel merges the partials in tile
// order (ties keep the lower tile).  No float
// atomics anywhere.  The what-if boundary statistics (amax, second,
// leader, relprev rows) come from the caller's prolog, which builds the
// arrivals with the same stage-ordered adds this kernel uses, so the
// leader's zero-excess cell cancels exactly.
//
// Subnormals: the library is built with -ftz=true, so every float
// operand and result below FLT_MIN flushes to zero, as in the reference;
// the plain torch version flushes at the same operations (`ops.ftz`).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "frontier_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Params {
  // inputs
  const float* d;      // [J, N, R, S] contiguous
  const float* wmin;   // [J, N, S] cross-rank minimum (read on sync stages)
  const float* bd;     // frontier baseline, strided view of [J, N, R, S]
  const float* bw;     // what-if / regime baseline, strided view
  const float* amax;   // [J, N, S] governing-boundary release
  const float* sec;    // [J, N, S] governing-boundary second arrival
  const int* lead;     // [J, N, S] governing-boundary leader
  const float* relp;   // [J, N, S] previous segment's release
  const float* thr;    // [J, R, S] activity threshold (regimes / hosts)
  const int* host;     // [J, R] rank -> host index (hosts)
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
  unsigned sync_mask;  // the sync set as bits (S <= 16 variants)
  const unsigned char* sync;  // the same set, 1 byte per stage (wide)
};

template <int MS, bool REG, bool HOSTS>
__global__ void __launch_bounds__(kThreads)
    fused_tick_kernel(const Params p) {
  const int j = blockIdx.x;
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

  // sync segmentation: stage s belongs to the segment ending at the first
  // declared barrier at or after s, else at the last stage
  bool is_sync[MS];
#pragma unroll
  for (int s = 0; s < MS; ++s) is_sync[s] = (p.sync_mask >> s) & 1u;

  float thr[MS];
  int host = -1;
  if (REG || HOSTS) {
#pragma unroll
    for (int s = 0; s < MS; ++s)
      thr[s] = (valid && s < S) ? p.thr[((long long)j * R + r) * S + s] : 0.f;
  }
  if (HOSTS && valid) {
    host = p.host[(long long)j * R + r];
    if (host < 0 || host >= p.H) host = -1;  // out of range: no host row
  }

  float wacc[MS];
  int cnt[MS], ons[MS], lst[MS], rns[MS], stk[MS], prv[MS];
  float se[MS], sp[MS];
#pragma unroll
  for (int s = 0; s < MS; ++s) {
    wacc[s] = 0.f;
    if (REG) {
      cnt[s] = 0;
      ons[s] = kBig;
      lst[s] = -1;
      rns[s] = 0;
      stk[s] = 0;
      prv[s] = 0;
      se[s] = 0.f;
      sp[s] = 0.f;
    }
  }

  const long long rr = valid ? r : 0;  // in-bounds address for idle lanes
  for (int n = 0; n < N; ++n) {
    const long long jn = (long long)j * N + n;
    const float* drow = p.d + (jn * R + rr) * S;
    const float* bdp = p.bd + j * p.bd_st[0] + n * p.bd_st[1] + rr * p.bd_st[2];
    const float* bwp = p.bw + j * p.bw_st[0] + n * p.bw_st[1] + rr * p.bw_st[2];
    const float* stat_amax = p.amax + jn * S;
    const float* stat_sec = p.sec + jn * S;
    const int* stat_lead = p.lead + jn * S;
    const float* stat_relp = p.relp + jn * S;

    float dv[MS], wv[MS], pd[MS], pw[MS];
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      if (s < S) {
        dv[s] = drow[s];
        wv[s] = is_sync[s] ? p.wmin[jn * S + s] : dv[s];
      } else {
        dv[s] = 0.f;
        wv[s] = 0.f;
      }
    }
    // stage prefixes: explicit stage-ordered adds (the prolog's order)
    pd[0] = dv[0];
    pw[0] = wv[0];
#pragma unroll
    for (int s = 1; s < MS; ++s) {
      pd[s] = pd[s - 1] + dv[s];
      pw[s] = pw[s - 1] + wv[s];
    }
    float pd_final = pd[0];
#pragma unroll
    for (int s = 1; s < MS; ++s)
      if (s == S - 1) pd_final = pd[s];

    // -- frontier family: warp-shuffle reduction of the tile ---------------
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

    // -- what-if family (and the regime / host activity it shares) ---------
    // arrival at each stage's governing boundary: relprev + segment prefix
    float seg_end[MS];
    {
      float endp = pw[0];
#pragma unroll
      for (int s = MS - 1; s >= 0; --s) {
        if (s < S && (is_sync[s] || s == S - 1)) endp = pw[s];
        seg_end[s] = endp;
      }
    }
    float base = 0.f;
    bool has_base = false;
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      if (s < S) {
        const float seg = has_base ? seg_end[s] - base : seg_end[s];
        if (is_sync[s]) {
          base = pw[s];
          has_base = true;
        }
        const float ew = fmaxf(0.f, wv[s] - bwp[s * p.bw_st[3]]);
        const float arr = stat_relp[s] + seg;
        const float am = stat_amax[s];
        const float other = (r == stat_lead[s]) ? stat_sec[s] : am;
        const float new_a = fmaxf(other, arr - ew);
        const float contrib = valid ? fmaxf(0.f, am - new_a) : 0.f;
        wacc[s] = wacc[s] + contrib;
        if (REG || HOSTS) {
          const bool act = valid && (ew > thr[s]);
          if (REG) {
            const int ai = act ? 1 : 0;
            cnt[s] += ai;
            ons[s] = act ? min(ons[s], n) : ons[s];
            lst[s] = act ? max(lst[s], n) : lst[s];
            rns[s] += ai * (1 - prv[s]);
            stk[s] = act ? stk[s] + 1 : 0;
            prv[s] = ai;
            se[s] = se[s] + ew;
            sp[s] = sp[s] + se[s];
          }
          if (HOSTS && act && host >= 0)
            atomicAdd(&p.hostcnt[(jn * S + s) * p.H + host], 1);
        }
      }
    }
  }

  if (!valid) return;
#pragma unroll
  for (int s = 0; s < MS; ++s) {
    if (s < S) {
      const long long o = ((long long)j * S + s) * R + r;
      p.wif[o] = wacc[s];
      if (REG) {
        p.count[o] = cnt[s];
        p.onset[o] = ons[s];
        p.last[o] = lst[s];
        p.runs[o] = rns[s];
        p.streak[o] = stk[s];
        p.sume[o] = se[s];
        p.sumpfx[o] = sp[s];
      }
    }
  }
}

// Stages per frontier-reduction round of the wide variant (one lane of
// the reducing warp per stage).
constexpr int kChunk = 32;

// The tick for any S (used past 16 stages).  The arithmetic of
// `fused_tick_kernel`, with the stage prefixes in the blocked order of
// `StagePrefix`; per-stage state lives in the outputs and in running
// prefixes instead of register arrays.
template <bool REG, bool HOSTS>
__global__ void __launch_bounds__(kThreads)
    fused_tick_wide_kernel(const Params p) {
  const int j = blockIdx.x;
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
  const float* thr = (REG || HOSTS) ? p.thr + ((long long)j * R + rr) * S : nullptr;
  int host = -1;
  if (HOSTS && valid) {
    host = p.host[(long long)j * R + r];
    if (host < 0 || host >= p.H) host = -1;  // out of range: no host row
  }
  // accumulators: this rank's cells of the [J, S, R] outputs
  const long long acc0 = (long long)j * S * R + r;
  if (valid) {
    for (int s = 0; s < S; ++s) {
      const long long o = acc0 + (long long)s * R;
      p.wif[o] = 0.f;
      if (REG) {
        p.count[o] = 0;
        p.onset[o] = kBig;
        p.last[o] = -1;
        p.runs[o] = 0;
        p.streak[o] = 0;
        p.sume[o] = 0.f;
        p.sumpfx[o] = 0.f;
      }
    }
  }

  int rounds = 0;  // frontier rounds so far: picks the shared buffer
  for (int n = 0; n < N; ++n) {
    const long long jn = (long long)j * N + n;
    const float* drow = p.d + (jn * R + rr) * S;
    const float* bdp = p.bd + j * p.bd_st[0] + n * p.bd_st[1] + rr * p.bd_st[2];
    const float* bwp = p.bw + j * p.bw_st[0] + n * p.bw_st[1] + rr * p.bw_st[2];
    const float* wmin = p.wmin + jn * S;
    const float* stat_amax = p.amax + jn * S;
    const float* stat_sec = p.sec + jn * S;
    const int* stat_lead = p.lead + jn * S;
    const float* stat_relp = p.relp + jn * S;

    // the last stage prefix first: every stage's clip needs it
    float pd_final = 0.f;
    {
      StagePrefix pfx;
      for (int s = 0; s < S; ++s) pd_final = pfx.next(drow[s]);
    }

    // -- frontier family: kChunk stages per warp-shuffle round ------------
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

    // -- what-if family (+ regime / host activity), one governing segment
    // at a time: a segment runs to the first barrier at or after its
    // start, else to the last stage
    if (!valid) continue;
    StagePrefix pfx_w;  // prefix of w, taken through each segment's end
    float base = 0.f;   // prefix at the previous barrier
    bool has_base = false;
    for (int start = 0; start < S;) {
      int end = start;
      while (end < S - 1 && !p.sync[end]) ++end;
      float pw_end = 0.f;
      for (int s = start; s <= end; ++s)
        pw_end = pfx_w.next(p.sync[s] ? wmin[s] : drow[s]);
      const float seg = has_base ? pw_end - base : pw_end;
      for (int s = start; s <= end; ++s) {
        const float wv = p.sync[s] ? wmin[s] : drow[s];
        const float ew = fmaxf(0.f, wv - bwp[s * p.bw_st[3]]);
        const float arr = stat_relp[s] + seg;
        const float am = stat_amax[s];
        const float other = (r == stat_lead[s]) ? stat_sec[s] : am;
        const float new_a = fmaxf(other, arr - ew);
        const long long o = acc0 + (long long)s * R;
        p.wif[o] = p.wif[o] + fmaxf(0.f, am - new_a);
        if (REG || HOSTS) {
          const bool act = ew > thr[s];
          if (REG) {
            const int ai = act ? 1 : 0;
            const int stk = p.streak[o];
            const int prv = stk > 0 ? 1 : 0;  // the previous step was active
            p.count[o] += ai;
            if (act) {
              p.onset[o] = min(p.onset[o], n);
              p.last[o] = max(p.last[o], n);
            }
            p.runs[o] += ai * (1 - prv);
            p.streak[o] = act ? stk + 1 : 0;
            const float se = p.sume[o] + ew;
            p.sume[o] = se;
            p.sumpfx[o] = p.sumpfx[o] + se;
          }
          if (HOSTS && act && host >= 0)
            atomicAdd(&p.hostcnt[(jn * S + s) * p.H + host], 1);
        }
      }
      if (p.sync[end]) {
        base = pw_end;
        has_base = true;
      }
      start = end + 1;
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

template <int MS>
void launch_main(const Params& p, bool reg, bool hosts, cudaStream_t st) {
  const dim3 grid(p.J, p.T);
  if (reg && hosts)
    fused_tick_kernel<MS, true, true><<<grid, kThreads, 0, st>>>(p);
  else if (reg)
    fused_tick_kernel<MS, true, false><<<grid, kThreads, 0, st>>>(p);
  else if (hosts)
    fused_tick_kernel<MS, false, true><<<grid, kThreads, 0, st>>>(p);
  else
    fused_tick_kernel<MS, false, false><<<grid, kThreads, 0, st>>>(p);
}

void launch_wide(const Params& p, bool reg, bool hosts, cudaStream_t st) {
  const dim3 grid(p.J, p.T);
  if (reg && hosts)
    fused_tick_wide_kernel<true, true><<<grid, kThreads, 0, st>>>(p);
  else if (reg)
    fused_tick_wide_kernel<true, false><<<grid, kThreads, 0, st>>>(p);
  else if (hosts)
    fused_tick_wide_kernel<false, true><<<grid, kThreads, 0, st>>>(p);
  else
    fused_tick_wide_kernel<false, false><<<grid, kThreads, 0, st>>>(p);
}

}  // namespace

extern "C" {

// Pointer slots of `ptrs` (device addresses; 0 where a family is off).
enum {
  kD, kWmin, kBd, kBw, kAmax, kSec, kLead, kRelp, kThr, kHost, kSync,
  kPf, kPl, kPs, kPc, kF, kFl, kFs, kFc, kWif,
  kCount, kOnset, kLast, kRuns, kStreak, kSume, kSumpfx, kHostcnt,
  kNumPtrs
};
// Integer slots of `ints`.
enum {
  iJ, iN, iR, iS, iH, iT, iSyncMask, iReg, iHosts,
  iBd0, iBd1, iBd2, iBd3, iBw0, iBw1, iBw2, iBw3,
  kNumInts
};

int fused_tick_num_slots(int which) {
  return which == 0 ? static_cast<int>(kNumPtrs) : static_cast<int>(kNumInts);
}

// Launches the tick (and the tile fold when T > 1) on `stream`.  Returns
// cudaGetLastError() after the launches: 0 when both were accepted.
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
  p.sync_mask = static_cast<unsigned>(ints[iSyncMask]);
  for (int k = 0; k < 4; ++k) {
    p.bd_st[k] = ints[iBd0 + k];
    p.bw_st[k] = ints[iBw0 + k];
  }
  const bool reg = ints[iReg] != 0;
  const bool hosts = ints[iHosts] != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaGetLastError();  // clear any stale error from earlier work
  if (p.S <= 8)
    launch_main<8>(p, reg, hosts, st);
  else if (p.S <= 16)
    launch_main<16>(p, reg, hosts, st);
  else
    launch_wide(p, reg, hosts, st);
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
