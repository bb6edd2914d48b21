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
// bytes.  It reads d once (J*N*R*S*4 bytes; each thread reads its rank's
// row of S floats twice, the second time from L1) and writes four
// [J, N, S] rows.  The baseline arrives as a strided view ([J, S] medians
// broadcast with zero strides), never materialized at window size.
//
// Design.  The TPU folds rank tiles in grid order and keeps the earlier
// leader on ties.  On this card blocks run in no order: grid
// (J*N, ceil(R / 128)), 128 threads, one thread per rank of the tile in the
// natural [J, N, R, S] layout, unpadded.  Each thread walks its stages as
// a running prefix (`StagePrefix`); every 32 stages the block reduces the
// (max, leader, second, clipped) summaries over its ranks with warp
// shuffles and a merge across its 4 warps, an explicit index tie-break
// (equal values keep the lower rank), and writes a per-tile partial.  A
// second kernel merges the partials in tile order when R > 128.  No float
// atomics; max and the top-2 merge are exact in any order.
//
// Subnormals: built with -ftz=true, as the reference flushes.
#include <cuda_runtime.h>
#include <math.h>

#include "frontier_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // stages per reduction round

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

__global__ void __launch_bounds__(kThreads)
    frontier_window_kernel(const Params p) {
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

// Launches the kernel (and the tile fold when T > 1) on `stream`:
// partials pf..pc ([J*N, T, S]; the outputs when T == 1), outputs f..fc
// ([J*N, S]), the baseline's four element strides in `bd_st`.  Returns
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

  cudaGetLastError();  // clear any stale error from earlier work
  const dim3 grid(static_cast<unsigned>(p.JN), static_cast<unsigned>(T));
  frontier_window_kernel<<<grid, kThreads, 0, st>>>(p);
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
