// The regime family alone: per (job, stage, rank) of a stacked window
// tensor d[J, N, R, S], a step fold of the activity e > thr, where
// e = max(0, w - bw) is the exposed increment of the sync-imputed work w:
//
//   count   active steps;            onset   first active step (BIG = never);
//   last    last active step (-1);   runs    distinct bursts;
//   streak  trailing active steps;   sum_e   sum of e;
//   sum_pfx sum over steps of the running sum of e.
//
// Replaces the Pallas TPU kernel `_regime_kernel`
// (src/repro/kernels/frontier/frontier.py, reached through
// `regime_stats_kernel` from `fleet_regime_stats`).  One of the three
// separate launches of the four-dispatch reference route, which exists to
// check the fused tick: it runs the fused tick's cell role
// (`cell_walk.cuh`) with the regime family alone, so both routes take
// their regime statistics from the one fold, `CellState::add`.
//
// Bound.  A handful of operations per float loaded: bound by
// device-memory bytes.  It reads d once (J*N*R*S*4 bytes), the threshold
// [J, R, S] once and the [J, N, S] minimum rows on sync stages, and
// writes seven [J, S, R] statistics.
//
// Design.  The statistics of one (stage, rank) cell depend on that cell's
// own series only, and without the what-if family no stage prefix is
// needed: the cell walk's flat walk, one thread per (rank, stage) cell of
// one job, lanes over the flat index, so every lane is busy at any S and
// a warp's loads of one step are 32 contiguous floats.  A step is one
// load, the imputed work (the baseline is constant over the steps with
// regimes, and read once); the loads go in batches of 12 steps issued up
// front, the next batch's in flight while this one folds in step order.
// Each statistic is written once, at the end.
//
// Subnormals: built with -ftz=true, so the running sums flush at FLT_MIN
// as the reference's fused route does (the reference's own four-dispatch
// regime route does not; this route follows the fused one).
#include <cuda_runtime.h>

#include "cell_walk.cuh"

extern "C" {

// Launches the kernel on `stream`: outputs count, onset, last, runs,
// streak (int32), sum_e, sum_pfx (float32), each [J, S, R]; `wmin` may be
// any valid address when no stage is a sync stage.  Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
int regime_stats_launch(const void* d, const void* wmin, const void* bw,
                        const void* thr, const void* sync, void* count,
                        void* onset, void* last, void* runs, void* streak,
                        void* sume, void* sumpfx, const long long* bw_st,
                        int J, int N, int R, int S, void* stream) {
  CellParams p = {};
  p.d = static_cast<const float*>(d);
  p.wmin = static_cast<const float*>(wmin);
  p.bw = static_cast<const float*>(bw);
  p.thr = static_cast<const float*>(thr);
  p.sync = static_cast<const unsigned char*>(sync);
  p.count = static_cast<int*>(count);
  p.onset = static_cast<int*>(onset);
  p.last = static_cast<int*>(last);
  p.runs = static_cast<int*>(runs);
  p.streak = static_cast<int*>(streak);
  p.sume = static_cast<float*>(sume);
  p.sumpfx = static_cast<float*>(sumpfx);
  for (int k = 0; k < 4; ++k) p.bw_st[k] = bw_st[k];
  p.N = N;
  p.R = R;
  p.S = S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaGetLastError();  // clear any stale error from earlier work
  const cudaError_t err = launch_cell_walk<false, true, false>(p, J, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* regime_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
