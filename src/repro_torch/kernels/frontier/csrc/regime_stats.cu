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
// separate launches of the four-dispatch reference route; it shares no
// kernel code with `fused_tick.cu`.
//
// Bound.  A handful of operations per float loaded: bound by
// device-memory bytes.  It reads d once (J*N*R*S*4 bytes), the threshold
// [J, R, S] once and the [J, N, S] minimum rows on sync stages, and
// writes seven [J, S, R] statistics.
//
// Design.  The statistics of one (stage, rank) cell depend on that cell's
// own series only, so the cells are independent: grid
// (ceil(R*S / 128), J), one thread per (rank, stage) cell of one job.
// Neighbouring threads own neighbouring cells of the natural [R, S] step
// slab, so a warp's loads of one step are 32 contiguous floats.  Each
// thread walks the N steps in order with its whole state in registers;
// the float sums take adds only, one per step in step order (nothing
// contracts to an FMA), as the reference's `fori_loop` carry does.  It
// writes each statistic once, at the end.
//
// Subnormals: built with -ftz=true, so the running sums flush at FLT_MIN
// as the reference's fused route does (the reference's own four-dispatch
// regime route does not; this route follows the fused one).
#include <cuda_runtime.h>
#include <math.h>

#include "frontier_common.cuh"

namespace {

constexpr int kThreads = 128;

struct Params {
  const float* d;     // [J, N, R, S] contiguous
  const float* wmin;  // [J, N, S] cross-rank minimum (read on sync stages)
  const float* bw;    // regime baseline, strided view of [J, N, R, S]
  const float* thr;   // [J, R, S] activity threshold
  const unsigned char* sync;  // [S], 1 on sync stages
  int* count;         // [J, S, R] each
  int* onset;
  int* last;
  int* runs;
  int* streak;
  float* sume;
  float* sumpfx;
  long long bw_st[4];
  int N, R, S;
};

__global__ void __launch_bounds__(kThreads)
    regime_stats_kernel(const Params p) {
  const int j = blockIdx.y;
  const long long cells = (long long)p.R * p.S;
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= cells) return;
  const int S = p.S;
  const int N = p.N;
  const int r = static_cast<int>(c / S);
  const int s = static_cast<int>(c - (long long)r * S);
  const bool sync = p.sync[s] != 0;
  const float thr = p.thr[(long long)j * cells + c];
  const float* bwp = p.bw + j * p.bw_st[0] + r * p.bw_st[2] + s * p.bw_st[3];

  int count = 0, onset = kBig, last = -1, runs = 0, streak = 0, prev = 0;
  float sume = 0.f, sumpfx = 0.f;
  for (int n = 0; n < N; ++n) {
    const long long jn = (long long)j * N + n;
    const float wv = sync ? p.wmin[jn * S + s] : p.d[jn * cells + c];
    const float e = fmaxf(0.f, wv - bwp[n * p.bw_st[1]]);
    const int act = e > thr ? 1 : 0;
    count += act;
    onset = act ? min(onset, n) : onset;
    last = act ? n : last;
    runs += act * (1 - prev);
    streak = act ? streak + 1 : 0;
    prev = act;
    sume = sume + e;
    sumpfx = sumpfx + sume;
  }
  const long long o = ((long long)j * S + s) * p.R + r;
  p.count[o] = count;
  p.onset[o] = onset;
  p.last[o] = last;
  p.runs[o] = runs;
  p.streak[o] = streak;
  p.sume[o] = sume;
  p.sumpfx[o] = sumpfx;
}

}  // namespace

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
  Params p;
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
  const long long cells = (long long)R * S;
  const dim3 grid(static_cast<unsigned>((cells + kThreads - 1) / kThreads),
                  static_cast<unsigned>(J));
  regime_stats_kernel<<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* regime_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
