// The what-if family alone: per (job, stage, rank) of a stacked window
// tensor d[J, N, R, S], the recoverable seconds of clipping that one cell
// to its baseline,
//
//   W[j, s, r] = sum over steps t, in step order, of
//                max(0, amax - max(other, arr - excess)),
//
// where arr is rank r's replayed arrival at the governing barrier of
// stage s (the first declared sync stage at or after s, else the last
// stage): relprev + P[end] - P[start - 1], P the stage prefix of the
// sync-imputed work w; excess = max(0, w - bw); other = second on the
// boundary leader's lane and amax elsewhere.
//
// Replaces the Pallas TPU kernel `_whatif_kernel`
// (src/repro/kernels/frontier/frontier.py, reached through
// `whatif_matrix_kernel` from `fleet_whatif_matrix`).  One of the three
// separate launches of the four-dispatch reference route; it shares no
// kernel code with `fused_tick.cu`, only the prefix order of
// `frontier_common.cuh`.
//
// Bound.  A few operations per float loaded: bound by device-memory
// bytes.  It reads d once (J*N*R*S*4 bytes) and the [J, N, S] rows (the
// cross-rank minimum w takes on sync stages, and the boundary stats
// amax, second, leader, relprev), and writes [J, S, R].  The imputed work
// is never a second window: w is d except on sync stages, where it is
// the [J, N, S] row.  The baseline arrives as a strided view.
//
// Design.  The TPU folds steps on its sequential grid into a VMEM-resident
// accumulator.  Here grid (J, ceil(R / 128)), 128 threads, one thread per
// (job, rank) in the natural layout, unpadded; each thread walks the N
// steps in order and keeps its S sums in its own cells of the [J, S, R]
// output (coalesced over the warp's ranks), so any S works and every sum
// is one add per step in step order, with no multiply (nothing contracts
// to an FMA).  Per step it walks the sync segments: the segment's prefix
// first, then each stage's contribution.  The sync set arrives as one
// byte per stage, so a barrier past bit 31 needs no mask.  The arrival is
// rebuilt with the same adds as the caller's prolog
// (`ops.whatif_stats`), so the leader's own arrival equals amax bit for
// bit and its zero-excess cell gains nothing.
//
// Subnormals: built with -ftz=true, as the reference flushes.
#include <cuda_runtime.h>
#include <math.h>

#include "frontier_common.cuh"

namespace {

constexpr int kThreads = 128;

struct Params {
  const float* d;     // [J, N, R, S] contiguous
  const float* wmin;  // [J, N, S] cross-rank minimum (read on sync stages)
  const float* bw;    // what-if baseline, strided view of [J, N, R, S]
  const float* amax;  // [J, N, S] governing-boundary release
  const float* sec;   // [J, N, S] governing-boundary second arrival
  const int* lead;    // [J, N, S] governing-boundary leader
  const float* relp;  // [J, N, S] previous segment's release
  const unsigned char* sync;  // [S], 1 on sync stages
  float* wif;         // [J, S, R]
  long long bw_st[4];
  int N, R, S;
};

__global__ void __launch_bounds__(kThreads)
    whatif_matrix_kernel(const Params p) {
  const int j = blockIdx.x;
  const int r = blockIdx.y * kThreads + threadIdx.x;
  if (r >= p.R) return;
  const int S = p.S;
  const int N = p.N;
  const long long acc0 = (long long)j * S * p.R + r;  // this rank's cells
  for (int s = 0; s < S; ++s) p.wif[acc0 + (long long)s * p.R] = 0.f;

  for (int n = 0; n < N; ++n) {
    const long long jn = (long long)j * N + n;
    const float* drow = p.d + (jn * p.R + r) * S;
    const float* bwp = p.bw + j * p.bw_st[0] + n * p.bw_st[1] + r * p.bw_st[2];
    const float* wmin = p.wmin + jn * S;
    const float* stat_amax = p.amax + jn * S;
    const float* stat_sec = p.sec + jn * S;
    const int* stat_lead = p.lead + jn * S;
    const float* stat_relp = p.relp + jn * S;

    StagePrefix pfx;    // prefix of w, taken through each segment's end
    float base = 0.f;   // prefix at the previous barrier
    bool has_base = false;
    for (int start = 0; start < S;) {
      int end = start;
      while (end < S - 1 && !p.sync[end]) ++end;
      float pw_end = 0.f;
      for (int s = start; s <= end; ++s)
        pw_end = pfx.next(p.sync[s] ? wmin[s] : drow[s]);
      const float seg = has_base ? pw_end - base : pw_end;
      for (int s = start; s <= end; ++s) {
        const float wv = p.sync[s] ? wmin[s] : drow[s];
        const float ew = fmaxf(0.f, wv - bwp[s * p.bw_st[3]]);
        const float arr = stat_relp[s] + seg;
        const float am = stat_amax[s];
        const float other = (r == stat_lead[s]) ? stat_sec[s] : am;
        const float new_a = fmaxf(other, arr - ew);
        const long long o = acc0 + (long long)s * p.R;
        p.wif[o] = p.wif[o] + fmaxf(0.f, am - new_a);
      }
      if (p.sync[end]) {
        base = pw_end;
        has_base = true;
      }
      start = end + 1;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; `wmin` may be any valid address when
// no stage is a sync stage.  Returns cudaGetLastError() after the launch:
// 0 when it was accepted.
int whatif_matrix_launch(const void* d, const void* wmin, const void* bw,
                         const void* amax, const void* sec, const void* lead,
                         const void* relp, const void* sync, void* wif,
                         const long long* bw_st, int J, int N, int R, int S,
                         void* stream) {
  Params p;
  p.d = static_cast<const float*>(d);
  p.wmin = static_cast<const float*>(wmin);
  p.bw = static_cast<const float*>(bw);
  p.amax = static_cast<const float*>(amax);
  p.sec = static_cast<const float*>(sec);
  p.lead = static_cast<const int*>(lead);
  p.relp = static_cast<const float*>(relp);
  p.sync = static_cast<const unsigned char*>(sync);
  p.wif = static_cast<float*>(wif);
  for (int k = 0; k < 4; ++k) p.bw_st[k] = bw_st[k];
  p.N = N;
  p.R = R;
  p.S = S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaGetLastError();  // clear any stale error from earlier work
  const dim3 grid(static_cast<unsigned>(J),
                  static_cast<unsigned>((R + kThreads - 1) / kThreads));
  whatif_matrix_kernel<<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* whatif_matrix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
