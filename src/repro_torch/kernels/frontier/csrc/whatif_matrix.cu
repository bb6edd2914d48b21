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
// separate launches of the four-dispatch reference route, which exists to
// check the fused tick: it runs the fused tick's cell role
// (`cell_walk.cuh`) with the what-if family alone, so the two routes share
// the arithmetic they must agree on bit for bit.
//
// Bound.  A few operations per float loaded: bound by device-memory
// bytes.  It reads d once (J*N*R*S*4 bytes) and the [J, N, S] rows (the
// cross-rank minimum w takes on sync stages, and the boundary stats
// amax, second, leader, relprev), and writes [J, S, R].  The imputed work
// is never a second window: w is d except on sync stages, where it is
// the [J, N, S] row.  The baseline arrives as a strided view.
//
// Design.  The TPU folds steps on its sequential grid into a
// VMEM-resident accumulator, one grid row per (job, rank tile).  Here the
// only serial chain is the step sum of one cell, so the kernel is one
// thread per (job, rank, stage) cell, each walking the N steps in order
// with its sum in a register, one add per step and no multiply (nothing
// contracts to an FMA), and writing it once, at the end.  Up to 32
// stages a warp holds whole ranks and takes each rank's stage prefix as
// a chain of shuffles, once per (rank, step, stage), with no shared
// memory and no barrier; past 32 a segment pass writes each (step, rank)
// row's segment sums to the caller's scratch, and the walk reads them
// (see `cell_walk.cuh`), at any S.  The sync set arrives as one byte per
// stage, so a barrier past bit 31 needs no mask.
//
// Subnormals: built with -ftz=true, as the reference flushes.
#include <cuda_runtime.h>
#include <math.h>

#include "cell_walk.cuh"

extern "C" {

// Floats of the scratch buffer `seg` a J x N x R x S window needs: 0 up
// to 32 stages.
long long whatif_matrix_scratch_floats(int J, int N, int R, int S) {
  return cell_scratch_floats(J, N, R, S);
}

// Launches the kernel on `stream`; `wmin` is read at [J, N, S] offsets
// even when no stage is a sync stage (pass the window itself then);
// `seg` holds whatif_matrix_scratch_floats floats.  Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
int whatif_matrix_launch(const void* d, const void* wmin, const void* bw,
                         const void* amax, const void* sec, const void* lead,
                         const void* relp, const void* sync, void* seg,
                         void* wif, const long long* bw_st, int J, int N,
                         int R, int S, void* stream) {
  CellParams p = {};
  p.d = static_cast<const float*>(d);
  p.wmin = static_cast<const float*>(wmin);
  p.bw = static_cast<const float*>(bw);
  p.amax = static_cast<const float*>(amax);
  p.sec = static_cast<const float*>(sec);
  p.lead = static_cast<const int*>(lead);
  p.relp = static_cast<const float*>(relp);
  p.sync = static_cast<const unsigned char*>(sync);
  p.seg = static_cast<float*>(seg);
  p.wif = static_cast<float*>(wif);
  for (int k = 0; k < 4; ++k) p.bw_st[k] = bw_st[k];
  p.N = N;
  p.R = R;
  p.S = S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaGetLastError();  // clear any stale error from earlier work
  const cudaError_t err = launch_cell_walk<true, false, false>(p, J, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* whatif_matrix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
