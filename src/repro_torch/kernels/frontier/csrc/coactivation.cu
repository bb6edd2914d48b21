// Cross-job co-activation by host column: the incident tier's
// common-cause statistics of a fleet activity tensor act[J, N, C, S]
// (job j has an above-threshold candidate on column c in stage s at step
// t; the columns are hosts, then the switch and pod nodes the caller
// OR-collapsed onto the same axis).  Per (stage, column):
//
//   jobs    distinct jobs active at any step;
//   coact   steps at which >= 2 jobs are active at once;
//   active  active job-steps.
//
// Replaces the Pallas TPU kernel `_coactivation_kernel`
// (src/repro/kernels/frontier/incidents.py, reached through
// `_coactivation_dispatch` from `co_activation`, `tiered_co_activation`
// and `co_activation_loop`), together with its epilog: the [N, S, C]
// per-step cross-job sums never reach device memory, and the three [S, C]
// int32 counts come out directly.
//
// Bound.  One byte read per element and a few integer adds: bound by
// device-memory bytes (J*N*C*S read once, 3*S*C*4 written).
//
// Design.  The TPU grid sweeps the jobs in order and folds them into
// accumulators that stay in VMEM; on this card blocks run in no order, so
// the fold is split instead.  Everything is integer, so any order gives
// the same counts.  The input stays in its natural contiguous layout,
// read as bytes (one byte per torch.bool), unpadded: the (stage, column)
// pairs of one (job, step) are one contiguous run, one per thread, so a
// warp's loads are 32 neighbouring bytes.
//
//   coact_steps_kernel  grid (ceil(C*S / 128), ceil(N / kSteps)): each
//                       thread owns one (column, stage) and kSteps steps,
//                       walks all jobs, keeps the per-step cross-job sums
//                       in registers, and adds its coact / active counts
//                       to the outputs with integer atomics.  Per job it
//                       marks `seen[j, column, stage]` when the job was
//                       active at any of its steps.
//   coact_jobs_kernel   one thread per (column, stage): jobs = the count
//                       of marked jobs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 8;  // steps per thread of coact_steps_kernel

struct Params {
  const uint8_t* act;  // [J, N, C, S] 0/1 bytes, contiguous
  uint8_t* seen;       // [J, C, S] zeroed by the caller
  int* jobs;           // [S, C]
  int* coact;          // [S, C] zeroed by the caller
  int* active;         // [S, C] zeroed by the caller
  int J, N, C, S;
};

__global__ void __launch_bounds__(kThreads) coact_steps_kernel(const Params p) {
  const long long cols = (long long)p.C * p.S;
  const long long cs = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (cs >= cols) return;
  const int n0 = blockIdx.y * kSteps;
  const int steps = min(kSteps, p.N - n0);

  int sum[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) sum[k] = 0;
  for (int j = 0; j < p.J; ++j) {
    const uint8_t* a = p.act + ((long long)j * p.N + n0) * cols + cs;
    int any = 0;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      if (k < steps) {
        const int v = a[k * cols] != 0;
        sum[k] += v;
        any |= v;
      }
    }
    // every writer stores the same 1: the order of the stores is moot
    if (any) p.seen[(long long)j * cols + cs] = 1;
  }
  int co = 0, ac = 0;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    co += sum[k] >= 2;
    ac += sum[k];
  }
  const int c = static_cast<int>(cs / p.S);
  const int s = static_cast<int>(cs - (long long)c * p.S);
  const long long o = (long long)s * p.C + c;
  if (co) atomicAdd(&p.coact[o], co);
  if (ac) atomicAdd(&p.active[o], ac);
}

__global__ void coact_jobs_kernel(const Params p) {
  const long long cols = (long long)p.C * p.S;
  const long long cs = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cs >= cols) return;
  int count = 0;
  for (int j = 0; j < p.J; ++j) count += p.seen[(long long)j * cols + cs];
  const int c = static_cast<int>(cs / p.S);
  const int s = static_cast<int>(cs - (long long)c * p.S);
  p.jobs[(long long)s * p.C + c] = count;
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`.  Returns cudaGetLastError() after
// the launches: 0 when both were accepted.
int coact_launch(const void* act, void* seen, void* jobs, void* coact,
                 void* active, int J, int N, int C, int S, void* stream) {
  Params p;
  p.act = static_cast<const uint8_t*>(act);
  p.seen = static_cast<uint8_t*>(seen);
  p.jobs = static_cast<int*>(jobs);
  p.coact = static_cast<int*>(coact);
  p.active = static_cast<int*>(active);
  p.J = J;
  p.N = N;
  p.C = C;
  p.S = S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long cols = (long long)C * S;

  cudaGetLastError();  // clear any stale error from earlier work
  const dim3 grid(static_cast<unsigned>((cols + kThreads - 1) / kThreads),
                  static_cast<unsigned>((N + kSteps - 1) / kSteps));
  coact_steps_kernel<<<grid, kThreads, 0, st>>>(p);
  const int threads = 256;
  coact_jobs_kernel<<<static_cast<unsigned>((cols + threads - 1) / threads),
                      threads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* coact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
