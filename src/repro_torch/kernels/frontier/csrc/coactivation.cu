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
// Bound.  One byte read per element and a few integer operations: bound
// by device-memory bytes (J*N*C*S read once, 3*S*C*4 written).
//
// Design.  One launch, no scratch in device memory, no output zeroed
// first: each output entry is written once.  The input stays in its
// natural contiguous layout; its (column, stage) pairs ("columns" below)
// of one (job, step) are one contiguous run.  Every operation is an
// integer OR or add, so any order of warps, blocks or atomics gives the
// same counts.
//
//   Tiles.  A thread block cluster of CL blocks owns a tile of 32 words
//   of that run, one word a lane: 4 columns a word (a warp's request of
//   one (job, step) is one 128-byte line) when C*S is a multiple of 4 and
//   at least 1,024, else one column a word.  CL = min(8, J), the portable
//   most, or min(16, J) where the tiles alone would leave SMs idle (fewer
//   than SMs / 8 of them) and the card can schedule 16-block clusters (an
//   H100 can: its non-portable most).
//   Jobs across blocks.  Block b of the cluster takes jobs [b*Jb,
//   (b+1)*Jb), Jb = ceil(J / CL).
//   Steps across warps.  Warp w of a block takes a contiguous share of
//   the steps and walks it for every job of the block, in batches of
//   kJobs jobs x kSteps steps whose loads all issue before any use, the
//   next batch's loads in flight while this one folds.  Whether >= 1 and
//   >= 2 jobs are active at (step, column) is two bits of a byte of the
//   block's [steps, 32] word array in shared memory; a step belongs to one
//   warp, so the warp updates it with a plain read-modify-write (two |=
//   one & x, one |= x, bytewise on 0/1 bytes): no atomics per step.
//   "Job j was active on this column" (any) is a register OR over the
//   warp's steps, ORed once per job into the block's [Jb, 32] word array
//   (one shared atomic); `active` is a register count.
//   Cluster.  The blocks' step arrays meet in distributed shared memory:
//   block b folds the CL arrays at its share of the steps (the same
//   two-bit rule) and counts `coact`; the blocks' jobs are disjoint, so
//   each counts `jobs` from its own job array; the leader block adds the
//   CL blocks' per-column counts and writes the tile's three outputs.
//   Long windows, many jobs.  A block's registers leave room for one a
//   SM, so the job and step arrays share its shared memory, about 1,800
//   rows of 32 words on an H100.  Where the block's jobs and at least
//   half of it (or the whole window) fit, the jobs' rows stay whole and a
//   longer window goes in step chunks of equal size, each folded and
//   merged in turn.  Else, where the window fits in half, the block folds
//   its jobs in chunks of the job array: each chunk's `jobs` goes into
//   a register tally and the array is cleared, while the step bits stay
//   across chunks.  Else (many jobs and a long window) act is read twice:
//   once for `jobs` and `active` with job chunks outside, once for
//   `coact` with step chunks outside, the two arrays in the same memory
//   by turns.  So every J and N launches.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMinBlocks = 1;      // resident blocks an SM is built for
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;        // blocks of a cluster: the portable most
constexpr int kWideCluster = 16;   // ... and H100's most, for few tiles
constexpr int kJobs = 4;           // jobs of a load batch
constexpr int kSteps = 8;          // steps of a load batch
constexpr int kVecColumns = 1024;  // C*S from which 4 columns go to a lane
constexpr uint32_t kOnes = 0x01010101u;

struct Params {
  const uint8_t* __restrict__ act;  // [J, N, C, S] 0/1 bytes, contiguous
  int* __restrict__ jobs;           // [S, C]
  int* __restrict__ coact;          // [S, C]
  int* __restrict__ active;         // [S, C]
  int J, N, C, S;
  int CL;      // blocks per cluster
  int Jb;      // jobs per block: block b takes jobs [b * Jb, (b + 1) * Jb)
  int Jc;      // jobs per chunk of the job array
  int chunk;   // steps per chunk of the step array
};

template <int V>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ a,
                                              long long off) {
  if (V == 4) return __ldg(reinterpret_cast<const unsigned int*>(a + off));
  return __ldg(a + off);
}

// Adds the V bytes of a word of 0/1 (or small) byte counts to `acc`.
template <int V>
__device__ __forceinline__ void add_bytes(int (&acc)[V], uint32_t w) {
#pragma unroll
  for (int b = 0; b < V; ++b) acc[b] += (w >> (8 * b)) & 0xffu;
}

// The kernel's three shapes of walk, chosen by the launcher from what fits
// in shared memory.
enum Mode {
  kOnePass = 0,    // the block's job array whole, the window in step chunks
  kJobChunks = 1,  // the window in one step chunk, the jobs in chunks
  kTwoPasses = 2,  // both too long: act read twice (jobs/active, then coact)
};

// One pass of a block over its jobs and the window: chunks of `jc` jobs
// (q_count of them, the same count in every block of the cluster) outer,
// step chunks of p.chunk inner.  ANY: "job active on the column" into the
// job array, counted into jobs_l once a job chunk is done, and active_l.
// STATE: the step array's two bits, merged across the cluster into
// coact_l.  With both, one of the two loops has a single trip, so a step
// chunk's bits have seen every job of the block before they are merged.
template <int V, bool ANY, bool STATE>
__device__ __forceinline__ void coact_pass(const Params& p, uint32_t* anyw,
                                           uint32_t* state, int jc,
                                           int q_count, int (&jobs_l)[V],
                                           int (&active_l)[V],
                                           int (&coact_l)[V]) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = p.CL;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / CL;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = p.N;
  const long long CS = (long long)p.C * p.S;
  const long long words = CS / V;
  const long long w = (long long)tile * 32 + lane;  // this lane's word
  const bool valid = w < words;
  const long long col = (valid ? w : words - 1) * V;  // in bounds when idle
  const int nj_block = max(0, min(p.J, (rank + 1) * p.Jb) - rank * p.Jb);
  const int chunks = (N + p.chunk - 1) / p.chunk;

  for (int qc = 0; qc < q_count; ++qc) {
    const int j_lo = rank * p.Jb + qc * jc;  // this job chunk's jobs
    const int nj = max(0, min(nj_block - qc * jc, jc));
    if (ANY)
      for (int i = tid; i < nj * 32; i += kThreads) anyw[i] = 0;
    for (int c = 0; c < chunks; ++c) {
      const int lo = c * p.chunk;
      const int hi = min(N, lo + p.chunk);
      if (STATE && qc == 0)
        for (int i = tid; i < (hi - lo) * 32; i += kThreads) state[i] = 0;
      __syncthreads();
      // this warp's steps [s_lo, s_hi) of the chunk, for every job of the
      // chunk: items (job group g, step batch b), the next one's loads in
      // flight while this one folds
      const int per = (hi - lo + kWarps - 1) / kWarps;
      const int s_lo = lo + warp * per;
      const int s_hi = min(hi, s_lo + per);
      const int nb = (s_hi - s_lo + kSteps - 1) / kSteps;
      const int items = s_lo < s_hi ? nb * ((nj + kJobs - 1) / kJobs) : 0;
      auto load = [&](int i, uint32_t (&x)[kJobs][kSteps]) {
        const int g = i / nb;
        const int n0 = s_lo + (i - g * nb) * kSteps;
#pragma unroll
        for (int q = 0; q < kJobs; ++q) {
          const int jl = g * kJobs + q;
          if (jl < nj) {  // warp-uniform; the batch's loads are unconditional
            const uint8_t* a = p.act + (long long)(j_lo + jl) * N * CS + col;
#pragma unroll
            for (int t = 0; t < kSteps; ++t)
              x[q][t] = load_word<V>(a, min(n0 + t, s_hi - 1) * CS);
          } else {
#pragma unroll
            for (int t = 0; t < kSteps; ++t) x[q][t] = 0;
          }
        }
      };
      uint32_t x[kJobs][kSteps];
      uint32_t any[kJobs] = {};
      if (items) load(0, x);
      for (int i = 0; i < items; ++i) {
        uint32_t xn[kJobs][kSteps];
        if (i + 1 < items) load(i + 1, xn);
        const int g = i / nb;
        const int b = i - g * nb;
        const int n0 = s_lo + b * kSteps;
        uint32_t sum = 0;
#pragma unroll
        for (int t = 0; t < kSteps; ++t) {
          const int n = n0 + t;
          if (valid && n < s_hi) {  // (step n, this word) is this lane's alone
            uint32_t one = 0, two = 0;
            uint32_t* sp = &state[(n - lo) * 32 + lane];
            if (STATE) {
              const uint32_t st = *sp;
              one = st & kOnes;
              two = (st >> 1) & kOnes;
            }
#pragma unroll
            for (int q = 0; q < kJobs; ++q) {
              const uint32_t xv = x[q][t];
              two |= one & xv;
              one |= xv;
              any[q] |= xv;
              sum += xv;  // each byte <= kJobs * kSteps: no carry
            }
            if (STATE) *sp = one | (two << 1);
          }
        }
        if (ANY) {
          add_bytes<V>(active_l, sum);
          if (b == nb - 1) {  // the group's last batch: its jobs' any
#pragma unroll
            for (int q = 0; q < kJobs; ++q) {
              const int jl = g * kJobs + q;
              if (jl < nj && any[q]) atomicOr(&anyw[jl * 32 + lane], any[q]);
              any[q] = 0;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kJobs; ++q) {
#pragma unroll
          for (int t = 0; t < kSteps; ++t) x[q][t] = xn[q][t];
        }
      }
      __syncthreads();
      if (STATE && qc == q_count - 1) {
        cluster.sync();  // every block's step array is whole
        // this block's share of the steps: fold the CL arrays, count >= 2
        for (int n = lo + rank * kWarps + warp; n < hi; n += CL * kWarps) {
          // the CL words load together, then fold (absent blocks read as 0)
          uint32_t one = 0, two = 0, st[kWideCluster];
#pragma unroll
          for (int r = 0; r < kWideCluster; ++r)
            st[r] = r < CL ? *cluster.map_shared_rank(&state[(n - lo) * 32 + lane], r) : 0u;
#pragma unroll
          for (int r = 0; r < kWideCluster; ++r) {
            const uint32_t o = st[r] & kOnes;
            two |= ((st[r] >> 1) & kOnes) | (one & o);
            one |= o;
          }
          add_bytes<V>(coact_l, two);
        }
        cluster.sync();  // no block rewrites its array while another reads it
      }
    }
    if (ANY) {
      // the blocks' jobs are disjoint: each block counts its own, a job
      // chunk at a time, before the next chunk clears the array
      for (int jl = warp; jl < nj; jl += kWarps) add_bytes<V>(jobs_l, anyw[jl * 32 + lane]);
      __syncthreads();
    }
  }
}

template <int V, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks) coact_kernel(const Params p) {
  extern __shared__ uint32_t smem[];
  // [Jc][32] job array: job active on the column; [chunk][32] step array:
  // bit 0 >= 1, bit 1 >= 2 jobs.  Two passes use one at a time: they share.
  uint32_t* anyw = smem;
  uint32_t* state = smem + (MODE == kTwoPasses ? 0 : p.Jc * 32);
  __shared__ int cnt[3][32 * V];  // jobs, active, coact per column
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / p.CL;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long CS = (long long)p.C * p.S;

  for (int i = tid; i < 3 * 32 * V; i += kThreads) (&cnt[0][0])[i] = 0;
  int jobs_l[V], active_l[V], coact_l[V];
#pragma unroll
  for (int b = 0; b < V; ++b) jobs_l[b] = active_l[b] = coact_l[b] = 0;

  const int q_count = (p.Jb + p.Jc - 1) / p.Jc;
  if (MODE == kOnePass) {
    coact_pass<V, true, true>(p, anyw, state, p.Jb, 1, jobs_l, active_l, coact_l);
  } else if (MODE == kJobChunks) {
    coact_pass<V, true, true>(p, anyw, state, p.Jc, q_count, jobs_l, active_l, coact_l);
  } else {
    coact_pass<V, true, false>(p, anyw, state, p.Jc, q_count, jobs_l, active_l, coact_l);
    coact_pass<V, false, true>(p, anyw, state, p.Jb, 1, jobs_l, active_l, coact_l);
  }

#pragma unroll
  for (int b = 0; b < V; ++b) {
    const int k = lane * V + b;
    if (jobs_l[b]) atomicAdd(&cnt[0][k], jobs_l[b]);
    if (active_l[b]) atomicAdd(&cnt[1][k], active_l[b]);
    if (coact_l[b]) atomicAdd(&cnt[2][k], coact_l[b]);
  }
  __syncthreads();
  cluster.sync();
  if (rank == 0 && tid < 32 * V) {
    const long long cs = (long long)tile * 32 * V + tid;
    if (cs < CS) {
      int sums[3] = {0, 0, 0};
      for (int r = 0; r < p.CL; ++r) {
#pragma unroll
        for (int k = 0; k < 3; ++k) sums[k] += *cluster.map_shared_rank(&cnt[k][tid], r);
      }
      const int c = static_cast<int>(cs / p.S);
      const int s = static_cast<int>(cs - (long long)c * p.S);
      const long long o = (long long)s * p.C + c;
      p.jobs[o] = sums[0];
      p.active[o] = sums[1];
      p.coact[o] = sums[2];
    }
  }
  cluster.sync();  // the leader has read every block's counts
}

// Sizes the arrays for clusters of p.CL: jobs per block (Jb), per job
// chunk (Jc) and steps per step chunk (chunk), chunks of equal size; the
// mode; the shared bytes.  A block per SM (its registers allow no more),
// so the two arrays share the shared memory the statics leave, `room`
// rows of 32 words.  The job array whole with a step chunk of at least
// half the room (or the whole window) is one pass; else, a window of at
// most half the room in one step chunk leaves the other half or more to
// job chunks; else the two passes have all of it in turn.
template <int V>
int size_for(Params& p, int optin, size_t& smem) {
  p.Jb = (p.J + p.CL - 1) / p.CL;
  const long long row = 32 * sizeof(uint32_t);
  const long long room = optin / row - 3 * V;
  const long long half = room / 2;
  auto even = [](long long total, long long most) {  // equal chunks of <= most
    const long long k = (total + most - 1) / most;
    return static_cast<int>((total + k - 1) / k);
  };
  int mode;
  if (p.Jb + (p.N < half ? p.N : half) <= room) {
    mode = kOnePass;
    p.Jc = p.Jb;
    p.chunk = even(p.N, room - p.Jb);
    smem = static_cast<size_t>(row * (p.Jc + p.chunk));
  } else if (p.N <= half) {
    mode = kJobChunks;
    p.chunk = p.N;
    p.Jc = even(p.Jb, room - p.N);
    smem = static_cast<size_t>(row * (p.Jc + p.chunk));
  } else {
    mode = kTwoPasses;
    p.chunk = even(p.N, room);
    p.Jc = even(p.Jb, room);
    smem = static_cast<size_t>(row * max(p.Jc, p.chunk));
  }
  return mode;
}

template <int V, int MODE>
cudaError_t launch_mode(const Params& p, cudaLaunchConfig_t& cfg, bool wide,
                        bool probe, int& most) {
  auto kernel = coact_kernel<V, MODE>;
  cudaError_t err = cudaSuccess;
  if (wide)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && cfg.dynamicSmemBytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cfg.dynamicSmemBytes));
  if (err != cudaSuccess) return err;
  if (probe) return cudaOccupancyMaxPotentialClusterSize(&most, kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// The mode's kernel: with `probe`, the largest cluster the card can
// schedule for it into `most`, else the launch.
template <int V>
cudaError_t dispatch(const Params& p, int mode, cudaLaunchConfig_t& cfg,
                     bool wide, bool probe, int& most) {
  switch (mode) {
    case kOnePass:
      return launch_mode<V, kOnePass>(p, cfg, wide, probe, most);
    case kJobChunks:
      return launch_mode<V, kJobChunks>(p, cfg, wide, probe, most);
    default:
      return launch_mode<V, kTwoPasses>(p, cfg, wide, probe, most);
  }
}

template <int V>
cudaError_t launch(Params p, cudaStream_t st) {
  const long long CS = (long long)p.C * p.S;
  const long long tiles = (CS / V + 31) / 32;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  size_t smem = 0;
  int mode = 0, most = 0;
  p.CL = min(kCluster, p.J);
  if (kWideCluster > kCluster && p.J > kCluster && tiles * kCluster < sms) {
    // few tiles: a wider cluster puts more SMs on each, where the card
    // can schedule it
    p.CL = min(kWideCluster, p.J);
    mode = size_for<V>(p, optin, smem);
    cfg.gridDim = dim3(static_cast<unsigned>(tiles * p.CL));
    cfg.dynamicSmemBytes = smem;
    err = dispatch<V>(p, mode, cfg, true, true, most);
    if (err != cudaSuccess || most < p.CL) {
      cudaGetLastError();  // not available here: the portable size
      p.CL = min(kCluster, p.J);
    }
  }
  mode = size_for<V>(p, optin, smem);
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * p.CL));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.CL);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return dispatch<V>(p, mode, cfg, p.CL > kCluster, false, most);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`: input act [J, N, C, S], outputs jobs,
// coact and active [S, C], each entry written once.  Returns the launch's
// error, else cudaGetLastError() after it: 0 when it was accepted.
int coact_launch(const void* act, void* jobs, void* coact, void* active,
                 int J, int N, int C, int S, void* stream) {
  Params p;
  p.act = static_cast<const uint8_t*>(act);
  p.jobs = static_cast<int*>(jobs);
  p.coact = static_cast<int*>(coact);
  p.active = static_cast<int*>(active);
  p.J = J;
  p.N = N;
  p.C = C;
  p.S = S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long CS = (long long)C * S;

  cudaGetLastError();  // clear any stale error from earlier work
  const cudaError_t err = (CS % 4 == 0 && CS >= kVecColumns)
                              ? launch<4>(p, st)
                              : launch<1>(p, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* coact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
