// The cell walk: the families of the fleet tick that carry state across
// steps, one thread per (job, rank, stage) cell of a stacked window tensor
// d[J, N, R, S].  Shared by `fused_tick.cu` (what-if, regimes, hosts) and
// `whatif_matrix.cu` (what-if alone), so the two routes run the same adds
// in the same order and agree bit for bit.
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
// regime statistics and its host in registers, and writes its outputs
// once, at the end.  Two kernels share that fold:
//
//   warp walk (S <= 32)  a warp holds whole ranks, floor(32 / S) of them,
//     lane = (rank, stage), so its loads of a step are one contiguous run
//     of d.  The stage prefix is a chain of shuffles: in round k the lane
//     of stage k adds its w to the prefix of stage k - 1, so each add is
//     made once per (rank, step, stage), in the reference's order (two
//     chains of 16 and a block total past 16 stages, as `StagePrefix`).
//     The segment end's prefix and the previous barrier's come by
//     shuffle too.  No shared memory and no block barrier: the steps go
//     in batches of kWarpBatch, whose loads are independent, the next
//     batch's window loads in flight while this one folds.
//   slab walk (S > 32)   grid (ceil(R*S / 128), J), neighbouring threads on
//     neighbouring cells of a step's [R, S] slab.  A block copies a
//     batch's slabs (the rows of the ranks its cells touch, whole), its
//     cells' baselines and the batch's [S] rows into a ring of shared
//     memory with cp.async, two batches ahead of the fold; one thread per
//     (step, rank) pair takes the rank's prefix once (`StagePrefix`) and
//     writes each stage's segment prefix beside the slab; then each cell
//     folds the batch's steps in order.  Shared memory per block:
//     4 * (3 K * (slab + 128 + 5 S) + K * slab) bytes + S, slab =
//     (127 / S + 2) * S floats; K (8 at most) halves while that passes
//     64 KB, and past 48 KB the launcher opts in, so S may reach about
//     2,400 stages on an H100 (227 KB), beyond which the launch fails
//     with cudaErrorInvalidValue.
//
// Either way the segment prefix is P[end] - P[start - 1] with the
// prolog's adds, and the fold of a batch forms its steps' excesses and
// contributions first (they are independent) and then adds them in step
// order: every float sum is the plain version's chain.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "frontier_common.cuh"

namespace {

constexpr int kCellThreads = 128;
constexpr int kWarpStages = 32;              // the warp walk's largest S
constexpr int kWarpBatch = 8;                // steps per batch of the warp walk
constexpr int kMaxBatch = 8;                 // steps per batch of the slab walk, at most
constexpr int kSlots = 3;                    // slab-walk batches in shared memory
constexpr size_t kBatchBudget = 64 * 1024;   // shared bytes a slab batch may take
constexpr unsigned kFull = 0xffffffffu;

struct CellParams {
  const float* d;      // [J, N, R, S] contiguous
  const float* wmin;   // [J, N, S] cross-rank minimum (any [J, N, S]-sized
                       // address when no stage is a sync stage)
  const float* bw;     // what-if / regime baseline, strided view of d's shape
  const float* amax;   // [J, N, S] governing-boundary release
  const float* sec;    // [J, N, S] governing-boundary second arrival
  const int* lead;     // [J, N, S] governing-boundary leader
  const float* relp;   // [J, N, S] previous segment's release
  const unsigned char* sync;  // [S], 1 on sync stages
  const float* thr;    // [J, R, S] activity threshold (regimes / hosts)
  const int* host;     // [J, R] rank -> host index (hosts)
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
  int K;               // steps per batch of the slab walk (set by the launcher)
};

// What one cell carries across the steps, and its step-ordered fold.
template <bool REG, bool HOSTS>
struct CellState {
  float wacc = 0.f, se = 0.f, sp = 0.f;
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
    wacc = wacc + contrib;
    if (REG || HOSTS) {
      const bool act = ew > thr;
      if (REG) {
        const int ai = act ? 1 : 0;
        cnt += ai;
        ons = act ? min(ons, n) : ons;
        lst = act ? max(lst, n) : lst;
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
    p.wif[o] = wacc;
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
// warp walk: S <= 32
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
  CellState<REG, HOSTS> st(p, j, r, s, valid);

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
// slab walk: S > 32
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Floats of the largest slab a block copies: the ranks its 128 cells touch.
__host__ __device__ __forceinline__ int cell_slab_max(int S) {
  return ((kCellThreads - 1) / S + 2) * S;
}

// Stride of a step's slab in a slot: odd, so the (step, rank) pairs of a
// warp read distinct banks.
__host__ __device__ __forceinline__ int cell_slab_stride(int S) {
  return cell_slab_max(S) | 1;
}

// Floats of one slot of K steps: the slabs, the cells' baselines and the
// five [K, S] rows.
__host__ __device__ __forceinline__ int cell_slot_len(int S, int K) {
  return K * (cell_slab_stride(S) + kCellThreads + 5 * S);
}

// kSlots slots, the K steps' segment prefixes, the sync bytes.
__host__ __device__ __forceinline__ size_t cell_smem_bytes(int S, int K) {
  return sizeof(float) * (kSlots * static_cast<size_t>(cell_slot_len(S, K)) +
                          static_cast<size_t>(K) * cell_slab_max(S)) +
         static_cast<size_t>(S);
}

template <bool REG, bool HOSTS>
__global__ void __launch_bounds__(kCellThreads)
    cell_slab_kernel(const CellParams p) {
  extern __shared__ float smem[];
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int S = p.S;
  const int N = p.N;
  const int R = p.R;
  const int K = p.K;
  const long long cells = (long long)R * S;
  const long long c0 = (long long)blockIdx.x * kCellThreads;
  const long long c = c0 + tid;
  const bool valid = c < cells;
  const int r = valid ? static_cast<int>(c / S) : 0;
  const int s = valid ? static_cast<int>(c - (long long)r * S) : 0;
  // the ranks this block's cells touch: the slab is their rows, whole
  const int r_lo = static_cast<int>(c0 / S);
  const int r_hi = static_cast<int>(min((long long)R - 1, (c0 + kCellThreads - 1) / S));
  const int nr = r_hi - r_lo + 1;
  const int slab = nr * S;
  const int lc = static_cast<int>(c - (long long)r_lo * S);  // cell in the slab
  const int lmax = cell_slab_max(S);
  const int lstride = cell_slab_stride(S);
  const int slot_len = cell_slot_len(S, K);
  const float* bwc = p.bw + j * p.bw_st[0] + r * p.bw_st[2] + s * p.bw_st[3];

  // slot: [K slabs of lstride | K x 128 baselines | 5 rows of K x S: amax,
  // sec, lead, relp, wmin]
  float* ring = smem;                        // [kSlots][slot_len]
  float* segp = smem + kSlots * slot_len;    // [K][lmax] segment prefixes
  unsigned char* sync = reinterpret_cast<unsigned char*>(segp + K * lmax);
  for (int k = tid; k < S; k += kCellThreads) sync[k] = p.sync[k];

  auto slot = [&](int b) { return ring + (b % kSlots) * slot_len; };
  auto batch_len = [&](int b) { return min(K, N - b * K); };

  // copy batch b into its slot (cp.async; the caller commits the group)
  auto issue = [&](int b) {
    float* sl = slot(b);
    const int n0 = b * K;
    const int kb = batch_len(b);
    const long long jn0 = (long long)j * N + n0;
    for (int t = 0; t < kb; ++t) {
      const float* src = p.d + ((jn0 + t) * R + r_lo) * S;
      float* dst = sl + t * lstride;
      for (int i = tid; i < slab; i += kCellThreads) cp_async4(dst + i, src + i);
      if (valid)
        cp_async4(sl + K * lstride + t * kCellThreads + tid,
                  bwc + (n0 + t) * p.bw_st[1]);
    }
    // the batch's rows are contiguous: [kb, S] of each [J, N, S] row
    float* rows = sl + K * (lstride + kCellThreads);
    const long long o = jn0 * S;
    for (int i = tid; i < kb * S; i += kCellThreads) {
      cp_async4(rows + i, p.amax + o + i);
      cp_async4(rows + K * S + i, p.sec + o + i);
      cp_async4(rows + 2 * K * S + i, p.lead + o + i);
      cp_async4(rows + 3 * K * S + i, p.relp + o + i);
      cp_async4(rows + 4 * K * S + i, p.wmin + o + i);
    }
  };

  // one thread per (step, rank) pair of batch b: the segment prefix of
  // every stage, P[end] - P[start - 1] of the imputed work (P[end] for
  // the first segment), with the prolog's adds in StagePrefix's order
  auto prefix = [&](int b) {
    const float* sl = slot(b);
    const int kb = batch_len(b);
    const float* wrows = sl + K * (lstride + kCellThreads) + 4 * K * S;
    for (int q = tid; q < kMaxBatch * nr; q += kCellThreads) {
      const int t = q % kMaxBatch;
      if (t >= kb) continue;
      const int lr = q / kMaxBatch;
      const float* row = sl + t * lstride + lr * S;
      const float* wrow = wrows + t * S;
      float* out = segp + t * lmax + lr * S;
      StagePrefix pfx;
      float pw = 0.f;
      float base = 0.f;  // prefix at the previous barrier
      bool has_base = false;
      int start = 0;
      for (int k = 0; k < S; ++k) {
        const bool sy = sync[k] != 0;
        pw = pfx.next(sy ? wrow[k] : row[k]);
        if (sy || k == S - 1) {
          const float seg = has_base ? pw - base : pw;
          for (int i = start; i <= k; ++i) out[i] = seg;
          if (sy) {
            base = pw;
            has_base = true;
          }
          start = k + 1;
        }
      }
    }
  };

  const bool sync_s = valid && p.sync[s] != 0;
  CellState<REG, HOSTS> st(p, j, r, s, valid);

  // the fold of batch b: each step's excess and what-if contribution are
  // independent of the others, so they are formed for the whole batch
  // first; then the sums take them in step order
  auto fold = [&](int b) {
    const float* sl = slot(b);
    const int n0 = b * K;
    const int kb = batch_len(b);
    const float* rows = sl + K * (lstride + kCellThreads);
    const int* lead = reinterpret_cast<const int*>(rows + 2 * K * S);
    float ew[kMaxBatch], contrib[kMaxBatch];
#pragma unroll
    for (int t = 0; t < kMaxBatch; ++t) {
      if (t < kb) {
        const int o = t * S + s;
        const float dv = sl[t * lstride + lc];
        const float wm = rows[4 * K * S + o];
        const float bwv = sl[K * lstride + t * kCellThreads + tid];
        const float sec = rows[K * S + o];
        const float wv = sync_s ? wm : dv;
        ew[t] = fmaxf(0.f, wv - bwv);
        const float arr = rows[3 * K * S + o] + segp[t * lmax + lc];
        const float am = rows[o];
        const float other = (r == lead[o]) ? sec : am;
        contrib[t] = whatif_contrib(am, other, arr, ew[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxBatch; ++t)
      if (t < kb) st.add(p, j, n0 + t, s, contrib[t], ew[t]);
  };

  // b = -2 and -1 only copy batches 0 and 1; each lambda has one call
  // site, so all of them inline
  const int batches = (N + K - 1) / K;
  for (int b = -2; b < batches; ++b) {
    if (b >= 0) {
      cp_async_wait<kSlots - 2>();  // this thread's copies of batch b
      // Everyone's copies of batch b are visible, and every thread is done
      // with batch b - 1: its slot takes batch b + 2, its prefix rows b.
      __syncthreads();
    }
    if (b + 2 < batches) issue(b + 2);
    cp_async_commit();
    if (b < 0) continue;
    prefix(b);
    __syncthreads();  // batch b's prefixes are visible
    if (valid) fold(b);
  }
  if (valid) st.write(p, j, r, s);
}

template <bool REG, bool HOSTS>
cudaError_t launch_cell_slab(CellParams p, int J, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  p.K = kMaxBatch;
  while (p.K > 1 && cell_smem_bytes(p.S, p.K) > kBatchBudget) p.K /= 2;
  const size_t smem = cell_smem_bytes(p.S, p.K);
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cell_slab_kernel<REG, HOSTS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long cells = (long long)p.R * p.S;
  const dim3 grid(static_cast<unsigned>((cells + kCellThreads - 1) / kCellThreads),
                  static_cast<unsigned>(J));
  cell_slab_kernel<REG, HOSTS><<<grid, kCellThreads, smem, st>>>(p);
  return cudaSuccess;
}

// Launches the cell walk with the regime (REG) and host (HOSTS) families
// on `st`; the caller reads cudaGetLastError().  Returns an error the
// launch could not be attempted for (too many stages for the device's
// shared memory), else cudaSuccess.
template <bool REG, bool HOSTS>
cudaError_t launch_cell_walk(const CellParams& p, int J, cudaStream_t st) {
  if (p.S > kWarpStages) return launch_cell_slab<REG, HOSTS>(p, J, st);
  constexpr int kWarps = kCellThreads / 32;
  const int warps = (p.R + 32 / p.S - 1) / (32 / p.S);  // per job
  const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps),
                  static_cast<unsigned>(J));
  cell_warp_kernel<REG, HOSTS><<<grid, kCellThreads, 0, st>>>(p);
  return cudaSuccess;
}

}  // namespace
