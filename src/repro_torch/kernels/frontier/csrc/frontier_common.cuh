// Pieces shared by the frontier kernels of this directory: the "never"
// sentinel, the top-2 merge of the frontier family and the stage prefix in
// the reference's add order.  Every source that includes this header is
// rebuilt when it changes (`_lib._library_path` hashes the headers too).
#pragma once

#include <cuda_runtime.h>

namespace {

// "never active" onset sentinel and the leader index of no rank
constexpr int kBig = 1 << 30;

// Top-2 merge of (max, lowest index of the max, second) summaries: the
// second of the union of two multisets keeps tied duplicates.
__device__ __forceinline__ void merge_top2(float& m1, int& i1, float& s1,
                                           float m2, int i2, float s2) {
  const float second = fmaxf(fminf(m1, m2), fmaxf(s1, s2));
  const bool take = (m2 > m1) || (m2 == m1 && i2 < i1);
  m1 = take ? m2 : m1;
  i1 = take ? i2 : i1;
  s1 = second;
}

// The stage prefix in the reference's add order (`ops.stage_prefix`, the
// order of XLA's cumulative sum): the stages split into blocks of kBlock,
// each block takes the ordered prefix of its own stages, and block b > 0
// adds the prefix, by this same rule, of the totals of blocks 0 .. b-1.
// Up to kBlock stages that is the plain ordered chain.  `next` takes the
// stages in order and returns each one's prefix; level k > 0 holds the
// block totals of level k - 1.
constexpr int kBlock = 16;
constexpr int kLevels = 8;  // kBlock^kLevels stages: any int S

struct StagePrefix {
  int cnt[kLevels + 1];    // elements taken at each level
  float loc[kLevels + 1];  // ordered prefix within the current block
  float inc[kLevels + 1];  // prefix of the last element (levels >= 1)

  __device__ __forceinline__ StagePrefix() {
    for (int k = 0; k <= kLevels; ++k) cnt[k] = 0;
  }

  __device__ __forceinline__ float next(float x) {
    float v = x;
    float out = 0.f;
    for (int k = 0; k < kLevels; ++k) {
      const int pos = cnt[k] % kBlock;
      const int blk = cnt[k] / kBlock;
      loc[k] = pos == 0 ? v : loc[k] + v;
      const float pre = blk == 0 ? loc[k] : inc[k + 1] + loc[k];
      if (k == 0)
        out = pre;
      else
        inc[k] = pre;
      ++cnt[k];
      if (pos != kBlock - 1) break;
      v = loc[k];  // a block is complete: its total enters the next level
    }
    return out;
  }
};

// The same order on a warp that holds whole ranks, E consecutive stages
// a lane (lane = (rank, lp), stages lp*E .. lp*E + E - 1; S <= 2 * kBlock
// and kBlock a multiple of E; `lane0` the lane of its rank's stage 0):
// B chains side by side, from the values v[b] into the prefixes x[b].  A
// lane takes the ordered prefix of its own stages; then in round k the
// lane k of each block of kBlock stages adds its values, in order, to the
// prefix of the stage before its first, which the lane before it holds:
// each add is made once, in StagePrefix's order.  Past kBlock stages the
// second block adds the first block's total.  Every lane of the warp must
// call it.
template <int E, int B>
__device__ __forceinline__ void warp_stage_prefix(const float (&v)[B][E],
                                                  float (&x)[B][E], int lp,
                                                  int lane0, int S) {
  constexpr int kLanes = kBlock / E;  // lanes of a block
  const int L = (S + E - 1) / E;      // lanes of a rank
  const int lpos = lp % kLanes;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    x[b][0] = v[b][0];
#pragma unroll
    for (int e = 1; e < E; ++e) x[b][e] = x[b][e - 1] + v[b][e];
  }
#pragma unroll
  for (int k = 1; k < kLanes; ++k) {
    if (k < L) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float up = __shfl_up_sync(0xffffffffu, x[b][E - 1], 1);
        if (lpos == k) {
          x[b][0] = up + v[b][0];
#pragma unroll
          for (int e = 1; e < E; ++e) x[b][e] = x[b][e - 1] + v[b][e];
        }
      }
    }
  }
  if (S > kBlock) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float total = __shfl_sync(0xffffffffu, x[b][E - 1], lane0 + kLanes - 1);
      if (lp >= kLanes) {
#pragma unroll
        for (int e = 0; e < E; ++e) x[b][e] = total + x[b][e];
      }
    }
  }
}

}  // namespace
