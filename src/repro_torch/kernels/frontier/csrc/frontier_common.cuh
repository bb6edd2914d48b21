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

}  // namespace
