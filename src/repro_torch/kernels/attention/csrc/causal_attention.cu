// Causal (optionally sliding-window) attention with GQA for Hopper
// (sm_90a): `models/attention.py` `chunked_causal_attention`'s online
// softmax, one launch forward and two backward, the scores, probabilities
// and their gradients kept in registers and shared memory.
//
// Replaces no TPU kernel: the JAX package leaves its chunked attention
// (`src/repro/models/attention.py`) to XLA, as plain `jnp`.  On the card
// the port's plain walk materialises f32 scores for every (query block,
// key block) pair and passes them through some fifteen launches a pair;
// this kernel is added for that cost.
//
// Bound.  The work is tensor-core products: per visible score element,
// q.k takes D multiply-adds, P.V another D; the backward recomputes the
// scores twice and adds dO.V^T, P^T.dO, dS^T.Q and dS.K.  At the cells'
// shapes that is about 1e14 FLOPs a step against 989 TFLOP/s of bf16; the
// bytes (q, k, v, o read or written a few times) are two orders smaller.
// So the design keeps the products on `mma.sync` m16n8k16 bf16 tiles,
// reads each K/V (or Q/dO) tile into shared memory once per CTA with
// `cp.async`, double-buffered, and skips key tiles that the causal mask
// and the window hide entirely (in the plain walk such a tile adds exactly
// 0 to the sum and the accumulator, so the values are the same).
//
// Precision: the plain walk's, with another order of f32 sums.
//   * A product of two bf16 values is exact in f32: q.k and dO.V^T take
//     one bf16 MMA with f32 accumulation.
//   * Operands the plain walk holds in f32 (P, dS, and every operand of an
//     f32 input) enter as three bf16 parts, hi = bf16(x), mid = bf16(x -
//     hi), lo = bf16(x - hi - mid), whose sum is x (wherever |x| >= 2^-110,
//     so that the parts are normal); a product of two split
//     operands takes the part products with i + j <= 2 (the rest lie
//     below f32 rounding).
//   * Sums over keys or query rows: the MMA's own f32 accumulation
//     truncates, and over the 4k cell's 16,384 rows that drifted dK and
//     dV by 8e-5 of their largest value on an H100.  So each tile's
//     products are summed in a zeroed register tile and added to the
//     running sums by f32 adds (round to nearest): 2e-6 to 3e-6, what
//     two plain f32 computations of the same sums differ by.
//   * cast_f32=False on bf16 inputs (P rounded to bf16 before P.V) is not
//     built: no configuration runs it on the card, and the wrapper refuses
//     it.  On f32 inputs the plain walk's rounding to V's dtype is none.
//   * exp and log are the accurate expf / logf.  The library is built
//     WITHOUT -ftz=true: the plain path on the card keeps subnormals, and
//     exp of scores far below the row max makes them.  Flags: -gencode
//     arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//     -Xptxas -v -DHEAD_DIM=<D> -DINPUT_F32=<0|1>, one library per
//     (head_dim, input dtype), built on first use.
//
// Layout.  q, dq, o, dO: [B, Sq, H, D]; k, v, dk, dv: [B, S, KV, D];
// lse and delta: [B, H, Sq] f32; all contiguous.  The G = H / KV query
// heads of a KV head are flattened with the positions into Sq * G rows
// (row r: local position r / G, head kvh * G + r % G), so one CTA's rows
// share each K/V tile.  A local position lp is global position
// qblk[lp / qc] * qc + lp % qc when `qblk` (the query split's block
// indices) is given, else lp.
//
// Kernels.  Forward: one CTA per (batch, KV head, tile of BM rows), the
// tiles with the most keys first; online softmax (m, l, acc) in f32
// registers; writes o in the input dtype and, when a gradient is wanted,
// the f32 output and the row log-sum-exp.  Backward, deterministic, no
// atomics: the dQ kernel (one CTA per tile of BMD rows) computes delta =
// rowsum(dO * O_f32) and dQ; the dK/dV kernel (one CTA per key tile of BK rows) walks the
// query tiles that see its keys and sums the G heads' shares in f32.
// D above 64 is cut into 64-column slices, one warp each, which recompute
// the scores of their rows alongside each other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#ifndef HEAD_DIM
#error "build with -DHEAD_DIM=<16|64|128|256>"
#endif
#ifndef INPUT_F32
#error "build with -DINPUT_F32=<0|1>"
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = HEAD_DIM;
static_assert(D == 16 || D == 64 || D == 128 || D == 256, "head_dim");
constexpr bool F32 = INPUT_F32 != 0;
typedef std::conditional<F32, float, bf16>::type T;
constexpr int LD = D + 8;            // padded shared row: conflict-free ldmatrix
constexpr int NPI = F32 ? 3 : 1;     // bf16 parts of an input operand
constexpr int DS = D < 64 ? D : 64;  // columns of one warp's output slice
constexpr int DSPLIT = D / DS;
constexpr int NTS = DS / 8;          // n-tiles of a slice
// Tiles, chosen by timing the cells' shapes on an H100 (bf16, head_dim 64):
// forward: BM flattened query rows a CTA (16 a warp), key tiles of BN; at
// head_dim 64 in bf16 three CTAs an SM (FWD_BOUNDS: at most 170 registers)
constexpr int WRQ = D == 256 ? 2 : 4;
constexpr int BM = 16 * WRQ;
constexpr int BN = !F32 ? 64 : (D <= 64 ? 64 : (D == 128 ? 32 : 16));
constexpr int NWQ = WRQ * DSPLIT;
#if !INPUT_F32 && HEAD_DIM <= 64
#define FWD_BOUNDS __launch_bounds__(NWQ * 32, 3)
#else
#define FWD_BOUNDS __launch_bounds__(NWQ * 32)
#endif
// dQ: BMD flattened query rows a CTA, key tiles of BND
constexpr int WRD = D <= 128 ? 4 : 2;
constexpr int BMD = 16 * WRD;
constexpr int BND = BN;
constexpr int NWD = WRD * DSPLIT;
// dK/dV: BK keys a CTA, query tiles of BQ flattened rows
constexpr int WRK = D <= 128 ? 4 : 2;
constexpr int BK = 16 * WRK;
constexpr int BQ = F32 && D == 256 ? 16 : 32;
constexpr int NWK = WRK * DSPLIT;

constexpr size_t FWD_SMEM = sizeof(bf16) * NPI * LD * (BM + 4 * BN);
constexpr size_t DQ_SMEM = sizeof(bf16) * NPI * LD * (2 * BMD + 4 * BND) + 2 * sizeof(float) * BMD;
constexpr size_t DKV_SMEM = sizeof(bf16) * NPI * LD * (2 * BK + 4 * BQ) + 6 * sizeof(float) * BQ;
static_assert(FWD_SMEM <= 232448 && DQ_SMEM <= 232448 && DKV_SMEM <= 232448, "shared memory");

struct Shape {
  int B, Sq, S, H, KV, G, window, qc;
  const int* qblk;
  float scale;
};

__device__ __forceinline__ int qpos(const Shape& s, int lp) {
  return s.qblk ? s.qblk[lp / s.qc] * s.qc + lp % s.qc : lp;
}

// global positions of flattened rows [r0, r1), r0 < r1
__device__ __forceinline__ void pos_range(const Shape& s, int r0, int r1, int& pmin, int& pmax) {
  const int lp0 = r0 / s.G, lp1 = (r1 - 1) / s.G;
  if (!s.qblk) {
    pmin = lp0;
    pmax = lp1;
    return;
  }
  pmin = INT_MAX;
  pmax = -1;
  for (int blk = lp0 / s.qc; blk <= lp1 / s.qc; ++blk) {
    const int a = max(lp0, blk * s.qc), e = min(lp1, blk * s.qc + s.qc - 1);
    const int shift = (s.qblk[blk] - blk) * s.qc;
    pmin = min(pmin, a + shift);
    pmax = max(pmax, e + shift);
  }
}

__device__ __forceinline__ bool visible(int qp, int key, int window) {
  return key <= qp && (window <= 0 || qp - key < window);
}

__device__ __forceinline__ const T* qrow(const T* base, const Shape& s, int b, int kvh, int r) {
  return base + (((size_t)b * s.Sq + r / s.G) * s.H + (size_t)kvh * s.G + r % s.G) * D;
}

__device__ __forceinline__ size_t qstat(const Shape& s, int b, int kvh, int r) {
  return ((size_t)b * s.H + (size_t)kvh * s.G + r % s.G) * s.Sq + r / s.G;
}

__device__ __forceinline__ const T* krow(const T* base, const Shape& s, int b, int kvh, int j) {
  return base + (((size_t)b * s.S + j) * s.KV + kvh) * D;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x and y (neighbouring columns) as NP bf16 pairs whose sum is (x, y)
template <int NP>
__device__ __forceinline__ void split2(float x, float y, uint32_t* parts) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    parts[i] = *reinterpret_cast<uint32_t*>(&h);
    if (i + 1 < NP) {
      const float2 f = __bfloat1622float2(h);
      x -= f.x;
      y -= f.y;
    }
  }
}

// `rows` rows of D elements into the [NPI][rows][LD] tile `dst`; src(r)
// is row r's first element, or nullptr for a row of zeros.  bf16 rows go
// by cp.async (the caller commits); f32 rows are split on the way in.
template <int ROWS, int NTHREADS, class F>
__device__ __forceinline__ void load_rows(bf16* dst, const T* any, F src) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const T* p = src(r);
    bf16* d = dst + r * LD + c;
    if constexpr (!F32) {
      cp_async16(d, p ? p + c : any, p ? 16 : 0);
    } else {
      float x[8];
      if (p) {
        const float4 u = *reinterpret_cast<const float4*>(p + c);
        const float4 w = *reinterpret_cast<const float4*>(p + c + 4);
        x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
        x[4] = w.x; x[5] = w.y; x[6] = w.z; x[7] = w.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
      uint32_t parts[4][3];
#pragma unroll
      for (int e = 0; e < 4; ++e) split2<3>(x[2 * e], x[2 * e + 1], parts[e]);
#pragma unroll
      for (int pt = 0; pt < 3; ++pt) {
        *reinterpret_cast<uint4*>(d + pt * ROWS * LD) =
            make_uint4(parts[0][pt], parts[1][pt], parts[2][pt], parts[3][pt]);
      }
    }
  }
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[16 x NT*8] += A[arow0.., 0..D) . B[0..NT*8, 0..D)^T; A and B are
// [parts][rows][LD] tiles with `pa`, `pb` elements between parts
template <int NT, int NA, int NB>
__device__ __forceinline__ void rows_by_rows(float (&acc)[NT][4], const bf16* A, int pa, int arow0,
                                             const bf16* B, int pb) {
  static_assert(NT % 2 == 0, "pairs of n-tiles");
  const int lane = threadIdx.x & 31;
  const bf16* ap = A + (arow0 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* bp = B + (((lane >> 4) << 3) + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[NA][4];
#pragma unroll
    for (int i = 0; i < NA; ++i) ldsm(a[i], ap + i * pa + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
      for (int j = NB - 1; j >= 0; --j) {
        uint32_t b[4];
        ldsm(b, bp + j * pb + np * 16 * LD + kk * 16);
#pragma unroll
        for (int i = NA - 1; i >= 0; --i) {
          if (i + j <= 2) {
            mma(acc[2 * np], a[i], b[0], b[1]);
            mma(acc[2 * np + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
  }
}

// acc[16 x DS] += P[16 x NT*8] . B[0..NT*8, col0..col0+DS): P in the
// accumulator layout of `rows_by_rows`, taken as NP bf16 parts; B a
// [parts][rows][LD] tile, `pb` elements between its parts.  The tile's
// products are summed apart, then added to acc by f32 adds: the MMA's
// own accumulation truncates, and acc takes hundreds of tiles
template <int NT, int NP, int NB>
__device__ __forceinline__ void regs_by_rows(float (&acc)[NTS][4], const float (&p)[NT][4],
                                             const bf16* B, int pb, int col0) {
  float sum[NTS][4];
#pragma unroll
  for (int n = 0; n < NTS; ++n) sum[n][0] = sum[n][1] = sum[n][2] = sum[n][3] = 0.f;
  const int lane = threadIdx.x & 31;
  const bf16* bp = B + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + col0 + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t a[4][NP];
    split2<NP>(p[2 * kk][0], p[2 * kk][1], a[0]);
    split2<NP>(p[2 * kk][2], p[2 * kk][3], a[1]);
    split2<NP>(p[2 * kk + 1][0], p[2 * kk + 1][1], a[2]);
    split2<NP>(p[2 * kk + 1][2], p[2 * kk + 1][3], a[3]);
#pragma unroll
    for (int np = 0; np < NTS / 2; ++np) {
#pragma unroll
      for (int j = NB - 1; j >= 0; --j) {
        uint32_t b[4];
        ldsm_t(b, bp + j * pb + kk * 16 * LD + np * 16);
#pragma unroll
        for (int i = NP - 1; i >= 0; --i) {
          if (i + j <= 2) {
            const uint32_t ai[4] = {a[0][i], a[1][i], a[2][i], a[3][i]};
            mma(sum[2 * np], ai, b[0], b[1]);
            mma(sum[2 * np + 1], ai, b[2], b[3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NTS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += sum[n][e];
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(T* p, float x, float y) {
  if constexpr (F32) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
}
__device__ __forceinline__ float to_float(T x) {
  if constexpr (F32) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

// the key tiles [j_lo, j_hi] of TN keys that rows at positions [pmin, pmax] see
template <int TN>
__device__ __forceinline__ void key_tiles(const Shape& s, int pmin, int pmax, int& j_lo,
                                          int& j_hi) {
  j_lo = s.window > 0 ? max(0, pmin - s.window + 1) / TN : 0;
  j_hi = pmax / TN;
}

__global__ void FWD_BOUNDS
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, float* __restrict__ o32,
                         float* __restrict__ lse, Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + NPI * BM * LD;
  bf16* sV = sK + 2 * NPI * BN * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, grp = lane >> 2, tq = lane & 3;
  const int wr = warp % WRQ, ds = warp / WRQ;
  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int nrows = s.Sq * s.G;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the most keys first
  int pmin, pmax, j_lo, j_hi;
  pos_range(s, r0, min(r0 + BM, nrows), pmin, pmax);
  key_tiles<BN>(s, pmin, pmax, j_lo, j_hi);

  auto load_kv = [&](int j, int st) {
    auto kr = [&](const T* base) {
      return [&, base](int r) -> const T* {
        return j * BN + r < s.S ? krow(base, s, b, kvh, j * BN + r) : nullptr;
      };
    };
    load_rows<BN, NWQ * 32>(sK + st * NPI * BN * LD, k, kr(k));
    load_rows<BN, NWQ * 32>(sV + st * NPI * BN * LD, v, kr(v));
  };
  load_rows<BM, NWQ * 32>(sQ, q, [&](int r) -> const T* {
    return r0 + r < nrows ? qrow(q, s, b, kvh, r0 + r) : nullptr;
  });
  load_kv(j_lo, 0);
  cp_commit();

  const int ra = r0 + wr * 16 + grp, rb = ra + 8;
  const int pa = ra < nrows ? qpos(s, ra / s.G) : -1;
  const int pb = rb < nrows ? qpos(s, rb / s.G) : -1;
  float acc[NTS][4];
#pragma unroll
  for (int n = 0; n < NTS; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) {
      load_kv(j + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* K = sK + st * NPI * BN * LD;
    const bf16* V = sV + st * NPI * BN * LD;
    float sc[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    rows_by_rows<BN / 8, NPI, NPI>(sc, sQ, BM * LD, wr * 16, K, BN * LD);

    const int k0 = j * BN;
    const bool full = k0 + BN - 1 <= pmin && (s.window <= 0 || pmax - k0 < s.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * s.scale;
        if (!full && !visible(e < 2 ? pa : pb, k0 + n * 8 + 2 * tq + (e & 1), s.window)) {
          x = -INFINITY;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float use[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      use[h] = mn == -INFINITY ? 0.f : mn;
      corr[h] = expf(m[h] - use[h]);
      m[h] = mn;
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - use[e >> 1]);
        rs[e >> 1] += sc[n][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    regs_by_rows<BN / 8, 3, NPI>(acc, sc, V, BN * LD, ds * DS);
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    const float lt = quad_sum(l[h]);
    if (r >= nrows) continue;
    const size_t row = ((size_t)b * s.Sq + r / s.G) * s.H + (size_t)kvh * s.G + r % s.G;
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
      const int col = ds * DS + n * 8 + 2 * tq;
      const float x = acc[n][2 * h] / lt, y = acc[n][2 * h + 1] / lt;
      store2(out + row * D + col, x, y);
      if (o32) *reinterpret_cast<float2*>(o32 + row * D + col) = make_float2(x, y);
    }
    if (lse && ds == 0 && tq == 0) lse[qstat(s, b, kvh, r)] = (m[h] == -INFINITY ? 0.f : m[h]) + logf(lt);
  }
}

__global__ void __launch_bounds__(NWD * 32)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ o32, const float* __restrict__ lse,
                            float* __restrict__ delta, T* __restrict__ dq, Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + NPI * BMD * LD;  // dO
  bf16* sK = sO + NPI * BMD * LD;
  bf16* sV = sK + 2 * NPI * BND * LD;
  float* sL = reinterpret_cast<float*>(sV + 2 * NPI * BND * LD);
  float* sD = sL + BMD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, grp = lane >> 2, tq = lane & 3;
  const int wr = warp % WRD, ds = warp / WRD;
  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int nrows = s.Sq * s.G;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BMD;
  int pmin, pmax, j_lo, j_hi;
  pos_range(s, r0, min(r0 + BMD, nrows), pmin, pmax);
  key_tiles<BND>(s, pmin, pmax, j_lo, j_hi);

  auto load_kv = [&](int j, int st) {
    auto kr = [&](const T* base) {
      return [&, base](int r) -> const T* {
        return j * BND + r < s.S ? krow(base, s, b, kvh, j * BND + r) : nullptr;
      };
    };
    load_rows<BND, NWD * 32>(sK + st * NPI * BND * LD, k, kr(k));
    load_rows<BND, NWD * 32>(sV + st * NPI * BND * LD, v, kr(v));
  };
  auto qr = [&](const T* base) {
    return [&, base](int r) -> const T* {
      return r0 + r < nrows ? qrow(base, s, b, kvh, r0 + r) : nullptr;
    };
  };
  load_rows<BMD, NWD * 32>(sQ, q, qr(q));
  load_rows<BMD, NWD * 32>(sO, dout, qr(dout));
  load_kv(j_lo, 0);
  cp_commit();

  // delta = rowsum(dO * O) with the f32 output, one warp a row
  for (int i = warp; i < BMD; i += NWD) {
    const int r = r0 + i;
    float d = 0.f, L = 0.f;
    if (r < nrows) {
      const T* dop = qrow(dout, s, b, kvh, r);
      const float* op = o32 + (qrow(dout, s, b, kvh, r) - dout);
      for (int c = lane; c < D; c += 32) d += to_float(dop[c]) * op[c];
      L = lse[qstat(s, b, kvh, r)];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (lane == 0) {
      sD[i] = d;
      sL[i] = L;
      if (r < nrows) delta[qstat(s, b, kvh, r)] = d;
    }
  }

  const int ra = r0 + wr * 16 + grp, rb = ra + 8;
  const int pa = ra < nrows ? qpos(s, ra / s.G) : -1;
  const int pb = rb < nrows ? qpos(s, rb / s.G) : -1;
  float acc[NTS][4];
#pragma unroll
  for (int n = 0; n < NTS; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float La = 0.f, Lb = 0.f, Da = 0.f, Db = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) {
      load_kv(j + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (j == j_lo) {
      La = sL[wr * 16 + grp];
      Lb = sL[wr * 16 + grp + 8];
      Da = sD[wr * 16 + grp];
      Db = sD[wr * 16 + grp + 8];
    }
    const bf16* K = sK + st * NPI * BND * LD;
    const bf16* V = sV + st * NPI * BND * LD;
    float p[BND / 8][4], dp[BND / 8][4];
#pragma unroll
    for (int n = 0; n < BND / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = dp[n][e] = 0.f;
    }
    rows_by_rows<BND / 8, NPI, NPI>(p, sQ, BMD * LD, wr * 16, K, BND * LD);
    rows_by_rows<BND / 8, NPI, NPI>(dp, sO, BMD * LD, wr * 16, V, BND * LD);
    const int k0 = j * BND;
    const bool full = k0 + BND - 1 <= pmin && (s.window <= 0 || pmax - k0 < s.window);
#pragma unroll
    for (int n = 0; n < BND / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        float x = expf(p[n][e] * s.scale - (hi ? Lb : La));
        if (!full && !visible(hi ? pb : pa, k0 + n * 8 + 2 * tq + (e & 1), s.window)) x = 0.f;
        dp[n][e] = x * (dp[n][e] - (hi ? Db : Da)) * s.scale;
      }
    }
    regs_by_rows<BND / 8, 3, NPI>(acc, dp, K, BND * LD, ds * DS);
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    if (r >= nrows) continue;
    T* row = dq + (qrow(q, s, b, kvh, r) - q);
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
      store2(row + ds * DS + n * 8 + 2 * tq, acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(NWK * 32)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + NPI * BK * LD;
  bf16* sQ = sV + NPI * BK * LD;   // [2][NPI][BQ][LD]
  bf16* sO = sQ + 2 * NPI * BQ * LD;
  float* sL = reinterpret_cast<float*>(sO + 2 * NPI * BQ * LD);  // [2][BQ]
  float* sD = sL + 2 * BQ;
  int* sP = reinterpret_cast<int*>(sD + 2 * BQ);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, grp = lane >> 2, tq = lane & 3;
  const int wr = warp % WRK, ds = warp / WRK;
  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int nrows = s.Sq * s.G;
  const int nqt = (nrows + BQ - 1) / BQ;
  const int k0 = blockIdx.y * BK;  // the most queries first
  const int klast = min(k0 + BK, s.S) - 1;

  auto sees = [&](int t, int& pmin, int& pmax) {
    pos_range(s, t * BQ, min(t * BQ + BQ, nrows), pmin, pmax);
    return pmax >= k0 && !(s.window > 0 && pmin - klast >= s.window);
  };
  auto next_tile = [&](int t) {
    int lo, hi;
    while (t < nqt && !sees(t, lo, hi)) ++t;
    return t;
  };
  auto load_q = [&](int t, int st) {
    const int r0 = t * BQ;
    auto qr = [&](const T* base) {
      return [&, base](int r) -> const T* {
        return r0 + r < nrows ? qrow(base, s, b, kvh, r0 + r) : nullptr;
      };
    };
    load_rows<BQ, NWK * 32>(sQ + st * NPI * BQ * LD, q, qr(q));
    load_rows<BQ, NWK * 32>(sO + st * NPI * BQ * LD, dout, qr(dout));
    for (int i = threadIdx.x; i < BQ; i += NWK * 32) {
      const int r = r0 + i;
      const bool in = r < nrows;
      sL[st * BQ + i] = in ? lse[qstat(s, b, kvh, r)] : 0.f;
      sD[st * BQ + i] = in ? delta[qstat(s, b, kvh, r)] : 0.f;
      sP[st * BQ + i] = in ? qpos(s, r / s.G) : -1;
    }
  };
  auto kr = [&](const T* base) {
    return [&, base](int r) -> const T* {
      return k0 + r < s.S ? krow(base, s, b, kvh, k0 + r) : nullptr;
    };
  };
  load_rows<BK, NWK * 32>(sK, k, kr(k));
  load_rows<BK, NWK * 32>(sV, v, kr(v));
  int t = next_tile(0);
  if (t < nqt) load_q(t, 0);
  cp_commit();

  const int ka = k0 + wr * 16 + grp, kb = ka + 8;
  float adk[NTS][4], adv[NTS][4];
#pragma unroll
  for (int n = 0; n < NTS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  }

  for (int st = 0; t < nqt; st ^= 1) {
    const int tn = next_tile(t + 1);
    if (tn < nqt) {
      load_q(tn, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    int pmin, pmax;
    sees(t, pmin, pmax);
    const bool full = klast <= pmin && (s.window <= 0 || pmax - k0 < s.window) &&
                      t * BQ + BQ <= nrows;
    const bf16* Q = sQ + st * NPI * BQ * LD;
    const bf16* O = sO + st * NPI * BQ * LD;
    const float* L = sL + st * BQ;
    const float* Dl = sD + st * BQ;
    const int* P = sP + st * BQ;
    float p[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = dp[n][e] = 0.f;
    }
    rows_by_rows<BQ / 8, NPI, NPI>(p, sK, BK * LD, wr * 16, Q, BQ * LD);  // S^T
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        float x = expf(p[n][e] * s.scale - L[c]);
        if (!full && !visible(P[c], e < 2 ? ka : kb, s.window)) x = 0.f;
        p[n][e] = x;
      }
    }
    regs_by_rows<BQ / 8, 3, NPI>(adv, p, O, BQ * LD, ds * DS);      // dV += P^T dO
    rows_by_rows<BQ / 8, NPI, NPI>(dp, sV, BK * LD, wr * 16, O, BQ * LD);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        dp[n][e] = p[n][e] * (dp[n][e] - Dl[c]) * s.scale;
      }
    }
    regs_by_rows<BQ / 8, 3, NPI>(adk, dp, Q, BQ * LD, ds * DS);     // dK += dS^T Q
    __syncthreads();
    t = tn;
  }
  cp_wait<0>();  // K and V of a tile no query sees

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h ? kb : ka;
    if (key >= s.S) continue;
    const size_t row = (((size_t)b * s.S + key) * s.KV + kvh) * D;
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
      const int col = ds * DS + n * 8 + 2 * tq;
      store2(dk + row + col, adk[n][2 * h], adk[n][2 * h + 1]);
      store2(dv + row + col, adv[n][2 * h], adv[n][2 * h + 1]);
    }
  }
}

Shape make_shape(int B, int Sq, int S, int H, int KV, int window, const int* qblk, int qc,
                 float scale) {
  return Shape{B, Sq, S, H, KV, H / KV, window, qc, qblk, scale};
}

template <class K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// the fewest rows of a forward or dQ CTA, keys of a dK/dV CTA (the wrapper checks the grid)
int causal_attention_query_tile() { return BM < BMD ? BM : BMD; }
int causal_attention_key_tile() { return BK; }

// o (and, when o32 and lse are not null, the f32 output and the row
// log-sum-exp)
int causal_attention_forward(const void* q, const void* k, const void* v, void* out, void* o32,
                             void* lse, const int* qblk, int qc, int B, int Sq, int S, int H,
                             int KV, int window, float scale, void* stream) {
  const Shape s = make_shape(B, Sq, S, H, KV, window, qblk, qc, scale);
  const dim3 grid(B * KV, (Sq * s.G + BM - 1) / BM);
  int err = prepare(attention_fwd_kernel, FWD_SMEM);
  if (err) return err;
  attention_fwd_kernel<<<grid, NWQ * 32, FWD_SMEM, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)o32, (float*)lse, s);
  return (int)cudaGetLastError();
}

// delta (scratch, [B, H, Sq] f32) and dq; before causal_attention_dkv
int causal_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* o32, const void* lse, void* delta, void* dq, const int* qblk,
                        int qc, int B, int Sq, int S, int H, int KV, int window, float scale,
                        void* stream) {
  const Shape s = make_shape(B, Sq, S, H, KV, window, qblk, qc, scale);
  const dim3 grid(B * KV, (Sq * s.G + BMD - 1) / BMD);
  int err = prepare(attention_bwd_dq_kernel, DQ_SMEM);
  if (err) return err;
  attention_bwd_dq_kernel<<<grid, NWD * 32, DQ_SMEM, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)o32,
      (const float*)lse, (float*)delta, (T*)dq, s);
  return (int)cudaGetLastError();
}

int causal_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, const int* qblk,
                         int qc, int B, int Sq, int S, int H, int KV, int window, float scale,
                         void* stream) {
  const Shape s = make_shape(B, Sq, S, H, KV, window, qblk, qc, scale);
  const dim3 grid(B * KV, (S + BK - 1) / BK);
  int err = prepare(attention_bwd_dkv_kernel, DKV_SMEM);
  if (err) return err;
  attention_bwd_dkv_kernel<<<grid, NWK * 32, DKV_SMEM, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, s);
  return (int)cudaGetLastError();
}

const char* causal_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
