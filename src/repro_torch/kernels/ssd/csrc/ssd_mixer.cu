// The Mamba-2 SSD mixer's two elementwise chains for Hopper (sm_90a):
// `models/ssm.py` `apply_ssm` around the scan, each chain one pass over
// the data forward and one backward.
//
// Replaces no TPU kernel: the JAX package's mixer (`src/repro/models/
// ssm.py` `apply_ssm`, `_causal_conv`, `_gated_norm`) is plain `jnp` left
// to XLA, which fuses such chains itself.  The port's plain version runs
// each op as its own PyTorch launch: before the scan the concatenation of
// x, B and C, their pad, four bf16 taps and the bias, the cast and the
// silu, and dt's softplus (15 launches); after it the gated norm's cast,
// silu, products, mean, rsqrt, scale and the cast for `out_proj` (11).
// At hymba-1.5b's train shape (B 4, S 4,096, d_inner 3,200, N 16, H 50,
// width 4) that is ~6.3 GB a layer forward, twice under the layer remat,
// and about twice again backward: ~400 ms of a ~1.7 s step.  This file is
// added for that cost.
//
// Bound: bytes.  A layer's conv forward reads x, B, C and dt in bf16
// (~110 MB) and writes the f32 conv output and dt (~215 MB); the norm
// forward reads y in f32 and z in bf16 and writes bf16 (~420 MB); the
// backwards read the saved inputs and the gradients and write the
// gradients (~430 and ~740 MB).  At 3.35 TB/s: 0.095, 0.125, 0.13 and
// 0.22 ms.  A few FLOPs an element: far below the FLOP bound.  So each
// chain is one pass that reads every input once and writes every output
// once, with nothing between in device memory.
//
// Layout.  zx is `in_proj`'s output [B, S, L], L = 2D + 2N + H (z, x, B,
// C, dt), read at its batch and token strides (last dim contiguous): the
// conv reads columns [D, 2D + 2N) (x, B, C: C = D + 2N channels) and dt
// [2D + 2N, L); the norm reads z, columns [0, D).  Its row is 12,964
// bytes at hymba's shape, no multiple of 16, so no 16-byte load can start
// every row.  No tile is staged through shared memory: a thread loads a
// channel pair (bf16 x 2, 4 bytes, `V` = 2) where every column offset and
// stride is even, so a warp reads 128 contiguous bytes of a token's row,
// else one channel (`V` = 1).  The conv's outputs are three contiguous f32
// tensors, x [B, S, D], B and C [B, S, N], as the scan reads them and as
// their gradients come back (no concatenation either way); dt [B, S, H].
// The gradient of zx is one contiguous [B, S, L] tensor of zx's dtype
// that the two backwards fill: the norm's writes z's columns, the conv's
// x's, B's, C's and dt's; nothing is zero-filled or added.
//
// The conv (a CTA 128 channels or pairs of one run of 8 tokens of one
// row; a run's CTAs are launched together, so a token's row is read
// whole): the thread loads its channel's 8 + 3 inputs (the halo before
// the run, zeros before the row's first token, so no row reads the tail
// of the one before), then out_t = silu(b + sum_i w_i x_{t-W+1+i}),
// products and sums in f32 (fmaf, from the bias, tap by tap).  Widths
// under 4 are the width-4 conv with zero leading taps.  The first CTA of
// each run computes dt's softplus, max(v, 0) + log1p(exp(-|v|)) of v =
// dt + dt_bias, the `logaddexp(v, 0)` the port takes.  Its backward (a
// CTA the same channels over a block of 128 tokens) walks the block in
// runs of 8, carrying the last 3 inputs and g'_t = g_t silu'(pre_t)
// from run to run, so each token's input is read and its g' formed
// once; it writes dx_u = sum_i w_i g'_{u+W-1-i} and adds up each tap's
// and the bias's products over its own tokens; the dt CTA writes dt's
// gradient g sigmoid(v) and sums it per head.  Each CTA writes its sums
// to its token block's row of a partial-sum array [blocks, ...], and a
// reduction launch adds the rows in a fixed order: no atomics, so two
// runs agree bit for bit.
//
// The norm (a CTA of 256 threads a row, each thread every 256th channel or
// pair): u = y silu(z) and the row's sum of u^2, then r = 1 / sqrt(sum /
// D + 1e-6) and, reading the row again (from L1 or L2), out = u r scale
// in zx's dtype (the `out_proj` operand); r kept [B S].  Its backward (a
// CTA 32 rows, walked in order): with n = u r and gn = g scale, the row's
// sum(gn n), then, reading the row again, du = r (gn - n sum(gn n) / D),
// dy = du silu(z) in f32 and dz = du y silu'(z) in zx's dtype into the
// shared gradient; scale's gradient sum(g n) over the CTA's rows in
// shared memory, each thread its own channels, then into its row of
// partial sums, and the reduction.  Two passes over a row hold nothing
// in registers across the row's sum, so any D is taken, and many rows are
// in flight on an SM.  Each row's sum is a warp tree and then the warps'
// totals in order, the same in every thread.
//
// Precision: f32 throughout; inputs are bf16 or f32 (zx, conv_w, conv_b,
// gate_norm_scale of one dtype, dt_bias f32), outputs f32 but the norm's
// and the gradients of the bf16 inputs, which are rounded once to nearest
// even.  The conv accumulates in f32 where the plain version rounds each
// bf16 tap.  exp is the accurate expf, sqrt and division IEEE; the library
// is built without -ftz=true and without fast math.
//
// Flags: -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -Xptxas -v.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WMAX = 4;          // the widest conv
constexpr int HALO = WMAX - 1;   // inputs before a token that its output reads
constexpr int CONV_NT = 128;     // threads a conv CTA: a channel or pair each
constexpr int RUN = 8;           // tokens a forward conv thread takes
constexpr int BWD_RUN = 8;       // tokens a backward conv thread walks at once
constexpr int BWD_TOKENS = 128;  // tokens a backward conv CTA sums over
static_assert(BWD_TOKENS % BWD_RUN == 0, "a backward block is whole runs");
constexpr int NORM_NT = 256;     // threads a norm CTA
constexpr int NORM_ROWS = 32;    // rows a backward norm CTA sums over
constexpr float NORM_EPS = 1e-6f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive values of T at p (aligned to V of them), as f32
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }
// d silu(v) / dv, as PyTorch's silu backward forms it
__device__ __forceinline__ float silu_grad(float v) {
  const float s = sigmoid(v);
  return s * (1.0f + v * (1.0f - s));
}
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// ---------------------------------------------------------------------------
// the conv, its silu and dt's softplus

struct ConvArgs {
  const void* zx;            // [B, S, L] at strides sb, st (elements)
  long long sb, st;
  const void* w;             // [W, C]
  const void* bias;          // [C]
  const float* dt_bias;      // [H]
  float* out[3];             // forward: x [B, S, D], B and C [B, S, N]
  float* out_dt;             // forward: [B, S, H]
  const float* g[3];         // backward: the gradients of the three outputs
  const float* g_dt;         // backward: dt's, [B, S, H]
  void* dzx;                 // backward: [B, S, L] contiguous
  float* part;               // backward: partial sums [blocks, M]: W taps x C, C, H
  int B, S, D, N, H, W;
  __host__ __device__ int C() const { return D + 2 * N; }
  __host__ __device__ int L() const { return 2 * D + 2 * N + H; }
  __host__ __device__ int M() const { return (W + 1) * C() + H; }
};

// the output (or its gradient) of channel c in row `row`: x's, B's or C's
template <typename P>
__device__ __forceinline__ P* channel(P* const (&base)[3], const ConvArgs& a, long long row,
                                      int c) {
  if (c < a.D) return base[0] + row * a.D + c;
  c -= a.D;
  if (c < a.N) return base[1] + row * a.N + c;
  return base[2] + row * a.N + (c - a.N);
}

// the taps of channels [c, c + V) as a width-4 conv (leading taps zero) and the bias
template <typename T, int V>
__device__ __forceinline__ void conv_weights(const ConvArgs& a, int c, float (&w)[WMAX][V],
                                             float (&bias)[V]) {
  const int C = a.C();
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    const int j = i - (WMAX - a.W);
    if (j >= 0) {
      load<T, V>((const T*)a.w + (long long)j * C + c, w[i]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) w[i][v] = 0.0f;
    }
  }
  load<T, V>((const T*)a.bias + c, bias);
}

// channels [c, c + V)'s inputs at tokens t0 + k - HALO, k < K (zeros outside the row)
template <typename T, int V, int K>
__device__ __forceinline__ void conv_inputs(const T* row, const ConvArgs& a, int t0, int c,
                                            float (&x)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = t0 + k - HALO;
    if (t >= 0 && t < a.S) {
      load<T, V>(row + t * a.st + a.D + c, x[k]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[k][v] = 0.0f;
    }
  }
}

// the pre-activation at the token whose inputs are x[k .. k + HALO]
template <int V, int K>
__device__ __forceinline__ float conv_pre(const float (&w)[WMAX][V], const float (&bias)[V],
                                          const float (&x)[K][V], int k, int v) {
  float acc = bias[v];
#pragma unroll
  for (int i = 0; i < WMAX; ++i) acc = fmaf(w[i][v], x[k + i][v], acc);
  return acc;
}

// A conv CTA's (token block, channel block) from its index in the 1D grid
// of `tblocks` x (1 + the channel blocks), the channel blocks fastest, so
// the CTAs in flight together cover whole token rows of zx; channel block
// 0 is dt's
__device__ __forceinline__ void conv_tile(int tblocks, int& tb, int& cb) {
  const int per = gridDim.x / tblocks;
  tb = blockIdx.x / per;
  cb = blockIdx.x - tb * per;
}

template <typename T, int V>
__global__ void __launch_bounds__(CONV_NT) conv_forward_kernel(ConvArgs a) {
  const int runs = (a.S + RUN - 1) / RUN;
  int tb, cb;
  conv_tile(a.B * runs, tb, cb);
  const int b = tb / runs;
  const int t0 = (tb - b * runs) * RUN;
  const T* row = (const T*)a.zx + b * a.sb;
  const long long r0 = (long long)b * a.S;
  if (cb == 0) {  // dt's softplus over the run
    for (int e = threadIdx.x; e < RUN * a.H; e += CONV_NT) {
      const int k = e / a.H, h = e - k * a.H, t = t0 + k;
      if (t < a.S)
        a.out_dt[(r0 + t) * a.H + h] =
            softplus(to_f32(row[t * a.st + a.D + a.C() + h]) + a.dt_bias[h]);
    }
    return;
  }
  const int c = ((cb - 1) * CONV_NT + threadIdx.x) * V;
  if (c >= a.C()) return;
  float w[WMAX][V], bias[V], x[RUN + HALO][V];
  conv_weights<T, V>(a, c, w, bias);
  conv_inputs<T, V>(row, a, t0, c, x);
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    if (t0 + k < a.S) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = silu(conv_pre(w, bias, x, k, v));
      store<float, V>(channel(a.out, a, r0 + t0 + k, c), o);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(CONV_NT) conv_backward_kernel(ConvArgs a) {
  const int blocks = (a.S + BWD_TOKENS - 1) / BWD_TOKENS;
  int tb, cb;
  conv_tile(a.B * blocks, tb, cb);
  const int b = tb / blocks;
  const int first = (tb - b * blocks) * BWD_TOKENS;
  const int last = min(first + BWD_TOKENS, a.S);
  const T* row = (const T*)a.zx + b * a.sb;
  T* drow = (T*)a.dzx;
  const long long r0 = (long long)b * a.S;
  const long long L = a.L();
  float* part = a.part + (long long)tb * a.M();
  if (cb == 0) {  // dt: its gradient, and the head's sum
    const int dt0 = a.D + a.C();
    for (int h = threadIdx.x; h < a.H; h += CONV_NT) {
      const float bias = a.dt_bias[h];
      float sum = 0.0f;
      for (int t0 = first; t0 < last; t0 += BWD_RUN) {
        float g[BWD_RUN], v[BWD_RUN];
#pragma unroll
        for (int k = 0; k < BWD_RUN; ++k) {
          if (t0 + k < last) {
            g[k] = a.g_dt[(r0 + t0 + k) * a.H + h];
            v[k] = to_f32(row[(t0 + k) * a.st + dt0 + h]) + bias;
          }
        }
#pragma unroll
        for (int k = 0; k < BWD_RUN; ++k) {
          if (t0 + k < last) {
            const float d = g[k] * sigmoid(v[k]);
            drow[(r0 + t0 + k) * L + dt0 + h] = from_f32<T>(d);
            sum += d;
          }
        }
      }
      part[(a.W + 1) * a.C() + h] = sum;
    }
    return;
  }
  const int C = a.C();
  const int c = ((cb - 1) * CONV_NT + threadIdx.x) * V;
  if (c >= C) return;
  float w[WMAX][V], bias[V], dw[WMAX][V] = {}, db[V] = {};
  conv_weights<T, V>(a, c, w, bias);
  // A walk over the block in runs of BWD_RUN tokens t0 + k, carrying the last
  // HALO inputs and g' from run to run: x[k] holds the input at t0 + k -
  // HALO, gp[k] g' at t0 + k - HALO, so each token's input is read and its
  // g' formed once.  A run forms g' at its own tokens and emits dx at the
  // HALO tokens before each of them, so the walk runs HALO tokens past the
  // block; g' before the block is never read (dx before it is not emitted).
  float x[BWD_RUN + HALO][V], gp[BWD_RUN + HALO][V];
#pragma unroll
  for (int k = 0; k < HALO; ++k) {
    const int t = first + k - HALO;
    if (t >= 0) {
      load<T, V>(row + t * a.st + a.D + c, x[k]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[k][v] = 0.0f;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) gp[k][v] = 0.0f;
  }
  for (int t0 = first; t0 < last + HALO; t0 += BWD_RUN) {
    float g[BWD_RUN][V];
#pragma unroll
    for (int k = 0; k < BWD_RUN; ++k) {
      const int t = t0 + k;
      if (t < a.S) {
        load<T, V>(row + t * a.st + a.D + c, x[HALO + k]);
        load<float, V>(channel(a.g, a, r0 + t, c), g[k]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) x[HALO + k][v] = g[k][v] = 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < BWD_RUN; ++k) {
      const bool own = t0 + k < last;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = g[k][v] * silu_grad(conv_pre(w, bias, x, k, v));
        gp[HALO + k][v] = d;
        if (own) {
#pragma unroll
          for (int i = 0; i < WMAX; ++i) dw[i][v] = fmaf(d, x[k + i][v], dw[i][v]);
          db[v] += d;
        }
      }
      const int u = t0 + k - HALO;  // dx_u reads g' at u .. u + HALO
      if (u >= first && u < last) {
        float dx[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < WMAX; ++i) acc = fmaf(w[i][v], gp[k + HALO - i][v], acc);
          dx[v] = acc;
        }
        store<T, V>(drow + (r0 + u) * L + a.D + c, dx);
      }
    }
#pragma unroll
    for (int k = 0; k < HALO; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        x[k][v] = x[BWD_RUN + k][v];
        gp[k][v] = gp[BWD_RUN + k][v];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    const int j = i - (WMAX - a.W);
    if (j >= 0) store<float, V>(part + j * C + c, dw[i]);
  }
  store<float, V>(part + a.W * C + c, db);
}

// The partial sums [blocks, M] added over their rows in a fixed order (a
// CTA 32 columns: 32 threads a column each add every 32nd row in order,
// then one adds their 32 totals in order): outputs [0, na) to `a` and [na,
// na + nb) to `b` in their dtype, the rest to `f` in f32.
template <typename T>
__global__ void __launch_bounds__(1024) sum_rows_kernel(const float* __restrict__ p, int blocks,
                                                        int M, T* __restrict__ a, int na,
                                                        T* __restrict__ b, int nb,
                                                        float* __restrict__ f) {
  __shared__ float sh[32][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (j < M) {
#pragma unroll 8
    for (int i = threadIdx.y; i < blocks; i += 32) s += p[(long long)i * M + j];
  }
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || j >= M) return;
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sum += sh[i][threadIdx.x];
  if (j < na) a[j] = from_f32<T>(sum);
  else if (j < na + nb) b[j - na] = from_f32<T>(sum);
  else f[j - na - nb] = sum;
}

template <typename T>
void sum_rows(const float* p, int blocks, int M, void* a, int na, void* b, int nb, float* f,
              cudaStream_t stream) {
  sum_rows_kernel<T><<<(M + 31) / 32, dim3(32, 32), 0, stream>>>(p, blocks, M, (T*)a, na,
                                                                (T*)b, nb, f);
}

// ---------------------------------------------------------------------------
// the gated RMS norm

struct NormArgs {
  const float* y;            // [R, D] contiguous, R = B S
  const void* zx;            // z at columns [0, D) of [B, S, L], strides sb, st
  long long sb, st;
  const void* scale;         // [D]
  void* out;                 // forward: [R, D] in zx's dtype
  float* rstd;               // [R]
  const void* g;             // backward: out's gradient [R, D]
  float* dy;                 // backward: [R, D]
  void* dzx;                 // backward: dz at columns [0, D) of rows of ld
  long long ld;
  float* pscale;             // backward: partial sums [blocks, D]
  int B, S, D;
};

// the sum of v over the CTA, the same in every thread: a warp tree, then
// the warps' totals in order (`sh` holds 32 floats; free on entry)
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < warps; ++i) s += sh[i];
  __syncthreads();
  return s;
}

template <typename T, int V>
__global__ void __launch_bounds__(NORM_NT) norm_forward_kernel(NormArgs a) {
  __shared__ float sh[32];
  const long long r = blockIdx.x;
  const int b = (int)(r / a.S), t = (int)(r - (long long)b * a.S);
  const T* z = (const T*)a.zx + b * a.sb + t * a.st;
  const float* y = a.y + r * a.D;
  float ss = 0.0f;
#pragma unroll 4
  for (int j = threadIdx.x * V; j < a.D; j += NORM_NT * V) {
    float yv[V], zv[V];
    load<float, V>(y + j, yv);
    load<T, V>(z + j, zv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float u = yv[v] * silu(zv[v]);
      ss = fmaf(u, u, ss);
    }
  }
  const float rs = 1.0f / sqrtf(block_sum(ss, sh) / (float)a.D + NORM_EPS);
#pragma unroll 4
  for (int j = threadIdx.x * V; j < a.D; j += NORM_NT * V) {
    float yv[V], zv[V], sc[V], o[V];
    load<float, V>(y + j, yv);
    load<T, V>(z + j, zv);
    load<T, V>((const T*)a.scale + j, sc);
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = yv[v] * silu(zv[v]) * rs * sc[v];
    store<T, V>((T*)a.out + r * a.D + j, o);
  }
  if (threadIdx.x == 0) a.rstd[r] = rs;
}

template <typename T, int V>
__global__ void __launch_bounds__(NORM_NT) norm_backward_kernel(NormArgs a) {
  __shared__ float sh[32];
  extern __shared__ float dsc[];  // [D]: the scale's gradient over this CTA's rows
  const long long rows = (long long)a.B * a.S;
  const long long first = (long long)blockIdx.x * NORM_ROWS;
  const long long last = min(first + NORM_ROWS, rows);
  for (int j = threadIdx.x * V; j < a.D; j += NORM_NT * V) {
#pragma unroll
    for (int v = 0; v < V; ++v) dsc[j + v] = 0.0f;
  }
  for (long long r = first; r < last; ++r) {
    const int b = (int)(r / a.S), t = (int)(r - (long long)b * a.S);
    const T* z = (const T*)a.zx + b * a.sb + t * a.st;
    const float* y = a.y + r * a.D;
    const T* g = (const T*)a.g + r * a.D;
    const float rs = a.rstd[r];
    float dot = 0.0f;
#pragma unroll 4
    for (int j = threadIdx.x * V; j < a.D; j += NORM_NT * V) {
      float yv[V], zv[V], gv[V], sc[V];
      load<float, V>(y + j, yv);
      load<T, V>(z + j, zv);
      load<T, V>(g + j, gv);
      load<T, V>((const T*)a.scale + j, sc);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float n = yv[v] * silu(zv[v]) * rs;
        dot = fmaf(gv[v] * sc[v], n, dot);
        dsc[j + v] = fmaf(gv[v], n, dsc[j + v]);
      }
    }
    const float mean = block_sum(dot, sh) / (float)a.D;
#pragma unroll 4
    for (int j = threadIdx.x * V; j < a.D; j += NORM_NT * V) {
      float yv[V], zv[V], gv[V], sc[V], dy[V], dz[V];
      load<float, V>(y + j, yv);
      load<T, V>(z + j, zv);
      load<T, V>(g + j, gv);
      load<T, V>((const T*)a.scale + j, sc);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float sz = silu(zv[v]);
        const float du = rs * (gv[v] * sc[v] - yv[v] * sz * rs * mean);
        dy[v] = du * sz;
        dz[v] = du * yv[v] * silu_grad(zv[v]);
      }
      store<float, V>(a.dy + r * a.D + j, dy);
      store<T, V>((T*)a.dzx + r * a.ld + j, dz);
    }
  }
  for (int j = threadIdx.x * V; j < a.D; j += NORM_NT * V) {
    float v2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) v2[v] = dsc[j + v];
    store<float, V>(a.pscale + (long long)blockIdx.x * a.D + j, v2);
  }
}

bool conv_shape(const ConvArgs& a) {
  return a.B > 0 && a.S > 0 && a.D > 0 && a.N > 0 && a.H > 0 && a.W >= 1 && a.W <= WMAX;
}

}  // namespace

#define MIXER_DISPATCH(bf16, vec, LAUNCH)         \
  if (bf16) {                                     \
    if (vec == 2) LAUNCH(__nv_bfloat16, 2)        \
    else LAUNCH(__nv_bfloat16, 1)                 \
  } else {                                        \
    if (vec == 2) LAUNCH(float, 2)                \
    else LAUNCH(float, 1)                         \
  }

extern "C" {

// rows of the conv backward's partial sums: a block of tokens of a row
int mixer_conv_blocks(int B, int S) { return B * ((S + BWD_TOKENS - 1) / BWD_TOKENS); }

// rows of the norm backward's partial sums
int mixer_norm_blocks(int B, int S) {
  return (int)(((long long)B * S + NORM_ROWS - 1) / NORM_ROWS);
}

int mixer_conv_forward(const void* zx, long long sb, long long st, const void* w,
                       const void* bias, const void* dt_bias, void* out_x, void* out_b,
                       void* out_c, void* out_dt, int B, int S, int D, int N, int H, int W,
                       int bf16, int vec, void* stream) {
  ConvArgs a{};
  a.zx = zx; a.sb = sb; a.st = st; a.w = w; a.bias = bias; a.dt_bias = (const float*)dt_bias;
  a.out[0] = (float*)out_x; a.out[1] = (float*)out_b; a.out[2] = (float*)out_c;
  a.out_dt = (float*)out_dt;
  a.B = B; a.S = S; a.D = D; a.N = N; a.H = H; a.W = W;
  if (!conv_shape(a) || (vec != 1 && vec != 2)) return (int)cudaErrorInvalidValue;
  const int units = (a.C() + vec - 1) / vec;
  const unsigned grid =
      (unsigned)B * ((S + RUN - 1) / RUN) * (1 + (units + CONV_NT - 1) / CONV_NT);
#define MIXER_LAUNCH(T, V) \
  conv_forward_kernel<T, V><<<grid, CONV_NT, 0, (cudaStream_t)stream>>>(a);
  MIXER_DISPATCH(bf16, vec, MIXER_LAUNCH)
#undef MIXER_LAUNCH
  return (int)cudaGetLastError();
}

int mixer_conv_backward(const void* zx, long long sb, long long st, const void* w,
                        const void* bias, const void* dt_bias, const void* g_x, const void* g_b,
                        const void* g_c, const void* g_dt, void* dzx, void* part, int B, int S,
                        int D, int N, int H, int W, int bf16, int vec, void* stream) {
  ConvArgs a{};
  a.zx = zx; a.sb = sb; a.st = st; a.w = w; a.bias = bias; a.dt_bias = (const float*)dt_bias;
  a.g[0] = (const float*)g_x; a.g[1] = (const float*)g_b; a.g[2] = (const float*)g_c;
  a.g_dt = (const float*)g_dt; a.dzx = dzx; a.part = (float*)part;
  a.B = B; a.S = S; a.D = D; a.N = N; a.H = H; a.W = W;
  if (!conv_shape(a) || (vec != 1 && vec != 2)) return (int)cudaErrorInvalidValue;
  const int units = (a.C() + vec - 1) / vec;
  const unsigned grid = (unsigned)mixer_conv_blocks(B, S) * (1 + (units + CONV_NT - 1) / CONV_NT);
#define MIXER_LAUNCH(T, V) \
  conv_backward_kernel<T, V><<<grid, CONV_NT, 0, (cudaStream_t)stream>>>(a);
  MIXER_DISPATCH(bf16, vec, MIXER_LAUNCH)
#undef MIXER_LAUNCH
  return (int)cudaGetLastError();
}

// conv_w's and conv_b's gradients in their dtype, dt_bias's in f32, from
// the backward's partial sums
int mixer_conv_reduce(const void* part, void* dw, void* db, void* ddt_bias, int blocks, int C,
                      int H, int W, int bf16, void* stream) {
  if (blocks <= 0 || C <= 0 || H <= 0 || W < 1 || W > WMAX) return (int)cudaErrorInvalidValue;
  const int M = (W + 1) * C + H;
  if (bf16)
    sum_rows<__nv_bfloat16>((const float*)part, blocks, M, dw, W * C, db, C, (float*)ddt_bias,
                            (cudaStream_t)stream);
  else
    sum_rows<float>((const float*)part, blocks, M, dw, W * C, db, C, (float*)ddt_bias,
                    (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int mixer_norm_forward(const void* y, const void* zx, long long sb, long long st,
                       const void* scale, void* out, void* rstd, int B, int S, int D, int bf16,
                       int vec, void* stream) {
  NormArgs a{};
  a.y = (const float*)y; a.zx = zx; a.sb = sb; a.st = st; a.scale = scale; a.out = out;
  a.rstd = (float*)rstd; a.B = B; a.S = S; a.D = D;
  if (B <= 0 || S <= 0 || D <= 0 || (vec != 1 && vec != 2)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((long long)B * S);
#define MIXER_LAUNCH(T, V) \
  norm_forward_kernel<T, V><<<grid, NORM_NT, 0, (cudaStream_t)stream>>>(a);
  MIXER_DISPATCH(bf16, vec, MIXER_LAUNCH)
#undef MIXER_LAUNCH
  return (int)cudaGetLastError();
}

int mixer_norm_backward(const void* y, const void* zx, long long sb, long long st,
                        const void* scale, const void* rstd, const void* g, void* dy, void* dzx,
                        long long ld, void* pscale, int B, int S, int D, int bf16, int vec,
                        void* stream) {
  NormArgs a{};
  a.y = (const float*)y; a.zx = zx; a.sb = sb; a.st = st; a.scale = scale;
  a.rstd = (float*)rstd; a.g = g; a.dy = (float*)dy; a.dzx = dzx; a.ld = ld;
  a.pscale = (float*)pscale; a.B = B; a.S = S; a.D = D;
  if (B <= 0 || S <= 0 || D <= 0 || (vec != 1 && vec != 2)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)mixer_norm_blocks(B, S);
  const size_t smem = sizeof(float) * D;
#define MIXER_LAUNCH(T, V)                                                               \
  {                                                                                      \
    if (smem > 48 * 1024) {                                                              \
      const cudaError_t e = cudaFuncSetAttribute(                                        \
          norm_backward_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,       \
          (int)smem);                                                                    \
      if (e != cudaSuccess) return (int)e;                                               \
    }                                                                                    \
    norm_backward_kernel<T, V><<<grid, NORM_NT, smem, (cudaStream_t)stream>>>(a);        \
  }
  MIXER_DISPATCH(bf16, vec, MIXER_LAUNCH)
#undef MIXER_LAUNCH
  return (int)cudaGetLastError();
}

// gate_norm_scale's gradient in its dtype, from the backward's partial sums
int mixer_norm_reduce(const void* part, void* dscale, int blocks, int D, int bf16,
                      void* stream) {
  if (blocks <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    sum_rows<__nv_bfloat16>((const float*)part, blocks, D, dscale, D, nullptr, 0, nullptr,
                            (cudaStream_t)stream);
  else
    sum_rows<float>((const float*)part, blocks, D, dscale, D, nullptr, 0, nullptr,
                    (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

const char* mixer_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
