// The Mamba-2 SSD chunked scan for Hopper (sm_90a): `models/ssm.py`
// `_ssd`, three launches forward and four backward, each chunk's masked
// decays, its scores C.B^T times the decays, and their gradients formed
// tile by tile in registers and shared memory, in f32.
//
// Replaces no TPU kernel: the JAX package's `_ssd` (`src/repro/models/
// ssm.py`) is plain `jnp` left to XLA.  On the card the port's plain
// version makes some ten f32 passes over [B, NC, H, Q, Q] tensors (the
// segment sums, their mask, their exp, the scores broadcast over the
// heads and multiplied in, the layout copies before the batched products)
// and again in the backward and the layer remat: at hymba-1.5b's train
// shape (B 4, S 4,096, H 50, P 64, N 16, Q 256) each is 0.84 GB, and the
// scan took a third of the step.  This kernel is added for that cost.
//
// Bound.  A layer's forward reads xh and writes y (f32 [B, S, H, P], ~420
// MB at hymba's shape; dt, B and C are small) and does ~17 GFLOP (the
// within-chunk product, Q^2 / 2 * P multiply-adds a (chunk, head), plus
// the chunk states and the entering states' share, Q * P * N each); the
// backward reads xh, dy and the saved states and writes dx (~630 MB) and
// does about twice the forward's work.  At 3.35 TB/s and 67 TFLOP/s of
// f32 FMA that is 0.13 / 0.25 ms forward and 0.19 / 0.5 ms backward a
// layer: as f32 FMA the FLOPs would bound it.  With the quadratic
// products on the tensor cores as below (six bf16 MMAs a product at 989
// TFLOP/s, the chunk kernel's products f32 FMA) the bound is 0.13 ms
// forward, set by the bytes, and 0.26 ms backward, by the FLOPs
// (`chip_smoke.py`'s ssd phase).  So the design never writes anything
// quadratic in Q to device memory but C.B^T (one [Q, Q] a (batch, chunk),
// shared by the heads: 16.8 MB at hymba's shape), skips the tiles above
// the diagonal, reads xh, B and C at their strides (they are column slices
// of the conv's output: a copy would be one more 210 MB pass a call), and
// runs the two quadratic kernels' products on the tensor cores: with
// register tiles of 4 x 4 outputs fed from shared memory, f32 FMA reached
// a third of these kernels' speed on an H100, bound by shared memory's
// bandwidth (two 16-byte loads a thread for 16 FMAs).
//
// Precision: f32 values throughout, f32 accumulation.  The chunk kernel's
// products (C.B^T, the chunk states) are f32 FMA.  The output and backward
// kernels' products take each f32 operand as three bf16 parts, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x
// (wherever the parts are normal), and sum the part products with i + j <=
// 2 on `mma.sync` m16n8k16 (the rest lie below f32 rounding); a product
// that a sum takes over many tiles is summed in a zeroed register tile and
// then added in f32, since the MMA's own accumulation truncates.  No TF32
// and no single bf16 rounding of an operand.  The segment sums are masked
// before the exp (above the diagonal the difference is positive and
// overflows).  exp is the accurate expf; the library is built without
// -ftz=true and without fast math.  The within-chunk cumulative sum of dt
// * a is a tree scan in f64 (each product exact), rounded once to f32:
// the sums reach some hundreds over a chunk, where an f32 rounding is
// ~1e-5, and a tree scan in f32 rounds each sum up to eight times, which
// gave the decays near the diagonal twice the plain version's error (its
// cumsum rounds once a step).  The backward's reverse cumulative sum and
// its sums over positions, heads and chunks (dt's, a's and D's gradients,
// dB and dC over the heads) are f64 likewise.  Other sums are taken in
// another order than the plain version's: the state entering a chunk a
// walk over the chunks, and the products sum in tiles.
//
// Layout.  xh [B, S, H, P] and B, C [B, S, N] at their strides (the last
// dim contiguous); dt, dy, y, dx [B, S, H(, P)] contiguous; a, D [H].
// Scratch: the chunk states, entering states and their gradients [B, NC,
// H, N, P]; C.B^T [B, NC, Q, Q]; the cumulative sums [B, H, S] and their
// chunk totals [B, NC, H]; the heads' shares of dB and dC [B, S, H, N] and
// the (batch, chunk)s' shares of da and dD [B, NC, H] (f64).
//
// Kernels.  Forward: the chunk kernel (a CTA a (batch, chunk, head): the
// cumulative sum of dt * a, the chunk's state sum_j B_j w_j x_j^T with w_j
// = dt_j exp(cum_last - cum_j), and every H-th of the chunk's lower tiles
// of C.B^T); the state pass (a thread an element of a (batch, head)'s
// state, walking the chunks); the output kernel (a CTA a tile of T rows of
// a (batch, chunk, head), a warp 16 of them, the heaviest tiles first:
// exp(cum_i) C_i h_in, then, tile by tile, the masked decays times C.B^T
// formed in registers and multiplied with the dt-weighted x, then D x).
// Backward: the chunk kernel on dy (the gradient of the entering state,
// sum_i C_i exp(cum_i) dy_i^T); the state pass in reverse (the gradient of
// each chunk's state); the main kernel (a CTA a (batch, chunk, head), a
// warp 16 positions j of a tile: a walk over the lower tile pairs that
// forms dM^T = xd_j dy_i^T, recomputes the decays, reads C.B^T, and adds up
// dx, dt's gradient and the head's shares of dB, dC, da and dD; dC's rows
// are the i tile's, from dG^T kept in shared memory); the reduction (dB
// and dC summed over the heads, da and dD over the (batch, chunk)s, each
// in a fixed order).  No atomics: two runs agree bit for bit.
//
// Instances: one library per (P, N) = (SSD_P, SSD_N); any H; any chunk Q
// up to 256 that divides S (a prefill shorter than the config's chunk
// takes Q = S): a tile's rows past Q are zeros in shared memory, masked
// out of the decays, and never stored (the wrapper checks; the entry
// points refuse anything else).  Flags: -gencode arch=compute_90a,code=
// sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas -v -DSSD_P=<P>
// -DSSD_N=<N>.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SSD_P
#error "build with -DSSD_P=<head_dim>"
#endif
#ifndef SSD_N
#error "build with -DSSD_N=<state>"
#endif

namespace {

constexpr int P = SSD_P;
constexpr int N = SSD_N;
static_assert(P % 8 == 0 && N % 8 == 0 && P >= 16 && N >= 16, "P and N");
constexpr int NT = 256;                // threads a CTA
constexpr int QMAX = 256;              // the longest chunk
static_assert(NT == QMAX, "a thread a position of the chunk");
constexpr int T = N > 64 ? 32 : 64;    // a tile of a chunk's positions
constexpr int TP = T + 4;              // a transposed tile's row: conflict-free stores

struct Shape {
  int B, S, H, Q, NC;
  long long xb, xs, xh;  // x strides: batch, token, head
  long long bb, bs;      // B strides: batch, token
  long long cb, cs;      // C strides
};

// A CTA's FMA product of an M x NN output: TM x TN outputs a thread (TN up to
// 4 consecutive columns, TM consecutive rows), threads along m first
template <int M, int NN>
struct Map {
  static constexpr int E = M * NN / NT;
  static_assert(E >= 1 && M * NN == E * NT, "outputs a thread");
  static constexpr int TN = E < 4 ? E : 4;
  static constexpr int TM = E / TN;
  static constexpr int CN = NN / TN;  // threads along n
  static constexpr int CM = M / TM;   // threads along m
  static_assert(CN * CM == NT && CN * TN == NN && CM * TM == M, "map");
  __device__ static int cm() { return threadIdx.x % CM; }
  __device__ static int cn() { return threadIdx.x / CM; }
  __device__ static int m0() { return cm() * TM; }
  __device__ static int n0() { return cn() * TN; }
};

// L floats from p, aligned to them (up to 16 bytes)
template <int L>
__device__ __forceinline__ void load_vec(float (&v)[L], const float* p) {
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int i = 0; i < L / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else if constexpr (L == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) v[i] = p[i];
  }
}

// acc[r][c] += sum_k A[k * LDA + m0 + r] * Bm[k * LDB + n0 + c]: both
// operands in shared memory with k the row
template <class Mp, int K, int LDA, int LDB>
__device__ __forceinline__ void mm(float (&acc)[Mp::TM][Mp::TN], const float* A, const float* Bm) {
  const float* a = A + Mp::m0();
  const float* b = Bm + Mp::n0();
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[Mp::TM], bv[Mp::TN];
    load_vec<Mp::TM>(av, a + k * LDA);
    load_vec<Mp::TN>(bv, b + k * LDB);
#pragma unroll
    for (int r = 0; r < Mp::TM; ++r) {
#pragma unroll
      for (int c = 0; c < Mp::TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

template <class Mp>
__device__ __forceinline__ void zero(float (&acc)[Mp::TM][Mp::TN]) {
#pragma unroll
  for (int r = 0; r < Mp::TM; ++r) {
#pragma unroll
    for (int c = 0; c < Mp::TN; ++c) acc[r][c] = 0.f;
  }
}

// rows r < T of W values, at(r, k) for r < rows and 0 past them, into
// dst[r * W + k]
template <int W, class F>
__device__ __forceinline__ void load_rows(float* dst, int rows, F at) {
  for (int e = threadIdx.x; e < T * W; e += NT) {
    const int r = e / W, k = e % W;
    dst[r * W + k] = r < rows ? at(r, k) : 0.f;
  }
}

// the same rows transposed, into dst[k * TP + r]: a warp takes 4 rows x 8
// columns, so its global reads are whole 32-byte sectors and its stores
// fall in 32 distinct banks
template <int W, class F>
__device__ __forceinline__ void load_cols(float* dst, int rows, F at) {
  static_assert(W % 8 == 0 && T % 4 == 0, "transposed tile");
  for (int e = threadIdx.x; e < T * W; e += NT) {
    const int lane = e & 31, chunk = e >> 5;
    const int r = (chunk % (T / 4)) * 4 + (lane & 3), k = (chunk / (T / 4)) * 8 + (lane >> 2);
    dst[k * TP + r] = r < rows ? at(r, k) : 0.f;
  }
}

// inclusive prefix sums of v over the NTH threads, in a fixed tree order
// (buf: 2 * NTH values)
template <int NTH, class V>
__device__ V block_scan(V v, V* buf) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  int src = 0;
  for (int off = 1; off < NTH; off <<= 1) {
    V x = buf[src * NTH + t];
    if (t >= off) x += buf[src * NTH + t - off];
    buf[(src ^ 1) * NTH + t] = x;
    src ^= 1;
    __syncthreads();
  }
  const V r = buf[src * NTH + t];
  __syncthreads();
  return r;
}

// the sum of v over the NTH threads, in a fixed tree order (buf: NTH values)
template <int NTH, class V>
__device__ V block_sum(V v, V* buf) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int off = NTH / 2; off > 0; off >>= 1) {
    if (t < off) buf[t] += buf[t + off];
    __syncthreads();
  }
  const V r = buf[0];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float xval(const float* x, const Shape& s, int b, long long tok,
                                      int h, int p) {
  return x[b * s.xb + tok * s.xs + h * s.xh + p];
}

// ---------------------------------------------------------------------------
// the chunk kernel

struct ChunkArgs {
  const float *x, *dt, *a, *b, *c, *dy;  // dy null: forward
  float *st, *g, *cum, *tot;
  Shape s;
};

constexpr int CHUNK_TILES = (2 * N * TP > T * (N + P)) ? 2 * N * TP : T * (N + P);
constexpr size_t CHUNK_SMEM =
    sizeof(double) * (QMAX + 2 * NT) + sizeof(float) * (QMAX + CHUNK_TILES);

__global__ void __launch_bounds__(NT) ssd_chunk_kernel(ChunkArgs p) {
  extern __shared__ __align__(16) float smem[];
  const Shape& s = p.s;
  const int H = s.H, Q = s.Q, t = threadIdx.x;
  const int bc = blockIdx.x, h = blockIdx.y, b = bc / s.NC, c = bc % s.NC;
  const long long tok0 = (long long)b * s.S + (long long)c * Q;  // [B, S] row of position 0
  double* cum = reinterpret_cast<double*>(smem);
  double* buf = cum + QMAX;
  float* w = reinterpret_cast<float*>(buf + 2 * NT);
  float* tiles = w + QMAX;

  // the within-chunk cumulative sum of dt * a (f64, rounded once to f32),
  // and each position's weight
  const float dtv = t < Q ? p.dt[(tok0 + t) * H + h] : 0.f;
  const double cv = block_scan<NT>((double)dtv * (double)p.a[h], buf);
  if (t < Q) cum[t] = cv;
  __syncthreads();
  const double last = cum[Q - 1];
  if (t < Q) {
    p.cum[((long long)b * H + h) * s.S + (long long)c * Q + t] = (float)cv;
    w[t] = p.dy ? expf((float)cv) : dtv * expf((float)(last - cv));
  }
  if (t == 0) p.tot[(long long)bc * H + h] = (float)last;

  // this head's share of the chunk's lower tiles of C.B^T
  {
    using GM = Map<T, T>;
    float* sc = tiles;         // [N][TP]: C rows of the tile, transposed
    float* sb = sc + N * TP;   // [N][TP]: B rows
    const int nt = (Q + T - 1) / T;
    for (int u = h; u < nt * (nt + 1) / 2; u += H) {
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= u) ++ti;
      const int tj = u - ti * (ti + 1) / 2;
      const int i0 = ti * T, j0 = tj * T;
      __syncthreads();
      load_cols<N>(sc, Q - i0, [&](int r, int k) {
        return p.c[b * s.cb + (long long)(c * Q + i0 + r) * s.cs + k];
      });
      load_cols<N>(sb, Q - j0, [&](int r, int k) {
        return p.b[b * s.bb + (long long)(c * Q + j0 + r) * s.bs + k];
      });
      __syncthreads();
      float acc[GM::TM][GM::TN];
      zero<GM>(acc);
      mm<GM, N, TP, TP>(acc, sc, sb);
#pragma unroll
      for (int r = 0; r < GM::TM; ++r) {
        const int i = i0 + GM::m0() + r;
#pragma unroll
        for (int k = 0; k < GM::TN; ++k) {
          const int j = j0 + GM::n0() + k;
          if (i < Q && j < Q) p.g[((long long)bc * Q + i) * Q + j] = acc[r][k];
        }
      }
    }
  }

  // the chunk's state [N][P]: sum_j (B_j w_j)^T x_j, or with dy the
  // gradient of the entering state, sum_i (C_i exp(cum_i))^T dy_i
  using SM = Map<N, P>;
  float* sw = tiles;         // [T][N]
  float* sx = sw + T * N;    // [T][P]
  const float* op = p.dy ? p.c : p.b;
  const long long ob = p.dy ? s.cb : s.bb, os = p.dy ? s.cs : s.bs;
  float acc[SM::TM][SM::TN];
  zero<SM>(acc);
  for (int j0 = 0; j0 < Q; j0 += T) {
    __syncthreads();
    load_rows<N>(sw, Q - j0, [&](int r, int k) {
      return op[b * ob + (long long)(c * Q + j0 + r) * os + k] * w[j0 + r];
    });
    if (p.dy) {
      load_rows<P>(sx, Q - j0, [&](int r, int k) {
        return p.dy[((tok0 + j0 + r) * H + h) * P + k];
      });
    } else {
      load_rows<P>(sx, Q - j0, [&](int r, int k) {
        return xval(p.x, s, b, c * Q + j0 + r, h, k);
      });
    }
    __syncthreads();
    mm<SM, T, N, P>(acc, sw, sx);
  }
  float* out = p.st + (((long long)bc * H + h) * N) * P;
#pragma unroll
  for (int r = 0; r < SM::TM; ++r) {
#pragma unroll
    for (int k = 0; k < SM::TN; ++k) out[(SM::m0() + r) * P + SM::n0() + k] = acc[r][k];
  }
}

// ---------------------------------------------------------------------------
// the state pass: out[c] the carry before chunk c, then carry = in[c] +
// exp(tot[c]) * carry, from the first chunk or (reverse) the last

__global__ void __launch_bounds__(NT)
    ssd_state_kernel(const float* __restrict__ in, const float* __restrict__ tot,
                     float* __restrict__ out, int reverse, int NC, int H) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int e = blockIdx.y * NT + threadIdx.x;
  if (e >= N * P) return;
  float carry = 0.f;
  for (int k = 0; k < NC; ++k) {
    const int c = reverse ? NC - 1 - k : k;
    const long long u = ((long long)b * NC + c) * H + h;
    out[u * (N * P) + e] = carry;
    carry = in[u * (N * P) + e] + expf(tot[u]) * carry;
  }
}

// ---------------------------------------------------------------------------
// tensor-core products of f32 operands: each operand as three bf16 parts
// (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is
// x wherever the parts are normal), the part products with i + j <= 2 on
// `mma.sync` m16n8k16 with f32 accumulation (the rest lie below f32
// rounding).  A warp owns 16 rows of a tile; a value of a 16 x 8 tile sits
// in the accumulator layout: lane (grp = lane / 4, tq = lane % 4) holds rows
// grp and grp + 8, columns 2 tq and 2 tq + 1.

typedef __nv_bfloat16 bf16;
constexpr int NPART = 3;
constexpr int NW = T / 16;          // warps a CTA of the output and backward kernels
constexpr int NTW = NW * 32;
constexpr int LDP = P + 8;          // a bf16 row of a [rows][P] tile: conflict-free ldmatrix
constexpr int LDN = N + 8;
constexpr int LDT = T + 8;
constexpr int NTP = P / 8, NTN = N / 8, NTT = T / 8;  // 8-column tiles over P, N, T
static_assert(NTP % 2 == 0 && NTN % 2 == 0 && NTT % 2 == 0, "pairs of 8-column tiles");

// x and y (neighbouring columns) as three bf16 pairs whose sum is (x, y)
__device__ __forceinline__ void split2(float x, float y, uint32_t (&parts)[NPART]) {
#pragma unroll
  for (int i = 0; i < NPART; ++i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    parts[i] = *reinterpret_cast<uint32_t*>(&v);
    const float2 f = __bfloat1622float2(v);
    x -= f.x;
    y -= f.y;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NTL>
__device__ __forceinline__ void zero_tiles(float (&acc)[NTL][4]) {
#pragma unroll
  for (int n = 0; n < NTL; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

template <int NTS>
__device__ __forceinline__ void add_tiles(float (&acc)[NTS][4], const float (&sum)[NTS][4]) {
#pragma unroll
  for (int n = 0; n < NTS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += sum[n][e];
  }
}

// rows r < ROWS of W f32 values at(r, k) (0 past `rows`) as three bf16
// parts, dst[part][r][LD]; a thread takes 8 neighbouring values of a row
template <int ROWS, int W, int LD, class F>
__device__ __forceinline__ void load_split(bf16* dst, int rows, F at) {
  static_assert(W % 8 == 0, "rows of whole 16-byte parts");
  for (int e = threadIdx.x; e < ROWS * W / 8; e += NTW) {
    const int r = e / (W / 8), c = (e % (W / 8)) * 8;
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = r < rows ? at(r, c + i) : 0.f;
    uint32_t parts[4][NPART];
#pragma unroll
    for (int q = 0; q < 4; ++q) split2(x[2 * q], x[2 * q + 1], parts[q]);
#pragma unroll
    for (int pt = 0; pt < NPART; ++pt) {
      *reinterpret_cast<uint4*>(dst + (pt * ROWS + r) * LD + c) =
          make_uint4(parts[0][pt], parts[1][pt], parts[2][pt], parts[3][pt]);
    }
  }
}

// acc[16 x NTL*8] += A[arow0 .. +16, 0..K) . B[0..NTL*8, 0..K)^T: A and B
// [part][rows][LD] tiles, `pa` and `pb` elements between their parts; one
// tile's K, summed in the MMAs' accumulation
template <int NTL, int K, int LD>
__device__ __forceinline__ void rows_by_rows(float (&acc)[NTL][4], const bf16* A, int pa,
                                             int arow0, const bf16* B, int pb) {
  const int lane = threadIdx.x & 31;
  const bf16* ap = A + (arow0 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* bp = B + (((lane >> 4) << 3) + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[NPART][4];
#pragma unroll
    for (int i = 0; i < NPART; ++i) ldsm(a[i], ap + i * pa + kk * 16);
#pragma unroll
    for (int j = NPART - 1; j >= 0; --j) {
      uint32_t b[NTL / 2][4];
#pragma unroll
      for (int np = 0; np < NTL / 2; ++np) ldsm(b[np], bp + j * pb + np * 16 * LD + kk * 16);
#pragma unroll
      for (int i = NPART - 1; i >= 0; --i) {
        if (i + j <= 2) {
#pragma unroll
          for (int np = 0; np < NTL / 2; ++np) {
            mma(acc[2 * np], a[i], b[np][0], b[np][1]);
            mma(acc[2 * np + 1], a[i], b[np][2], b[np][3]);
          }
        }
      }
    }
  }
}

// acc[16 x DS] += M[16 x NTL*8] . B[0..NTL*8, 0..DS): M in the accumulator
// layout (registers), B a [part][rows][LD] tile; the tile's products are
// summed in a zeroed register tile, then added to acc by f32 adds (the
// MMAs' own accumulation truncates, and acc takes many tiles)
template <int NTL, int DS, int LD>
__device__ __forceinline__ void regs_by_rows(float (&acc)[DS / 8][4], const float (&m)[NTL][4],
                                             const bf16* B, int pb) {
  constexpr int NTS = DS / 8;
  float sum[NTS][4];
  zero_tiles(sum);
  const int lane = threadIdx.x & 31;
  const bf16* bp = B + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NTL / 2; ++kk) {
    uint32_t a[4][NPART];
    split2(m[2 * kk][0], m[2 * kk][1], a[0]);
    split2(m[2 * kk][2], m[2 * kk][3], a[1]);
    split2(m[2 * kk + 1][0], m[2 * kk + 1][1], a[2]);
    split2(m[2 * kk + 1][2], m[2 * kk + 1][3], a[3]);
#pragma unroll
    for (int j = NPART - 1; j >= 0; --j) {
      uint32_t b[NTS / 2][4];
#pragma unroll
      for (int np = 0; np < NTS / 2; ++np) ldsm_t(b[np], bp + j * pb + kk * 16 * LD + np * 16);
#pragma unroll
      for (int i = NPART - 1; i >= 0; --i) {
        if (i + j <= 2) {
          const uint32_t ai[4] = {a[0][i], a[1][i], a[2][i], a[3][i]};
#pragma unroll
          for (int np = 0; np < NTS / 2; ++np) {
            mma(sum[2 * np], ai, b[np][0], b[np][1]);
            mma(sum[2 * np + 1], ai, b[np][2], b[np][3]);
          }
        }
      }
    }
  }
  add_tiles(acc, sum);
}

// acc[16 x DS] += A[arow0 .. +16, 0..K) . B[0..K, 0..DS): A stored
// transposed ([k][row], LDA), B stored [k][col] (LDB), both as three parts
// read by ldmatrix.trans; summed apart, then added by f32 adds
template <int K, int DS, int LDA, int LDB>
__device__ __forceinline__ void cols_by_rows(float (&acc)[DS / 8][4], const bf16* A, int pa,
                                             int arow0, const bf16* B, int pb) {
  constexpr int NTS = DS / 8;
  float sum[NTS][4];
  zero_tiles(sum);
  const int lane = threadIdx.x & 31;
  const bf16* ap = A + ((lane & 7) + ((lane >> 4) & 1) * 8) * LDA + arow0 + ((lane >> 3) & 1) * 8;
  const bf16* bp = B + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[NPART][4];
#pragma unroll
    for (int i = 0; i < NPART; ++i) ldsm_t(a[i], ap + i * pa + kk * 16 * LDA);
#pragma unroll
    for (int j = NPART - 1; j >= 0; --j) {
      uint32_t b[NTS / 2][4];
#pragma unroll
      for (int np = 0; np < NTS / 2; ++np) ldsm_t(b[np], bp + j * pb + kk * 16 * LDB + np * 16);
#pragma unroll
      for (int i = NPART - 1; i >= 0; --i) {
        if (i + j <= 2) {
#pragma unroll
          for (int np = 0; np < NTS / 2; ++np) {
            mma(sum[2 * np], a[i], b[np][0], b[np][1]);
            mma(sum[2 * np + 1], a[i], b[np][2], b[np][3]);
          }
        }
      }
    }
  }
  add_tiles(acc, sum);
}

// the sum over the four lanes of a row of the accumulator layout
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the sum over the eight rows of a column of a warp's 8-row half
__device__ __forceinline__ float column_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// ---------------------------------------------------------------------------
// the output kernel

struct OutArgs {
  const float *x, *dt, *d, *c, *g, *cum, *hin;
  float* y;
  Shape s;
};

constexpr size_t OUT_SMEM = sizeof(float) * 2 * QMAX + sizeof(bf16) * NPART * (T + N) * LDP;

// four CTAs an SM (128 registers a thread): the exps and loads' latency hides
__global__ void __launch_bounds__(NTW, 4) ssd_output_kernel(OutArgs p) {
  extern __shared__ __align__(16) float smem[];
  const Shape& s = p.s;
  const int H = s.H, Q = s.Q, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31, grp = lane >> 2, tq = lane & 3;
  const int nt = (Q + T - 1) / T, units = s.B * s.NC * H;
  const int unit = blockIdx.x % units, ti = nt - 1 - (int)(blockIdx.x / units);  // heaviest first
  const int h = unit % H, bc = unit / H, b = bc / s.NC, c = bc % s.NC;
  const long long tok0 = (long long)b * s.S + (long long)c * Q;
  const int ia = ti * T + 16 * warp + grp, ib = ia + 8;  // this thread's rows
  float* cum = smem;
  float* dts = cum + QMAX;
  bf16* sx = reinterpret_cast<bf16*>(dts + QMAX);  // [3][T][LDP] the j tile's dt-weighted x
  bf16* sh = sx + NPART * T * LDP;                 // [3][N][LDP] the entering state

  for (int e = t; e < Q; e += NTW) {
    cum[e] = p.cum[((long long)b * H + h) * s.S + (long long)c * Q + e];
    dts[e] = p.dt[(tok0 + e) * H + h];
  }
  const float* hin = p.hin + (((long long)bc * H + h) * N) * P;
  load_split<N, P, LDP>(sh, N, [&](int r, int k) { return hin[r * P + k]; });
  float cf[NTN][4];  // C of this thread's rows, columns n
#pragma unroll
  for (int nn = 0; nn < NTN; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? ia : ib;
      cf[nn][e] = i < Q ? p.c[b * s.cb + (long long)(c * Q + i) * s.cs + 8 * nn + 2 * tq + (e & 1)]
                        : 0.f;
    }
  }
  __syncthreads();
  float acc[NTP][4];
  zero_tiles(acc);
  regs_by_rows<NTN, P, LDP>(acc, cf, sh, N * LDP);  // C_i h_in, then times exp(cum_i)
  const float ea = ia < Q ? expf(cum[ia]) : 0.f, eb = ib < Q ? expf(cum[ib]) : 0.f;
#pragma unroll
  for (int n = 0; n < NTP; ++n) {
    acc[n][0] *= ea;
    acc[n][1] *= ea;
    acc[n][2] *= eb;
    acc[n][3] *= eb;
  }
  const float* g = p.g + (long long)bc * Q * Q;
  for (int tj = 0; tj <= ti; ++tj) {
    const int j0 = tj * T;
    __syncthreads();
    load_split<T, P, LDP>(sx, Q - j0, [&](int r, int k) {
      return dts[j0 + r] * xval(p.x, s, b, c * Q + j0 + r, h, k);
    });
    float m[NTT][4];  // C.B^T times the decays, this thread's rows, columns j
#pragma unroll
    for (int nn = 0; nn < NTT; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib, j = j0 + 8 * nn + 2 * tq + (e & 1);
        m[nn][e] = i < Q && j <= i ? g[(long long)i * Q + j] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    __syncthreads();
    regs_by_rows<NTT, P, LDP>(acc, m, sx, T * LDP);
  }
  const float dv = p.d[h];
#pragma unroll
  for (int n = 0; n < NTP; ++n) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = hh ? ib : ia, col = 8 * n + 2 * tq;
      if (i >= Q) continue;
      const float x0 = xval(p.x, s, b, c * Q + i, h, col);
      const float x1 = xval(p.x, s, b, c * Q + i, h, col + 1);
      *reinterpret_cast<float2*>(p.y + ((tok0 + i) * H + h) * P + col) =
          make_float2(acc[n][2 * hh] + dv * x0, acc[n][2 * hh + 1] + dv * x1);
    }
  }
}

// ---------------------------------------------------------------------------
// the main backward kernel

struct BwdArgs {
  const float *x, *dt, *a, *d, *b, *c, *dy, *g, *cum, *tot, *hin, *ds;
  float *dx, *ddt, *dbp, *dcp;
  double *dap, *ddp;  // the (batch, chunk)s' shares of da and dD
  Shape s;
};

constexpr int BWD_F32 = 6 * QMAX + 4 * NTW + NW * T + T;
static_assert(BWD_F32 % 4 == 0 && QMAX % NTW == 0, "layout");
constexpr int LDY = LDP > LDT ? LDP : LDT;  // the i tile's dy, then dG^T in its place
constexpr size_t BWD_SMEM =
    sizeof(float) * BWD_F32 + sizeof(bf16) * NPART * (T * LDP + T * LDY + 2 * T * LDN + 2 * N * LDP);
static_assert(BWD_SMEM <= 232448, "shared memory");

// two CTAs an SM at hymba's widths (under 113 KB of shared memory each):
// a CTA's four warps alone leave the exps and loads' latency bare
__global__ void __launch_bounds__(NTW, 2) ssd_backward_kernel(BwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  const Shape& s = p.s;
  const int H = s.H, Q = s.Q, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31, grp = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x % H, bc = blockIdx.x / H, b = bc / s.NC, c = bc % s.NC;
  const long long tok0 = (long long)b * s.S + (long long)c * Q;
  const long long sbase = ((long long)bc * H + h) * (N * P);
  const float av = p.a[h], dv = p.d[h];
  const float* g = p.g + (long long)bc * Q * Q;
  float* cum = smem;            // [QMAX] each of these six
  float* dts = cum + QMAX;
  float* dcr = dts + QMAX;      // d(loss)/d(cum_i), the terms that add
  float* dcc = dcr + QMAX;      // ... and those that subtract
  float* ddtp = dcc + QMAX;     // sum_p x dxd, dt's gradient before the cumsum chain
  float* ws = ddtp + QMAX;      // w_j: the chunk state's share of d/d(cum)
  float* buf = ws + QMAX;       // [2 * NTW] doubles: the block scans' and sums' buffer
  double* dbuf = reinterpret_cast<double*>(buf);
  float* redr = buf + 4 * NTW;  // [NW][T] each warp's sums over its rows j, by column i
  float* redi = redr + NW * T;  // [T] the entering state's share of d/d(cum_i)
  bf16* xdj = reinterpret_cast<bf16*>(redi + T);  // [3][T][LDP] the j tile's dt-weighted x
  bf16* dyi = xdj + NPART * T * LDP;              // [3][T][LDP] the i tile's dy, until
  bf16* dgt = dyi;                                // [3][T][LDT] dG^T (rows j, columns i)
  bf16* bjs = dyi + NPART * T * LDY;              // [3][T][LDN] the j tile's B
  bf16* cis = bjs + NPART * T * LDN;              // [3][T][LDN] the i tile's C
  bf16* shs = cis + NPART * T * LDN;              // [3][N][LDP] the entering state
  bf16* dss = shs + NPART * N * LDP;              // [3][N][LDP] its chunk state's gradient

  auto X = [&](int j, int k) { return xval(p.x, s, b, c * Q + j, h, k); };
  auto DY = [&](int i, int k) { return p.dy[((tok0 + i) * H + h) * P + k]; };
  auto Bv = [&](int j, int k) { return p.b[b * s.bb + (long long)(c * Q + j) * s.bs + k]; };
  auto Cv = [&](int i, int k) { return p.c[b * s.cb + (long long)(c * Q + i) * s.cs + k]; };

  for (int e = t; e < QMAX; e += NTW) {
    if (e < Q) {
      cum[e] = p.cum[((long long)b * H + h) * s.S + (long long)c * Q + e];
      dts[e] = p.dt[(tok0 + e) * H + h];
    }
    dcr[e] = 0.f;
    dcc[e] = 0.f;
  }
  float dtp = 0.f;  // <h_in, dS>
  for (int e = t; e < N * P; e += NTW) dtp += p.hin[sbase + e] * p.ds[sbase + e];
  load_split<N, P, LDP>(shs, N, [&](int r, int k) { return p.hin[sbase + r * P + k]; });
  load_split<N, P, LDP>(dss, N, [&](int r, int k) { return p.ds[sbase + r * P + k]; });
  dtp = block_sum<NTW>(dtp, buf);  // syncs: cum and the states are in place
  const float last = cum[Q - 1];
  const float dtot = expf(last) * dtp;  // the chunk total's gradient
  const int nt = (Q + T - 1) / T;
  double ddsum = 0.0;  // this thread's share of sum dy * x

  for (int tj = 0; tj < nt; ++tj) {
    const int j0 = tj * T;
    const int ja = j0 + 16 * warp + grp, jb = ja + 8;  // this thread's rows j
    __syncthreads();
    load_split<T, P, LDP>(xdj, Q - j0, [&](int r, int k) { return dts[j0 + r] * X(j0 + r, k); });
    load_split<T, N, LDN>(bjs, Q - j0, [&](int r, int k) { return Bv(j0 + r, k); });
    float dxd[NTP][4], dbj[NTN][4];
    zero_tiles(dxd);
    zero_tiles(dbj);
    for (int ti = tj; ti < nt; ++ti) {
      const int i0 = ti * T;
      const int ia = i0 + 16 * warp + grp, ib = ia + 8;  // this thread's rows of the dC product
      __syncthreads();
      load_split<T, P, LDP>(dyi, Q - i0, [&](int r, int k) { return DY(i0 + r, k); });
      load_split<T, N, LDN>(cis, Q - i0, [&](int r, int k) { return Cv(i0 + r, k); });
      float gv[NTT][4];  // C.B^T at (row j, column i), 0 where masked
#pragma unroll
      for (int nn = 0; nn < NTT; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * nn + 2 * tq + (e & 1), j = e < 2 ? ja : jb;
          gv[nn][e] = i < Q && j <= i ? g[(long long)i * Q + j] : 0.f;
        }
      }
      __syncthreads();
      float dm[NTT][4];  // dM^T = xd_j dy_i^T: rows j, columns i
      zero_tiles(dm);
      rows_by_rows<NTT, P, LDP>(dm, xdj, T * LDP, 16 * warp, dyi, T * LDP);
      float m0[NTT][4], csa = 0.f, csb = 0.f;
#pragma unroll
      for (int nn = 0; nn < NTT; ++nn) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * nn + 2 * tq + (e & 1), j = e < 2 ? ja : jb;
          const float L = i < Q && j <= i ? expf(cum[i] - cum[j]) : 0.f;  // masked before the exp
          m0[nn][e] = gv[nn][e] * L;
          ds[e] = dm[nn][e] * m0[nn][e];
          dm[nn][e] *= L;  // dG^T
        }
        csa += ds[0] + ds[1];
        csb += ds[2] + ds[3];
#pragma unroll
        for (int k = 0; k < 2; ++k) {  // sums over the warp's rows j, by column i
          const float v = column_sum(ds[k] + ds[k + 2]);
          if (grp == 0) redr[warp * T + 8 * nn + 2 * tq + k] = v;
        }
      }
      csa = quad_sum(csa);
      csb = quad_sum(csb);
      if (tq == 0) {
        if (ja < Q) dcc[ja] += csa;
        if (jb < Q) dcc[jb] += csb;
      }
      regs_by_rows<NTT, P, LDP>(dxd, m0, dyi, T * LDP);  // (C.B^T L)^T dy_i
      regs_by_rows<NTT, N, LDN>(dbj, dm, cis, T * LDN);  // dG^T C_i
      float dci[NTN][4];  // dC of rows ia, ib: the earlier pairs' shares
#pragma unroll
      for (int nn = 0; nn < NTN; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib;
          dci[nn][e] = tj > 0 && i < Q ? p.dcp[((tok0 + i) * H + h) * N + 8 * nn + 2 * tq + (e & 1)]
                                       : 0.f;
        }
      }
      if (tj == 0) {  // the entering state's share of dC: exp(cum_i) dy_i h_in^T
        float cin[NTN][4];
        zero_tiles(cin);
        rows_by_rows<NTN, P, LDP>(cin, dyi, T * LDP, 16 * warp, shs, N * LDP);
        const float ea = ia < Q ? expf(cum[ia]) : 0.f, eb = ib < Q ? expf(cum[ib]) : 0.f;
        float pa = 0.f, pb = 0.f;
#pragma unroll
        for (int nn = 0; nn < NTN; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib, n = 8 * nn + 2 * tq + (e & 1);
            const float v = cin[nn][e] * (e < 2 ? ea : eb);
            dci[nn][e] += v;
            (e < 2 ? pa : pb) += (i < Q ? Cv(i, n) : 0.f) * v;
          }
        }
        pa = quad_sum(pa);
        pb = quad_sum(pb);
        if (tq == 0) {
          redi[ia - i0] = pa;
          redi[ib - i0] = pb;
        }
      }
      __syncthreads();  // dy_i read: dG^T takes its place
#pragma unroll
      for (int nn = 0; nn < NTT; ++nn) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t parts[NPART];
          split2(dm[nn][2 * hh], dm[nn][2 * hh + 1], parts);
#pragma unroll
          for (int pt = 0; pt < NPART; ++pt) {
            *reinterpret_cast<uint32_t*>(dgt + (pt * T + (hh ? jb : ja) - j0) * LDT + 8 * nn + 2 * tq) =
                parts[pt];
          }
        }
      }
      __syncthreads();
      if (t < T && i0 + t < Q) {
        float v = 0.f;
        for (int w = 0; w < NW; ++w) v += redr[w * T + t];
        if (tj == 0) v += redi[t];
        dcr[i0 + t] += v;
      }
      cols_by_rows<T, N, LDT, LDN>(dci, dgt, T * LDT, 16 * warp, bjs, T * LDN);  // dG B_j
#pragma unroll
      for (int nn = 0; nn < NTN; ++nn) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = hh ? ib : ia;
          if (i < Q) {
            *reinterpret_cast<float2*>(p.dcp + ((tok0 + i) * H + h) * N + 8 * nn + 2 * tq) =
                make_float2(dci[nn][2 * hh], dci[nn][2 * hh + 1]);
          }
        }
      }
    }
    // the chunk state's share of the j tile: B_j exp(cum_last - cum_j) dS
    const float tea = ja < Q ? expf(last - cum[ja]) : 0.f, teb = jb < Q ? expf(last - cum[jb]) : 0.f;
    float bv[NTN][4], bw[NTN][4];
#pragma unroll
    for (int nn = 0; nn < NTN; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e < 2 ? ja : jb;
        bv[nn][e] = j < Q ? Bv(j, 8 * nn + 2 * tq + (e & 1)) : 0.f;
        bw[nn][e] = bv[nn][e] * (e < 2 ? tea : teb);
      }
    }
    regs_by_rows<NTN, P, LDP>(dxd, bw, dss, N * LDP);
    float z[NTN][4];  // xd_j dS^T
    zero_tiles(z);
    rows_by_rows<NTN, P, LDP>(z, xdj, T * LDP, 16 * warp, dss, N * LDP);
    float wa = 0.f, wb = 0.f;
#pragma unroll
    for (int nn = 0; nn < NTN; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float zz = z[nn][e] * (e < 2 ? tea : teb);
        dbj[nn][e] += zz;
        (e < 2 ? wa : wb) += bv[nn][e] * zz;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = hh ? jb : ja;
        if (j < Q) {
          *reinterpret_cast<float2*>(p.dbp + ((tok0 + j) * H + h) * N + 8 * nn + 2 * tq) =
              make_float2(dbj[nn][2 * hh], dbj[nn][2 * hh + 1]);
        }
      }
    }
    wa = quad_sum(wa);
    wb = quad_sum(wb);
    // dx, and the shares of dt's and D's gradients
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int n = 0; n < NTP; ++n) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = hh ? jb : ja, col = 8 * n + 2 * tq;
        if (j >= Q) continue;
        const float x0 = X(j, col), x1 = X(j, col + 1), d0 = DY(j, col), d1 = DY(j, col + 1);
        (hh ? pb : pa) += x0 * dxd[n][2 * hh] + x1 * dxd[n][2 * hh + 1];
        ddsum += (double)d0 * x0 + (double)d1 * x1;
        *reinterpret_cast<float2*>(p.dx + ((tok0 + j) * H + h) * P + col) =
            make_float2(dv * d0 + dts[j] * dxd[n][2 * hh], dv * d1 + dts[j] * dxd[n][2 * hh + 1]);
      }
    }
    pa = quad_sum(pa);
    pb = quad_sum(pb);
    if (tq == 0) {
      if (ja < Q) {
        ddtp[ja] = pa;
        ws[ja] = wa;
        dcc[ja] += wa;
      }
      if (jb < Q) {
        ddtp[jb] = pb;
        ws[jb] = wb;
        dcc[jb] += wb;
      }
    }
  }
  __syncthreads();
  // d/d(cum_last): the chunk total's share and the w_j's
  double last_share = dtot;
  if (t == 0) {
    for (int j = 0; j < Q; ++j) last_share += ws[j];
  }
  // dda_j = sum_{i >= j} dcum_i, the cumulative sum's backward, in f64: a
  // thread takes QMAX / NTW positions from the last, then a scan over the
  // threads
  constexpr int E = QMAX / NTW;
  double loc[E], run = 0.0;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int u = t * E + k, j = Q - 1 - u;
    run += u < Q ? (double)dcr[j] - dcc[j] + (u == 0 ? last_share : 0.0) : 0.0;
    loc[k] = run;
  }
  const double before = block_scan<NTW>(run, dbuf) - run;
  double dap = 0.0;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int u = t * E + k, j = Q - 1 - u;
    if (u < Q) {
      const double sfx = before + loc[k];
      p.ddt[(tok0 + j) * H + h] = (float)(ddtp[j] + av * sfx);
      dap += dts[j] * sfx;
    }
  }
  dap = block_sum<NTW>(dap, dbuf);
  ddsum = block_sum<NTW>(ddsum, dbuf);
  if (t == 0) {
    p.dap[(long long)bc * H + h] = dap;
    p.ddp[(long long)bc * H + h] = ddsum;
  }
}

// ---------------------------------------------------------------------------
// the reduction: dB and dC over the heads, da and dD over the (batch, chunk)s

__global__ void __launch_bounds__(NT)
    ssd_reduce_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                      const double* __restrict__ dap, const double* __restrict__ ddp,
                      float* __restrict__ db, float* __restrict__ dc, float* __restrict__ da,
                      float* __restrict__ dd, int B, int S, int H, int NC) {
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  const long long nbs = (long long)B * S * N;
  if (e < 2 * nbs) {
    const bool isc = e >= nbs;
    const long long k = isc ? e - nbs : e;
    const float* src = (isc ? dcp : dbp) + (k / N) * H * N + k % N;
    double v = 0.0;
    for (int h = 0; h < H; ++h) v += src[(long long)h * N];
    (isc ? dc : db)[k] = (float)v;
  } else if (e < 2 * nbs + 2 * H) {
    const int k = (int)(e - 2 * nbs);
    const bool isd = k >= H;
    const int h = isd ? k - H : k;
    const double* src = isd ? ddp : dap;
    double v = 0.0;
    for (int u = 0; u < B * NC; ++u) v += src[(long long)u * H + h];
    (isd ? dd : da)[h] = (float)v;
  }
}

bool make_shape(Shape& s, int B, int S, int H, int Q, long long xb, long long xs, long long xh,
                long long bb, long long bs, long long cb, long long cs) {
  if (B <= 0 || H <= 0 || Q < 1 || Q > QMAX || S <= 0 || S % Q) return false;
  s = Shape{B, S, H, Q, S / Q, xb, xs, xh, bb, bs, cb, cs};
  return (long long)B * s.NC <= 0x7fffffffLL && H <= 65535 &&
         (long long)B * s.NC * H * ((Q + T - 1) / T) <= 0x7fffffffLL;
}

template <class K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// the chunk kernel: states (dy null) or the entering states' gradients
// (dy given), C.B^T, the cumulative sums and their chunk totals
int ssd_chunk(const void* x, const void* dt, const void* a, const void* b, const void* c,
              const void* dy, void* st, void* g, void* cum, void* tot, int B, int S, int H,
              int Q, long long xb, long long xs, long long xh, long long bb, long long bs,
              long long cb, long long cs, void* stream) {
  ChunkArgs p{(const float*)x, (const float*)dt, (const float*)a, (const float*)b,
              (const float*)c, (const float*)dy, (float*)st, (float*)g, (float*)cum,
              (float*)tot, {}};
  if (!make_shape(p.s, B, S, H, Q, xb, xs, xh, bb, bs, cb, cs)) return (int)cudaErrorInvalidValue;
  int err = prepare(ssd_chunk_kernel, CHUNK_SMEM);
  if (err) return err;
  const dim3 grid(B * p.s.NC, H);
  ssd_chunk_kernel<<<grid, NT, CHUNK_SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int ssd_state_pass(const void* in, const void* tot, void* out, int reverse, int B, int NC, int H,
                   void* stream) {
  if (B <= 0 || NC <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (N * P + NT - 1) / NT);
  ssd_state_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)in, (const float*)tot, (float*)out, reverse, NC, H);
  return (int)cudaGetLastError();
}

int ssd_output(const void* x, const void* dt, const void* d, const void* c, const void* g,
               const void* cum, const void* hin, void* y, int B, int S, int H, int Q,
               long long xb, long long xs, long long xh, long long bb, long long bs,
               long long cb, long long cs, void* stream) {
  OutArgs p{(const float*)x, (const float*)dt, (const float*)d, (const float*)c,
            (const float*)g, (const float*)cum, (const float*)hin, (float*)y, {}};
  if (!make_shape(p.s, B, S, H, Q, xb, xs, xh, bb, bs, cb, cs)) return (int)cudaErrorInvalidValue;
  int err = prepare(ssd_output_kernel, OUT_SMEM);
  if (err) return err;
  const unsigned blocks = (unsigned)(B * p.s.NC * H * ((Q + T - 1) / T));
  ssd_output_kernel<<<blocks, NTW, OUT_SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int ssd_backward(const void* x, const void* dt, const void* a, const void* d, const void* b,
                 const void* c, const void* dy, const void* g, const void* cum, const void* tot,
                 const void* hin, const void* ds, void* dx, void* ddt, void* dbp, void* dcp,
                 void* dap, void* ddp, int B, int S, int H, int Q, long long xb, long long xs,
                 long long xh, long long bb, long long bs, long long cb, long long cs,
                 void* stream) {
  BwdArgs p{(const float*)x, (const float*)dt, (const float*)a, (const float*)d,
            (const float*)b, (const float*)c, (const float*)dy, (const float*)g,
            (const float*)cum, (const float*)tot, (const float*)hin, (const float*)ds,
            (float*)dx, (float*)ddt, (float*)dbp, (float*)dcp, (double*)dap, (double*)ddp, {}};
  if (!make_shape(p.s, B, S, H, Q, xb, xs, xh, bb, bs, cb, cs)) return (int)cudaErrorInvalidValue;
  int err = prepare(ssd_backward_kernel, BWD_SMEM);
  if (err) return err;
  const unsigned blocks = (unsigned)(B * p.s.NC * H);
  ssd_backward_kernel<<<blocks, NTW, BWD_SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int ssd_reduce(const void* dbp, const void* dcp, const void* dap, const void* ddp, void* db,
               void* dc, void* da, void* dd, int B, int S, int H, int n, int NC, void* stream) {
  if (n != N || B <= 0 || S <= 0 || H <= 0 || NC <= 0) return (int)cudaErrorInvalidValue;
  const long long total = 2LL * B * S * N + 2LL * H;
  const unsigned blocks = (unsigned)((total + NT - 1) / NT);
  ssd_reduce_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      (const float*)dbp, (const float*)dcp, (const double*)dap, (const double*)ddp, (float*)db,
      (float*)dc, (float*)da, (float*)dd, B, S, H, NC);
  return (int)cudaGetLastError();
}

const char* ssd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
