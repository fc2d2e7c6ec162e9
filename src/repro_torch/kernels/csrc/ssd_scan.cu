// Chunked Mamba2 SSD scan for Hopper, sm_90a: K8.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::ssd_pallas (_ssd_kernel),
// the TPU kernel behind ssd(backend="pallas").  Same function, for each
// (batch b, head h), over chunks of Q steps, with cs = cumsum(dt·A) over
// the chunk (inclusive):
//   y     = (C·Bᵀ ⊙ L)·(dt·x) + exp(cs)·(C·stateᵀ) + D·x,
//           L[i][j] = exp(cs_i − cs_j) for j <= i, 0 above the diagonal;
//   state ← exp(cs_last)·state + (dt·x·exp(cs_last − cs))ᵀ·B.
// B and C are shared by the heads of a group (g = h / (H/G)).  The math is
// f32 (the chunk's cumulative sums f64); y is stored in x's dtype, the
// final state in f32.  x (Bt,S,H,P), dt (Bt,S,H) f32, A and D (H,) f32, B
// and C (Bt,S,G,N), the initial state (Bt,H,P,N) f32.  S need not be a
// multiple of Q: the steps of the last chunk past S are taken as dt = 0
// with no input (what the reference's padding feeds the Pallas kernel),
// and their outputs are not stored.
//
// What bounds it on an H100: operations on f32 operands.  At mamba2-130m's
// prefill (Bt 4, S 512, H 24, P 64, N 128, Q 256; bf16 x, B, C) the
// function needs, over the causal half of each chunk, C·Bᵀ once per
// (batch, group, chunk) (0.07 GFLOP on bf16 operands: 0.07 us at 989
// TFLOP/s) and, per head, its product with dt·x plus the two state terms
// (2.42 GFLOP whose operands are f32: 36 us at the CUDA cores' 67 TFLOP/s;
// 11.4 us at 495 as TF32 products, three for the intra-chunk term and two
// for each state term, whose bf16 B or C is exact in TF32), against 19.5
// MB of operands (6 us of memory).  zamba2-1.2b (H 64, N 64): 0.03 + 4.30
// GFLOP, 43 MB; 64 or 21.7 us.  (Computed, not measured; measured times
// are in PERF.md.)  The
// Pallas kernel's grid walks the chunks in order on one core; a block per
// (head, channels) that does the same on the H100 forms C·Bᵀ once per head
// (24 and 64 times what the function needs, since both models have one
// group), leaves most SMs idle at batch 4, and on the CUDA cores is held
// to a fraction of their rate by its shared-memory reads.
//
// Design: the chunked SSD decomposition as four kernels, launched one
// after another on the caller's stream by one wrapper call.
//  1. cb_mma_kernel / cb_f32_kernel, per (batch, group, chunk, 64 x 64
//     tile at or below the diagonal): C·Bᵀ once, into scratch as (j, i),
//     i.e. key-major.  bf16 B and C run on the tensor cores (mma.sync
//     m16n8k16, f32 sums: bf16 products are exact in f32); f32 B and C on
//     the CUDA cores.
//  2. state_kernel, per (batch, head, chunk, 64 x 64 tile of the state):
//     the chunk's cumulative sums of dt·A (one warp; f64, see
//     chunk_cumsum), written to scratch once per (batch, head, chunk), and
//     the chunk's own contribution to the state, (dt·x·exp(cs_last −
//     cs))ᵀ·B, into scratch.  All chunks at once.
//  3. pass_kernel, per (batch, head, 1,024 state entries): the state
//     passed across the chunks in order, elementwise: each chunk's slot
//     of the scratch is rewritten with the state entering it, and the
//     last state is the final state.
//  4. out_kernel, per (batch, head, chunk, 64-step query tile, 64
//     channels): y = (exp(cs)·C)·stateᵀ + Σ_{key tiles <= query tile}
//     (C·Bᵀ ⊙ L)·(dt·x) + D·x, the mask applied before the exp; tiles
//     above the diagonal are never touched.
// The products of stages 2 and 4, whose operands are f32 (dt·x, the
// decays, the state), run on the tensor cores in a form that keeps f32's
// accuracy: each operand is split into a TF32 part and the TF32 part of
// its rest as it is written to shared memory, and each product is the sum
// of three m16n8k8 products (lo·hi, hi·lo, hi·hi) in f32, or of two where
// one operand is exact in TF32 and has no lo part (bf16 B in the state
// update, bf16 C in C·stateᵀ; tc_pass's flags).  128 threads a
// block, 2 x 2 warps of 32 x 32 outputs, 32 contracted steps a pass; each
// pass's operands are loaded into registers while the last pass is
// multiplied, then widened, scaled by dt or the decay, or transposed as
// they are written to shared memory.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int QMAX = 256;       // longest chunk
constexpr int NMAX = 128;       // widest state
constexpr int TILE = 64;        // rows and columns of an output tile
constexpr int KC = 32;          // contracted steps per pass through shared memory
constexpr int LD = TILE;        // row stride of a CUDA-core operand in shared memory
constexpr int LDT = TILE + 8;   // ... of a tensor-core operand (no bank conflicts)
constexpr int CC_THREADS = 64;  // CUDA cores: 8 x 8 threads, 8 x 8 outputs each
constexpr int TC_THREADS = 128; // tensor cores: 2 x 2 warps, 32 x 32 outputs each
constexpr int PASS_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Row (or column) of the tile that a thread's r-th output sits on.
__device__ __forceinline__ int tile_row(int t, int r) {
  return (r < 4 ? 0 : 32) + t * 4 + (r & 3);
}

// One pass's piece of an operand, held in registers between its global
// load and its store to shared memory: up to 16 values, raw (16-byte
// pieces of the operand's own type) or f32 words.
union Frag {
  uint4 v[4];
  uint32_t w[16];
};

template <typename T> __device__ __forceinline__ void unpack16(uint4 u, float* out);
template <> __device__ __forceinline__ void unpack16<float>(uint4 u, float* out) {
  out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 u, float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// A tensor-core operand in shared memory: an f32 value v as its TF32 part
// hi = tf32(v) and the TF32 part of the rest, lo = tf32(v - hi), each
// (KC, LDT) along the contracted axis.  hi·hi + hi·lo + lo·hi carries v·w
// to about 2^-21 of its size: the f32 products of the function, on the
// tensor cores.
struct __align__(16) Split {
  uint32_t hi[KC * LDT];
  uint32_t lo[KC * LDT];
  // LO false: v is a TF32 value already (a widened bf16); no lo part
  template <bool LO = true>
  __device__ __forceinline__ void put(int i, float v) {
    const uint32_t h = to_tf32(v);
    hi[i] = h;
    if (LO) lo[i] = to_tf32(v - __uint_as_float(h));
  }
  template <bool LO = true>
  __device__ __forceinline__ void put4(int i, float a, float b, float c,
                                       float d) {   // i a multiple of 4
    const uint4 h = make_uint4(to_tf32(a), to_tf32(b), to_tf32(c), to_tf32(d));
    *reinterpret_cast<uint4*>(hi + i) = h;
    if (LO) {
      *reinterpret_cast<uint4*>(lo + i) = make_uint4(
          to_tf32(a - __uint_as_float(h.x)), to_tf32(b - __uint_as_float(h.y)),
          to_tf32(c - __uint_as_float(h.z)), to_tf32(d - __uint_as_float(h.w)));
    }
  }
};

// 4 elements of a global row as raw words (2 for bf16, 4 for f32), and
// back to f32.
template <typename T> struct Four { static constexpr int W = sizeof(T); };
__device__ __forceinline__ void ld4(const float* p, uint32_t* w) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, uint32_t* w) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  w[0] = u.x; w[1] = u.y;
}
__device__ __forceinline__ void unpack4(const uint32_t* w, float* out, float) {
  for (int e = 0; e < 4; ++e) out[e] = __uint_as_float(w[e]);
}
__device__ __forceinline__ void unpack4(const uint32_t* w, float* out,
                                        __nv_bfloat16) {
  for (int i = 0; i < 2; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// KC rows of a row-major global matrix, columns [0, TILE), 4 elements a
// piece (16 threads a row): rows at or past `rows` and columns at or past
// `cols` (a multiple of 8) are zeros.
template <typename T>
__device__ __forceinline__ void fetch_rows(Frag& f, const T* src,
                                           int64_t stride, int rows,
                                           int cols) {
  constexpr int W = Four<T>::W;
#pragma unroll
  for (int q = 0; q < KC * TILE / 4 / TC_THREADS; ++q) {
    const int c = threadIdx.x + q * TC_THREADS;
    const int r = c / (TILE / 4);
    const int col = (c % (TILE / 4)) * 4;
    if (r < rows && col < cols) {
      ld4(src + r * stride + col, &f.w[q * W]);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) f.w[q * W + e] = 0u;
    }
  }
}

// ... into dst at (k, col), row k times scale[k] when given (LO false when
// the values are TF32 already); a quarter warp's 16-byte stores cover the
// banks once.
template <typename T, bool LO>
__device__ __forceinline__ void store_rows(Split& dst, const Frag& f,
                                           const float* scale, int rows) {
  constexpr int W = Four<T>::W;
#pragma unroll
  for (int q = 0; q < KC * TILE / 4 / TC_THREADS; ++q) {
    const int c = threadIdx.x + q * TC_THREADS;
    const int r = c / (TILE / 4);
    const int col = (c % (TILE / 4)) * 4;
    float v[4];
    unpack4(&f.w[q * W], v, T());
    const float m = scale != nullptr && r < rows ? scale[r] : 1.f;
    dst.put4<LO>(r * LDT + col, v[0] * m, v[1] * m, v[2] * m, v[3] * m);
  }
}

// The transpose: TILE rows of a row-major global matrix, columns [0, KC):
// rows at or past `rows` and columns at or past `cols` (a multiple of 8)
// are zeros.  Thread t takes row t % TILE.
template <typename T>
__device__ __forceinline__ void fetch_cols(Frag& f, const T* src,
                                           int64_t stride, int rows,
                                           int cols) {
  constexpr int V = Vec16<T>::N;
#pragma unroll
  for (int q = 0; q < TILE * KC / V / TC_THREADS; ++q) {
    const int c = threadIdx.x + q * TC_THREADS;
    const int row = c % TILE;
    const int k = (c / TILE) * V;
    f.v[q] = row < rows && k < cols
                 ? __ldg(reinterpret_cast<const uint4*>(src + row * stride + k))
                 : make_uint4(0, 0, 0, 0);
  }
}

// ... into dst at (k, row), times `scale` (the thread's row's); LO false
// when the values are TF32 already.
template <typename T, bool LO>
__device__ __forceinline__ void store_cols(Split& dst, const Frag& f,
                                           float scale) {
  constexpr int V = Vec16<T>::N;
#pragma unroll
  for (int q = 0; q < TILE * KC / V / TC_THREADS; ++q) {
    const int c = threadIdx.x + q * TC_THREADS;
    const int row = c % TILE;
    const int k = (c / TILE) * V;
    float v[V];
    unpack16<T>(f.v[q], v);
#pragma unroll
    for (int e = 0; e < V; ++e) dst.put<LO>((k + e) * LDT + row, v[e] * scale);
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += Aᵀ·B over one pass of KC steps, both operands (k, row) in shared
// memory: warp (wm, wn) of the 2 x 2 takes rows wm*32.. and columns
// wn*32.., two 16-row by four 8-column m16n8k8 tiles, three products each;
// an operand whose values are TF32 already (bf16 B or C) has no lo part,
// and its product with the other's hi part is left out (A_LO, B_LO false).
// acc[mt][nt][e] sits at row wm*32 + mt*16 + lane/4 (+8 for e >= 2) and
// column wn*32 + nt*8 + 2*(lane%4) + (e&1).
template <bool A_LO, bool B_LO>
__device__ __forceinline__ void tc_pass(float (&acc)[2][4][4], const Split& a,
                                        const Split& b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp >> 1) * 32 + lane / 4, n0 = (warp & 1) * 32 + lane / 4;
  const int tig = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < KC; k0 += 8) {
    const int r0 = (k0 + tig) * LDT, r1 = (k0 + tig + 4) * LDT;
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = m0 + mt * 16;
      const int idx[4] = {r0 + m, r0 + m + 8, r1 + m, r1 + m + 8};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[mt][e] = a.hi[idx[e]];
        if (A_LO) al[mt][e] = a.lo[idx[e]];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + nt * 8;
      bh[nt][0] = b.hi[r0 + n];
      bh[nt][1] = b.hi[r1 + n];
      if (B_LO) {
        bl[nt][0] = b.lo[r0 + n];
        bl[nt][1] = b.lo[r1 + n];
      }
    }
    // the small terms first; each product over all 8 tiles before the
    // next, so that no mma waits on the one before it
    if (A_LO) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
    }
    if (B_LO) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
  }
}

__device__ __forceinline__ int tc_row(int mt, int e) {
  return ((threadIdx.x / 32) >> 1) * 32 + mt * 16 + (threadIdx.x % 32) / 4 +
         (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int tc_col(int nt, int e) {
  return ((threadIdx.x / 32) & 1) * 32 + nt * 8 + 2 * (threadIdx.x % 4) +
         (e & 1);
}

// The transpose in one step (C·Bᵀ's f32 kernel): TILE rows of a row-major
// global matrix, columns [0, KC), into shared f32 dst[k * LD + row].  Rows
// at or past `rows` and columns at or past `cols` (a multiple of 8) are
// zeros.
template <typename T>
__device__ __forceinline__ void load_cols(float* dst, const T* src,
                                          int64_t stride, int rows,
                                          int cols) {
  constexpr int V = Vec16<T>::N;
  constexpr int CPR = KC / V;
  for (int c = threadIdx.x; c < TILE * CPR; c += CC_THREADS) {
    const int row = c % TILE;
    const int k = (c / TILE) * V;
    float v[V];
    if (row < rows && k < cols) {
      load16(src + row * stride + k, v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[(k + e) * LD + row] = v[e];
  }
}

// acc[r][c] += Σ_k a[k][tile_row(ty, r)] · b[k][tile_row(tx, c)], k < KC.
__device__ __forceinline__ void gemm_pass(float (&acc)[8][8], const float* a,
                                          const float* b, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < KC; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * LD + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * LD + 32 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * LD + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(b + k * LD + 32 + tx * 4);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
}

// One warp: cs[i] = sum_{j <= i} dts[j] * a for i < Q, each product in
// f32 (as dt·A is formed in the reference) and the sums in f64.  At the
// models' decays the sums reach -1e3 over a chunk, where an f32 running
// sum would carry ~1e-4 of absolute error into every cs_i - cs_j; in f64
// the differences are exact to f32 rounding.  Each lane sums a run of
// ceil(Q/32) steps, the lanes' totals are scanned with shuffles, and each
// lane then rewrites its run from its exclusive prefix.
__device__ __forceinline__ void chunk_cumsum(const float* dts, double* cs,
                                             int Q, float a, int lane) {
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q);
  const int hi = min(lo + per, Q);
  double run = 0.0;
  for (int i = lo; i < hi; ++i) run += dts[i] * a;
  double tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, tot, o);
    if (lane >= o) tot += v;
  }
  double base = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) base = 0.0;
  for (int i = lo; i < hi; ++i) {
    base += dts[i] * a;
    cs[i] = base;
  }
}

// Shapes every kernel reads.
struct Dims {
  int Bt, S, H, P, G, N, Q, nc;   // nc chunks of Q steps
  int qt, pt, nt;                 // 64-wide tiles of Q, P and N
};

// (j tile, i tile) of the t-th tile at or below the diagonal, row by row.
__device__ __forceinline__ void lower_tile(int t, int* jt, int* it) {
  int i = 0;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  *it = i;
  *jt = t - i * (i + 1) / 2;
}

// ---- 1. C·Bᵀ once per (batch, group, chunk) ----------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cbt[j][i] = Σ_n B[j][n] C[i][n] for a 64 x 64 tile, bf16 on the tensor
// cores: 4 warps of 16 rows j, each 8 column groups of 8 i.
__global__ void __launch_bounds__(TC_THREADS)
cb_mma_kernel(const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm, float* __restrict__ cbt,
              Dims d) {
  extern __shared__ float4 smem4[];
  const int ldb = ((d.N + 15) / 16) * 16 + 8;      // bf16 row stride
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* csm = bs + TILE * ldb;
  const int n_lower = d.qt * (d.qt + 1) / 2;
  int t = blockIdx.x;
  const int tile = t % n_lower; t /= n_lower;
  const int c = t % d.nc; t /= d.nc;
  const int g = t % d.G;
  const int b = t / d.G;
  int jt, it;
  lower_tile(tile, &jt, &it);
  const int r0 = c * d.Q;
  const int qv = min(d.Q, d.S - r0);
  const int j0 = jt * TILE, i0 = it * TILE;
  const int64_t stride = static_cast<int64_t>(d.G) * d.N;
  const int64_t base = (static_cast<int64_t>(b) * d.S + r0) * stride +
                       static_cast<int64_t>(g) * d.N;
  const int np = ldb - 8;
  // rows j of B and i of C into shared memory, zeros past qv and N
  const int cpr = np / 8;
  for (int x = threadIdx.x; x < 2 * TILE * cpr; x += TC_THREADS) {
    const int which = x / (TILE * cpr);
    const int row = (x / cpr) % TILE;
    const int col = (x % cpr) * 8;
    const int step = (which == 0 ? j0 : i0) + row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (step < qv && col < d.N) {
      const __nv_bfloat16* src = (which == 0 ? Bm : Cm) + base + step * stride + col;
      v = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>((which == 0 ? bs : csm) + row * ldb + col) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const __nv_bfloat16* arow = bs + (warp * 16 + gid) * ldb + tig * 2;
  for (int k0 = 0; k0 < np; k0 += 16) {
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(arow + k0);
    a[1] = *reinterpret_cast<const uint32_t*>(arow + 8 * ldb + k0);
    a[2] = *reinterpret_cast<const uint32_t*>(arow + k0 + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(arow + 8 * ldb + k0 + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* brow = csm + (nt * 8 + gid) * ldb + tig * 2 + k0;
      mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(brow),
               *reinterpret_cast<const uint32_t*>(brow + 8));
    }
  }
  float* out = cbt + ((static_cast<int64_t>(b) * d.G + g) * d.nc + c) *
                         d.Q * d.Q;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + warp * 16 + gid + (e >= 2 ? 8 : 0);
      const int i = i0 + nt * 8 + tig * 2 + (e & 1);
      if (j < d.Q && i < d.Q) out[static_cast<int64_t>(j) * d.Q + i] = acc[nt][e];
    }
}

// The same in f32 on the CUDA cores.
__global__ void __launch_bounds__(CC_THREADS)
cb_f32_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cbt, Dims d) {
  __shared__ __align__(16) float as[KC * LD];
  __shared__ __align__(16) float bsm[KC * LD];
  const int n_lower = d.qt * (d.qt + 1) / 2;
  int t = blockIdx.x;
  const int tile = t % n_lower; t /= n_lower;
  const int c = t % d.nc; t /= d.nc;
  const int g = t % d.G;
  const int b = t / d.G;
  int jt, it;
  lower_tile(tile, &jt, &it);
  const int r0 = c * d.Q;
  const int qv = min(d.Q, d.S - r0);
  const int j0 = jt * TILE, i0 = it * TILE;
  const int64_t stride = static_cast<int64_t>(d.G) * d.N;
  const int64_t base = (static_cast<int64_t>(b) * d.S + r0) * stride +
                       static_cast<int64_t>(g) * d.N;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float acc[8][8];
  zero(acc);
  for (int n0 = 0; n0 < d.N; n0 += KC) {
    __syncthreads();
    load_cols<float>(as, Bm + base + j0 * stride + n0, stride,
                     max(0, qv - j0), d.N - n0);
    load_cols<float>(bsm, Cm + base + i0 * stride + n0, stride,
                     max(0, qv - i0), d.N - n0);
    __syncthreads();
    gemm_pass(acc, as, bsm, ty, tx);
  }
  float* out = cbt + ((static_cast<int64_t>(b) * d.G + g) * d.nc + c) *
                         d.Q * d.Q;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int j = j0 + tile_row(ty, r), i = i0 + tile_row(tx, cc);
      if (j < d.Q && i < d.Q) out[static_cast<int64_t>(j) * d.Q + i] = acc[r][cc];
    }
}

// ---- 2. cumulative sums and each chunk's own state contribution ---------

// Loads dt of the chunk's steps (0 past S) into dts[0, Q).
__device__ __forceinline__ void load_dt(float* dts, const float* dt,
                                        int64_t b, int h, int r0, int qv,
                                        const Dims& d) {
  for (int i = threadIdx.x; i < d.Q; i += blockDim.x)
    dts[i] = i < qv ? dt[(b * d.S + r0 + i) * d.H + h] : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(TC_THREADS, 4)
state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             double* __restrict__ cs_out, float* __restrict__ states, Dims d) {
  __shared__ __align__(16) Split as, bsm;
  __shared__ double cs[QMAX];
  __shared__ float dts[QMAX];
  __shared__ float wts[QMAX];
  int t = blockIdx.x;
  const int ntile = t % d.nt; t /= d.nt;
  const int ptile = t % d.pt; t /= d.pt;
  const int c = t % d.nc; t /= d.nc;
  const int h = t % d.H;
  const int b = t / d.H;
  const int g = h / (d.H / d.G);
  const int r0 = c * d.Q;
  const int qv = min(d.Q, d.S - r0);
  const int p0 = ptile * TILE, n0 = ntile * TILE;
  const int pv = min(TILE, d.P - p0), nv = min(TILE, d.N - n0);
  const int tid = threadIdx.x;
  constexpr bool kF32Ops = sizeof(T) == 4;   // bf16 B is TF32 already

  // contribution[p][n] = Σ_j wts[j] x[j][p] B[j][n]; the first pass's
  // loads go out before the cumulative sums
  const int64_t xs = static_cast<int64_t>(d.H) * d.P;
  const int64_t bs_ = static_cast<int64_t>(d.G) * d.N;
  const T* xb = x + (static_cast<int64_t>(b) * d.S + r0) * xs +
                static_cast<int64_t>(h) * d.P + p0;
  const T* Bb = Bm + (static_cast<int64_t>(b) * d.S + r0) * bs_ +
                static_cast<int64_t>(g) * d.N + n0;
  Frag fa, fb;
  fetch_rows<T>(fa, xb, xs, qv, pv);
  fetch_rows<T>(fb, Bb, bs_, qv, nv);

  load_dt(dts, dt, b, h, r0, qv, d);
  __syncthreads();
  if (tid < 32) chunk_cumsum(dts, cs, d.Q, A[h], tid);
  __syncthreads();
  const int64_t bhc = (static_cast<int64_t>(b) * d.H + h) * d.nc + c;
  const double cs_last = cs[d.Q - 1];
  for (int i = tid; i < d.Q; i += TC_THREADS) {
    wts[i] = dts[i] * expf(static_cast<float>(cs_last - cs[i]));
    if (ptile == 0 && ntile == 0) cs_out[bhc * d.Q + i] = cs[i];
  }

  float acc[2][4][4] = {};
  // pass k + 1's loads are in flight while pass k is multiplied
  const int passes = (qv + KC - 1) / KC;
  for (int k = 0; k < passes; ++k) {
    const int j0 = k * KC;
    __syncthreads();               // wts written; the last pass is read
    store_rows<T, true>(as, fa, wts + j0, qv - j0);
    store_rows<T, kF32Ops>(bsm, fb, nullptr, qv - j0);
    __syncthreads();
    if (k + 1 < passes) {
      fetch_rows<T>(fa, xb + (j0 + KC) * xs, xs, qv - j0 - KC, pv);
      fetch_rows<T>(fb, Bb + (j0 + KC) * bs_, bs_, qv - j0 - KC, nv);
    }
    tc_pass<true, kF32Ops>(acc, as, bsm);
  }
  float* out = states + bhc * d.P * d.N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = tc_row(mt, 2 * half), n = tc_col(nt, 0);
        if (p < pv && n < nv) {
          *reinterpret_cast<float2*>(out + static_cast<int64_t>(p0 + p) * d.N + n0 + n) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
      }
}

// ---- 3. the state across the chunks --------------------------------------

__global__ void __launch_bounds__(PASS_THREADS)
pass_kernel(const float* __restrict__ init, const double* __restrict__ cs,
            float* __restrict__ states, float* __restrict__ final_state,
            Dims d) {
  const int n4 = d.P * d.N / 4;
  const int per_bh = (n4 + PASS_THREADS - 1) / PASS_THREADS;
  const int bh = blockIdx.x / per_bh;
  const int e = (blockIdx.x % per_bh) * PASS_THREADS + threadIdx.x;
  if (e >= n4) return;
  const int64_t pn = static_cast<int64_t>(d.P) * d.N;
  float4 run = reinterpret_cast<const float4*>(init + bh * pn)[e];
  for (int c = 0; c < d.nc; ++c) {
    const int64_t bhc = static_cast<int64_t>(bh) * d.nc + c;
    float4* slot = reinterpret_cast<float4*>(states + bhc * pn) + e;
    const float4 own = *slot;
    if (c > 0) *slot = run;        // the state entering chunk c
    const float decay = expf(static_cast<float>(cs[bhc * d.Q + d.Q - 1]));
    run.x = fmaf(decay, run.x, own.x);
    run.y = fmaf(decay, run.y, own.y);
    run.z = fmaf(decay, run.z, own.z);
    run.w = fmaf(decay, run.w, own.w);
  }
  reinterpret_cast<float4*>(final_state + bh * pn)[e] = run;
}

// ---- 4. the outputs ------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(TC_THREADS, 4)
out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const T* __restrict__ Cm, const float* __restrict__ Dskip,
           const float* __restrict__ init, const double* __restrict__ cs_in,
           const float* __restrict__ cbt, const float* __restrict__ states,
           T* __restrict__ y, Dims d) {
  __shared__ __align__(16) Split as, bsm;
  __shared__ double cs[QMAX];
  __shared__ float dts[QMAX];
  int t = blockIdx.x;
  const int ptile = t % d.pt; t /= d.pt;
  const int it = d.qt - 1 - t % d.qt; t /= d.qt;    // longest rows first
  const int c = t % d.nc; t /= d.nc;
  const int h = t % d.H;
  const int b = t / d.H;
  const int g = h / (d.H / d.G);
  const int r0 = c * d.Q;
  const int qv = min(d.Q, d.S - r0);
  const int q0 = it * TILE;
  const int p0 = ptile * TILE;
  const int tid = threadIdx.x;
  if (q0 >= qv) return;            // the whole tile lies past S
  const int qrows = min(TILE, qv - q0);
  const int pv = min(TILE, d.P - p0);
  const int jend = min(q0 + TILE, qv);     // keys the tile's rows can see
  const int i = q0 + tid % TILE;   // this thread's query row while loading
  const bool row_ok = i < qv;
  constexpr bool kF32Ops = sizeof(T) == 4;   // bf16 C is TF32 already

  const int64_t bhc = (static_cast<int64_t>(b) * d.H + h) * d.nc + c;
  const int64_t cstride = static_cast<int64_t>(d.G) * d.N;
  const T* Cb = Cm + (static_cast<int64_t>(b) * d.S + r0 + q0) * cstride +
                static_cast<int64_t>(g) * d.N;
  const int64_t pn = static_cast<int64_t>(d.P) * d.N;
  const float* st = (c == 0 ? init + (static_cast<int64_t>(b) * d.H + h) * pn
                            : states + bhc * pn) +
                    static_cast<int64_t>(p0) * d.N;
  const int64_t xs = static_cast<int64_t>(d.H) * d.P;
  const T* xb = x + (static_cast<int64_t>(b) * d.S + r0) * xs +
                static_cast<int64_t>(h) * d.P + p0;
  const float* cb = cbt + ((static_cast<int64_t>(b) * d.G + g) * d.nc + c) *
                              d.Q * d.Q;

  // Passes 0 .. n1 - 1: C_i · state_inᵀ over N, the state entering the
  // chunk, whose rows are then scaled by exp(cs_i) (bf16 C stays TF32);
  // then (C·Bᵀ ⊙ L)·(dt·x) over the keys at or before
  // the tile's last row, KC at a time: thread t loads row t % TILE, keys
  // t / TILE + 2z.  Pass k + 1's loads are in flight while pass k is
  // multiplied.
  constexpr int KPT = KC * TILE / TC_THREADS;    // keys a thread loads
  const int n1 = (d.N + KC - 1) / KC;
  const int passes = n1 + (jend + KC - 1) / KC;
  Frag fa, fb;
  auto fetch = [&](int k) {
    if (k < n1) {
      const int n0 = k * KC;
      fetch_cols<T>(fa, Cb + n0, cstride, qrows, d.N - n0);
      fetch_cols<float>(fb, st + n0, d.N, pv, d.N - n0);
    } else {
      const int j0 = (k - n1) * KC + tid / TILE;
#pragma unroll
      for (int z = 0; z < KPT; ++z) {
        const int j = j0 + 2 * z;
        fa.w[z] = row_ok && j <= i
                      ? __float_as_uint(__ldg(cb + static_cast<int64_t>(j) * d.Q + i))
                      : 0u;
      }
      fetch_rows<T>(fb, xb + (j0 - tid / TILE) * xs, xs,
                    qv - (j0 - tid / TILE), pv);
    }
  };
  fetch(0);
  for (int k = tid; k < d.Q; k += TC_THREADS) cs[k] = cs_in[bhc * d.Q + k];
  load_dt(dts, dt, b, h, r0, qv, d);

  float acc[2][4][4] = {};
  for (int k = 0; k < passes; ++k) {
    __syncthreads();               // cs, dts loaded; the last pass is read
    if (k < n1) {
      store_cols<T, kF32Ops>(as, fa, 1.f);
      store_cols<float, true>(bsm, fb, 1.f);
    } else {
      const int j0 = (k - n1) * KC;
      const double cs_i = row_ok ? cs[i] : 0.0;
#pragma unroll
      for (int z = 0; z < KPT; ++z) {
        const int kk = tid / TILE + 2 * z;
        const int j = j0 + kk;
        float s = __uint_as_float(fa.w[z]);
        if (row_ok && j <= i)      // the mask before the exp
          s *= __expf(static_cast<float>(cs_i - cs[j]));
        as.put<true>(kk * LDT + tid % TILE, s);
      }
      store_rows<T, true>(bsm, fb, dts + j0, qv - j0);
    }
    __syncthreads();
    if (k + 1 < passes) fetch(k + 1);
    if (k < n1) {
      tc_pass<kF32Ops, true>(acc, as, bsm);
      if (k == n1 - 1) {           // exp(cs_i) on the state term's rows
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + tc_row(mt, e);
            const float sc = row < qv ? expf(static_cast<float>(cs[row])) : 0.f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) acc[mt][nt][e] *= sc;
          }
      }
    } else {
      tc_pass<true, true>(acc, as, bsm);
    }
  }

  const float dskip = Dskip[h];
  T* yb = y + (static_cast<int64_t>(b) * d.S + r0) * xs +
          static_cast<int64_t>(h) * d.P + p0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + tc_row(mt, e), p = tc_col(nt, e);
        if (row < qv && p < pv) {
          const int64_t off = row * xs + p;
          store(yb + off, acc[mt][nt][e] + dskip * to_f32(xb[off]));
        }
      }
}

// Blocks of each of the four kernels: C·Bᵀ per (batch, group, chunk, tile
// at or below the diagonal), the state per (batch, head, chunk, tile), the
// pass per (batch, head, 1,024 state entries), the outputs per (batch,
// head, chunk, query tile, channel tile).
struct Grids {
  int cb, state, pass, out;
};

Grids grids(const Dims& d) {
  const int per_bh = (d.P * d.N / 4 + PASS_THREADS - 1) / PASS_THREADS;
  return {d.qt * (d.qt + 1) / 2 * d.nc * d.Bt * d.G,
          d.Bt * d.H * d.nc * d.pt * d.nt, d.Bt * d.H * per_bh,
          d.Bt * d.H * d.nc * d.qt * d.pt};
}

// The dims of a call, or false for arguments the kernels do not take.
bool make_dims(int Bt, int S, int H, int P, int G, int N, int chunk, Dims* d) {
  if (Bt <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      P % 8 != 0 || N <= 0 || N % 8 != 0 || N > NMAX || chunk < 1 ||
      chunk > QMAX)
    return false;
  d->Bt = Bt; d->S = S; d->H = H; d->P = P; d->G = G; d->N = N; d->Q = chunk;
  d->nc = (S + chunk - 1) / chunk;
  d->qt = (chunk + TILE - 1) / TILE;
  d->pt = (P + TILE - 1) / TILE;
  d->nt = (N + TILE - 1) / TILE;
  return static_cast<int64_t>(Bt) * H * d->nc * d->qt * d->pt <=
         (1ll << 31) - 1;
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* D,
                   const float* init, void* y, float* final_state,
                   double* cs, float* cbt, float* states, const Dims& d,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const Grids g = grids(d);
  if constexpr (sizeof(T) == 2) {
    const int ldb = ((d.N + 15) / 16) * 16 + 8;
    const int smem = 2 * TILE * ldb * static_cast<int>(sizeof(T));
    cb_mma_kernel<<<g.cb, TC_THREADS, smem, stream>>>(Bt, Ct, cbt, d);
  } else {
    cb_f32_kernel<<<g.cb, CC_THREADS, 0, stream>>>(Bt, Ct, cbt, d);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_kernel<T><<<g.state, TC_THREADS, 0, stream>>>(xt, dt, A, Bt, cs,
                                                      states, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pass_kernel<<<g.pass, PASS_THREADS, 0, stream>>>(init, cs, states,
                                                   final_state, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  out_kernel<T><<<g.out, TC_THREADS, 0, stream>>>(
      xt, dt, Ct, D, init, cs, cbt, states, static_cast<T*>(y), d);
  return cudaGetLastError();
}

}  // namespace

// The blocks each of the four kernels of a call at these shapes launches
// (C·Bᵀ, state, pass, outputs) into out[4]; -1 for shapes ssd_scan_fwd
// does not take.
extern "C" int ssd_scan_grids(int Bt, int S, int H, int P, int G, int N,
                              int chunk, int* out) {
  Dims d;
  if (!make_dims(Bt, S, H, P, G, N, chunk, &d)) return -1;
  const Grids g = grids(d);
  out[0] = g.cb; out[1] = g.state; out[2] = g.pass; out[3] = g.out;
  return 0;
}

// x (Bt,S,H,P), B and C (Bt,S,G,N) in `dtype`; dt (Bt,S,H), A and D (H,),
// init and final_state (Bt,H,P,N) in f32; y like x.  Scratch, every entry
// written before it is read: cs (Bt,H,nc,Q) f64, cbt (Bt,G,nc,Q,Q) f32 and
// states (Bt,H,nc,P,N) f32, nc = ceil(S / chunk).  All contiguous; P and N
// multiples of 8, N <= 128, 1 <= chunk <= 256.  Returns cudaGetLastError()
// after the launches, or -1 for arguments the kernels do not take.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* B, const void* C, const float* D,
                            const float* init, void* y, float* final_state,
                            void* cs, void* cbt, void* states, int Bt, int S,
                            int H, int P, int G, int N, int chunk, int dtype,
                            void* stream) {
  Dims d;
  if (!make_dims(Bt, S, H, P, G, N, chunk, &d)) return -1;
  (void)cudaGetLastError();   // report only these launches' errors
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* csp = static_cast<double*>(cs);
  float* cbp = static_cast<float*>(cbt);
  float* stp = static_cast<float*>(states);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch<float>(x, dt, A, B, C, D, init, y,
                                            final_state, csp, cbp, stp, d, s));
    case kBF16:
      return static_cast<int>(launch<__nv_bfloat16>(x, dt, A, B, C, D, init,
                                                    y, final_state, csp, cbp,
                                                    stp, d, s));
    default:
      return -1;
  }
}
