// Chunked Mamba2 SSD scan for Hopper, sm_90a: K8.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::ssd_pallas (_ssd_kernel),
// the TPU kernel behind ssd(backend="pallas").  Same function, for each
// (batch b, head h), sequentially over chunks of Q steps, with
// cs = cumsum(dt·A) over the chunk (inclusive):
//   y     = (C·Bᵀ ⊙ L)·(dt·x) + exp(cs)·(C·stateᵀ) + D·x,
//           L[i][j] = exp(cs_i − cs_j) for j <= i, 0 above the diagonal;
//   state ← exp(cs_last)·state + (dt·x·exp(cs_last − cs))ᵀ·B.
// B and C are shared by the heads of a group (g = h / (H/G)).  The math is
// f32 (the chunk's cumulative sums f64); y is stored in x's dtype, the
// final state in f32.  x (Bt,S,H,P),
// dt (Bt,S,H) f32, A and D (H,) f32, B and C (Bt,S,G,N), the initial state
// (Bt,H,P,N) f32.  S need not be a multiple of Q: the steps of the last
// chunk past S are taken as dt = 0 with no input (what the reference's
// padding feeds the Pallas kernel), and their outputs are not stored.
//
// What bounds it on an H100: f32 operations.  At mamba2-130m's prefill
// (Bt 4, S 512, H 24, P 64, N 128, Q 256; bf16 x, B, C) the function
// needs, over the causal half of each chunk, C·Bᵀ once per (batch, group,
// chunk) (0.07 GFLOP on bf16 operands: 0.07 us at 989 TFLOP/s) and, per
// head, its product with dt·x plus the two state terms (2.42 GFLOP of
// f32: 36 us at 67 TFLOP/s outside the tensor cores), against 19.5 MB of
// operands (6 us of memory).  zamba2-1.2b (H 64, N 64): 0.03 + 4.30
// GFLOP, 43 MB, 64 us.  This kernel recomputes C·Bᵀ for every head (1.5
// and 2.1 GFLOP more).  (Computed, not measured; measured times are in
// PERF.md.)
//
// Design: one block per (64 head channels, head, batch), 256 threads, a
// loop over the chunks inside the block in place of the Pallas grid's
// sequential chunk axis.  The block's (64, N) slice of the state stays in
// shared memory across the chunk loop; rows p of the state are
// independent (y[:, p] and state[p, :] need only column p of dt·x), so
// channel tiles never talk to each other.  A chunk of up to 256 steps does
// not fit whole (its Q x Q f32 scores would take 256 KB), so it is cut into
// 64-step tiles: for each query tile, the state term first, then the key
// tiles at or below the diagonal (the ones above are never touched), each
// a 64 x 64 score tile C_i·B_jᵀ that is masked before its exp and then
// multiplied into dt·x_j.  Every output row of a chunk reads the incoming
// state, so the state update comes after all of them: it accumulates in
// registers over the chunk's key tiles and is written back behind a
// barrier.  The chunk's cumulative sums are one warp's shuffle scan, kept
// in f64 in shared memory (see chunk_cumsum).  Each thread owns 4 x 4
// outputs of a tile (rows ty*4+r, columns tx+16c) and reads 16-byte
// vectors along the contracted axis; row strides of N+4 floats keep those
// reads off shared bank conflicts.
// f32 on the CUDA cores; wgmma and TMA are later work.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int QT = 64;          // steps in a query or key tile
constexpr int PT = 64;          // head channels (state rows) per block
constexpr int QMAX = 256;       // longest chunk
constexpr int NMAX = 128;       // widest state
constexpr int NC = NMAX / 16;   // state columns per thread in the update
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDX = PT + 4;     // row stride of the dt·x tile
constexpr int LDS = QT + 4;     // row stride of the score tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// `rows` rows of `width` elements (a multiple of 8) into shared f32 rows
// of stride `ld`, row r from src + r * row_stride, times scale[r] when
// given.  Rows at or past `valid` and columns at or past `width_valid` (a
// multiple of 8) are written as zeros and never read.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t row_stride, int rows,
                                          int valid, int width,
                                          int width_valid,
                                          const float* scale) {
  constexpr int V = Vec16<T>::N;
  const int cpr = width / V;
  for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
    const int r = i / cpr;
    const int col = (i % cpr) * V;
    float v[V];
    if (r < valid && col < width_valid) {
      load16(src + r * row_stride + col, v);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = 0.f;
    }
    const float m = scale != nullptr && r < valid ? scale[r] : 1.f;
#pragma unroll
    for (int k = 0; k < V; ++k) dst[r * ld + col + k] = v[k] * m;
  }
}

// acc[r][c] = sum_k a[(ty*4 + r) * ld + k] * b[(tx + 16c) * ld + k] for
// k < K (a multiple of 4): both operands along the contracted axis.
__device__ __forceinline__ void mm_nt(float acc[4][4], const float* a,
                                      const float* b, int ld, int K, int ty,
                                      int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (ty * 4 + r) * ld + k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b + (tx + 16 * c) * ld + k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[r][c];
        s = fmaf(av[r].x, bv[c].x, s);
        s = fmaf(av[r].y, bv[c].y, s);
        s = fmaf(av[r].z, bv[c].z, s);
        s = fmaf(av[r].w, bv[c].w, s);
        acc[r][c] = s;
      }
  }
}

// acc[r][c] += sum_k a[(ty*4 + r) * lda + k] * b[k * ldb + tx + 16c] for
// k < K (a multiple of 4): b row-major over the contracted axis.
__device__ __forceinline__ void mm_nn(float acc[4][4], const float* a,
                                      int lda, const float* b, int ldb,
                                      int K, int ty, int tx) {
  for (int k = 0; k < K; k += 4) {
    float4 av[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (ty * 4 + r) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = b[(k + kk) * ldb + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ar = kk == 0 ? av[r].x : kk == 1 ? av[r].y
                         : kk == 2 ? av[r].z : av[r].w;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar, bv[c], acc[r][c]);
      }
    }
  }
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dskip,
           const float* __restrict__ init, T* __restrict__ y,
           float* __restrict__ final_state, int S, int H, int P, int G,
           int N, int Q) {
  extern __shared__ float4 smem4[];
  const int ldn = N + 4;
  float* st = reinterpret_cast<float*>(smem4);   // (PT, ldn) state slice
  float* cq = st + PT * ldn;       // (QT, ldn) C of the query tile
  float* bk = cq + QT * ldn;       // (QT, ldn) B of the key tile
  float* xv = bk + QT * ldn;       // (QT, LDX) dt·x of the key tile
  float* sc = xv + QT * LDX;       // (QT, LDS) masked, decayed scores
  float* dts = sc + QT * LDS;      // (QMAX) dt of the chunk
  float* wts = dts + QMAX;         // (QMAX) dt·exp(cs_last − cs)
  double* cs = reinterpret_cast<double*>(wts + QMAX);   // (QMAX) cumsum of dt·A

  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float a = A[h];
  const float dskip = Dskip[h];
  const int pv = min(PT, P - p0);              // this block's channels
  const int64_t xs = static_cast<int64_t>(H) * P;   // step stride of x, y
  const int64_t bs = static_cast<int64_t>(G) * N;   // of B, C
  const int64_t xoff = (static_cast<int64_t>(b) * S * H + h) * P + p0;
  const T* xb = x + xoff;
  T* yb = y + xoff;
  const int64_t boff = (static_cast<int64_t>(b) * S * G + g) * N;
  const T* Bb = Bm + boff;
  const T* Cb = Cm + boff;
  const float* dtb = dt + static_cast<int64_t>(b) * S * H + h;
  const int64_t soff = ((static_cast<int64_t>(b) * H + h) * P + p0) * N;

  for (int i = tid; i < PT * N; i += THREADS) {
    const int p = i / N, n = i % N;
    st[p * ldn + n] = p < pv ? init[soff + static_cast<int64_t>(p) * N + n] : 0.f;
  }

  const int n_tiles = (Q + QT - 1) / QT;
  for (int r0 = 0; r0 < S; r0 += Q) {
    const int qv = min(Q, S - r0);             // steps of the chunk before S
    __syncthreads();                           // the last chunk is done
    for (int i = tid; i < Q; i += THREADS)
      dts[i] = i < qv ? dtb[static_cast<int64_t>(r0 + i) * H] : 0.f;
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, cs, Q, a, tid);
    __syncthreads();
    const double cs_last = cs[Q - 1];
    for (int i = tid; i < Q; i += THREADS)
      wts[i] = dts[i] * expf(static_cast<float>(cs_last - cs[i]));

    // Outputs, one query tile at a time; all of them read the incoming state.
    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = it * QT;
      const int qrows = max(0, min(QT, qv - q0));
      if (qrows == 0) break;                   // the rest lies past S
      __syncthreads();
      load_rows<T>(cq, ldn, Cb + (r0 + q0) * bs, bs, QT, qrows, N, N, nullptr);
      __syncthreads();
      float acc[4][4];
      mm_nt(acc, cq, st, ldn, N, ty, tx);      // C_i · stateᵀ
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = q0 + ty * 4 + r;
        const float e = qi < Q ? expf(static_cast<float>(cs[qi])) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }
      for (int jt = 0; jt <= it; ++jt) {
        const int k0 = jt * QT;
        const int krows = max(0, min(QT, qv - k0));
        __syncthreads();
        load_rows<T>(bk, ldn, Bb + (r0 + k0) * bs, bs, QT, krows, N, N, nullptr);
        load_rows<T>(xv, LDX, xb + (r0 + k0) * xs, xs, QT, krows, PT, pv,
                     dts + k0);
        __syncthreads();
        float s[4][4];
        mm_nt(s, cq, bk, ldn, N, ty, tx);      // C_i · B_jᵀ
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qi = q0 + ty * 4 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int kj = k0 + tx + 16 * c;
            // the mask before the exp: above the diagonal cs_i − cs_j > 0
            sc[(ty * 4 + r) * LDS + tx + 16 * c] =
                kj <= qi && qi < Q
                    ? s[r][c] * expf(static_cast<float>(cs[qi] - cs[kj]))
                    : 0.f;
          }
        }
        __syncthreads();
        mm_nn(acc, sc, LDS, xv, LDX, QT, ty, tx);   // (scores ⊙ L) · dt·x_j
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = q0 + ty * 4 + r;
        if (row >= qv) continue;
        const int64_t off = static_cast<int64_t>(r0 + row) * xs;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < pv) store(yb + off + p, acc[r][c] + dskip * to_f32(xb[off + p]));
        }
      }
    }

    // The state update over the chunk's key tiles, in registers: rows
    // ty*4 + r, columns tx + 16c of the (PT, N) slice.
    float up[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) up[r][c] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int k0 = jt * QT;
      const int krows = max(0, min(QT, qv - k0));
      if (krows == 0) break;
      __syncthreads();
      load_rows<T>(bk, ldn, Bb + (r0 + k0) * bs, bs, QT, krows, N, N, nullptr);
      load_rows<T>(xv, LDX, xb + (r0 + k0) * xs, xs, QT, krows, PT, pv,
                   wts + k0);
      __syncthreads();
      for (int k = 0; k < krows; ++k) {
        const float4 xa = *reinterpret_cast<const float4*>(xv + k * LDX + ty * 4);
        const float xr[4] = {xa.x, xa.y, xa.z, xa.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = tx + 16 * c;
          const float bn = n < N ? bk[k * ldn + n] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) up[r][c] = fmaf(xr[r], bn, up[r][c]);
        }
      }
    }
    // Every output row of the chunk has read the old state (the barriers
    // above), and each thread rewrites only its own entries.
    const float decay = expf(static_cast<float>(cs_last));
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = tx + 16 * c;
        if (n < N) {
          float* e = st + (ty * 4 + r) * ldn + n;
          *e = decay * *e + up[r][c];
        }
      }
  }
  __syncthreads();
  for (int i = tid; i < pv * N; i += THREADS) {
    const int p = i / N, n = i % N;
    final_state[soff + static_cast<int64_t>(p) * N + n] = st[p * ldn + n];
  }
}

int smem_bytes(int N) {
  const int ldn = N + 4;
  return static_cast<int>(sizeof(float)) *
         (PT * ldn + 2 * QT * ldn + QT * LDX + QT * LDS + 4 * QMAX);
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* D,
                   const float* init, void* y, float* final_state, int Bt,
                   int S, int H, int P, int G, int N, int Q,
                   cudaStream_t stream) {
  static int limit[kMaxDevices] = {0};
  const int bytes = smem_bytes(N);
  cudaError_t err = raise_smem_limit(ssd_kernel<T>, bytes, limit);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PT - 1) / PT, H, Bt);
  ssd_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), D, init, static_cast<T*>(y), final_state, S,
      H, P, G, N, Q);
  return cudaGetLastError();
}

}  // namespace

// x (Bt,S,H,P), B and C (Bt,S,G,N) in `dtype`; dt (Bt,S,H), A and D (H,),
// init and final_state (Bt,H,P,N) in f32; y like x.  All contiguous; P and
// N multiples of 8, N <= 128, 1 <= chunk <= 256.  Returns cudaGetLastError()
// after the launch, or -1 for arguments the kernel does not take.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* B, const void* C, const float* D,
                            const float* init, void* y, float* final_state,
                            int Bt, int S, int H, int P, int G, int N,
                            int chunk, int dtype, void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      P % 8 != 0 || N <= 0 || N % 8 != 0 || N > NMAX || chunk < 1 ||
      chunk > QMAX || H > 65535 || Bt > 65535)
    return -1;
  (void)cudaGetLastError();   // report only this launch's error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch<float>(x, dt, A, B, C, D, init, y,
                                            final_state, Bt, S, H, P, G, N,
                                            chunk, s));
    case kBF16:
      return static_cast<int>(launch<__nv_bfloat16>(x, dt, A, B, C, D, init,
                                                    y, final_state, Bt, S, H,
                                                    P, G, N, chunk, s));
    default:
      return -1;
  }
}
