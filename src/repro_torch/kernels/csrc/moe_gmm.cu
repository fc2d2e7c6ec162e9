// Grouped matmul (dropless MoE expert compute) for Hopper, sm_90a: K7.
//
// Replaces: src/repro/kernels/moe_gmm/kernel.py::gmm_pallas (_gmm_kernel),
// the TPU kernel behind gmm(backend="pallas").  Same function:
// y[r] = x[r] @ w[e(r)] for x (T,d) with rows sorted by expert, w (E,d,f)
// and group_sizes (E,) int32; f32 accumulation, output in x's dtype; rows
// past sum(group_sizes) come out zero.  The Pallas path pads every group
// to block_m rows on the host side (moe_gmm/ops.py:29-62) and streams all
// E experts' weights whatever the group sizes; these kernels read the
// group sizes on the card (no host sync, so a decode step stays
// graph-safe) and never touch an empty expert's weights.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 989 bf16 TFLOP/s;
// computed from the shapes, not measured), deepseek-moe-16b in bf16:
//   decode gate/up (T 24, ~20 of 64 experts active, d 2048, f 1408) and
//   decode down (d 1408, f 2048): 115 MB of weights, 0.14 GFLOP, about
//   1.2 FLOP per byte: 34.4 us of memory, the tensor cores idle.
//   sorted prefill (T 12,288, all 64 experts, ~192 rows each): 369 MB of
//   weights + 50 MB of x + 35 MB of y = 454 MB (135.5 us), then 70.9 GFLOP
//   (71.7 us of bf16 tensor-core time); both floors are close, so the
//   kernel has to stream at the memory rate while the tensor cores run.
// Measured times are in PERF.md.
//
// The wrapper (moe_gmm/ops.py::plan) picks one of two bf16 kernels from
// T, d, f and E alone, never from the group sizes: below 64
// rows (a decode step) stream_kernel, from 64 rows on tc_kernel, which was
// the faster of the two at every T from 64 to 12,288 on the H100.
//
//  * stream_kernel (few rows per expert: decode).  Memory-bound, so the
//    design is about bytes in flight, not arithmetic.  One 128-thread
//    block per (16-row tile of one group, 64-column slab); the grid's x
//    extent is a bound on the tiles that T and E allow, min(T, T/16 +
//    min(T, E) + 1), so at decode (T 24) nearly every block has work, and
//    each streams one expert slab (d x 64 weights, 128-byte rows) once,
//    six blocks to an SM.  A block runs a 3-stage cp.async ring of 64-deep
//    stages (8 KB of weights each) whose misses fetch 256 bytes into L2
//    (the neighbouring slab's block reads the other half); rows are not
//    padded to 64: the 16-row x tile feeds mma.sync m16n8k16 (ldmatrix
//    fragments, f32 accumulators), each warp owning 16 columns.  A group of
//    more than 16 rows takes several row tiles, whose blocks sit next to
//    each other and meet the slab in L2.
//  * tc_kernel (many rows per expert: sorted prefill).  Persistent blocks,
//    one per SM, walking work items (256-row tile of one group, 128-column
//    tile) numbered expert by expert, column tile by column tile, so an
//    expert's x rows are read from L2 by the blocks that run its 11 column
//    tiles at the same time.  Each block builds the item list from the
//    group sizes itself (a warp scan into shared memory).  The host
//    encodes x's TMA map on each call and keeps each weight tensor's map,
//    so a call costs one encoding.  Two producer
//    threads fill a 4-stage ring on mbarriers by TMA, 128-byte swizzle:
//    one the x tile (64-row boxes of a 2-D map over (T, d), only the boxes
//    that hold rows of the group; rows of the next group may come with the
//    last box and are never stored), the other the w tile (64 x 128 as two
//    64-column boxes of a 3-D map over (E, d, f), the MN-major B operand).
//    Four consumer warpgroups of 64 rows each issue wgmma m64n128k16 with
//    f32 accumulators in registers; a warpgroup whose rows lie past the
//    group skips the products and only releases the stages.  The epilogue
//    turns each quad's bf16 pairs into 16-byte stores of 8 columns by two
//    shuffle rounds, masked by row, so no tile writes a neighbouring
//    group's rows; tiles past the groups store zeros.  The weights, read
//    once from HBM, set the pace: in a diagnostic run at the prefill shape
//    (one producer; PERF.md) leaving out the w loads cut 32% of the
//    time, the products 7%, the stores 9%.
//
// f32 operands need the full f32 product for the reference's 1e-4, so
// they multiply on the CUDA cores in cc_kernel (this kernel's first
// design): one block per (64-row tile of one group, 64 columns), a
// cp.async ring, each thread 8 rows x 4 columns.
#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

struct TileInfo {
  int kind;       // 0: none (exit), 1: a group's rows, 2: zero rows
  int expert;
  int row0;       // first row of the tile
  int row_end;    // one past its last valid row
};

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Warp 0 of the block: which BM-row tile is `slot`?  Group e holds rows
// [start_e, end_e), the prefix sums of the sizes clamped to [0, T]; it is
// cut into ceil((end_e - start_e) / BM) tiles, numbered in expert order.
// The slots after the groups' tiles cover rows [total, T) with zero tiles.
template <int BM>
__device__ void find_tile(const int* __restrict__ group_sizes, int E, int T,
                          int slot, TileInfo* out) {
  const int lane = threadIdx.x;
  const int per = (E + 31) / 32;
  const int lo = min(lane * per, E), hi = min(lo + per, E);
  long long rows = 0;
  for (int e = lo; e < hi; ++e) rows += max(group_sizes[e], 0);
  // exclusive prefix of the rows before this lane's experts
  long long incl = rows;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  const long long row_base = incl - rows;
  const int total = static_cast<int>(
      min(__shfl_sync(0xffffffffu, incl, 31), static_cast<long long>(T)));
  int tiles = 0;
  long long r = row_base;
  for (int e = lo; e < hi; ++e) {
    const long long n = max(group_sizes[e], 0);
    const int s = static_cast<int>(min(r, static_cast<long long>(T)));
    const int t = static_cast<int>(min(r + n, static_cast<long long>(T)));
    tiles += (t - s + BM - 1) / BM;
    r += n;
  }
  const int tiles_incl = warp_incl_scan(tiles, lane);
  const int tile_base = tiles_incl - tiles;
  const int n_group_tiles = __shfl_sync(0xffffffffu, tiles_incl, 31);
  if (slot >= n_group_tiles) {
    if (lane == 0) {
      const int row0 = total + (slot - n_group_tiles) * BM;
      *out = row0 < T ? TileInfo{2, 0, row0, min(row0 + BM, T)}
                      : TileInfo{0, 0, 0, 0};
    }
    return;
  }
  if (slot < tile_base || slot >= tiles_incl) return;   // another lane's
  int t_at = tile_base;
  r = row_base;
  for (int e = lo; e < hi; ++e) {
    const long long n = max(group_sizes[e], 0);
    const int s = static_cast<int>(min(r, static_cast<long long>(T)));
    const int t = static_cast<int>(min(r + n, static_cast<long long>(T)));
    const int k = (t - s + BM - 1) / BM;
    if (slot < t_at + k) {
      const int row0 = s + (slot - t_at) * BM;
      *out = TileInfo{1, e, row0, t};
      return;
    }
    t_at += k;
    r += n;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;          // 0: fill with zeros, read nothing
  // (the L2 fetches 256 bytes around each miss: the neighbouring blocks
  // read the rest of those weight rows)
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Zeros over rows [row0, row_end) x columns [n0, min(n0 + cols, f)) of y,
// 16 bytes a store, by `threads` threads numbered from `tid`.
template <typename T>
__device__ __forceinline__ void store_zeros(T* __restrict__ y, int f,
                                            int row0, int row_end, int n0,
                                            int cols, int tid, int threads) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = cols / VEC;
  for (int i = tid; i < (row_end - row0) * per_row; i += threads) {
    const int r = row0 + i / per_row;
    const int c = n0 + (i % per_row) * VEC;
    if (c < f) {
      *reinterpret_cast<uint4*>(y + static_cast<int64_t>(r) * f + c) =
          make_uint4(0, 0, 0, 0);
    }
  }
}

// ---- cc_kernel: f32 on the CUDA cores ----

namespace cc {

constexpr int BM = 64;          // rows per tile
constexpr int BN = 64;          // columns per tile
constexpr int BK = 32;          // depth of one pipeline stage
constexpr int THREADS = 128;    // thread (ty, tx) owns 8 rows x 4 columns
constexpr int STAGES = 2;
constexpr int LDA = BK + 4;     // x stage: BM x LDA
constexpr int LDB = BN + 4;     // w stage: BK x LDB

// One block per (64-row tile of one group, 64 columns); the grid's x extent
// is ceil(T/64) + E, a bound on the tiles, and blocks without one exit.
__global__ void __launch_bounds__(THREADS)
cc_kernel(const float* __restrict__ x, const float* __restrict__ w,
          const int* __restrict__ group_sizes, float* __restrict__ y,
          int T_rows, int d, int f, int E) {
  __shared__ __align__(16) float As[STAGES * BM * LDA];
  __shared__ __align__(16) float Bs[STAGES * BK * LDB];
  __shared__ TileInfo info;

  const int tid = threadIdx.x;
  if (tid < 32) find_tile<BM>(group_sizes, E, T_rows, blockIdx.x, &info);
  __syncthreads();
  const TileInfo ti = info;
  if (ti.kind == 0) return;
  const int n0 = blockIdx.y * BN;
  if (n0 >= f) return;

  if (ti.kind == 2) {                       // rows past the last group
    store_zeros(y, f, ti.row0, ti.row_end, n0, BN, tid, THREADS);
    return;
  }

  const float* wx = w + static_cast<int64_t>(ti.expert) * d * f;
  const int n_k = (d + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    for (int i = tid; i < BM * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4);
      const int c = (i % (BK / 4)) * 4;
      const int row = ti.row0 + r;
      const bool ok = row < ti.row_end && k0 + c < d;
      const float* src = ok ? x + static_cast<int64_t>(row) * d + k0 + c : x;
      cp_async16(As + stage * BM * LDA + r * LDA + c, src, ok);
    }
    for (int i = tid; i < BK * (BN / 4); i += THREADS) {
      const int r = i / (BN / 4);
      const int c = (i % (BN / 4)) * 4;
      const bool ok = k0 + r < d && n0 + c < f;
      const float* src =
          ok ? wx + static_cast<int64_t>(k0 + r) * f + n0 + c : wx;
      cp_async16(Bs + stage * BK * LDB + r * LDB + c, src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }

  const int ty = tid / 16, tx = tid % 16;
  float acc[8][4] = {};
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < n_k) load_stage(next % STAGES, next);
    cp_async_commit();
    const float* A = As + (kt % STAGES) * BM * LDA;
    const float* Bt = Bs + (kt % STAGES) * BK * LDB;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(Bt + k * LDB + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = A[(ty * 8 + i) * LDA + k];
        acc[i][0] = fmaf(av, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av, bv.w, acc[i][3]);
      }
    }
    // the next iteration's load overwrites the stage read here only
    // after its __syncthreads
  }
  cp_async_wait<0>();
  const int c = n0 + tx * 4;
  if (c < f) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ti.row0 + ty * 8 + i;
      if (row < ti.row_end) {
        *reinterpret_cast<float4*>(y + static_cast<int64_t>(row) * f + c) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
}

int launch(const void* x, const void* w, const int* group_sizes, void* y,
           int T_rows, int d, int f, int E, cudaStream_t stream) {
  const dim3 grid((T_rows + BM - 1) / BM + E, (f + BN - 1) / BN);
  cc_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), group_sizes,
      static_cast<float*>(y), T_rows, d, f, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cc

// ---- stream_kernel: bf16, few rows per expert (decode) ----

namespace stream {

constexpr int RM = 16;          // rows per tile: one m16 fragment
constexpr int BN = 64;          // columns per block: 128 bytes of a w row
constexpr int BK = 64;          // depth of one stage: 8 KB of weights
constexpr int STAGES = 3;
constexpr int THREADS = 128;    // four warps, 16 columns each
constexpr int LDX = BK + 8;     // padded rows: ldmatrix off the same banks
constexpr int LDW = BN + 8;
constexpr int STAGE_ELEMS = RM * LDX + BK * LDW;

using bf16 = __nv_bfloat16;

// Tiles of one group never mix experts; `gridDim.x` covers every tile.
__global__ void __launch_bounds__(THREADS)
stream_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const int* __restrict__ group_sizes, bf16* __restrict__ y,
              int T_rows, int d, int f, int E) {
  __shared__ __align__(16) bf16 smem[STAGES * STAGE_ELEMS];
  __shared__ TileInfo info;
  const int tid = threadIdx.x;
  if (tid < 32) find_tile<RM>(group_sizes, E, T_rows, blockIdx.x, &info);
  __syncthreads();
  const TileInfo ti = info;
  if (ti.kind == 0) return;
  const int n0 = blockIdx.y * BN;
  if (n0 >= f) return;
  if (ti.kind == 2) {
    store_zeros(y, f, ti.row0, ti.row_end, n0, BN, tid, THREADS);
    return;
  }

  const bf16* wx = w + static_cast<int64_t>(ti.expert) * d * f;
  const int n_k = (d + BK - 1) / BK;
  auto load_stage = [&](int stage, int kt) {
    bf16* Xs = smem + stage * STAGE_ELEMS;
    bf16* Ws = Xs + RM * LDX;
    const int k0 = kt * BK;
    {   // x: 16 rows x 8 chunks, one per thread; rows past the group zero
      const int r = tid / 8, c = (tid % 8) * 8;
      const int row = ti.row0 + r;
      const bool ok = row < ti.row_end && k0 + c < d;
      cp_async16(Xs + r * LDX + c,
                 ok ? x + static_cast<int64_t>(row) * d + k0 + c : x, ok);
    }
#pragma unroll
    for (int i = tid; i < BK * 8; i += THREADS) {   // w: 64 rows x 8 chunks
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = k0 + r < d && n0 + c < f;
      cp_async16(Ws + r * LDW + c,
                 ok ? wx + static_cast<int64_t>(k0 + r) * f + n0 + c : wx, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }
  const int warp = tid / 32, lane = tid % 32;
  float acc[2][4] = {};
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < n_k) load_stage(next % STAGES, next);
    cp_async_commit();
    const bf16* Xs = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* Ws = Xs + RM * LDX;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      unsigned a[4], r[4];
      ldmatrix_x4(a, Xs + (lane % 16) * LDX + ks + (lane / 16) * 8);
      ldmatrix_x4_trans(r, Ws + (ks + (lane % 16)) * LDW + warp * 16 +
                               (lane / 16) * 8);
      const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16(acc[0], a, b0);
      mma_bf16(acc[1], a, b1);
    }
  }
  cp_async_wait<0>();
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int ni = 0; ni < 2; ++ni) {
    const int c = n0 + warp * 16 + ni * 8 + 2 * t4;
    if (c >= f) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ti.row0 + g + 8 * h;
      if (row < ti.row_end) {
        *reinterpret_cast<__nv_bfloat162*>(y + static_cast<int64_t>(row) * f +
                                           c) =
            __floats2bfloat162_rn(acc[ni][2 * h], acc[ni][2 * h + 1]);
      }
    }
  }
}

int launch(const void* x, const void* w, const int* group_sizes, void* y,
           int T_rows, int d, int f, int E, cudaStream_t stream) {
  // a bound on the tiles of any group sizes that sum to at most T: each
  // group adds at most one partial tile, the zero rows one more
  const dim3 grid(min(T_rows, T_rows / RM + min(T_rows, E) + 1),
                  (f + BN - 1) / BN);
  stream_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), group_sizes,
      static_cast<bf16*>(y), T_rows, d, f, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stream

// ---- tc_kernel: bf16, many rows per expert (sorted prefill) ----

namespace tc {

constexpr int BM = 256;               // rows per item: 64 per consumer
constexpr int BN = 128;               // columns per item: two 64-column boxes
constexpr int BK = 64;                // depth of a stage: one 128-byte row
constexpr int STAGES = 4;
constexpr int WG_ROWS = 64;           // rows per consumer warpgroup
constexpr int CONSUMERS = BM / WG_ROWS;
constexpr int THREADS = (CONSUMERS + 1) * 128;   // + the producer warpgroup
constexpr int E_MAX = 256;            // experts the item table holds
constexpr int A_BYTES = BM * BK * 2;  // x tile: four boxes of 64 rows x 128 B
constexpr int B_BYTES = BK * BN * 2;  // w tile: two boxes of 64 rows x 128 B
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int BARS = STAGES * STAGE;
constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;   // + barriers, alignment

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D(64 x 128, f32) (+)= A(64 x 16, smem, K-major) * B(16 x 128, smem,
// MN-major).
__device__ __forceinline__ void wgmma_n128_bmn(float* d, uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The item list, from the group sizes: group e holds rows [row_start[e],
// row_start[e + 1]) (prefix sums clamped to T) and items [item_start[e],
// item_start[e + 1]), ceil(rows / BM) row tiles times NT column tiles,
// numbered column tile by column tile.  Items from item_start[E] on store
// the zero rows [row_start[E], T).
struct Groups {
  int row_start[E_MAX + 1];
  int item_start[E_MAX + 1];
};

struct Item {
  bool zero;
  int expert, row0, row_end, n0;
};

__device__ void build_groups(const int* __restrict__ group_sizes, int E,
                             int T, int NT, Groups* g) {
  const int lane = threadIdx.x % 32;
  int rows = 0, tiles = 0;         // carried over the chunks of 32 experts
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const int n = e < E ? min(max(group_sizes[e], 0), T) : 0;
    const int incl = warp_incl_scan(n, lane);
    const int s = min(rows + incl - n, T), t = min(rows + incl, T);
    const int k = (t - s + BM - 1) / BM;
    const int k_incl = warp_incl_scan(k, lane);
    if (e < E) {
      g->row_start[e] = s;
      g->item_start[e] = (tiles + k_incl - k) * NT;
    }
    rows = min(rows + __shfl_sync(0xffffffffu, incl, 31), T);
    tiles += __shfl_sync(0xffffffffu, k_incl, 31);
  }
  if (lane == 0) {
    g->row_start[E] = rows;
    g->item_start[E] = tiles * NT;
  }
}

__device__ __forceinline__ Item item_at(const Groups& g, int x, int E, int T,
                                        int NT) {
  if (x >= g.item_start[E]) {           // zero rows past the groups
    const int z = x - g.item_start[E];
    const int row0 = g.row_start[E] + (z / NT) * BM;
    return Item{true, 0, row0, min(row0 + BM, T), (z % NT) * BN};
  }
  int lo = 0, hi = E;     // item_start[lo] <= x < item_start[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (g.item_start[mid] <= x) lo = mid; else hi = mid;
  }
  const int tiles = (g.item_start[lo + 1] - g.item_start[lo]) / NT;
  const int local = x - g.item_start[lo];
  return Item{false, lo, g.row_start[lo] + (local % tiles) * BM,
              g.row_start[lo + 1], (local / tiles) * BN};
}

// One item's products for a warpgroup: its 64 rows against n_k tiles of
// the ring, from tile count g of the block's walk (tile k in stage k %
// STAGES).
__device__ __forceinline__ void mainloop(float (&acc)[64], uint32_t base,
                                         uint32_t full, uint32_t empty,
                                         int g, int n_k, int wg, int lane) {
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = (g + kt) % STAGES;
    mbar_wait(full + 8 * s, ((g + kt) / STAGES) & 1);
    const uint32_t a = base + s * STAGE + wg * WG_ROWS * 128;
    const uint32_t b = base + s * STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_n128_bmn(acc, smem_desc(a + kk * 32, 16, 1024),
                     smem_desc(b + kk * 16 * 128, BK * 128, 1024),
                     kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();          // the previous tile's products are done
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((g + kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs<64>(acc);
  if (n_k > 0 && lane == 0) mbar_arrive(empty + 8 * ((g + n_k - 1) % STAGES));
}

// Accumulator layout of a 64 x 128 wgmma result in a warpgroup: thread
// (warp w, lane l) holds rows 16w + l/4 and + 8; element 4j + 2i + c is row
// + 8i, column 8j + 2(l%4) + c.
__global__ void __launch_bounds__(THREADS, 1)
tc_kernel(const __grid_constant__ CUtensorMap x_map,
          const __grid_constant__ CUtensorMap w_map,
          const int* __restrict__ group_sizes, bf16* __restrict__ y,
          int T_rows, int d, int f, int E) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Groups groups;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + BARS;            // STAGES barriers each
  const uint32_t empty = full + 8 * STAGES;
  const int NT = (f + BN - 1) / BN;
  const int n_k = (d + BK - 1) / BK;

  const int tid = threadIdx.x;
  if (tid < 32) build_groups(group_sizes, E, T_rows, NT, &groups);
  if (tid == 32) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 2);                  // both producers
      mbar_init(empty + 8 * s, CONSUMERS * 4);     // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_items = groups.item_start[E] +
      ((T_rows - groups.row_start[E] + BM - 1) / BM) * NT;

  const int wg = tid / 128;
  if (wg == CONSUMERS) {
    // producers: lane 0 of warp 0 loads the x tiles, lane 0 of warp 1
    // the w tiles, each into its part of the stage and each running ahead
    // into the block's next items
    const int role = (tid % 128) / 32;
    if (tid % 32 != 0 || role > 1) return;
    int g = 0;
    for (int x = blockIdx.x; x < n_items; x += gridDim.x) {
      const Item it = item_at(groups, x, E, T_rows, NT);
      if (it.zero) continue;
      // x in 64-row boxes, only those that hold rows of the group
      const int boxes = min(BM, it.row_end - it.row0 + 63) / 64;
      for (int kt = 0; kt < n_k; ++kt, ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty + 8 * s, ((g / STAGES) - 1) & 1);
        const uint32_t dst = base + s * STAGE;
        if (role == 0) {
          mbar_expect_tx(full + 8 * s, boxes * 64 * 128);
          for (int i = 0; i < boxes; ++i) {
            tma_load(dst + i * 64 * 128, &x_map, full + 8 * s, kt * BK,
                     it.row0 + i * 64);
          }
        } else {
          mbar_expect_tx(full + 8 * s, B_BYTES);
          tma_load(dst + A_BYTES, &w_map, full + 8 * s, it.n0, kt * BK,
                   it.expert);
          tma_load(dst + A_BYTES + BK * 128, &w_map, full + 8 * s,
                   it.n0 + 64, kt * BK, it.expert);
        }
      }
    }
  } else {
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    int g = 0;
    for (int x = blockIdx.x; x < n_items; x += gridDim.x) {
      const Item it = item_at(groups, x, E, T_rows, NT);
      if (it.zero) {
        store_zeros(y, f, it.row0, it.row_end, it.n0, BN, tid,
                    CONSUMERS * 128);
        continue;
      }
      const int row0 = it.row0 + wg * WG_ROWS;   // the warpgroup's first row
      float acc[64];
      // (one instance of the products: with a second one behind another
      // branch, ptxas built wrong code; PERF.md)
      if (row0 < it.row_end) {
        mainloop(acc, base, full, empty, g, n_k, wg, lane);
      } else {
        // no row of the group: release each stage once it has landed
        for (int kt = 0; kt < n_k; ++kt) {
          const int s = (g + kt) % STAGES;
          mbar_wait(full + 8 * s, ((g + kt) / STAGES) & 1);
          if (lane == 0) mbar_arrive(empty + 8 * s);
        }
      }
      g += n_k;
      if (row0 >= it.row_end) continue;
      // epilogue: 16-byte stores of the group's rows, columns below f.
      // Lane t of a quad holds columns 8j + 2t, + 1 of its row for each j;
      // the quad transposes each 4 x 4 block of bf16 pairs (j = 4m..4m+3)
      // by two shuffle rounds, so that lane t holds the 8 columns of
      // j = 4m + t and the quad writes 64 contiguous bytes of the row.
      const int t = lane % 4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + warp * 16 + lane / 4 + 8 * i;
#pragma unroll
        for (int m = 0; m < BN / 32; ++m) {
          uint32_t b[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * m + k;
            b[k] = pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
          }
#pragma unroll
          for (int sh = 1; sh <= 2; sh <<= 1) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (k & sh) continue;
              const uint32_t send = (t & sh) ? b[k] : b[k ^ sh];
              const uint32_t recv = __shfl_xor_sync(0xffffffffu, send, sh);
              if (t & sh) b[k] = recv; else b[k ^ sh] = recv;
            }
          }
          const int c = it.n0 + 32 * m + 8 * t;
          if (row < it.row_end && c < f) {
            *reinterpret_cast<uint4*>(y + static_cast<int64_t>(row) * f + c) =
                make_uint4(b[0], b[1], b[2], b[3]);
          }
        }
      }
    }
  }
}

// A 2-D or 3-D map over a contiguous bf16 tensor, innermost dimension
// first, with a box of 64 columns (128 bytes, 128-byte swizzle) by `rows`;
// elements outside the tensor read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, int rows) {
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weight map of each (pointer, E, d, f) launched on, so that a call
// encodes only x's map.  A map holds nothing but the address, the shape
// and the box, so an entry stays right after its tensor is freed and
// another of the same shape takes the address.  Direct-mapped by a hash of
// the address; a clash encodes again.
struct WeightMap {
  const void* ptr;
  int E, d, f;
  CUtensorMap map;
};
constexpr int W_MAPS = 256;

bool weight_map(EncodeTiled encode, const void* w, int E, int d, int f,
                CUtensorMap* out) {
  static WeightMap cache[W_MAPS] = {};
  static std::mutex mu;      // the runtime's threads call concurrently
  const uint64_t h = (reinterpret_cast<uintptr_t>(w) >> 4) *
                     0x9E3779B97F4A7C15ull;
  WeightMap& slot = cache[h >> 56];
  const std::lock_guard<std::mutex> lock(mu);
  if (slot.ptr != w || slot.E != E || slot.d != d || slot.f != f) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(f),
                                static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(E)};
    slot.ptr = nullptr;
    if (!make_map(encode, &slot.map, w, 3, dims, BK)) return false;
    slot.ptr = w;
    slot.E = E;
    slot.d = d;
    slot.f = f;
  }
  *out = slot.map;
  return true;
}

int launch(const void* x, const void* w, const int* group_sizes, void* y,
           int T_rows, int d, int f, int E, cudaStream_t stream) {
  // boxes of 64 x 64 must fit in the tensors
  if (E < 1 || E > E_MAX || T_rows < 64 || d < BK || f < 64) return -3;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(T_rows)};
  if (!make_map(encode, &x_map, x, 2, x_dims, 64) ||
      !weight_map(encode, w, E, d, f, &w_map)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int smem_limit[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(tc_kernel, BYTES, smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;               // persistent blocks: one per SM
  err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  tc_kernel<<<sms, THREADS, BYTES, stream>>>(
      x_map, w_map, group_sizes, static_cast<bf16*>(y), T_rows, d, f, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// x (T,d), w (E,d,f), group_sizes (E,) int32 on the device, y (T,f); all
// contiguous and 16-byte aligned, d and f multiples of 8.  f32 runs on the
// CUDA cores; bf16 on the kernel `regime` names (0 stream_kernel, 1
// tc_kernel), each sizing its own grid.  Returns cudaGetLastError() after
// the launch, or a negative code for arguments the kernels do not take (-1
// shape, dtype or regime, -3 a shape tc_kernel does not take, -4 an
// operand not 16-byte aligned).
extern "C" int moe_gmm_fwd(const void* x, const void* w,
                           const int* group_sizes, void* y, int T_rows, int d,
                           int f, int E, int dtype, int regime, void* stream) {
  if (T_rows < 0 || d < 0 || f <= 0 || E < 0 || d % 8 || f % 8) return -1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(group_sizes) |
       reinterpret_cast<uintptr_t>(y)) % 16) {
    return -4;
  }
  (void)cudaGetLastError();   // report only this launch's error
  if (T_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return cc::launch(x, w, group_sizes, y, T_rows, d, f, E, s);
  }
  if (dtype != kBF16) return -1;
  switch (regime) {
    case 0:
      return stream::launch(x, w, group_sizes, y, T_rows, d, f, E, s);
    case 1:
      return tc::launch(x, w, group_sizes, y, T_rows, d, f, E, s);
    default:
      return -1;
  }
}
