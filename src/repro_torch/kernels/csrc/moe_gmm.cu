// Grouped matmul (dropless MoE expert compute) for Hopper, sm_90a: K7.
//
// Replaces: src/repro/kernels/moe_gmm/kernel.py::gmm_pallas (_gmm_kernel),
// the TPU kernel behind gmm(backend="pallas").  Same function:
// y[r] = x[r] @ w[e(r)] for x (T,d) with rows sorted by expert, w (E,d,f)
// and group_sizes (E,) int32; f32 accumulation, output in x's dtype; rows
// past sum(group_sizes) come out zero.  The Pallas path pads every group
// to block_m rows on the host side (moe_gmm/ops.py:29-62) and streams all
// E experts' weights whatever the group sizes; this kernel reads the group
// sizes on the card and never touches an empty expert's weights.
//
// What bounds it on an H100: the bytes of the active experts' weights.
// In a decode step of deepseek-moe-16b (T = 24 rows, about 20 distinct
// experts of 64, d 2048, f 1408, bf16) one gate/up call reads about
// 115 MB of weights and does 0.14 GFLOP: about 34 us at the data sheet's
// 3.35 TB/s, against 369 MB (110 us) if every expert were streamed.  In a
// sorted prefill (T = 12,288, all 64 experts) it reads 369 MB and does
// 70.9 GFLOP: 110 us of memory against 72 us of bf16 tensor-core time.
// (Computed, not measured; measured times are in PERF.md.)
//
// Design: one block per (row tile, 64-column tile).  The grid's x extent is
// an upper bound on the row tiles, ceil(T/64) + E: each block scans the E
// group sizes in one warp (shuffle prefix sums, no host sync), finds the
// expert and row range of its tile, and exits if it has none.  Groups are
// cut into 64-row tiles of their own, so a tile never mixes experts, an
// empty expert has no tile, and a 1-row group (the common decode case)
// reads its expert's weights once per column tile.  Rows from the end of
// the last group to T form zero tiles that only store zeros.  The K loop
// streams 32-deep slices of x and w through a ring of shared-memory stages
// with cp.async (rows and columns past the edge are zero-filled, never
// read), so several weight loads are in flight per block.  bf16 multiplies
// on the tensor cores with mma.sync m16n8k16 from ldmatrix fragments (x
// row-major, w through ldmatrix.trans), f32 accumulators; f32 operands,
// which need the full f32 product for the reference's 1e-4, multiply on
// the CUDA cores.  wgmma, TMA and a persistent schedule are later work.
#include "common.cuh"

#include <type_traits>

using namespace repro;

namespace {

constexpr int BM = 64;          // rows per tile
constexpr int BN = 64;          // columns per tile
constexpr int BK = 32;          // depth of one pipeline stage
constexpr int THREADS = 128;    // four warps, 2 x 2 over the tile

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int STAGES = 4;
  static constexpr int PAD = 8;     // 16 B: ldmatrix rows off the same banks
};
template <> struct Tile<float> {
  static constexpr int STAGES = 2;
  static constexpr int PAD = 4;
};

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

// Warp 0 of the block: which tile is `slot`?  Group e holds rows
// [start_e, end_e), the prefix sums of the sizes clamped to [0, T]; it is
// cut into ceil((end_e - start_e) / BM) tiles, numbered in expert order.
// The slots after the groups' tiles cover rows [total, T) with zero tiles.
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
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const int* __restrict__ group_sizes, T* __restrict__ y, int T_rows,
           int d, int f, int E) {
  constexpr int STAGES = Tile<T>::STAGES;
  constexpr int LDA = BK + Tile<T>::PAD;   // x stage: BM x LDA
  constexpr int LDB = BN + Tile<T>::PAD;   // w stage: BK x LDB
  constexpr int VEC = 16 / sizeof(T);      // elements per 16-byte chunk
  // the ring of stages: STAGES x (BM x LDA) of x, then STAGES x (BK x LDB)
  // of w (raw bytes: a __shared__ array of a class type would need a
  // trivial constructor)
  __shared__ __align__(16) unsigned char smem[STAGES * (BM * LDA + BK * LDB) *
                                              sizeof(T)];
  __shared__ TileInfo info;
  T* const As = reinterpret_cast<T*>(smem);
  T* const Bs = As + STAGES * BM * LDA;

  const int tid = threadIdx.x;
  if (tid < 32) find_tile(group_sizes, E, T_rows, blockIdx.x, &info);
  __syncthreads();
  const TileInfo ti = info;
  if (ti.kind == 0) return;
  const int n0 = blockIdx.y * BN;
  if (n0 >= f) return;

  if (ti.kind == 2) {                       // rows past the last group
    for (int i = tid; i < BM * (BN / VEC); i += THREADS) {
      const int r = ti.row0 + i / (BN / VEC);
      const int c = n0 + (i % (BN / VEC)) * VEC;
      if (r < ti.row_end && c < f) {
        *reinterpret_cast<uint4*>(y + static_cast<int64_t>(r) * f + c) =
            make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  const T* wx = w + static_cast<int64_t>(ti.expert) * d * f;
  const int n_k = (d + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    for (int i = tid; i < BM * (BK / VEC); i += THREADS) {
      const int r = i / (BK / VEC);
      const int c = (i % (BK / VEC)) * VEC;
      const int row = ti.row0 + r;
      const bool ok = row < ti.row_end && k0 + c < d;
      const T* src = ok ? x + static_cast<int64_t>(row) * d + k0 + c : x;
      cp_async16(As + stage * BM * LDA + r * LDA + c, src, ok);
    }
    for (int i = tid; i < BK * (BN / VEC); i += THREADS) {
      const int r = i / (BN / VEC);
      const int c = (i % (BN / VEC)) * VEC;
      const bool ok = k0 + r < d && n0 + c < f;
      const T* src = ok ? wx + static_cast<int64_t>(k0 + r) * f + n0 + c : wx;
      cp_async16(Bs + stage * BK * LDB + r * LDB + c, src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }

  const int warp = tid / 32, lane = tid % 32;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // warp (wm, wn) owns rows wm*32.. and columns wn*32.. of the tile:
    // 2 x 4 mma tiles of 16 x 8
    const int wm = warp / 2, wn = warp % 2;
    float acc[2][4][4] = {};
    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int next = kt + STAGES - 1;
      if (next < n_k) load_stage(next % STAGES, next);
      cp_async_commit();
      const T* A = As + (kt % STAGES) * BM * LDA;
      const T* Bt = Bs + (kt % STAGES) * BK * LDB;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        unsigned a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          ldmatrix_x4(a[mi], A + (wm * 32 + mi * 16 + (lane % 16)) * LDA +
                                 ks + (lane / 16) * 8);
        }
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          unsigned r[4];
          ldmatrix_x4_trans(r, Bt + (ks + (lane % 16)) * LDB + wn * 32 +
                                   nj * 16 + (lane / 16) * 8);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
        }
      }
    }
    cp_async_wait<0>();
    const int g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + wn * 32 + ni * 8 + 2 * t4;
        if (c >= f) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = ti.row0 + wm * 32 + mi * 16 + g + 8 * h;
          if (row < ti.row_end) {
            *reinterpret_cast<__nv_bfloat162*>(
                y + static_cast<int64_t>(row) * f + c) =
                __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                      acc[mi][ni][2 * h + 1]);
          }
        }
      }
    }
  } else {
    // f32 on the CUDA cores: thread (ty, tx) owns 8 rows x 4 columns
    const int ty = tid / 16, tx = tid % 16;
    float acc[8][4] = {};
    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int next = kt + STAGES - 1;
      if (next < n_k) load_stage(next % STAGES, next);
      cp_async_commit();
      const T* A = As + (kt % STAGES) * BM * LDA;
      const T* Bt = Bs + (kt % STAGES) * BK * LDB;
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
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* group_sizes,
                   void* y, int T_rows, int d, int f, int E,
                   cudaStream_t stream) {
  const dim3 grid((T_rows + BM - 1) / BM + E, (f + BN - 1) / BN);
  gmm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), group_sizes,
      static_cast<T*>(y), T_rows, d, f, E);
  return cudaGetLastError();
}

}  // namespace

// x (T,d), w (E,d,f), group_sizes (E,) int32 on the device, y (T,f); all
// contiguous, d and f multiples of 8.  Returns cudaGetLastError() after
// the launch, or -1 for arguments the kernel does not take.
extern "C" int moe_gmm_fwd(const void* x, const void* w,
                           const int* group_sizes, void* y, int T_rows, int d,
                           int f, int E, int dtype, void* stream) {
  if (T_rows < 0 || d < 0 || f <= 0 || E < 0 || d % 8 || f % 8) return -1;
  if (T_rows == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch<float>(x, w, group_sizes, y, T_rows, d,
                                            f, E, s));
    case kBF16:
      return static_cast<int>(launch<__nv_bfloat16>(x, w, group_sizes, y,
                                                    T_rows, d, f, E, s));
    default:
      return -1;
  }
}
