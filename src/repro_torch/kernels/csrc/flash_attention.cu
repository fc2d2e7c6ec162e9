// Flash attention forward (causal or full, GQA) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (_flash_kernel), the TPU kernel behind flash_attention(backend="pallas").
// Same function: q (B,Sq,H,D), k/v (B,Sk,K,D) -> (B,Sq,H,D) in q's dtype;
// query head h reads KV head h / (H/K); query row i sits at absolute
// position q_offset + i; masked scores are -1e30; online softmax with f32
// running max, sum and accumulator; a row whose sum is 0 gives 0.  As in the
// Pallas kernel (kernel.py:47) the scale is applied in f32, never rounded
// into q; the XLA path instead rounds q*scale to q's dtype (ops.py:94).
//
// Two kernels, chosen by dtype and head dim in the C entry point before
// launch (never after a failure):
//
//  * flash_tc_kernel: bf16 at D 64 and D 128, the head widths of every
//    served model (qwen1.5-0.5b and zamba2-1.2b D 64, deepseek-moe-16b
//    D 128).  Tensor cores, TMA, warp-specialised; described below.
//  * flash_fwd_kernel: f32 at every D (the 2e-5 f32 tolerance rules out
//    TF32) and bf16 at D 16 and 32 (no model's width).  f32 on the CUDA
//    cores, one block per (64-query tile, head, batch), 32-key chunks
//    staged in shared memory as f32; described above the kernel.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 989 bf16 TFLOP/s;
// computed, not measured), bf16, causal, q_offset 0, B 4, Sq = Sk = 512:
//   H 16, D 64  (qwen1.5-0.5b prefill)      16.8 MB, 2.15 GFLOP: 5.01 us (bytes)
//   H 16, D 128 (deepseek-moe-16b prefill)  33.6 MB, 4.30 GFLOP: 10.0 us (bytes)
//   H 32, D 64  (zamba2-1.2b shared block)  33.6 MB, 4.30 GFLOP: 10.0 us (bytes)
// Memory sets the floor at these shapes, against ~2-4 us of tensor-core
// time; measured times are in PERF.md.
//
// What held the CUDA-core kernel back at those shapes, and what the
// tensor-core kernel does about it:
//  * f32 arithmetic on the CUDA cores (a 32 us floor at the qwen shape by
//    the 67 TFLOP/s f32 rate alone): S = Q.K^T and O += P.V run as
//    wgmma m64nNk16 bf16 products with f32 accumulators in registers.
//  * operands widened to f32 in shared memory by synchronous loads: K and
//    V tiles stay bf16 and arrive by TMA into a 4-stage ring guarded by
//    mbarriers, issued by one producer thread while the consumers compute;
//    128-byte swizzle (a D 128 row is loaded as two 64-column boxes).
//  * a key per lane, two warp-wide reductions per row and three block
//    barriers per chunk: each accumulator row lives in the 4 threads of a
//    quad, so its max and sum take two shuffles each; blocks synchronise
//    only through the mbarriers.
//  * P.V as scalar FMAs out of shared memory: P is rounded to bf16 in
//    registers and is the register A operand of the second wgmma (one
//    bf16 rounding per probability that the f32 kernel does not make).
//
// Tensor-core design.  Persistent blocks, one per SM, each walking a share
// of the work items (128-query tile, head, batch), heaviest causal tile
// first, in a snake over the rounds so that every block gets about the
// same number of KV tiles.  A block has two consumer warpgroups of 64
// query rows and one producer warpgroup, which gives its registers to the
// consumers (setmaxnreg 56 / 224) and whose first thread issues every TMA
// load: Q into one of two buffers, so the next item's Q arrives while the
// current one is finished, and K and V tiles (128 keys at D 64, 64 at D
// 128, where a 128-key tile's scores would not fit beside the 64 x 128
// accumulator) on barriers of their own.  Each consumer issues tile t's
// Q.K^T together with tile t-1's P.V and waits for Q.K^T alone, so the
// softmax of tile t runs while the tensor cores finish P.V; at D 64 the two
// consumers also take turns to issue (ping-pong), so one's products run
// during the other's softmax.  The scale, with log2(e) folded in, is
// applied in f32 after the product (on a tile with no masked key, inside
// the FMA before the exp); the causal and tail masks are applied by
// position before the exp, only on tiles that cross the diagonal or the
// end of the keys; the exp is the SFU's ex2.approx.  The softmax's
// instructions, not the tensor cores or the memory, set the pace at the
// served shapes: each change that cut them (the exp, the scale, the
// ping-pong) paid, deeper prefetch did not.  A warpgroup skips the tiles
// above its last query position and an item stops at the last tile its
// last row can see.  TMA
// zero-fills rows past Sq/Sk (its maps are 4-D over (D, heads, S, B), so a
// tile never reads the next batch); the scores are still masked by
// position, and the epilogue writes O / l (l == 0 -> 1) as bf16 for the
// rows below Sq.  The maps are encoded on the host in the entry point,
// with cuTensorMapEncodeTiled found through the runtime's
// cudaGetDriverEntryPoint: no driver library is linked.  The operands
// must be 16-byte aligned, as TMA needs (the wrapper checks it).
//
// Softmax statistics (training).  Given a (B, H, Sq) f32 buffer `lse`,
// both kernels also write each row's log-sum-exp of its scaled, masked
// scores in natural-log units, m + log(l), at their epilogue: the
// residual the reference's flash backward recomputes each tile's
// probabilities from (ops.py:130-173), read there as exp(s - lse).  The
// tensor-core kernel keeps its running max in log2 units (the scale
// carries log2 e), so it stores m * ln 2 + log(l).  A row with no valid
// key (l == 0) stores -1e30: exp(s - lse) then gives 1 on its masked
// keys, as the reference's m = -1e30, l_safe = 1 does.  Serving passes
// null and nothing is stored; the tensor-core kernel is then the instance
// compiled without the store (with it, the serving shapes ran 2-5% slower
// on an H100; PERF.md).
#include "common.cuh"
#include "hopper.cuh"   // mbarriers, TMA, wgmma descriptors, encode_tiled,
                        // sm_count

using namespace repro;

namespace {

// ---- the CUDA-core kernel: f32 at every D, bf16 at D 16 and 32 ----
//
// One block per (64-query tile, head, batch).  The Pallas grid's
// sequential KV axis becomes a loop inside the block over 32-key chunks,
// stopping at the last chunk the causal limit reaches, so each block
// streams its K/V once and keeps the running max, sum and accumulator on
// chip.  Every chunk is staged in shared memory as f32 through 16-byte
// loads; lane j of a warp owns key j of the chunk (its row in registers)
// and each warp scores 8 query rows, reducing max and sum by shuffles.
// The probability tile then meets V in shared memory, each thread owning
// 4 columns of D/16 rows of the f32 accumulator.  Ragged edges (Sq, Sk not
// multiples of the tiles) are masked from the true lengths; the TPU's
// (8,128) padding is not carried over and the kernel allocates nothing.

constexpr int BQ = 64;        // query rows per block
constexpr int TK = 32;        // keys per chunk: one per lane
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;
constexpr int LDP = TK + 1;   // padded probability rows

template <int D>
constexpr int smem_floats() {
  return BQ * D + TK * (D + 4) + TK * D + BQ * LDP + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int K,
                 int causal, int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LDK = D + 4;   // lanes read distinct rows: pad off the banks
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x D, pre-scaled
  float* Ks = Qs + BQ * D;                       // TK x LDK
  float* Vs = Ks + TK * LDK;                     // TK x D
  float* Ps = Vs + TK * D;                       // BQ x LDP
  float* row_m = Ps + BQ * LDP;
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int64_t q_stride = static_cast<int64_t>(H) * D;    // between rows
  const int64_t kv_stride = static_cast<int64_t>(K) * D;
  const T* qb = q + (static_cast<int64_t>(b) * Sq + q0) * q_stride +
                static_cast<int64_t>(h) * D;
  const T* kb = k + static_cast<int64_t>(b) * Sk * kv_stride +
                static_cast<int64_t>(kh) * D;
  const T* vb = v + static_cast<int64_t>(b) * Sk * kv_stride +
                static_cast<int64_t>(kh) * D;
  T* ob = out + (static_cast<int64_t>(b) * Sq + q0) * q_stride +
          static_cast<int64_t>(h) * D;

  const int q_rows = min(BQ, Sq - q0);
  load_tile<T, D>(Qs, D, qb, q_stride, BQ, q_rows, scale);
  for (int r = tid; r < BQ; r += THREADS) {
    row_m[r] = kNegInf;
    row_l[r] = 0.f;
  }

  // accumulator ownership: column group dg (4 columns), rows rg + i*RG
  constexpr int DG = D / 4;
  constexpr int RG = THREADS / DG;
  constexpr int RPT = BQ / RG;
  const int dg = tid % DG;
  const int rg = tid / DG;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // keys past the last query position of this tile are masked for every
  // row: stop there (the Pallas kernel's `needed` test, kernel.py:42-43)
  int kv_end = Sk;
  if (causal) kv_end = max(0, min(Sk, q_offset + q0 + q_rows));

  for (int c0 = 0; c0 < kv_end; c0 += TK) {
    __syncthreads();   // previous chunk fully read; Q and row state visible
    const int valid = min(TK, kv_end - c0);
    load_tile<T, D>(Ks, LDK, kb + c0 * kv_stride, kv_stride, TK, valid, 1.f);
    load_tile<T, D>(Vs, D, vb + c0 * kv_stride, kv_stride, TK, valid, 1.f);
    __syncthreads();

    float kreg[D];
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 t = *reinterpret_cast<const float4*>(Ks + lane * LDK + d);
      kreg[d] = t.x; kreg[d + 1] = t.y; kreg[d + 2] = t.z; kreg[d + 3] = t.w;
    }
    const int kpos = c0 + lane;
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      float s = dot_row<D>(Qs + r * D, kreg);
      if (kpos >= Sk || (causal && kpos > q_offset + q0 + r)) s = kNegInf;
      const float m_prev = row_m[r];
      const float m_cur = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_cur);
      const float p_sum = warp_sum(p);
      Ps[r * LDP + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_cur);
        row_c[r] = corr;
        row_m[r] = m_cur;
        row_l[r] = row_l[r] * corr + p_sum;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float c = row_c[rg + i * RG];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= c;
    }
    for (int t = 0; t < TK; ++t) {
      const float4 vv = *reinterpret_cast<const float4*>(Vs + t * D + dg * 4);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(rg + i * RG) * LDP + t];
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + i * RG;
    if (r < q_rows) {
      const float l_row = row_l[r];
      const float l = (l_row == 0.f) ? 1.f : l_row;
#pragma unroll
      for (int e = 0; e < 4; ++e) store(ob + r * q_stride + dg * 4 + e, acc[i][e] / l);
      if (lse != nullptr && dg == 0) {
        lse[(static_cast<int64_t>(b) * H + h) * Sq + q0 + r] =
            l_row == 0.f ? kNegInf : row_m[r] + logf(l_row);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Sq, int Sk, int H, int K, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  static int smem_limit[kMaxDevices] = {};
  const size_t smem = smem_floats<D>() * sizeof(float);
  const cudaError_t err = raise_smem_limit(flash_fwd_kernel<T, D>,
                                           static_cast<int>(smem), smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, H, K,
      causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Sk, int H, int K, int causal,
             int q_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    default: return -1;
  }
}

}  // namespace


// ---- the tensor-core kernel: bf16, D 64 and D 128 ----

namespace tc {

constexpr int BM = 128;               // query rows per block
constexpr int CONSUMERS = 2;          // warpgroups of 64 query rows
constexpr int THREADS = (CONSUMERS + 1) * 128;   // + the producer warpgroup
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;    // 56 * 128 + 224 * 256 = 168 * 384
constexpr int BOX = 64;               // columns per TMA box: one 128-byte row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory in bytes, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): two Q buffers (BM x D), then
// STAGES K tiles and STAGES V tiles (BN x D each), each stored as D / 64
// boxes of rows x 128 bytes; then the barriers.
template <int D>
struct Smem {
  // keys per K/V tile: 128 at D 64; 64 at D 128, where a 128-key tile's
  // scores, probabilities and the 64 x 128 accumulator would not fit in
  // the consumers' registers together
  static constexpr int BN = D == 64 ? 128 : 64;
  static constexpr int STAGES = 4;
  static constexpr int Q = BM * D * 2;
  static constexpr int KV = BN * D * 2;
  static constexpr int BARS = 2 * Q + 2 * STAGES * KV;
  static constexpr int BYTES = BARS + (3 * STAGES + 6) * 8 + 1024;
};

// 2^x by the SFU alone (relative error ~2^-22, results below 2^-126 flush
// to 0): exp2f adds a range fix-up that the softmax does not need.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D(64 x 128, f32) (+)= A(64 x 16, smem) * B(16 x 128, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                               int accumulate) {
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// D(64 x 64, f32) += A(64 x 16, registers) * B(16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D(64 x 128, f32) += A(64 x 16, registers) * B(16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D(64 x 64, f32) (+)= A(64 x 16, smem) * B(16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, accumulate);
  } else {
    wgmma_ss_n128(d, a, b, accumulate);
  }
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, b, 1);
  } else {
    wgmma_rs_n128(o, a, b, 1);
  }
}

// S = Q . K^T for one warpgroup: 64 x BN in f32 from its 64 rows of Q and
// a K tile, D / 16 steps of 16 columns (32 bytes within a 128-byte row,
// then the next 64-column box).
template <int D>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t q_wg,
                                         uint32_t k_tile) {
  constexpr int BN = Smem<D>::BN;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    wgmma_qk<BN>(sc, smem_desc(q_wg + (kk / 4) * BM * 128 + step, 16, 1024),
                 smem_desc(k_tile + (kk / 4) * BN * 128 + step, 16, 1024),
                 kk > 0);
  }
}

// O += P . V: BN / 16 steps of 16 keys (2048 bytes of the V tile); V is
// MN-major (D contiguous), its two 64-column boxes BN * 128 bytes apart.
template <int D>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*pa)[4],
                                         uint32_t v_tile) {
  constexpr int BN = Smem<D>::BN;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    wgmma_pv<D>(o, pa[kk], smem_desc(v_tile + kk * 16 * 128, BN * 128, 1024));
  }
}

// One tile's online softmax on the f32 scores `sc` (rows r and r + 8 of
// the accumulator layout below): scale (log2 e folded in), mask by
// position where the tile crosses the diagonal or the end of the keys,
// update the running max m and this thread's share of the sum l, and
// return each row's correction of the accumulator in corr.  Leaves the
// probabilities in sc.  On a tile with no masked key and a positive scale
// the max is taken on the raw scores and the scale rides in the FMA before
// each exp (max commutes with a positive scale), saving a multiply per
// score; elsewhere the scores are scaled first, then masked.
template <int BN>
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l,
                                             float* corr, int kv0, int r,
                                             int row0, int lane, int Sk,
                                             int causal, int q_offset,
                                             float scale_log2) {
  const bool masked =
      kv0 + BN > Sk || (causal && kv0 + BN - 1 > q_offset + row0);
  const bool fused = !masked && scale_log2 > 0.f;
  if (!fused) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sc[e] *= scale_log2;
  }
  if (masked) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = kv0 + 8 * j + 2 * (lane % 4) + c;
          if (kpos >= Sk || (causal && kpos > q_offset + r + 8 * i)) {
            sc[4 * j + 2 * i + c] = kNegInf;
          }
        }
      }
    }
  }
  const float mul = fused ? scale_log2 : 1.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {          // each row's max and sum over the quad
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m[i], mx * mul);
    corr[i] = fast_exp2(m[i] - mx);
    m[i] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = fast_exp2(fmaf(sc[4 * j + 2 * i + c], mul, -mx));
        sc[4 * j + 2 * i + c] = p;
        sum += p;
      }
    }
    l[i] = l[i] * corr[i] + sum;
  }
}

// P in bf16 pairs, the register A fragments of P.V, and O rescaled.
template <int D>
__device__ __forceinline__ void pack_and_rescale(uint32_t (*pa)[4],
                                                 const float* sc, float* o,
                                                 const float* corr) {
  constexpr int BN = Smem<D>::BN;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= corr[i];
      o[4 * j + 2 * i + 1] *= corr[i];
    }
  }
}

// One work item: a 128-query tile of one head and batch.  Items are
// numbered heaviest causal tile first; block `blk` of `grid` takes items
// blk, 2 grid - 1 - blk, 2 grid + blk, ... (a snake over the rounds), so
// each block's sum of KV tiles stays near the mean.
struct Item {
  int x, qt, h, b, q0, n_kv;
};

template <int BN>
__device__ __forceinline__ Item item_at(int j, int Sq, int Sk, int H, int B,
                                        int causal, int q_offset) {
  const int grid = gridDim.x;
  const int blk = blockIdx.x;
  Item it;
  it.x = j * grid + ((j & 1) ? grid - 1 - blk : blk);
  const int n_qt = (Sq + BM - 1) / BM;
  it.qt = n_qt - 1 - it.x / (H * B);
  it.h = it.x % H;
  it.b = (it.x / H) % B;
  it.q0 = it.qt * BM;
  const int q_rows = min(BM, Sq - it.q0);
  // keys past the last query position of this tile are masked for every
  // row: stop there (the Pallas kernel's `needed` test, kernel.py:42-43)
  const int kv_end = causal ? max(0, min(Sk, q_offset + it.q0 + q_rows)) : Sk;
  it.n_kv = (kv_end + BN - 1) / BN;
  return it;
}

// Accumulator layout of a 64 x N wgmma result in a warpgroup: thread
// (warp w, lane l) holds rows r = 16w + l/4 and r + 8; element 4j + 2i + c
// is row r + 8i, column 8j + 2(l%4) + c.  The same layout, taken 16
// columns at a time and packed in bf16 pairs, is the register A fragment
// of the next wgmma: that is how P goes from the scores to P.V.  STATS
// adds the log-sum-exp store to the epilogue; serving's instance, without
// it, is compiled as it was before the store existed.
template <int D, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Sq, int Sk, int H, int K, int B, int causal, int q_offset,
                float scale_log2) {
  using S = Smem<D>;
  constexpr int BN = S::BN;
  constexpr int STAGES = S::STAGES;
  constexpr int HALVES = D / BOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                     // two Q buffers
  const uint32_t k_s = base + 2 * S::Q;
  const uint32_t v_s = k_s + STAGES * S::KV;
  const uint32_t k_full = base + S::BARS;        // STAGES barriers each
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;
  const uint32_t q_full = empty + 8 * STAGES;    // two barriers each
  const uint32_t q_empty = q_full + 16;
  const uint32_t turn = q_empty + 16;            // one per consumer warpgroup
  const int n_items = ((Sq + BM - 1) / BM) * H * B;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);   // every consumer warp
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full + 8 * qb, 1);
      mbar_init(q_empty + 8 * qb, CONSUMERS * 4);
      mbar_init(turn + 8 * qb, 4);               // the other warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full, running ahead into the
    // block's next item while the consumers finish the current one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS * 128) {
      int g = 0;                                 // the block's KV tiles so far
      for (int j = 0;; ++j) {
        const Item it = item_at<BN>(j, Sq, Sk, H, B, causal, q_offset);
        if (it.x >= n_items) break;
        const int kh = it.h / (H / K);
        const int qb = j & 1;
        if (j >= 2) mbar_wait(q_empty + 8 * qb, ((j >> 1) - 1) & 1);
        mbar_expect_tx(q_full + 8 * qb, S::Q);
        for (int c = 0; c < HALVES; ++c) {
          tma_load(q_s + qb * S::Q + c * BM * 128, &q_map, q_full + 8 * qb,
                   c * BOX, it.h, it.q0, it.b);
        }
        for (int t = 0; t < it.n_kv; ++t, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(empty + 8 * s, ((g / STAGES) - 1) & 1);
          // K and V on barriers of their own: Q.K^T need not wait for V
          mbar_expect_tx(k_full + 8 * s, S::KV);
          for (int c = 0; c < HALVES; ++c) {
            tma_load(k_s + s * S::KV + c * BN * 128, &k_map, k_full + 8 * s,
                     c * BOX, kh, t * BN, it.b);
          }
          mbar_expect_tx(v_full + 8 * s, S::KV);
          for (int c = 0; c < HALVES; ++c) {
            tma_load(v_s + s * S::KV + c * BN * 128, &v_map, v_full + 8 * s,
                     c * BOX, kh, t * BN, it.b);
          }
        }
      }
    }
  } else {
    // consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    // Ping-pong at D 64: the two warpgroups take turns to issue their
    // wgmmas, one turn per KV tile of an item and one for its last P.V, so
    // the tensor cores run one warpgroup's products while the other runs
    // its softmax.  At D 128 (64-key tiles) warpgroup 0 often has a tile
    // fewer than warpgroup 1, and the turns cost more than they gain.
    constexpr bool PINGPONG = D == 64;
    int turns = 0;
    auto take_turn = [&] {
      if constexpr (PINGPONG) mbar_wait(turn + 8 * wg, turns & 1);
    };
    auto pass_turn = [&] {
      if constexpr (PINGPONG) {
        if (lane == 0) mbar_arrive(turn + 8 * (1 - wg));
        ++turns;
      }
    };
    if (PINGPONG && wg == 1 && lane == 0) mbar_arrive(turn);   // 0 goes first
    int g = 0;
    for (int j = 0;; ++j) {
      const Item it = item_at<BN>(j, Sq, Sk, H, B, causal, q_offset);
      if (it.x >= n_items) break;
      const int qb = j & 1;
      const int n_kv = it.n_kv;
      const int row0 = it.q0 + wg * 64;             // the warpgroup's first row
      const int r = row0 + warp * 16 + lane / 4;    // this thread's rows r, r + 8
      const bool active = row0 < Sq;
      const int last_pos = q_offset + min(row0 + 63, Sq - 1);
      float o[D / 2];
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};    // this thread's share of the row sums
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      // tiles this warpgroup needs: those up to its last query position (a
      // tile wholly above it adds nothing: p = 0, correction 1)
      const int n_w = !active ? 0
                    : !causal ? n_kv
                    : last_pos < 0 ? 0 : min(n_kv, last_pos / BN + 1);
      const uint32_t q_wg = q_s + qb * S::Q + wg * 64 * 128;
      float sc[BN / 2];               // this tile's scores, then probabilities
      uint32_t pa[BN / 16][4];        // the previous tile's P in bf16
      float corr[2];
      mbar_wait(q_full + 8 * qb, (j >> 1) & 1);

      // Tile t's Q.K^T is issued together with tile t-1's P.V; the wait
      // returns when Q.K^T is done, so tile t's softmax runs while the
      // tensor cores still work on P.V.  Then O is rescaled, P repacked
      // and tile t-1's stage released.  Tile 0 (Q.K^T alone) and the last
      // P.V are peeled off, so no wgmma sits on a branch inside the loop
      // (ptxas serialises every wgmma of a kernel where one does).
      if (n_w > 0) {
        mbar_wait(k_full + 8 * (g % STAGES), (g / STAGES) & 1);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) sc[e] = 0.f;
        fence_regs<BN / 2>(sc);
        take_turn();
        wgmma_fence();
        issue_qk<D>(sc, q_wg, k_s + (g % STAGES) * S::KV);
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        fence_regs<BN / 2>(sc);
        softmax_tile<BN>(sc, m, l, corr, 0, r, row0, lane, Sk, causal,
                         q_offset, scale_log2);
        pack_and_rescale<D>(pa, sc, o, corr);

        for (int t = 1; t < n_w; ++t) {
          const int s = (g + t) % STAGES;
          const int sp = (g + t - 1) % STAGES;
          mbar_wait(k_full + 8 * s, ((g + t) / STAGES) & 1);
          mbar_wait(v_full + 8 * sp, ((g + t - 1) / STAGES) & 1);
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) sc[e] = 0.f;
          fence_regs<BN / 2>(sc);
          fence_regs<D / 2>(o);
          take_turn();
          wgmma_fence();              // o and pa were written by plain code
          issue_qk<D>(sc, q_wg, k_s + s * S::KV);
          wgmma_commit();
          issue_pv<D>(o, pa, v_s + sp * S::KV);
          wgmma_commit();
          pass_turn();
          wgmma_wait<1>();            // Q.K^T done; P.V may still run
          fence_regs<BN / 2>(sc);
          softmax_tile<BN>(sc, m, l, corr, t * BN, r, row0, lane, Sk, causal,
                           q_offset, scale_log2);
          wgmma_wait<0>();
          fence_regs<D / 2>(o);
          if (lane == 0) mbar_arrive(empty + 8 * sp);
          pack_and_rescale<D>(pa, sc, o, corr);
        }

        const int sp = (g + n_w - 1) % STAGES;   // the last tile's P.V
        mbar_wait(v_full + 8 * sp, ((g + n_w - 1) / STAGES) & 1);
        fence_regs<D / 2>(o);
        take_turn();
        wgmma_fence();
        issue_pv<D>(o, pa, v_s + sp * S::KV);
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        if (lane == 0) mbar_arrive(empty + 8 * sp);
      }
      // the tiles above this warpgroup's rows: wait for each, take its
      // turn and release it; so both warpgroups take n_kv + 1 turns
      for (int t = n_w; t < n_kv; ++t) {
        mbar_wait(k_full + 8 * ((g + t) % STAGES), ((g + t) / STAGES) & 1);
        take_turn();
        pass_turn();
        if (lane == 0) mbar_arrive(empty + 8 * ((g + t) % STAGES));
      }
      if (PINGPONG && n_w == 0) {
        take_turn();
        pass_turn();
      }
      g += n_kv;
      if (lane == 0) mbar_arrive(q_empty + 8 * qb);  // Q is read: refill it

      // epilogue: O / l in bf16 for the rows below Sq (and, when asked,
      // each row's log-sum-exp in natural-log units from one thread of its
      // quad)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int row = r + 8 * i;
        if (row < Sq) {
          if (STATS && lane % 4 == 0) {
            lse[(static_cast<int64_t>(it.b) * H + it.h) * Sq + row] =
                l[i] == 0.f ? kNegInf : fmaf(m[i], kLn2, logf(l[i]));
          }
          const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
          __nv_bfloat16* dst =
              out + ((static_cast<int64_t>(it.b) * Sq + row) * H + it.h) * D;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj) {
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj + 2 * (lane % 4)) =
                __floats2bfloat162_rn(o[4 * jj + 2 * i] * inv,
                                      o[4 * jj + 2 * i + 1] * inv);
          }
        }
      }
    }
  }
}

}  // namespace tc

namespace tc {

// The 4-D map over a contiguous bf16 (B, S, heads, D) tensor, innermost
// first: (D, heads, S, B); a box is 64 columns of `rows` rows of one head
// and batch, 128-byte swizzled; rows past S read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int D,
              int heads, int S, int B, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;   // bytes
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {BOX, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__global__ void fill_kernel(float* __restrict__ x, int64_t n, float value) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    x[i] = value;
  }
}

template <int D, bool STATS>
int launch_kernel(const void* q, const void* k, const void* v, void* out,
                  float* lse, int B, int Sq, int Sk, int H, int K, int causal,
                  int q_offset, float scale, cudaStream_t stream) {
  // setmaxnreg moves registers within the block's allocation at launch:
  // refuse a build whose allocation could not cover the consumers' share
  // (the increase would wait for ever)
  static int regs_checked = 0;
  if (!regs_checked) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, flash_tc_kernel<D, STATS>);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * THREADS <
        PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS) {
      return static_cast<int>(cudaErrorLaunchOutOfResources);
    }
    regs_checked = 1;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(encode, &q_map, q, D, H, Sq, B, BM) ||
      !make_map(encode, &k_map, k, D, K, Sk, B, Smem<D>::BN) ||
      !make_map(encode, &v_map, v, D, K, Sk, B, Smem<D>::BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int smem_limit[kMaxDevices] = {};
  const cudaError_t err =
      raise_smem_limit(flash_tc_kernel<D, STATS>, Smem<D>::BYTES, smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: one per SM, each walking its share of the items
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_items = ((Sq + BM - 1) / BM) * H * B;
  flash_tc_kernel<D, STATS>
      <<<min(n_items, sms), THREADS, Smem<D>::BYTES, stream>>>(
          q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, Sq, Sk,
          H, K, B, causal, q_offset, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Sq, int Sk, int H, int K, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  if (Sk == 0) {   // no key: every row's sum is 0, so every output is 0
    if (lse != nullptr) {
      const int64_t n = static_cast<int64_t>(B) * H * Sq;
      const int64_t blocks = (n + 255) / 256;
      fill_kernel<<<static_cast<int>(blocks < 1024 ? blocks : 1024), 256, 0,
                    stream>>>(lse, n, kNegInf);
    }
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * Sq * H * D * 2, stream));
  }
  return lse != nullptr
             ? launch_kernel<D, true>(q, k, v, out, lse, B, Sq, Sk, H, K,
                                      causal, q_offset, scale, stream)
             : launch_kernel<D, false>(q, k, v, out, nullptr, B, Sq, Sk, H, K,
                                       causal, q_offset, scale, stream);
}

}  // namespace tc

// Returns cudaGetLastError() after the launch, or a negative code for
// arguments the kernels do not take (-1 head dim, -2 dtype, -3 shape, -4
// an operand not 16-byte aligned).  bf16 at D 64 and D 128 runs on the
// tensor cores; every other (dtype, D) on the CUDA cores.  `lse` is a
// (B, H, Sq) f32 buffer for the rows' log-sum-exp, or null.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int Sq, int Sk, int H, int K, int D,
                                   int dtype, int causal, int q_offset,
                                   float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Sk < 0 || K <= 0 || H % K != 0) return -3;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16) {
    return -4;
  }
  (void)cudaGetLastError();   // report only this launch's error
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_d<float>(D, q, k, v, out, lse, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    case kBF16:
      if (D == 64) return tc::launch<64>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, q_offset, scale, s);
      if (D == 128) return tc::launch<128>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, q_offset, scale, s);
      return launch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    default:
      return -2;
  }
}
