// Flash attention forward (causal or full, GQA) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (_flash_kernel), the TPU kernel behind flash_attention(backend="pallas").
// Same function: q (B,Sq,H,D), k/v (B,Sk,K,D) -> (B,Sq,H,D) in q's dtype;
// query head h reads KV head h / (H/K); query row i sits at absolute
// position q_offset + i; masked scores are -1e30; online softmax with an
// f32 accumulator; a row whose sum is 0 gives 0.  As in the Pallas kernel
// (kernel.py:47) q is widened to f32 and then scaled; the XLA path instead
// rounds q*scale to q's dtype (ops.py:94).  This kernel follows Pallas.
//
// What bounds it on an H100: at the serving prefill shape (B 4, S 512,
// H 16, D 64, bf16, causal) one call moves 16.8 MB and does 2.1 GFLOP, so
// by the data sheet's rates (3.35 TB/s, 989 bf16 TFLOP/s; computed, not
// measured) memory sets the floor, about 5 us against 2.2 us of tensor-core
// time.  This first version does its arithmetic in f32 on the CUDA cores,
// which puts its own limit well above that floor; tensor cores (mma/wgmma)
// and TMA are for later work.  Measured times are in PERF.md.
//
// Design: one block per (64-query tile, head, batch).  The Pallas grid's
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
#include "common.cuh"

using namespace repro;

namespace {

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
                 const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                 int H, int K, int causal, int q_offset, float scale) {
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
      float l = row_l[r];
      l = (l == 0.f) ? 1.f : l;
#pragma unroll
      for (int e = 0; e < 4; ++e) store(ob + r * q_stride + dg * 4 + e, acc[i][e] / l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int K, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  static int smem_limit[kMaxDevices] = {};
  const size_t smem = smem_floats<D>() * sizeof(float);
  const cudaError_t err = raise_smem_limit(flash_fwd_kernel<T, D>,
                                           static_cast<int>(smem), smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, K, causal,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Sk, int H, int K, int causal, int q_offset,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    default: return -1;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch, or a negative code for
// arguments the kernel does not take (-1 head dim, -2 dtype, -3 shape).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int H, int K, int D, int dtype,
                                   int causal, int q_offset, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Sk < 0 || K <= 0 || H % K != 0) return -3;
  (void)cudaGetLastError();   // report only this launch's error
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_d<float>(D, q, k, v, out, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    case kBF16:
      return launch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, H, K, causal, q_offset, scale, s);
    default:
      return -2;
  }
}
