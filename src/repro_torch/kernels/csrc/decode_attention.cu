// Decode attention (one query token per sequence over a KV cache) for
// Hopper, sm_90a: flash-decoding in two kernels, split then combine.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::
// decode_attention_pallas (_decode_kernel), the TPU kernel behind
// decode_attention(backend="pallas").  Same function: q (B,H,D), k/v
// (B,S,K,D) cache, lengths (B,) int32 -> (B,H,D) in q's dtype; keys at or
// past lengths[b] are masked (-1e30); all G = H/K query heads of a KV head
// share each streamed KV tile; splits that start at or past the length
// are skipped; a sequence with no valid key gives 0.  q is widened to f32
// and scaled, as in the Pallas kernel (kernel.py:42).
//
// What bounds it on an H100: the cache.  At the serving decode shape
// (B 4, K 16, D 64, bf16, about 544 cached positions) one call reads
// 8.9 MB of K/V and does about 9 MFLOP, so only memory time counts (about
// 2.7 us at the data sheet's 3.35 TB/s; computed, not measured).
// B*K = 64 (batch, KV head) pairs would fill only 64 of the 132 SMs, so
// the cache is cut into splits that run as blocks of their own (the Pallas
// kernel walked them in order on one core).  Measured times are in PERF.md.
//
// Design: grid (split, KV head, batch).  A block reads lengths[b] itself
// (no host sync: the lengths never leave the card), returns at once when
// its split starts at or past the length, and otherwise streams the split
// once in 32-key chunks through shared memory with 16-byte loads, scoring
// all G heads against each chunk (lane j owns key j; warps take heads) and
// keeping an online softmax per head.  It writes its partial (max, sum,
// unnormalised f32 accumulator) to a scratch tensor the wrapper allocates;
// the combine kernel rescales the valid splits of each head to their
// common max and divides.  The TPU's g_pad sublane padding and (8,128)
// cache padding are not carried over.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int TK = 32;          // keys per chunk: one per lane
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXP = 4;         // (head, 4-column) pairs per thread
constexpr int LDP = TK + 1;
constexpr int MAX_G = 64;

template <int D>
int smem_floats(int G) {
  return G * D + TK * (D + 4) + TK * D + G * LDP + 3 * G;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int S, int H, int K, int split_len, int n_splits,
                    float scale) {
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int length = min(max(lengths[b], 0), S);
  const int start = split * split_len;
  if (start >= length) return;             // the combine reads valid splits only
  const int end = min(start + split_len, length);

  extern __shared__ float4 smem4[];
  constexpr int LDK = D + 4;
  float* Qs = reinterpret_cast<float*>(smem4);   // G x D, pre-scaled
  float* Ks = Qs + G * D;                        // TK x LDK
  float* Vs = Ks + TK * LDK;                     // TK x D
  float* Ps = Vs + TK * D;                       // G x LDP
  float* head_m = Ps + G * LDP;
  float* head_l = head_m + G;
  float* head_c = head_l + G;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t kv_stride = static_cast<int64_t>(K) * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * S * K + kh) * D;

  load_tile<T, D>(Qs, D, q + (static_cast<int64_t>(b) * H + kh * G) * D, D, G,
                  G, scale);
  for (int g = tid; g < G; g += THREADS) {
    head_m[g] = kNegInf;
    head_l[g] = 0.f;
  }

  constexpr int DG = D / 4;
  float acc[MAXP][4];
#pragma unroll
  for (int j = 0; j < MAXP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int c0 = start; c0 < end; c0 += TK) {
    __syncthreads();
    const int valid = min(TK, end - c0);
    load_tile<T, D>(Ks, LDK, k + kv_off + c0 * kv_stride, kv_stride, TK, valid, 1.f);
    load_tile<T, D>(Vs, D, v + kv_off + c0 * kv_stride, kv_stride, TK, valid, 1.f);
    __syncthreads();

    float kreg[D];
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 t = *reinterpret_cast<const float4*>(Ks + lane * LDK + d);
      kreg[d] = t.x; kreg[d + 1] = t.y; kreg[d + 2] = t.z; kreg[d + 3] = t.w;
    }
    const bool masked = c0 + lane >= end;
    for (int g = warp; g < G; g += WARPS) {
      float s = dot_row<D>(Qs + g * D, kreg);
      if (masked) s = kNegInf;
      const float m_prev = head_m[g];
      const float m_cur = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_cur);
      const float p_sum = warp_sum(p);
      Ps[g * LDP + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_cur);
        head_c[g] = corr;
        head_m[g] = m_cur;
        head_l[g] = head_l[g] * corr + p_sum;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < MAXP; ++j) {
      const int pair = tid + j * THREADS;
      if (pair < G * DG) {
        const int g = pair / DG;
        const int dg = pair % DG;
        const float c = head_c[g];
        float a0 = acc[j][0] * c, a1 = acc[j][1] * c;
        float a2 = acc[j][2] * c, a3 = acc[j][3] * c;
        for (int t = 0; t < TK; ++t) {
          const float p = Ps[g * LDP + t];
          const float4 vv = *reinterpret_cast<const float4*>(Vs + t * D + dg * 4);
          a0 = fmaf(p, vv.x, a0);
          a1 = fmaf(p, vv.y, a1);
          a2 = fmaf(p, vv.z, a2);
          a3 = fmaf(p, vv.w, a3);
        }
        acc[j][0] = a0; acc[j][1] = a1; acc[j][2] = a2; acc[j][3] = a3;
      }
    }
  }
  __syncthreads();

  // partials of this split: rows (b, kh, split, g)
  const int64_t row0 = ((static_cast<int64_t>(b) * K + kh) * n_splits + split) * G;
#pragma unroll
  for (int j = 0; j < MAXP; ++j) {
    const int pair = tid + j * THREADS;
    if (pair < G * DG) {
      const int g = pair / DG;
      const int dg = pair % DG;
      *reinterpret_cast<float4*>(part_acc + (row0 + g) * D + dg * 4) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
  for (int g = tid; g < G; g += THREADS) {
    part_ml[(row0 + g) * 2] = head_m[g];
    part_ml[(row0 + g) * 2 + 1] = head_l[g];
  }
}

// One block per (head, batch), one thread per column of D.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      const int* __restrict__ lengths,
                                      T* __restrict__ out, int S, int H, int K,
                                      int D, int split_len, int n_splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int G = H / K;
  const int kh = h / G;
  const int g = h % G;
  const int length = min(max(lengths[b], 0), S);
  const int n_valid = (length + split_len - 1) / split_len;
  const int64_t row0 = (static_cast<int64_t>(b) * K + kh) * n_splits * G + g;

  float m = kNegInf;
  for (int s = 0; s < n_valid; ++s) m = fmaxf(m, part_ml[(row0 + s * G) * 2]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_valid; ++s) {
    const int64_t row = row0 + static_cast<int64_t>(s) * G;
    const float w = expf(part_ml[row * 2] - m);
    l = fmaf(part_ml[row * 2 + 1], w, l);
    a = fmaf(part_acc[row * D + d], w, a);
  }
  l = (l == 0.f) ? 1.f : l;
  store(out + (static_cast<int64_t>(b) * H + h) * D + d, a / l);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part_acc, float* part_ml, int B, int S, int H,
           int K, int split_len, int n_splits, float scale, cudaStream_t s) {
  const int G = H / K;
  if (G > MAX_G || G * (D / 4) > MAXP * THREADS) return -3;
  static int smem_limit[kMaxDevices] = {};
  const size_t smem = smem_floats<D>(G) * sizeof(float);
  cudaError_t err = raise_smem_limit(decode_split_kernel<T, D>,
                                     static_cast<int>(smem), smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<T, D><<<dim3(n_splits, K, B), THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_ml, S, H, K, split_len,
      n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<dim3(H, B), D, 0, s>>>(
      part_acc, part_ml, lengths, static_cast<T*>(out), S, H, K, D, split_len,
      n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const int* lengths, void* out, float* pa, float* pm, int B, int S,
             int H, int K, int split_len, int n_splits, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, out, pa, pm, B, S, H, K, split_len, n_splits, scale, s);
    case 32: return launch<T, 32>(q, k, v, lengths, out, pa, pm, B, S, H, K, split_len, n_splits, scale, s);
    case 64: return launch<T, 64>(q, k, v, lengths, out, pa, pm, B, S, H, K, split_len, n_splits, scale, s);
    case 128: return launch<T, 128>(q, k, v, lengths, out, pa, pm, B, S, H, K, split_len, n_splits, scale, s);
    default: return -1;
  }
}

}  // namespace

// part_acc: (B, K, n_splits, G, D) f32 and part_ml: (B, K, n_splits, G, 2)
// f32 scratch; split_len a multiple of 32 with n_splits * split_len >= S.
// Returns cudaGetLastError() after the launches, or a negative code for
// arguments the kernels do not take (-1 head dim, -2 dtype, -3 shape).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, void* part_acc, void* part_ml,
                                    int B, int S, int H, int K, int D,
                                    int dtype, int split_len, int n_splits,
                                    float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0) return -3;
  if (split_len <= 0 || split_len % TK != 0 ||
      static_cast<int64_t>(split_len) * n_splits < S) return -3;
  (void)cudaGetLastError();   // report only these launches' errors
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  switch (dtype) {
    case kF32:
      return launch_d<float>(D, q, k, v, len, out, pa, pm, B, S, H, K, split_len, n_splits, scale, s);
    case kBF16:
      return launch_d<__nv_bfloat16>(D, q, k, v, len, out, pa, pm, B, S, H, K, split_len, n_splits, scale, s);
    default:
      return -2;
  }
}
