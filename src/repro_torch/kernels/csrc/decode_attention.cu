// Decode attention (one query token per sequence over a KV cache) for
// Hopper, sm_90a: flash-decoding in one kernel, the combine folded in.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::
// decode_attention_pallas (_decode_kernel), the TPU kernel behind
// decode_attention(backend="pallas").  Same function: q (B,H,D), k/v
// (B,S,K,D) cache, lengths (B,) int32 -> (B,H,D) in q's dtype; keys at or
// past lengths[b] are masked (-1e30); the G = H/K query
// heads of a KV head share each streamed KV tile; a sequence with no
// valid key gives 0.  q is widened to f32 and scaled, as in the Pallas
// kernel (kernel.py:42).
//
// What bounds it on an H100: the bytes of the cache.  At the serving
// decode shapes (B 4, about 544 cached positions, bf16) one call reads
// 8.9 MB of K/V (qwen1.5-0.5b: K 16, D 64; zamba2-1.2b's shared block has
// K 32) or 17.8 MB (deepseek-moe-16b: D 128) and does about 2 FLOP a byte,
// so only memory time counts: 2.7 and 5.3 us at the data sheet's 3.35
// TB/s (computed, not measured; measured times are in PERF.md).  A call is
// a few memory latencies long, so what counts is how many bytes are in
// flight from the first cycle, and that no thread waits on another.
//
// Design.  Grid (split, KV head x head group, batch), 4 warps a block.  A
// split is a run of whole tiles of the cache; a tile is 2 KB of K rows
// (16 keys at D 64 in bf16, 8 at D 128) and the same of V.  Each warp takes
// every fourth tile of its block's split and streams it through a ring of
// its own in shared memory with cp.async: each lane copies 16-byte pieces
// of K and V rows in their own type and later reads only the pieces it
// copied, so no barrier guards the ring, which keeps a warp's share of its
// split (up to 4 tiles) in flight.  Lanes split D (8 lanes a row at D 64 in
// bf16, 16 at D 128; 4 rows a round): a score is a dot product over the
// lanes of a row, reduced by shuffles, and P·V needs no exchange at all.
// Each warp keeps its own online softmax over its tiles for up to GT query
// heads held in registers (q widened and scaled once); the warps merge in
// shared memory at the end.  The first tiles are issued before the length
// is read, so its latency hides behind theirs; rows past the cache's
// capacity are copied as zeros, and rows past the length are masked when
// read (their scores -1e30, their V never summed, whatever they hold).
//
// The combine is in the same kernel: a block whose split is one of several
// writes its (max, sum, f32 accumulator) to a scratch tensor, counts itself
// on a device counter of its (batch, KV head, head group) with an atomic,
// and the block that counts last reduces every split of that pair and
// writes the output.  It sets the counter back to 0, so the next call and a
// CUDA-graph replay find it at 0.  The wrapper keeps one set of counters
// per (device, stream): two calls that run at once on two streams never
// share one.  The plan (split length, number of splits) follows from the
// cache's capacity and the SM count only; the lengths stay on the card.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_BYTES = 2048;                 // K (or V) of one warp's tile
constexpr int ROUNDS = TILE_BYTES / (32 * 16);   // 16-byte copies per lane
constexpr int RING_MAX = 4;                      // tiles in flight per warp
constexpr int MAX_SPLITS = 1024;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Waits until at most n (< RING_MAX) groups of this thread are in flight.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// 16 bytes of shared memory widened to f32.
__device__ __forceinline__ void lds16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void lds16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Sum (or max) over the lanes whose index differs only in bits LO..16.
template <int LO>
__device__ __forceinline__ float xor_sum(float v) {
#pragma unroll
  for (int o = LO; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
template <int LO>
__device__ __forceinline__ float xor_max(float v) {
#pragma unroll
  for (int o = LO; o < 32; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int LPR>
__device__ __forceinline__ float row_sum(float v) {   // over one row's lanes
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// T the cache's type, D the head dim, GT the query heads a block scores.
template <typename T, int D, int GT>
struct Shape {
  static constexpr int EPL = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int LPR = D / EPL;            // lanes per row
  static constexpr int RPR = 32 / LPR;           // rows per round
  static constexpr int TK = ROUNDS * RPR;        // keys per tile
  static_assert(LPR >= 1 && LPR <= 32 && TK * D * sizeof(T) == TILE_BYTES,
                "a tile is 2 KB of whole rows");
};

template <int D, int GT>
int smem_bytes(int stages) {   // the rings and the warps' partials
  return WARPS * stages * 2 * TILE_BYTES +
         WARPS * GT * (D + 2) * static_cast<int>(sizeof(float));
}

template <typename T, int D, int GT>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, float* __restrict__ part_acc,
              float* __restrict__ part_ml, int* __restrict__ counters, int S,
              int H, int K, int split_len, int n_splits, int stages,
              float scale) {
  using Sh = Shape<T, D, GT>;
  constexpr int EPL = Sh::EPL, LPR = Sh::LPR, RPR = Sh::RPR, TK = Sh::TK;
  const int split = blockIdx.x;
  const int G = H / K;
  const int n_hg = (G + GT - 1) / GT;
  const int kh = blockIdx.y / n_hg;
  const int h0 = kh * G + (blockIdx.y % n_hg) * GT;   // first query head
  const int gv = min(GT, (kh + 1) * G - h0);          // heads of this block
  const int b = blockIdx.z;
  const int pair = b * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int start = split * split_len;
  const int cap = min(start + split_len, S);          // the split's positions
  const int col = (lane % LPR) * EPL;                  // this lane's columns

  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4) +
               warp * stages * 2 * TILE_BYTES;
  float* wres = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                         WARPS * stages * 2 * TILE_BYTES);
  // wres: per warp, GT rows of (max, sum, D accumulators)

  const int64_t kv_row = static_cast<int64_t>(K) * D;   // elements per position
  const T* kb = k + (static_cast<int64_t>(b) * S * K + kh) * D + col;
  const T* vb = v + (static_cast<int64_t>(b) * S * K + kh) * D + col;
  const uint32_t ring_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  // copy this lane's pieces of local tile i (tile warp + i * WARPS); rows
  // past the cache are zeros, rows past the length are masked when read
  auto issue = [&](int i) {
    const int row0 = start + (warp + i * WARPS) * TK;
    const uint32_t slot = ring_u32 + (i % stages) * 2 * TILE_BYTES;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int row = row0 + r * RPR + lane / LPR;
      const bool ok = row < cap;
      const int64_t off = ok ? row * kv_row : 0;
      const uint32_t dst = slot + (r * 32 + lane) * 16;
      cp_async16(dst, kb + off, ok ? 16 : 0);
      cp_async16(dst + TILE_BYTES, vb + off, ok ? 16 : 0);
    }
  };
  // the first tiles go out before the length is known: the cache's bytes
  // are the kernel's time, and the length's latency hides behind them
  const int cap_tiles = (cap - start + TK - 1) / TK;
  const int warp_cap = warp < cap_tiles ? (cap_tiles - warp + WARPS - 1) / WARPS : 0;
  for (int i = 0; i < stages - 1; ++i) {
    if (i < warp_cap) issue(i);
    cp_async_commit();
  }

  const int length = min(max(lengths[b], 0), S);
  T* outb = out + (static_cast<int64_t>(b) * H + h0) * D;
  if (start >= length) {
    if (split == 0) {              // no valid key: the output is 0
      for (int i = tid; i < gv * D; i += THREADS) store(outb + i, 0.f);
    }
    cp_async_wait<0>();
    return;
  }
  const int end = min(cap, length);
  const int n_active = (length + split_len - 1) / split_len;
  const int n_tiles = (end - start + TK - 1) / TK;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + WARPS - 1) / WARPS : 0;

  // this lane's columns of q, widened and scaled; heads past gv score 0
  float qr[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float t[EPL];
    if (g < gv) {
      load16(q + (static_cast<int64_t>(b) * H + h0 + g) * D + col, t);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = t[e] * scale;
  }

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < my_tiles; ++i) {
    __syncwarp();                  // this lane's reads of the slot are done
    if (i + stages - 1 < my_tiles) issue(i + stages - 1);
    cp_async_commit();
    cp_async_wait_dyn(stages - 1); // tile i has landed (this lane's pieces)
    const T* ks = reinterpret_cast<const T*>(ring + (i % stages) * 2 * TILE_BYTES);
    const T* vs = ks + TILE_BYTES / sizeof(T);
    const int row0 = start + (warp + i * WARPS) * TK;

    float s[ROUNDS][GT];
    bool ok[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      float kf[EPL];
      lds16(ks + (r * 32 + lane) * EPL, kf);
      ok[r] = row0 + r * RPR + lane / LPR < end;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kf[e], d);
        d = row_sum<LPR>(d);
        s[r][g] = ok[r] ? d : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mt = s[0][g];
#pragma unroll
      for (int r = 1; r < ROUNDS; ++r) mt = fmaxf(mt, s[r][g]);
      mt = xor_max<LPR>(mt);       // over the tile's rows
      const float m_new = fmaxf(m[g], mt);
      const float corr = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      float vf[EPL];
      lds16(vs + (r * 32 + lane) * EPL, vf);
#pragma unroll
      for (int e = 0; e < EPL; ++e)  // past the length: whatever the cache holds
        vf[e] = ok[r] ? vf[e] : 0.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = expf(s[r][g] - m[g]);   // 0 for a masked row
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // the warp's rows to one (max, sum, accumulator) per head, then to shared
  float* wr = wres + warp * GT * (D + 2);
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const float lg = xor_sum<LPR>(l[g]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = xor_sum<LPR>(acc[g][e]);
    if (lane < LPR) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) wr[g * (D + 2) + 2 + col + e] = acc[g][e];
    }
    if (lane == 0) {
      wr[g * (D + 2)] = m[g];
      wr[g * (D + 2) + 1] = lg;
    }
  }
  __syncthreads();

  // the block's warps to one partial per head; written out, or final
  const int64_t part_row = (static_cast<int64_t>(pair) * n_splits + split) * GT;
  for (int i = tid; i < gv * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wres[(w * GT + g) * (D + 2)]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* r = wres + (w * GT + g) * (D + 2);
      const float c = expf(r[0] - M);   // 0 for a warp with no tile
      L = fmaf(r[1], c, L);
      A = fmaf(r[2 + d], c, A);
    }
    if (n_active == 1) {
      store(outb + i, A / L);
    } else {
      part_acc[(part_row + g) * D + d] = A;
      if (d == 0) {
        part_ml[(part_row + g) * 2] = M;
        part_ml[(part_row + g) * 2 + 1] = L;
      }
    }
  }
  if (n_active == 1) return;

  // the last block of this pair to finish reduces every split
  __shared__ int last;
  __threadfence();                 // this block's partial, before the count
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + pair, 1) == n_active - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();                 // the other blocks' partials, after it
  const int64_t row0 = static_cast<int64_t>(pair) * n_splits * GT;
  for (int i = tid; i < gv * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = kNegInf, L = 0.f, A = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_active; ++sp) {   // online: one pass of loads
      const int64_t r = row0 + sp * GT + g;
      const float ms = __ldcg(part_ml + r * 2);
      const float ls = __ldcg(part_ml + r * 2 + 1);
      const float as = __ldcg(part_acc + r * D + d);
      const float m_new = fmaxf(M, ms);
      const float c_old = expf(M - m_new), c_new = expf(ms - m_new);
      L = L * c_old + ls * c_new;
      A = A * c_old + as * c_new;
      M = m_new;
    }
    store(outb + i, A / L);
  }
  if (tid == 0) counters[pair] = 0;   // ready for the next call or replay
}

template <typename T, int D, int GT>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part_acc, float* part_ml, int* counters, int B,
           int S, int H, int K, int split_len, int n_splits, float scale,
           cudaStream_t s) {
  using Sh = Shape<T, D, GT>;
  if (split_len % Sh::TK != 0) return -3;
  const int G = H / K;
  const int n_hg = (G + GT - 1) / GT;
  const int tiles = split_len / Sh::TK;
  const int stages = min(RING_MAX, (tiles + WARPS - 1) / WARPS);
  static int smem_limit[kMaxDevices] = {};
  const int smem = smem_bytes<D, GT>(stages);
  cudaError_t err = raise_smem_limit(decode_kernel<T, D, GT>, smem, smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<int64_t>(K) * n_hg > 65535 || B > 65535) return -3;
  decode_kernel<T, D, GT><<<dim3(n_splits, K * n_hg, B), THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part_acc,
      part_ml, counters, S, H, K, split_len, n_splits, stages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(int GT, const void* q, const void* k, const void* v,
             const int* len, void* out, float* pa, float* pm, int* cnt, int B,
             int S, int H, int K, int split_len, int n_splits, float scale,
             cudaStream_t s) {
  switch (GT) {
    case 1: return launch<T, D, 1>(q, k, v, len, out, pa, pm, cnt, B, S, H, K, split_len, n_splits, scale, s);
    case 2: return launch<T, D, 2>(q, k, v, len, out, pa, pm, cnt, B, S, H, K, split_len, n_splits, scale, s);
    case 4: return launch<T, D, 4>(q, k, v, len, out, pa, pm, cnt, B, S, H, K, split_len, n_splits, scale, s);
    case 8: return launch<T, D, 8>(q, k, v, len, out, pa, pm, cnt, B, S, H, K, split_len, n_splits, scale, s);
    default: return -3;
  }
}

template <typename T>
int launch_d(int D, int GT, const void* q, const void* k, const void* v,
             const int* len, void* out, float* pa, float* pm, int* cnt, int B,
             int S, int H, int K, int split_len, int n_splits, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch_g<T, 16>(GT, q, k, v, len, out, pa, pm, cnt, B, S, H, K, split_len, n_splits, scale, s);
    case 32: return launch_g<T, 32>(GT, q, k, v, len, out, pa, pm, cnt, B, S, H, K, split_len, n_splits, scale, s);
    case 64: return launch_g<T, 64>(GT, q, k, v, len, out, pa, pm, cnt, B, S, H, K, split_len, n_splits, scale, s);
    case 128: return launch_g<T, 128>(GT, q, k, v, len, out, pa, pm, cnt, B, S, H, K, split_len, n_splits, scale, s);
    default: return -1;
  }
}

}  // namespace

// q (B,H,D), k/v (B,S,K,D) and out (B,H,D) in `dtype`; lengths (B,) int32.
// gt: query heads per block (1, 2, 4 or 8), so a KV head's G = H/K heads
// take ceil(G/gt) blocks.  split_len: a multiple of the tile's keys
// (2048 bytes of rows), with n_splits * split_len >= S.  part_acc
// (B, K*ceil(G/gt), n_splits, gt, D) and part_ml (..., 2) f32 scratch and
// counters (B*K*ceil(G/gt)) int32, all 0 before the first call (the kernel
// leaves them at 0): all three may be null when n_splits is 1.  Returns
// cudaGetLastError() after the launch, or a negative code for arguments the
// kernel does not take (-1 head dim, -2 dtype, -3 shape or plan).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, void* part_acc, void* part_ml,
                                    void* counters, int B, int S, int H,
                                    int K, int D, int dtype, int gt,
                                    int split_len, int n_splits, float scale,
                                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0) return -3;
  if (split_len <= 0 || n_splits <= 0 || n_splits > MAX_SPLITS ||
      static_cast<int64_t>(split_len) * n_splits < S ||
      static_cast<int64_t>(split_len) * (n_splits - 1) >= S)
    return -3;
  if (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr ||
                       counters == nullptr))
    return -3;
  (void)cudaGetLastError();   // report only this launch's errors
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counters);
  switch (dtype) {
    case kF32:
      return launch_d<float>(D, gt, q, k, v, len, out, pa, pm, cnt, B, S, H, K, split_len, n_splits, scale, s);
    case kBF16:
      return launch_d<__nv_bfloat16>(D, gt, q, k, v, len, out, pa, pm, cnt, B, S, H, K, split_len, n_splits, scale, s);
    default:
      return -2;
  }
}
