// Flash-decode GQA attention for one query token per sequence, on Hopper
// (sm_90a): every decode step of the serving engine runs it.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py,
// decode_attention_pallas (_decode_attn_kernel):
//
//     out[b, h] = sum_j p[b, h, j] v[b, j, h / G] / max(sum_j p[b, h, j], 1e-30)
//     p = online softmax of s = (q[b, h] . k[b, j, h / G]) * scale,
//         s = -1e30 where j >= valid_len[b]
//
// q [B, H, D], k/v [B, S, KH, D] (fp32 or bf16), valid_len [B] int32,
// out [B, H, D] in q's type; G = H / KH query heads share a KV head.
// Scores, the running max m, the sum l and the accumulator are fp32, as on
// the TPU. At valid_len == 0 every score is -1e30, so p = 1 at every
// position and the output is the mean of V over the S positions.
//
// What bounds it on this card: device-memory bytes. A decode step reads the
// K and V of every valid position once and does 4 flops per element read,
// far below the ~20 flops a byte at which fp32 arithmetic would bind. At the
// serve shape (B = 8, H = 32, KH = 4, D = 64, S = 144, bf16) that is about
// 1.2 MB, 0.4 us at 3.35 TB/s, so one launch costs more than its bytes.
//
// Design: one block per (kv head, sequence) holds all G query heads of its
// KV head, so each K/V element is read from device memory once. Keys are
// streamed through shared memory in tiles of a FIXED 64 positions, upcast
// to fp32: first the K tile (each lane scores two keys of one head, fixed
// summation order over D), then the V tile in the same buffer (each lane
// accumulates D / 32 output columns). Warp w owns heads w, w + 4, ...; its
// max and sum are xor-butterfly reductions, which leave bitwise the same
// value in every lane. Positions past valid_len add exact zeros in fixed
// places, so a row's result does not depend on S, on B or on where its
// valid prefix ends inside a tile: tiles wholly past valid_len are skipped
// (they would leave m, l and the accumulator bit for bit as they are), and
// masked positions of a partial tile are not read (zero-filled). That keeps
// the serving engine's bit-exact contracts (padded == unpadded, a request
// joining a pool == alone, chained segments == sequential decode). Head
// sizes 32 (the reduced test models), 64 and 128 are compiled. No split
// of S across blocks, no wgmma, no TMA: at the serve shape the grid is
// 4 x 8 = 32 blocks on 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // keys per shared-memory tile (fixed)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats: the K or V tile [kTile, D + 1] (padded so the
// lanes scoring consecutive keys hit distinct banks), q and the
// accumulator [G, D] each, the tile's probabilities [G, kTile], and m, l,
// the tile's rescale factor [G] each.
__host__ __device__ constexpr int smem_floats(int d, int g) {
  return kTile * (d + 1) + 2 * g * d + g * kTile + 3 * g;
}

// Copy positions [t0, t0 + kTile) of one KV head's K or V into the tile,
// upcast; positions at or past `lim` are zero-filled, never read.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* src, int t0, int lim,
                                          long long pos_stride) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int j = e / D, d = e % D;
    const int pos = t0 + j;
    tile[j * (D + 1) + d] = pos < lim ? to_f32(src[pos * pos_stride + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ valid_len,
                        T* __restrict__ out, int h, int kh_n, int s_len, int g_n,
                        float scale) {
  extern __shared__ float smem[];
  float* tile = smem;
  float* qs = tile + kTile * (D + 1);
  float* acc = qs + g_n * D;
  float* ps = acc + g_n * D;
  float* ms = ps + g_n * kTile;
  float* ls = ms + g_n;
  float* cs = ls + g_n;

  const int kh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qb = q + (static_cast<long long>(b) * h + static_cast<long long>(kh) * g_n) * D;
  for (int e = threadIdx.x; e < g_n * D; e += kThreads) {
    qs[e] = to_f32(qb[e]);
    acc[e] = 0.f;
  }
  for (int g = threadIdx.x; g < g_n; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  const int vl = min(max(valid_len[b], 0), s_len);
  // positions that can carry weight: the valid prefix, or all S when none
  // is valid (then every score is -1e30 and every position weighs 1)
  const int lim = vl > 0 ? vl : s_len;
  const long long pos_stride = static_cast<long long>(kh_n) * D;
  const long long base = (static_cast<long long>(b) * s_len * kh_n + kh) * D;

  for (int t0 = 0; t0 < lim; t0 += kTile) {
    __syncthreads();  // the previous V tile is consumed; q, m, l are set
    load_tile<T, D>(tile, k + base, t0, lim, pos_stride);
    __syncthreads();
    for (int g = warp; g < g_n; g += kWarps) {
      const float* qg = qs + g * D;
      const float* k0 = tile + lane * (D + 1);
      const float* k1 = tile + (lane + 32) * (D + 1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        const float qd = qg[d];
        s0 = fmaf(qd, k0[d], s0);
        s1 = fmaf(qd, k1[d], s1);
      }
      const int p0 = t0 + lane, p1 = t0 + lane + 32;
      s0 = p0 < vl ? s0 * scale : kNegInf;
      s1 = p1 < vl ? s1 * scale : kNegInf;
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = p0 < lim ? expf(s0 - m_new) : 0.f;
      const float e1 = p1 < lim ? expf(s1 - m_new) : 0.f;
      const float corr = expf(m_old - m_new);
      const float l_new = ls[g] * corr + warp_sum(e0 + e1);
      ps[g * kTile + lane] = e0;
      ps[g * kTile + lane + 32] = e1;
      __syncwarp();
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = l_new;
        cs[g] = corr;
      }
    }
    __syncthreads();  // scores are done with the K tile
    load_tile<T, D>(tile, v + base, t0, lim, pos_stride);
    __syncthreads();
    for (int g = warp; g < g_n; g += kWarps) {
      const float corr = cs[g];
      const float* pg = ps + g * kTile;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const int d = lane + 32 * i;
        float t = 0.f;
#pragma unroll 16
        for (int j = 0; j < kTile; ++j) t = fmaf(pg[j], tile[j * (D + 1) + d], t);
        acc[g * D + d] = acc[g * D + d] * corr + t;
      }
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<long long>(b) * h + static_cast<long long>(kh) * g_n) * D;
  for (int e = threadIdx.x; e < g_n * D; e += kThreads) {
    store(ob + e, acc[e] / fmaxf(ls[e / D], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* valid_len, void* out,
           int b, int h, int kh, int s, float scale, cudaStream_t stream) {
  const int g = h / kh;
  const int bytes = static_cast<int>(sizeof(float)) * smem_floats(D, g);
  auto kernel = decode_attention_kernel<T, D>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(kh, b), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      valid_len, static_cast<T*>(out), h, kh, s, g, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs for head size d and g query heads
// per KV head (the wrapper refuses more than a block can have).
extern "C" int preba_decode_attention_smem_bytes(int d, int g) {
  return static_cast<int>(sizeof(float)) * smem_floats(d, g);
}

// q [b, h, d], k/v [b, s, kh, d], valid_len [b] int32 -> out [b, h, d];
// bf16 != 0 for bfloat16 tensors, else float32; all contiguous, h % kh == 0,
// d in {32, 64, 128}. Returns the cudaError_t of the launch.
extern "C" int preba_decode_attention(const void* q, const void* k, const void* v,
                                      const int* valid_len, void* out, int b, int h,
                                      int kh, int s, int d, int bf16, float scale,
                                      void* stream) {
  if (b <= 0 || kh <= 0 || h % kh != 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return bf16 ? launch<__nv_bfloat16, 32>(q, k, v, valid_len, out, b, h, kh, s, scale, st)
                : launch<float, 32>(q, k, v, valid_len, out, b, h, kh, s, scale, st);
  if (d == 64)
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, valid_len, out, b, h, kh, s, scale, st)
                : launch<float, 64>(q, k, v, valid_len, out, b, h, kh, s, scale, st);
  if (d == 128)
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, valid_len, out, b, h, kh, s, scale, st)
                : launch<float, 128>(q, k, v, valid_len, out, b, h, kh, s, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
