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
// With an lse pointer [B, H] fp32 (optional; null leaves all of the above
// as it is) the kernel also writes each row's log-sum-exp of its scaled
// fp32 scores over the valid prefix, lse = m + log(l), from the m and l the
// cluster merge already holds. A row with valid_len == 0 then weighs
// nothing: o = 0 and lse = -inf. This is what a rank that holds one cut of
// a ring along its sequence returns, so that the ranks' partial outputs
// merge exactly (o = sum_r exp(lse_r - M) o_r / sum_r exp(lse_r - M)).
//
// What bounds it on this card: device-memory bytes and latency. A decode
// step reads the K and V of every valid position once and does 4 flops per
// element read, far below the ~20 flops a byte at which fp32 arithmetic
// would bind, so the kernel uses no tensor cores. At the serve shape
// (B = 8, H = 32, KH = 4, D = 64, S = 144, bf16) that is about 1.2 MB,
// 0.4 us at 3.35 TB/s, so what it pays is launch, load latency and the
// depth of its dependent steps.
//
// Design: a thread block cluster of C = 8 blocks per (KV head, sequence)
// splits S. Keys go in tiles of a FIXED 64 positions; block r of the
// cluster takes tiles r, r + C, r + 2C, ... in ascending order and keeps
// the online-softmax partial (m, l, acc) of all G query heads of its KV
// head, so each K/V element is read from device memory once. Each tile's K
// and V are copied together with 16-byte cp.async into a two-stage ring in
// their storage type, rows padded by 16 bytes so the lanes scoring
// consecutive keys hit distinct banks; the next tile's copy runs under
// this tile's scores and values, and each value is upcast in registers.
// The copies of q and of the block's first tile are issued before
// valid_len is read, so the three device-memory latencies overlap.
// Eight warps: warp w owns query heads w, w + 8, ... (tinyllama's G = 8: one
// each; at G = 1, the MHA of whisper and phi-3-vision, warp 0 alone scores
// and the other seven only copy) and upcasts their q once; a lane scores
// two keys of a head (fixed summation order over D), max and sum are
// xor-butterfly reductions (bitwise the same value in every lane), and a
// lane accumulates kCols adjacent output columns over the tile's keys in
// order: 1, 2 or 4 of them (D = 32, 64, 128: every lane), and 4 at D = 80
// and 96, where D / 32 is no power of two (lanes 0-19 and 0-23 own 4
// columns each, the rest sit out the value loop). A lane's 4
// columns are 16 bytes in fp32 and 8 in bf16 from a row start on 16 bytes,
// so every load stays aligned and inside the lane's own columns; D / 32 = 3
// columns at 96 would put a lane's loads off 16 bytes. After
// cluster.sync() the blocks merge the partials through distributed shared
// memory (mapa + ld.shared::cluster, all of a thread's remote reads in
// flight at once), each a slice of the G x D outputs, in rank order; ranks
// that hold no tile below the limit are left out of the merge, not merged
// as -inf. A second cluster.sync() keeps every block resident until the
// others have read its shared memory. One launch a call: no combine
// kernel, no workspace. Registers are capped at 85 a thread (3 blocks an
// SM): at 128 the card holds fewer clusters of 8 at once than the serve
// shape's 32, and the launch runs in two waves.
//
// A row's result does not depend on S, on B or on what lies past its
// valid prefix: which block takes a tile and the merge order depend on the
// tile's position only, tiles wholly past valid_len are skipped, scores
// past valid_len are replaced by -1e30 whatever the keys there hold, and
// the value loop stops at the limit, so no value past it is read. That
// keeps the serving engine's bit-exact contracts (padded == unpadded, a
// request joining a pool == alone, chained segments == sequential decode).
// Head sizes 32 (the reduced test models), 64, 80 (h2o-danube), 96
// (phi-3-vision) and 128 are compiled. A row of 80 is 10 bf16 or 20 fp32
// 16-byte copies, one of 96 12 or 24; a padded ring row of 176 or 336
// bytes (D 80), 208 or 400 (D 96), an odd multiple of 16 bytes, keeps 8
// lanes' 16-byte loads on distinct banks.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;      // keys per tile (fixed)
constexpr int kCluster = 8;    // blocks per (KV head, sequence), the portable maximum
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;     // tiles in the ring
constexpr int kMinBlocks = 3;  // blocks an SM (caps registers at 85)
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

// 16 bytes from global to shared; src_bytes = 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 32-bit distributed-shared-memory address of p in block `rank` of the
// cluster, and a load from it.
__device__ __forceinline__ unsigned map_rank(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(rank));
  return out;
}
__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

// n consecutive elements at p (aligned to n elements) upcast to fp32.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (N == 1) {
    out[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x, out[i + 1] = v.y, out[i + 2] = v.z, out[i + 3] = v.w;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 1) {
    out[0] = __bfloat162float(p[0]);
  } else if constexpr (N == 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = v.x, out[1] = v.y;
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
        out[i + 2 * k] = f.x, out[i + 2 * k + 1] = f.y;
      }
    }
  }
}

// A tile row: D elements and 16 bytes of padding.
template <typename T, int D>
__host__ __device__ constexpr int row_elems() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Shared memory, in bytes: the ring [kStages][K, V][kTile][row] and q [G, D]
// in the storage type, then (bf16 only) q upcast [G, D], the accumulator
// [G, D], each warp's probabilities [kTile], and m, l [G], fp32.
template <typename T, int D>
__host__ __device__ constexpr int smem_bytes(int g) {
  return static_cast<int>(sizeof(T)) * (kStages * 2 * kTile * row_elems<T, D>() + g * D)
         + 4 * ((sizeof(T) == 4 ? 1 : 2) * g * D + kWarps * kTile + 2 * g);
}

template <typename T, int D>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, kMinBlocks)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ valid_len,
                        T* __restrict__ out, float* __restrict__ lse, int h, int kh_n,
                        int s_len, int g_n, float scale) {
  constexpr int kRow = row_elems<T, D>();
  constexpr int kTileElems = kTile * kRow;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte copy
  constexpr int kChunks = D / kPer;                        // 16-byte copies a row
  // output columns a lane (a power of two, so a lane's loads stay aligned),
  // and the lanes that own columns
  constexpr int kCols = D == 32 ? 1 : D == 64 ? 2 : 4;
  constexpr int kColLanes = D / kCols;
  // a padded row is an odd multiple of 16 bytes: 8 lanes' 16-byte loads of
  // consecutive rows fall on distinct banks
  static_assert(D % kPer == 0 && D % kCols == 0 && kColLanes <= 32 &&
                    (kRow * sizeof(T)) % 32 == 16,
                "head size");
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  T* qs = ring + kStages * 2 * kTileElems;
  float* after_q = reinterpret_cast<float*>(qs + g_n * D);
  float* qf = sizeof(T) == 2 ? after_q : reinterpret_cast<float*>(qs);  // q in fp32
  float* acc = sizeof(T) == 2 ? after_q + g_n * D : after_q;
  float* ps = acc + g_n * D;
  float* ms = ps + kWarps * kTile;
  float* ls = ms + g_n;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int kh = blockIdx.x / kCluster, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long pos_stride = static_cast<long long>(kh_n) * D;
  const long long base = (static_cast<long long>(b) * s_len * kh_n + kh) * D;
  const T* kb = k + base;
  const T* vb = v + base;

  // copy K and V of tile `tile` into the ring; rows at or past `end` are
  // zero-filled, not read
  auto issue = [&](int tile, int end) {
    T* kd = ring + (tile / kCluster % kStages) * 2 * kTileElems;
    T* vd = kd + kTileElems;
    for (int e = tid; e < kTile * kChunks; e += kThreads) {
      const int j = e / kChunks, c = e % kChunks;
      const int pos = tile * kTile + j;
      const bool ok = pos < end;
      const long long off = ok ? pos * pos_stride + c * kPer : 0;
      cp_async16(kd + j * kRow + c * kPer, kb + off, ok ? 16 : 0);
      cp_async16(vd + j * kRow + c * kPer, vb + off, ok ? 16 : 0);
    }
  };

  // q and this block's first tile fly while valid_len is read: the first
  // copy is bounded by S, not by valid_len, so positions past valid_len may
  // land in it; their scores are replaced by -1e30 and their values are
  // never read (the value loop stops at the limit).
  const T* qb = q + (static_cast<long long>(b) * h + static_cast<long long>(kh) * g_n) * D;
  for (int e = tid; e < g_n * kChunks; e += kThreads)
    cp_async16(qs + e * kPer, qb + e * kPer, 16);
  if (rank * kTile < s_len) issue(rank, s_len);
  cp_async_commit();

  const int vl = min(max(valid_len[b], 0), s_len);
  // positions that can carry weight: the valid prefix, or, when none is
  // valid, all S (every score is -1e30 and every position weighs 1) or,
  // with lse, none (the row weighs nothing)
  const int lim = vl > 0 ? vl : lse != nullptr ? 0 : s_len;
  const int n_tiles = (lim + kTile - 1) / kTile;
  const int my_tiles = n_tiles > rank ? (n_tiles - rank + kCluster - 1) / kCluster : 0;
  for (int e = tid; e < g_n * D; e += kThreads) acc[e] = 0.f;
  for (int g = tid; g < g_n; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  // one commit group a tile (empty past the last): the next tile's copy is
  // in flight while this one is used
  for (int i = 0; i < my_tiles; ++i) {
    if (i + 1 < my_tiles) issue(rank + (i + 1) * kCluster, lim);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile i and q have landed for every thread; m, l are set
    const T* kt = ring + (i % kStages) * 2 * kTileElems;
    const T* vt = kt + kTileElems;
    const int t0 = (rank + i * kCluster) * kTile;
    const int nk = min(kTile, lim - t0);  // keys of this tile that carry weight
    float* pw = ps + warp * kTile;
    if constexpr (sizeof(T) == 2) {
      if (i == 0) {  // each warp upcasts the q rows of its own heads, once
        for (int g = warp; g < g_n; g += kWarps)
          for (int d = lane; d < D; d += 32) qf[g * D + d] = to_f32(qs[g * D + d]);
        __syncwarp();
      }
    }
    for (int g = warp; g < g_n; g += kWarps) {
      const float* qg = qf + g * D;
      const T* k0 = kt + lane * kRow;
      const T* k1 = k0 + 32 * kRow;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float a[kPer], bb[kPer], qd[kPer];
        load_f32<kPer>(k0 + c * kPer, a);
        load_f32<kPer>(k1 + c * kPer, bb);
        load_f32<kPer>(qg + c * kPer, qd);
#pragma unroll
        for (int x = 0; x < kPer; ++x) {
          s0 = fmaf(qd[x], a[x], s0);
          s1 = fmaf(qd[x], bb[x], s1);
        }
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
      pw[lane] = e0;
      pw[lane + 32] = e1;
      __syncwarp();
      if (lane < kColLanes) {
        float t[kCols] = {};
        const int d0 = lane * kCols;
        int j = 0;
#pragma unroll 4
        for (; j + 4 <= nk; j += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pw + j);
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float vv[kCols];
            load_f32<kCols>(vt + (j + jj) * kRow + d0, vv);
#pragma unroll
            for (int x = 0; x < kCols; ++x) t[x] = fmaf(pj[jj], vv[x], t[x]);
          }
        }
        for (; j < nk; ++j) {
          float vv[kCols];
          load_f32<kCols>(vt + j * kRow + d0, vv);
#pragma unroll
          for (int x = 0; x < kCols; ++x) t[x] = fmaf(pw[j], vv[x], t[x]);
        }
        float* ag = acc + g * D + d0;
#pragma unroll
        for (int x = 0; x < kCols; ++x) ag[x] = ag[x] * corr + t[x];
      }
      __syncwarp();  // every lane has read m, l and its probabilities
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = l_new;
      }
    }
    __syncthreads();  // this stage is free for the copy issued next round
  }
  cp_async_wait<0>();  // no copy may land after the block has left

  // merge the partials of ranks [0, parts) in rank order; each block
  // writes a slice of the G x D outputs
  cluster.sync();
  const int parts = min(n_tiles, kCluster);
  const int gd = g_n * D, slice = (gd + kCluster - 1) / kCluster;
  const int e_end = min(gd, (rank + 1) * slice);
  T* ob = out + (static_cast<long long>(b) * h + static_cast<long long>(kh) * g_n) * D;
  for (int e = rank * slice + tid; e < e_end; e += kThreads) {
    const int g = e / D;
    float mr[kCluster], ar[kCluster], lr[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {  // all remote reads in flight at once
      if (r < parts) {
        mr[r] = ld_cluster(map_rank(ms + g, r));
        ar[r] = ld_cluster(map_rank(acc + e, r));
        lr[r] = ld_cluster(map_rank(ls + g, r));
      }
    }
    float m = kNegInf;  // every partial's m is at least -1e30
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      if (r < parts) m = fmaxf(m, mr[r]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      if (r < parts) {
        const float f = expf(mr[r] - m);
        a = fmaf(ar[r], f, a);
        l = fmaf(lr[r], f, l);
      }
    }
    store(ob + e, a / fmaxf(l, 1e-30f));
    if (lse != nullptr && e % D == 0)  // one thread a head writes its row's lse
      lse[static_cast<long long>(b) * h + kh * g_n + g] = vl > 0 ? m + logf(l)
                                                             : -__int_as_float(0x7f800000);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Allow the kernel its dynamic shared memory; returns the cudaError_t.
template <typename T, int D>
int configure(int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      decode_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int D>
int max_clusters(int g, int kh, int b) {
  const int bytes = smem_bytes<T, D>(g);
  if (int err = configure<T, D>(bytes)) return -err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * kh, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, decode_attention_kernel<T, D>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* valid_len, void* out,
           float* lse, int b, int h, int kh, int s, float scale, cudaStream_t stream) {
  const int g = h / kh;
  const int bytes = smem_bytes<T, D>(g);
  auto kernel = decode_attention_kernel<T, D>;
  if (int err = configure<T, D>(bytes)) return err;
  kernel<<<dim3(kCluster * kh, b), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      valid_len, static_cast<T*>(out), lse, h, kh, s, g, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs for head size d, g query heads per
// KV head and bf16 != 0 for bfloat16 (the wrapper refuses more than a
// block can have); -1 for a head size that is not compiled.
extern "C" int preba_decode_attention_smem_bytes(int d, int g, int bf16) {
  if (d == 32) return bf16 ? smem_bytes<__nv_bfloat16, 32>(g) : smem_bytes<float, 32>(g);
  if (d == 64) return bf16 ? smem_bytes<__nv_bfloat16, 64>(g) : smem_bytes<float, 64>(g);
  if (d == 80) return bf16 ? smem_bytes<__nv_bfloat16, 80>(g) : smem_bytes<float, 80>(g);
  if (d == 96) return bf16 ? smem_bytes<__nv_bfloat16, 96>(g) : smem_bytes<float, 96>(g);
  if (d == 128) return bf16 ? smem_bytes<__nv_bfloat16, 128>(g) : smem_bytes<float, 128>(g);
  return -1;
}

// Clusters of 8 blocks the card holds at once for that launch (a diagnostic:
// fewer than kh * b means the launch runs in more than one wave); a
// negative cudaError_t on failure.
extern "C" int preba_decode_attention_max_clusters(int d, int g, int bf16, int kh, int b) {
  if (d == 32)
    return bf16 ? max_clusters<__nv_bfloat16, 32>(g, kh, b) : max_clusters<float, 32>(g, kh, b);
  if (d == 64)
    return bf16 ? max_clusters<__nv_bfloat16, 64>(g, kh, b) : max_clusters<float, 64>(g, kh, b);
  if (d == 80)
    return bf16 ? max_clusters<__nv_bfloat16, 80>(g, kh, b) : max_clusters<float, 80>(g, kh, b);
  if (d == 96)
    return bf16 ? max_clusters<__nv_bfloat16, 96>(g, kh, b) : max_clusters<float, 96>(g, kh, b);
  if (d == 128)
    return bf16 ? max_clusters<__nv_bfloat16, 128>(g, kh, b) : max_clusters<float, 128>(g, kh, b);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// q [b, h, d], k/v [b, s, kh, d], valid_len [b] int32 -> out [b, h, d] and,
// where lse is not null, lse [b, h] fp32; bf16 != 0 for bfloat16 tensors,
// else float32; all contiguous and 16-byte aligned, h % kh == 0, d in {32,
// 64, 80, 96, 128}. Launches a grid of (8 kh, b) blocks in clusters of 8.
// Returns the cudaError_t of the launch.
extern "C" int preba_decode_attention(const void* q, const void* k, const void* v,
                                      const int* valid_len, void* out, float* lse, int b,
                                      int h, int kh, int s, int d, int bf16, float scale,
                                      void* stream) {
  if (b <= 0 || kh <= 0 || h % kh != 0 || b > 65535 || kh > 0x7fffffff / kCluster)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return bf16 ? launch<__nv_bfloat16, 32>(q, k, v, valid_len, out, lse, b, h, kh, s,
                                            scale, st)
                : launch<float, 32>(q, k, v, valid_len, out, lse, b, h, kh, s, scale, st);
  if (d == 64)
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, valid_len, out, lse, b, h, kh, s,
                                            scale, st)
                : launch<float, 64>(q, k, v, valid_len, out, lse, b, h, kh, s, scale, st);
  if (d == 80)
    return bf16 ? launch<__nv_bfloat16, 80>(q, k, v, valid_len, out, lse, b, h, kh, s,
                                            scale, st)
                : launch<float, 80>(q, k, v, valid_len, out, lse, b, h, kh, s, scale, st);
  if (d == 96)
    return bf16 ? launch<__nv_bfloat16, 96>(q, k, v, valid_len, out, lse, b, h, kh, s,
                                            scale, st)
                : launch<float, 96>(q, k, v, valid_len, out, lse, b, h, kh, s, scale, st);
  if (d == 128)
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, valid_len, out, lse, b, h, kh, s,
                                             scale, st)
                : launch<float, 128>(q, k, v, valid_len, out, lse, b, h, kh, s, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
