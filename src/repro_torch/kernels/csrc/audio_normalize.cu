// Per-utterance mean/variance normalize for the DPU 'Normalize' functional
// unit, on Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/audio_normalize.py,
// audio_normalize_batch_pallas (_stats_kernel_b, then _scale_kernel_b; the
// single audio_normalize_pallas is this kernel at N = 1):
//
//     mu  = sum_t x[n, t, f] / T
//     var = max(sum_t x[n, t, f]^2 / T - mu^2, 0)
//     y[n, t, f] = (x[n, t, f] - mu) * rsqrt(var + eps)
//
// over a stack x [N, T, F] of same-shape utterances (fp32).
//
// What bounds it on this card: a handful of flops per element against 8
// bytes moved (one read, one write), so device-memory bytes (N = 16,
// T = 2,998, F = 80: 30.7 MB, 9.2 us at 3.35 TB/s), and below a few MB the
// launch and the latency of its dependent steps. The TPU split it into a
// stats launch and a scale launch because only its sequential grid could
// carry the sums from one T-tile to the next. One block walking a whole
// utterance twice would be latency-bound instead: flat in N, linear in T,
// one L2 round trip a group of rows, and one SM an utterance.
//
// Design: a thread block cluster of C blocks per utterance (grid C x N):
// C = 4 below T = 998 rows (10 s of audio), else 8 (the portable maximum),
// fewer when T < 4. C is chosen from T alone: from T = 998 on, 8 blocks
// take less time than 4 summed over a stack of 1 and of 16 (timed with
// tools/kernel_ab.py on trees that differ in kLongRows; PERF.md). Block r
// owns the rows [r T / C, (r + 1) T / C). Where that span fits in shared
// memory it is read from device memory once: one thread stages it with
// one 1-D bulk copy (TMA, cp.async.bulk, completing on an mbarrier). A
// thread owns W adjacent columns (W = 4: 16-byte accesses) and every
// lanes-th row of the span (lanes from the ceil(F / 4) column groups, on
// either path); its partial sums of x and x^2 meet the other lanes' in
// shared memory; after cluster.sync() every block reads the C block sums
// through distributed shared memory (mapa + ld.shared::cluster, all in
// flight at once), adds them in rank order and computes mu and the scale
// itself, so all C blocks agree bit for bit. Each block then scales its span from
// shared memory over the same (columns, lanes) items, mu and the scale in
// registers, and stores it once in 16-byte stores. The block arrives on
// the cluster barrier once it has read its peers and waits on it before
// it exits, so no block leaves while a peer still reads its shared memory.
// One launch a stack; no sums round-trip through device memory. Tried on
// the H100 and dropped, each slower: four or eight bulk copies a span
// (each with its own mbarrier wait), 512 threads a block, and pushing the
// sums into every peer (st.shared::cluster) instead of pulling them.
//
// The plan (C, the span, whether it is staged, the lanes) depends on
// (T, F) only, and each column's rows meet in the same chains and trees on
// the 16-byte and the scalar path, so an utterance's output is the same
// bits in any stack, aligned or not. Where the span does not fit in
// shared memory (F = 80: from T = 5,601) the same launch reads it from
// device memory for the sums and again for the scale. The 16-byte
// instantiation needs both base pointers on 16 bytes and F a multiple of 4
// (so every span and bulk copy is on 16 bytes); any other stack takes the
// scalar instantiation (W = 1, 4-byte cp.async staging) in the same launch.
//
// Summation order: an empty mel band makes a feature column constant
// (log 1e-6 = -13.8155); its variance is 0, its scale rsqrt(1e-5) = 316,
// and every ulp by which mu misses the constant comes out x316. A long
// serial fp32 chain drifts there (one chain over T = 2,998 rows: 0.16 off,
// 50x the 3e-3 tolerance). Each column's sum here is a tree of short
// chains: a thread's rows go round-robin to 4 running sums, which meet
// pairwise; then fixed pairwise trees over the block's lanes and over the
// cluster's ranks (value i meets value i + h for h = N/2, ..., 2, 1). At
// F = 80 and T = 2,998 (C = 8: 375 rows a block, 12 lanes, 32 rows a
// thread) the longest serial chain is 8 additions, then 2 + 5 + 3 tree
// levels; the same at F = 81 (21 column groups: 12 lanes).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinLanes = 8;      // row lanes a column group, at least
constexpr int kMaxLanes = 32;     // and at most
constexpr int kChains = 4;        // running sums a thread keeps for each of its columns
constexpr int kCluster = 8;       // blocks an utterance of kLongRows rows or more (portable max)
constexpr int kShortCluster = 4;  // ... and of fewer
constexpr int kLongRows = 998;
constexpr int kBarBytes = 128;    // the mbarrier, at the head of shared memory
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can have on sm_90

// Row lanes for ncg column groups: as many as fill the block, within
// [8, 32] (past 32 column groups the threads loop over the groups, so that
// a wide F does not lengthen each thread's chain of rows).
__host__ __device__ constexpr int lanes_for(int ncg) {
  return kThreads / ncg < kMinLanes ? kMinLanes
                                    : (kThreads / ncg < kMaxLanes ? kThreads / ncg : kMaxLanes);
}

// Row lanes for F features: those of its ceil(F / 4) column groups, on
// the scalar path too, so that a column's rows meet in the same order.
__host__ __device__ constexpr int lanes_of(int f) { return lanes_for((f + 3) / 4); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both addresses on 16 bytes) from
// global into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the barrier's first phase has completed (its copy has landed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The distributed-shared-memory address of this block's shared address p
// in block `rank` of the cluster, and a load from it.
__device__ __forceinline__ unsigned map_rank(unsigned p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(p), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

// v[i] += v[i + h] for h = H, H/2, ..., 1: a fixed pairwise tree whose
// indices are all compile-time, so v stays in registers.
template <int H, int N>
__device__ __forceinline__ void fold(float (&v)[N]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int i = 0; i < H; ++i) v[i] += v[i + H];
    fold<H / 2>(v);
  }
}

// The sum of load(0), ..., load(n - 1), n <= N, in that tree (absent values
// are 0, which adds exactly).
template <int N, typename Load>
__device__ __forceinline__ float tree_sum(int n, Load load) {
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = i < n ? load(i) : 0.f;
  fold<N / 2>(v);
  return v[0];
}

// W adjacent columns: one 16-byte access, or one float.
template <bool VEC>
struct Cols;
template <>
struct Cols<true> {
  static constexpr int kW = 4;
  template <bool GLOBAL>
  __device__ static void load(const float* p, float* v) {
    const float4 a = GLOBAL ? __ldg(reinterpret_cast<const float4*>(p))
                            : *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Cols<false> {
  static constexpr int kW = 1;
  template <bool GLOBAL>
  __device__ static void load(const float* p, float* v) {
    v[0] = GLOBAL ? __ldg(p) : *p;
  }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};

// Shared memory: the mbarrier [kBarBytes], then (STAGED) the span
// [rows_max, F] rounded up to 16 bytes, then the partial sums of x and x^2
// [lanes, F] each, then mu and the scale [F] each.
template <bool VEC, bool STAGED>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const float* __restrict__ x, float* __restrict__ y, int t_len, int n_feat,
                 int c_n, float eps) {
  using C = Cols<VEC>;
  constexpr int W = C::kW;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* stage = reinterpret_cast<float*>(smem + kBarBytes);
  const int ncg = n_feat / W;
  const int lanes = lanes_of(n_feat);
  const int rows_max = (t_len + c_n - 1) / c_n;
  float* s_part = stage + (STAGED ? (rows_max * n_feat + 3) / 4 * 4 : 0);
  float* q_part = s_part + lanes * n_feat;
  float* mu_s = q_part + lanes * n_feat;
  float* sc_s = mu_s + n_feat;

  const int rank = static_cast<int>(blockIdx.x % c_n);  // the block's rank in its 1-D cluster
  const long long n = blockIdx.x / c_n;
  const int t0 = static_cast<int>(static_cast<long long>(rank) * t_len / c_n);
  const int rows = static_cast<int>(static_cast<long long>(rank + 1) * t_len / c_n) - t0;
  const long long base = (n * t_len + t0) * n_feat;
  const float* xs = x + base;  // this block's span: rows x F, contiguous
  float* ys = y + base;
  const int tid = threadIdx.x;

  const float* src = xs;
  if constexpr (STAGED) {
    src = stage;
    if constexpr (VEC) {
      if (tid == 0) {
        mbar_init(bar);
        mbar_fence_init();
        bulk_load(stage, xs, static_cast<unsigned>(rows * n_feat * 4), bar);
      }
      __syncthreads();  // the barrier is initialised before anyone waits on it
      mbar_wait(bar);
    } else {
      for (int e = tid; e < rows * n_feat; e += kThreads) cp_async4(stage + e, xs + e);
      cp_async_wait_all();
      __syncthreads();
    }
  }

  // 1. Column partial sums: item (g, l) is column group g (W columns) over
  // the rows l, l + lanes, ... of the span, in ascending order; its j-th
  // row goes to chain j % kChains, and the chains meet pairwise at the end.
  for (int item = tid; item < ncg * lanes; item += kThreads) {
    const int g = item % ncg, l = item / ncg;
    float s[kChains][W], q[kChains][W];
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
#pragma unroll
      for (int w = 0; w < W; ++w) s[k][w] = 0.f, q[k][w] = 0.f;
    }
    auto add = [&](int k, int r) {
      float v[W];
      C::template load<!STAGED>(src + static_cast<long long>(r) * n_feat + g * W, v);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        s[k][w] += v[w];
        q[k][w] += __fmul_rn(v[w], v[w]);  // x^2 rounded, then added, as the plain version
      }
    };
    int r = l;
    for (; r + (kChains - 1) * lanes < rows; r += kChains * lanes) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) add(k, r + k * lanes);
    }
#pragma unroll
    for (int k = 0; k < kChains - 1; ++k) {
      if (r < rows) add(k, r);
      r += lanes;
    }
#pragma unroll
    for (int h = kChains / 2; h >= 1; h /= 2) {
#pragma unroll
      for (int k = 0; k < h; ++k) {
#pragma unroll
        for (int w = 0; w < W; ++w) s[k][w] += s[k + h][w], q[k][w] += q[k + h][w];
      }
    }
    C::store(s_part + l * n_feat + g * W, s[0]);
    C::store(q_part + l * n_feat + g * W, q[0]);
  }
  __syncthreads();

  // 2. The block's column sums over its lanes, into row 0 of the partials.
  for (int c = tid; c < n_feat; c += kThreads) {
    const float s = tree_sum<kMaxLanes>(lanes, [&](int l) { return s_part[l * n_feat + c]; });
    const float q = tree_sum<kMaxLanes>(lanes, [&](int l) { return q_part[l * n_feat + c]; });
    s_part[c] = s;
    q_part[c] = q;
  }
  cluster_arrive();  // cluster.sync(): every block's sums are written
  cluster_wait();

  // 3. The cluster's sums over its ranks, then mu and the scale: every
  // block computes them itself from the same values in the same order.
  const float tf = static_cast<float>(t_len);
  for (int c = tid; c < n_feat; c += kThreads) {
    const auto sa = smem_addr(s_part + c), qa = smem_addr(q_part + c);
    const float s = tree_sum<kCluster>(c_n, [&](int r) { return ld_cluster(map_rank(sa, r)); });
    const float q = tree_sum<kCluster>(c_n, [&](int r) { return ld_cluster(map_rank(qa, r)); });
    const float mu = __fdiv_rn(s, tf);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(q, tf), __fmul_rn(mu, mu)), 0.f);
    mu_s[c] = mu;
    sc_s[c] = rsqrtf(__fadd_rn(var, eps));
  }
  cluster_arrive();  // this block has read its peers' sums
  __syncthreads();   // mu and the scale are set for every thread

  // 4. Scale the span and store it once, over the same items as step 1:
  // a thread's mu and scale stay in registers, and a warp's loads and
  // stores are contiguous.
  for (int item = tid; item < ncg * lanes; item += kThreads) {
    const int g = item % ncg, l = item / ncg;
    float mu[W], sc[W];
    C::template load<false>(mu_s + g * W, mu);
    C::template load<false>(sc_s + g * W, sc);
#pragma unroll 4
    for (int r = l; r < rows; r += lanes) {
      const long long off = static_cast<long long>(r) * n_feat + g * W;
      float v[W];
      C::template load<!STAGED>(src + off, v);
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = __fmul_rn(__fsub_rn(v[w], mu[w]), sc[w]);
      C::store(ys + off, v);
    }
  }
  cluster_wait();  // no block leaves while a peer still reads its shared memory
}

struct Plan {
  int c, rows, staged, smem;
};

// The launch plan for T rows of F features; smem < 0 for a shape whose
// sums no block can hold.
Plan make_plan(int t, int f) {
  Plan p = {0, 0, 0, -1};
  if (t < 1 || f < 1) return p;
  p.c = t < kLongRows ? kShortCluster : kCluster;
  while (p.c > t) p.c >>= 1;
  p.rows = (t + p.c - 1) / p.c;
  const long long fixed = kBarBytes + 4LL * (2LL * lanes_of(f) * f + 2LL * f);
  const long long staged = fixed + 4LL * ((static_cast<long long>(p.rows) * f + 3) / 4 * 4);
  if (fixed > kMaxSmem) return p;
  p.staged = staged <= kMaxSmem;
  p.smem = static_cast<int>(p.staged ? staged : fixed);
  return p;
}

template <bool VEC, bool STAGED>
int launch(const Plan& p, const float* x, float* y, int n, int t, int f, float eps,
           cudaStream_t stream) {
  auto kernel = normalize_kernel<VEC, STAGED>;
  // CUDA holds the attribute per card: set it once on each card a launch
  // meets (per instantiation; setting it twice is harmless)
  constexpr int kMaxCards = 64;
  static bool configured[kMaxCards] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxCards || !configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < kMaxCards) configured[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.c);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.c) * static_cast<unsigned>(n));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, y, t, f, p.c, eps);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// The plan for T rows of F features: blocks an utterance (4 or 8 by T),
// rows a block at most, and 1 if each block's span is staged in shared
// memory. Returns 0, or cudaErrorInvalidValue for a shape the kernel does
// not take.
extern "C" int preba_normalize_plan(int t, int f, int* c, int* rows, int* staged) {
  const Plan p = make_plan(t, f);
  if (p.smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  *c = p.c, *rows = p.rows, *staged = p.staged;
  return 0;
}

// 1 if preba_normalize takes the 16-byte path for these arguments.
extern "C" int preba_normalize_vectorized(const void* x, const void* y, int f) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0
         && f % 4 == 0;
}

// x [n, t_len, n_feat] -> y [n, t_len, n_feat], fp32 and contiguous, with
// the plan of preba_normalize_plan(t_len, n_feat). Returns the cudaError_t
// of the launch.
extern "C" int preba_normalize(const float* x, float* y, int n, int t_len, int n_feat,
                               float eps, void* stream) {
  const Plan p = make_plan(t_len, n_feat);
  if (p.smem < 0 || n < 1 || static_cast<long long>(n) * p.c > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = preba_normalize_vectorized(x, y, n_feat);
  if (vec)
    return p.staged ? launch<true, true>(p, x, y, n, t_len, n_feat, eps, s)
                    : launch<true, false>(p, x, y, n, t_len, n_feat, eps, s);
  return p.staged ? launch<false, true>(p, x, y, n, t_len, n_feat, eps, s)
                  : launch<false, false>(p, x, y, n, t_len, n_feat, eps, s);
}
