// Fused center crop + normalize for the DPU 'Crop' and 'Normalize'
// functional units, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/image_normalize.py,
// image_crop_normalize_pallas (_crop_norm_kernel):
//
//     y[n, r, c] = (x[n, y0 + r, x0 + c] - mean) * inv_std
//
// over a stack x [N, H, W] -> y [N, ch, cw], fp32, with inv_std = 1/std
// rounded to fp32 once by the caller, as the TPU kernel does. A subtract
// then a multiply, each rounded (no FMA can contract them), so the result
// equals the plain PyTorch version bit for bit.
//
// What bounds it on this card: one subtract and one multiply per element
// against 8 bytes (one read, one write), so device-memory bytes (N = 16,
// 224 x 224: ~6.4 MB, ~1.9 us at the HBM rate) plus the launch. The TPU
// kernel meant to fold the crop into its block index map but could not
// (crop origins are not block-aligned) and sliced a copy first. Here the
// crop costs nothing: the kernel reads the window in place. It is one
// grid-stride pass over the output in 16-byte vectors: a vector of 4
// output columns is one 16-byte load at the crop origin of its row and one
// 16-byte store, each thread keeps kUnroll vectors in flight, and the grid
// is sized to the work (at most 8 blocks an SM), not to the row count.
// The vector path needs both base pointers on 16 bytes and w, x0 and cw
// multiples of 4 (the serve shape 256 -> 224 at x0 = 16 has them); any
// other stack takes the same kernel's scalar instantiation, one element an
// item, in the same launch. An uncropped stack is y0 = x0 = 0.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // items in flight per thread per pass

template <bool VEC>
struct Item;
template <>
struct Item<true> {
  using T = float4;
  static constexpr int kWidth = 4;
  __device__ static T load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static T apply(T v, float mean, float inv_std) {
    return make_float4(__fmul_rn(__fsub_rn(v.x, mean), inv_std),
                       __fmul_rn(__fsub_rn(v.y, mean), inv_std),
                       __fmul_rn(__fsub_rn(v.z, mean), inv_std),
                       __fmul_rn(__fsub_rn(v.w, mean), inv_std));
  }
};
template <>
struct Item<false> {
  using T = float;
  static constexpr int kWidth = 1;
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static T apply(T v, float mean, float inv_std) {
    return __fmul_rn(__fsub_rn(v, mean), inv_std);
  }
};

// items: n * ch * cw / kWidth, each kWidth consecutive output columns of one row.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
crop_normalize_kernel(const float* __restrict__ x, float* __restrict__ y, int h, int w,
                      int y0, int x0, int ch, int cw, unsigned items, float mean,
                      float inv_std) {
  using I = Item<VEC>;
  const unsigned row_items = static_cast<unsigned>(cw) / I::kWidth;
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned i0 = blockIdx.x * kThreads + threadIdx.x; i0 < items; i0 += stride * kUnroll) {
    typename I::T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = i0 + u * stride;
      if (i < items) {
        const unsigned row = i / row_items;  // n * ch + r
        const unsigned c = (i - row * row_items) * I::kWidth;
        const unsigned n = row / ch, r = row - n * ch;
        v[u] = I::load(x + (static_cast<long long>(n) * h + y0 + r) * w + x0 + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = i0 + u * stride;
      if (i < items) reinterpret_cast<typename I::T*>(y)[i] = I::apply(v[u], mean, inv_std);
    }
  }
}

// The current card's SM count, cached per card (the caller sets the card
// of its tensors current before a launch).
int sm_count() {
  constexpr int kMaxCards = 64;
  static int n[kMaxCards] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxCards) dev = 0;
  if (n[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    n[dev] = v > 0 ? v : 132;
  }
  return n[dev];
}

}  // namespace

// 1 if preba_crop_normalize takes the 16-byte path for these arguments.
extern "C" int preba_crop_normalize_vectorized(const void* x, const void* y, int w, int x0,
                                               int cw) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0
         && w % 4 == 0 && x0 % 4 == 0 && cw % 4 == 0;
}

// x [n, h, w] -> y [n, ch, cw] from the window at (y0, x0); fp32,
// contiguous. Returns the cudaError_t of the launch.
extern "C" int preba_crop_normalize(const float* x, float* y, int n, int h, int w, int y0,
                                    int x0, int ch, int cw, float mean, float inv_std,
                                    void* stream) {
  const long long elems = static_cast<long long>(n) * ch * cw;
  if (elems <= 0 || elems > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = preba_crop_normalize_vectorized(x, y, w, x0, cw);
  const unsigned items = static_cast<unsigned>(vec ? elems / 4 : elems);
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long cap = 8LL * sm_count();
  long long need = (items + per_block - 1) / per_block;
  if (need < sm_count()) {  // a small stack: one item a thread, over more SMs
    const long long one = (items + kThreads - 1) / kThreads;
    need = one < sm_count() ? one : sm_count();
  }
  const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    crop_normalize_kernel<true><<<blocks, kThreads, 0, s>>>(x, y, h, w, y0, x0, ch, cw, items,
                                                           mean, inv_std);
  } else {
    crop_normalize_kernel<false><<<blocks, kThreads, 0, s>>>(x, y, h, w, y0, x0, ch, cw, items,
                                                            mean, inv_std);
  }
  return static_cast<int>(cudaGetLastError());
}
