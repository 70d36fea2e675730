// Separable bilinear resize for the DPU 'Resize' functional unit, on Hopper
// (sm_90a): one launch for a stack of same-shape images.
//
// Replaces the TPU kernels src/repro/kernels/image_resize.py,
// image_resize_batch_pallas (_rows_kernel_b, then _cols_kernel; the single
// image_resize_pallas is the same two passes at N = 1), which compute
//
//     out[n] = Ry @ img[n] @ Rx^T          Ry [H_out, H], Rx [W_out, W]
//
// as two dense MXU products over a stack img [N, H, W], all fp32. A
// bilinear row of Ry or Rx has at most two non-zeros, so this kernel takes
// the matrices as taps (ops.resize_taps): for each output row o, the two
// columns idx[o] and their weights w[o], the matrix's own entries (a row
// with one non-zero names its column twice, the second weight 0). It keeps
// the reference's order of operations:
//
//     t[y, x]   = wy0 img[y0, x] + wy1 img[y1, x]     vertical taps, first
//     out[y, x] = wx0 t[y, x0]   + wx1 t[y, x1]       then horizontal taps
//
// so every output is within a few ulps of the dense products.
//
// What bounds it on this card: device-memory bytes. An output costs about
// 4 flops against 4-16 bytes read, far below the ~20 flops a byte at which
// fp32 arithmetic would bind, so the kernel uses no tensor cores (TF32
// could not meet the 1e-4 tolerance on pixels of ~255 anyway). At N = 16,
// 512 x 512 -> 256 x 256 the image and output are ~21 MB, ~6.3 us at
// 3.35 TB/s.
//
// Design: one block per (image, band of output rows). The block stages the
// x taps in shared memory, computes the vertical taps of its band straight
// from device memory into shared memory (t [band, W], never written to
// device memory), then the horizontal taps out of shared memory. Where W % 4
// == 0 the vertical pass reads and writes 16 bytes a thread (float4); a
// stack whose rows do not start on 16 bytes (W % 4 != 0) takes the scalar
// path. The horizontal pass gives consecutive outputs to consecutive
// threads, so each warp store fills whole 128-byte lines and the shared
// reads of t stride by the scale factor (2-way bank conflicts at scale 2,
// where a float4 of outputs a thread would make them 8-way). The band is 8
// rows, halved down to 1 until the grid has two blocks an SM or the shared
// memory fits 48 KB; each output is computed the same way whatever the band,
// so the result does not depend on N, the band or the launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBand = 8;
constexpr int kMinBlocks = 2 * 132;          // two blocks an SM
constexpr long long kSmemDefault = 48 * 1024;
constexpr long long kSmemMax = 227 * 1024;

// Shared bytes: the x taps (weights float2, columns int2) [w_out], then the
// vertical taps t [band, w] (16-byte aligned: 16 w_out bytes precede it).
long long smem_bytes(int band, int w, int w_out) {
  return 16LL * w_out + 4LL * band * w;
}

// Tap columns are clamped into [0, n): a tap outside the image reads its
// edge, never memory past it (ops.resize_taps builds none).
__device__ __forceinline__ int2 clamp_taps(int2 i, int n) {
  return make_int2(min(max(i.x, 0), n - 1), min(max(i.y, 0), n - 1));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
resize_kernel(const float* __restrict__ img, const int2* __restrict__ yidx,
              const float2* __restrict__ yw, const int2* __restrict__ xidx,
              const float2* __restrict__ xw, float* __restrict__ out, int h, int w,
              int h_out, int w_out, int band) {
  extern __shared__ float4 smem[];
  float2* xw_s = reinterpret_cast<float2*>(smem);
  int2* xi_s = reinterpret_cast<int2*>(xw_s + w_out);
  float* t = reinterpret_cast<float*>(xi_s + w_out);

  const int n = blockIdx.y, o0 = blockIdx.x * band;
  const int rows = min(band, h_out - o0);
  for (int e = threadIdx.x; e < w_out; e += kThreads) {
    xw_s[e] = xw[e];
    xi_s[e] = clamp_taps(xidx[e], w);
  }
  const float* src = img + static_cast<long long>(n) * h * w;
  if (kVec) {
    const int w4 = w / 4;
    for (int e = threadIdx.x; e < rows * w4; e += kThreads) {
      const int r = e / w4, x = e - r * w4;
      const int2 yi = clamp_taps(yidx[o0 + r], h);
      const float2 wy = yw[o0 + r];
      const float4 a = reinterpret_cast<const float4*>(src + static_cast<long long>(yi.x) * w)[x];
      const float4 b = reinterpret_cast<const float4*>(src + static_cast<long long>(yi.y) * w)[x];
      float4 v;
      v.x = fmaf(wy.y, b.x, wy.x * a.x);
      v.y = fmaf(wy.y, b.y, wy.x * a.y);
      v.z = fmaf(wy.y, b.z, wy.x * a.z);
      v.w = fmaf(wy.y, b.w, wy.x * a.w);
      reinterpret_cast<float4*>(t + r * w)[x] = v;
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += kThreads) {
      const int r = e / w, x = e - r * w;
      const int2 yi = clamp_taps(yidx[o0 + r], h);
      const float2 wy = yw[o0 + r];
      t[e] = fmaf(wy.y, src[static_cast<long long>(yi.y) * w + x],
                  wy.x * src[static_cast<long long>(yi.x) * w + x]);
    }
  }
  __syncthreads();
  float* dst = out + (static_cast<long long>(n) * h_out + o0) * w_out;
  for (int e = threadIdx.x; e < rows * w_out; e += kThreads) {
    const int r = e / w_out, x = e - r * w_out;
    const int2 xi = xi_s[x];
    const float2 wx = xw_s[x];
    const float* tr = t + r * w;
    dst[e] = fmaf(wx.y, tr[xi.y], wx.x * tr[xi.x]);
  }
}

}  // namespace

// img [n_img, h, w] -> out [n_img, h_out, w_out]; yidx/yw [h_out, 2] (int32,
// float32) and xidx/xw [w_out, 2] are the taps of ops.resize_taps, columns in
// [0, h) and [0, w) (others are clamped). All contiguous. Returns the
// cudaError_t of the launch.
extern "C" int preba_resize(const float* img, const int* yidx, const float* yw,
                            const int* xidx, const float* xw, float* out, int n_img,
                            int h, int w, int h_out, int w_out, void* stream) {
  if (n_img <= 0 || h <= 0 || w <= 0 || h_out <= 0 || w_out <= 0 || n_img > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  int band = kMaxBand;
  while (band > 1 && (static_cast<long long>((h_out + band - 1) / band) * n_img < kMinBlocks
                      || smem_bytes(band, w, w_out) > kSmemDefault))
    band /= 2;
  const long long bytes = smem_bytes(band, w, w_out);
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = w % 4 == 0 && reinterpret_cast<unsigned long long>(img) % 16 == 0;
  auto kernel = vec ? resize_kernel<true> : resize_kernel<false>;
  if (bytes > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((h_out + band - 1) / band, n_img);
  kernel<<<grid, kThreads, static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<const int2*>(yidx), reinterpret_cast<const float2*>(yw),
      reinterpret_cast<const int2*>(xidx), reinterpret_cast<const float2*>(xw), out, h, w,
      h_out, w_out, band);
  return static_cast<int>(cudaGetLastError());
}
