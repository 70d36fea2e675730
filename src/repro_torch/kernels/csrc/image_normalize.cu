// Fused center crop + normalize for the DPU 'Crop' and 'Normalize'
// functional units, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/image_normalize.py,
// image_crop_normalize_pallas (_crop_norm_kernel):
//
//     y[n, r, c] = (x[n, y0 + r, x0 + c] - mean) * inv_std
//
// over a stack x [N, H, W] -> y [N, ch, cw], fp32, with inv_std = 1/std
// rounded to fp32 once by the caller, as the TPU kernel does.
//
// What bounds it on this card: one subtract and one multiply per element
// against 8 bytes (one read, one write), so device-memory bytes (N = 16,
// 224 x 224: ~6.4 MB). The TPU kernel meant to fold the crop into its
// block index map but could not (crop origins are not block-aligned) and
// sliced a copy first. Here the crop costs nothing: each CUDA block owns
// one output row and reads it at the crop origin straight from the
// uncropped stack, its threads on consecutive columns so reads and writes
// are coalesced. An uncropped stack is the same launch with y0 = x0 = 0.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
crop_normalize_kernel(const float* __restrict__ x, float* __restrict__ y,
                      int h, int w, int y0, int x0, int ch, int cw, float mean,
                      float inv_std) {
  const int row = blockIdx.x;              // n * ch + r
  const int n = row / ch, r = row % ch;
  const float* src = x + (static_cast<long long>(n) * h + y0 + r) * w + x0;
  float* dst = y + static_cast<long long>(row) * cw;
  for (int c = threadIdx.x; c < cw; c += kThreads) dst[c] = (src[c] - mean) * inv_std;
}

}  // namespace

// x [n, h, w] -> y [n, ch, cw] from the window at (y0, x0); fp32,
// contiguous. Returns the cudaError_t of the launch.
extern "C" int preba_crop_normalize(const float* x, float* y, int n, int h,
                                    int w, int y0, int x0, int ch, int cw,
                                    float mean, float inv_std, void* stream) {
  const long long rows = static_cast<long long>(n) * ch;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  crop_normalize_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, y, h, w, y0, x0, ch, cw, mean, inv_std);
  return static_cast<int>(cudaGetLastError());
}
