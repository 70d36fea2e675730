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
// bytes moved (read + write), so device-memory bytes (N = 16, T = 398,
// F = 80: ~2 MB). The TPU split it into a stats launch and a scale launch
// because only its sequential grid could carry the sums from one T-tile to
// the next. Here one block owns one whole utterance: threads map to
// feature columns (32 columns a warp, so every row read is one coalesced
// 128-byte line) and stride over T in kRows row groups; the kRows partial
// sums meet in shared memory, and the same block then rereads its
// utterance (now L2-resident) and writes the scaled output. One launch
// instead of two, and no sums round-trip through device memory.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;  // threads across feature columns
constexpr int kRows = 8;   // row groups striding over T

__global__ void __launch_bounds__(kCols * kRows)
normalize_kernel(const float* __restrict__ x, float* __restrict__ y,
                 int t_len, int n_feat, float eps) {
  extern __shared__ float sm[];  // [2][kRows][n_feat]
  float* s_sum = sm;
  float* s_sq = sm + kRows * n_feat;

  const long long base = static_cast<long long>(blockIdx.x) * t_len * n_feat;
  const float* xu = x + base;
  float* yu = y + base;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int c = tx; c < n_feat; c += kCols) {
    float s = 0.0f, q = 0.0f;
    for (int t = ty; t < t_len; t += kRows) {
      const float v = xu[static_cast<long long>(t) * n_feat + c];
      s += v;
      q = fmaf(v, v, q);
    }
    s_sum[ty * n_feat + c] = s;
    s_sq[ty * n_feat + c] = q;
  }
  __syncthreads();
  if (ty == 0) {
    const float inv_t = 1.0f / static_cast<float>(t_len);
    for (int c = tx; c < n_feat; c += kCols) {
      float s = 0.0f, q = 0.0f;
      for (int r = 0; r < kRows; ++r) {
        s += s_sum[r * n_feat + c];
        q += s_sq[r * n_feat + c];
      }
      const float mu = s * inv_t;
      const float var = fmaxf(q * inv_t - mu * mu, 0.0f);
      s_sum[c] = mu;  // row 0 now holds mu, and s_sq row 0 the scale
      s_sq[c] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  for (int t = ty; t < t_len; t += kRows) {
    for (int c = tx; c < n_feat; c += kCols) {
      const long long i = static_cast<long long>(t) * n_feat + c;
      yu[i] = (xu[i] - s_sum[c]) * s_sq[c];
    }
  }
}

}  // namespace

// x [n, t_len, n_feat] -> y [n, t_len, n_feat], fp32 and contiguous.
// Returns the cudaError_t of the launch.
extern "C" int preba_normalize(const float* x, float* y, int n, int t_len,
                               int n_feat, float eps, void* stream) {
  const dim3 block(kCols, kRows);
  const size_t smem = sizeof(float) * 2 * kRows * static_cast<size_t>(n_feat);
  normalize_kernel<<<n, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, t_len, n_feat, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int preba_normalize_smem_bytes(int n_feat) {
  return static_cast<int>(sizeof(float)) * 2 * kRows * n_feat;
}
