// FIR decimation for the DPU 'Resample' functional unit, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/audio_resample.py,
// audio_resample_batch_pallas (_resample_kernel_b; the single-signal
// audio_resample_pallas is this kernel at N = 1):
//
//     y[n, i] = sum_k h[k] * xp[n, i*down + k]      for i < n_out
//
// over a stack of pre-padded signals xp [N, len_in] (fp32), taps h [n_taps].
//
// What bounds it on this card: at the served 1:3 rate (144 taps) each output
// costs 288 flops against 12 bytes of input read once, about 24 flops per
// byte, so the kernel sits near the balance point of fp32 CUDA-core
// throughput and HBM bandwidth (N = 16, L = 192,000: ~12 MB, ~0.3 GFLOP).
// The TPU kernel loaded each grid step's overlapping window by hand
// (pl.ANY + pl.load) because BlockSpecs cannot overlap, and folded the taps
// in as trace-time immediates. Here one block owns one (signal, tile of
// kTile outputs): it stages its overlapping input window (kTile*down +
// n_taps samples) and the taps in shared memory with coalesced loads, so
// every input sample is read from device memory about once, and each thread
// then accumulates one output in fp32, in tap order k = 0 .. n_taps-1.
// Consecutive threads read shared memory at stride `down`; with down odd
// (3) the 32 lanes of a warp hit 32 distinct banks.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // outputs per block = threads per block

__global__ void __launch_bounds__(kTile)
resample_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                float* __restrict__ y, int len_in, int n_taps, int down,
                int n_out) {
  extern __shared__ float smem[];
  float* h = smem;             // [n_taps]
  float* win = smem + n_taps;  // [kTile * down + n_taps]

  const int sig = blockIdx.y;
  const int out0 = blockIdx.x * kTile;
  const long long in0 = static_cast<long long>(out0) * down;
  const float* xs = x + static_cast<long long>(sig) * len_in;
  const int win_len = kTile * down + n_taps;

  for (int k = threadIdx.x; k < n_taps; k += blockDim.x) h[k] = taps[k];
  for (int j = threadIdx.x; j < win_len; j += blockDim.x) {
    const long long src = in0 + j;
    win[j] = src < len_in ? xs[src] : 0.0f;
  }
  __syncthreads();

  const int i = out0 + threadIdx.x;
  if (i >= n_out) return;
  const float* w = win + threadIdx.x * down;
  float acc = 0.0f;
  for (int k = 0; k < n_taps; ++k) acc = fmaf(h[k], w[k], acc);
  y[static_cast<long long>(sig) * n_out + i] = acc;
}

}  // namespace

extern "C" int preba_resample_smem_bytes(int n_taps, int down) {
  return static_cast<int>(sizeof(float)) * (2 * n_taps + kTile * down);
}

// x [n_sig, len_in], taps [n_taps] -> y [n_sig, n_out], all fp32 and
// contiguous. Returns the cudaError_t of the launch.
extern "C" int preba_resample(const float* x, const float* taps, float* y,
                              int n_sig, int len_in, int n_taps, int down,
                              int n_out, void* stream) {
  const dim3 grid((n_out + kTile - 1) / kTile, n_sig);
  const size_t smem = static_cast<size_t>(preba_resample_smem_bytes(n_taps, down));
  resample_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      x, taps, y, len_in, n_taps, down, n_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* preba_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
