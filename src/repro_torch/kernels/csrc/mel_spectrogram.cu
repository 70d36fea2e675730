// Log-mel spectrogram for the DPU 'Mel spectrogram' functional unit, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mel_spectrogram.py,
// mel_spectrogram_pallas (_mel_kernel):
//
//     out = log(((F @ Cr)^2 + (F @ Ci)^2) @ FB + 1e-6)
//
// for windowed, zero-padded frames F [M, n_fft], DFT bases Cr/Ci
// [n_fft, n_bins] and the mel filterbank FB [n_bins, n_mels], all fp32.
//
// What bounds it on this card: the two DFT products dominate (about 0.53
// MFLOP a frame at n_fft 512, 257 bins), so at N = 16, L = 192,000 (6,368
// frames, ~3.6 GFLOP against ~14 MB) it is bound by fp32 operations. It
// runs on the CUDA cores with fp32 FMA and never TF32: the log-mel
// tolerance (2e-4) rules out TF32's 10-bit mantissa.
// The TPU kernel kept the power spectrum in VMEM between its three MXU
// products. Here one block owns a tile of kTF frames and walks the bins in
// chunks of kBC (257 bins -> 9 chunks, the last zero-padded): for each chunk
// it forms re and im for its [kTF, kBC] tile with a register-tiled product
// over K (staged through shared memory, kKC samples at a time), squares
// them into a shared-memory power tile, and multiply-accumulates that tile
// into the [kTF, n_mels] mel accumulator held in registers. The power
// spectrum never reaches device memory; log(. + 1e-6) is the epilogue.
#include <cuda_runtime.h>

namespace {

constexpr int kTF = 16;         // frames per block
constexpr int kBC = 32;         // DFT bins per chunk
constexpr int kKC = 32;         // samples per K step
constexpr int kThreads = 128;   // 8 x 16 threads, 2 frames x 2 bins each
constexpr int kMaxMels = 128;
constexpr int kMelPerThread = kMaxMels / 8;  // mel columns m = (tid % 8) + 8 j

__global__ void __launch_bounds__(kThreads)
mel_kernel(const float* __restrict__ frames, const float* __restrict__ cr,
           const float* __restrict__ ci, const float* __restrict__ fb,
           float* __restrict__ out, int n_frames, int n_fft, int n_bins,
           int n_mels) {
  __shared__ float f_s[kTF][kKC + 1];
  __shared__ float cr_s[kKC][kBC];
  __shared__ float ci_s[kKC][kBC];
  __shared__ float p_s[kTF][kBC + 1];
  extern __shared__ float fb_s[];  // [kBC][n_mels]

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kTF;
  const int ty = tid / 16;  // DFT tile: frames 2ty, 2ty+1
  const int tx = tid % 16;  //           bins   2tx, 2tx+1 (within the chunk)
  const int mf = tid / 8;   // mel tile: frame mf
  const int mm = tid % 8;   //           mels  mm + 8 j

  float mel[kMelPerThread];
#pragma unroll
  for (int j = 0; j < kMelPerThread; ++j) mel[j] = 0.0f;

  for (int b0 = 0; b0 < n_bins; b0 += kBC) {
    float re00 = 0.f, re01 = 0.f, re10 = 0.f, re11 = 0.f;
    float im00 = 0.f, im01 = 0.f, im10 = 0.f, im11 = 0.f;
    for (int k0 = 0; k0 < n_fft; k0 += kKC) {
      for (int e = tid; e < kTF * kKC; e += kThreads) {
        const int r = e / kKC, c = e % kKC;
        const int fr = f0 + r, k = k0 + c;
        f_s[r][c] = (fr < n_frames && k < n_fft)
                        ? frames[static_cast<long long>(fr) * n_fft + k]
                        : 0.0f;
      }
      for (int e = tid; e < kKC * kBC; e += kThreads) {
        const int r = e / kBC, c = e % kBC;
        const int k = k0 + r, b = b0 + c;
        const bool ok = k < n_fft && b < n_bins;
        const long long idx = static_cast<long long>(k) * n_bins + b;
        cr_s[r][c] = ok ? cr[idx] : 0.0f;
        ci_s[r][c] = ok ? ci[idx] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float a0 = f_s[2 * ty][kk];
        const float a1 = f_s[2 * ty + 1][kk];
        const float c0 = cr_s[kk][2 * tx];
        const float c1 = cr_s[kk][2 * tx + 1];
        const float s0 = ci_s[kk][2 * tx];
        const float s1 = ci_s[kk][2 * tx + 1];
        re00 = fmaf(a0, c0, re00);
        re01 = fmaf(a0, c1, re01);
        re10 = fmaf(a1, c0, re10);
        re11 = fmaf(a1, c1, re11);
        im00 = fmaf(a0, s0, im00);
        im01 = fmaf(a0, s1, im01);
        im10 = fmaf(a1, s0, im10);
        im11 = fmaf(a1, s1, im11);
      }
      __syncthreads();
    }
    // power of this chunk (zero-padded bins have zero bases -> zero power)
    p_s[2 * ty][2 * tx] = re00 * re00 + im00 * im00;
    p_s[2 * ty][2 * tx + 1] = re01 * re01 + im01 * im01;
    p_s[2 * ty + 1][2 * tx] = re10 * re10 + im10 * im10;
    p_s[2 * ty + 1][2 * tx + 1] = re11 * re11 + im11 * im11;
    for (int e = tid; e < kBC * n_mels; e += kThreads) {
      const int b = b0 + e / n_mels;
      fb_s[e] = b < n_bins ? fb[static_cast<long long>(b) * n_mels + e % n_mels]
                           : 0.0f;
    }
    __syncthreads();
    for (int bb = 0; bb < kBC; ++bb) {
      const float p = p_s[mf][bb];
      const float* fbr = fb_s + bb * n_mels;
#pragma unroll
      for (int j = 0; j < kMelPerThread; ++j) {
        const int m = mm + 8 * j;
        if (m < n_mels) mel[j] = fmaf(p, fbr[m], mel[j]);
      }
    }
    __syncthreads();  // p_s / fb_s are rewritten by the next chunk
  }

  const int fr = f0 + mf;
  if (fr >= n_frames) return;
#pragma unroll
  for (int j = 0; j < kMelPerThread; ++j) {
    const int m = mm + 8 * j;
    if (m < n_mels) out[static_cast<long long>(fr) * n_mels + m] = logf(mel[j] + 1e-6f);
  }
}

}  // namespace

extern "C" int preba_mel_max_mels() { return kMaxMels; }

// frames [n_frames, n_fft], cr/ci [n_fft, n_bins], fb [n_bins, n_mels] ->
// out [n_frames, n_mels], all fp32 and contiguous; n_mels <= kMaxMels.
// Returns the cudaError_t of the launch.
extern "C" int preba_mel(const float* frames, const float* cr, const float* ci,
                         const float* fb, float* out, int n_frames, int n_fft,
                         int n_bins, int n_mels, void* stream) {
  const dim3 grid((n_frames + kTF - 1) / kTF);
  const size_t smem = sizeof(float) * kBC * static_cast<size_t>(n_mels);
  mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, cr, ci, fb, out, n_frames, n_fft, n_bins, n_mels);
  return static_cast<int>(cudaGetLastError());
}
