// Log-mel spectrogram for the DPU 'Mel spectrogram' functional unit, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mel_spectrogram.py,
// mel_spectrogram_pallas (_mel_kernel), together with the framing that
// src/repro/kernels/ops.py::mel_spectrogram_batch does around it:
//
//     out[n, j] = log(|DFT_n_fft(y[n, j hop + t] win[t], t < frame, 0 after)|^2
//                     @ FB + 1e-6)
//
// for a same-length stack y [N, L], fp32, into out [N, T, n_mels].
//
// The TPU kernel ran the DFT as two dense products because the MXU wants
// products (the FPGA unit's FFT butterflies "become two dense DFT
// matmuls"). Here it is an FFT. The real trick: the frame's even and odd
// samples are packed into M = n_fft/2 complex points z, a Stockham
// (autosort) FFT of M points runs log2 M / 3 radix-8 passes plus a last
// radix-4 or radix-2 pass where log2 M is not a multiple of 3 (M = 256 at
// n_fft 512: 8, 8, 4), and a split step recovers the n_fft/2 + 1 bins,
// X[k] = (Z[k] + Z*[M-k])/2 - i W^k (Z[k] - Z*[M-k])/2. M/8 threads own a
// frame, 8 complex values each in registers (a warp a frame at n_fft 512);
// a block of 128 threads owns 128 / (M/8) frames (4 at n_fft 512). The
// first pass reads the frame straight from the signal, windowed and
// zero-padded past `frame`; each later pass reads and writes a ping-pong
// pair of shared-memory planes (re and im apart, one float of padding every
// 8, so the strided writes of a pass hit distinct banks). Twiddles come
// from a table W_n^k (k < n_fft, float64 on the host rounded to fp32),
// staged in shared memory with the filterbank's band weights. The power
// spectrum stays in shared memory; each mel filter sums only its band of
// bins [lo, hi) with the filterbank's own weights in ascending bin order
// (outside the band the filterbank holds exact zeros), and log(. + 1e-6) is
// the epilogue, written for the block's frames as one contiguous run. No
// TF32 and no tensor core: log-mel must stay within 2e-4.
//
// What bounds it on this card: at the serve shape (16 signals x 98 frames)
// it moves ~1.5 MB (signal and output) for ~22 MFLOP, a bound of ~0.0005
// ms; one launch of 392 blocks, 4 block barriers, no device-memory
// intermediate. What is left is the launch and the in-block work (on an
// H100 SXM at 700 W: 0.0106 ms against a 0.005 ms launch floor, and 0.022
// ms at 4x the frames, so the passes and band sums, not memory, bound it).
// The previous design (two dense DFT products over frames framed by torch,
// 9 bin chunks x 16 K steps of load-barrier-FMA a block, 98 blocks) took
// 0.4400 ms there.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxMels = 128;
constexpr float kRsqrt2 = 0.70710678118654752f;

// shared-memory index of element p of a plane: one float of padding every 8
__host__ __device__ constexpr int pad(int p) { return p + (p >> 3); }

__device__ __forceinline__ void cmul(float& re, float& im, float2 w) {
  const float r = fmaf(re, w.x, -im * w.y);
  im = fmaf(re, w.y, im * w.x);
  re = r;
}

// (a, b) <- (a + b, a - b)
__device__ __forceinline__ void bfly(float& ar, float& ai, float& br, float& bi) {
  const float tr = ar - br, ti = ai - bi;
  ar += br;
  ai += bi;
  br = tr;
  bi = ti;
}

// in-place 4-point DFT of v[o], v[o + s], v[o + 2s], v[o + 3s]
__device__ __forceinline__ void dft4(float* re, float* im, int o, int s) {
  float* r0 = re + o;
  float* i0 = im + o;
  bfly(r0[0], i0[0], r0[2 * s], i0[2 * s]);       // c0 +- c2
  bfly(r0[s], i0[s], r0[3 * s], i0[3 * s]);       // c1 +- c3
  const float t = r0[3 * s];                      // (c1 - c3) * -i
  r0[3 * s] = i0[3 * s];
  i0[3 * s] = -t;
  bfly(r0[0], i0[0], r0[s], i0[s]);               // Y0, Y2
  bfly(r0[2 * s], i0[2 * s], r0[3 * s], i0[3 * s]);  // Y1, Y3
  // now r0[0]=Y0, r0[s]=Y2, r0[2s]=Y1, r0[3s]=Y3: swap the middle pair
  float u = r0[s];
  r0[s] = r0[2 * s];
  r0[2 * s] = u;
  u = i0[s];
  i0[s] = i0[2 * s];
  i0[2 * s] = u;
}

template <int kR>
__device__ __forceinline__ void dft(float* re, float* im);

template <>
__device__ __forceinline__ void dft<2>(float* re, float* im) {
  bfly(re[0], im[0], re[1], im[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float* re, float* im) {
  dft4(re, im, 0, 1);
}

// 8-point DFT, decimation in frequency: even outputs are the 4-point DFT of
// v[q] + v[q + 4], odd outputs that of (v[q] - v[q + 4]) W_8^q.
template <>
__device__ __forceinline__ void dft<8>(float* re, float* im) {
#pragma unroll
  for (int q = 0; q < 4; ++q) bfly(re[q], im[q], re[q + 4], im[q + 4]);
  float t = re[5];                                 // * W_8 = (1 - i)/sqrt2
  re[5] = kRsqrt2 * (t + im[5]);
  im[5] = kRsqrt2 * (im[5] - t);
  t = re[6];                                       // * W_8^2 = -i
  re[6] = im[6];
  im[6] = -t;
  t = re[7];                                       // * W_8^3 = -(1 + i)/sqrt2
  re[7] = kRsqrt2 * (im[7] - t);
  im[7] = -kRsqrt2 * (t + im[7]);
  dft4(re, im, 0, 1);                              // X0, X2, X4, X6
  dft4(re, im, 4, 1);                              // X1, X3, X5, X7
  float ur[8], ui[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ur[2 * q] = re[q];
    ui[2 * q] = im[q];
    ur[2 * q + 1] = re[q + 4];
    ui[2 * q + 1] = im[q + 4];
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    re[q] = ur[q];
    im[q] = ui[q];
  }
}

// One Stockham pass of radix kR after passes whose radices multiply to kNs:
// butterfly j reads src[j + r M/kR], multiplies by W_M^(r (j % kNs) M/(kNs kR)),
// transforms, and writes dst[(j / kNs) kNs kR + j % kNs + r kNs]. Each of
// the frame's M/8 threads takes 8/kR butterflies.
template <int kM, int kR, int kNs>
__device__ __forceinline__ void radix_pass(const float* sre, const float* sim, float* dre,
                                           float* dim, const float2* tw, int t) {
  constexpr int kTPF = kM / 8;
#pragma unroll
  for (int b = 0; b < 8 / kR; ++b) {
    const int j = t + b * kTPF;
    const int k = j % kNs;
    float re[kR], im[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      re[r] = sre[pad(j + r * (kM / kR))];
      im[r] = sim[pad(j + r * (kM / kR))];
    }
#pragma unroll
    for (int r = 1; r < kR; ++r) cmul(re[r], im[r], tw[2 * r * k * (kM / (kNs * kR))]);
    dft<kR>(re, im);
    const int d = (j / kNs) * kNs * kR + k;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      dre[pad(d + r * kNs)] = re[r];
      dim[pad(d + r * kNs)] = im[r];
    }
  }
}

// Planes of the block's shared buffers: buffer b (0, 1), part c (0 re,
// 1 im), frame f, each pad(kM) floats.
template <int kM, int kFPB>
__device__ __forceinline__ float* plane(float* buf, int b, int c, int f) {
  return buf + ((b * 2 + c) * kFPB + f) * pad(kM);
}

// The radix of the pass that follows passes whose radices multiply to ns:
// 8 while 8 divides what is left, then the remainder 4 or 2.
__host__ __device__ constexpr int radix_after(int m, int ns) { return m / ns >= 8 ? 8 : m / ns; }

__host__ __device__ constexpr int n_passes(int m) {
  int n = 0;
  for (int ns = 1; ns < m; ns *= radix_after(m, ns)) ++n;
  return n;
}

// Passes 2.. of the FFT, from buffer kBuf on.
template <int kM, int kFPB, int kNs, int kBuf>
__device__ __forceinline__ void passes(float* buf, const float2* tw, int f, int t) {
  if constexpr (kNs < kM) {
    constexpr int kR = radix_after(kM, kNs);
    radix_pass<kM, kR, kNs>(plane<kM, kFPB>(buf, kBuf, 0, f), plane<kM, kFPB>(buf, kBuf, 1, f),
                            plane<kM, kFPB>(buf, 1 - kBuf, 0, f),
                            plane<kM, kFPB>(buf, 1 - kBuf, 1, f), tw, t);
    __syncthreads();
    passes<kM, kFPB, kNs * kR, 1 - kBuf>(buf, tw, f, t);
  }
}

template <int kM>
__host__ __device__ constexpr int frames_per_block() { return kThreads / (kM / 8); }

template <int kM>
size_t smem_bytes(int n_weights) {
  return sizeof(float) * (4 * kM + ((n_weights + 3) & ~3)
                          + 4 * frames_per_block<kM>() * pad(kM));
}

template <int kM>
__global__ void __launch_bounds__(kThreads)
mel_kernel(const float* __restrict__ y, const float* __restrict__ win,
           const float2* __restrict__ tw, const float* __restrict__ weights,
           const int* __restrict__ bands, float* __restrict__ out, int n_frames,
           int frames_per_signal, int length, int hop, int frame, int n_mels,
           int n_weights) {
  constexpr int kN = 2 * kM;
  constexpr int kTPF = kM / 8;                     // threads a frame
  constexpr int kFPB = frames_per_block<kM>();     // frames a block
  extern __shared__ __align__(16) float smem[];
  float2* tw_s = reinterpret_cast<float2*>(smem);  // [kN]
  float* w_s = smem + 2 * kN;                      // [n_weights]
  float* buf = w_s + ((n_weights + 3) & ~3);       // [2][2][kFPB][pad(kM)]

  const int tid = threadIdx.x;
  const int f = tid / kTPF, t = tid % kTPF;
  const int g0 = blockIdx.x * kFPB;
  const int g = g0 + f;
  const bool live = g < n_frames;
  const int sig = g / frames_per_signal;
  const float* x = y + (live ? static_cast<long long>(sig) * length
                               + static_cast<long long>(g - sig * frames_per_signal) * hop
                             : 0LL);

  // pass 1 (radix 8, all twiddles 1): z[t + r M/8] = x[2q] + i x[2q + 1]
  // windowed, zero past `frame`; the staging of twiddles and band weights
  // is issued behind the frame's loads.
  {
    float re[8], im[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int s = 2 * (t + r * kTPF);
      re[r] = live && s < frame ? x[s] * __ldg(win + s) : 0.f;
      im[r] = live && s + 1 < frame ? x[s + 1] * __ldg(win + s + 1) : 0.f;
    }
    for (int i = tid; i < kN; i += kThreads) tw_s[i] = tw[i];
    for (int i = tid; i < n_weights; i += kThreads) w_s[i] = weights[i];
    dft<8>(re, im);
    float* dre = plane<kM, kFPB>(buf, 0, 0, f);
    float* dim = plane<kM, kFPB>(buf, 0, 1, f);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      dre[pad(8 * t + r)] = re[r];
      dim[pad(8 * t + r)] = im[r];
    }
  }
  __syncthreads();
  passes<kM, kFPB, 8, 0>(buf, tw_s, f, t);
  constexpr int res = (n_passes(kM) - 1) % 2;  // the buffer the last pass wrote

  // split: X[k] = E + W^k O, k = 0..M, into the power plane (the other buffer)
  {
    const float* zre = plane<kM, kFPB>(buf, res, 0, f);
    const float* zim = plane<kM, kFPB>(buf, res, 1, f);
    float* p = plane<kM, kFPB>(buf, 1 - res, 0, f);
    for (int k = t; k <= kM; k += kTPF) {
      const int a = k & (kM - 1), b = (kM - k) & (kM - 1);
      const float ar = zre[pad(a)], ai = zim[pad(a)];
      const float br = zre[pad(b)], bi = -zim[pad(b)];   // conj(Z[M - k])
      const float er = 0.5f * (ar + br), ei = 0.5f * (ai + bi);
      float orr = 0.5f * (ai - bi), oi = -0.5f * (ar - br);  // -i (Z - Z*) / 2
      cmul(orr, oi, tw_s[k]);
      const float xr = er + orr, xi = ei + oi;
      p[k] = xr * xr + xi * xi;
    }
  }
  __syncthreads();

  // mel bands and log, one (frame, mel) a thread: out[g0 n_mels + e]
  for (int e = tid; e < kFPB * n_mels; e += kThreads) {
    const int ff = e / n_mels, m = e - ff * n_mels;
    if (g0 + ff >= n_frames) break;
    const float* p = plane<kM, kFPB>(buf, 1 - res, 0, ff);
    const int lo = __ldg(bands + 3 * m), hi = __ldg(bands + 3 * m + 1);
    const float* w = w_s + __ldg(bands + 3 * m + 2) - lo;
    float s = 0.f;
    for (int k = lo; k < hi; ++k) s = fmaf(w[k], p[k], s);
    out[static_cast<long long>(g0) * n_mels + e] = logf(s + 1e-6f);
  }
}

template <int kM>
int launch(const float* y, const float* win, const float* tw, const float* weights,
           const int* bands, float* out, int n_signals, int length, int frame, int hop,
           int n_mels, int n_weights, cudaStream_t stream) {
  const int per_signal = 1 + (length - frame) / hop;
  const long long frames = static_cast<long long>(n_signals) * per_signal;
  if (frames > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t bytes = smem_bytes<kM>(n_weights);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mel_kernel<kM>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kFPB = frames_per_block<kM>();
  const int blocks = static_cast<int>((frames + kFPB - 1) / kFPB);
  mel_kernel<kM><<<blocks, kThreads, bytes, stream>>>(
      y, win, reinterpret_cast<const float2*>(tw), weights, bands, out,
      static_cast<int>(frames), per_signal, length, hop, frame, n_mels, n_weights);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int preba_mel_max_mels() { return kMaxMels; }

// y [n_signals, length] fp32, win [frame], tw [n_fft, 2] (W_n^k), weights
// [n_weights] and bands [n_mels, 3] int32 (lo, hi, offset into weights) ->
// out [n_signals, 1 + (length - frame) / hop, n_mels]; all contiguous, tw on
// 8 bytes. n_fft a power of two in [64, 2048], 0 < frame <= n_fft, length
// >= frame, n_mels <= kMaxMels; every band within [0, n_fft/2 + 1). Returns the cudaError_t of the launch.
extern "C" int preba_mel(const float* y, const float* win, const float* tw,
                         const float* weights, const int* bands, float* out, int n_signals,
                         int length, int frame, int hop, int n_fft, int n_mels,
                         int n_weights, void* stream) {
  if (n_signals <= 0 || frame <= 0 || frame > n_fft || length < frame || hop <= 0
      || n_mels <= 0 || n_mels > kMaxMels || n_weights < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 64: return launch<32>(y, win, tw, weights, bands, out, n_signals, length, frame, hop, n_mels, n_weights, s);
    case 128: return launch<64>(y, win, tw, weights, bands, out, n_signals, length, frame, hop, n_mels, n_weights, s);
    case 256: return launch<128>(y, win, tw, weights, bands, out, n_signals, length, frame, hop, n_mels, n_weights, s);
    case 512: return launch<256>(y, win, tw, weights, bands, out, n_signals, length, frame, hop, n_mels, n_weights, s);
    case 1024: return launch<512>(y, win, tw, weights, bands, out, n_signals, length, frame, hop, n_mels, n_weights, s);
    case 2048: return launch<1024>(y, win, tw, weights, bands, out, n_signals, length, frame, hop, n_mels, n_weights, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
