// FIR decimation for the DPU 'Resample' functional unit, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/audio_resample.py,
// audio_resample_batch_pallas (_resample_kernel_b; the single-signal
// audio_resample_pallas is this kernel at N = 1):
//
//     y[n, i] = sum_k h[k] * xz[n, i*down + k - pad_left]      for i < n_out
//
// over a stack of signals x [N, len_in] (fp32), taps h [n_taps], where xz
// is x inside [0, len_in) and zero outside. The kernel pads the signal
// itself: with pad_left = n_taps / 2 this is the reference's jnp.pad then
// the TPU kernel, with no padding pass before the launch; with pad_left = 0
// on a pre-padded stack it is the plain FIR.
//
// What bounds it on this card: at the served 1:3 rate (144 taps) each
// output costs 288 flops against 12 bytes of input read once, so the work
// is fp32 FMAs (N = 16, L = 48,000: 37 M FMAs, ~1.2 us at the CUDA cores'
// peak) once each sample is read from device memory about once. A block
// stages its overlapping input window (T*R*down + n_taps samples, zero
// outside the signal) and the taps in shared memory with cp.async, 16
// bytes a copy where the signal's rows and the window's start allow it
// (the serve shape: 48,000-sample rows, a 72-sample pad). One
// output per thread, with a shared-memory load of a tap and of a sample
// for every FMA, would be bound by shared-memory issue at 8x the FMA time.
// So each thread computes R consecutive outputs from a ring of registers
// that slides over its part of the window: at tap k output r needs sample
// k + r*down, so each tap costs one new sample load for R FMAs, and the
// taps come as 16-byte broadcast loads, one for four taps. The tap loop is
// unrolled by the ring's length Q, so the ring rotates by register
// renaming, with no moves; Q exceeds the live window by at least 3 slots,
// so a sample's load is issued steps before its first use. Lanes read the
// window at stride R*down words: odd for odd down (R = 9 or 3), so the 32
// lanes hit 32 banks; even down costs a 2- or 4-way conflict. Each output
// is accumulated in fp32 in tap order k = 0 .. n_taps-1, so a result does
// not depend on R, the block size or N.
// Outputs go back through shared memory, so the stores are coalesced.
//
// The block size T and R are chosen per launch: R = 9 with the largest T
// in {128, 64, 32} that still gives 2 blocks an SM; where even T = 32
// gives fewer (one short signal, the per-request path) R = 3 and T = 32,
// so a single 1 s signal still spreads over the SMs. down 1-4 are
// compiled; any other down takes the same kernel at R = 1.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 128;

template <int R, int DOWN>
struct Ring {
  static constexpr int kLive = (R - 1) * DOWN + 1;         // samples a step reads
  static constexpr int kLen = (kLive + 3 + 3) / 4 * 4;     // >= kLive + 3, a multiple of 4
};

// cp.async of one float, or of four (16 bytes, both addresses on 16
// bytes); zeros where `valid` is false.
__device__ __forceinline__ void stage(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void stage4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// One tap step at ring position J (compile time): load the sample that
// enters the ring, then R FMAs.
template <int R, int DOWN, int J>
__device__ __forceinline__ void tap_step(float (&ring)[Ring<R, DOWN>::kLen], float (&acc)[R],
                                         const float* w, int k0, float hk) {
  constexpr int Q = Ring<R, DOWN>::kLen, LIVE = Ring<R, DOWN>::kLive;
  ring[(J + LIVE - 1) % Q] = w[k0 + J + LIVE - 1];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = fmaf(hk, ring[(J + r * DOWN) % Q], acc[r]);
}

// Steps J .. J+3 of one period; GUARD skips the steps at or past n_taps.
template <int R, int DOWN, int J, bool GUARD>
__device__ __forceinline__ void four_steps(float (&ring)[Ring<R, DOWN>::kLen], float (&acc)[R],
                                           const float* w, const float* h, int k0, int n_taps) {
  if (GUARD && k0 + J >= n_taps) return;
  const float4 h4 = *reinterpret_cast<const float4*>(h + k0 + J);
  tap_step<R, DOWN, J>(ring, acc, w, k0, h4.x);
  if (GUARD && k0 + J + 1 >= n_taps) return;
  tap_step<R, DOWN, J + 1>(ring, acc, w, k0, h4.y);
  if (GUARD && k0 + J + 2 >= n_taps) return;
  tap_step<R, DOWN, J + 2>(ring, acc, w, k0, h4.z);
  if (GUARD && k0 + J + 3 >= n_taps) return;
  tap_step<R, DOWN, J + 3>(ring, acc, w, k0, h4.w);
}

template <int R, int DOWN, bool GUARD, int J = 0>
__device__ __forceinline__ void period(float (&ring)[Ring<R, DOWN>::kLen], float (&acc)[R],
                                       const float* w, const float* h, int k0, int n_taps) {
  if constexpr (J < Ring<R, DOWN>::kLen) {
    four_steps<R, DOWN, J, GUARD>(ring, acc, w, h, k0, n_taps);
    period<R, DOWN, GUARD, J + 4>(ring, acc, w, h, k0, n_taps);
  }
}

// DOWN > 0: compiled decimation factor; DOWN == 0: `down` at run time (R = 1).
template <int R, int DOWN>
__global__ void __launch_bounds__(kMaxThreads)
resample_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                float* __restrict__ y, int len_in, int n_taps, int down, int pad_left,
                int n_out) {
  static_assert(R == 1 || DOWN > 0, "a run-time down takes R = 1");
  constexpr int Q = Ring<R, DOWN>::kLen, LIVE = Ring<R, DOWN>::kLive;
  if constexpr (DOWN > 0) down = DOWN;
  extern __shared__ __align__(16) float smem[];
  const int taps4 = (n_taps + 3) & ~3;
  float* h = smem;            // [taps4], zero past n_taps
  float* win = smem + taps4;  // [T*R*down + n_taps, rounded up to 4]; then the block's outputs

  const int nt = blockDim.x, tile = nt * R;
  const int sig = blockIdx.y;
  const int out0 = blockIdx.x * tile;
  const long long in0 = static_cast<long long>(out0) * down - pad_left;
  const float* xs = x + static_cast<long long>(sig) * len_in;
  const int win_len = tile * down + n_taps;

  for (int k = threadIdx.x; k < taps4; k += nt) {
    stage(h + k, taps + (k < n_taps ? k : 0), k < n_taps);
  }
  if (len_in % 4 == 0 && in0 % 4 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0) {
    // 16 bytes a copy: each group of 4 lies wholly inside or outside the signal
    for (int j = 4 * threadIdx.x; j < win_len; j += 4 * nt) {
      const long long src = in0 + j;
      const bool inside = src >= 0 && src < len_in;
      stage4(win + j, inside ? xs + src : xs, inside);
    }
  } else {
    for (int j = threadIdx.x; j < win_len; j += nt) {
      const long long src = in0 + j;
      const bool inside = src >= 0 && src < len_in;
      stage(win + j, inside ? xs + src : xs, inside);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const float* w = win + threadIdx.x * R * down;
  float ring[Q];
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int m = 0; m < LIVE - 1; ++m) ring[m] = w[m];
  int k0 = 0;
  for (; k0 + Q <= n_taps; k0 += Q) period<R, DOWN, false>(ring, acc, w, h, k0, n_taps);
  if (k0 < n_taps) period<R, DOWN, true>(ring, acc, w, h, k0, n_taps);

  __syncthreads();  // every thread is done with the window
#pragma unroll
  for (int r = 0; r < R; ++r) win[threadIdx.x * R + r] = acc[r];
  __syncthreads();
  float* ys = y + static_cast<long long>(sig) * n_out + out0;
  const int n_here = min(tile, n_out - out0);
  for (int j = threadIdx.x; j < n_here; j += nt) ys[j] = win[j];
}

constexpr int kWide = 9, kNarrow = 3;  // outputs a thread (odd: R*down odd for odd down)

struct Plan {
  int r, threads;
};

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

Plan plan(int n_sig, int n_out, int down) {
  if (down < 1 || down > 4) return {1, kMaxThreads};
  const long long want = 2LL * sm_count();
  for (int t = kMaxThreads; t >= 32; t /= 2) {
    const long long blocks = static_cast<long long>((n_out + kWide * t - 1) / (kWide * t)) * n_sig;
    if (blocks >= want) return {kWide, t};
  }
  return {kNarrow, 32};
}

struct Args {
  const float* x;
  const float* taps;
  float* y;
  int n_sig, len_in, n_taps, down, pad_left, n_out;
};

template <int R, int DOWN>
int launch(const Args& a, int threads, size_t smem, cudaStream_t s) {
  const dim3 grid((a.n_out + threads * R - 1) / (threads * R), a.n_sig);
  resample_kernel<R, DOWN><<<grid, threads, smem, s>>>(a.x, a.taps, a.y, a.len_in, a.n_taps,
                                                       a.down, a.pad_left, a.n_out);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_down(const Args& a, int threads, size_t smem, cudaStream_t s) {
  switch (a.down) {
    case 1: return launch<R, 1>(a, threads, smem, s);
    case 2: return launch<R, 2>(a, threads, smem, s);
    case 3: return launch<R, 3>(a, threads, smem, s);
    default: return launch<R, 4>(a, threads, smem, s);
  }
}

}  // namespace

// Dynamic shared memory of the launch that preba_resample makes for these
// sizes: the taps (padded to 4) and the block's window.
extern "C" int preba_resample_smem_bytes(int n_sig, int n_out, int n_taps, int down) {
  const Plan p = plan(n_sig, n_out, down);
  const long long win = static_cast<long long>(p.threads) * p.r * down + n_taps;
  const long long floats = ((n_taps + 3) & ~3) + ((win + 3) & ~3LL);
  return static_cast<int>(sizeof(float) * floats);
}

// x [n_sig, len_in], taps [n_taps] -> y [n_sig, n_out], all fp32 and
// contiguous, x read as zero outside [0, len_in) after shifting by
// pad_left. Returns the cudaError_t of the launch.
extern "C" int preba_resample(const float* x, const float* taps, float* y, int n_sig,
                              int len_in, int n_taps, int down, int pad_left, int n_out,
                              void* stream) {
  const Plan p = plan(n_sig, n_out, down);
  const size_t smem = static_cast<size_t>(preba_resample_smem_bytes(n_sig, n_out, n_taps, down));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, taps, y, n_sig, len_in, n_taps, down, pad_left, n_out};
  if (p.r == kWide) return launch_down<kWide>(a, p.threads, smem, s);
  if (p.r == kNarrow) return launch_down<kNarrow>(a, p.threads, smem, s);
  return launch<1, 0>(a, p.threads, smem, s);
}

extern "C" const char* preba_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
