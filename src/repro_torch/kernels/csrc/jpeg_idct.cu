// JPEG block decode (dequantize + 8x8 inverse DCT) for the DPU 'Decode'
// functional unit, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/jpeg_idct.py, jpeg_idct_pallas
// (_idct_kernel), together with the reshape and transpose that
// src/repro/kernels/ops.py::jpeg_decode_batch applies to its output:
//
//     D = C[n, by, bx] * Q                       (dequantize)
//     P = M @ D @ M^T + 128                      (orthonormal 8x8 IDCT)
//     img[n, 8 by + i, 8 bx + l] = P[i, l]
//
// for quantized coefficients C [N, BY, BX, 8, 8], one quantization table Q
// [8, 8] and the IDCT basis M [8, 8], all fp32, into pixels [N, 8 BY, 8 BX].
//
// What bounds it on this card: 2 x 512 FMAs per 64 pixels (~34 flops a
// pixel) against 8 bytes a pixel (one coefficient read, one pixel written),
// so device-memory bytes: at N = 16, 512 x 512 it moves ~33.6 MB for
// ~0.14 GFLOP. The TPU kernel batched 512 blocks a grid step as two MXU
// einsums and padded the block count to a multiple of 512; its caller then
// transposed the blocks into image layout in a second pass over memory.
// Here one CUDA block of 512 threads owns kStrip neighbouring 8x8 blocks
// of one block row: their 512 coefficients are one contiguous, coalesced
// read; the two 8x8 products run as fp32 FMA out of shared memory (8 FMAs
// an element each); and each thread writes one pixel so that every pixel
// row of the strip (kStrip x 8 = 64 floats) is one coalesced store,
// straight into image layout. The ragged end of a block row is masked; no
// block count is padded and no transpose pass is made.
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 8;                  // 8x8 blocks per CUDA block
constexpr int kThreads = kStrip * 64;      // one thread per coefficient/pixel

__global__ void __launch_bounds__(kThreads)
idct_kernel(const float* __restrict__ coeffs, const float* __restrict__ qtable,
            const float* __restrict__ basis, float* __restrict__ out,
            int bx_count, int strips) {
  __shared__ float m_s[8][8];
  __shared__ float d_s[kStrip][8][8];      // dequantized coefficients
  __shared__ float t_s[kStrip][8][8];      // M @ D

  const int tid = threadIdx.x;
  const int row = blockIdx.x / strips;     // n * BY + by
  const int bx0 = (blockIdx.x % strips) * kStrip;
  if (tid < 64) m_s[tid / 8][tid % 8] = basis[tid];

  // dequantize: coefficient e of block b of the strip
  const int b = tid / 64, e = tid % 64;
  const bool in_row = bx0 + b < bx_count;
  const long long first = (static_cast<long long>(row) * bx_count + bx0) * 64;
  d_s[b][e / 8][e % 8] = in_row ? coeffs[first + tid] * qtable[e] : 0.0f;
  __syncthreads();

  // T = M @ D, element (i, k) of block b
  {
    const int i = e / 8, k = e % 8;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(m_s[i][j], d_s[b][j][k], s);
    t_s[b][i][k] = s;
  }
  __syncthreads();

  // P = T @ M^T + 128: thread -> pixel (i, x) of the strip, x = 8 b + l
  const int i = tid / 64, x = tid % 64;
  const int pb = x / 8, l = x % 8;
  if (bx0 + pb >= bx_count) return;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s = fmaf(t_s[pb][i][k], m_s[l][k], s);
  const long long width = 8LL * bx_count;
  out[(8LL * row + i) * width + 8LL * bx0 + x] = s + 128.0f;
}

}  // namespace

// coeffs [rows, bx_count, 8, 8] (rows = N * BY), qtable [8, 8], basis
// [8, 8] -> out [rows * 8, bx_count * 8] = [N, H, W]; fp32, contiguous.
// Returns the cudaError_t of the launch.
extern "C" int preba_idct(const float* coeffs, const float* qtable,
                          const float* basis, float* out, int rows,
                          int bx_count, void* stream) {
  const int strips = (bx_count + kStrip - 1) / kStrip;
  const long long blocks = static_cast<long long>(rows) * strips;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  idct_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(coeffs, qtable, basis, out,
                                                     bx_count, strips);
  return static_cast<int>(cudaGetLastError());
}
