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
// ~0.14 GFLOP. The design keeps every access 16 bytes wide and every value
// in registers. A warp owns 4 neighbouring 8x8 blocks (in memory order,
// across block rows and images), lane 8q + r row r of block q: it reads its
// 8 coefficients as two 16-byte loads (the warp reads 1 KB in one run),
// issued before the block's only barrier (the staging of M and Q), then
// dequantizes them and forms row r of T = D M^T in registers, M read by
// broadcast from shared memory. T goes through a per-warp shared-memory
// tile under __syncwarp() only (rows 12 floats apart and blocks 104 apart,
// so the 16-byte stores and reads hit distinct banks). For P = M T + 128
// the lanes swap roles: lane 8i + c forms columns 4h..4h+3 (h = c % 2) of
// pixel rows i and i + 4 of block c / 2 and writes each as one 16-byte
// store straight into image layout: each store instruction of the warp
// writes 4 pixel rows of its 4 blocks, whole 128-byte runs (full sectors).
// Only the end of the whole stack is masked; no block count is padded and
// no transpose pass is made. What is left is bytes and the launch: on an
// H100 SXM (700 W) it took 0.0158 ms at (16, 512 x 512), about a 0.005 ms
// launch floor plus 33.6 MB at ~3 TB/s.
// The previous design (one thread a coefficient and then a pixel, scalar
// 4-byte accesses, two 512-thread barriers per 8 blocks, 4-way bank
// conflicts in the second product) took 0.0322 ms there.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                // 32 8x8 blocks a CUDA block, 4 a warp
constexpr int kBlocks = kThreads / 8;
constexpr int kRow = 12;                     // floats between rows of a T tile
constexpr int kTile = 8 * kRow + 8;          // floats between T tiles (104)

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__global__ void __launch_bounds__(kThreads)
idct_kernel(const float* __restrict__ coeffs, const float* __restrict__ qtable,
            const float* __restrict__ basis, float* __restrict__ out, long long n_blocks,
            int bx_count) {
  __shared__ __align__(16) float m_s[64];
  __shared__ __align__(16) float q_s[64];
  __shared__ __align__(16) float t_s[kBlocks * kTile];

  const int tid = threadIdx.x, lane = tid & 31;
  const long long wb = static_cast<long long>(blockIdx.x) * kBlocks + (tid >> 5) * 4;

  // lane 8 q + r: row r of the warp's block q; its coefficients are loaded
  // before the barrier so that their latency overlaps the staging of M, Q
  const int q = lane >> 3, r = lane & 7;
  float d[8];
  if (wb + q < n_blocks) {
    load8(coeffs + (wb + q) * 64 + 8 * r, d);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = 0.f;
  }
  if (tid < 64) {
    m_s[tid] = basis[tid];
    q_s[tid] = qtable[tid];
  }
  __syncthreads();

  // row r of T = (C * Q) M^T: T[r][l] = sum_k D[r][k] M[l][k]
  float qr[8], t[8];
  load8(q_s + 8 * r, qr);
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] *= qr[k];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    float ml[8];
    load8(m_s + 8 * l, ml);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s = fmaf(d[k], ml[k], s);
    t[l] = s;
  }
  float* tiles = t_s + (tid >> 5) * 4 * kTile;
  store8(tiles + q * kTile + kRow * r, t);
  __syncwarp();

  // lane 8 i + c: columns 4h..4h+3 of pixel rows i and i + 4 of the warp's
  // block c / 2 (h = c % 2), P = M T + 128, so each of the two 16-byte
  // stores of the warp writes 4 pixel rows of 4 neighbouring blocks
  const int i = lane >> 3, c = lane & 7, bq = c >> 1, h = c & 1;
  float m0[8], m1[8];
  load8(m_s + 8 * i, m0);
  load8(m_s + 8 * (i + 4), m1);
  float4 p0 = make_float4(0.f, 0.f, 0.f, 0.f), p1 = p0;
  const float* tile = tiles + bq * kTile + 4 * h;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 tj = *reinterpret_cast<const float4*>(tile + kRow * j);
    p0.x = fmaf(m0[j], tj.x, p0.x);
    p0.y = fmaf(m0[j], tj.y, p0.y);
    p0.z = fmaf(m0[j], tj.z, p0.z);
    p0.w = fmaf(m0[j], tj.w, p0.w);
    p1.x = fmaf(m1[j], tj.x, p1.x);
    p1.y = fmaf(m1[j], tj.y, p1.y);
    p1.z = fmaf(m1[j], tj.z, p1.z);
    p1.w = fmaf(m1[j], tj.w, p1.w);
  }
  const long long b = wb + bq;
  if (b >= n_blocks) return;
  const long long row = b / bx_count;           // n * BY + by
  const long long width = 8LL * bx_count;
  float* dst = out + (8 * row + i) * width + 8 * (b - row * bx_count) + 4 * h;
  reinterpret_cast<float4*>(dst)[0] =
      make_float4(p0.x + 128.0f, p0.y + 128.0f, p0.z + 128.0f, p0.w + 128.0f);
  reinterpret_cast<float4*>(dst + 4 * width)[0] =
      make_float4(p1.x + 128.0f, p1.y + 128.0f, p1.z + 128.0f, p1.w + 128.0f);
}

}  // namespace

// coeffs [rows, bx_count, 8, 8] (rows = N * BY), qtable [8, 8], basis
// [8, 8] -> out [rows * 8, bx_count * 8] = [N, H, W]; fp32, contiguous,
// coeffs and out on 16 bytes. Returns the cudaError_t of the launch.
extern "C" int preba_idct(const float* coeffs, const float* qtable,
                          const float* basis, float* out, int rows,
                          int bx_count, void* stream) {
  if (rows <= 0 || bx_count <= 0
      || reinterpret_cast<unsigned long long>(coeffs) % 16
      || reinterpret_cast<unsigned long long>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = static_cast<long long>(rows) * bx_count;
  const long long grid = (n_blocks + kBlocks - 1) / kBlocks;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  idct_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(coeffs, qtable, basis, out,
                                                     n_blocks, bx_count);
  return static_cast<int>(cudaGetLastError());
}
