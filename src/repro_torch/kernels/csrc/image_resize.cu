// Separable bilinear resize for the DPU 'Resize' functional unit, on Hopper
// (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/image_resize.py,
// image_resize_batch_pallas (_rows_kernel_b, then _cols_kernel; the single
// image_resize_pallas is the same two passes at N = 1):
//
//     tmp[n] = Ry @ img[n]                 rows pass,    Ry [H_out, H]
//     out    = tmp.reshape(N H_out, W) @ Rx^T   cols pass, Rx [W_out, W]
//
// over a stack img [N, H, W] of same-shape images, all fp32.
//
// What bounds it on this card: the function needs 2 taps an output in each
// pass, so bytes bound it (N = 16, 512 x 512 -> 256 x 256: ~22 MB, ~6.6 us
// at 3.35 TB/s). Written as dense products, as the TPU kernel does them, it
// is 2 H_out H W + 2 H_out W W_out flops an image (~3.2 GFLOP at that
// shape), so this kernel is bound by fp32 operations, ~7x above the bytes
// bound. TF32 is out: its 10-bit mantissa cannot meet the 1e-4
// tolerance on pixel values of ~255. Both passes run one shared-memory
// tiled fp32 GEMM on the CUDA cores: a 256-thread block computes a 64 x 64
// tile of C, each thread a 4 x 4 register tile (rows ty + 16 i, columns
// tx + 16 j, so a warp's stores are coalesced), walking K in steps of 16
// staged through padded shared tiles. The rows pass batches over blockIdx.z
// with Ry shared (stride 0); the cols pass reads Rx in place as the
// transposed B operand, so no transpose is materialised. Ragged edges are
// masked: Ry is not padded to 128 rows as on the TPU. A bilinear row has
// only two non-zero taps, so almost all of these flops multiply zeros;
// a two-tap gather would bring it down to the bytes bound.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;   // 16 x 16, a 4 x 4 tile of C each
constexpr int kPad = 4;         // spreads the transposed tile stores over banks

// C[z] = A[z] @ B[z] with A [M, K]; B [K, N], or [N, K] read transposed
// when kTransB; C [M, N]; all row-major, batch strides in elements.
template <bool kTransB>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ c, int m, int n, int k, long long stride_a,
            long long stride_b, long long stride_c) {
  __shared__ float a_s[kBK][kBM + kPad];
  __shared__ float b_s[kBK][kBN + kPad];

  a += blockIdx.z * stride_a;
  b += blockIdx.z * stride_b;
  c += blockIdx.z * stride_c;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int mm = idx / kBK, kk = idx % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      a_s[kk][mm] = (gm < m && gk < k) ? a[static_cast<long long>(gm) * k + gk] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kBN * kBK / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      if (kTransB) {
        const int nn = idx / kBK, kk = idx % kBK;
        const int gn = n0 + nn, gk = k0 + kk;
        b_s[kk][nn] = (gn < n && gk < k) ? b[static_cast<long long>(gn) * k + gk] : 0.0f;
      } else {
        const int kk = idx / kBN, nn = idx % kBN;
        const int gn = n0 + nn, gk = k0 + kk;
        b_s[kk][nn] = (gn < n && gk < k) ? b[static_cast<long long>(gk) * n + gn] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n) c[static_cast<long long>(gm) * n + gn] = acc[i][j];
    }
  }
}

int launch_error(long long grid_x, long long grid_y, long long grid_z) {
  if (grid_x > 0x7fffffffLL || grid_y > 65535 || grid_z > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

}  // namespace

// Rows pass: img [n_img, h, w], ry [h_out, h] -> tmp [n_img, h_out, w].
// Returns the cudaError_t of the launch.
extern "C" int preba_resize_rows(const float* img, const float* ry, float* tmp,
                                 int n_img, int h, int w, int h_out,
                                 void* stream) {
  const dim3 grid((w + kBN - 1) / kBN, (h_out + kBM - 1) / kBM, n_img);
  if (int err = launch_error(grid.x, grid.y, grid.z)) return err;
  gemm_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ry, img, tmp, h_out, w, h, 0LL, static_cast<long long>(h) * w,
      static_cast<long long>(h_out) * w);
  return static_cast<int>(cudaGetLastError());
}

// Cols pass: tmp [rows, w] (rows = n_img * h_out), rx [w_out, w] ->
// out [rows, w_out]. Returns the cudaError_t of the launch.
extern "C" int preba_resize_cols(const float* tmp, const float* rx, float* out,
                                 int rows, int w, int w_out, void* stream) {
  const dim3 grid((w_out + kBN - 1) / kBN, (rows + kBM - 1) / kBM, 1);
  if (int err = launch_error(grid.x, grid.y, grid.z)) return err;
  gemm_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tmp, rx, out, rows, w_out, w, 0LL, 0LL, 0LL);
  return static_cast<int>(cudaGetLastError());
}
