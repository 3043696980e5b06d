// Separable Gaussian blur over (N, H, W, C) float32 images, channels last,
// reflect-101 borders (OpenCV's default).
//
// Replaces: the Pallas TPU kernel gaussian_blur_pallas / _blur_kernel in
// src/repro/kernels/gaussian_blur.py, which needs its wrapper to write two
// reflect-padded copies of the image before one program per (image, row
// band) blurs a band plus the next one.
//
// What bounds it on an H100: memory.  Each output value costs 2*ksize
// flops per pass and 8 bytes of traffic (one read, one write), far below
// the card's ~20 flop/byte balance point for fp32, so the floor is reading
// the image once and writing it once at 3.35 TB/s.
//
// What the design does about it: the reflect-101 indexing happens while a
// CTA loads its tile, so the image is read straight from the caller's
// tensor and no padded copy is written.  One CTA owns one
// TILE_H x TILE_W output tile of one image; it stages the tile plus its
// ksize-1 halo in shared memory, runs the vertical taps into a second shared
// buffer, then the horizontal taps from there, so every input value is
// read from device memory about (1 + (ksize-1)/TILE)^2 times (1.27 times
// at ksize 5) and every output value written once.  Tiling the width too
// keeps the shared footprint independent of the image width (a 1080p row
// of C=3 floats alone is 23 KB).  The block is 32 x 8 threads: a warp walks
// one tile row, so loads and stores are coalesced, and the reflected
// source row and column offsets are computed once per tile into shared
// memory, so the inner loops do no integer division.  Taps ride in the
// parameter block.  Products and sums are rounded separately
// (__fmul_rn/__fadd_rn, no contraction to FMA) in tap order, so the result
// matches the plain PyTorch version bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 32;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr int MAX_K = 63;

struct Taps {
  float v[MAX_K];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = abs(i) % period;
  return i < n ? i : period - i;
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
blur_kernel(const float* __restrict__ in, float* __restrict__ out,
            int H, int W, int C, Taps ky, Taps kx, int K) {
  extern __shared__ float smem[];
  const int pad = K / 2;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int n = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BLOCK_X + tx;
  const int tile_rows = TILE_H + K - 1;
  const int row_len = (TILE_W + K - 1) * C;  // tile row, halo included
  float* tile = smem;                         // tile_rows x row_len
  float* vert = tile + tile_rows * row_len;   // TILE_H x row_len
  int* src_row = reinterpret_cast<int*>(vert + TILE_H * row_len);
  int* src_col = src_row + tile_rows;
  const size_t img_len = (size_t)H * W * C;
  const float* img = in + n * img_len;

  for (int r = tid; r < tile_rows; r += BLOCK_X * BLOCK_Y)
    src_row[r] = reflect101(y0 + r - pad, H) * W * C;
  for (int k = tid; k < row_len; k += BLOCK_X * BLOCK_Y) {
    const int col = k / C;
    src_col[k] = reflect101(x0 + col - pad, W) * C + (k - col * C);
  }
  __syncthreads();

  for (int r = ty; r < tile_rows; r += BLOCK_Y) {
    const float* row = img + src_row[r];
    for (int k = tx; k < row_len; k += BLOCK_X)
      tile[r * row_len + k] = row[src_col[k]];
  }
  __syncthreads();

  const int rows_out = min(TILE_H, H - y0);
  for (int r = ty; r < rows_out; r += BLOCK_Y) {
    for (int k = tx; k < row_len; k += BLOCK_X) {
      const float* src = tile + r * row_len + k;
      float acc = __fmul_rn(ky.v[0], src[0]);
      for (int t = 1; t < K; ++t)
        acc = __fadd_rn(acc, __fmul_rn(ky.v[t], src[t * row_len]));
      vert[r * row_len + k] = acc;
    }
  }
  __syncthreads();

  const int out_len = min(TILE_W, W - x0) * C;
  float* dst = out + n * img_len + ((size_t)y0 * W + x0) * C;
  for (int r = ty; r < rows_out; r += BLOCK_Y) {
    for (int k = tx; k < out_len; k += BLOCK_X) {  // k = column * C + channel
      const float* src = vert + r * row_len + k;
      float acc = __fmul_rn(kx.v[0], src[0]);
      for (int t = 1; t < K; ++t)
        acc = __fadd_rn(acc, __fmul_rn(kx.v[t], src[t * C]));
      dst[(size_t)r * W * C + k] = acc;
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_gaussian_blur_f32(const float* in, float* out, int n,
                                       int h, int w, int c, const float* ky,
                                       const float* kx, int ksize,
                                       void* stream) {
  if (ksize < 1 || ksize > MAX_K || n > 65535 || (size_t)h * w * c >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  Taps tky = {}, tkx = {};
  for (int t = 0; t < ksize; ++t) {
    tky.v[t] = ky[t];
    tkx.v[t] = kx[t];
  }
  const size_t tile_rows = TILE_H + ksize - 1;
  const size_t row_len = (size_t)(TILE_W + ksize - 1) * c;
  const size_t smem = (tile_rows + TILE_H) * row_len * sizeof(float) +
                      (tile_rows + row_len) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, n);
  blur_kernel<<<grid, dim3(BLOCK_X, BLOCK_Y), smem, (cudaStream_t)stream>>>(
      in, out, h, w, c, tky, tkx, ksize);
  return (int)cudaGetLastError();
}
