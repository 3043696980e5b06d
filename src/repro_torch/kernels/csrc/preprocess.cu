// Fused resize -> crop -> normalize over (N, Hi, Wi, C) float32 images,
// channels last:
//
//   out[n, i, j, c] = (sum_w Rx[j, w] * sum_h Ry[i, h] * img[n, h, w, c]
//                      - mean) / std
//
// with Ry (Hc, Hi) and Rx (Wc, Wi) the interpolation matrices of the
// resize, the crop folded in as a row slice of each.
//
// Replaces: the Pallas TPU kernel fused_resize_crop_normalize_pallas /
// _preprocess_kernel in src/repro/kernels/preprocess.py, which runs one
// program per image as two dense MXU matmuls plus an affine.
//
// What bounds it on an H100: memory.  As dense products the work would be
// about 160 MFLOP per 250x250 -> 224x224 image, compute-bound on the fp32
// cores (no TF32 here: the reference is exact float32).  But Ry and Rx are
// banded (two taps per output pixel for a bilinear upsample, about
// 2/scale when downsampling with antialias), so the products the data
// needs are a few hundred kFLOP per image, and reading each image once and
// writing the crop once is the floor.
//
// What the design does about it: the host passes each matrix row's first
// and last nonzero column, and every sum runs only over its band — the
// same sums as the dense products minus exact zeros.  One CTA owns a
// TILE_I x TILE_J tile of output pixels of one image and walks the input
// columns its tile needs in chunks of CHUNK_W: stage 1 contracts the image
// with the Ry rows of the tile into a (TILE_I, CHUNK_W * C) intermediate
// in shared memory (neighbouring threads read neighbouring addresses of an
// image row); stage 2 contracts that with the Rx rows into per-thread
// accumulators, and the epilogue writes (acc - mean) / std once.  The
// resized image never reaches device memory and its cropped-away rows and
// columns are never computed.  Sums use fp32 FMA.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_I = 16;
constexpr int TILE_J = 32;
constexpr int CHUNK_W = 32;
constexpr int THREADS = 256;
constexpr int MAX_C = 4;
constexpr int PER_THREAD = (TILE_I * TILE_J * MAX_C + THREADS - 1) / THREADS;

__global__ void __launch_bounds__(THREADS)
preprocess_kernel(const float* __restrict__ img, const float* __restrict__ ry,
                  const float* __restrict__ rx, const int* __restrict__ ry_lo,
                  const int* __restrict__ ry_hi, const int* __restrict__ rx_lo,
                  const int* __restrict__ rx_hi, float* __restrict__ out,
                  int Hi, int Wi, int C, int Hc, int Wc, float mean,
                  float stdev) {
  __shared__ float tmp[TILE_I * CHUNK_W * MAX_C];
  __shared__ int s_wlo, s_whi;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * TILE_I;
  const int j0 = blockIdx.x * TILE_J;
  const int ti = min(TILE_I, Hc - i0);
  const int tj = min(TILE_J, Wc - j0);
  const int n_out = ti * tj * C;
  const int chunk_len = CHUNK_W * C;
  const size_t row_stride = (size_t)Wi * C;
  const float* im = img + (size_t)n * Hi * row_stride;

  if (threadIdx.x == 0) {  // input columns the tile's Rx rows touch
    int lo = INT_MAX, hi = -1;
    for (int j = 0; j < tj; ++j) {
      if (rx_lo[j0 + j] <= rx_hi[j0 + j]) {
        lo = min(lo, rx_lo[j0 + j]);
        hi = max(hi, rx_hi[j0 + j]);
      }
    }
    s_wlo = hi < 0 ? 0 : lo;
    s_whi = hi;
  }
  __syncthreads();
  const int wlo = s_wlo, whi = s_whi;

  float acc[PER_THREAD];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) acc[q] = 0.f;

  for (int w0 = wlo; w0 <= whi; w0 += CHUNK_W) {
    const int wk = min(CHUNK_W, whi + 1 - w0);
    const int kc = wk * C;
    // stage 1: tmp[r][k] = sum_h Ry[i0 + r, h] * img[n, h, w0*C + k]
    for (int idx = threadIdx.x; idx < ti * kc; idx += THREADS) {
      const int r = idx / kc;
      const int k = idx - r * kc;
      const int i = i0 + r;
      const float* rrow = ry + (size_t)i * Hi;
      const float* col = im + (size_t)w0 * C + k;
      float a = 0.f;
      for (int h = ry_lo[i], h_end = ry_hi[i]; h <= h_end; ++h)
        a = fmaf(rrow[h], col[(size_t)h * row_stride], a);
      tmp[r * chunk_len + k] = a;
    }
    __syncthreads();
    // stage 2: acc[r][j][c] += sum_w Rx[j0 + j, w] * tmp[r][(w - w0)*C + c]
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int idx = threadIdx.x + q * THREADS;
      if (idx < n_out) {
        const int r = idx / (tj * C);
        const int rem = idx - r * (tj * C);
        const int j = rem / C;
        const int c = rem - j * C;
        const int jj = j0 + j;
        const float* xrow = rx + (size_t)jj * Wi;
        const float* t = tmp + r * chunk_len + c;
        const int lo = max(rx_lo[jj], w0);
        const int hi = min(rx_hi[jj], w0 + wk - 1);
        float a = acc[q];
        for (int w = lo; w <= hi; ++w)
          a = fmaf(xrow[w], t[(w - w0) * C], a);
        acc[q] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int idx = threadIdx.x + q * THREADS;
    if (idx < n_out) {
      const int r = idx / (tj * C);
      const int rem = idx - r * (tj * C);  // j * C + c
      out[(((size_t)n * Hc + i0 + r) * Wc + j0) * C + rem] =
          __fdiv_rn(__fsub_rn(acc[q], mean), stdev);
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_preprocess_f32(const float* img, const float* ry,
                                    const float* rx, const int* ry_lo,
                                    const int* ry_hi, const int* rx_lo,
                                    const int* rx_hi, float* out, int n,
                                    int hi, int wi, int c, int hc, int wc,
                                    float mean, float stdev, void* stream) {
  if (c < 1 || c > MAX_C || n > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((wc + TILE_J - 1) / TILE_J, (hc + TILE_I - 1) / TILE_I, n);
  preprocess_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      img, ry, rx, ry_lo, ry_hi, rx_lo, rx_hi, out, hi, wi, c, hc, wc, mean,
      stdev);
  return (int)cudaGetLastError();
}
