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
// 2 * 3 * scale for a lanczos3 downsample), so the products the data needs
// are a few hundred kFLOP per image, and reading each image once and
// writing the crop once is the floor: 0.0130 ms for the device backend's
// batch of 32 faces, 250x250 -> 224x224.
//
// What the design does about it.  The host hands over each matrix as a
// tap table: per output row (column) the first input row (column) and P
// weights, P the widest band, padded with exact zeros, the windows
// monotone and inside the image (preprocess.py: tap_table).  The sums are
// the dense products' minus exact zeros, in fp32 FMA, vertical then
// horizontal, and the affine is (sum - mean) times the reciprocal of std,
// rounded once (within an ulp of the plain version's division, which
// costs about 10 instructions an output).  Three routes, picked by P:
//
// - P = 2 on both axes (every bilinear upsample: the device backend's
//   250 -> 256 faces), direct: one thread per output float of a row, for
//   4 rows of a strip, reads its 2 x 2 window straight from global memory
//   (neighbouring threads' windows overlap, so most reads hit L1; each
//   input row comes from device memory about once) and writes its output;
//   no shared memory, no barrier, 32 registers, so every SM holds 2,048
//   threads, each with 16 loads in flight.  0.024 ms at the batch of 32.
// - any other P up to 1,024 (downsamples with antialias taps, cubic and
//   lanczos windows), tiled: one CTA owns a strip of `rows` (<= 8) output
//   rows by a segment of `cols` output columns of `cb` channels of one image,
//   sized by the host (launch_plan) so that a tile row holds at most
//   1,024 floats and the launch at least 264 CTAs.
//     1. Vertical pass, streamed: each thread owns up to 4 floats of the
//        tile row (the input columns from the segment's first window to
//        its last, all of the group's channels) and walks the strip's band
//        of input rows once, top to bottom, the loads of 4 rows in flight
//        together; each value joins, in registers, the sums of every
//        output row of the strip whose window holds that input row, in
//        the window's order.  The sums go to a shared tile once.
//     2. Horizontal pass and the affine: each thread owns output floats
//        of the segment and sums the window of the tile for all the
//        strip's rows at once, one tap at a time (8 independent sums).
//   A wide window's band is long (a 1080p -> 224 lanczos3 strip of 4 rows
//   reads 48 input rows), and each CTA walks it in sequence.
// - a window over 1,024 taps on either axis (a 1920-wide frame to 8
//   columns with lanczos3: 1,440 columns a window; a tile row would not
//   fit, nor a tall window's taps in shared memory), wide, through
//   repro_preprocess_wide_f32: the same sums in the same order in two
//   plain passes through a scratch image that the caller allocates, (n,
//   hc, the input columns the windows cover, c).  The vertical pass gives
//   one thread one float of a scratch row and walks its window's rows from
//   global memory (neighbouring threads read neighbouring floats); the
//   horizontal pass gives one thread one output float and walks its
//   window along the scratch row, then the affine.  Taps from global
//   memory, any number of them.
//
// Measured on an H100 (700 W), (32,250,250,3) -> (32,224,224,3): the
// first design, one 16 x 32 tile a CTA over dense matrix rows between
// per-row band limits (3,136 CTAs, a division per element, a near-empty
// second chunk of columns), 0.082 ms; a tiled route that gathered each output
// row's window from global memory, 0.040 (and 0.205 at 1080p lanczos3,
// a chain of dependent loads per tap); the tiled route above, 0.037-0.044
// (latency-bound: 2-3 CTAs an SM, each loading, then summing, then
// writing); the direct route, 0.024.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 8;  // the most output rows a strip holds
constexpr int G = 4;     // the most floats of a tile row a thread owns
constexpr int U = 4;     // input rows whose loads are in flight together
constexpr int DR = 4;    // output rows a thread of the direct route computes

struct Args {
  const float* img;
  float* out;
  const int* y0;    // (Hc) first input row of each output row's window
  const float* wy;  // (Hc, Py) its taps
  const int* x0;    // (Wc) first input column of each output column's window
  const float* wx;  // (Wc, Px)
  int Hi, Wi, C, Hc, Wc, Py, Px;
  int rows, cols, cb, ld, ncg;  // tile: rows x cols pixels of cb channels
  float mean, stdev;
};

// the general route: any tap counts
__global__ void __launch_bounds__(THREADS, 2) preprocess_tiled(const Args a) {
  extern __shared__ float smem[];
  float* tile = smem;                  // rows x ld: the vertical pass's output
  float* swy = smem + a.rows * a.ld;   // rows x Py: the strip's taps
  const int py = a.Py, px = a.Px;
  const int tid = threadIdx.x;
  const int n = blockIdx.z / a.ncg;
  const int c0 = (blockIdx.z - n * a.ncg) * a.cb;
  const int cb = min(a.cb, a.C - c0);
  const int i0 = blockIdx.y * a.rows;
  const int rows = min(a.rows, a.Hc - i0);
  const int j0 = blockIdx.x * a.cols;
  const int cols = min(a.cols, a.Wc - j0);
  const int xlo = __ldg(a.x0 + j0);
  // floats of a tile row: the input columns from xlo to the end of the
  // last column's window (windows are monotone), cb channels each
  const int width = (__ldg(a.x0 + j0 + cols - 1) + px - xlo) * cb;
  const bool packed = cb == a.C;  // the tile row is one run of the image row
  const size_t rowf = (size_t)a.Wi * a.C;
  const float* im = a.img + (size_t)n * a.Hi * rowf + (size_t)xlo * a.C + c0;

  // the strip's windows: first input rows (a row past the strip's band
  // for rows the strip lacks) and their taps
  int y0r[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    y0r[r] = r < rows ? __ldg(a.y0 + i0 + r) : INT_MAX / 2;
  const int ylo = y0r[0], yhi = __ldg(a.y0 + i0 + rows - 1) + py - 1;
  for (int e = tid; e < rows * py; e += THREADS)
    swy[e] = __ldg(a.wy + (size_t)i0 * py + e);
  __syncthreads();

  // 1. Vertical pass.  The thread's floats g = tid + k * THREADS of the
  // tile row; each input row of the strip's band is read once, and its
  // values join the sums of every output row whose window holds it, in
  // the window's order: acc[r][k] = sum_p wy[i0 + r][p] * img row
  // y0[i0 + r] + p
  int off[G];
  bool ok[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int g = tid + k * THREADS;
    ok[k] = g < width;
    const int q = packed ? 0 : g / cb;
    off[k] = packed ? g : q * a.C + (g - q * cb);
  }
  float acc[ROWS][G];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int k = 0; k < G; ++k) acc[r][k] = 0.f;
  for (int yb = ylo; yb <= yhi; yb += U) {
    float x[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < G; ++k)
        x[u][k] = ok[k] && yb + u <= yhi
                      ? __ldg(im + (size_t)(yb + u) * rowf + off[k])
                      : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int p = yb + u - y0r[r];
        if (p >= 0 && p < py) {
          const float w = swy[r * py + p];
#pragma unroll
          for (int k = 0; k < G; ++k) acc[r][k] = fmaf(w, x[u][k], acc[r][k]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (r < rows && ok[k]) tile[r * a.ld + tid + k * THREADS] = acc[r][k];
  __syncthreads();

  // 2. Horizontal pass and the affine: out[i0 + r][j][c] =
  //    (sum_p wx[j][p] * tile[r][x0[j] - xlo + p][c] - mean) * (1 / std),
  //    one output float of the segment a thread at a time, all rows at once
  const size_t orow = (size_t)a.Wc * a.C;
  const float inv = __frcp_rn(a.stdev);
  float* dst = a.out + ((size_t)n * a.Hc + i0) * orow + (size_t)j0 * a.C + c0;
  for (int f = tid; f < cols * cb; f += THREADS) {
    const int jj = f / cb, cc = f - jj * cb;
    const int j = j0 + jj;
    const float* t = tile + (__ldg(a.x0 + j) - xlo) * cb + cc;
    const float* w = a.wx + (size_t)j * px;
    float o[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) o[r] = 0.f;
#pragma unroll 2
    for (int p = 0; p < px; ++p) {
      const float wp = __ldg(w + p);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < rows) o[r] = fmaf(wp, t[r * a.ld + p * cb], o[r]);
    }
    float* od = dst + (packed ? f : jj * a.C + cc);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < rows) od[r * orow] = __fmul_rn(__fsub_rn(o[r], a.mean), inv);
  }
}

// P = 2 on both axes, direct: one thread per output float f of a row, for
// DR rows; its 2 x 2 window read from global memory, summed in the tiled
// route's order: the vertical sums, then the horizontal.
__global__ void __launch_bounds__(THREADS) preprocess_direct(const Args a) {
  const int rowc = a.Wc * a.C;
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= rowc) return;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * DR;
  const int j = f / a.C, c = f - j * a.C;
  const int x = __ldg(a.x0 + j);
  const float wx0 = __ldg(a.wx + 2 * j), wx1 = __ldg(a.wx + 2 * j + 1);
  const size_t rowf = (size_t)a.Wi * a.C;
  const float* im = a.img + (size_t)n * a.Hi * rowf + (size_t)x * a.C + c;
  float* o = a.out + ((size_t)n * a.Hc + i0) * rowc + f;
  const float inv = __frcp_rn(a.stdev);
  float v[DR];
#pragma unroll
  for (int r = 0; r < DR; ++r) {
    const int i = min(i0 + r, a.Hc - 1);
    const float* s0 = im + (size_t)__ldg(a.y0 + i) * rowf;
    const float wy0 = __ldg(a.wy + 2 * i), wy1 = __ldg(a.wy + 2 * i + 1);
    const float t0 = fmaf(wy1, __ldg(s0 + rowf), fmaf(wy0, __ldg(s0), 0.f));
    const float t1 = fmaf(wy1, __ldg(s0 + rowf + a.C),
                          fmaf(wy0, __ldg(s0 + a.C), 0.f));
    v[r] = fmaf(wx1, t1, fmaf(wx0, t0, 0.f));
  }
#pragma unroll
  for (int r = 0; r < DR; ++r)
    if (i0 + r < a.Hc)
      o[(size_t)r * rowc] = __fmul_rn(__fsub_rn(v[r], a.mean), inv);
}

// the wide route's vertical pass: tmp[n][i][f] = sum_p wy[i][p] *
// img[n][y0[i] + p][xlo * C + f], f < rowt = the floats of a scratch row
__global__ void __launch_bounds__(THREADS) preprocess_wide_vertical(
    const Args a, float* tmp, int xlo, int rowt) {
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= rowt) return;
  const int i = blockIdx.y, n = blockIdx.z;
  const size_t rowf = (size_t)a.Wi * a.C;
  const float* im = a.img + ((size_t)n * a.Hi + __ldg(a.y0 + i)) * rowf +
                    (size_t)xlo * a.C + f;
  const float* w = a.wy + (size_t)i * a.Py;
  float acc = 0.f;
#pragma unroll 8
  for (int p = 0; p < a.Py; ++p)
    acc = fmaf(__ldg(w + p), __ldg(im + (size_t)p * rowf), acc);
  tmp[((size_t)n * a.Hc + i) * rowt + f] = acc;
}

// the wide route's horizontal pass and the affine: out[n][i][j][c] =
// (sum_p wx[j][p] * tmp[n][i][(x0[j] - xlo + p) * C + c] - mean) / std
__global__ void __launch_bounds__(THREADS) preprocess_wide_horizontal(
    const Args a, const float* tmp, int xlo, int rowt) {
  const int rowc = a.Wc * a.C;
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= rowc) return;
  const int i = blockIdx.y, n = blockIdx.z;
  const int j = f / a.C, c = f - j * a.C;
  const float* t = tmp + ((size_t)n * a.Hc + i) * rowt +
                   (size_t)(__ldg(a.x0 + j) - xlo) * a.C + c;
  const float* w = a.wx + (size_t)j * a.Px;
  float acc = 0.f;
#pragma unroll 8
  for (int p = 0; p < a.Px; ++p)
    acc = fmaf(__ldg(w + p), t[(size_t)p * a.C], acc);
  a.out[((size_t)n * a.Hc + i) * rowc + f] =
      __fmul_rn(__fsub_rn(acc, a.mean), __frcp_rn(a.stdev));
}

}  // namespace

// img (n, hi, wi, c) and out (n, hc, wc, c), contiguous; y0/wy and x0/wx
// the tap tables ((hc), (hc, py), (wc), (wc, px)); direct: 1 for the
// direct route (py = px = 2 only), 0 for the tiled route, whose tile is
// rows x cols output pixels of cb channels, ld >= the floats of the
// widest tile row (the direct route reads none of the four).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_preprocess_taps_f32(
    const float* img, float* out, const int* y0, const float* wy,
    const int* x0, const float* wx, int n, int hi, int wi, int c, int hc,
    int wc, int py, int px, int direct, int rows, int cols, int cb, int ld,
    float mean, float stdev, void* stream) {
  if (n < 1 || n > 65535 || hi < 1 || wi < 1 || c < 1 || hc < 1 ||
      wc < 1 || py < 1 || py > hi || px < 1 || px > wi ||
      (long long)wc * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int ncg = cb < 1 ? 1 : (c + cb - 1) / cb;
  const Args a{img, out, y0, wy, x0, wx, hi, wi, c, hc, wc, py, px,
               rows, cols, cb, ld, ncg, mean, stdev};
  cudaStream_t s = (cudaStream_t)stream;
  if (direct) {
    if (py != 2 || px != 2) return (int)cudaErrorInvalidValue;
    dim3 grid((wc * c + THREADS - 1) / THREADS, (hc + DR - 1) / DR, n);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    preprocess_direct<<<grid, THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const long long strips = rows < 1 ? 0 : (hc + rows - 1) / rows;
  const long long zs = (long long)n * ncg;
  const size_t smem = (size_t)rows * (ld + py) * sizeof(float);
  if (rows < 1 || rows > ROWS || cols < 1 || cb < 1 || cb > c || ld < 1 ||
      ld > G * THREADS || strips > 65535 || zs > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        preprocess_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((wc + cols - 1) / cols, (unsigned)strips, (unsigned)zs);
  preprocess_tiled<<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The wide route: tap tables as above, tmp a scratch of n * hc * (x1 -
// xlo) * c floats, the input columns [xlo, x1) holding every window of
// x0/wx.  Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_preprocess_wide_f32(
    const float* img, float* tmp, float* out, const int* y0, const float* wy,
    const int* x0, const float* wx, int n, int hi, int wi, int c, int hc,
    int wc, int py, int px, int xlo, int x1, float mean, float stdev,
    void* stream) {
  if (n < 1 || n > 65535 || hi < 1 || wi < 1 || c < 1 || hc < 1 ||
      hc > 65535 || wc < 1 || py < 1 || py > hi || px < 1 || xlo < 0 ||
      x1 > wi || x1 - xlo < px || (long long)(x1 - xlo) * c >= (1LL << 31) ||
      (long long)wc * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Args a{img, out, y0, wy, x0, wx, hi, wi, c, hc, wc, py, px,
               0, 0, 0, 0, 1, mean, stdev};
  const int rowt = (x1 - xlo) * c;
  cudaStream_t s = (cudaStream_t)stream;
  preprocess_wide_vertical<<<dim3((rowt + THREADS - 1) / THREADS, hc, n),
                             THREADS, 0, s>>>(a, tmp, xlo, rowt);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  preprocess_wide_horizontal<<<dim3((wc * c + THREADS - 1) / THREADS, hc, n),
                               THREADS, 0, s>>>(a, tmp, xlo, rowt);
  return (int)cudaGetLastError();
}
