// Separable Gaussian blur over (N, H, W, C) float32 images, channels last,
// reflect-101 borders (OpenCV's default).
//
// Replaces: the Pallas TPU kernel gaussian_blur_pallas / _blur_kernel in
// src/repro/kernels/gaussian_blur.py, which needs its wrapper to write two
// reflect-padded copies of the image before one program per (image, row
// band) blurs a band plus the next one.
//
// What bounds it on an H100: memory for a batch, latency for one image.
// Each output value costs 2*ksize flops per pass and 8 bytes of traffic
// (one read, one write), far below the card's ~20 flop/byte balance
// point for fp32, so a batch's floor is reading the images once and
// writing them once at 3.35 TB/s (11.5 us at (32,224,224,3)).  The engine
// blurs most images one at a time (IQ3 and the all-native arm: one
// 250x250 or 224x224 image a launch), where the bytes take under half a
// microsecond and what counts is how many SMs work and how long each
// waits on its loads.
//
// What the design does about it: a CTA owns one strip of SH output rows
// by one segment of the row (a run of W*C floats, channels interleaved),
// and the host sizes both by the image: segments narrow and strips
// shorten until one image launches at least 132 CTAs (a 224x224 image at
// k9: 3 segments x 56 strips), while a batch keeps 8-row strips.  Each
// thread owns one float column of the segment or of its halo of pad*C
// floats a side, walks down the strip and keeps the vertical window of
// ksize input rows in registers, rolling it by one row a step, with the
// next ROWS rows' loads in flight a whole group ahead; so each input row
// is read from device memory once per strip (plus the ksize-1 halo rows),
// in loads that are coalesced across the warp.  Reflect-101 is computed
// in the kernel, once per row for the row index and once per thread for
// a column past a left or right edge (the same in every row); no padded
// copy is written and the inner loops do no division.  Every ROWS
// vertical results go into a double-buffered shared row buffer with
// their halo, one barrier per group, and the horizontal taps read from
// there.  Wider units measured slower on an H100 (700 W): 4 floats a
// thread (16-byte loads where the row allows) took 0.074 ms at
// (32,224,224,3) k9 and 2 floats 0.052, one float 0.050 (more threads, a
// quarter of the registers); 8-row strips took 0.038 there against 16
// rows' 0.040.  The window is indexed statically: ksize 3..15 odd have their own
// instantiation, other sizes up to 15 and 16..63 take a bucket with the
// tap count at run time.  Products and sums are rounded separately
// (__fmul_rn/__fadd_rn, no contraction to FMA), vertical pass first,
// taps in order, so the result equals the plain PyTorch version bit for
// bit.  Taps ride in the parameter block.
//
// Every other window (ksize > 63, or a halo of (ksize / 2) * C floats a
// side that leaves a 256-thread segment no output float, as ksize 5 over
// 64 channels does) takes the general route, repro_gaussian_blur_any_f32:
// the same sums in the same order, rounded the same way, in two plain
// passes through a scratch image that the caller allocates.  The vertical
// pass gives one thread one float of one row and walks the ksize rows of
// its window from global memory (neighbouring threads read neighbouring
// floats; rows shared by the window of the next output row hit L1/L2);
// the horizontal pass does the same along the row, reading the scratch
// image.  Taps are read from device memory, any number of them.
// Reflect-101 repeats as numpy.pad's does, so a pad as large as the image
// or larger indexes as the plain version does.  It reads and writes the
// image twice, not once; it serves windows the engine's queries do not
// send on their main paths.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_K = 63;
constexpr int THREADS = 256;       // one float column of a segment each
constexpr int ROWS = 4;            // vertical rows per barrier, loaded ahead
constexpr int BATCH_ROWS = 8;      // a strip's rows where the launch fills the card
constexpr int TARGET_CTAS = 132;   // one image should fill every SM

struct Taps {
  float v[MAX_K];
};

struct Geometry {
  int H, W, C, K, pad;
  int rowf;   // W * C floats
  int hp;     // halo a side in floats: pad * C
  int segw;   // output floats per segment
  int nq;     // columns of a segment with its halo: segw + 2 * hp
  int sh;     // output rows per strip
};

// reflect-101 of index i into [0, n), repeated as numpy.pad does
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = abs(i) % period;
  return i < n ? i : period - i;
}

// KMAX: the window's static size; EXACT: ksize == KMAX (else g.K <= KMAX
// taps, the rest predicated off)
template <int KMAX, bool EXACT>
__global__ void __launch_bounds__(THREADS)
blur_kernel(const float* __restrict__ in, float* __restrict__ out,
            Geometry g, Taps ky, Taps kx) {
  __shared__ float vbuf[2][ROWS][THREADS];
  const int K = EXACT ? KMAX : g.K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int x0f = blockIdx.x * g.segw;             // first output float
  const int y0 = blockIdx.y * g.sh;
  const size_t img_len = (size_t)g.H * g.rowf;
  const float* img = in + blockIdx.z * img_len;
  float* dst = out + blockIdx.z * img_len + x0f;
  const int rows_out = min(g.sh, g.H - y0);
  const int seg_out = min(g.segw, g.rowf - x0f);
  const bool owner = tid < g.nq;

  // this thread's source column, the same in every row: reflected per
  // pixel (channel kept) only where it lies past a left or right edge
  int col = x0f - g.hp + tid;
  if (col < 0 || col >= g.rowf) {
    const int x = col >= 0 ? col / g.C : -((-col + g.C - 1) / g.C);
    col = reflect101(x, g.W) * g.C + (col - x * g.C);
  }
  auto at = [&](int i) {  // input row i of the strip (i = 0: y0 - pad)
    return __ldg(img + (size_t)reflect101(y0 - g.pad + i, g.H) * g.rowf + col);
  };

  // win holds input rows r .. r+K-1 of output row r; pf the next ROWS
  // rows, each loaded a whole group ahead of its use
  float win[KMAX], pf[ROWS];
  if (owner) {
#pragma unroll
    for (int j = 1; j < KMAX; ++j)
      if (j < K) win[j] = at(j - 1);
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
      if (rr < rows_out) pf[rr] = at(K - 1 + rr);
  }

  for (int r0 = 0; r0 < rows_out; r0 += ROWS) {
    float* vb = &vbuf[(r0 / ROWS) & 1][0][0];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = r0 + rr;
      if (owner && r < rows_out) {
#pragma unroll
        for (int j = 0; j + 1 < KMAX; ++j)
          if (j + 1 < K) win[j] = win[j + 1];
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j == K - 1) win[j] = pf[rr];
        if (r + ROWS < rows_out) pf[rr] = at(r + ROWS + K - 1);
        float acc = __fmul_rn(ky.v[0], win[0]);
#pragma unroll
        for (int t = 1; t < KMAX; ++t)
          if (t < K) acc = __fadd_rn(acc, __fmul_rn(ky.v[t], win[t]));
        vb[rr * THREADS + tid] = acc;
      }
    }
    __syncthreads();  // this group's vertical rows are in vb
    // horizontal taps: output float f of the segment reads vb at
    // f + t*C (vb's column 0 is the segment's first float less its halo)
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = r0 + rr;
      if (r >= rows_out) break;
      const float* src = vb + rr * THREADS;
      float* o = dst + (size_t)(y0 + r) * g.rowf;
      for (int f = tid; f < seg_out; f += nt) {
        float acc = __fmul_rn(kx.v[0], src[f]);
#pragma unroll
        for (int t = 1; t < KMAX; ++t)
          if (t < K) acc = __fadd_rn(acc, __fmul_rn(kx.v[t], src[f + t * g.C]));
        o[f] = acc;
      }
    }
    // the next group writes the other buffer; the one after it this
    // buffer, only once every thread has passed the next barrier
  }
}

template <int KMAX, bool EXACT>
int launch(const float* in, float* out, const Geometry& g, int n,
           const Taps& ky, const Taps& kx, cudaStream_t stream) {
  const int nt = (g.nq + 31) / 32 * 32;
  dim3 grid((g.rowf + g.segw - 1) / g.segw, (g.H + g.sh - 1) / g.sh, n);
  blur_kernel<KMAX, EXACT><<<grid, nt, 0, stream>>>(in, out, g, ky, kx);
  return (int)cudaGetLastError();
}

// Segments and strips sized by the image: a batch keeps 8-row strips;
// while the launch has fewer than TARGET_CTAS CTAs, strips shorten to 4
// rows, then segments halve down to about 96 floats.
bool plan(Geometry& g, int n) {
  g.hp = g.pad * g.C;
  const int maxseg = THREADS - 2 * g.hp;
  if (maxseg < 1) return false;
  int nseg = (g.rowf + maxseg - 1) / maxseg;
  auto width = [&](int ns) { return (g.rowf + ns - 1) / ns; };
  g.segw = width(nseg);
  g.sh = BATCH_ROWS;
  for (;;) {
    const long long ctas = (long long)n * ((g.rowf + g.segw - 1) / g.segw) *
                           ((g.H + g.sh - 1) / g.sh);
    if (ctas >= TARGET_CTAS) break;
    if (g.sh > 4) {
      g.sh /= 2;
    } else if (g.segw > 96) {
      nseg *= 2;
      g.segw = width(nseg);
    } else {
      break;
    }
  }
  g.nq = g.segw + 2 * g.hp;
  return (g.H + g.sh - 1) / g.sh <= 65535;
}

// ------------------------------------------------------------ any window
// vertical pass:
//   tmp[z, y, f] = sum_t taps[t] * in[z, reflect(y - pad + t), f]
__global__ void __launch_bounds__(THREADS)
blur_any_vertical(const float* __restrict__ in, float* __restrict__ tmp,
                  const float* __restrict__ taps, int H, int rowf, int K) {
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= rowf) return;
  const size_t img_len = (size_t)H * rowf;
  const float* src = in + blockIdx.z * img_len + f;
  float* dst = tmp + blockIdx.z * img_len + f;
  const int pad = K / 2;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    auto row = [&](int t) {  // input row t of output row y's window
      return __ldg(src + (size_t)reflect101(y - pad + t, H) * rowf);
    };
    float acc = __fmul_rn(__ldg(taps), row(0));
    for (int t = 1; t < K; ++t)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(taps + t), row(t)));
    dst[(size_t)y * rowf] = acc;
  }
}

// horizontal pass:
//   out[z, y, x*C + c] = sum_t taps[t] * tmp[z, y, reflect(x - pad + t)*C + c]
__global__ void __launch_bounds__(THREADS)
blur_any_horizontal(const float* __restrict__ tmp, float* __restrict__ out,
                    const float* __restrict__ taps, int H, int W, int C,
                    int K) {
  const int rowf = W * C;
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= rowf) return;
  const int x = f / C, c = f - x * C;
  const int pad = K / 2;
  const size_t img_len = (size_t)H * rowf;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    const float* src = tmp + blockIdx.z * img_len + (size_t)y * rowf + c;
    float acc = __fmul_rn(__ldg(taps), src[reflect101(x - pad, W) * C]);
    for (int t = 1; t < K; ++t)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(taps + t),
                                     src[reflect101(x - pad + t, W) * C]));
    out[blockIdx.z * img_len + (size_t)y * rowf + f] = acc;
  }
}

}  // namespace

// Any ksize >= 1 and any C: taps (2, ksize) on the device, vertical then
// horizontal; tmp is scratch of the image's size.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int repro_gaussian_blur_any_f32(const float* in, float* tmp,
                                           float* out, int n, int h, int w,
                                           int c, const float* taps,
                                           int ksize, void* stream) {
  if (ksize < 1 || n < 1 || n > 65535 || h < 1 || w < 1 || c < 1 ||
      (size_t)w * c >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const int rowf = w * c;
  dim3 grid((rowf + THREADS - 1) / THREADS, h < 65535 ? h : 65535, n);
  cudaStream_t s = (cudaStream_t)stream;
  blur_any_vertical<<<grid, THREADS, 0, s>>>(in, tmp, taps, h, rowf, ksize);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  blur_any_horizontal<<<grid, THREADS, 0, s>>>(tmp, out, taps + ksize, h, w,
                                               c, ksize);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_gaussian_blur_f32(const float* in, float* out, int n,
                                       int h, int w, int c, const float* ky,
                                       const float* kx, int ksize,
                                       void* stream) {
  if (ksize < 1 || ksize > MAX_K || n > 65535 || h < 1 || w < 1 || c < 1 ||
      (size_t)h * w * c >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  Taps tky = {}, tkx = {};
  for (int t = 0; t < ksize; ++t) {
    tky.v[t] = ky[t];
    tkx.v[t] = kx[t];
  }
  Geometry g{h, w, c, ksize, ksize / 2, w * c, 0, 0, 0, 0};
  if (!plan(g, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ksize) {
    case 3: return launch<3, true>(in, out, g, n, tky, tkx, s);
    case 5: return launch<5, true>(in, out, g, n, tky, tkx, s);
    case 7: return launch<7, true>(in, out, g, n, tky, tkx, s);
    case 9: return launch<9, true>(in, out, g, n, tky, tkx, s);
    case 11: return launch<11, true>(in, out, g, n, tky, tkx, s);
    case 13: return launch<13, true>(in, out, g, n, tky, tkx, s);
    case 15: return launch<15, true>(in, out, g, n, tky, tkx, s);
    default:
      return ksize <= 15 ? launch<15, false>(in, out, g, n, tky, tkx, s)
                         : launch<MAX_K, false>(in, out, g, n, tky, tkx, s);
  }
}
