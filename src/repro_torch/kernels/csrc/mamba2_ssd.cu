// Mamba2 SSD (state-space duality) chunked scan, with the D skip and the
// final state, over x (B,T,H,P), dt (B,T,H), A (H,), B/C (B,T,G,N) and an
// initial state (B,H,P,N).  x, B and C are float32 or bfloat16; y is
// written in x's type; dt, A, D and the states are float32.
//
// Replaces: the Pallas TPU kernel mamba2_ssd_pallas / _ssd_kernel in
// src/repro/kernels/mamba2_ssd.py.  Its wrapper transposes x, dt, B and C
// to head-major, writes B and C repeated from G groups to H heads, and
// pads the tail to a whole chunk; its grid walks (batch, head, chunk)
// with the P x N state in VMEM scratch.
//
// Per chunk of c steps (la = cumsum(A dt) within the chunk):
//   y_t = sum_{s<=t} (C_t . B_s) exp(la_t - la_s) dt_s x_s + exp(la_t) C_t . h
//   h  <- exp(la_last) h + sum_s exp(la_last - la_s) dt_s x_s B_s^T
// then y_t += D x_t.
//
// What bounds it on an H100: fp32 arithmetic.  At zamba2's shape
// (B=16, T=512, H=80, P=N=64, chunk 128) the causal half of each chunk's
// products comes to about 22 GFLOP (32 if the c x c products were taken
// whole) against about 384 MB of x, y, B, C and states: 57 flop per
// byte, above the card's ~20 flop/byte fp32 balance point.
//
// What the design does about it: one CTA per (batch, head) walks the
// chunks in order, holding the state in registers (each thread owns
// 8 x 2 of its P x N values, lanes along N so the state's loads and
// stores are coalesced) and a copy in shared memory, rows padded to N+1,
// for the inter-chunk term.  The chunk's x, B and C tiles are staged once in
// shared memory (fp32, B and C rows padded to N+1 so column walks are
// free of bank conflicts).  The c x c score matrix is never held whole:
// rows are taken 32 at a time, and only the causal columns s < r0+32 are
// computed.  Every product is register-tiled (4 x 4 scores, 4 x 2 outputs
// per thread) with one operand broadcast across the warp, so each shared
// load feeds two or more FMAs.  B and C are read by group (h / (H/G)),
// never repeated per head, and x, B and C are read in place through their
// batch and time strides (the model passes slices of the in-projection),
// so no transposed, repeated or padded copy is written.  The tail chunk
// stops at T: its missing steps would add nothing to y and not decay h.
// Plain fp32 FMA, no TF32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNK = 128;
constexpr int MAX_P = 64;
constexpr int MAX_N = 64;
constexpr int ROWS = 32;                  // chunk rows per score tile
constexpr int RPW = ROWS / WARPS;         // rows per warp (4)
constexpr int MAXJ = MAX_CHUNK / 32;      // score columns per lane (4)
constexpr int MAXK = MAX_P / 32;          // P columns per lane (2)
constexpr int MAXI = MAX_P / WARPS;       // state P rows per warp (8)
constexpr int MAXL = MAX_N / 32;          // state N columns per lane (2)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;   // may be null
  const float* h0;
  void* y;
  float* h_out;
  int T, H, P, G, N, chunk;
  long long sxb, sxt;  // x strides (elements) of batch and time
  long long sbb, sbt;  // B strides
  long long scb, sct;  // C strides
};

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float la[MAX_CHUNK];
  __shared__ float dts[MAX_CHUNK];

  const int h = blockIdx.x, b = blockIdx.y;
  const int P = a.P, N = a.N, c = a.chunk, Tn = a.T, H = a.H;
  const int g = h / (H / a.G);
  const int ldn = N + 1;
  float* xs = smem;            // c x P
  float* Bs = xs + c * P;      // c x (N+1)
  float* Cs = Bs + c * ldn;    // c x (N+1)
  float* hs = Cs + c * ldn;    // P x (N+1), the carried state
  float* S = hs + P * ldn;     // ROWS x c score tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float A = a.A[h];
  const float Dh = a.D ? a.D[h] : 0.f;
  const T* x = static_cast<const T*>(a.x) + b * a.sxb + (long long)h * P;
  const T* Bg = static_cast<const T*>(a.Bm) + b * a.sbb + (long long)g * N;
  const T* Cg = static_cast<const T*>(a.Cm) + b * a.scb + (long long)g * N;
  const float* dt = a.dt + (long long)b * Tn * H + h;            // step H
  T* y = static_cast<T*>(a.y) + ((long long)b * Tn * H + h) * P;  // step H*P
  const long long hbase = ((long long)b * H + h) * P * N;

  // this thread's state values: p = warp + WARPS*i, n = lane + 32*k
  float hr[MAXI][MAXL];
#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    const int p = warp + WARPS * i;
#pragma unroll
    for (int k = 0; k < MAXL; ++k) {
      const int n = lane + 32 * k;
      const bool ok = n < N && p < P;
      hr[i][k] = ok ? a.h0[hbase + (long long)p * N + n] : 0.f;
      if (ok) hs[p * ldn + n] = hr[i][k];
    }
  }

  for (int t0 = 0; t0 < Tn; t0 += c) {
    const int clen = min(c, Tn - t0);
    __syncthreads();  // the previous chunk is done with every tile

    // ---- stage the chunk (zero past its end)
    for (int i = tid; i < c; i += THREADS)
      dts[i] = i < clen ? dt[(long long)(t0 + i) * H] : 0.f;
    for (int i = tid; i < c * P; i += THREADS) {
      const int t = i / P, p = i - t * P;
      xs[i] = t < clen ? to_f(x[(t0 + t) * a.sxt + p]) : 0.f;
    }
    for (int i = tid; i < c * N; i += THREADS) {
      const int t = i / N, n = i - t * N;
      const bool ok = t < clen;
      Bs[t * ldn + n] = ok ? to_f(Bg[(t0 + t) * a.sbt + n]) : 0.f;
      Cs[t * ldn + n] = ok ? to_f(Cg[(t0 + t) * a.sct + n]) : 0.f;
    }
    __syncthreads();

    // ---- la = inclusive cumsum of A*dt: 4 steps per lane, then a warp scan
    if (warp == 0) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = lane * 4 + j;
        run += t < c ? A * dts[t] : 0.f;
        v[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = lane * 4 + j;
        if (t < c) la[t] = excl + v[j];
      }
    }
    __syncthreads();

    // ---- y, 32 chunk rows at a time
    for (int r0 = 0; r0 < clen; r0 += ROWS) {
      const int scols = min(c, r0 + ROWS);  // causal: s <= t < r0+ROWS
      const int nj = (scols + 31) / 32;
      const int row0 = warp * RPW;          // this warp's rows in the tile
      // a warp whose rows all lie past the chunk's end (short prompts,
      // ragged tails) skips the products: nothing reads its rows of S
      const bool active = r0 + row0 < clen;
      const int nn = active ? N : 0, ns = active ? scols : 0;

      float acc[RPW][MAXJ];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < nn; ++n) {
        float cv[RPW], bv[MAXJ];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int t = r0 + row0 + i;
          cv[i] = t < c ? Cs[t * ldn + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) {
          const int s = lane + 32 * j;
          bv[j] = (j < nj && s < scols) ? Bs[s * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
          for (int j = 0; j < MAXJ; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int t = r0 + row0 + i;
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) {
          const int s = lane + 32 * j;
          if (j < nj && s < scols) {
            const bool live = t < clen && s <= t;
            S[(row0 + i) * c + s] =
                live ? acc[i][j] * expf(la[t] - la[s]) * dts[s] : 0.f;
          }
        }
      }
      __syncthreads();

      float ya[RPW][MAXK], ia[RPW][MAXK];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int k = 0; k < MAXK; ++k) ya[i][k] = ia[i][k] = 0.f;
      for (int s = 0; s < ns; ++s) {
        float sv[RPW], xv[MAXK];
#pragma unroll
        for (int i = 0; i < RPW; ++i) sv[i] = S[(row0 + i) * c + s];
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          const int p = lane + 32 * k;
          xv[k] = p < P ? xs[s * P + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
          for (int k = 0; k < MAXK; ++k) ya[i][k] = fmaf(sv[i], xv[k], ya[i][k]);
      }
      for (int n = 0; n < nn; ++n) {  // inter-chunk: C_t . h
        float cv[RPW], hv[MAXK];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int t = r0 + row0 + i;
          cv[i] = t < c ? Cs[t * ldn + n] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          const int p = lane + 32 * k;
          hv[k] = p < P ? hs[p * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
          for (int k = 0; k < MAXK; ++k) ia[i][k] = fmaf(cv[i], hv[k], ia[i][k]);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int t = r0 + row0 + i;
        if (t >= clen) continue;
        const float et = expf(la[t]);
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          const int p = lane + 32 * k;
          if (p < P)
            put(y + (long long)(t0 + t) * H * P + p,
                ya[i][k] + et * ia[i][k] + Dh * xs[t * P + p]);
        }
      }
      __syncthreads();  // S is rewritten by the next row tile
    }

    // ---- state: h <- exp(la_last) h + sum_s (x_s w_s) B_s^T
    const float la_last = la[c - 1];
    for (int i = tid; i < c * P; i += THREADS) {
      const int s = i / P;
      xs[i] *= expf(la_last - la[s]) * dts[s];
    }
    __syncthreads();
    const float decay = expf(la_last);
#pragma unroll
    for (int i = 0; i < MAXI; ++i)
#pragma unroll
      for (int k = 0; k < MAXL; ++k) hr[i][k] *= decay;
    for (int s = 0; s < clen; ++s) {
      float xv[MAXI], bv[MAXL];
#pragma unroll
      for (int i = 0; i < MAXI; ++i) {
        const int p = warp + WARPS * i;
        xv[i] = p < P ? xs[s * P + p] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < MAXL; ++k) {
        const int n = lane + 32 * k;
        bv[k] = n < N ? Bs[s * ldn + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < MAXI; ++i)
#pragma unroll
        for (int k = 0; k < MAXL; ++k) hr[i][k] = fmaf(xv[i], bv[k], hr[i][k]);
    }
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      const int p = warp + WARPS * i;
#pragma unroll
      for (int k = 0; k < MAXL; ++k) {
        const int n = lane + 32 * k;
        if (n < N && p < P) hs[p * ldn + n] = hr[i][k];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    const int p = warp + WARPS * i;
#pragma unroll
    for (int k = 0; k < MAXL; ++k) {
      const int n = lane + 32 * k;
      if (n < N && p < P) a.h_out[hbase + (long long)p * N + n] = hr[i][k];
    }
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = (size_t)(a.chunk * a.P + 2 * a.chunk * (a.N + 1) +
                               a.P * (a.N + 1) + ROWS * a.chunk) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&ssd_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(a.H, batch);
  ssd_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y).  Strides are in elements;
// x's head stride is P and B/C's group stride N, each with unit feature
// stride; dt and y are contiguous.  Returns the cudaError_t of the launch.
extern "C" int repro_mamba2_ssd(int dtype, const void* x, const float* dt,
                                const float* A, const void* Bm, const void* Cm,
                                const float* D, const float* h0, void* y,
                                float* h_out, int batch, int T, int H, int P,
                                int G, int N, int chunk, long long sxb,
                                long long sxt, long long sbb, long long sbt,
                                long long scb, long long sct, void* stream) {
  if (batch < 1 || batch > 65535 || T < 1 || H < 1 || G < 1 || H % G != 0 ||
      P < 1 || P > MAX_P || N < 1 || N > MAX_N || chunk < 1 ||
      chunk > MAX_CHUNK || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{x, dt, A, Bm, Cm, D, h0, y, h_out, T, H, P, G, N, chunk,
         sxb, sxt, sbb, sbt, scb, sct};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(a, batch, s)
                    : launch<__nv_bfloat16>(a, batch, s);
}
