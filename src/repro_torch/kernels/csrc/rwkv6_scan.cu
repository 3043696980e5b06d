// RWKV6 WKV chunked scan over r, k, w (B,T,H,K), v (B,T,H,V), the bonus
// u (H,K) and an initial state (B,H,K,V).  r, k and v are float32 or
// bfloat16; the output is written in r's type; w, u and the states are
// float32.
//
// Replaces: the Pallas TPU kernel rwkv6_scan_pallas / _wkv_kernel in
// src/repro/kernels/rwkv6_scan.py.  Its wrapper transposes r, k, v and w
// to head-major and pads the tail to a whole chunk with w = 1; its grid
// walks (batch, head, chunk) with the K x V state in VMEM scratch.
//
// Per chunk of c steps, with lw = cumsum(log max(w, 1e-30)) within the
// chunk and lwp the same sum over strictly earlier steps:
//   y_t = (r_t * exp(lwp_t)) . S                                  (inter)
//       + sum_{s<t} [sum_k r_tk k_sk exp(lwp_tk - lw_sk)] v_s       (intra)
//       + (sum_k r_tk u_k k_tk) v_t                                 (bonus)
//   S  <- diag(exp(lw_last)) S + sum_s (k_s * exp(lw_last - lw_s)) v_s^T
// Every exponent is a sum of log-decays over a span of steps, so it is
// <= 0: the decay between s and t is taken as exp(lwp_t - lw_s), never
// as exp(lwp_t) * exp(-lw_s), since -lw passes 88 within a chunk when a
// step's log-decay reaches about -7 and exp(-lw) overflows float32.
//
// What bounds it on an H100: the exponentials of the intra-chunk decay
// cube.  At the model_serve prefill shape (B=16, T=512, H=32, K=V=64,
// chunk 64) the causal half of each chunk's c x c x K cube is about
// 530 M of the call's 580 M exponentials (0.14 ms on the SFUs), against
// about 7.6 GFLOP of fp32 work (0.11 ms) and 352 MB of inputs and
// outputs (0.11 ms).
//
// What the design does about it: one CTA per (batch, head) walks the
// chunks in order, holding the state in registers (each thread owns
// 8 x 2 of its K x V values, lanes along V) and a copy in shared memory
// for the inter-chunk term.  Per chunk r, k and v are staged once in
// shared memory in float32 together with lw (rows of r, k and lw padded
// to K+1, so the column walks of the decay cube are free of bank
// conflicts; lwp is the row of lw above, so it needs no array of its
// own, and two CTAs fit on an SM), and one c x c tile att holds the
// intra-chunk weights with the bonus on its diagonal.  Each thread
// computes a register tile of 8 rows t x 2 columns s of att, so one
// shared load of r_t and lwp_t feeds two exponentials and one of k_s and
// lw_s eight; pairs with s >= t are skipped, so only the causal half of
// the cube is exponentiated.  y = (r exp(lwp)) . S + att . v and the
// state update are register-tiled (8 x 2 per thread) with one operand
// broadcast across the warp.  r, k, v and w are read in place through
// their batch and time strides (no transposed or padded copy), and the
// tail chunk stops at T: its missing steps would have w = 1, k = 0 and
// change nothing.  Plain fp32 FMA, no TF32; the cube's exponentials are __expf
// (ex2.approx of a scaled argument: a relative error of about 1e-7 per
// unit of |argument|, far inside the float32 tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNK = 64;
constexpr int MAX_K = 64;
constexpr int MAX_V = 64;
constexpr int ROWS = MAX_CHUNK / WARPS;  // chunk rows per warp (8)
constexpr int KROWS = MAX_K / WARPS;     // state K rows per warp (8)
constexpr int VCOLS = MAX_V / 32;        // V columns per lane (2)
constexpr int SCOLS = MAX_CHUNK / 32;    // att columns per lane (2)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;  // may be null: start from zeros
  void* y;
  float* s_out;
  int T, H, K, V, chunk;
  long long srb, srt;  // r strides (elements) of batch and time
  long long skb, skt;  // k strides
  long long svb, svt;  // v strides
  long long swb, swt;  // w strides
};

template <typename T>
__global__ void __launch_bounds__(THREADS) wkv_kernel(Args a) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int K = a.K, V = a.V, c = a.chunk, Tn = a.T, H = a.H;
  const int ldk = K + 1;
  float* rs = smem;             // c x (K+1): r, then r * exp(lwp)
  float* ks = rs + c * ldk;     // c x (K+1): k, then k * exp(lw_last - lw)
  float* lw = ks + c * ldk;     // c x (K+1): log-decay, then its cumsum
  float* vs = lw + c * ldk;     // c x V
  float* att = vs + c * V;      // c x c
  float* S = att + c * c;       // K x V, the carried state
  float* us = S + K * V;        // K

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* r = static_cast<const T*>(a.r) + b * a.srb + (long long)h * K;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + (long long)h * K;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + (long long)h * V;
  const float* w = a.w + b * a.swb + (long long)h * K;
  T* y = static_cast<T*>(a.y) + ((long long)b * Tn * H + h) * V;  // step H*V
  const long long sbase = ((long long)b * H + h) * K * V;

  for (int i = tid; i < K; i += THREADS) us[i] = a.u[(long long)h * K + i];

  // this thread's state values: row kk = warp + WARPS*i, column lane + 32*j
  float sr[KROWS][VCOLS];
#pragma unroll
  for (int i = 0; i < KROWS; ++i) {
    const int kk = warp + WARPS * i;
#pragma unroll
    for (int j = 0; j < VCOLS; ++j) {
      const int vv = lane + 32 * j;
      const bool ok = kk < K && vv < V;
      sr[i][j] = (ok && a.s0) ? a.s0[sbase + (long long)kk * V + vv] : 0.f;
      if (ok) S[kk * V + vv] = sr[i][j];
    }
  }

  for (int t0 = 0; t0 < Tn; t0 += c) {
    const int clen = min(c, Tn - t0);
    __syncthreads();  // the previous chunk is done with every tile

    // ---- stage the chunk: rows past its end get r = k = v = 0, w = 1
    for (int i = tid; i < c * K; i += THREADS) {
      const int t = i / K, kk = i - t * K;
      const bool ok = t < clen;
      rs[t * ldk + kk] = ok ? to_f(r[(t0 + t) * a.srt + kk]) : 0.f;
      ks[t * ldk + kk] = ok ? to_f(k[(t0 + t) * a.skt + kk]) : 0.f;
      lw[t * ldk + kk] =
          ok ? logf(fmaxf(w[(t0 + t) * a.swt + kk], 1e-30f)) : 0.f;
    }
    for (int i = tid; i < c * V; i += THREADS) {
      const int t = i / V, vv = i - t * V;
      vs[i] = t < clen ? to_f(v[(t0 + t) * a.svt + vv]) : 0.f;
    }
    __syncthreads();

    // ---- cumulative log-decays, one channel per thread; the sum over
    // strictly earlier steps, lwp_t, is lw_{t-1} (0 at t = 0)
    for (int kk = tid; kk < K; kk += THREADS) {
      float run = 0.f;
      for (int t = 0; t < c; ++t) {
        run += lw[t * ldk + kk];
        lw[t * ldk + kk] = run;
      }
    }
    __syncthreads();

    // ---- att[t][s]: the decay-weighted r_t . k_s for s < t, zero above
    // the diagonal; rows t = warp + WARPS*i, columns s = lane + 32*j
    {
      float acc[ROWS][SCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < SCOLS; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < K; ++kk) {
        float rt[ROWS], lt[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int t = warp + WARPS * i;
          const bool live = t < clen;
          rt[i] = live ? rs[t * ldk + kk] : 0.f;
          lt[i] = live && t > 0 ? lw[(t - 1) * ldk + kk] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < SCOLS; ++j) {
          const int s = lane + 32 * j;
          const bool col = s < clen;
          const float kv = col ? ks[s * ldk + kk] : 0.f;
          const float ls = col ? lw[s * ldk + kk] : 0.f;
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const int t = warp + WARPS * i;
            if (s < t && t < clen)
              acc[i][j] = fmaf(rt[i] * kv, __expf(lt[i] - ls), acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int t = warp + WARPS * i;
#pragma unroll
        for (int j = 0; j < SCOLS; ++j) {
          const int s = lane + 32 * j;
          if (t < c && s < c) att[t * c + s] = acc[i][j];
        }
      }
    }
    __syncwarp();  // this warp's rows of att are written
    // the bonus r_t . (u * k_t) on the diagonal, a warp reduction per row
#pragma unroll 1
    for (int i = 0; i < ROWS; ++i) {
      const int t = warp + WARPS * i;
      if (t >= clen) break;
      float part = 0.f;
      for (int kk = lane; kk < K; kk += 32)
        part = fmaf(rs[t * ldk + kk] * us[kk], ks[t * ldk + kk], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) att[t * c + t] = part;
    }
    __syncthreads();

    // ---- r * exp(lwp) and k * exp(lw_last - lw), in place
    const int last = clen - 1;
    for (int i = tid; i < c * K; i += THREADS) {
      const int t = i / K, kk = i - t * K;
      rs[t * ldk + kk] *= t > 0 ? expf(lw[(t - 1) * ldk + kk]) : 1.f;
      ks[t * ldk + kk] *= expf(lw[last * ldk + kk] - lw[t * ldk + kk]);
    }
    __syncthreads();

    // ---- y = (r exp(lwp)) . S + att . v, rows t = warp + WARPS*i
    {
      float ya[ROWS][VCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < VCOLS; ++j) ya[i][j] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        float q[ROWS], sv[VCOLS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int t = warp + WARPS * i;
          q[i] = t < c ? rs[t * ldk + kk] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < VCOLS; ++j) {
          const int vv = lane + 32 * j;
          sv[j] = vv < V ? S[kk * V + vv] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < VCOLS; ++j) ya[i][j] = fmaf(q[i], sv[j], ya[i][j]);
      }
      // causal: row t needs s <= t; this warp's last row is the largest
      const int smax = min(clen, warp + WARPS * (ROWS - 1) + 1);
      for (int s = 0; s < smax; ++s) {
        float p[ROWS], vv_[VCOLS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int t = warp + WARPS * i;
          p[i] = t < c ? att[t * c + s] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < VCOLS; ++j) {
          const int vv = lane + 32 * j;
          vv_[j] = vv < V ? vs[s * V + vv] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < VCOLS; ++j) ya[i][j] = fmaf(p[i], vv_[j], ya[i][j]);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int t = warp + WARPS * i;
        if (t >= clen) continue;
#pragma unroll
        for (int j = 0; j < VCOLS; ++j) {
          const int vv = lane + 32 * j;
          if (vv < V) put(y + (long long)(t0 + t) * H * V + vv, ya[i][j]);
        }
      }
    }

    // ---- state: S <- diag(exp(lw_last)) S + (k exp(lw_last - lw))^T v
#pragma unroll
    for (int i = 0; i < KROWS; ++i) {
      const int kk = warp + WARPS * i;
      const float d = kk < K ? expf(lw[last * ldk + kk]) : 0.f;
#pragma unroll
      for (int j = 0; j < VCOLS; ++j) sr[i][j] *= d;
    }
    for (int s = 0; s < clen; ++s) {
      float kd[KROWS], vv_[VCOLS];
#pragma unroll
      for (int i = 0; i < KROWS; ++i) {
        const int kk = warp + WARPS * i;
        kd[i] = kk < K ? ks[s * ldk + kk] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < VCOLS; ++j) {
        const int vv = lane + 32 * j;
        vv_[j] = vv < V ? vs[s * V + vv] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < KROWS; ++i)
#pragma unroll
        for (int j = 0; j < VCOLS; ++j) sr[i][j] = fmaf(kd[i], vv_[j], sr[i][j]);
    }
    __syncthreads();  // every warp has read S for its y rows
#pragma unroll
    for (int i = 0; i < KROWS; ++i) {
      const int kk = warp + WARPS * i;
#pragma unroll
      for (int j = 0; j < VCOLS; ++j) {
        const int vv = lane + 32 * j;
        if (kk < K && vv < V) S[kk * V + vv] = sr[i][j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KROWS; ++i) {
    const int kk = warp + WARPS * i;
#pragma unroll
    for (int j = 0; j < VCOLS; ++j) {
      const int vv = lane + 32 * j;
      if (kk < K && vv < V) a.s_out[sbase + (long long)kk * V + vv] = sr[i][j];
    }
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = (size_t)(3 * a.chunk * (a.K + 1) + a.chunk * a.V +
                               a.chunk * a.chunk + a.K * a.V + a.K) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&wkv_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(a.H, batch);
  wkv_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (r, k, v and y).  Strides are in
// elements; r, k and w have head stride K and v head stride V, each with
// unit feature stride; u, the states and y are contiguous.  s0 may be
// null (a zero initial state).  Returns the cudaError_t of the launch.
extern "C" int repro_rwkv6_scan(int dtype, const void* r, const void* k,
                                const void* v, const float* w, const float* u,
                                const float* s0, void* y, float* s_out,
                                int batch, int T, int H, int K, int V,
                                int chunk, long long srb, long long srt,
                                long long skb, long long skt, long long svb,
                                long long svt, long long swb, long long swt,
                                void* stream) {
  if (batch < 1 || batch > 65535 || T < 1 || H < 1 || K < 1 || K > MAX_K ||
      V < 1 || V > MAX_V || chunk < 1 || chunk > MAX_CHUNK ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{r, k, v, w, u, s0, y, s_out, T, H, K, V, chunk,
         srb, srt, skb, skt, svb, svt, swb, swt};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(a, batch, s)
                    : launch<__nv_bfloat16>(a, batch, s);
}
