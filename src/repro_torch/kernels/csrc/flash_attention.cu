// FlashAttention forward with online softmax over q (B,Sq,H,D) and
// k, v (B,Sk,Hkv,D), grouped-query heads (q head h reads kv head
// h / (H/Hkv)), optional causal masking at an offset q_offset (query row
// i sits at position q_offset + i), padded tails masked.  q, k and v are
// float32 or bfloat16; out is written in q's type, and the log-sum-exp
// lse (B,Sq,H) in float32 for the recomputing backward.
//
// Replaces: the Pallas TPU kernel flash_attention_pallas / _fa_kernel in
// src/repro/kernels/flash_attention.py, and the forward of
// src/repro/kernels/flash_vjp.py (_fwd_impl), which is the route the
// model takes beyond 1024 positions.  The Pallas kernel has no q_offset,
// so it could not serve the prefill into a cache; this kernel takes one.
// Masked logits are the finite -1e30 of flash_vjp.py, so a fully masked
// tile gives no NaN.
//
// What bounds it on an H100: fp32 arithmetic.  At the long-context
// prefill (q (4,4096,16,128) against a 4113-slot cache, causal) the two
// products over the visible (query, key) pairs come to about 275 GFLOP
// (4.1 ms at the fp32 peak) against about 100 MB of q, k, v and out.
//
// What the design does about it: one CTA per (q tile of 64 rows, head,
// batch), q tiles issued heaviest first.  The tile of q is staged once
// in shared memory; the CTA walks 64-key tiles of K and V only up to the
// causal edge q_offset + (last row of the tile) + 1, so the unwritten
// tail of a cache is never read.  K is stored transposed and every row
// padded by one float, so the Q K^T and P V products read shared memory
// without bank conflicts; each thread holds a 4 x 4 tile of logits and a
// 4 x (D/16) tile of the output, with one operand broadcast across the
// half-warp that shares a row.  Row maxima and sums are taken with
// shuffles among the 16 threads of a row; the running max, sum and
// output stay in registers for the whole walk.  K and V are read through
// their batch and sequence strides, by kv head (never repeated).  Plain
// fp32 FMA, no TF32; bf16 inputs are widened on load.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;                 // query rows per CTA
constexpr int BK = 64;                 // keys per tile
constexpr int TROWS = BQ / 16;         // rows per thread (4)
constexpr int TCOLS = BK / 16;         // logit columns per thread (4)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int Sq, Sk, H, Hkv, q_offset, causal;
  float scale;
  long long sqb, sqt;  // q strides (elements) of batch and sequence
  long long skb, skt;  // k strides
  long long svb, svt;  // v strides
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) fa_kernel(Args a) {
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // BQ x (D+1)
  float* Kt = Qs + BQ * (D + 1);      // D x (BK+1), K transposed
  float* Vs = Kt + D * (BK + 1);      // BK x D
  float* Ps = Vs + BK * D;            // BQ x (BK+1)

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * BQ;
  const int qrows = min(BQ, a.Sq - q0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* q = static_cast<const T*>(a.q) + b * a.sqb + (long long)h * D;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + (long long)hk * D;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + (long long)hk * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    Qs[r * (D + 1) + d] = r < qrows ? to_f(q[(q0 + r) * a.sqt + d]) : 0.f;
  }

  float m[TROWS], l[TROWS], acc[TROWS][DJ];
#pragma unroll
  for (int i = 0; i < TROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = a.causal ? min(a.Sk, a.q_offset + q0 + qrows) : a.Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's products are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i - c * D;
      const bool ok = k0 + c < a.Sk;
      Kt[d * (BK + 1) + c] = ok ? to_f(k[(k0 + c) * a.skt + d]) : 0.f;
      Vs[c * D + d] = ok ? to_f(v[(k0 + c) * a.svt + d]) : 0.f;
    }
    __syncthreads();

    // ---- logits: rows ty + 16 i, columns tx + 16 j
    float s[TROWS][TCOLS];
#pragma unroll
    for (int i = 0; i < TROWS; ++i)
#pragma unroll
      for (int j = 0; j < TCOLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[TROWS], kv[TCOLS];
#pragma unroll
      for (int i = 0; i < TROWS; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < TCOLS; ++j) kv[j] = Kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TROWS; ++i)
#pragma unroll
        for (int j = 0; j < TCOLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // ---- mask, online softmax (the 16 threads of a row share it)
#pragma unroll
    for (int i = 0; i < TROWS; ++i) {
      const int row = q0 + ty + 16 * i;
      const int qpos = a.q_offset + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TCOLS; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < a.Sk && row < a.Sq && (!a.causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TCOLS; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // ---- acc += P V over the keys this tile holds below kv_end (the
    // rest carry p = 0)
    const int cmax = min(BK, kv_end - k0);
    for (int c = 0; c < cmax; ++c) {
      float pv[TROWS], vv[DJ];
#pragma unroll
      for (int i = 0; i < TROWS; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TROWS; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < TROWS; ++i) {
    const int r = ty + 16 * i;
    if (r >= qrows) continue;
    const long long row = ((long long)b * a.Sq + q0 + r) * a.H + h;
    const float lsafe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      put(out + row * D + tx + 16 * j, acc[i][j] / lsafe);
    if (tx == 0) a.lse[row] = m[i] + logf(lsafe);
  }
}

template <typename T, int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem =
      (size_t)(BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&fa_kernel<T, D>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, batch);
  fa_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int D, int batch, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, batch, stream);
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out).  Strides are in
// elements; q's head stride is D and k's and v's D, each with unit
// feature stride; out (B,Sq,H,D) and lse (B,Sq,H) are contiguous.
// Returns the cudaError_t of the launch.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     int batch, int Sq, int Sk, int H, int Hkv,
                                     int D, int q_offset, int causal,
                                     float scale, long long sqb, long long sqt,
                                     long long skb, long long skt,
                                     long long svb, long long svt,
                                     void* stream) {
  if (batch < 1 || batch > 65535 || Sq < 1 || Sk < 1 || H < 1 ||
      H > 65535 || Hkv < 1 || H % Hkv != 0 || q_offset < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, lse, Sq, Sk, H, Hkv, q_offset, causal ? 1 : 0, scale,
         sqb, sqt, skb, skt, svb, svt};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch_d<float>(a, D, batch, s)
                    : launch_d<__nv_bfloat16>(a, D, batch, s);
}
