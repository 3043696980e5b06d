// The gradient of the RWKV6 WKV scan (csrc/rwkv6_scan.cu): from r, k, w
// (B,T,H,K), v (B,T,H,V), the bonus u (H,K), an initial state s0
// (B,H,K,V) and the cotangents dy of y (B,T,H,V) and ds of the final
// state (B,H,K,V), the gradients dr, dk, dv in r's type and dw, du, ds0
// in float32.  r, k, v and dy are float32 or bfloat16; w, u and the
// states float32.  s0 and ds may be null (zeros).
//
// Replaces: no Pallas kernel.  The JAX package differentiates its chunked
// form rwkv6_chunked_jnp (src/repro/kernels/ref.py:232) by autodiff off
// the TPU, and the port recomputed the plain chunked form op by op under
// autograd, a (c, c, K) decay cube and an HBM round trip for every einsum
// of every 64-step chunk.
//
// With S_t the state after step t (S_t = diag(w_t) S_{t-1} + k_t v_t^T)
// and G_t its adjoint (G_T = ds, G_{t-1} = diag(w_t) G_t + r_t dy_t^T):
//   dr_t = S_{t-1} dy_t + (u o k_t)(v_t . dy_t)
//   dk_t = G_t v_t + (u o r_t)(v_t . dy_t)
//   dv_t = G_t^T k_t + (r_t . (u o k_t)) dy_t
//   du   = sum_t (r_t o k_t)(v_t . dy_t),   ds0 = G_0
//   dw_j = dlogw_j / w_j (0 where w_j < 1e-30: the clamp cuts it), with
//   dr', dk' the parts of dr, dk without the bonus and e the last step of
//   j's block:  dlogw_j = rowsum(G_e o S_e) + sum_{j<t<=e} r_t o dr'_t
//                         - sum_{j<=s<=e} k_s o dk'_s
// The last identity gives the decay's gradient from what each block
// already has: no per-step S_{t-1} o G_t product.
//
// What bounds it on an H100: the bytes.  At rwkv6-1.6b's training
// microbatch (B=2, T=4096, H=32, K=V=64, bf16) the function reads r, k,
// v, dy, w and writes dr, dk, dv, dw (~370 MB, 0.11 ms); its products
// (the readouts S dy, G v, G^T k and the decays' sums, 10KV a step) are
// 10.7 GFLOP.  The sequential walk is what a design must keep short.
//
// What the design does about it: three launches, no atomics.
//   1. walk_kernel: the states S at every 16-step block boundary, walking
//      forward from s0, and the adjoints G at every boundary, walking
//      backward from ds, each by the plain recurrence in float32 FMA.
//      A column of S (or G) evolves on its own (the decay is diagonal in
//      K), so a CTA holds 16 columns: grid (2 directions x V/16, H, B),
//      each thread 8 entries of one row in registers.  The blocks' rows
//      are staged by cp.async three blocks ahead of the one it steps
//      through.  The boundaries go to two float32 (B, H, T/16 + 1, K, V)
//      buffers.
//   2. block_kernel: one CTA per (16-step block, head, batch), in any
//      order.  From S at the block's start and G at its end it computes,
//      with lw the block's cumulative log2-decays (lwp over strictly
//      earlier steps, b the last step):
//        dr'_t = exp2(lwp_t) o (S_a dy_t) + sum_{s<t} (dy_t.v_s) k_s o E_ts
//        dk'_s = exp2(lw_b - lw_s) o (G_e v_s) + sum_{t>s} (dy_t.v_s) r_t o E_ts
//        dv'_s = G_e^T (k_s o exp2(lw_b - lw_s)) + sum_{t>s} A_ts dy_t
//      with E_ts = exp2(lwp_t - lw_s) and A_ts = sum_k r_tk k_sk E_tsk,
//      then the bonus terms, dlogw by a reverse sum over the block's
//      steps, and the block's share of du.  Every exponent is a sum of
//      log-decays over a span of steps, so <= 0: no factor overflows (the
//      forward's note, csrc/rwkv6_scan.cu).  All in float32 FMA: the
//      gradient's sums keep float32's bits (no tensor-core accumulator,
//      whose float32 sums drop the bits below their largest addend).
//   3. du_kernel: the blocks' du shares summed in a fixed order (a CTA
//      per channel and head, each thread's rows in order, then a fixed
//      tree), so two runs give equal bits.
// The tail stops at T: a block's steps past T get w = 1 and r = k = v =
// dy = 0 and change nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int SUB = 16;        // steps per block
constexpr int MAX_K = 64;
constexpr int MAX_V = 64;
constexpr int VS = 16;         // state columns a walk CTA holds
constexpr int PER = 8;         // of which each thread holds 8
constexpr int NST = 4;         // the walks' stages of staged blocks
constexpr int DU_THREADS = 128;
constexpr float W_MIN = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* dy;
  const float* w;
  const float* u;
  const float* s0;  // may be null: zeros
  const float* ds;  // may be null: zeros
  float* states;    // (B, H, nb + 1, K, V): S at the block boundaries
  float* adj;       // (B, H, nb + 1, K, V): G at the block boundaries
  void* dr;         // (B, T, H, K), r's type
  void* dk;
  void* dv;         // (B, T, H, V)
  float* dw;        // (B, T, H, K)
  float* du_part;   // (B, nb, H, K)
  float* du;        // (H, K)
  float* ds0;       // (B, H, K, V), may be null
  int T, H, K, V, nb, vec;
  long long srb, srt;  // strides (elements) of batch and time
  long long skb, skt;
  long long svb, svt;
  long long swb, swt;
  long long sdb, sdt;  // dy's
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr int ld_of(int n) { return round8(n) + 8; }

// Stage rows [0, SUB) of one operand (rows past clen zero): 16-byte
// cp.async when vec, else plain loads and stores (the forward's).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      long long st, int width, int clen,
                                      bool vec, int tid) {
  if (vec) {
    constexpr int PER16 = 16 / sizeof(T);
    const int cpr = width / PER16;
    for (int i = tid; i < SUB * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < clen;
      tc::cp_async16(dst + r * ld + c * PER16,
                     ok ? src + r * st + c * PER16 : src, ok);
    }
  } else {
    for (int i = tid; i < SUB * width; i += THREADS) {
      const int r = i / width, c = i - r * width;
      dst[r * ld + c] = r < clen ? src[r * st + c] : T(0.f);
    }
  }
}

template <typename T>
__host__ __device__ constexpr int walk_stage_bytes(int K) {
  return SUB * ld_of(K) * (int)sizeof(T) + SUB * ld_of(K) * 4 +
         SUB * ld_of(VS) * (int)sizeof(T);
}

// ---------------------------------------------------------------- walks
// blockIdx.x: direction (x / nvs: 0 the states forward from s0, 1 the
// adjoints backward from ds) and column group (x % nvs); y head; z batch.
// Forward: S <- diag(w_t) S + k_t v_t^T after each step, S saved at
// boundary m + 1 after block m (boundary 0 is s0).  Backward: G <-
// diag(w_t) G + r_t dy_t^T before each step, walking down, G saved at
// boundary m before block m (boundary nb is ds).
template <typename T>
__global__ void __launch_bounds__(THREADS) walk_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nvs = (a.V + VS - 1) / VS;
  const int dir = blockIdx.x / nvs, vg = blockIdx.x - dir * nvs;
  const int h = blockIdx.y, b = blockIdx.z;
  const int K = a.K, V = a.V, Tn = a.T, nb = a.nb;
  const int LD = ld_of(K), LB = ld_of(VS);
  const int SB = walk_stage_bytes<T>(K);
  auto A_of = [&](int s) { return reinterpret_cast<T*>(smem + s * SB); };
  auto W_of = [&](int s) {
    return reinterpret_cast<float*>(A_of(s) + SUB * LD);
  };
  auto B_of = [&](int s) {
    return reinterpret_cast<T*>(W_of(s) + SUB * LD);
  };
  const int tid = threadIdx.x;
  const int kk = tid >> 1, c0 = vg * VS + (tid & 1) * PER;
  const int vw = min(VS, V - vg * VS);  // columns of this group
  const bool row = kk < K;
  const T* A = static_cast<const T*>(dir ? a.r : a.k) +
               b * (dir ? a.srb : a.skb) + (long long)h * K;
  const long long sa = dir ? a.srt : a.skt;
  const T* Bp = static_cast<const T*>(dir ? a.dy : a.v) +
                b * (dir ? a.sdb : a.svb) + (long long)h * V + vg * VS;
  const long long sbt = dir ? a.sdt : a.svt;
  const float* w = a.w + b * a.swb + (long long)h * K;
  const long long KV = (long long)K * V;
  float* out = (dir ? a.adj : a.states) + ((long long)b * a.H + h) *
                                              (nb + 1) * KV;
  const float* init = dir ? a.ds : a.s0;
  const bool vec = a.vec != 0;

  float x[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int c = c0 + e;
    x[e] = init && row && c < V
               ? init[((long long)b * a.H + h) * KV + (long long)kk * V + c]
               : 0.f;
  }
  auto save = [&](int m) {
    if (!row) return;
    float* o = out + m * KV + (long long)kk * V;
#pragma unroll
    for (int e = 0; e < PER; ++e)
      if (c0 + e < V) o[c0 + e] = x[e];
  };
  save(dir ? nb : 0);

  auto load = [&](int m, int s) {
    const int t0 = m * SUB, clen = min(SUB, Tn - t0);
    stage<T>(A_of(s), LD, A + t0 * sa, sa, K, clen, vec, tid);
    stage<float>(W_of(s), LD, w + t0 * a.swt, a.swt, K, clen, vec, tid);
    stage<T>(B_of(s), LB, Bp + t0 * sbt, sbt, vw, clen, vec, tid);
  };
  // blocks in the order the walk takes them, NST - 1 ahead of the one it
  // steps through (one commit group each, empty past the last)
  auto block_at = [&](int it) { return dir ? nb - 1 - it : it; };
  for (int it = 0; it < NST - 1; ++it) {
    if (it < nb) load(block_at(it), it);
    tc::cp_async_commit();
  }
  for (int it = 0; it < nb; ++it) {
    const int m = block_at(it), s = it % NST;
    const int clen = min(SUB, Tn - m * SUB);
    tc::cp_async_wait<NST - 2>();
    __syncthreads();  // this block's stage has landed; the last block's
                      // readers of the stage reloaded next are done
    if (it + NST - 1 < nb) load(block_at(it + NST - 1), (it + NST - 1) % NST);
    tc::cp_async_commit();
    const T* As = A_of(s);
    const float* Ws = W_of(s);
    const T* Bs = B_of(s) + (tid & 1) * PER;
    if (row) {
      for (int i = 0; i < clen; ++i) {
        const int t = dir ? clen - 1 - i : i;
        const float wt = fmaxf(Ws[t * LD + kk], W_MIN);
        const float at = to_f(As[t * LD + kk]);
#pragma unroll
        for (int e = 0; e < PER; ++e)
          x[e] = fmaf(wt, x[e], at * to_f(Bs[t * LB + e]));
      }
    }
    save(dir ? m : m + 1);
  }
  if (dir && a.ds0 && row) {
    float* o = a.ds0 + ((long long)b * a.H + h) * KV + (long long)kk * V;
#pragma unroll
    for (int e = 0; e < PER; ++e)
      if (c0 + e < V) o[c0 + e] = x[e];
  }
}

// --------------------------------------------------------------- blocks
// shared memory, in floats: 7 step rows of K (r, k, lw and its low
// part, kd, dr', dk'), 2 of V (v, dy), S_a and G_e (K rows of V), the
// 16 x 17 tiles of dy_t.v_s and A_ts, and per channel Q_e and u, per
// step the bonus r.(u o k).  Every row has an odd length, so that threads
// reading one column of consecutive rows hit distinct banks; 73.5 KB at
// K = V = 64, three CTAs an SM
__host__ __device__ constexpr int odd(int n) { return n | 1; }
__host__ __device__ constexpr int block_floats(int K, int V) {
  return 7 * SUB * odd(K) + 2 * SUB * odd(V) + 2 * K * odd(V) +
         2 * SUB * (SUB + 1) + 2 * MAX_K + SUB;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) block_kernel(Args a) {
  extern __shared__ __align__(16) float fsm[];
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int K = a.K, V = a.V, Tn = a.T, H = a.H, nb = a.nb;
  const int LK = odd(K), LV = odd(V);
  float* R = fsm;
  float* Kc = R + SUB * LK;
  float* LW = Kc + SUB * LK;
  float* LWL = LW + SUB * LK;      // lw = LW + LWL exactly (see the scan)
  float* KD = LWL + SUB * LK;
  float* DR = KD + SUB * LK;
  float* DK = DR + SUB * LK;
  float* Vc = DK + SUB * LK;
  float* DY = Vc + SUB * LV;
  float* SA = DY + SUB * LV;
  float* GE = SA + K * LV;
  float* DM = GE + K * LV;     // DM[t][s] = dy_t . v_s, s <= t
  float* AM = DM + SUB * (SUB + 1);  // AM[t][s] = A_ts, s < t
  float* QE = AM + SUB * (SUB + 1);
  float* US = QE + MAX_K;
  float* BON = US + MAX_K;

  const int tid = threadIdx.x;
  const int t0 = j * SUB, clen = min(SUB, Tn - t0);
  const T* r = static_cast<const T*>(a.r) + b * a.srb + t0 * a.srt +
               (long long)h * K;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + t0 * a.skt +
               (long long)h * K;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + t0 * a.svt +
               (long long)h * V;
  const T* dy = static_cast<const T*>(a.dy) + b * a.sdb + t0 * a.sdt +
                (long long)h * V;
  const float* w = a.w + b * a.swb + t0 * a.swt + (long long)h * K;
  const long long KV = (long long)K * V;
  const long long base = ((long long)b * H + h) * (nb + 1) * KV;
  const float* sa = a.states + base + j * KV;
  const float* se = a.states + base + (j + 1) * KV;
  const float* ge = a.adj + base + (j + 1) * KV;

  // ---- load: S_a and G_e by 4-byte cp.async (all in flight at once),
  // the block's rows through registers in one batch (steps past clen read
  // as w = 1, log-decay 0, and r = k = v = dy = 0), and this thread's half
  // row of S_e for Q_e
  for (int i = tid; i < K * V; i += THREADS) {
    const int kr = i / V, c = i - kr * V;
    tc::cp_async4(SA + kr * LV + c, sa + i);
    tc::cp_async4(GE + kr * LV + c, ge + i);
  }
  tc::cp_async_commit();
  {
    constexpr int NR = SUB * MAX_K / THREADS, NC = SUB * MAX_V / THREADS;
    float xr[NR], xk[NR], xw[NR], xv[NC], xd[NC];
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      const int i = tid + e * THREADS, t = i / K, c = i - t * K;
      const bool ok = i < SUB * K && t < clen;
      xr[e] = ok ? to_f(r[t * a.srt + c]) : 0.f;
      xk[e] = ok ? to_f(k[t * a.skt + c]) : 0.f;
      xw[e] = ok ? w[t * a.swt + c] : 1.f;
    }
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int i = tid + e * THREADS, t = i / V, c = i - t * V;
      const bool ok = i < SUB * V && t < clen;
      xv[e] = ok ? to_f(v[t * a.svt + c]) : 0.f;
      xd[e] = ok ? to_f(dy[t * a.sdt + c]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      const int i = tid + e * THREADS, t = i / K, c = i - t * K;
      if (i < SUB * K) {
        R[t * LK + c] = xr[e];
        Kc[t * LK + c] = xk[e];
        LW[t * LK + c] = log2f(fmaxf(xw[e], W_MIN));
      }
    }
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int i = tid + e * THREADS, t = i / V, c = i - t * V;
      if (i < SUB * V) {
        Vc[t * LV + c] = xv[e];
        DY[t * LV + c] = xd[e];
      }
    }
  }
  const int qr = tid >> 1;  // Q_e's row: the half row c = tid % 2, +2, ..
  float xs[MAX_V / 2];
#pragma unroll
  for (int e = 0; e < MAX_V / 2; ++e) {
    const int c = (tid & 1) + 2 * e;
    xs[e] = qr < K && c < V ? se[(long long)qr * V + c] : 0.f;
  }
  for (int i = tid; i < K; i += THREADS) US[i] = a.u[(long long)h * K + i];
  tc::cp_async_wait<0>();
  __syncthreads();

  // ---- the cumulative log2-decays (one channel a thread), dy_t . v_s
  // over s <= t and the bonus r_t . (u o k_t) (the other threads), and
  // Q_e = rowsum(G_e o S_e) (every thread: half a row each).
  //
  // The scan keeps each sum as hi + lo, lo the rounding errors of the
  // adds (TwoSum): a decay between two steps is exp2 of a difference of
  // two sums, and once clamped steps (log2 w = -99.7) enter both, hi
  // alone would keep its bits only to ulp(|hi|) (3e-5 at 300).  hi_t -
  // hi_s is exact whenever the span's decay is not negligible (Sterbenz),
  // so (hi_t - hi_s) + (lo_t - lo_s) holds the span's sum to its own
  // precision.
  if (tid < 64) {
    if (tid < K) {
      float hi = 0.f, lo = 0.f;
      for (int t = 0; t < SUB; ++t) {
        const float l = LW[t * LK + tid], x = hi + l, bv = x - hi;
        lo += (hi - (x - bv)) + (l - bv);
        hi = x;
        LW[t * LK + tid] = hi;
        LWL[t * LK + tid] = lo;
      }
    }
  } else {
    for (int p = tid - 64; p < SUB * (SUB + 1) / 2 + SUB; p += 64) {
      if (p < SUB * (SUB + 1) / 2) {
        int t = 0;
        while ((t + 1) * (t + 2) / 2 <= p) ++t;
        const int s = p - t * (t + 1) / 2;
        float acc = 0.f;
        for (int c = 0; c < V; ++c)
          acc = fmaf(DY[t * LV + c], Vc[s * LV + c], acc);
        DM[t * (SUB + 1) + s] = acc;
      } else {
        const int t = p - SUB * (SUB + 1) / 2;
        float acc = 0.f;
        for (int c = 0; c < K; ++c)
          acc = fmaf(R[t * LK + c] * US[c], Kc[t * LK + c], acc);
        BON[t] = acc;
      }
    }
  }
  {
    float q = 0.f;
    if (qr < K) {
#pragma unroll
      for (int e = 0; e < MAX_V / 2; ++e) {
        const int c = (tid & 1) + 2 * e;
        if (c < V) q = fmaf(GE[qr * LV + c], xs[e], q);
      }
    }
    q += __shfl_xor_sync(FULL, q, 1);
    if (qr < K && (tid & 1) == 0) QE[qr] = q;
  }
  __syncthreads();

  // ---- the diagonal cube, E_ts = exp2(lwp_t - lw_s) for s < t, three
  // ways: dr' (threads 0..63, one channel each, summing over s), dk'
  // (threads 64..127, summing over t) and A_ts (a pair a thread, summing
  // over the channels); kd = k o exp2(lw_b - lw) beside dr'
  if (tid < 64) {
    const int c = tid;
    if (c < K) {
      const float lwb = LW[(SUB - 1) * LK + c];
      const float lwbl = LWL[(SUB - 1) * LK + c];
      DR[c] = 0.f;
      for (int t = 1; t < SUB; ++t) {
        const float lp = LW[(t - 1) * LK + c], lpl = LWL[(t - 1) * LK + c];
        float acc = 0.f;
        for (int s = 0; s < t; ++s)
          acc = fmaf(DM[t * (SUB + 1) + s] * Kc[s * LK + c],
                     exp2f((lp - LW[s * LK + c]) + (lpl - LWL[s * LK + c])),
                     acc);
        DR[t * LK + c] = acc;
      }
      for (int t = 0; t < SUB; ++t)
        KD[t * LK + c] = Kc[t * LK + c] *
                         exp2f((lwb - LW[t * LK + c]) +
                               (lwbl - LWL[t * LK + c]));
    }
  } else {
    const int c = tid - 64;
    if (c < K) {
      DK[(SUB - 1) * LK + c] = 0.f;
      for (int s = 0; s < SUB - 1; ++s) {
        const float ls = LW[s * LK + c], lsl = LWL[s * LK + c];
        float acc = 0.f;
        for (int t = s + 1; t < SUB; ++t)
          acc = fmaf(DM[t * (SUB + 1) + s] * R[t * LK + c],
                     exp2f((LW[(t - 1) * LK + c] - ls) +
                           (LWL[(t - 1) * LK + c] - lsl)),
                     acc);
        DK[s * LK + c] = acc;
      }
    }
  }
  if (tid < SUB * (SUB - 1) / 2) {  // pairs s < t: row t holds t(t-1)/2 ..
    int t = 1;
    while ((t + 1) * t / 2 <= tid) ++t;
    const int s = tid - t * (t - 1) / 2;
    const float* rt = R + t * LK;
    const float* ks = Kc + s * LK;
    const float* lp = LW + (t - 1) * LK;
    const float* ls = LW + s * LK;
    const float* lpl = LWL + (t - 1) * LK;
    const float* lsl = LWL + s * LK;
    float acc = 0.f;
    for (int c = 0; c < K; ++c)
      acc = fmaf(rt[c] * ks[c], exp2f((lp[c] - ls[c]) + (lpl[c] - lsl[c])),
                 acc);
    AM[t * (SUB + 1) + s] = acc;
  }
  __syncthreads();

  // ---- the readouts: dr' += exp2(lwp) o (S_a dy), dk' += exp2(lw_b -
  // lw) o (G_e v) for channel tid % 64 and steps 8 (tid / 64) .. + 7; then
  // dv' = G_e^T kd + A^T dy for column tid % 64 and the same steps; the
  // bonus terms; dr, dk and dv written
  const int tg = (tid >> 6) * 8;
  {
    const int c = tid & 63;
    if (c < K) {
      float ar[8], ak[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ar[i] = ak[i] = 0.f;
      for (int x = 0; x < V; ++x) {
        const float sv = SA[c * LV + x], gv = GE[c * LV + x];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ar[i] = fmaf(sv, DY[(tg + i) * LV + x], ar[i]);
          ak[i] = fmaf(gv, Vc[(tg + i) * LV + x], ak[i]);
        }
      }
      const float lwb = LW[(SUB - 1) * LK + c];
      const float lwbl = LWL[(SUB - 1) * LK + c];
      const float uc = US[c];
      T* dr = static_cast<T*>(a.dr) + (((long long)b * Tn + t0) * H + h) * K;
      T* dk = static_cast<T*>(a.dk) + (((long long)b * Tn + t0) * H + h) * K;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = tg + i;
        const float lp = t > 0 ? LW[(t - 1) * LK + c] + LWL[(t - 1) * LK + c]
                               : 0.f;
        const float drp = fmaf(exp2f(lp), ar[i], DR[t * LK + c]);
        const float dkp = fmaf(exp2f((lwb - LW[t * LK + c]) +
                                     (lwbl - LWL[t * LK + c])),
                               ak[i], DK[t * LK + c]);
        DR[t * LK + c] = drp;
        DK[t * LK + c] = dkp;
        const float cur = DM[t * (SUB + 1) + t];
        if (t < clen) {
          put(dr + (long long)t * H * K + c,
              fmaf(uc * Kc[t * LK + c], cur, drp));
          put(dk + (long long)t * H * K + c,
              fmaf(uc * R[t * LK + c], cur, dkp));
        }
      }
    }
  }
  {
    const int c = tid & 63;
    if (c < V) {
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      for (int x = 0; x < K; ++x) {
        const float gv = GE[x * LV + c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i] = fmaf(KD[(tg + i) * LK + x], gv, acc[i]);
      }
      T* dv = static_cast<T*>(a.dv) + (((long long)b * Tn + t0) * H + h) * V;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = tg + i;
        float x = acc[i];
        for (int tau = t + 1; tau < SUB; ++tau)
          x = fmaf(AM[tau * (SUB + 1) + t], DY[tau * LV + c], x);
        if (t < clen)
          put(dv + (long long)t * H * V + c, fmaf(BON[t], DY[t * LV + c], x));
      }
    }
  }
  __syncthreads();

  // ---- dlogw_j = Q_e + sum_{t>j} r_t o dr'_t - sum_{s>=j} k_s o dk'_s by
  // a reverse walk over the block (threads 0..63), dw = dlogw / w; the
  // block's share of du (threads 64..127)
  if (tid < 64) {
    const int c = tid;
    if (c < K) {
      float acc = QE[c];
      float* dw = a.dw + (((long long)b * Tn + t0) * H + h) * K + c;
      for (int t = SUB - 1; t >= 0; --t) {
        acc = fmaf(-Kc[t * LK + c], DK[t * LK + c], acc);
        if (t < clen) {
          const float wt = w[t * a.swt + c];
          dw[(long long)t * H * K] = wt >= W_MIN ? acc / wt : 0.f;
        }
        acc = fmaf(R[t * LK + c], DR[t * LK + c], acc);
      }
    }
  } else {
    const int c = tid - 64;
    if (c < K) {
      float acc = 0.f;
      for (int t = 0; t < SUB; ++t)
        acc = fmaf(R[t * LK + c] * Kc[t * LK + c], DM[t * (SUB + 1) + t],
                   acc);
      a.du_part[(((long long)b * nb + j) * H + h) * K + c] = acc;
    }
  }
}

// du[h][c] = the blocks' shares, rows (batch, block) in order: thread i
// sums rows i, i + 128, .. in order, then a tree over the threads in a
// fixed pairing, so two runs give equal bits.  Grid (K, H).
__global__ void __launch_bounds__(DU_THREADS) du_kernel(Args a, int batch) {
  __shared__ float part[DU_THREADS];
  const int c = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const long long rows = (long long)batch * a.nb;
  float acc = 0.f;
  for (long long i = tid; i < rows; i += DU_THREADS)
    acc += a.du_part[(i * a.H + h) * a.K + c];
  part[tid] = acc;
  __syncthreads();
  for (int n = DU_THREADS / 2; n > 0; n >>= 1) {
    if (tid < n) part[tid] += part[tid + n];
    __syncthreads();
  }
  if (tid == 0) a.du[(long long)h * a.K + c] = part[0];
}

template <typename T>
int launch(Args a, int batch, cudaStream_t stream) {
  const int item = sizeof(T);
  // 16-byte copies need whole 16-byte rows, strides and base pointers
  a.vec = a.V % VS == 0 && (a.K * item) % 16 == 0 && (VS * item) % 16 == 0 &&
          (a.K * 4) % 16 == 0 && (a.srb * item) % 16 == 0 &&
          (a.srt * item) % 16 == 0 && (a.skb * item) % 16 == 0 &&
          (a.skt * item) % 16 == 0 && (a.svb * item) % 16 == 0 &&
          (a.svt * item) % 16 == 0 && (a.sdb * item) % 16 == 0 &&
          (a.sdt * item) % 16 == 0 && (a.swb * 4) % 16 == 0 &&
          (a.swt * 4) % 16 == 0 &&
          ((uintptr_t)a.r | (uintptr_t)a.k | (uintptr_t)a.v |
           (uintptr_t)a.dy | (uintptr_t)a.w) % 16 == 0;
  const int nvs = (a.V + VS - 1) / VS;
  const size_t walk_smem = NST * (size_t)walk_stage_bytes<T>(a.K);
  if (walk_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&walk_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)walk_smem);
    if (e != cudaSuccess) return (int)e;
  }
  walk_kernel<T><<<dim3(2 * nvs, a.H, batch), THREADS, walk_smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t block_smem = (size_t)block_floats(a.K, a.V) * 4;
  if (block_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(&block_kernel<T>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)block_smem);
    if (e != cudaSuccess) return (int)e;
  }
  block_kernel<T><<<dim3(a.nb, a.H, batch), THREADS, block_smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  du_kernel<<<dim3(a.K, a.H), DU_THREADS, 0, stream>>>(a, batch);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (r, k, v, dy and dr, dk, dv).  Strides are
// in elements; r, k, w have head stride K and v, dy head stride V, each
// with unit feature stride; u, s0, ds and every output are contiguous.
// s0 and ds may be null (zeros), ds0 null (not written).  states and adj
// are scratch of (batch, H, ceil(T / 16) + 1, K, V) floats each, du_part
// of (batch, ceil(T / 16), H, K).  Returns the cudaError_t of the
// launches.
extern "C" int repro_rwkv6_scan_backward(
    int dtype, const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* s0, const void* dy, const float* ds,
    float* states, float* adj, void* dr, void* dk, void* dv, float* dw,
    float* du_part, float* du, float* ds0, int batch, int T, int H, int K,
    int V, long long srb, long long srt, long long skb, long long skt,
    long long svb, long long svt, long long swb, long long swt,
    long long sdb, long long sdt, void* stream) {
  if (batch < 1 || batch > 65535 || T < 1 || H < 1 || H > 65535 || K < 1 ||
      K > MAX_K || V < 1 || V > MAX_V || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{r,  k,  v,  dy, w,  u,  s0,  ds,  states, adj, dr,  dk,  dv,
         dw, du_part, du, ds0, T, H, K, V, (T + SUB - 1) / SUB, 0,
         srb, srt, skb, skt, svb, svt, swb, swt, sdb, sdt};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(a, batch, s)
                    : launch<__nv_bfloat16>(a, batch, s);
}
