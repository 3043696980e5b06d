// RWKV6 WKV scan over r, k, w (B,T,H,K), v (B,T,H,V), the bonus u (H,K)
// and an initial state (B,H,K,V).  r, k and v are float32 or bfloat16;
// the output is written in r's type; w, u and the states are float32.
//
// Replaces: the Pallas TPU kernel rwkv6_scan_pallas / _wkv_kernel in
// src/repro/kernels/rwkv6_scan.py.  Its wrapper transposes r, k, v and w
// to head-major and pads the tail to a whole chunk with w = 1; its grid
// walks (batch, head, chunk) with the K x V state in VMEM scratch.
//
// The chunked form is exact at any chunk length, so this kernel walks
// sub-chunks of 16 steps of its own (`chunk` only shapes the plain
// version).  Per sub-chunk, with lw = cumsum(log max(w, 1e-30)) over its
// steps, lwp_t the same sum over strictly earlier steps and b its last
// step:
//   y_t = (r_t o exp(lwp_t)) . S                                (readout)
//       + sum_{s<t} [sum_k r_tk k_sk exp(lwp_tk - lw_sk)] v_s     (diagonal)
//       + (sum_k r_tk u_k k_tk) v_t                              (bonus)
//   S  <- diag(exp(lw_b)) S + sum_s (k_s o exp(lw_b - lw_s)) v_s^T (update)
// Between two sub-chunks i > j the decay from step s of j to step t of i
// factors at b, the end of j: exp(lwp_t - lw_s) = exp(lwp_t - lw_b) *
// exp(lw_b - lw_s).  lw is a running sum of log-decays, each <= 0, so it
// never rises: lwp_t <= lw_b <= lw_s, and both exponents are <= 0.
// Neither factor can overflow, and where one underflows the true product
// is smaller still.  (The factoring exp(lwp_t) * exp(-lw_s) is another
// matter: its second factor is >= 1 and overflows float32 within a chunk
// once a step's log-decay nears -7.)  The kernel takes the off-diagonal
// blocks through the state: the sub-chunk's own start is the reference
// point of the readout (r o exp(lwp)) and its end b that of the update
// (k o exp(lw_b - lw)), so every sub-chunk before this one reaches y
// through S.  That is the fewest products (the readout and the update,
// 4KV a step, no 16 x 16 attention block between sub-chunks), and only
// the 16 x 16 diagonal blocks exponentiate the cube: 136 pairs x K per
// 16 steps instead of 2,016 x K per 64-step chunk.
//
// What bounds it on an H100: the bytes.  At the model_serve prefill shape
// (B=16, T=512, H=32, K=V=64) the 352 MB of inputs and outputs take 0.105
// ms; the 4.3 GFLOP of readout and update products 0.026 ms as 3xTF32
// (495/3 TF/s); the diagonal cubes' 126 M exponentials (120 pairs x K
// per 16 steps) about 0.03 ms on the SFUs.
//
// What the design does about it: one CTA of 4 warps per (batch, head)
// walks the sub-chunks in order; its 39-52 KB of shared memory and at
// most 128 registers a thread let four CTAs share an SM, so all 512 CTAs
// of the prefill shape are resident at once.  Warp w holds rows
// 16w..16w+15 of the transposed state S^T (V x K) in mma.sync accumulator
// fragments for the whole walk, and computes those rows of y^T:
//   y^T  = S^T q^T      A from the accumulators in place (A's k slots t,
//                       t+4 taken as columns 2t, 2t+1; q read in that order)
//        + v^T att^T    over the causal 16 x 16 block (three 8-step tiles)
//   S^T <- S^T o exp(lw_b) + v^T kd
// all on the tensor cores as mma.sync.m16n8k8 in 3xTF32 (csrc/tc.cuh: each
// float32 operand split into two halves rounded to TF32, about 22 bits);
// a bf16 v is exact in TF32 and drops its cross term.  No second copy of
// the state exists.  The tensor cores' float32 accumulation keeps no bits
// below its largest addend, so each 8-column share of y and each
// sub-chunk's share of the state is summed in fresh accumulators and
// added in float32.  The cumulative log-decays are a 16-lane warp scan
// (__shfl_up_sync) of log2 w, one channel per 16-lane group at a time,
// so each exponential is one exp2f; the diagonal cube gives its 120
// pairs s < t one to a thread over K and its 16 bonus entries two to
// each of the last eight threads.
// The next sub-chunk's r, k, v and w are staged by cp.async (16-byte
// copies where rows and strides allow) while this one computes; they are
// read in place through their batch and time strides, and the tail stops
// at T (its missing steps get w = 1, k = v = 0 and change nothing), so a
// 3-token call does one 16-step sub-chunk.  Rows are padded to
// round8(K) + 8 values so that the fragment loads are free of bank
// conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int SUB = 16;        // steps per sub-chunk
constexpr int MAX_CHUNK = 64;  // the `chunk` argument's range
constexpr int MAX_K = 64;
constexpr int MAX_V = 64;
constexpr int NK = MAX_K / 8;  // column tiles of the state a warp holds
constexpr int LDA = SUB + 4;   // row length of the att tile
constexpr int PAIRS = SUB * (SUB + 1) / 2;  // (t, s) with s <= t: 136

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;  // may be null: start from zeros
  void* y;
  float* s_out;
  int T, H, K, V, vec;
  long long srb, srt;  // r strides (elements) of batch and time
  long long skb, skt;  // k strides
  long long svb, svt;  // v strides
  long long swb, swt;  // w strides
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// four consecutive values as float32 (16-byte or 8-byte aligned)
__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }
// padded row length: 8 values past round8, so rows g = 0..7 of a fragment
// start 8 banks apart (float32) and 16-byte copies stay aligned
__host__ __device__ constexpr int ld_of(int n) { return round8(n) + 8; }

template <typename T>
__host__ __device__ constexpr int stage_bytes(int K, int V) {
  return SUB * (2 * ld_of(K) + ld_of(V)) * (int)sizeof(T) +
         SUB * ld_of(K) * 4;
}
__host__ __device__ constexpr int derived_bytes(int K) {
  return (3 * SUB * ld_of(K) + SUB * LDA + 3 * MAX_K) * 4;
}

// Stage rows [0, SUB) of one operand (rows past clen zero): 16-byte
// cp.async when vec, else plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      long long st, int width, int clen,
                                      bool vec, int tid) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const int cpr = width / PER;
    for (int i = tid; i < SUB * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < clen;
      tc::cp_async16(dst + r * ld + c * PER, ok ? src + r * st + c * PER : src,
                     ok);
    }
  } else {
    for (int i = tid; i < SUB * width; i += THREADS) {
      const int r = i / width, c = i - r * width;
      dst[r * ld + c] = r < clen ? src[r * st + c] : T(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4) wkv_kernel(Args a) {
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;  // exact in TF32
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int K = a.K, V = a.V, Tn = a.T, H = a.H;
  const int LD = ld_of(K), LDV = ld_of(V), K8 = round8(K);
  const int SB = stage_bytes<T>(K, V);
  auto R_of = [&](int s) { return reinterpret_cast<T*>(smem + s * SB); };
  auto K_of = [&](int s) { return R_of(s) + SUB * LD; };
  auto V_of = [&](int s) { return K_of(s) + SUB * LD; };
  auto W_of = [&](int s) {
    return reinterpret_cast<float*>(V_of(s) + SUB * LDV);
  };
  float* Q = reinterpret_cast<float*>(smem + 2 * SB);  // r o exp(lwp)
  float* KD = Q + SUB * LD;                            // k o exp(lw_b - lw)
  float* LW = KD + SUB * LD;                           // inclusive cumsum
  float* ATT = LW + SUB * LD;                          // SUB x LDA
  float* LWB = ATT + SUB * LDA;                        // lw_b per channel
  float* DEC = LWB + MAX_K;                            // exp(lw_b)
  float* US = DEC + MAX_K;                             // u

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const T* r = static_cast<const T*>(a.r) + b * a.srb + (long long)h * K;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + (long long)h * K;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + (long long)h * V;
  const float* w = a.w + b * a.swb + (long long)h * K;
  T* y = static_cast<T*>(a.y) + ((long long)b * Tn * H + h) * V;  // step H*V
  const long long sbase = ((long long)b * H + h) * K * V;
  const bool vec = a.vec != 0;

  // zero everything once: the pads past K and V are read by the products
  // and never written
  for (int i = tid; i < (2 * SB + derived_bytes(K)) / 4; i += THREADS)
    reinterpret_cast<float*>(smem)[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < K; i += THREADS) US[i] = a.u[(long long)h * K + i];

  // this thread's share of the diagonal cube: the 120 pairs s < t, one a
  // thread (row t holds pairs t(t-1)/2 ..), and the 16 bonus entries
  // s = t, two a thread for the last 8 threads
  int pt = 1, ps = 0;
  if (tid < PAIRS - SUB) {
    while ((pt + 1) * pt / 2 <= tid) ++pt;
    ps = tid - pt * (pt - 1) / 2;
  } else {
    pt = 2 * (tid - (PAIRS - SUB));
  }
  const bool vec4 = K % 4 == 0;

  // S^T rows vr0 + g (+8), columns 8j + 2t4 (+1), in accumulator layout
  const int vr0 = 16 * warp;
  const bool rows = vr0 < V;
  float st[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int vv = vr0 + g + (e >> 1) * 8, kk = 8 * j + 2 * t4 + (e & 1);
      st[j][e] = a.s0 && vv < V && kk < K
                     ? a.s0[sbase + (long long)kk * V + vv] : 0.f;
    }

  auto load_sub = [&](int t0, int s) {
    const int clen = min(SUB, Tn - t0);
    stage<T>(R_of(s), LD, r + t0 * a.srt, a.srt, K, clen, vec, tid);
    stage<T>(K_of(s), LD, k + t0 * a.skt, a.skt, K, clen, vec, tid);
    stage<T>(V_of(s), LDV, v + t0 * a.svt, a.svt, V, clen, vec, tid);
    stage<float>(W_of(s), LD, w + t0 * a.swt, a.swt, K, clen, vec, tid);
  };
  load_sub(0, 0);
  tc::cp_async_commit();

  const int nsub = (Tn + SUB - 1) / SUB;
  for (int it = 0; it < nsub; ++it) {
    const int t0 = it * SUB, clen = min(SUB, Tn - t0), s = it & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // this stage has landed; the last sub-chunk's
                      // readers of the other stage and of Q, KD, LW, ATT
                      // are done
    if (it + 1 < nsub) load_sub(t0 + SUB, s ^ 1);
    tc::cp_async_commit();
    const T* Rs = R_of(s);
    const T* Ks = K_of(s);
    const T* Vs = V_of(s);
    const float* Ws = W_of(s);

    // ---- lw: inclusive scan over the 16 steps of log2 of the decays,
    // one channel per 16-lane group at a time; steps past clen take
    // log-decay 0 (w = 1).  In base 2 every exponential below is one
    // exp2f, and every exponent is a sum of log-decays over a span: <= 0
    {
      const int step = tid & 15;
      for (int c0 = 0; c0 < K; c0 += THREADS / 16) {  // the same count
        const int c = c0 + (tid >> 4);                 // in every lane
        float x = step < clen && c < K
                      ? log2f(fmaxf(Ws[step * LD + c], 1e-30f)) : 0.f;
#pragma unroll
        for (int off = 1; off < SUB; off <<= 1) {
          const float o = __shfl_up_sync(FULL, x, off, SUB);
          if (step >= off) x += o;
        }
        if (c < K) {
          LW[step * LD + c] = x;
          if (step == SUB - 1) {
            LWB[c] = x;
            DEC[c] = exp2f(x);
          }
        }
      }
    }
    __syncthreads();

    // ---- q = r o exp(lwp), kd = k o exp(lw_b - lw)
    {
      int t = tid / K, c = tid - (tid / K) * K;
      const int dt = THREADS / K, dc = THREADS - dt * K;
      for (; t < SUB; t += dt, c += dc) {
        if (c >= K) {
          c -= K;
          ++t;
          if (t >= SUB) break;
        }
        const float lw = LW[t * LD + c];
        const float r_ = to_f(Rs[t * LD + c]);
        Q[t * LD + c] = t > 0 ? r_ * exp2f(LW[(t - 1) * LD + c]) : r_;
        KD[t * LD + c] = to_f(Ks[t * LD + c]) * exp2f(LWB[c] - lw);
      }
    }
    // ---- the diagonal cube: att[t][s] = sum_k r_tk k_sk exp(lwp_tk -
    // lw_sk) for s < t (lwp_t = lw_{t-1}), the bonus sum_k r_tk u_k k_tk
    // at s = t
    if (tid < PAIRS - SUB) {
      const T* rt = Rs + pt * LD;
      const T* ks = Ks + ps * LD;
      const float* lp = LW + (pt - 1) * LD;
      const float* ls = LW + ps * LD;
      float acc = 0.f;
      if (vec4) {
#pragma unroll 4
        for (int c = 0; c < K; c += 4) {
          float rv[4], kv[4], pv[4], sv[4];
          ld4(rt + c, rv);
          ld4(ks + c, kv);
          ld4(lp + c, pv);
          ld4(ls + c, sv);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc = fmaf(rv[e] * kv[e], exp2f(pv[e] - sv[e]), acc);
        }
      } else {
        for (int c = 0; c < K; ++c)
          acc = fmaf(to_f(rt[c]) * to_f(ks[c]), exp2f(lp[c] - ls[c]), acc);
      }
      ATT[pt * LDA + ps] = acc;
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = pt + j;
        const T* rt = Rs + t * LD;
        const T* kt = Ks + t * LD;
        float acc = 0.f;
        for (int c = 0; c < K; ++c)
          acc = fmaf(to_f(rt[c]) * US[c], to_f(kt[c]), acc);
        ATT[t * LDA + t] = acc;
      }
    }
    __syncthreads();

    if (rows) {
      // ---- y^T = S^T q^T + v^T att^T: 16 rows of V x 16 steps
      float yv[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) yv[m][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        if (8 * j < K8) {
          uint32_t ab[4], as[4];
          tc::split(st[j][0], ab[0], as[0]);  // k slot t4: column 8j + 2t4
          tc::split(st[j][2], ab[1], as[1]);
          tc::split(st[j][1], ab[2], as[2]);  // k slot t4 + 4: 8j + 2t4 + 1
          tc::split(st[j][3], ab[3], as[3]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float2 qv = *reinterpret_cast<const float2*>(
                Q + (8 * m + g) * LD + 8 * j + 2 * t4);
            uint32_t bb[2], bs[2];
            tc::split(qv.x, bb[0], bs[0]);
            tc::split(qv.y, bb[1], bs[1]);
            // each 8-column share in fresh accumulators, added to y in
            // float32: the tensor cores' accumulation drops bits below the
            // largest addend, which a running y (up to ~50) would make
            // coarse
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            tc::mma_3xtf32(part, ab, as, bb, bs);
#pragma unroll
            for (int e = 0; e < 4; ++e) yv[m][e] += part[e];
          }
        }
      }
      // v^T fragments, shared by att^T and the update: k slot t4 is step
      // 8sb + t4, slot t4 + 4 step 8sb + t4 + 4
      uint32_t vb[2][4], vs[2][4];
#pragma unroll
      for (int sb = 0; sb < 2; ++sb) {
        const T* vp = Vs + (8 * sb + t4) * LDV + vr0 + g;
        tc::split_ld(vp[0], vb[sb][0], vs[sb][0]);
        tc::split_ld(vp[8], vb[sb][1], vs[sb][1]);
        tc::split_ld(vp[4 * LDV], vb[sb][2], vs[sb][2]);
        tc::split_ld(vp[4 * LDV + 8], vb[sb][3], vs[sb][3]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int sb = 0; sb <= m; ++sb) {  // causal: steps 0..7 see s < 8
          const float* ap = ATT + (8 * m + g) * LDA + 8 * sb + t4;
          uint32_t bb[2], bs[2];
          tc::split(ap[0], bb[0], bs[0]);
          tc::split(ap[4], bb[1], bs[1]);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          tc::mma_3xtf32<EX, false>(part, vb[sb], vs[sb], bb, bs);
#pragma unroll
          for (int e = 0; e < 4; ++e) yv[m][e] += part[e];
        }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int step = 8 * m + 2 * t4 + (e & 1);
          const int vv = vr0 + g + (e >> 1) * 8;
          if (step < clen && vv < V)
            put(y + (long long)(t0 + step) * H * V + vv, yv[m][e]);
        }

      // ---- S^T <- S^T o exp(lw_b) + v^T kd: the sub-chunk's share in
      // fresh accumulators, added to the state in float32 (the state
      // itself never passes through the tensor cores' accumulation)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        if (8 * j < K8) {
          float ds[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int sb = 0; sb < 2; ++sb) {
            const float* kp = KD + (8 * sb + t4) * LD + 8 * j + g;
            uint32_t bb[2], bs[2];
            tc::split(kp[0], bb[0], bs[0]);
            tc::split(kp[4 * LD], bb[1], bs[1]);
            tc::mma_3xtf32<EX, false>(ds, vb[sb], vs[sb], bb, bs);
          }
          const float2 d = *reinterpret_cast<const float2*>(DEC + 8 * j + 2 * t4);
          st[j][0] = fmaf(st[j][0], d.x, ds[0]);
          st[j][1] = fmaf(st[j][1], d.y, ds[1]);
          st[j][2] = fmaf(st[j][2], d.x, ds[2]);
          st[j][3] = fmaf(st[j][3], d.y, ds[3]);
        }
      }
    }
  }

  if (rows) {
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int vv = vr0 + g + (e >> 1) * 8, kk = 8 * j + 2 * t4 + (e & 1);
        if (vv < V && kk < K)
          a.s_out[sbase + (long long)kk * V + vv] = st[j][e];
      }
  }
}

template <typename T>
int launch(Args a, int batch, cudaStream_t stream) {
  const size_t smem =
      (size_t)2 * stage_bytes<T>(a.K, a.V) + derived_bytes(a.K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&wkv_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte copies need whole 16-byte rows, strides and base pointers (w
  // is float32 whatever T is)
  const int item = sizeof(T);
  a.vec = (a.K * item) % 16 == 0 && (a.V * item) % 16 == 0 &&
          (a.K * 4) % 16 == 0 && (a.srb * item) % 16 == 0 &&
          (a.srt * item) % 16 == 0 && (a.skb * item) % 16 == 0 &&
          (a.skt * item) % 16 == 0 && (a.svb * item) % 16 == 0 &&
          (a.svt * item) % 16 == 0 && (a.swb * 4) % 16 == 0 &&
          (a.swt * 4) % 16 == 0 &&
          ((uintptr_t)a.r | (uintptr_t)a.k | (uintptr_t)a.v |
           (uintptr_t)a.w) % 16 == 0;
  dim3 grid(a.H, batch);
  wkv_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (r, k, v and y).  Strides are in
// elements; r, k and w have head stride K and v head stride V, each with
// unit feature stride; u, the states and y are contiguous.  s0 may be
// null (a zero initial state).  chunk is checked and not otherwise used:
// the kernel tiles by its own 16-step sub-chunks.  Returns the
// cudaError_t of the launch.
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
  Args a{r, k, v, w, u, s0, y, s_out, T, H, K, V, 0,
         srb, srt, skb, skt, svb, svt, swb, swt};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(a, batch, s)
                    : launch<__nv_bfloat16>(a, batch, s);
}
