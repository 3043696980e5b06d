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
//   j's 16-step sub-block:  dlogw_j = rowsum(G_e o S_e)
//                         + sum_{j<t<=e} r_t o dr'_t - sum_{j<=s<=e} k_s o dk'_s
// The last identity gives the decay's gradient from what each sub-block
// already has: no per-step S_{t-1} o G_t product.
//
// What bounds it on an H100: the bytes.  At rwkv6-1.6b's training
// microbatch (B=2, T=4096, H=32, K=V=64, bf16) the function reads r, k,
// v, dy, w and writes dr, dk, dv, dw (~370 MB, 0.11 ms); its products
// (the readouts S dy, G v, G^T k and the decays' sums, 10KV a step) are
// 10.7 GFLOP.  The sequential part is what a design must keep short.
//
// What the design does about it: the only series is a walk over 64-step
// block boundaries, elementwise over K x V, and every product runs on the
// tensor cores (mma.sync.m16n8k8 TF32 through csrc/tc.cuh: each float32
// operand as two TF32 halves, 3xTF32; a bf16 operand is exact in TF32 and
// drops its cross term; each k-step of 8 summed in a fresh accumulator
// and added in float32, since the tensor cores' float32 accumulation
// keeps no bits below its largest addend).  Every decay exponent spans at
// most one 16-step sub-block, as a difference of the sub-block's
// cumulative log2-decays kept as TwoSum hi + lo pairs, so a decay between
// two steps keeps its bits after clamped steps (log2 w = -99.7); a longer
// span is a product of sub-blocks' decays, each <= 1.  Four launches, no
// atomics, so two runs give equal bits:
//   1. local_kernel, a CTA of 8 warps per (64-step block, head, batch),
//      two an SM: the block's rows staged at once by 16-byte cp.async;
//      the block's own share of the state, dS = sum_s diag(exp2(lw_b -
//      lw_s)) k_s v_s^T, and of the adjoint, dG = sum_t diag(exp2(lwp_t))
//      r_t dy_t^T (lwp over the block's steps before t), each chained
//      from its four 16-step sub-shares ((K x 16) x (16 x V) products) by
//      the sub-blocks' decays, and the block's decay; written in place
//      into the boundary buffers (dS at the block's end, dG at its start)
//      and the decay into du_part;
//   2. walk_kernel, a thread per (direction, batch, head, state entry): S
//      at every boundary walking forward from s0, G at every boundary
//      walking backward from ds, in place in two float32 (B, H, T/64 + 1,
//      K, V) buffers (68 MB each at rwkv6's microbatch); ds0 = G_0;
//   3. grad_kernel, a CTA of 8 warps per (64-step block, head, batch), 199
//      KB of shared memory, one an SM: from S at the block's start and G
//      at its end it first carries G backward over the sub-blocks (G
//      after each kept in shared memory), then walks the sub-blocks
//      forward carrying S; per sub-block, with lw its cumulative
//      log2-decays (lwp over strictly earlier steps, b its last step) and
//      E_ts = exp2(lwp_t - lw_s):
//        dr'_t = exp2(lwp_t) o (S dy_t) + sum_{s<t} (dy_t.v_s) k_s o E_ts
//        dk'_s = exp2(lw_b - lw_s) o (G_e v_s) + sum_{t>s} (dy_t.v_s) r_t o E_ts
//        dv'_s = G_e^T (k_s o exp2(lw_b - lw_s)) + sum_{t>s} A_ts dy_t
//      with A_ts = sum_k r_tk k_sk E_tsk: the readouts, dy.v^T, A^T dy
//      and the state's share on the tensor cores, the decay cube E once
//      per sub-block (120 pairs x K exponentials, four threads a channel)
//      and its three sums in float32 FMA; then the bonus terms, dlogw by
//      a reverse sum over the sub-block's steps from Q_e = rowsum(G_e o
//      S_e) at its end (four threads a channel, joined by a scan), dw =
//      dlogw / w, and the block's share of du.  Its rows are staged as
//      float32 rows padded to 68 floats (fragment loads of row-major
//      operands free of bank conflicts); the G walk's rows all load in
//      the prologue, and each later sub-block's while the one before
//      computes, the loads' registers untouched until the stage is
//      written (a mask applied on the load's result would stall the
//      warp for the whole round trip);
//   4. du_kernel: the blocks' du shares summed in a fixed order (a CTA
//      per channel and head, each thread's rows in order, then a fixed
//      tree).
// The cumulative log2-decays of a sub-block are a scan over four threads
// a channel as its rows are staged; the exponentials are ex2.approx (2
// ulp, as exp2f; below 2^-126 flushed to 0).  r, k, v, dy and w are read
// through their batch and time strides.  The tail stops at T: a
// sub-block's steps past T get w = 1 and r = k = v = dy = 0 and change
// nothing, and sub-blocks wholly past T are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int BL = 64;              // steps per block: boundaries BL apart
constexpr int SUB = 16;             // steps per sub-block
constexpr int NSUB = BL / SUB;      // sub-blocks a block
constexpr int MAX_K = 64;
constexpr int MAX_V = 64;
constexpr int LD = 68;              // padded row of a staged operand, floats
constexpr int LDT = SUB + 4;        // row of a (channel x step) operand
constexpr int LDM = SUB + 1;        // row of the dy . v tile
constexpr int PAIRS = SUB * (SUB - 1) / 2;  // steps s < t of a sub-block
constexpr int LDE = MAX_K + 1;      // row of the decay cube, per pair
constexpr int NOP = 5;              // staged operands: r, k, v, dy, w
constexpr int THREADS = 256;        // eight warps
constexpr int WALK_THREADS = 256;
constexpr int DU_THREADS = 128;
constexpr float W_MIN = 1e-30f;
constexpr float NEG_INF = -__builtin_huge_valf();
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == SUB * MAX_K / 4, "a thread stages one quad of "
              "each operand's sub-block");

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
  float* du_part;   // (B, nb, H, K): each block's decay until the gradient
                    // pass, then the block's share of du
  float* du;        // (H, K)
  float* ds0;       // (B, H, K, V), may be null
  int batch, T, H, K, V, nb;
  int vec;     // quads of 4 values by one 16- or 8-byte load
  int vec16;   // rows by 16-byte copies
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

// n (<= 4) values to p; one 16-byte (float32) or 8-byte (bf16) store when
// vec and n == 4
__device__ __forceinline__ void put4(float* p, const float (&x)[4], int n,
                                     bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    for (int e = 0; e < n; ++e) p[e] = x[e];
  }
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, const float (&x)[4],
                                     int n, bool vec) {
  if (vec && n == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    for (int e = 0; e < n; ++e) put(p + e, x[e]);
  }
}

// This thread's share of a sub-block at step t0 (clen of its steps before
// T) in registers, as loaded: a quad of r, k, v and dy (row threadIdx.x /
// 16, columns 4 (threadIdx.x % 16) ..  + 3; float32 a float4, bf16 four
// values in a uint2) and w of channel threadIdx.x / 4 at steps 4
// (threadIdx.x % 4) ..  + 3.  Every load reads an address inside its
// operand (rows and columns clamped) and nothing reads the registers
// before put_stage, which masks them, so the loads stay in flight while
// the sub-block before computes.
template <typename T>
struct Fetched {
  typename std::conditional<sizeof(T) == 4, float4, uint2>::type q[4];
  float w[4];
  int clen;
};

template <typename T, typename Q>
__device__ __forceinline__ void load_raw(Q& dst, const T* src, long long st,
                                         int r, int c, int width, int rows,
                                         bool vec) {
  const T* p = src + min(r, rows - 1) * st;
  if (vec) {
    dst = *reinterpret_cast<const Q*>(p + (c < width ? c : 0));
  } else {
    T e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = p[min(c + i, width - 1)];
    if constexpr (sizeof(T) == 4) {
      dst = make_float4(e[0], e[1], e[2], e[3]);
    } else {
      __nv_bfloat162 lo, hi;
      lo.x = e[0];
      lo.y = e[1];
      hi.x = e[2];
      hi.y = e[3];
      dst.x = *reinterpret_cast<uint32_t*>(&lo);
      dst.y = *reinterpret_cast<uint32_t*>(&hi);
    }
  }
}

// a fetched quad as float32, zeros where masked
__device__ __forceinline__ float4 widen(const float4& v, bool row_ok, int n) {
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row_ok) {
    if (n > 0) o.x = v.x;
    if (n > 1) o.y = v.y;
    if (n > 2) o.z = v.z;
    if (n > 3) o.w = v.w;
  }
  return o;
}
__device__ __forceinline__ float4 widen(const uint2& u, bool row_ok, int n) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return widen(make_float4(lo.x, lo.y, hi.x, hi.y), row_ok, n);
}

template <typename T>
__device__ __forceinline__ void fetch(Fetched<T>& f, const Args& a, int b,
                                      int h, int t0, int clen) {
  const int row = threadIdx.x >> 4, c = (threadIdx.x & 15) << 2;
  const bool vec = a.vec != 0;
  const long long K = a.K, V = a.V;
  load_raw(f.q[0], static_cast<const T*>(a.r) + b * a.srb + t0 * a.srt + h * K,
           a.srt, row, c, a.K, clen, vec);
  load_raw(f.q[1], static_cast<const T*>(a.k) + b * a.skb + t0 * a.skt + h * K,
           a.skt, row, c, a.K, clen, vec);
  load_raw(f.q[2], static_cast<const T*>(a.v) + b * a.svb + t0 * a.svt + h * V,
           a.svt, row, c, a.V, clen, vec);
  load_raw(f.q[3],
           static_cast<const T*>(a.dy) + b * a.sdb + t0 * a.sdt + h * V,
           a.sdt, row, c, a.V, clen, vec);
  const int wc = threadIdx.x >> 2, s0 = (threadIdx.x & 3) * 4;
  const float* w = a.w + b * a.swb + t0 * a.swt + h * K + min(wc, a.K - 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) f.w[i] = w[min(s0 + i, clen - 1) * a.swt];
  f.clen = clen;
}

// (h, l) += x for a sum kept as hi + lo: TwoSum of the high parts, its
// rounding error added to the low part (with y, another sum's low part)
__device__ __forceinline__ void two_sum(float& h, float& l, float x,
                                        float y = 0.f) {
  const float s = h + x, bv = s - h;
  l += y + ((h - (s - bv)) + (x - bv));
  h = s;
}

// A sub-block's cumulative log2-decays, each channel's 16 steps over four
// threads (channel threadIdx.x / 4, steps 4 (threadIdx.x % 4) ..  + 3,
// whose decays w this thread holds): lw and its low part (where LW is
// given), exp2(lwp_t) (lwp over strictly earlier steps) and exp2(lw_b -
// lw_t) (b the last step) by step, and the sub-block's decay exp2(lw_b) by
// channel.
//
// Each sum is kept as hi + lo, lo the rounding errors of the adds
// (TwoSum): a decay between two steps is exp2 of a difference of two
// sums, and once clamped steps (log2 w = -99.7) enter both, hi alone
// would keep its bits only to ulp(|hi|) (3e-5 at 300).  hi_t - hi_s is
// exact whenever the span's decay is not negligible (Sterbenz), so (hi_t
// - hi_s) + (lo_t - lo_s) holds the span's sum to its own precision.  A
// thread sums its four steps on from the sum of the steps before them,
// which a scan over the channel's four threads gives.  The exponentials
// are ex2.approx (2 ulp, as exp2f; results below 2^-126 flushed to 0).
__device__ __forceinline__ void scan_decays(const float (&w)[4], float* LW,
                                            float* LWL, float* EB, float* EP,
                                            float* DEC) {
  const int wc = threadIdx.x >> 2, qq = threadIdx.x & 3, s0 = qq * 4;
  float x[4], h = 0.f, l = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = log2f(fmaxf(w[i], W_MIN));
    two_sum(h, l, x[i]);
  }
  // the sum over the channel's earlier threads' steps: an inclusive scan
  // over its four threads, then one thread on
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    float ph = __shfl_up_sync(FULL, h, off, 4);
    float pl = __shfl_up_sync(FULL, l, off, 4);
    if (qq >= off) {
      two_sum(ph, pl, h, l);
      h = ph;
      l = pl;
    }
  }
  float ph = __shfl_up_sync(FULL, h, 1, 4), pl = __shfl_up_sync(FULL, l, 1, 4);
  if (qq == 0) ph = pl = 0.f;
  float hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    EP[(s0 + i) * LD + wc] = tc::ex2(ph + pl);
    two_sum(ph, pl, x[i]);
    hi[i] = ph;
    lo[i] = pl;
  }
  const float bh = __shfl_sync(FULL, ph, 3, 4);
  const float bl = __shfl_sync(FULL, pl, 3, 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (LW) {
      LW[(s0 + i) * LD + wc] = hi[i];
      LWL[(s0 + i) * LD + wc] = lo[i];
    }
    EB[(s0 + i) * LD + wc] = tc::ex2((bh - hi[i]) + (bl - lo[i]));
  }
  if (qq == 0) DEC[wc] = tc::ex2(bh + bl);
}

// The fetched sub-block into the stage (r, k, v, dy, w, each SUB rows of
// LD floats; zeros past its steps and columns, w = 1), and its decays
// (scan_decays)
template <typename T>
__device__ __forceinline__ void put_stage(float* st, const Fetched<T>& f,
                                          int K, int V, float* LW, float* LWL,
                                          float* EB, float* EP, float* DEC) {
  const int row = threadIdx.x >> 4, c = (threadIdx.x & 15) << 2;
  const bool row_ok = row < f.clen;
#pragma unroll
  for (int o = 0; o < 4; ++o)
    *reinterpret_cast<float4*>(st + o * SUB * LD + row * LD + c) =
        widen(f.q[o], row_ok, (o < 2 ? K : V) - c);
  const int wc = threadIdx.x >> 2, s0 = (threadIdx.x & 3) * 4;
  float* W = st + 4 * SUB * LD;
  float w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = s0 + i < f.clen && wc < K ? f.w[i] : 1.f;
    W[(s0 + i) * LD + wc] = w[i];
  }
  scan_decays(w, LW, LWL, EB, EP, DEC);
}

// A K x V matrix (row stride V in device memory) in registers, rows
// threadIdx.x / 16 + 16 i, columns 4 (threadIdx.x % 16) ..  + 3 (every
// load inside the matrix); then into shared memory rows of LD, zeros past
// K and V
__device__ __forceinline__ void load_kv(float4 (&x)[MAX_K / 16],
                                        const float* src, int K, int V) {
  const bool vec = V % 4 == 0;
  const int row = threadIdx.x >> 4, c = (threadIdx.x & 15) << 2;
#pragma unroll
  for (int i = 0; i < MAX_K / 16; ++i)
    load_raw(x[i], src, V, row + 16 * i, c, V, K, vec);
}
__device__ __forceinline__ void store_kv(float* dst,
                                         const float4 (&x)[MAX_K / 16], int K,
                                         int V) {
  const int row = threadIdx.x >> 4, c = (threadIdx.x & 15) << 2;
#pragma unroll
  for (int i = 0; i < MAX_K / 16; ++i)
    *reinterpret_cast<float4*>(dst + (row + 16 * i) * LD + c) =
        widen(x[i], row + 16 * i < K, V - c);
}

// The block's rows of one operand (rows [0, rows) of `width` values from
// src, row stride st) into shared memory rows of LDR values of its type:
// 16-byte cp.async when vec (committed by the caller), else value by
// value; rows past `rows` zero, columns past `width` untouched
constexpr int LDR = 72;
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long st,
                                           int width, int rows, bool vec) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const int cpr = width / PER;
    for (int i = threadIdx.x; i < BL * cpr; i += THREADS) {
      const int r = i / cpr, c = (i - r * cpr) * PER;
      const bool ok = r < rows;
      tc::cp_async16(dst + r * LDR + c, ok ? src + r * st + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BL * width; i += THREADS) {
      const int r = i / width, c = i - r * width;
      dst[r * LDR + c] = r < rows ? src[r * st + c] : T(0.f);
    }
  }
}

template <bool EX>
__device__ __forceinline__ void frag(float v, uint32_t& big, uint32_t& small) {
  if constexpr (EX) {
    big = tc::exact(v);
    small = 0u;
  } else {
    tc::split(v, big, small);
  }
}

// acc[nt] += A B over NKS k-steps of 8 for a warp's 16 rows and its NT
// n-tiles of 8 columns: a(r, k) is A's element at the warp's row r, b(k,
// n) B's at the warp's column n.  In 3xTF32, the two small cross terms
// first (an operand flagged exact, a bf16 value, takes one TF32 half and
// drops its cross term); each k-step's products in a fresh accumulator,
// added to acc in float32.  Fragment of acc[nt]: element e at row g +
// 8 (e / 2), column 8 nt + 2 t + e % 2.
template <bool AEX, bool BEX, int NT, int NKS, typename FA, typename FB>
__device__ __forceinline__ void mm(float (&acc)[NT][4], FA a, FB b, int g,
                                   int t) {
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int k0 = 8 * ks;
    uint32_t ab[4], as[4];
    frag<AEX>(a(g, k0 + t), ab[0], as[0]);
    frag<AEX>(a(g + 8, k0 + t), ab[1], as[1]);
    frag<AEX>(a(g, k0 + t + 4), ab[2], as[2]);
    frag<AEX>(a(g + 8, k0 + t + 4), ab[3], as[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bb[2], bs[2];
      frag<BEX>(b(k0 + t, 8 * nt + g), bb[0], bs[0]);
      frag<BEX>(b(k0 + t + 4, 8 * nt + g), bb[1], bs[1]);
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (!AEX) tc::mma_tf32(p, as, bb);
      if constexpr (!BEX) tc::mma_tf32(p, ab, bs);
      tc::mma_tf32(p, ab, bb);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += p[e];
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// ------------------------------------------------------------ 1. local
// shared memory: r, k, v and dy of the block's 64 steps as loaded, in
// rows of LDR values of their type, w in rows of LDR floats, exp2(lw_b -
// lw) and exp2(lwp) of a sub-block by step and its decay by channel
template <typename T>
constexpr int local_bytes() {
  return 4 * BL * LDR * (int)sizeof(T) +
         (BL * LDR + 2 * SUB * LD + MAX_K) * (int)sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) local_kernel(Args a) {
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char lsm[];
  T* R = reinterpret_cast<T*>(lsm);
  T* KC = R + BL * LDR;
  T* VC = KC + BL * LDR;
  T* DY = VC + BL * LDR;
  float* W = reinterpret_cast<float*>(DY + BL * LDR);
  float* EB = W + BL * LDR;
  float* EP = EB + SUB * LD;
  float* DEC = EP + SUB * LD;

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = j * BL, blen = min(BL, a.T - t0);
  const int nsub = (blen + SUB - 1) / SUB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);  // the warp's tile
  const long long K = a.K, V = a.V;

  // the block's rows, all in flight at once (columns past K and V are
  // read only into rows and columns of the shares that are not written)
  const bool vec = a.vec16 != 0;
  stage_rows<T>(R, static_cast<const T*>(a.r) + b * a.srb + t0 * a.srt + h * K,
                a.srt, a.K, blen, vec);
  stage_rows<T>(KC, static_cast<const T*>(a.k) + b * a.skb + t0 * a.skt + h * K,
                a.skt, a.K, blen, vec);
  stage_rows<T>(VC, static_cast<const T*>(a.v) + b * a.svb + t0 * a.svt + h * V,
                a.svt, a.V, blen, vec);
  stage_rows<T>(DY,
                static_cast<const T*>(a.dy) + b * a.sdb + t0 * a.sdt + h * V,
                a.sdt, a.V, blen, vec);
  stage_rows<float>(W, a.w + b * a.swb + t0 * a.swt + h * K, a.swt, a.K, blen,
                    vec);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  float dS[4][4], dG[4][4];
  zero(dS);
  zero(dG);
  // the decay from the block's start to the sub-block's, rows r0 + g and
  // r0 + g + 8 (and for thread c < K, channel c's whole block)
  float pd[2] = {1.f, 1.f}, dec = 1.f;
  for (int m = 0; m < nsub; ++m) {
    const int clen = min(SUB, blen - SUB * m), base = SUB * m;
    {
      const int wc = tid >> 2, s0 = (tid & 3) * 4;
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = s0 + i < clen && wc < a.K ? W[(base + s0 + i) * LDR + wc] : 1.f;
      scan_decays(w, nullptr, nullptr, EB, EP, DEC);
    }
    __syncthreads();
    if (tid < MAX_K) dec *= DEC[tid];
    // the sub-shares: (k o exp2(lw_b - lw))^T v and (r o exp2(lwp))^T dy
    float sm[4][4], gm[4][4];
    zero(sm);
    zero(gm);
    mm<false, EX, 4, 2>(
        sm,
        [&](int rr, int kk) {
          return to_f(KC[(base + kk) * LDR + r0 + rr]) * EB[kk * LD + r0 + rr];
        },
        [&](int kk, int n) { return to_f(VC[(base + kk) * LDR + c0 + n]); },
        g, t);
    mm<false, EX, 4, 2>(
        gm,
        [&](int rr, int kk) {
          return to_f(R[(base + kk) * LDR + r0 + rr]) * EP[kk * LD + r0 + rr];
        },
        [&](int kk, int n) { return to_f(DY[(base + kk) * LDR + c0 + n]); },
        g, t);
    const float d[2] = {DEC[r0 + g], DEC[r0 + g + 8]};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dS[i][e] = fmaf(d[e >> 1], dS[i][e], sm[i][e]);
        dG[i][e] = fmaf(pd[e >> 1], gm[i][e], dG[i][e]);
      }
    pd[0] *= d[0];
    pd[1] *= d[1];
    __syncthreads();  // the decays' readers are done before the next scan
  }
  const long long KV = K * V, bh = (long long)b * a.H + h;
  float* so = a.states + (bh * (a.nb + 1) + j + 1) * KV;
  float* go = a.adj + (bh * (a.nb + 1) + j) * KV;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = r0 + g + 8 * (e >> 1), v = c0 + 8 * i + 2 * t + (e & 1);
      if (kk < a.K && v < a.V) {
        so[kk * a.V + v] = dS[i][e];
        go[kk * a.V + v] = dG[i][e];
      }
    }
  if (tid < a.K)
    a.du_part[(((long long)b * a.nb + j) * a.H + h) * a.K + tid] = dec;
}

// ------------------------------------------------------------- 2. walk
// blockIdx.y 0: the states, forward from s0; 1: the adjoints, backward
// from ds (then ds0 = the adjoint at boundary 0).  The block shares are
// in place; each block's decay is in du_part.
__global__ void __launch_bounds__(WALK_THREADS) walk_kernel(Args a) {
  const long long KV = (long long)a.K * a.V;
  const long long e = (long long)blockIdx.x * WALK_THREADS + threadIdx.x;
  if (e >= (long long)a.batch * a.H * KV) return;
  const long long bh = e / KV, kv = e - bh * KV;
  const int b = (int)(bh / a.H), h = (int)(bh - (long long)b * a.H);
  const int nb = a.nb, kk = (int)(kv / a.V);
  const long long step = (long long)a.H * a.K;  // from one block's decay on
  const float* dec = a.du_part + ((long long)b * nb * a.H + h) * a.K + kk;
  if (blockIdx.y == 0) {
    float* s = a.states + bh * (nb + 1) * KV + kv;
    float prev = a.s0 ? a.s0[e] : 0.f;
    s[0] = prev;
#pragma unroll 4
    for (int j = 0; j < nb; ++j) {
      prev = fmaf(dec[j * step], prev, s[(j + 1) * KV]);
      s[(j + 1) * KV] = prev;
    }
  } else {
    float* s = a.adj + bh * (nb + 1) * KV + kv;
    float prev = a.ds ? a.ds[e] : 0.f;
    s[nb * KV] = prev;
#pragma unroll 4
    for (int j = nb - 1; j >= 0; --j) {
      prev = fmaf(dec[j * step], prev, s[j * KV]);
      s[j * KV] = prev;
    }
    if (a.ds0) a.ds0[e] = prev;
  }
}

// ------------------------------------------------------------- 3. grad
// shared memory, floats: G after each sub-block, S at the sub-block's
// start and end (in turns), the stage, lw and its low part, exp2(lw_b -
// lw) and exp2(lwp), dr', dk', dv', r, k and w kept for the dw walk, the
// decay cube E[pair][channel], dy_t . v_s, A_ts (by s), and per channel
// the decay, u and Q_e, per step the bonus r.(u o k): 199 KB
constexpr int GRAD_FLOATS = (4 + 2) * MAX_K * LD + NOP * SUB * LD +
                            10 * SUB * LD + PAIRS * LDE + SUB * LDM +
                            SUB * LDT + 3 * MAX_K + SUB;

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) grad_kernel(Args a) {
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* GS = smem;                      // slot m: G after sub-block m
  float* SS = GS + 4 * MAX_K * LD;       // two K x V buffers
  float* ST = SS + 2 * MAX_K * LD;
  const float* R = ST;
  const float* KC = R + SUB * LD;
  const float* VC = KC + SUB * LD;
  const float* DY = VC + SUB * LD;
  const float* W = DY + SUB * LD;
  float* LW = ST + NOP * SUB * LD;
  float* LWL = LW + SUB * LD;
  float* EB = LWL + SUB * LD;
  float* EP = EB + SUB * LD;
  float* DR = EP + SUB * LD;
  float* DK = DR + SUB * LD;
  float* DV = DK + SUB * LD;
  float* XR = DV + SUB * LD;
  float* XK = XR + SUB * LD;
  float* XW = XK + SUB * LD;
  float* E = XW + SUB * LD;
  float* DM = E + PAIRS * LDE;           // DM[t][s] = dy_t . v_s
  float* AT = DM + SUB * LDM;            // AT[s][t] = A_ts, s < t
  float* DEC = AT + SUB * LDT;
  float* US = DEC + MAX_K;
  float* QE = US + MAX_K;
  float* BON = QE + MAX_K;

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int K = a.K, V = a.V, H = a.H, Tn = a.T, nb = a.nb;
  const int t0 = j * BL, blen = min(BL, Tn - t0);
  const int nsub = (blen + SUB - 1) / SUB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long KV = (long long)K * V, bh = (long long)b * H + h;
  const bool ovec = K % 4 == 0 && V % 4 == 0;

  // the G walk takes sub-blocks nsub - 1 .. 1, then the gradients 0 ..
  // nsub - 1.  The prologue loads the walk's rows and the first gradient
  // visit's (fw[i]: sub-block nsub - 1 - i) with S and G, every load in
  // flight before any is stored; each later visit's rows load while the
  // one before computes
  Fetched<T> fw[NSUB];
  float4 sx[MAX_K / 16], gx[MAX_K / 16];
  load_kv(sx, a.states + (bh * (nb + 1) + j) * KV, K, V);
  load_kv(gx, a.adj + (bh * (nb + 1) + j + 1) * KV, K, V);
#pragma unroll
  for (int i = 0; i < NSUB; ++i)
    if (i < nsub)
      fetch<T>(fw[i], a, b, h, t0 + SUB * (nsub - 1 - i),
               min(SUB, blen - SUB * (nsub - 1 - i)));
  // this thread's pair (pt, ps), ps < pt, for A_ts (threads < PAIRS; row
  // pt holds pairs pt (pt - 1) / 2 ..)
  int pt = 1, ps = 0;
  if (tid < PAIRS) {
    while ((pt + 1) * pt / 2 <= tid) ++pt;
    ps = tid - pt * (pt - 1) / 2;
  }
  for (int i = tid; i < SUB * LDT; i += THREADS) AT[i] = 0.f;  // s >= t
  if (tid < MAX_K) US[tid] = tid < K ? a.u[(long long)h * K + tid] : 0.f;
  store_kv(SS, sx, K, V);
  store_kv(GS + (nsub - 1) * MAX_K * LD, gx, K, V);
  put_stage(ST, fw[0], K, V, LW, LWL, EB, EP, DEC);
  __syncthreads();

  // ---- the G walk: G before sub-block m, diag(exp2(lw_b)) G + (r o
  // exp2(lwp))^T dy, into the slot of the sub-block before
#pragma unroll
  for (int i = 0; i < NSUB - 1; ++i) {
    if (i < nsub - 1) {
      const float* G = GS + (nsub - 1 - i) * MAX_K * LD;
      float* Gp = GS + (nsub - 2 - i) * MAX_K * LD;
      const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
      float acc[4][4];
      zero(acc);
      mm<false, EX, 4, 2>(
          acc,
          [&](int rr, int kk) {
            return R[kk * LD + r0 + rr] * EP[kk * LD + r0 + rr];
          },
          [&](int kk, int n) { return DY[kk * LD + c0 + n]; }, g, t);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = r0 + g + 8 * (e >> 1);
          const int v = c0 + 8 * n + 2 * t + (e & 1);
          Gp[kk * LD + v] = fmaf(DEC[kk], G[kk * LD + v], acc[n][e]);
        }
      __syncthreads();
      put_stage(ST, fw[i + 1], K, V, LW, LWL, EB, EP, DEC);
      __syncthreads();
    }
  }

  // ---- the gradients, sub-block by sub-block
  Fetched<T> f;
  int cur = 0;            // which S buffer holds S at the sub-block's start
  float du_acc = 0.f;     // channel tid's share of du over the block
  for (int m = 0; m < nsub; ++m) {
    const int clen = min(SUB, blen - SUB * m);
    if (m + 1 < nsub)
      fetch<T>(f, a, b, h, t0 + SUB * (m + 1), min(SUB, blen - SUB * (m + 1)));
    const float* G = GS + m * MAX_K * LD;    // G at the sub-block's end
    float* S = SS + cur * MAX_K * LD;        // S at the sub-block's start
    float* Sn = SS + (cur ^ 1) * MAX_K * LD; // and at its end

    // ---- 1. dy_t . v_s (warps 0, 1), the bonus r_t . (u o k_t) (warps
    // 2..5)
    if (warp < 2) {
      const int n0 = 8 * warp;
      float acc[1][4];
      zero(acc);
      mm<EX, EX, 1, 8>(
          acc, [&](int rr, int kk) { return DY[rr * LD + kk]; },
          [&](int kk, int n) { return VC[(n0 + n) * LD + kk]; }, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        DM[(g + 8 * (e >> 1)) * LDM + n0 + 2 * t + (e & 1)] = acc[0][e];
    } else if (warp < 6) {
      const int i8 = tid - 64, step = i8 >> 3, part = i8 & 7;
      float acc = 0.f;
#pragma unroll
      for (int x = 0; x < MAX_K / 8; ++x) {
        const int c = part + 8 * x;
        acc = fmaf(R[step * LD + c] * US[c], KC[step * LD + c], acc);
      }
      acc += __shfl_xor_sync(FULL, acc, 1);
      acc += __shfl_xor_sync(FULL, acc, 2);
      acc += __shfl_xor_sync(FULL, acc, 4);
      if (part == 0) BON[step] = acc;
    }
    __syncthreads();

    // ---- 2. the decay cube E_ts = exp2(lwp_t - lw_s), s < t, once, and
    // two of its sums: dr'_t = sum_{s<t} (dy_t.v_s) k_s o E_ts (complete)
    // and dk'_s = sum_{t>s} (dy_t.v_s) r_t o E_ts.  Channel tid / 4; of
    // the steps t, those with t % 4 == tid % 4 + 1; dk' summed over the
    // four threads of a channel in a fixed order
    {
      const int c = tid >> 2, qq = tid & 3;
      float hs[SUB - 1], ls[SUB - 1], ks[SUB - 1], dkp[SUB - 1];
#pragma unroll
      for (int s = 0; s < SUB - 1; ++s) {
        hs[s] = LW[s * LD + c];
        ls[s] = LWL[s * LD + c];
        ks[s] = KC[s * LD + c];
        dkp[s] = 0.f;
      }
#pragma unroll 1
      for (int x = 0; x < SUB / 4; ++x) {
        const int tt = qq + 1 + 4 * x;          // 16: no such step
        const int tl = min(tt, SUB - 1);
        const float lp = LW[(tl - 1) * LD + c], lpl = LWL[(tl - 1) * LD + c];
        const float rt = R[tl * LD + c];
        const int p0 = tt * (tt - 1) / 2;
        float dr = 0.f;
#pragma unroll
        for (int s = 0; s < SUB - 1; ++s) {
          if (s >= 4 * x + 4) break;  // past every step of this round
          // a pair past the step's own masked by exp2(-inf) = 0, not by a
          // branch: the exponential's asm would not be predicated
          const bool on = s < tt && tt < SUB;
          const float ex = tc::ex2(on ? (lp - hs[s]) + (lpl - ls[s]) : NEG_INF);
          const float dm = DM[tl * LDM + s];
          if (on) E[(p0 + s) * LDE + c] = ex;
          dr = fmaf(dm * ks[s], ex, dr);
          dkp[s] = fmaf(dm * rt, ex, dkp[s]);
        }
        if (tt < SUB) DR[tt * LD + c] = dr;
      }
#pragma unroll
      for (int s = 0; s < SUB - 1; ++s) {
        dkp[s] += __shfl_xor_sync(FULL, dkp[s], 1);
        dkp[s] += __shfl_xor_sync(FULL, dkp[s], 2);
      }
      if (qq == 0) {
        DR[c] = 0.f;
#pragma unroll
        for (int s = 0; s < SUB - 1; ++s) DK[s * LD + c] = dkp[s];
        DK[(SUB - 1) * LD + c] = 0.f;
      }
    }
    __syncthreads();

    // ---- 3. A_ts = sum_k r_tk k_sk E_tsk (a pair a thread, warps 0..3,
    // four partial sums); the readouts (warps 4..7, 16 columns each): dr'
    // += exp2(lwp) o (S dy), dk' += exp2(lw_b - lw) o (G v)
    if (warp < 4) {
      if (tid < PAIRS) {
        const float* rt = R + pt * LD;
        const float* ks = KC + ps * LD;
        const float* ep = E + tid * LDE;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < MAX_K; ++c)
          acc[c & 3] = fmaf(rt[c] * ks[c], ep[c], acc[c & 3]);
        AT[ps * LDT + pt] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    } else {
      const int n0 = 16 * (warp - 4);
      float ar[2][4], ak[2][4];
      zero(ar);
      zero(ak);
      mm<EX, false, 2, 8>(
          ar, [&](int rr, int kk) { return DY[rr * LD + kk]; },
          [&](int kk, int n) { return S[(n0 + n) * LD + kk]; }, g, t);
      mm<EX, false, 2, 8>(
          ak, [&](int rr, int kk) { return VC[rr * LD + kk]; },
          [&](int kk, int n) { return G[(n0 + n) * LD + kk]; }, g, t);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = (g + 8 * (e >> 1)) * LD + n0 + 8 * n + 2 * t + (e & 1);
          DR[o] = fmaf(EP[o], ar[n][e], DR[o]);
          DK[o] = fmaf(EB[o], ak[n][e], DK[o]);
        }
    }
    __syncthreads();

    // ---- 4. dv' = G^T kd + A^T dy, kd = k o exp2(lw_b - lw) (8 columns a
    // warp); S at the sub-block's end, diag(exp2(lw_b)) S + kd^T v (a 16 x
    // 32 tile a warp)
    {
      const int n0 = 8 * warp;
      float ag[1][4], aa[1][4];
      zero(ag);
      zero(aa);
      mm<false, false, 1, 8>(
          ag,
          [&](int rr, int kk) { return KC[rr * LD + kk] * EB[rr * LD + kk]; },
          [&](int kk, int n) { return G[kk * LD + n0 + n]; }, g, t);
      mm<false, EX, 1, 2>(
          aa, [&](int rr, int kk) { return AT[rr * LDT + kk]; },
          [&](int kk, int n) { return DY[kk * LD + n0 + n]; }, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        DV[(g + 8 * (e >> 1)) * LD + n0 + 2 * t + (e & 1)] = ag[0][e] + aa[0][e];
      const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
      float acc[4][4];
      zero(acc);
      mm<false, EX, 4, 2>(
          acc,
          [&](int rr, int kk) {
            return KC[kk * LD + r0 + rr] * EB[kk * LD + r0 + rr];
          },
          [&](int kk, int n) { return VC[kk * LD + c0 + n]; }, g, t);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = r0 + g + 8 * (e >> 1);
          const int v = c0 + 8 * n + 2 * t + (e & 1);
          Sn[kk * LD + v] = fmaf(DEC[kk], S[kk * LD + v], acc[n][e]);
        }
    }
    __syncthreads();

    // ---- 5. Q_e = rowsum(G o S) at the sub-block's end (four threads a
    // row); dr, dk and dv with the bonus terms (a quad of one step a
    // thread); r, k, w kept for the dw walk; the block's share of du
    {
      const int kk = tid >> 2, part = tid & 3;
      float qe = 0.f;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int v = part * 16 + x;
        qe = fmaf(G[kk * LD + v], Sn[kk * LD + v], qe);
      }
      qe += __shfl_xor_sync(FULL, qe, 1);
      qe += __shfl_xor_sync(FULL, qe, 2);
      if (part == 0) QE[kk] = qe;
    }
    {
      const int st = tid >> 4, c = (tid & 15) << 2, o = st * LD + c;
      const float cur_dv = DM[st * LDM + st], bon = BON[st];
      if (st < clen) {
        const long long row = ((long long)b * Tn + t0 + SUB * m + st) * H + h;
        float xr[4], xk[4], xv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xr[e] = fmaf(US[c + e] * KC[o + e], cur_dv, DR[o + e]);
          xk[e] = fmaf(US[c + e] * R[o + e], cur_dv, DK[o + e]);
          xv[e] = fmaf(bon, DY[o + e], DV[o + e]);
        }
        if (c < K) {
          put4(static_cast<T*>(a.dr) + row * K + c, xr, min(4, K - c), ovec);
          put4(static_cast<T*>(a.dk) + row * K + c, xk, min(4, K - c), ovec);
        }
        if (c < V)
          put4(static_cast<T*>(a.dv) + row * V + c, xv, min(4, V - c), ovec);
      }
      *reinterpret_cast<float4*>(XR + o) = *reinterpret_cast<const float4*>(R + o);
      *reinterpret_cast<float4*>(XK + o) = *reinterpret_cast<const float4*>(KC + o);
      *reinterpret_cast<float4*>(XW + o) = *reinterpret_cast<const float4*>(W + o);
    }
    if (tid < MAX_K) {
#pragma unroll
      for (int s = 0; s < SUB; ++s)
        du_acc = fmaf(R[s * LD + tid] * KC[s * LD + tid], DM[s * LDM + s],
                      du_acc);
    }
    __syncthreads();

    // ---- 6. dlogw_j = Q_e + sum_{t>j} r_t o dr'_t - sum_{s>=j} k_s o
    // dk'_s, dw = dlogw / w: channel tid / 4, steps 4 (tid % 4) ..  + 3
    // from the sum over the channel's later steps (a scan over its four
    // threads); then the next visit's rows into the stage
    {
      const int c = tid >> 2, qq = tid & 3, s0 = 4 * qq;
      float d = 0.f;
#pragma unroll
      for (int x = 3; x >= 0; --x) {
        const int s = s0 + x;
        d = fmaf(-XK[s * LD + c], DK[s * LD + c], d);
        d = fmaf(XR[s * LD + c], DR[s * LD + c], d);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float o = __shfl_down_sync(FULL, d, off, 4);
        if (qq + off < 4) d += o;
      }
      float acc = __shfl_down_sync(FULL, d, 1, 4);
      acc = QE[c] + (qq == 3 ? 0.f : acc);
      float* dw = a.dw + (((long long)b * Tn + t0 + SUB * m + s0) * H + h) * K + c;
#pragma unroll
      for (int x = 3; x >= 0; --x) {
        const int s = s0 + x;
        acc = fmaf(-XK[s * LD + c], DK[s * LD + c], acc);
        if (s < clen && c < K) {
          const float wt = XW[s * LD + c];
          dw[(long long)x * H * K] = wt >= W_MIN ? __fdividef(acc, wt) : 0.f;
        }
        acc = fmaf(XR[s * LD + c], DR[s * LD + c], acc);
      }
    }
    if (m + 1 < nsub) put_stage(ST, f, K, V, LW, LWL, EB, EP, DEC);
    __syncthreads();
    cur ^= 1;
  }
  if (tid < K) a.du_part[(((long long)b * nb + j) * H + h) * K + tid] = du_acc;
}

// du[h][c] = the blocks' shares, rows (batch, block) in order: thread i
// sums rows i, i + 128, .. in order, then a tree over the threads in a
// fixed pairing, so two runs give equal bits.  Grid (K, H).
__global__ void __launch_bounds__(DU_THREADS) du_kernel(Args a) {
  __shared__ float part[DU_THREADS];
  const int c = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const long long rows = (long long)a.batch * a.nb;
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
int launch(Args a, cudaStream_t stream) {
  const int item = sizeof(T);
  // 16-byte (float32) or 8-byte (bf16) loads of 4 columns need rows of a
  // multiple of 4 values, strides of one and aligned bases (w is float32
  // whatever T is)
  a.vec = a.K % 4 == 0 && a.V % 4 == 0 && a.srb % 4 == 0 && a.srt % 4 == 0 &&
          a.skb % 4 == 0 && a.skt % 4 == 0 && a.svb % 4 == 0 &&
          a.svt % 4 == 0 && a.sdb % 4 == 0 && a.sdt % 4 == 0 &&
          a.swb % 4 == 0 && a.swt % 4 == 0 &&
          ((uintptr_t)a.r | (uintptr_t)a.k | (uintptr_t)a.v |
           (uintptr_t)a.dy) % (4 * item) == 0 &&
          (uintptr_t)a.w % 16 == 0;
  // 16-byte copies of whole rows need rows of a multiple of 16 bytes,
  // strides to match and aligned bases
  a.vec16 = (a.K * item) % 16 == 0 && (a.V * item) % 16 == 0 &&
            a.K % 4 == 0 && (a.srb * item) % 16 == 0 &&
            (a.srt * item) % 16 == 0 && (a.skb * item) % 16 == 0 &&
            (a.skt * item) % 16 == 0 && (a.svb * item) % 16 == 0 &&
            (a.svt * item) % 16 == 0 && (a.sdb * item) % 16 == 0 &&
            (a.sdt * item) % 16 == 0 && a.swb % 4 == 0 && a.swt % 4 == 0 &&
            ((uintptr_t)a.r | (uintptr_t)a.k | (uintptr_t)a.v |
             (uintptr_t)a.dy | (uintptr_t)a.w) % 16 == 0;
  constexpr size_t local_smem = local_bytes<T>();
  constexpr size_t grad_smem = GRAD_FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&local_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)local_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(&grad_kernel<T>),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)grad_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 blocks(a.nb, a.H, a.batch);
  local_kernel<T><<<blocks, THREADS, local_smem, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long entries = (long long)a.batch * a.H * a.K * a.V;
  walk_kernel<<<dim3((unsigned)((entries + WALK_THREADS - 1) / WALK_THREADS),
                     2), WALK_THREADS, 0, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  grad_kernel<T><<<blocks, THREADS, grad_smem, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  du_kernel<<<dim3(a.K, a.H), DU_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (r, k, v, dy and dr, dk, dv).  Strides are
// in elements; r, k, w have head stride K and v, dy head stride V, each
// with unit feature stride; u, s0, ds and every output are contiguous.
// s0 and ds may be null (zeros), ds0 null (not written).  states and adj
// are scratch of (batch, H, ceil(T / 64) + 1, K, V) floats each, du_part
// of (batch, ceil(T / 64), H, K) (the block length and sub-block length
// are what repro_rwkv6_scan_backward_geometry reports).  Returns the
// cudaError_t of the launches.
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
  Args a{r,     k,  v,   dy, w,  u,  s0, ds,
         states, adj, dr, dk, dv, dw, du_part, du,
         ds0,   batch, T, H, K, V, (T + BL - 1) / BL, 0, 0,
         srb,   srt, skb, skt, svb, svt, swb, swt, sdb, sdt};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(a, s) : launch<__nv_bfloat16>(a, s);
}

// The launch geometry the wrapper sizes its scratch by and mirrors in
// Python: out[0] the block length BL, out[1] the sub-block length SUB,
// out[2] the walk's WALK_THREADS.
extern "C" int repro_rwkv6_scan_backward_geometry(int* out) {
  out[0] = BL;
  out[1] = SUB;
  out[2] = WALK_THREADS;
  return 0;
}
