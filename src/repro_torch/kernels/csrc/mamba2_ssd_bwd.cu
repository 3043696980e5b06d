// The gradient of the Mamba2 SSD scan (csrc/mamba2_ssd.cu): from x
// (B,T,H,P), dt (B,T,H), A (H,), B/C (B,T,G,N), D (H,), an initial
// state h0 (B,H,P,N) and the cotangents dy of y (B,T,H,P) and dh of the
// final state (B,H,P,N), the gradients dx in x's type, dB and dC in
// B's and C's, and ddt, dA, dD and dh0 in float32.  x, B, C and dy are
// float32 or bfloat16; dt, A, D and the states float32.  D, h0 and dh
// may be null (D: no skip; h0, dh: zeros).
//
// Replaces: no Pallas kernel.  The JAX package differentiates its
// chunked form mamba2_ssd_chunked_jnp (src/repro/kernels/ref.py:316) by
// autodiff off the TPU, and the port recomputed the plain chunked form
// op by op under autograd: a (c, c) decay matrix and an HBM round trip
// for every einsum of every 128-step chunk.
//
// Per block of c steps (la = cumsum(A dt) within it, L_ts = exp(la_t -
// la_s) on s <= t, w_s = exp(la_last - la_s) dt_s, h_in the state
// entering the block, G_out the adjoint of the state leaving it):
//   dx_s = sum_t (C_t.B_s) L_ts dt_s dy_t + w_s G_out B_s + D dy_s
//   dB_s = sum_t (dy_t.x_s) L_ts dt_s C_t + w_s G_out^T x_s
//   dC_t = sum_s (dy_t.x_s) L_ts dt_s B_s + exp(la_t) h_in^T dy_t
//   G_in = exp(la_last) G_out + sum_t exp(la_t) dy_t C_t^T
// dB and dC summed over the heads of a group.  With M_ts = (C_t.B_s)
// L_ts dt_s (dy_t.x_s) and u_s = w_s x_s^T G_out B_s:
//   dla_t = rowsum_t(M) - colsum_t(M) + exp(la_t) dy_t.(h_in C_t) - u_t,
//   and at the block's last step also + exp(la_last)<G_out, h_in> + sum u;
//   da_r = sum_{t>=r} dla_t (within the block), ddt_r = colsum_r(M)/dt_r
//   + u_r/dt_r + A da_r (formed without the division), dD = sum x.dy, and
//   dA = sum dt da regrouped by c_t = sum_{r<=t} dt_r (la = A c):
//   sum_{s<=t} M_ts (c_t - c_s) + sum_t q_t c_t + sum_s u_s (c_last - c_s)
//   + c_last exp(la_last)<G_out, h_in>, q_t = exp(la_t) dy_t.(h_in C_t),
//   each weight a span, small where its term is large (sum dt da weights
//   dla by la itself, up to -100 over a block at strong decays, where
//   dla's terms cancel: 4-15 times further from a float64 reference).
// The chunked form is exact at any block length, so the kernel takes its
// own 64-step blocks whatever the caller's chunk: only rounding differs.
// Every exponent is a sum of A dt over a span of steps, so <= 0 (the
// forward's note): no factor overflows, and exp(-la) is never formed.
//
// What bounds it on an H100: its products.  At zamba2-2.7b's training
// microbatch (B=1, T=4096, H=80, P=N=64, float32) the function needs,
// counted per step as the forward's (2N + 2P + 10NP), 13.5 GFLOP: 0.082
// ms in float32 as 3xTF32 (495/3 TF/s); its 258 MB of x, dy, dx, B, C,
// dB, dC, dt and ddt take 0.077 ms.  In bfloat16 the bytes (130.5 MB,
// 0.039 ms) bound it.
//
// What the design does about it: the sequential part is only the walk
// over block boundaries, elementwise over P x N, and every product runs
// on the tensor cores (mma.sync.m16n8k8 TF32 through csrc/tc.cuh: each
// float32 operand as two TF32 halves, 3xTF32; a bf16 operand is exact in
// TF32 and drops its cross term).  Five launches, no atomics:
//   1. local_kernel, a CTA per (block, head, batch): the block's own
//      share of the state, sum_s w_s x_s B_s^T, and of the adjoint,
//      sum_t exp(la_t) dy_t C_t^T (two P x N products over its steps),
//      and its decay exp(la_last);
//   2. walk_kernel, a thread per (direction, batch, head, state entry):
//      h_in at every boundary walking forward from h0, G_out at every
//      boundary walking backward from dh, in place in two float32
//      (B, H, T/64 + 1, P, N) buffers (170 MB at zamba2's microbatch);
//   3. grad_kernel, a CTA per (block, head, batch), eight warps: the
//      (c, c) matrices C B^T and dy x^T on the causal blocks, scaled by
//      L and dt in their accumulators into shared memory, then dx, the
//      head's shares of dB and dC, ddt and the block's shares of dA and
//      dD; each product has a fresh accumulator over at most 64 terms,
//      its 3xTF32 cross terms one of their own, and a warp's tiles
//      unrolled without a branch between them;
//   4. group_sum_kernel: dB and dC summed over each group's heads in
//      order (a float32 (B, T, H, N) scratch each);
//   5. head_sum_kernel: dA and dD over the blocks and the batch, in order.
// Operands are staged in shared memory as float32 rows padded to 68
// floats, so every fragment load is free of bank conflicts, each thread's
// 16-byte loads all issued before any is stored; about 140 KB for
// grad_kernel, one CTA of eight warps on an SM.  B and C are read by
// group (h / (H/G)), x, B, C and dy through their batch and time strides.
// The tail block stops at T: its missing steps get dt = 0 and x = B = C
// = dy = 0 and change nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int BL = 64;          // steps per block
constexpr int MAX_P = 64;
constexpr int MAX_N = 64;
constexpr int LD = 68;          // padded row of a staged operand, floats
constexpr int THREADS = 256;    // eight warps
constexpr int WALK_THREADS = 256;
constexpr int SUM_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;    // may be null
  const float* h0;   // may be null: zeros
  const void* dy;
  const float* dh;   // may be null: zeros
  float* states;     // (B, H, nb + 1, P, N): h_in at every boundary
  float* adj;        // (B, H, nb + 1, P, N): G at every boundary
  float* decay;      // (B, H, nb): exp(la_last) of every block
  void* dx;          // (B, T, H, P), x's type
  float* ddt;        // (B, T, H)
  float* dB_part;    // (B, T, H, N)
  float* dC_part;    // (B, T, H, N)
  void* dB;          // (B, T, G, N), B's type
  void* dC;
  float* dA_part;    // (B, H, nb)
  float* dD_part;    // (B, H, nb)
  float* dA;         // (H,)
  float* dD;         // (H,), may be null
  float* dh0;        // (B, H, P, N), may be null
  int batch, T, H, P, G, N, nb, vec;
  long long sxb, sxt;  // strides (elements) of batch and time
  long long sbb, sbt;
  long long scb, sct;
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

// The staged operands are 64 x 64 floats: each thread holds QUADS
// quads of 4 columns (quad q of thread i: row (i + THREADS q) / 16,
// columns 4 ((i + THREADS q) % 16) ..  + 3), all loaded before any is
// stored, so a CTA has every load of its staging in flight at once.
constexpr int QUADS = BL * 16 / THREADS;

__device__ __forceinline__ float4 bf16x4(uint2 u) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Columns c..c+3 of row r (zero past `rows` and `width`) as float32: one
// 16-byte (float32) or 8-byte (bf16) load when vec (width a multiple of
// 4, rows and base aligned)
template <typename T>
__device__ __forceinline__ float4 load4(const T* src, long long st, int r,
                                        int c, int width, int rows,
                                        bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= rows || c >= width) return v;
  const T* p = src + r * st + c;
  if (vec) {
    if constexpr (sizeof(T) == 4)
      v = *reinterpret_cast<const float4*>(p);
    else
      v = bf16x4(*reinterpret_cast<const uint2*>(p));
  } else {
    v.x = to_f(p[0]);
    if (c + 1 < width) v.y = to_f(p[1]);
    if (c + 2 < width) v.z = to_f(p[2]);
    if (c + 3 < width) v.w = to_f(p[3]);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void load_quads(float4 (&q)[QUADS], const T* src,
                                           long long st, int width,
                                           int rows, bool vec) {
#pragma unroll
  for (int i = 0; i < QUADS; ++i) {
    const int e = threadIdx.x + THREADS * i;
    q[i] = load4<T>(src, st, e >> 4, (e & 15) << 2, width, rows, vec);
  }
}

__device__ __forceinline__ void store_quads(float* dst,
                                            const float4 (&q)[QUADS]) {
#pragma unroll
  for (int i = 0; i < QUADS; ++i) {
    const int e = threadIdx.x + THREADS * i;
    *reinterpret_cast<float4*>(dst + (e >> 4) * LD + ((e & 15) << 2)) = q[i];
  }
}

template <bool EXACT>
__device__ __forceinline__ void frag(float v, uint32_t& big, uint32_t& small) {
  if constexpr (EXACT) {
    big = tc::exact(v);
    small = 0u;
  } else {
    tc::split(v, big, small);
  }
}

// acc[nt] += A B over k in [k_lo, k_hi) (multiples of 8) for a warp's 16
// rows and its first NT n-tiles of 8 columns: a(r, k) is A's element at
// the warp's row r, b(k, c) B's at the warp's column c.  In 3xTF32 (an
// operand flagged exact, a bf16 value, takes one TF32 half and drops its
// cross term), the two small cross terms summed in an accumulator of
// their own and added at the end: a tile's passes are then two
// independent chains, not one of three dependent products.  NT is a
// constant, so the tiles' loads and products carry no branch between
// them (a branch a tile serialised them on shared-memory latency).
template <bool AEX, bool BEX, int NT, typename FA, typename FB>
__device__ __forceinline__ void mm_tiles(float (&acc)[4][4], FA a, FB b,
                                         int k_lo, int k_hi, int g, int t) {
  constexpr bool SMALL = !(AEX && BEX);
  float sm[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sm[i][e] = 0.f;
#pragma unroll 2
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
    frag<AEX>(a(g, k0 + t), ab[0], as[0]);
    frag<AEX>(a(g + 8, k0 + t), ab[1], as[1]);
    frag<AEX>(a(g, k0 + t + 4), ab[2], as[2]);
    frag<AEX>(a(g + 8, k0 + t + 4), ab[3], as[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      frag<BEX>(b(k0 + t, 8 * nt + g), bb[nt][0], bs[nt][0]);
      frag<BEX>(b(k0 + t + 4, 8 * nt + g), bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (!AEX) tc::mma_tf32(sm[nt], as, bb[nt]);
      if constexpr (!BEX) tc::mma_tf32(sm[nt], ab, bs[nt]);
      tc::mma_tf32(acc[nt], ab, bb[nt]);
    }
  }
  if constexpr (SMALL) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += sm[i][e];
  }
}

// mm_tiles for the warp's first `ntiles` (1..4) n-tiles, chosen once
template <bool AEX, bool BEX, typename FA, typename FB>
__device__ __forceinline__ void mm(float (&acc)[4][4], FA a, FB b, int k_lo,
                                   int k_hi, int ntiles, int g, int t) {
  switch (ntiles) {
    case 4: mm_tiles<AEX, BEX, 4>(acc, a, b, k_lo, k_hi, g, t); break;
    case 3: mm_tiles<AEX, BEX, 3>(acc, a, b, k_lo, k_hi, g, t); break;
    case 2: mm_tiles<AEX, BEX, 2>(acc, a, b, k_lo, k_hi, g, t); break;
    case 1: mm_tiles<AEX, BEX, 1>(acc, a, b, k_lo, k_hi, g, t); break;
    default: break;
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// the n-tiles of 8 columns from c0 that lie below `limit`, at most 4
__device__ __forceinline__ int tiles_below(int limit, int c0) {
  return max(0, min(4, (limit - c0 + 7) / 8));
}

// la (inclusive cumsum of A dt over the block, in order by one thread:
// a sequential sum keeps neighbouring la's consistent, and their
// differences are the decays L; a tree scan measured 2-4 times further
// from a float64 reference in dx and ddt), exp(la_t), exp(la_last -
// la_t), w_t and, where cd is given, c_t = the cumsum of dt (la = A c)
// into shared memory; dt is staged already
__device__ __forceinline__ void decays(const float* dts, float A, float* la,
                                       float* el, float* te, float* wv,
                                       float* cd = nullptr) {
  if (threadIdx.x == 0) {
    float s = 0.f, c = 0.f;
#pragma unroll
    for (int i = 0; i < BL; ++i) {
      s += A * dts[i];
      la[i] = s;
      c += dts[i];
      if (cd) cd[i] = c;
    }
  }
  __syncthreads();
  if (threadIdx.x < BL) {
    const int i = threadIdx.x;
    const float l = la[i], last = la[BL - 1];
    el[i] = expf(l);
    te[i] = expf(last - l);
    wv[i] = te[i] * dts[i];
  }
  __syncthreads();
}

// ------------------------------------------------------------ 1. local
template <typename T>
__global__ void __launch_bounds__(THREADS) local_kernel(Args a) {
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;
  float* DYs = Xs + BL * LD;
  float* Bs = DYs + BL * LD;
  float* Cs = Bs + BL * LD;
  float* dts = Cs + BL * LD;
  float* la = dts + BL;
  float* el = la + BL;
  float* te = el + BL;
  float* wv = te + BL;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = a.H, P = a.P, N = a.N, t0 = j * BL;
  const int clen = min(BL, a.T - t0), gi = h / (H / a.G);
  const long long bh = (long long)b * H + h;
  {
    const bool vec = a.vec != 0;
    float4 qx[QUADS], qd[QUADS], qb[QUADS], qc[QUADS];
    load_quads<T>(qx, static_cast<const T*>(a.x) + b * a.sxb + t0 * a.sxt +
                          (long long)h * P, a.sxt, P, clen, vec);
    load_quads<T>(qd, static_cast<const T*>(a.dy) + b * a.sdb +
                          t0 * a.sdt + (long long)h * P, a.sdt, P, clen, vec);
    load_quads<T>(qb, static_cast<const T*>(a.Bm) + b * a.sbb +
                          t0 * a.sbt + (long long)gi * N, a.sbt, N, clen, vec);
    load_quads<T>(qc, static_cast<const T*>(a.Cm) + b * a.scb +
                          t0 * a.sct + (long long)gi * N, a.sct, N, clen, vec);
    if (threadIdx.x < BL) {
      const int i = threadIdx.x;
      dts[i] = i < clen ? a.dt[((long long)b * a.T + t0 + i) * H + h] : 0.f;
    }
    store_quads(Xs, qx);
    store_quads(DYs, qd);
    store_quads(Bs, qb);
    store_quads(Cs, qc);
  }
  __syncthreads();
  decays(dts, a.A[h], la, el, te, wv);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  const int nt = tiles_below(round8(N), c0);
  if (r0 < round8(P) && nt > 0) {
    const long long PN = (long long)P * N;
    // the state's share: (x diag(w))^T B, rows p, columns n, over steps
    float acc[4][4];
    zero(acc);
    mm<false, EX>(acc,
                  [&](int r, int k) { return Xs[k * LD + r0 + r] * wv[k]; },
                  [&](int k, int c) { return Bs[k * LD + c0 + c]; }, 0, BL,
                  nt, g, t);
    float* hl = a.states + (bh * (a.nb + 1) + j + 1) * PN;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = r0 + g + 8 * (e >> 1), n = c0 + 8 * i + 2 * t + (e & 1);
        if (i < nt && p < P && n < N) hl[p * N + n] = acc[i][e];
      }
    // the adjoint's share: (dy diag(exp(la)))^T C
    zero(acc);
    mm<false, EX>(acc,
                  [&](int r, int k) { return DYs[k * LD + r0 + r] * el[k]; },
                  [&](int k, int c) { return Cs[k * LD + c0 + c]; }, 0, BL,
                  nt, g, t);
    float* gl = a.adj + (bh * (a.nb + 1) + j) * PN;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = r0 + g + 8 * (e >> 1), n = c0 + 8 * i + 2 * t + (e & 1);
        if (i < nt && p < P && n < N) gl[p * N + n] = acc[i][e];
      }
  }
  if (threadIdx.x == 0) a.decay[bh * a.nb + j] = expf(la[BL - 1]);
}

// ------------------------------------------------------------- 2. walk
// blockIdx.y 0: the states, forward from h0; 1: the adjoints, backward
// from dh (then dh0 = the adjoint at boundary 0)
__global__ void __launch_bounds__(WALK_THREADS) walk_kernel(Args a) {
  const long long PN = (long long)a.P * a.N;
  const long long e = (long long)blockIdx.x * WALK_THREADS + threadIdx.x;
  if (e >= (long long)a.batch * a.H * PN) return;
  const long long bh = e / PN, pn = e - bh * PN;
  const int nb = a.nb;
  const float* dec = a.decay + bh * nb;
  if (blockIdx.y == 0) {
    float* s = a.states + bh * (nb + 1) * PN + pn;
    float prev = a.h0 ? a.h0[e] : 0.f;
    s[0] = prev;
#pragma unroll 4
    for (int j = 0; j < nb; ++j) {
      prev = fmaf(dec[j], prev, s[(j + 1) * PN]);
      s[(j + 1) * PN] = prev;
    }
  } else {
    float* s = a.adj + bh * (nb + 1) * PN + pn;
    float prev = a.dh ? a.dh[e] : 0.f;
    s[nb * PN] = prev;
#pragma unroll 4
    for (int j = nb - 1; j >= 0; --j) {
      prev = fmaf(dec[j], prev, s[j * PN]);
      s[j * PN] = prev;
    }
    if (a.dh0) a.dh0[e] = prev;
  }
}

// ------------------------------------------------------------- 3. grad
template <typename T>
__global__ void __launch_bounds__(THREADS) grad_kernel(Args a) {
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;               // x       (steps x P)
  float* DYs = Xs + BL * LD;      // dy      (steps x P)
  float* Bs = DYs + BL * LD;      // B       (steps x N)
  float* Cs = Bs + BL * LD;       // C       (steps x N)
  float* Hs = Cs + BL * LD;       // h_in    (P x N)
  float* Gs = Hs + MAX_P * LD;    // G_out   (P x N)
  float* P1 = Gs + MAX_P * LD;    // (C_t.B_s) L_ts dt_s    (t x s)
  float* P2 = P1 + BL * LD;       // (dy_t.x_s) L_ts dt_s   (t x s)
  float* dts = P2 + BL * LD;
  float* la = dts + BL;
  float* el = la + BL;
  float* te = el + BL;
  float* wv = te + BL;
  float* rowM = wv + BL;          // [2][BL]: rowsum(M), per column half
  float* colS = rowM + 2 * BL;    // [4][BL]: colsum(M / dt), per row block
  float* vpart = colS + 4 * BL;   // [2][BL]: x_s.(G_out B_s)
  float* qpart = vpart + 2 * BL;  // [2][BL]: C_t.(h_in^T dy_t)
  float* cd = qpart + 2 * BL;     // the cumsum of dt: la = A cd
  float* red = cd + BL;           // [3][8]: <G_out, h_in>, x.dy and dA's
                                  // M share, per warp

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = a.H, P = a.P, N = a.N, t0 = j * BL;
  const int P8 = round8(P), N8 = round8(N);
  const int clen = min(BL, a.T - t0), gi = h / (H / a.G);
  const long long bh = (long long)b * H + h, PN = (long long)P * N;
  {
    const bool vec = a.vec != 0;
    float4 qx[QUADS], qd[QUADS], qb[QUADS], qc[QUADS], qh[QUADS], qg[QUADS];
    load_quads<T>(qx, static_cast<const T*>(a.x) + b * a.sxb + t0 * a.sxt +
                          (long long)h * P, a.sxt, P, clen, vec);
    load_quads<T>(qd, static_cast<const T*>(a.dy) + b * a.sdb +
                          t0 * a.sdt + (long long)h * P, a.sdt, P, clen, vec);
    load_quads<T>(qb, static_cast<const T*>(a.Bm) + b * a.sbb +
                          t0 * a.sbt + (long long)gi * N, a.sbt, N, clen, vec);
    load_quads<T>(qc, static_cast<const T*>(a.Cm) + b * a.scb +
                          t0 * a.sct + (long long)gi * N, a.sct, N, clen, vec);
    load_quads<float>(qh, a.states + (bh * (a.nb + 1) + j) * PN, N, N, P,
                      vec);
    load_quads<float>(qg, a.adj + (bh * (a.nb + 1) + j + 1) * PN, N, N, P,
                      vec);
    if (threadIdx.x < BL) {
      const int i = threadIdx.x;
      dts[i] = i < clen ? a.dt[((long long)b * a.T + t0 + i) * H + h] : 0.f;
    }
    store_quads(Xs, qx);
    store_quads(DYs, qd);
    store_quads(Bs, qb);
    store_quads(Cs, qc);
    store_quads(Hs, qh);
    store_quads(Gs, qg);
  }
  __syncthreads();
  const float A = a.A[h];
  decays(dts, A, la, el, te, wv, cd);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, cw = warp >> 2;
  const int r0 = 16 * rw, c0 = 32 * cw;

  // <G_out, h_in> and the block's x.dy, each summed by warps in a fixed
  // tree, then over the warps in order
  {
    float gh = 0.f, xd = 0.f;
    for (int i = threadIdx.x; i < P8 * N8; i += THREADS) {
      const int p = i / N8, n = i - p * N8;
      gh = fmaf(Gs[p * LD + n], Hs[p * LD + n], gh);
    }
    for (int i = threadIdx.x; i < BL * P8; i += THREADS) {
      const int s = i / P8, p = i - s * P8;
      xd = fmaf(Xs[s * LD + p], DYs[s * LD + p], xd);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      gh += __shfl_xor_sync(FULL, gh, o);
      xd += __shfl_xor_sync(FULL, xd, o);
    }
    if (lane == 0) {
      red[warp] = gh;
      red[8 + warp] = xd;
    }
  }

  // ---- C B^T and dy x^T on the causal blocks (s <= t), scaled into P1
  // (by L dt) and P2 (by L dt); M = P1 o dy x^T summed by rows, M / dt
  // by columns
  {
    const int nt = tiles_below(r0 + 16, c0);   // s-tiles with some s <= t
    float cb[4][4], dx[4][4];
    zero(cb);
    zero(dx);
    if (nt > 0) {
      mm<EX, EX>(cb, [&](int r, int k) { return Cs[(r0 + r) * LD + k]; },
                 [&](int k, int c) { return Bs[(c0 + c) * LD + k]; }, 0, N8,
                 nt, g, t);
      mm<EX, EX>(dx, [&](int r, int k) { return DYs[(r0 + r) * LD + k]; },
                 [&](int k, int c) { return Xs[(c0 + c) * LD + k]; }, 0, P8,
                 nt, g, t);
    }
    // dA's share of M: sum M_ts (c_t - c_s), each weight a span of steps
    float rs[2] = {0.f, 0.f}, cs[4][2], dam = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) cs[i][e] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tr = r0 + g + 8 * (e >> 1), sc = c0 + 8 * i + 2 * t + (e & 1);
        float p1 = 0.f, p2 = 0.f;
        if (sc <= tr) {
          const float L = expf(la[tr] - la[sc]);
          const float s = cb[i][e] * L * dx[i][e];   // M_ts / dt_s
          const float m = s * dts[sc];
          p1 = cb[i][e] * L * dts[sc];
          p2 = dx[i][e] * L * dts[sc];
          rs[e >> 1] += m;
          cs[i][e & 1] += s;
          dam = fmaf(m, cd[tr] - cd[sc], dam);
        }
        P1[tr * LD + sc] = p1;
        P2[tr * LD + sc] = p2;
      }
    }
    // rows: over the quad (t); columns: over the rows g of the warp
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rs[e] += __shfl_xor_sync(FULL, rs[e], 1);
      rs[e] += __shfl_xor_sync(FULL, rs[e], 2);
    }
    if (t == 0) {
      rowM[cw * BL + r0 + g] = rs[0];
      rowM[cw * BL + r0 + g + 8] = rs[1];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = cs[i][e];
        v += __shfl_xor_sync(FULL, v, 4);
        v += __shfl_xor_sync(FULL, v, 8);
        v += __shfl_xor_sync(FULL, v, 16);
        if (g == 0) colS[rw * BL + c0 + 8 * i + 2 * t + e] = v;
      }
#pragma unroll
    for (int o = 16; o; o >>= 1) dam += __shfl_xor_sync(FULL, dam, o);
    if (lane == 0) red[16 + warp] = dam;
  }
  __syncthreads();

  const float Dh = a.D ? a.D[h] : 0.f;
  const long long row0 = ((long long)b * a.T + t0) * H + h;   // (b, t0, h)
  // ---- dx: rows s, columns p.  P1^T dy over t >= s, then w_s (G_out B_s)
  {
    const int nt = tiles_below(P8, c0);
    float acc[4][4], gb[4][4];
    zero(acc);
    zero(gb);
    if (nt > 0) {
      mm<false, EX>(acc, [&](int r, int k) { return P1[k * LD + r0 + r]; },
                    [&](int k, int c) { return DYs[k * LD + c0 + c]; }, r0,
                    BL, nt, g, t);
      mm<EX, false>(gb, [&](int r, int k) { return Bs[(r0 + r) * LD + k]; },
                    [&](int k, int c) { return Gs[(c0 + c) * LD + k]; }, 0,
                    N8, nt, g, t);
    }
    float vs[2] = {0.f, 0.f};
    T* dxo = static_cast<T*>(a.dx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = r0 + g + 8 * (e >> 1), p = c0 + 8 * i + 2 * t + (e & 1);
        vs[e >> 1] = fmaf(Xs[s * LD + p], gb[i][e], vs[e >> 1]);
        if (i < nt && s < clen && p < P)
          put(dxo + (row0 + (long long)s * H) * P + p,
              acc[i][e] + wv[s] * gb[i][e] + Dh * DYs[s * LD + p]);
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      vs[e] += __shfl_xor_sync(FULL, vs[e], 1);
      vs[e] += __shfl_xor_sync(FULL, vs[e], 2);
    }
    if (t == 0) {
      vpart[cw * BL + r0 + g] = vs[0];
      vpart[cw * BL + r0 + g + 8] = vs[1];
    }
  }
  const int ntN = tiles_below(N8, c0);
  // ---- the head's share of dB: rows s, columns n.  P2^T C over t >= s,
  // then w_s (G_out^T x_s)
  if (ntN > 0) {
    float acc[4][4], gx[4][4];
    zero(acc);
    zero(gx);
    mm<false, EX>(acc, [&](int r, int k) { return P2[k * LD + r0 + r]; },
                  [&](int k, int c) { return Cs[k * LD + c0 + c]; }, r0, BL,
                  ntN, g, t);
    mm<EX, false>(gx, [&](int r, int k) { return Xs[(r0 + r) * LD + k]; },
                  [&](int k, int c) { return Gs[k * LD + c0 + c]; }, 0, P8,
                  ntN, g, t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = r0 + g + 8 * (e >> 1), n = c0 + 8 * i + 2 * t + (e & 1);
        if (i < ntN && s < clen && n < N)
          a.dB_part[(row0 + (long long)s * H) * N + n] =
              acc[i][e] + wv[s] * gx[i][e];
      }
  }
  // ---- the head's share of dC: rows t, columns n.  P2 B over s <= t,
  // then exp(la_t) (h_in^T dy_t)
  {
    float acc[4][4], hd[4][4];
    zero(acc);
    zero(hd);
    if (ntN > 0) {
      mm<false, EX>(acc, [&](int r, int k) { return P2[(r0 + r) * LD + k]; },
                    [&](int k, int c) { return Bs[k * LD + c0 + c]; }, 0,
                    r0 + 16, ntN, g, t);
      mm<EX, false>(hd, [&](int r, int k) { return DYs[(r0 + r) * LD + k]; },
                    [&](int k, int c) { return Hs[k * LD + c0 + c]; }, 0, P8,
                    ntN, g, t);
    }
    float qs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tr = r0 + g + 8 * (e >> 1), n = c0 + 8 * i + 2 * t + (e & 1);
        qs[e >> 1] = fmaf(Cs[tr * LD + n], hd[i][e], qs[e >> 1]);
        if (i < ntN && tr < clen && n < N)
          a.dC_part[(row0 + (long long)tr * H) * N + n] =
              acc[i][e] + el[tr] * hd[i][e];
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      qs[e] += __shfl_xor_sync(FULL, qs[e], 1);
      qs[e] += __shfl_xor_sync(FULL, qs[e], 2);
    }
    if (t == 0) {
      qpart[cw * BL + r0 + g] = qs[0];
      qpart[cw * BL + r0 + g + 8] = qs[1];
    }
  }
  __syncthreads();

  // ---- dla, da (a reverse sum within the block: a warp scan over pairs
  // of steps), ddt and the block's shares of dA and dD, by warp 0 in a
  // fixed order.  dA = sum dt da regrouped by c (la = A c): the M share
  // above, + sum_t q_t c_t + sum_s u_s (c_last - c_s) + c_last exp(la_last)
  // <G_out, h_in>; sum dt da would weight dla by la itself, where dla's
  // terms cancel
  if (warp == 0) {
    float gh = 0.f, xd = 0.f, dA = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) {
      gh += red[w];
      xd += red[8 + w];
      dA += red[16 + w];
    }
    float dla[2], col[2], v[2], u = 0.f, qu = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e;
      col[e] = colS[i] + colS[BL + i] + colS[2 * BL + i] + colS[3 * BL + i];
      v[e] = te[i] * (vpart[i] + vpart[BL + i]);
      const float q = el[i] * (qpart[i] + qpart[BL + i]), ui = dts[i] * v[e];
      dla[e] = rowM[i] + rowM[BL + i] - dts[i] * col[e] + q - ui;
      u += ui;
      qu = fmaf(q, cd[i], qu);
      qu = fmaf(ui, cd[BL - 1] - cd[i], qu);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      u += __shfl_xor_sync(FULL, u, o);
      qu += __shfl_xor_sync(FULL, qu, o);
    }
    dA += qu + cd[BL - 1] * el[BL - 1] * gh;
    if (lane == 31) dla[1] += el[BL - 1] * gh + u;
    float sc = dla[0] + dla[1];          // summed from the block's end
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(FULL, sc, off);
      if (lane + off < 32) sc += o;
    }
    float after = __shfl_down_sync(FULL, sc, 1);
    if (lane == 31) after = 0.f;
    const float da1 = after + dla[1], da0 = da1 + dla[0];
    const float da[2] = {da0, da1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e;
      if (i < clen) a.ddt[row0 + (long long)i * H] = col[e] + v[e] + A * da[e];
    }
    if (lane == 0) {
      a.dA_part[bh * a.nb + j] = dA;
      a.dD_part[bh * a.nb + j] = xd;
    }
  }
}

// ------------------------------------------------------------- 4, 5. sums
// dB (blockIdx.y 0) and dC (1): each group's heads summed in order
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS) group_sum_kernel(Args a) {
  const int G = a.G, N = a.N, rep = a.H / G;
  const long long e = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (e >= (long long)a.batch * a.T * G * N) return;
  const long long bt = e / ((long long)G * N);
  const int gn = (int)(e - bt * G * N), gi = gn / N, n = gn - gi * N;
  const float* part = (blockIdx.y == 0 ? a.dB_part : a.dC_part) +
                      (bt * a.H + (long long)gi * rep) * N + n;
  float s = 0.f;
  for (int r = 0; r < rep; ++r) s += part[(long long)r * N];
  put(static_cast<T*>(blockIdx.y == 0 ? a.dB : a.dC) + e, s);
}

// dA and dD of each head over the batch and the blocks, in order
__global__ void __launch_bounds__(SUM_THREADS) head_sum_kernel(Args a) {
  const int h = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (h >= a.H) return;
  float sa = 0.f, sd = 0.f;
  for (int b = 0; b < a.batch; ++b)
    for (int j = 0; j < a.nb; ++j) {
      const long long i = ((long long)b * a.H + h) * a.nb + j;
      sa += a.dA_part[i];
      sd += a.dD_part[i];
    }
  a.dA[h] = sa;
  if (a.dD) a.dD[h] = sd;
}

constexpr size_t LOCAL_SMEM = (4 * BL * LD + 5 * BL) * sizeof(float);
constexpr size_t GRAD_SMEM =
    (6 * BL * LD + 2 * MAX_P * LD + 5 * BL + 11 * BL + 24) * sizeof(float);

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&local_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)LOCAL_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(&grad_kernel<T>),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)GRAD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 blocks(a.nb, a.H, a.batch);
  local_kernel<T><<<blocks, THREADS, LOCAL_SMEM, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long entries = (long long)a.batch * a.H * a.P * a.N;
  walk_kernel<<<dim3((unsigned)((entries + WALK_THREADS - 1) / WALK_THREADS),
                     2), WALK_THREADS, 0, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  grad_kernel<T><<<blocks, THREADS, GRAD_SMEM, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long grouped = (long long)a.batch * a.T * a.G * a.N;
  group_sum_kernel<T><<<dim3((unsigned)((grouped + SUM_THREADS - 1) /
                                        SUM_THREADS), 2),
                        SUM_THREADS, 0, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  head_sum_kernel<<<(a.H + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                    stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C, dy, dx, dB, dC).  Strides are in
// elements; x's and dy's head stride is P and B/C's group stride N, each
// with unit feature stride; dt, the states and every output contiguous.
// The scratch buffers are the wrapper's (see Args).  Returns the
// cudaError_t of the launches.
extern "C" int repro_mamba2_ssd_backward(
    int dtype, const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* D, const float* h0, const void* dy,
    const float* dh, float* states, float* adj, float* decay, void* dx,
    float* ddt, float* dB_part, float* dC_part, void* dB, void* dC,
    float* dA_part, float* dD_part, float* dA, float* dD, float* dh0,
    int batch, int T, int H, int P, int G, int N, long long sxb,
    long long sxt, long long sbb, long long sbt, long long scb, long long sct,
    long long sdb, long long sdt, void* stream) {
  if (batch < 1 || batch > 65535 || T < 1 || H < 1 || H > 65535 || G < 1 ||
      H % G != 0 || P < 1 || P > MAX_P || N < 1 || N > MAX_N ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{x,     dt,      A,       Bm,      Cm,      D,       h0,    dy,
         dh,    states,  adj,     decay,   dx,      ddt,     dB_part,
         dC_part, dB,    dC,      dA_part, dD_part, dA,      dD,    dh0,
         batch, T,       H,       P,       G,       N,       (T + BL - 1) / BL,
         0,     sxb,     sxt,     sbb,     sbt,     scb,     sct,   sdb,
         sdt};
  // 16-byte (float32) or 8-byte (bf16) loads of 4 columns need rows of a
  // multiple of 4 values, strides of one and aligned bases
  const int item = dtype == 0 ? 4 : 2;
  a.vec = P % 4 == 0 && N % 4 == 0 && sxb % 4 == 0 && sxt % 4 == 0 &&
          sbb % 4 == 0 && sbt % 4 == 0 && scb % 4 == 0 && sct % 4 == 0 &&
          sdb % 4 == 0 && sdt % 4 == 0 &&
          ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm | (uintptr_t)dy) %
                  (4 * item) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(a, s) : launch<__nv_bfloat16>(a, s);
}

// The launch geometry the wrapper sizes its scratch by and mirrors in
// Python: out[0] the block length BL, out[1] the walk's WALK_THREADS.
extern "C" int repro_mamba2_ssd_backward_geometry(int* out) {
  out[0] = BL;
  out[1] = WALK_THREADS;
  return 0;
}
