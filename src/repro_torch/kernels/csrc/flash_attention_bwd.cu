// FlashAttention's recomputing backward over q (B,Sq,H,D), k, v
// (B,Sk,Hkv,D), the forward's output out and log-sum-exp lse (B,Sq,H),
// and the output's cotangent dout: dq, dk and dv in the inputs' type.
// Grouped-query heads (q head h reads kv head h / (H/Hkv)), optional
// causal masking at an offset q_offset (query row i sits at position
// q_offset + i), padded tails masked.  float32 or bfloat16 throughout.
//
// Replaces: the JAX package's _bwd (src/repro/kernels/flash_vjp.py:106,
// registered as the custom_vjp's backward at :171), which is jnp outside
// any Pallas kernel; the port's plain version of it is
// repro_torch/kernels/flash_vjp.py's flash_backward (torch.einsum over
// 512 x 1024 blocks, float32), which stays the CPU route.
//
// What bounds it on an H100: the products, 10D a visible (query, key)
// pair and head for the function (S = Q K^T, dP = dO V^T, dV = P^T dO,
// dK = dS^T Q, dQ = dS K), 14D as the two passes below do them.  At
// minicpm-2b's training shape (q (1,4096,36,64) bf16, causal) that is 193
// GFLOP against 152 MB: 0.195 ms at the bf16 tensor-core peak (0.274 ms
// at 14D); at qwen3-0.6b's (q (2,4096,16,128), GQA 16/8) 344 GFLOP, 0.348
// ms in bf16 (0.487 at 14D), 2.08 ms in float32 as 3xTF32.
//
// Two passes, both deterministic (no atomics):
//   1. the dQ pass, one CTA per (128-row q block, head, batch): writes
//      delta = rowsum(dO o O) of its rows (float32, (B,Sq,H), read again
//      by pass 2), then walks the key tiles up to the causal edge,
//      recomputing S = Q K^T and dP = dO V^T, and accumulates dQ += dS K
//      in registers; dQ is written once in q's type;
//   2. the dK/dV pass, one CTA per (128-key block, kv head, batch):
//      holds its K and V rows in shared memory and walks, for each of
//      the G q heads of its kv head in turn, the q tiles that can see the
//      block (from the causal start max(0, k0 - q_offset); every tile
//      when not causal), recomputing S^T = K Q^T and dP^T = V dO^T with
//      keys as rows, and accumulates dV += P^T dO and dK += dS^T Q in
//      registers over the whole walk (the sum over the G heads stays in
//      the CTA); dK and dV are written once.
// FlashAttention-2 computes dQ in pass 2 and adds it into a float32
// buffer by atomicAdd.  The second pass recomputes S and dP (14D
// products a visible pair instead of 10D) but keeps every sum in one
// order (a resumed step reproduces the straight run's bit for bit),
// needs no float32 dQ buffer and no cast after it, and in both passes P
// and dS go from the accumulators to the next product's A operand in
// place: neither is transposed through shared memory.
//
// Both routes share that plan: a fixed tile of R = 128 rows (A: K or Q,
// B: V or dO) and a walk of W-row tiles (C: Q or K, D: dO or V).  X1 = A
// C^T, X2 = B D^T; P = exp2(X1 scale log2e - lse log2e) under the
// forward's finite -1e30 mask (applied only on tiles that cross Sk, Sq or
// the causal edge), dS = P (X2 - delta) scale; then acc_C += dS C (dK or
// dQ) and, in pass 2, acc_D += P D (dV).  A unit of fixed rows (a warp
// or a warpgroup) whose rows all lie past the causal edge of a walk
// tile's real rows (or past Sk or Sq) skips it.
//
// bfloat16 route, on wgmma, fed by TMA from a producer warp.  What bounded
// the mma.sync route it replaced (on an H100: 10.9-11.5% of the bound,
// 3.1-3.7x SDPA's backward): one CTA of eight warps an SM, every operand
// staged by cp.async and read back through ldmatrix, and no warp left to
// keep copies in flight.  Here:
// - a CTA is a producer warpgroup and two consumer warpgroups of 64 fixed
//   rows.  One producer thread issues every copy as TMA boxes of 64
//   columns (fewer at D < 64) written with the 128-byte swizzle (64, 32 at
//   D = 32, 16): the fixed tile once, then a two-stage ring of walk tiles
//   under full and empty mbarriers (full: the bytes landed, and in the
//   dK/dV pass the producer warp's 32 lanes stored the q tile's lse log2e
//   and delta, which lie a head apart in memory and so are no TMA box;
//   empty: all eight consumer warps are done).  The warpgroups never meet
//   at a CTA barrier.
// - X1 and X2 are SS products (m64nW, both operands K-major, one commit
//   group); P and dS are rounded to bf16 pairs straight from the
//   accumulators into the register A operand of RS products (m64nD: dV +=
//   P^T dO, dK += dS^T Q, dQ += dS K) whose B operand (dO, Q or K) is read
//   MN-major, as the forward reads V.  Nothing passes through shared
//   memory but the TMA tiles.  W = 128 at D <= 64, 64 at D 80 and 128.
// - registers: at D = 128 a consumer thread of the dK/dV pass holds dK and
//   dV (64 + 64 floats) and X1, X2 (32 + 32).  setmaxnreg hands them over:
//   384 threads launch at 168 each; the producer warpgroup drops to 24 and
//   the consumers rise to 240.  setmaxnreg acts by warpgroups, so the
//   producer is a whole warpgroup of which warps 9-11 only give up their
//   registers.  Its waits give up instead of trapping
//   (tc::mbar_wait_bounded): a trap in the kernel makes ptxas hold every
//   role to the launch's 168, and the dK/dV pass then spills.  -Xptxas
//   -v shows no spill at any head dim.
// - the grid runs over (batch, head) first and fixed blocks second, in
//   the order of their causal walks' length, heaviest first: the dQ pass
//   from the last q block, the dK/dV pass from the first key block.
// - head dim 80 is padded to 128 columns by TMA's zero fill, as in the
//   forward; 16 and 32 take the 32- and 64-byte swizzles.  Every head dim
//   the wrapper takes runs on wgmma.
// - the elementwise work (an exponential, a difference and two bf16
//   conversions a score) is as long as the products at D 64, so it is
//   kept lean: the exponent is one FFMA, the exponential ex2.approx.ftz
//   (subnormal P, below 2^-126, is 0), the mask a separate instantiation
//   that only tiles crossing an edge run, and dS's scale applied to dK
//   and dQ as they are written (exact where the scale is a power of two,
//   D 16 and 64).
//
// float32 route, on mma.sync (m16n8k8) in 3xTF32 (tc.cuh: each operand
// split into big and small TF32 halves, about 22 bits), as the forward's
// float32 route: eight warps of 16 fixed rows, W = 64 (32 at D = 128 to
// keep the registers under 255 with no spill), double-buffered by 16-byte
// cp.async (lse and delta of a q tile beside it in pass 2); rows padded by
// 4 floats, so every fragment load is free of bank conflicts; an
// accumulator passes to the A operand with its k slots t and t + 4 taken
// as rows 2t and 2t + 1, and the B operand is read in the same order.
// Head dim 80 is taken as it is (84-float rows).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int Sq, Sk, H, Hkv, q_offset, causal;
  float scale;
  long long sqb, sqt;  // q strides (elements) of batch and sequence
  long long skb, skt;  // k
  long long svb, svt;  // v
  long long sob, sot;  // out
  long long sdb, sdt;  // dout
};

// The fragments of one product step (16 rows x KS of k), per type:
// load_a: A of a row-major tile at p (row 0, k 0) with pitch ld;
// load_bn: B of two 8-column slices from a tile stored [n][k] (n rows
//   at p); load_bk: the same from a tile stored [k][n] (k rows at p), in
//   the k order of to_a; to_a: the A operand of k step kk from
//   accumulator slices (8 columns each) of a 16-row product.
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int KS = 8, PAD = 4;
  struct A {
    uint32_t b[4], s[4];
  };
  struct B {
    uint32_t b[2], s[2];
  };
  static __device__ __forceinline__ void load_a(A& a, const float* p, int ld,
                                                int lane) {
    const float* x = p + (lane >> 2) * ld + (lane & 3);
    tc::split(x[0], a.b[0], a.s[0]);
    tc::split(x[8 * ld], a.b[1], a.s[1]);
    tc::split(x[4], a.b[2], a.s[2]);
    tc::split(x[8 * ld + 4], a.b[3], a.s[3]);
  }
  static __device__ __forceinline__ void load_bn(B (&b)[2], const float* p,
                                                 int ld, int lane) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* x = p + (s * 8 + (lane >> 2)) * ld + (lane & 3);
      tc::split(x[0], b[s].b[0], b[s].s[0]);
      tc::split(x[4], b[s].b[1], b[s].s[1]);
    }
  }
  // k slots t and t + 4 are rows 2t and 2t + 1
  static __device__ __forceinline__ void load_bk(B (&b)[2], const float* p,
                                                 int ld, int lane) {
    const float* x = p + 2 * (lane & 3) * ld + (lane >> 2);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      tc::split(x[s * 8], b[s].b[0], b[s].s[0]);
      tc::split(x[ld + s * 8], b[s].b[1], b[s].s[1]);
    }
  }
  // slice kk: column 2t in slot t, column 2t + 1 in slot t + 4
  template <int N>
  static __device__ __forceinline__ void to_a(A& a, const float (&c)[N][4],
                                              int kk) {
    tc::split(c[kk][0], a.b[0], a.s[0]);
    tc::split(c[kk][2], a.b[1], a.s[1]);
    tc::split(c[kk][1], a.b[2], a.s[2]);
    tc::split(c[kk][3], a.b[3], a.s[3]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    tc::mma_3xtf32(d, a.b, a.s, b.b, b.s);
  }
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

template <typename T, int D>
struct Cfg {
  static constexpr int THREADS = 256;                   // eight warps
  static constexpr int R = 128;                         // fixed-tile rows
  static constexpr int W = D == 128 ? 32 : 64;          // walk-tile rows
  static constexpr int LD = D + Mma<T>::PAD;            // staged row pitch
  static constexpr int EPC = 16 / (int)sizeof(T);       // elements a chunk
  static constexpr int C = D / EPC;                     // 16-byte chunks a row
  static constexpr size_t SMEM =
      (size_t)(2 * R + 4 * W) * LD * sizeof(T) + 4 * W * sizeof(float);
};

// Which 16-byte chunk (row, c) of a rows x C-chunk tile the idx-th copy
// moves: eight rows of one chunk per quarter warp.
template <int C>
__device__ __forceinline__ void chunk_of(int idx, int& row, int& c) {
  const int q = idx >> 3;
  c = q % C;
  row = (q / C) * 8 + (idx & 7);
}

// KEYS: the dK/dV pass (fixed rows: 128 keys of a kv head; walk: q
// tiles of its G heads); otherwise the dQ pass (fixed rows: 128 queries
// of a head; walk: key tiles).
template <typename T, int D, bool KEYS>
__global__ void __launch_bounds__(256, 1) fa_bwd(Args a) {
  using M = Mma<T>;
  using Cf = Cfg<T, D>;
  constexpr int R = Cf::R, W = Cf::W, LD = Cf::LD, C = Cf::C, EPC = Cf::EPC;
  constexpr int KS = M::KS;
  constexpr int NW = W / 8;  // score slices of 8 walk rows
  constexpr int ND = D / 8;  // output slices of 8 columns
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ar = reinterpret_cast<T*>(smem);  // R x LD: K | Q
  T* Br = Ar + R * LD;                 // R x LD: V | dO
  T* Cw = Br + R * LD;                 // 2 stages of W x LD: Q | K
  T* Dw = Cw + 2 * W * LD;             // 2 stages of W x LD: dO | V
  float* Ls = reinterpret_cast<float*>(Dw + 2 * W * LD);  // 2 x W lse
  float* Ds = Ls + 2 * W;                                 // 2 x W delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int r0 = warp * 16;  // this warp's rows in the fixed tile
  const float scale2 = a.scale * LOG2E;

  // the fixed tile and the walk
  int row0, nrows, hk, h = 0, tstart = 0, ntile, total;
  if (KEYS) {
    hk = blockIdx.y;
    row0 = blockIdx.x * R;
    nrows = a.Sk;
    const int first = a.causal ? max(0, row0 - a.q_offset) : 0;
    tstart = first / W;
    ntile = first < a.Sq ? (a.Sq + W - 1) / W - tstart : 0;
    total = G * ntile;
  } else {
    h = blockIdx.y;
    hk = h / G;
    row0 = (gridDim.x - 1 - blockIdx.x) * R;  // heaviest causal blocks first
    nrows = a.Sq;
    const int qrows = min(R, a.Sq - row0);
    const int end = a.causal ? min(a.Sk, a.q_offset + row0 + qrows) : a.Sk;
    ntile = (end + W - 1) / W;
    total = ntile;
  }
  const T* q = static_cast<const T*>(a.q) + b * a.sqb;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + (long long)hk * D;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + (long long)hk * D;
  const T* dop = static_cast<const T*>(a.dout) + b * a.sdb;

  {  // the fixed tile, zero past the end
    const T* pa = KEYS ? kp : q + (long long)h * D;
    const T* pb = KEYS ? vp : dop + (long long)h * D;
    const long long sa = KEYS ? a.skt : a.sqt, sb = KEYS ? a.svt : a.sdt;
    for (int i = tid; i < R * C; i += Cf::THREADS) {
      int r, c;
      chunk_of<C>(i, r, c);
      const bool ok = row0 + r < nrows;
      tc::cp_async16(Ar + r * LD + c * EPC,
                     ok ? pa + (row0 + r) * sa + c * EPC : pa, ok);
      tc::cp_async16(Br + r * LD + c * EPC,
                     ok ? pb + (row0 + r) * sb + c * EPC : pb, ok);
    }
  }
  auto load_walk = [&](int it, int st) {
    T* cd = Cw + st * W * LD;
    T* dd = Dw + st * W * LD;
    if (KEYS) {  // q tile of head hk G + it / ntile: Q, dO, lse, delta
      const int hh = hk * G + it / ntile;
      const int i0 = (tstart + it % ntile) * W;
      const T* pc = q + (long long)hh * D;
      const T* pd = dop + (long long)hh * D;
      for (int i = tid; i < W * C; i += Cf::THREADS) {
        int r, c;
        chunk_of<C>(i, r, c);
        const bool ok = i0 + r < a.Sq;
        tc::cp_async16(cd + r * LD + c * EPC,
                       ok ? pc + (i0 + r) * a.sqt + c * EPC : pc, ok);
        tc::cp_async16(dd + r * LD + c * EPC,
                       ok ? pd + (i0 + r) * a.sdt + c * EPC : pd, ok);
      }
      for (int r = tid; r < W; r += Cf::THREADS) {
        const bool ok = i0 + r < a.Sq;
        const long long at = ((long long)b * a.Sq + i0 + r) * a.H + hh;
        tc::cp_async4(Ls + st * W + r, ok ? a.lse + at : a.lse, ok);
        tc::cp_async4(Ds + st * W + r, ok ? a.delta + at : a.delta, ok);
      }
    } else {  // key tile: K, V
      const int k0 = it * W;
      for (int i = tid; i < W * C; i += Cf::THREADS) {
        int r, c;
        chunk_of<C>(i, r, c);
        const bool ok = k0 + r < a.Sk;
        tc::cp_async16(cd + r * LD + c * EPC,
                       ok ? kp + (k0 + r) * a.skt + c * EPC : kp, ok);
        tc::cp_async16(dd + r * LD + c * EPC,
                       ok ? vp + (k0 + r) * a.svt + c * EPC : vp, ok);
      }
    }
  };
  if (total > 0) load_walk(0, 0);
  tc::cp_async_commit();

  // the dQ pass: delta of this warp's rows (written for pass 2) and the
  // rows' log-sum-exp, in base 2; rows g and g + 8 of the warp
  float lse0 = 0.f, lse1 = 0.f, del0 = 0.f, del1 = 0.f;
  if (!KEYS) {
    const T* op = static_cast<const T*>(a.out) + b * a.sob + (long long)h * D;
    const T* dp = dop + (long long)h * D;
#pragma unroll 1
    for (int rr = 0; rr < 16; ++rr) {
      const int i = row0 + r0 + rr;
      float s = 0.f;
      if (i < a.Sq)
        for (int c = lane; c < D; c += 32)
          s += M::to_f(op[i * a.sot + c]) * M::to_f(dp[i * a.sdt + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (rr == g) del0 = s;
      if (rr == g + 8) del1 = s;
      if (lane == 0 && i < a.Sq)
        a.delta[((long long)b * a.Sq + i) * a.H + h] = s;
    }
    const int i0 = row0 + r0 + g, i1 = i0 + 8;
    if (i0 < a.Sq) lse0 = a.lse[((long long)b * a.Sq + i0) * a.H + h] * LOG2E;
    if (i1 < a.Sq) lse1 = a.lse[((long long)b * a.Sq + i1) * a.H + h] * LOG2E;
  }

  float acc_c[ND][4];             // dK | dQ
  float acc_d[KEYS ? ND : 1][4];  // dV
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_c[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < (KEYS ? ND : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_d[n][e] = 0.f;

  const int x0 = row0 + r0;  // this warp's first key | query row
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) load_walk(it + 1, (it + 1) & 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int st = it & 1;
    const T* Ct = Cw + st * W * LD;
    const T* Dt = Dw + st * W * LD;
    // the walk tile's first query row (KEYS) or key (dQ pass)
    const int w0 = KEYS ? (tstart + it % ntile) * W : it * W;
    bool live, masked;
    if (KEYS) {  // keys x0.. against queries w0..
      live = x0 < a.Sk &&
             (!a.causal || x0 <= a.q_offset + min(w0 + W, a.Sq) - 1);
      masked = x0 + 15 >= a.Sk || w0 + W > a.Sq ||
               (a.causal && x0 + 15 > a.q_offset + w0);
    } else {  // queries x0.. against keys w0..
      live = x0 < a.Sq &&
             (!a.causal || w0 <= a.q_offset + min(x0 + 16, a.Sq) - 1);
      masked = x0 + 15 >= a.Sq || w0 + W > a.Sk ||
               (a.causal && w0 + W - 1 > a.q_offset + x0);
    }
    if (live) {
      float x1[NW][4], x2[NW][4];  // S | S^T, then P; dP | dP^T, then dS
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x1[j][e] = x2[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / KS; ++kk) {
        typename M::A fa;
        typename M::B fb[2];
        M::load_a(fa, Ar + r0 * LD + kk * KS, LD, lane);
#pragma unroll
        for (int n2 = 0; n2 < W / 16; ++n2) {
          M::load_bn(fb, Ct + n2 * 16 * LD + kk * KS, LD, lane);
          M::mma(x1[2 * n2], fa, fb[0]);
          M::mma(x1[2 * n2 + 1], fa, fb[1]);
        }
        M::load_a(fa, Br + r0 * LD + kk * KS, LD, lane);
#pragma unroll
        for (int n2 = 0; n2 < W / 16; ++n2) {
          M::load_bn(fb, Dt + n2 * 16 * LD + kk * KS, LD, lane);
          M::mma(x2[2 * n2], fa, fb[0]);
          M::mma(x2[2 * n2 + 1], fa, fb[1]);
        }
      }
      // x1[j][e]: row g (+8 for e >= 2) of the warp, walk row 8j + 2t +
      // (e & 1) of the tile
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = g + (e >> 1) * 8, cl = j * 8 + 2 * t + (e & 1);
          float l2, dl;
          if constexpr (KEYS) {
            l2 = Ls[st * W + cl] * LOG2E;
            dl = Ds[st * W + cl];
          } else {
            l2 = (e >> 1) ? lse1 : lse0;
            dl = (e >> 1) ? del1 : del0;
          }
          float s = x1[j][e] * scale2;
          if (masked) {
            const int key = KEYS ? x0 + rl : w0 + cl;
            const int i = KEYS ? w0 + cl : x0 + rl;
            if (key >= a.Sk || i >= a.Sq || (a.causal && key > a.q_offset + i))
              s = NEG_INF;
          }
          const float p = exp2f(s - l2);
          x1[j][e] = p;
          x2[j][e] = p * (x2[j][e] - dl) * a.scale;
        }
      // acc_C += dS C; acc_D += P D (pass 2)
#pragma unroll
      for (int kk = 0; kk < W / KS; ++kk) {
        typename M::A pa, da;
        typename M::B fb[2];
        M::to_a(da, x2, kk);
        if constexpr (KEYS) M::to_a(pa, x1, kk);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          M::load_bk(fb, Ct + kk * KS * LD + n2 * 16, LD, lane);
          M::mma(acc_c[2 * n2], da, fb[0]);
          M::mma(acc_c[2 * n2 + 1], da, fb[1]);
          if constexpr (KEYS) {
            M::load_bk(fb, Dt + kk * KS * LD + n2 * 16, LD, lane);
            M::mma(acc_d[2 * n2], pa, fb[0]);
            M::mma(acc_d[2 * n2 + 1], pa, fb[1]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copy reuses this stage
  }
  tc::cp_async_wait<0>();

  // write each row once (a walk that was empty writes zeros)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int x = x0 + g + half * 8;
    if (x >= nrows) continue;
    T* oc;
    T* od = nullptr;
    if (KEYS) {
      const long long row = ((long long)b * a.Sk + x) * a.Hkv + hk;
      oc = static_cast<T*>(a.dk) + row * D;
      od = static_cast<T*>(a.dv) + row * D;
    } else {
      const long long row = ((long long)b * a.Sq + x) * a.H + h;
      oc = static_cast<T*>(a.dq) + row * D;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      M::store2(oc + n * 8 + 2 * t, acc_c[n][2 * half], acc_c[n][2 * half + 1]);
      if constexpr (KEYS)
        M::store2(od + n * 8 + 2 * t, acc_d[n][2 * half], acc_d[n][2 * half + 1]);
    }
  }
}

template <typename T, int D, bool KEYS>
int launch_pass(const Args& a, int batch, cudaStream_t stream) {
  using Cf = Cfg<T, D>;
  auto* kernel = fa_bwd<T, D, KEYS>;
  if (Cf::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cf::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(((KEYS ? a.Sk : a.Sq) + Cf::R - 1) / Cf::R, KEYS ? a.Hkv : a.H,
            batch);
  kernel<<<grid, Cf::THREADS, Cf::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// the dQ pass first: it writes delta, which the dK/dV pass reads
template <typename T, int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int e = launch_pass<T, D, false>(a, batch, stream);
  if (e != 0) return e;
  return launch_pass<T, D, true>(a, batch, stream);
}

template <typename T>
int launch_d(int D, const Args& a, int batch, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, batch, s);
    case 32: return launch<T, 32>(a, batch, s);
    case 64: return launch<T, 64>(a, batch, s);
    case 80: return launch<T, 80>(a, batch, s);
    case 128: return launch<T, 128>(a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ bf16 route
template <int D>
struct WgCfg {
  // two consumer warpgroups and a producer warpgroup, of which one warp
  // issues every copy (setmaxnreg hands registers over by warpgroups)
  static constexpr int THREADS = 384;
  static constexpr int R = 128;        // fixed-tile rows, 64 a warpgroup
  static constexpr int W = D >= 80 ? 64 : 128;      // walk-tile rows
  static constexpr int STAGES = 2;
  static constexpr int SW = D >= 64 ? 128 : 2 * D;  // swizzled row, bytes
  static constexpr int COLS = SW / 2;               // columns of one box
  static constexpr int DP = (D + COLS - 1) / COLS * COLS;  // padded columns
  static constexpr int FIXED = R * DP * 2;  // bytes of a fixed tile
  static constexpr int WALK = W * DP * 2;   // bytes of a walk tile
  // registers a thread: 168 at launch (65,536 / 384), then the producer
  // warpgroup's 128 threads give up 144 each and the consumers' 256 take
  // 72 each
  static constexpr int REGS = 240;
  static constexpr int PRODUCER_REGS = 24;
  // tiles, lse and delta of each stage, barriers, room to align to 1024
  static constexpr size_t SMEM = 2 * (size_t)FIXED +
                                 (size_t)STAGES * 2 * WALK +
                                 (size_t)STAGES * 2 * W * sizeof(float) +
                                 8 * (1 + 2 * STAGES) + 1024;
};

struct Maps {  // the fixed tile's A and B, the walk's C and D
  CUtensorMap a, b, c, d;
};

// KEYS: the dK/dV pass (A, B: K and V; C, D: Q and dO), otherwise the dQ
// pass (A, B: Q and dO; C, D: K and V).  Warp 8 is the producer (warps
// 9-11 only give up their registers); warps 0-3 and 4-7 are consumer
// warpgroups 0 and 1, of fixed rows 0-63 and 64-127.
template <int D, bool KEYS>
__global__ void __launch_bounds__(384, 1)
    fa_bwd_wg(const __grid_constant__ Maps maps, Args a) {
  using Cf = WgCfg<D>;
  constexpr int R = Cf::R, W = Cf::W, ST = Cf::STAGES;
  constexpr int SW = Cf::SW, COLS = Cf::COLS, DP = Cf::DP;
  constexpr int NB = DP / COLS;  // boxes of a row
  constexpr int NS = W / 2;      // score accumulators a thread holds
  constexpr int NA = DP / 2;     // accumulators of one gradient a thread holds
  extern __shared__ __align__(128) unsigned char wsm[];
  // a tile of N rows is NB boxes of N rows x SW bytes, box c at byte
  // c N SW, as TMA writes them with the SW-byte swizzle; every tile
  // starts on 1024 bytes
  unsigned char* As = wsm + ((1024 - (tc::smem_u32(wsm) & 1023)) & 1023);
  unsigned char* Bs = As + Cf::FIXED;
  unsigned char* Cs = Bs + Cf::FIXED;    // ST walk tiles
  unsigned char* Ds = Cs + ST * Cf::WALK;  // ST walk tiles
  float* Ls = reinterpret_cast<float*>(Ds + ST * Cf::WALK);  // ST x W lse log2e
  float* Es = Ls + ST * W;                                   // ST x W delta
  uint64_t* fixed_full = reinterpret_cast<uint64_t*>(Es + ST * W);
  uint64_t* full = fixed_full + 1;  // a stage's tiles (and lse, delta) landed
  uint64_t* empty = full + ST;      // every consumer warp is done with it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.H / a.Hkv;
  // the fixed tile and the walk, as the mma.sync route's; blockIdx.x runs
  // over (batch, head) and blockIdx.y over the fixed blocks, so that the
  // card starts every head's heaviest causal block first
  const int heads = KEYS ? a.Hkv : a.H;
  const int b = blockIdx.x / heads;
  int row0, nrows, hk, h = 0, tstart = 0, ntile, total;
  if (KEYS) {
    hk = blockIdx.x % heads;
    row0 = blockIdx.y * R;  // a key block's walk shortens with its start
    nrows = a.Sk;
    const int first = a.causal ? max(0, row0 - a.q_offset) : 0;
    tstart = first / W;
    ntile = first < a.Sq ? (a.Sq + W - 1) / W - tstart : 0;
    total = G * ntile;
  } else {
    h = blockIdx.x % heads;
    hk = h / G;
    row0 = (gridDim.y - 1 - blockIdx.y) * R;  // a q block's, with its end
    nrows = a.Sq;
    const int qrows = min(R, a.Sq - row0);
    const int end = a.causal ? min(a.Sk, a.q_offset + row0 + qrows) : a.Sk;
    ntile = (end + W - 1) / W;
    total = ntile;
  }

  if (tid == 0) {
    tc::mbar_init(fixed_full, 1);
    for (int s = 0; s < ST; ++s) {
      // the dK/dV pass: the TMA bytes and each producer lane's lse, delta
      tc::mbar_init(full + s, KEYS ? 33 : 1);
      tc::mbar_init(empty + s, 8);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // ---- producer warpgroup
    tc::setmaxnreg_dec<Cf::PRODUCER_REGS>();
    if (warp > 8) return;
    if (lane == 0) {
      const int fh = KEYS ? hk : h;
      tc::mbar_expect_tx(fixed_full, 2 * Cf::FIXED);
      for (int c = 0; c < NB; ++c) {
        tc::tma_load_4d(As + c * R * SW, &maps.a, fixed_full, c * COLS, row0,
                        fh, b);
        tc::tma_load_4d(Bs + c * R * SW, &maps.b, fixed_full, c * COLS, row0,
                        fh, b);
      }
    }
    for (int it = 0; it < total; ++it) {
      const int s = it % ST, n = it / ST;
      if (n > 0) tc::mbar_wait_bounded(empty + s, (n - 1) & 1);
      const int hh = KEYS ? hk * G + it / ntile : hk;
      const int w0 = KEYS ? (tstart + it % ntile) * W : it * W;
      if (lane == 0) {
        tc::mbar_expect_tx(full + s, 2 * Cf::WALK);
        for (int c = 0; c < NB; ++c) {
          tc::tma_load_4d(Cs + s * Cf::WALK + c * W * SW, &maps.c, full + s,
                          c * COLS, w0, hh, b);
          tc::tma_load_4d(Ds + s * Cf::WALK + c * W * SW, &maps.d, full + s,
                          c * COLS, w0, hh, b);
        }
      }
      if constexpr (KEYS) {  // lse (base 2) and delta of the q tile's rows
        for (int r = lane; r < W; r += 32) {
          const int i = w0 + r;
          const bool ok = i < a.Sq;
          const long long at = ((long long)b * a.Sq + i) * a.H + hh;
          Ls[s * W + r] = ok ? a.lse[at] * LOG2E : 0.f;
          Es[s * W + r] = ok ? a.delta[at] : 0.f;
        }
        tc::mbar_arrive(full + s);
      }
    }
  } else {  // ---- consumers: warpgroup wg holds fixed rows 64 wg .. 64 wg + 63
    tc::setmaxnreg_inc<Cf::REGS>();
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int x0 = row0 + wg * 64;     // the warpgroup's first fixed row
    const int xr = x0 + wq * 16 + g;   // this thread's rows xr and xr + 8
    const float scale2 = a.scale * LOG2E;
    const uint32_t a_addr = tc::smem_u32(As) + wg * 64 * SW;
    const uint32_t b_addr = tc::smem_u32(Bs) + wg * 64 * SW;

    // the dQ pass: delta = rowsum(dO o O) of the warp's 16 rows (two
    // lanes a row, 16-byte loads), written for the dK/dV pass, and the
    // log-sum-exp of rows xr and xr + 8 in base 2
    float lse0 = 0.f, lse1 = 0.f, del0 = 0.f, del1 = 0.f;
    if constexpr (!KEYS) {
      constexpr int C = D / 8;  // 16-byte chunks of a row
      const int r = x0 + wq * 16 + (lane >> 1);
      float sum = 0.f;
      if (r < a.Sq) {
        const bf16* op = static_cast<const bf16*>(a.out) + b * a.sob +
                         (long long)r * a.sot + (long long)h * D;
        const bf16* dp = static_cast<const bf16*>(a.dout) + b * a.sdb +
                         (long long)r * a.sdt + (long long)h * D;
#pragma unroll
        for (int j = 0; j < (C + 1) / 2; ++j) {
          const int c = 2 * j + (lane & 1);
          if (c < C) {
            const uint4 o4 = *reinterpret_cast<const uint4*>(op + c * 8);
            const uint4 d4 = *reinterpret_cast<const uint4*>(dp + c * 8);
            const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
            const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 of = __bfloat1622float2(o2[e]);
              const float2 df = __bfloat1622float2(d2[e]);
              sum += of.x * df.x + of.y * df.y;
            }
          }
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((lane & 1) == 0 && r < a.Sq)
        a.delta[((long long)b * a.Sq + r) * a.H + h] = sum;
      del0 = __shfl_sync(0xffffffffu, sum, 2 * g);
      del1 = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
      if (xr < a.Sq) lse0 = a.lse[((long long)b * a.Sq + xr) * a.H + h] * LOG2E;
      if (xr + 8 < a.Sq)
        lse1 = a.lse[((long long)b * a.Sq + xr + 8) * a.H + h] * LOG2E;
    }

    float acc_c[NA];               // dK | dQ
    float acc_d[KEYS ? NA : 1];    // dV
#pragma unroll
    for (int i = 0; i < NA; ++i) acc_c[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (KEYS ? NA : 1); ++i) acc_d[i] = 0.f;
    tc::mbar_wait_bounded(fixed_full, 0);

    for (int it = 0; it < total; ++it) {
      const int s = it % ST;
      // the walk tile's first query row (KEYS) or key (dQ pass)
      const int w0 = KEYS ? (tstart + it % ntile) * W : it * W;
      bool live, masked;
      if (KEYS) {  // keys x0.. against queries w0..
        live = x0 < a.Sk &&
               (!a.causal || x0 <= a.q_offset + min(w0 + W, a.Sq) - 1);
        masked = x0 + 63 >= a.Sk || w0 + W > a.Sq ||
                 (a.causal && x0 + 63 > a.q_offset + w0);
      } else {  // queries x0.. against keys w0..
        live = x0 < a.Sq &&
               (!a.causal || w0 <= a.q_offset + min(x0 + 64, a.Sq) - 1);
        masked = x0 + 63 >= a.Sq || w0 + W > a.Sk ||
                 (a.causal && w0 + W - 1 > a.q_offset + x0);
      }
      tc::mbar_wait_bounded(full + s, (it / ST) & 1);
      if (live) {
        const uint32_t c_addr = tc::smem_u32(Cs + s * Cf::WALK);
        const uint32_t d_addr = tc::smem_u32(Ds + s * Cf::WALK);
        // x1 = A C^T, x2 = B D^T (S^T and dP^T | S and dP): SS products,
        // k16 step kk in box kk / (SW/32), 32 bytes into its rows; only
        // the steps over the D real columns
        float x1[NS], x2[NS];
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int box = kk / (SW / 32), off = (kk % (SW / 32)) * 32;
          tc::wgmma_ss<W>(x1, tc::desc(a_addr + box * R * SW + off, 16, 8 * SW, SW),
                          tc::desc(c_addr + box * W * SW + off, 16, 8 * SW, SW),
                          kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int box = kk / (SW / 32), off = (kk % (SW / 32)) * 32;
          tc::wgmma_ss<W>(x2, tc::desc(b_addr + box * R * SW + off, 16, 8 * SW, SW),
                          tc::desc(d_addr + box * W * SW + off, 16, 8 * SW, SW),
                          kk > 0);
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs(x1);
        tc::fence_regs(x2);

        // P = exp2(x1 scale log2e - lse log2e) under the mask, dS = P (x2 -
        // delta) (the scale is applied to dK and dQ as they are written),
        // each pair rounded to bf16 into the A operand of k16 step i / 8:
        // x[4j + e] is fixed row g (+8 for e >= 2) of the warp, walk row 8j
        // + 2t + (e & 1) of the tile.  Instantiated with and without the
        // mask, so a tile inside the edges runs no index arithmetic.
        uint32_t pa[KEYS ? W / 16 : 1][4], da[W / 16][4];
        auto scores = [&](auto mask) {
#pragma unroll
          for (int i = 0; i < NS; i += 2) {
            const int hi = (i >> 1) & 1;
            const int cl = (i >> 2) * 8 + 2 * t;  // walk rows cl, cl + 1
            float l2[2], dl[2], p[2];
            if constexpr (KEYS) {
              const float2 lv = *reinterpret_cast<const float2*>(Ls + s * W + cl);
              const float2 dv = *reinterpret_cast<const float2*>(Es + s * W + cl);
              l2[0] = lv.x, l2[1] = lv.y, dl[0] = dv.x, dl[1] = dv.y;
            } else {
              l2[0] = l2[1] = hi ? lse1 : lse0;
              dl[0] = dl[1] = hi ? del1 : del0;
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float e = fmaf(x1[i + u], scale2, -l2[u]);
              if constexpr (decltype(mask)::value) {
                const int xf = xr + hi * 8, xw = w0 + cl + u;
                const int key = KEYS ? xf : xw, qi = KEYS ? xw : xf;
                if (key >= a.Sk || qi >= a.Sq || (a.causal && key > a.q_offset + qi))
                  e = NEG_INF;
              }
              p[u] = tc::ex2(e);
            }
            if constexpr (KEYS) pa[i >> 3][(i >> 1) & 3] = tc::pack_bf16(p[0], p[1]);
            da[i >> 3][(i >> 1) & 3] =
                tc::pack_bf16(p[0] * (x2[i] - dl[0]), p[1] * (x2[i + 1] - dl[1]));
          }
        };
        if (masked)
          scores(std::true_type{});
        else
          scores(std::false_type{});

        // acc_c += dS C, acc_d += P D (KEYS): RS products, C and D read
        // MN-major, 16 walk rows (two atoms) a step, boxes W SW apart
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          tc::wgmma_rs<DP>(acc_c, da[kk],
                           tc::desc(c_addr + kk * 16 * SW, W * SW, 8 * SW, SW));
          if constexpr (KEYS)
            tc::wgmma_rs<DP>(acc_d, pa[kk],
                             tc::desc(d_addr + kk * 16 * SW, W * SW, 8 * SW, SW));
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs(acc_c);
        if constexpr (KEYS) tc::fence_regs(acc_d);
      }
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(empty + s);  // this warp is done with the stage
    }

    // write each row once (a walk that was empty writes zeros); the real
    // columns only
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = xr + half * 8;
      if (x >= nrows) continue;
      bf16* oc;
      bf16* od = nullptr;
      if (KEYS) {
        const long long row = ((long long)b * a.Sk + x) * a.Hkv + hk;
        oc = static_cast<bf16*>(a.dk) + row * D;
        od = static_cast<bf16*>(a.dv) + row * D;
      } else {
        const long long row = ((long long)b * a.Sq + x) * a.H + h;
        oc = static_cast<bf16*>(a.dq) + row * D;
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(oc + i * 8 + 2 * t) =
            tc::pack_bf16(acc_c[4 * i + 2 * half] * a.scale,
                          acc_c[4 * i + 2 * half + 1] * a.scale);
        if constexpr (KEYS)
          *reinterpret_cast<uint32_t*>(od + i * 8 + 2 * t) = tc::pack_bf16(
              acc_d[4 * i + 2 * half], acc_d[4 * i + 2 * half + 1]);
      }
    }
  }
}

template <int D, bool KEYS>
int launch_wg_pass(const Args& a, int batch, cudaStream_t stream) {
  using Cf = WgCfg<D>;
  auto* kernel = fa_bwd_wg<D, KEYS>;
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cf::SMEM);
  if (e != cudaSuccess) return (int)e;
  // boxes of the fixed tile's R rows and of the walk's W rows
  constexpr int R = Cf::R, W = Cf::W, SW = Cf::SW;
  Maps m;
  const bool ok =
      KEYS ? tc::make_map(&m.a, a.k, D, a.Sk, a.Hkv, batch, a.skt, a.skb, R, SW) &&
                 tc::make_map(&m.b, a.v, D, a.Sk, a.Hkv, batch, a.svt, a.svb, R, SW) &&
                 tc::make_map(&m.c, a.q, D, a.Sq, a.H, batch, a.sqt, a.sqb, W, SW) &&
                 tc::make_map(&m.d, a.dout, D, a.Sq, a.H, batch, a.sdt, a.sdb, W, SW)
           : tc::make_map(&m.a, a.q, D, a.Sq, a.H, batch, a.sqt, a.sqb, R, SW) &&
                 tc::make_map(&m.b, a.dout, D, a.Sq, a.H, batch, a.sdt, a.sdb, R, SW) &&
                 tc::make_map(&m.c, a.k, D, a.Sk, a.Hkv, batch, a.skt, a.skb, W, SW) &&
                 tc::make_map(&m.d, a.v, D, a.Sk, a.Hkv, batch, a.svt, a.svb, W, SW);
  if (!ok) return (int)cudaErrorInvalidValue;
  dim3 grid(batch * (KEYS ? a.Hkv : a.H), ((KEYS ? a.Sk : a.Sq) + R - 1) / R);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, Cf::THREADS, Cf::SMEM, stream>>>(m, a);
  return (int)cudaGetLastError();
}

// the dQ pass first: it writes delta, which the dK/dV pass reads
template <int D>
int launch_wg(const Args& a, int batch, cudaStream_t stream) {
  const int e = launch_wg_pass<D, false>(a, batch, stream);
  if (e != 0) return e;
  return launch_wg_pass<D, true>(a, batch, stream);
}

int launch_wg_d(int D, const Args& a, int batch, cudaStream_t s) {
  switch (D) {
    case 16: return launch_wg<16>(a, batch, s);
    case 32: return launch_wg<32>(a, batch, s);
    case 64: return launch_wg<64>(a, batch, s);
    case 80: return launch_wg<80>(a, batch, s);
    case 128: return launch_wg<128>(a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

// fixed rows, walk rows and the rows of a unit that skips a tile (a
// warp | a warpgroup) of each route
template <int D>
void geometry(int dtype, int* out) {
  if (dtype == 0) {
    out[0] = Cfg<float, D>::R;
    out[1] = Cfg<float, D>::W;
    out[2] = 16;
  } else {
    out[0] = WgCfg<D>::R;
    out[1] = WgCfg<D>::W;
    out[2] = 64;
  }
}

}  // namespace

// dtype: 0 float32 (3xTF32), 1 bfloat16, for q, k, v, out, dout, dq, dk
// and dv.  Strides are in elements; each of q, k, v, out and dout has a
// head stride of D and unit feature stride, and every base pointer and
// batch or sequence stride of q, k, v and dout is 16-byte aligned; lse
// and delta (B,Sq,H) float32, dq (B,Sq,H,D) and dk, dv (B,Sk,Hkv,D) are
// contiguous.  Launches two kernels on the stream; returns the
// cudaError_t of the launches.
extern "C" int repro_flash_attention_backward(
    int dtype, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int batch, int Sq, int Sk, int H, int Hkv, int D, int q_offset,
    int causal, float scale, long long sqb, long long sqt, long long skb,
    long long skt, long long svb, long long svt, long long sob, long long sot,
    long long sdb, long long sdt, void* stream) {
  if (batch < 1 || batch > 65535 || Sq < 1 || Sk < 1 || H < 1 ||
      H > 65535 || Hkv < 1 || H % Hkv != 0 || q_offset < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int item = dtype == 0 ? 4 : 2;
  const long long strides[10] = {sqb, sqt, skb, skt, svb, svt, sdb, sdt,
                                 sob, sot};
  for (long long s : strides)
    if ((s * item) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  Args a{q,  k,  v,   out, dout, lse, delta, dq, dk, dv, Sq, Sk,
         H,  Hkv, q_offset, causal ? 1 : 0, scale, sqb, sqt, skb, skt,
         svb, svt, sob, sot, sdb, sdt};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch_d<float>(D, a, batch, s)
                    : launch_wg_d(D, a, batch, s);
}

// The launch geometry of route dtype at head dim D, which
// flash_attention.backward_walks and backward_tiles mirror: out[0] the
// fixed tile's rows, out[1] the walk tile's, out[2] the rows of the unit
// that skips a walk tile (a warp of the mma.sync route, a warpgroup of
// the wgmma route).
extern "C" int repro_flash_attention_backward_geometry(int dtype, int D,
                                                       int* out) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: geometry<16>(dtype, out); return 0;
    case 32: geometry<32>(dtype, out); return 0;
    case 64: geometry<64>(dtype, out); return 0;
    case 80: geometry<80>(dtype, out); return 0;
    case 128: geometry<128>(dtype, out); return 0;
  }
  return (int)cudaErrorInvalidValue;
}
