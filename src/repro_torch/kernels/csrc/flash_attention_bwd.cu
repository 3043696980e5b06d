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
// dK = dS^T Q, dQ = dS K).  At minicpm-2b's training shape (q
// (1,4096,36,64) bf16, causal) that is 193 GFLOP against 152 MB: 0.195 ms
// at the bf16 tensor-core peak; at qwen3-0.6b's (q (2,4096,16,128) f32,
// GQA 16/8) 344 GFLOP, 2.08 ms in float32 as 3xTF32.
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
// Both passes are one template: a fixed tile of R = 128 rows (A: K or
// Q, B: V or dO), eight warps of 16 rows each, and a walk of W-row tiles
// (C: Q or K, D: dO or V; W = 64, 32 at D = 128 to keep the registers
// under 255 with no spill), double-buffered by 16-byte cp.async (lse and
// delta of a q tile beside it in pass 2).  X1 = A C^T, X2 = B D^T; P =
// exp2(X1 scale log2e - lse log2e) under the forward's finite -1e30
// mask (applied only on tiles that cross Sk, Sq or the causal edge), dS
// = P (X2 - delta) scale; then acc_C += dS C (dK or dQ) and, in pass 2,
// acc_D += P D (dV).  A warp whose 16 rows all lie past the causal edge
// of a walk tile's real rows (or past Sk or Sq) skips it.
//
// Tensor cores, on mma.sync for both types:
// - bfloat16: m16n8k16 with float32 accumulation; fragments come from
//   shared memory by ldmatrix (transposed for the B operand whose k
//   runs along the rows: dO and Q in pass 2, K in pass 1), rows padded
//   by 16 bytes so the eight row addresses of each 8 x 8 matrix fall in
//   distinct banks; P and dS are rounded to bf16 as A operands, as
//   FlashAttention-2 and -3 do.  wgmma would take the products at the
//   full rate, but its register A operand is the m64 accumulator layout
//   of a warpgroup and its B operands dO and Q would be read MN-major;
//   mma.sync keeps one fragment scheme for both types and every head
//   size, and wgmma is left to a later redesign.
// - float32: m16n8k8 in 3xTF32 (tc.cuh: each operand split into big and
//   small TF32 halves, about 22 bits), as the forward's float32 route;
//   rows padded by 4 floats, so every fragment load is free of bank
//   conflicts; an accumulator passes to the A operand with its k slots
//   t and t + 4 taken as rows 2t and 2t + 1, and the B operand is read
//   in the same order.  Head dim 80 is taken as it is (84-float rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// four 8 x 8 matrices of 16-bit values, row addresses from lanes 8m..8m+7
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tc::smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tc::smem_u32(p))
      : "memory");
}
// d += a b, one m16n8k16 bf16 product with float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

template <>
struct Mma<bf16> {
  static constexpr int KS = 16, PAD = 8;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  // matrices: rows 0-7 | 8-15 at k 0, then at k 8: a0, a1, a2, a3
  static __device__ __forceinline__ void load_a(A& a, const bf16* p, int ld,
                                                int lane) {
    ldsm_x4(a.r, p + ((lane & 7) + (lane & 8)) * ld + (lane >> 4) * 8);
  }
  // matrices: n 0-7 at k 0 | k 8, then n 8-15: b0, b1 of each slice
  static __device__ __forceinline__ void load_bn(B (&b)[2], const bf16* p,
                                                 int ld, int lane) {
    uint32_t r[4];
    ldsm_x4(r, p + ((lane & 7) + (lane >> 4) * 8) * ld + (lane & 8));
    b[0].r[0] = r[0];
    b[0].r[1] = r[1];
    b[1].r[0] = r[2];
    b[1].r[1] = r[3];
  }
  // matrices: k 0-7 | 8-15 at n 0, then at n 8, each transposed
  static __device__ __forceinline__ void load_bk(B (&b)[2], const bf16* p,
                                                 int ld, int lane) {
    uint32_t r[4];
    ldsm_x4_t(r, p + ((lane & 7) + (lane & 8)) * ld + (lane >> 4) * 8);
    b[0].r[0] = r[0];
    b[0].r[1] = r[1];
    b[1].r[0] = r[2];
    b[1].r[1] = r[3];
  }
  // k step kk spans slices 2kk (k 0-7) and 2kk + 1 (k 8-15)
  template <int N>
  static __device__ __forceinline__ void to_a(A& a, const float (&c)[N][4],
                                              int kk) {
    a.r[0] = tc::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a.r[1] = tc::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a.r[2] = tc::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a.r[3] = tc::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma_bf16(d, a.r, b.r);
  }
  static __device__ __forceinline__ float to_f(bf16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ void store2(bf16* p, float x, float y) {
    *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16(x, y);
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
  const long long strides[8] = {sqb, sqt, skb, skt, svb, svt, sdb, sdt};
  for (long long s : strides)
    if ((s * item) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  Args a{q,  k,  v,   out, dout, lse, delta, dq, dk, dv, Sq, Sk,
         H,  Hkv, q_offset, causal ? 1 : 0, scale, sqb, sqt, skb, skt,
         svb, svt, sob, sot, sdb, sdt};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch_d<float>(D, a, batch, s)
                    : launch_d<bf16>(D, a, batch, s);
}
