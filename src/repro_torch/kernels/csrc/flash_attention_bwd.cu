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
//   1. the dQ pass, one CTA per (q block, head, batch): writes delta =
//      rowsum(dO o O) of its rows (float32, read again by pass 2; in the
//      float32 route the pre-pass writes it), then walks the key tiles up to the causal edge,
//      recomputing S = Q K^T and dP = dO V^T, and accumulates dQ += dS K
//      in registers; dQ is written once in q's type;
//   2. the dK/dV pass, one CTA per (key block, kv head, batch):
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
// Both routes share that plan: a fixed tile of R rows (128 in bf16, 64 in
// float32; A: K or Q, B: V or dO) and a walk of W-row tiles (C: Q or K, D: dO or V).  X1 = A
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
// float32 route, on wgmma in 3xTF32 (each product a_s b_b + a_b b_s + a_b
// b_b over TF32 halves, about 21-22 bits), fed by TMA bulk copies from a
// producer warp.  What bounded the mma.sync route it replaced (on an
// H100: 18.4% of the bound, 11.2 ms at qwen3-0.6b's microbatch): mma.sync
// below wgmma's rate, eight warps staging their own tiles by cp.async, and
// every fragment load splitting its operand into TF32 halves again (each
// walk tile eight times, once a warp).  Hopper's tf32 wgmma reads both
// shared-memory operands K-major only, so the products over the walk rows
// (dV += P^T dO, dK += dS^T Q, dQ += dS K) need their B operand with the
// sequence contiguous, which no TMA box can transpose.  So:
// - a pre-pass (a third launch, bound by bytes) writes each operand once
//   as images (Scratch, below): both TF32 halves, padded to 32-float
//   chunks of the head dim, already in the 128-byte swizzle, in pieces of
//   16 KB; Q, dO and K also transposed with the sequence permuted in
//   groups of 8, so that the accumulators pass to the A operand in place;
//   and (lse log2e, delta) of every q row.  About 3.5 times the operands'
//   float32 bytes (0.74 GB at qwen3-0.6b's microbatch, about 0.3 ms).
// - the passes are pure copy and product: a CTA holds R = 64 fixed rows
//   (their two operands, both halves: 128 KB at D = 128) and two consumer
//   warpgroups that take the walk's tiles in turn, even and odd, each fed
//   by its own producer thread through its own ring of pieces (W walk
//   rows x 32 head-dim columns, both halves; W = 64, but 32 in the dK/dV
//   pass at D >= 80) by bulk copies completing on mbarriers.  While one
//   warpgroup waits on its products or runs a tile's exponentials, the
//   other's products keep the tensor cores busy.  At the end the second
//   warpgroup's partial gradients are added into the first's through
//   shared memory (a fixed order: the sums stay deterministic).  Each
//   piece is one commit group, handed back once its products are done,
//   one group behind.
// - X1 and X2 are SS products m64nWk8 (3 a k8 step, over the head dim's
//   real columns); P and dS are split into TF32 halves from the
//   accumulators into the A operand of RS products m64n32k8 (m64n16k8 for
//   a last chunk of 16 columns, at D 16 and 80), one 32-column chunk of
//   the gradient a piece.  dS is split only after dV's products have
//   completed, so at most one of the two is held in halves: at D = 128 a
//   dK/dV thread holds dK, dV (64 + 64), X1, X2 (16 + 16) and one split
//   (32).
// - setmaxnreg: 384 threads launch at 168 registers; the producer
//   warpgroup drops to 40 (its 64-bit address arithmetic spills at 24),
//   the consumers rise to 232.  No spill at any head dim (-Xptxas -v).
//   ptxas serializes every wgmma of a kernel when products are in flight
//   across a branch whose two sides join, so a tile's products sit in one
//   straight-line region (a dead tile takes a separate branch before any
//   product) and the pieces are handed back by predicated arrives, not a
//   branch on the lane.  The elementwise work uses exp2f, as the mma.sync
//   route did.
// - head dims 16 and 80 are padded to 32 and 96 columns in the images
//   (zeros); the products skip the k8 steps past D.
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

// ------------------------------------------------------------ float32 route
// The pre-pass writes every operand the two passes read as images: each a
// sequence of pieces of 4,096 floats (16 KB), a piece being both TF32
// halves (big, then small: tc::split_exact) of 64 rows x 32 floats, each
// half laid out as a K-major wgmma operand with the 128-byte swizzle (the
// float at row r, column f at r 32 + ((f / 4) ^ (r % 8)) 4 + f % 4).
// - natural (nq, ndo, nk, nv): piece ((b heads + h) tiles + tile) NC + c
//   holds sequence rows 64 tile.. of head-dim columns 32 c..32 c + 31:
//   the head dim is K, for S = Q K^T and dP = dO V^T and the fixed tiles;
// - transposed (tq, tdo, tk): the same piece index holds head-dim
//   columns 32 c.. as rows and the tile's 64 sequence rows as K, in two
//   atom columns of 32, each group of 8 sequence rows stored 0, 2, 4, 6,
//   1, 3, 5, 7 (tc.cuh's k order for an accumulator passed as A): the B
//   operand of dV += P^T dO, dK += dS^T Q and dQ += dS K;
// - ld: (B, H, 64 TQ) pairs (lse log2e, delta) of the q rows, 0 past Sq.
// Rows past the sequence and columns past D are zeros.
constexpr int TILE = 64;       // rows of an image tile
constexpr int PIECE_F = 4096;  // floats of an image piece, both halves

struct Scratch {
  float *nq, *ndo, *tq, *tdo, *nk, *nv, *tk, *ld;
  int TQ, TK;  // image tiles of q and of k
};

// the float32 route's scratch in floats; with s, its pieces carved from
// base in this order
long long tf_scratch(int batch, int Sq, int Sk, int H, int Hkv, int D,
                     float* base, Scratch* s) {
  const int NC = (D + 31) / 32;
  const int TQ = (Sq + TILE - 1) / TILE, TK = (Sk + TILE - 1) / TILE;
  const long long nq = (long long)batch * H * TQ * NC * PIECE_F;
  const long long nk = (long long)batch * Hkv * TK * NC * PIECE_F;
  if (s != nullptr) {
    s->nq = base;
    s->ndo = s->nq + nq;
    s->tq = s->ndo + nq;
    s->tdo = s->tq + nq;
    s->nk = s->tdo + nq;
    s->nv = s->nk + nk;
    s->tk = s->nv + nk;
    s->ld = s->tk + nk;
    s->TQ = TQ;
    s->TK = TK;
  }
  return 4 * nq + 3 * nk + (long long)batch * H * TQ * TILE * 2;
}

// sequence row of position s in a group of 8 of a transposed piece
__device__ __forceinline__ int perm8(int s) { return s < 4 ? 2 * s : 2 * s - 7; }

// The pre-pass: one CTA a (64-row tile, head, batch) of each of q, dout,
// k and v, in that order.  Stages the tile (zeros past the sequence and
// past D), writes its natural pieces and, for q, dout and k, its
// transposed pieces; for dout also delta = rowsum(dO o O) and lse log2e
// of its rows.  Bound by bytes: it reads the four operands and out once
// and writes 3.5 times their float32 size (7 images of two halves, V's
// transposed one not needed).
template <int D>
__global__ void __launch_bounds__(256) fa_bwd_prep(const Args a,
                                                   const Scratch s,
                                                   int batch) {
  constexpr int NC = (D + 31) / 32, DP = 32 * NC, LDX = DP + 1;
  __shared__ float X[TILE * LDX];
  const int tid = threadIdx.x;
  long long job = blockIdx.x;
  const long long nqj = (long long)batch * a.H * s.TQ;
  const long long nkj = (long long)batch * a.Hkv * s.TK;
  int kind = 0;  // q, dout, k, v
  if (job >= nqj) {
    job -= nqj, kind = 1;
    if (job >= nqj) {
      job -= nqj, kind = 2;
      if (job >= nkj) job -= nkj, kind = 3;
    }
  }
  const bool qside = kind < 2;
  const int heads = qside ? a.H : a.Hkv, tiles = qside ? s.TQ : s.TK;
  const int S = qside ? a.Sq : a.Sk;
  const int tile = (int)(job % tiles);
  job /= tiles;
  const int h = (int)(job % heads), b = (int)(job / heads);
  const float* src;
  long long sb, st;
  float* nat;
  float* tr = nullptr;
  switch (kind) {
    case 0: src = static_cast<const float*>(a.q), sb = a.sqb, st = a.sqt;
            nat = s.nq, tr = s.tq; break;
    case 1: src = static_cast<const float*>(a.dout), sb = a.sdb, st = a.sdt;
            nat = s.ndo, tr = s.tdo; break;
    case 2: src = static_cast<const float*>(a.k), sb = a.skb, st = a.skt;
            nat = s.nk, tr = s.tk; break;
    default: src = static_cast<const float*>(a.v), sb = a.svb, st = a.svt;
             nat = s.nv;
  }
  src += b * sb + (long long)h * D;
  const int row0 = tile * TILE;
  for (int i = tid; i < TILE * (DP / 4); i += 256) {
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S && c < D)
      x = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * st + c);
    float* p = X + r * LDX + c;
    p[0] = x.x, p[1] = x.y, p[2] = x.z, p[3] = x.w;
  }
  __syncthreads();
  const long long piece0 = (((long long)b * heads + h) * tiles + tile) * NC;
  // natural pieces: a thread a 16-byte chunk j of row r of chunk c
  for (int i = tid; i < NC * TILE * 8; i += 256) {
    const int j = i & 7, r = (i >> 3) & (TILE - 1), c = i >> 9;
    float big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tc::split_exact(X[r * LDX + 32 * c + 4 * j + e], big[e], small[e]);
    float* dst = nat + (piece0 + c) * PIECE_F + r * 32 + ((j ^ (r & 7)) << 2);
    *reinterpret_cast<float4*>(dst) = make_float4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<float4*>(dst + PIECE_F / 2) =
        make_float4(small[0], small[1], small[2], small[3]);
  }
  // transposed pieces: a thread a 16-byte chunk j of head-dim row rr of
  // atom column kc of chunk n
  if (tr != nullptr) {
    for (int i = tid; i < NC * 2 * 32 * 8; i += 256) {
      const int j = i & 7, rr = (i >> 3) & 31, kc = (i >> 8) & 1, n = i >> 9;
      float big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = 4 * j + e;
        const int row = kc * 32 + (pos & ~7) + perm8(pos & 7);
        tc::split_exact(X[row * LDX + 32 * n + rr], big[e], small[e]);
      }
      float* dst = tr + (piece0 + n) * PIECE_F + kc * 1024 + rr * 32 +
                   ((j ^ (rr & 7)) << 2);
      *reinterpret_cast<float4*>(dst) = make_float4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<float4*>(dst + PIECE_F / 2) =
          make_float4(small[0], small[1], small[2], small[3]);
    }
  }
  if (kind == 1) {  // a warp a row: delta in a fixed order, and lse log2e
    const int warp = tid >> 5, lane = tid & 31;
    const float* op = static_cast<const float*>(a.out) + b * a.sob + (long long)h * D;
    float* ld = s.ld + (((long long)b * a.H + h) * s.TQ * TILE + row0) * 2;
    for (int r = warp; r < TILE; r += 8) {
      const int i = row0 + r;
      float sum = 0.f;
      if (i < a.Sq)
        for (int c = lane; c < D; c += 32)
          sum += op[(long long)i * a.sot + c] * X[r * LDX + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0)
        *reinterpret_cast<float2*>(ld + 2 * r) =
            i < a.Sq ? make_float2(a.lse[((long long)b * a.Sq + i) * a.H + h] * LOG2E, sum)
                     : make_float2(0.f, 0.f);
    }
  }
}

// x (+)= the fixed chunk at fixed (A) times the walk piece at walk (C^T,
// W rows): chunk c's k8 steps within D, three TF32 products a step, small
// terms first; chunk 0's first product overwrites x
template <int D, int W>
__device__ __forceinline__ void tf32_scores(float (&x)[W / 2], uint32_t fixed,
                                            uint32_t walk, int c) {
  constexpr int FHALF = TILE * 32 * 4, HALF = W * 32 * 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (32 * c + 8 * kk < D) {
      const uint32_t o = kk * 32;
      const uint64_t ab = tc::desc(fixed + o, 16, 1024, 128);
      const uint64_t as = tc::desc(fixed + FHALF + o, 16, 1024, 128);
      const uint64_t bb = tc::desc(walk + o, 16, 1024, 128);
      const uint64_t bs = tc::desc(walk + HALF + o, 16, 1024, 128);
      tc::wgmma_tf32_ss<W>(x, as, bb, c > 0 || kk > 0);
      tc::wgmma_tf32_ss<W>(x, ab, bs, 1);
      tc::wgmma_tf32_ss<W>(x, ab, bb, 1);
    }
}

// P or dS from the accumulators as the A operand of k8 step kk, both
// halves (tc::split): k slot t is walk column 2t, slot t + 4 column 2t + 1
template <int W>
__device__ __forceinline__ void tf32_to_a(const float (&x)[W / 2],
                                          uint32_t (&fb)[W / 8][4],
                                          uint32_t (&fs)[W / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    tc::split(x[4 * kk], fb[kk][0], fs[kk][0]);
    tc::split(x[4 * kk + 2], fb[kk][1], fs[kk][1]);
    tc::split(x[4 * kk + 1], fb[kk][2], fs[kk][2]);
    tc::split(x[4 * kk + 3], fb[kk][3], fs[kk][3]);
  }
}

// acc's head-dim columns 32 C.. (32 of them, 16 for a last chunk of 16)
// += A (fb, fs) times the transposed piece at walk (K: the W walk rows),
// three TF32 products a k8 step
template <int D, int W, int C>
__device__ __forceinline__ void tf32_grads(float (&acc)[D / 2],
                                           const uint32_t (&fb)[W / 8][4],
                                           const uint32_t (&fs)[W / 8][4],
                                           uint32_t walk) {
  if constexpr (32 * C < D) {
    constexpr int N = D - 32 * C >= 32 ? 32 : 16, HALF = W * 32 * 4;
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) {
      const uint32_t o = (kk / 4) * 4096 + (kk % 4) * 32;
      const uint64_t bb = tc::desc(walk + o, 16, 1024, 128);
      const uint64_t bs = tc::desc(walk + HALF + o, 16, 1024, 128);
      tc::wgmma_tf32_rs<N, 16 * C>(acc, fs[kk], bb);
      tc::wgmma_tf32_rs<N, 16 * C>(acc, fb[kk], bs);
      tc::wgmma_tf32_rs<N, 16 * C>(acc, fb[kk], bb);
    }
  }
}

template <int D, bool KEYS>
struct TfCfg {
  // two consumer warpgroups, which take the walk's tiles in turn (even,
  // odd) against the same fixed rows, each fed through its own ring by its
  // own producer thread, and a producer warpgroup, of which warps 8 and 9
  // issue the copies (setmaxnreg hands registers over by warpgroups): 168
  // registers a thread at launch, then 40 for the producers (their 64-bit
  // address arithmetic spills at 24) and 232 for the consumers
  static constexpr int THREADS = 384;
  static constexpr int REGS = 232;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int R = 64;               // fixed rows, M of every product
  // walk rows, N of S and dP: 64, but 32 in the dK/dV pass at D >= 80,
  // where a thread holds dK and dV (2 x D / 2 floats) beside the scores
  // and one split (at 64 rows they pass the 232 registers); at D 128 the
  // dQ pass's rings of 16 KB pieces are three deep, which still runs
  // faster than 32-row pieces six deep
  static constexpr int W = KEYS && D >= 80 ? 32 : 64;
  static constexpr int NC = (D + 31) / 32;   // 32-float chunks of a row
  static constexpr int FIXED = TILE * 32 * 2 * 4;  // bytes of a fixed piece
  static constexpr int HALF = W * 32 * 4;    // bytes of a walk piece's half
  static constexpr int PIECE = 2 * HALF;
  static constexpr int LDB = 2 * W * 2 * 4;  // two stages of (lse, delta)
  static constexpr int BARS = 512;           // room for the mbarriers
  // the fixed tiles (both halves of A and B), then as many walk pieces as
  // fit in the 227 KB an SM gives a block, past 1024 bytes of alignment,
  // split into the two rings
  static constexpr int STAGES =
      (232448 - 1024 - LDB - BARS - 2 * NC * FIXED) / PIECE / 2;
  static constexpr size_t SMEM = 1024 + 2 * (size_t)NC * FIXED +
                                 2 * (size_t)STAGES * PIECE + LDB + BARS;
  static_assert(STAGES >= 3 && 1 + 4 * STAGES + 4 <= BARS / 8, "smem plan");
  // the second warpgroup's partial gradients pass through the rings
  static_assert(2 * (size_t)STAGES * PIECE >= (KEYS ? 2 : 1) * (D / 2) * 128 * 4,
                "room for the partial sums");
};

// KEYS: the dK/dV pass (fixed: 64 keys of a kv head, K and V; walk: the
// q tiles of its G heads, pieces Q, dO, dO^T, Q^T); otherwise the dQ pass
// (fixed: 64 rows of a head, Q and dO; walk: key tiles, pieces K, V,
// K^T).  Warps 0-3 and 4-7 are consumer warpgroups 0 and 1, which take
// the even and the odd walk tiles and sum their partial gradients at the
// end (1's into 0's, a fixed order); lane 0 of warp 8 + w is warpgroup
// w's producer (warp 8's also loads the fixed tiles).
template <int D, bool KEYS>
__global__ void __launch_bounds__(384, 1)
    fa_bwd_tf32(const Args a, const Scratch s) {
  using Cf = TfCfg<D, KEYS>;
  constexpr int R = Cf::R, W = Cf::W, NC = Cf::NC, ST = Cf::STAGES;
  constexpr int FIXED = Cf::FIXED, HALF = Cf::HALF, PIECE = Cf::PIECE;
  constexpr int OPS = KEYS ? 4 : 3;  // walk operands a tile
  constexpr int NS = W / 2;          // score accumulators a thread holds
  constexpr int NA = D / 2;          // accumulators of one gradient
  constexpr int LAG = 1;             // commit groups left in flight
  extern __shared__ __align__(128) unsigned char tsm[];
  unsigned char* fixa = tsm + ((1024 - (tc::smem_u32(tsm) & 1023)) & 1023);
  unsigned char* fixb = fixa + NC * FIXED;
  unsigned char* rings = fixb + NC * FIXED;  // 2 rings of ST walk pieces
  float* lds = reinterpret_cast<float*>(rings + 2 * ST * PIECE);
  uint64_t* fixed_full = reinterpret_cast<uint64_t*>(lds + 4 * W);
  uint64_t* fulls = fixed_full + 1;  // 2 x ST: a piece landed
  uint64_t* empties = fulls + 2 * ST;  // 2 x ST: its warpgroup's 4 warps are done
  uint64_t* ld_full = empties + 2 * ST;  // warpgroup w's stage w: a q
  uint64_t* ld_empty = ld_full + 2;      // tile's (lse, delta) landed, used

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.H / a.Hkv;
  // the fixed tile and the walk, as the bf16 route's: blockIdx.x runs
  // over (batch, head), blockIdx.y over the fixed blocks, heaviest
  // causal walk first
  const int heads = KEYS ? a.Hkv : a.H;
  const int b = blockIdx.x / heads;
  int row0, nrows, hk, h = 0, tstart = 0, ntile, total;
  if (KEYS) {
    hk = blockIdx.x % heads;
    row0 = blockIdx.y * R;
    nrows = a.Sk;
    const int first = a.causal ? max(0, row0 - a.q_offset) : 0;
    tstart = first / W;
    ntile = first < a.Sq ? (a.Sq + W - 1) / W - tstart : 0;
    total = G * ntile;
  } else {
    h = blockIdx.x % heads;
    hk = h / G;
    row0 = (gridDim.y - 1 - blockIdx.y) * R;
    nrows = a.Sq;
    const int qrows = min(R, a.Sq - row0);
    const int end = a.causal ? min(a.Sk, a.q_offset + row0 + qrows) : a.Sk;
    ntile = (end + W - 1) / W;
    total = ntile;
  }

  if (tid == 0) {
    tc::mbar_init(fixed_full, 1);
    for (int i = 0; i < 2 * ST; ++i) {
      tc::mbar_init(fulls + i, 1);
      tc::mbar_init(empties + i, 4);
    }
    for (int i = 0; i < 2; ++i) {
      tc::mbar_init(ld_full + i, 1);
      tc::mbar_init(ld_empty + i, 4);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // ---- producers: lane 0 of warp 8 + w feeds warpgroup w
    tc::setmaxnreg_dec<Cf::PRODUCER_REGS>();
    const int w = warp - 8;
    if (w > 1 || lane != 0) return;
    if (w == 0) {
      const int fh = KEYS ? hk : h, ftiles = KEYS ? s.TK : s.TQ;
      const long long fp = (((long long)b * heads + fh) * ftiles + row0 / TILE) * NC;
      const float* ia = KEYS ? s.nk : s.nq;
      const float* ib = KEYS ? s.nv : s.ndo;
      tc::mbar_expect_tx(fixed_full, 2 * NC * FIXED);
      for (int c = 0; c < NC; ++c) {
        tc::bulk_load(fixa + c * FIXED, ia + (fp + c) * PIECE_F, FIXED, fixed_full);
        tc::bulk_load(fixb + c * FIXED, ib + (fp + c) * PIECE_F, FIXED, fixed_full);
      }
    }
    unsigned char* ring = rings + w * ST * PIECE;
    uint64_t* full = fulls + w * ST;
    uint64_t* empty = empties + w * ST;
    const int wheads = KEYS ? a.H : a.Hkv, wtiles = KEYS ? s.TQ : s.TK;
    int slot = 0, n = 0;  // the next piece's stage and its use of it
    for (int it = w, k = 0; it < total; it += 2, ++k) {
      const int hh = KEYS ? hk * G + it / ntile : hk;
      const int w0 = KEYS ? (tstart + it % ntile) * W : it * W;
      // the tile's first piece in an image, and floats into each half
      const long long off = (((long long)b * wheads + hh) * wtiles + w0 / TILE) *
                                NC * PIECE_F + (w0 % TILE) * 32;
      if constexpr (KEYS) {
        if (k > 0) tc::mbar_wait_bounded(ld_empty + w, (k - 1) & 1);
        tc::mbar_expect_tx(ld_full + w, W * 8);
        tc::bulk_load(lds + w * 2 * W,
                      s.ld + (((long long)b * a.H + hh) * s.TQ * TILE + w0) * 2,
                      W * 8, ld_full + w);
      }
#pragma unroll
      for (int op = 0; op < OPS; ++op) {
        const float* src =
            (KEYS ? (op == 0 ? s.nq : op == 1 ? s.ndo : op == 2 ? s.tdo : s.tq)
                  : (op == 0 ? s.nk : op == 1 ? s.nv : s.tk)) + off;
        for (int c = 0; c < NC; ++c, src += PIECE_F) {
          if (n > 0) tc::mbar_wait_bounded(empty + slot, (n - 1) & 1);
          unsigned char* dst = ring + slot * PIECE;
          tc::mbar_expect_tx(full + slot, PIECE);
          tc::bulk_load(dst, src, HALF, full + slot);
          tc::bulk_load(dst + HALF, src + PIECE_F / 2, HALF, full + slot);
          if (++slot == ST) slot = 0, ++n;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes walk tiles wg, wg + 2, ... against
  // fixed rows row0 .. row0 + 63
  tc::setmaxnreg_inc<Cf::REGS>();
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = row0;
  const int xr = x0 + (warp & 3) * 16 + g;  // this thread's rows xr and xr + 8
  const float scale2 = a.scale * LOG2E;
  const uint32_t fa_addr = tc::smem_u32(fixa), fb_addr = tc::smem_u32(fixb);
  const uint32_t ring_addr = tc::smem_u32(rings + wg * ST * PIECE);
  uint64_t* full = fulls + wg * ST;
  uint64_t* empty = empties + wg * ST;

  // the dQ pass: lse log2e and delta of rows xr and xr + 8
  float lse0 = 0.f, lse1 = 0.f, del0 = 0.f, del1 = 0.f;
  if constexpr (!KEYS) {
    const float* ld = s.ld + ((long long)b * a.H + h) * s.TQ * TILE * 2;
    if (xr < a.Sq) lse0 = ld[2 * xr], del0 = ld[2 * xr + 1];
    if (xr + 8 < a.Sq) lse1 = ld[2 * xr + 16], del1 = ld[2 * xr + 17];
  }

  float acc_c[NA];             // dK | dQ
  float acc_d[KEYS ? NA : 1];  // dV
#pragma unroll
  for (int i = 0; i < NA; ++i) acc_c[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (KEYS ? NA : 1); ++i) acc_d[i] = 0.f;
  tc::mbar_wait_bounded(fixed_full, 0);

  // the warpgroup's walk pieces in its ring's order (a tile's OPS NC
  // pieces after its last tile's): p the next to take, freed the first
  // not yet handed back.  Lane 0 of each warp hands a piece back once the
  // warp's products are done, in straight-line code (a predicated
  // arrive): products may be in flight across the waits and hand-backs,
  // never across a branch (ptxas would serialize every wgmma).
  int p = 0, freed = 0;
  auto acquire = [&](int q) { tc::mbar_wait_bounded(full + q % ST, (q / ST) & 1); };
  auto release = [&](int upto) {
    for (; freed < upto; ++freed) tc::mbar_arrive_if(empty + freed % ST, lane == 0);
  };
  // one walk operand's NC transposed pieces into acc, each a commit group
  auto walk_grads = [&](float (&acc)[NA], const uint32_t (&fb)[W / 8][4],
                        const uint32_t (&fs)[W / 8][4]) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acquire(p);
      const uint32_t walk = ring_addr + (p % ST) * PIECE;
      tc::wgmma_fence();
      if (c == 0) tf32_grads<D, W, 0>(acc, fb, fs, walk);
      if (c == 1) tf32_grads<D, W, 1>(acc, fb, fs, walk);
      if (c == 2) tf32_grads<D, W, 2>(acc, fb, fs, walk);
      if (c == 3) tf32_grads<D, W, 3>(acc, fb, fs, walk);
      tc::wgmma_commit();
      tc::wgmma_wait<LAG>();
      ++p;
      release(p - LAG);
    }
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
    release(p);
  };

  for (int it = wg, k = 0; it < total; it += 2, ++k) {
    // the walk tile's first query row (KEYS) or key (dQ pass)
    const int w0 = KEYS ? (tstart + it % ntile) * W : it * W;
    bool live, masked;
    if (KEYS) {  // keys x0.. against queries w0..
      live = x0 < a.Sk &&
             (!a.causal || x0 <= a.q_offset + min(w0 + W, a.Sq) - 1);
      masked = x0 + R - 1 >= a.Sk || w0 + W > a.Sq ||
               (a.causal && x0 + R - 1 > a.q_offset + w0);
    } else {  // queries x0.. against keys w0..
      live = x0 < a.Sq &&
             (!a.causal || w0 <= a.q_offset + min(x0 + R, a.Sq) - 1);
      masked = x0 + R - 1 >= a.Sq || w0 + W > a.Sk ||
               (a.causal && w0 + W - 1 > a.q_offset + x0);
    }
    const float* lt = lds + wg * 2 * W;
    if (!live) {  // a tile past the edge: its pieces handed back unread
      for (int j = 0; j < OPS * NC; ++j) {
        acquire(p);
        ++p;
        release(p);
      }
      if constexpr (KEYS) {
        tc::mbar_wait_bounded(ld_full + wg, k & 1);
        tc::mbar_arrive_if(ld_empty + wg, lane == 0);
      }
      continue;
    }

    // x1 = A C^T, x2 = B D^T (S^T and dP^T | S and dP)
    float x1[NS], x2[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) x1[i] = x2[i] = 0.f;
#pragma unroll
    for (int op = 0; op < 2; ++op)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acquire(p);
        const uint32_t walk = ring_addr + (p % ST) * PIECE;
        tc::wgmma_fence();
        if (op == 0)
          tf32_scores<D, W>(x1, fa_addr + c * FIXED, walk, c);
        else
          tf32_scores<D, W>(x2, fb_addr + c * FIXED, walk, c);
        tc::wgmma_commit();
        tc::wgmma_wait<LAG>();
        ++p;
        release(p - LAG);
      }
    tc::wgmma_wait<0>();
    tc::fence_regs(x1);
    tc::fence_regs(x2);
    release(p);

    // P = exp2(x1 scale log2e - lse log2e) under the mask, dS = P (x2 -
    // delta) (the scale is applied to dK and dQ as they are written):
    // x[4j + e] is fixed row g (+8 for e >= 2) of the warp, walk row 8j +
    // 2t + (e & 1) of the tile.  Instantiated with and without the mask.
    if constexpr (KEYS) tc::mbar_wait_bounded(ld_full + wg, k & 1);
    auto elementwise = [&](auto mask) {
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int hi = (i >> 1) & 1;
        const int cl = (i >> 2) * 8 + 2 * t;  // walk rows cl, cl + 1
        float l2[2], dl[2];
        if constexpr (KEYS) {
          const float4 v = *reinterpret_cast<const float4*>(lt + 2 * cl);
          l2[0] = v.x, dl[0] = v.y, l2[1] = v.z, dl[1] = v.w;
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
          const float pv = exp2f(e);
          x1[i + u] = pv;
          x2[i + u] = pv * (x2[i + u] - dl[u]);
        }
      }
    };
    if (masked)
      elementwise(std::true_type{});
    else
      elementwise(std::false_type{});
    if constexpr (KEYS) {
      __syncwarp();
      tc::mbar_arrive_if(ld_empty + wg, lane == 0);
    }

    // dV += P^T dO (KEYS), then dK += dS^T Q | dQ += dS K: RS products,
    // each piece one head-dim chunk of the gradient.  The A operand of one
    // stays in registers until its products are done, so dS is split only
    // after dV's products have completed.
    if constexpr (KEYS) {
      uint32_t pb[W / 8][4], ps[W / 8][4];
      tf32_to_a<W>(x1, pb, ps);
      walk_grads(acc_d, pb, ps);
      tc::fence_regs(x2);
    }
    uint32_t db[W / 8][4], ds[W / 8][4];
    tf32_to_a<W>(x2, db, ds);
    walk_grads(acc_c, db, ds);
  }

  // warpgroup 1's partial gradients into warpgroup 0's, through the ring
  // (its pieces all taken and every product done: the two warpgroups
  // meet first)
  float* xs = reinterpret_cast<float*>(rings) + (tid & 127);
  tc::fence_proxy_async();
  tc::named_barrier(1, 256);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < NA; ++i) xs[i * 128] = acc_c[i];
    if constexpr (KEYS)
#pragma unroll
      for (int i = 0; i < NA; ++i) xs[(NA + i) * 128] = acc_d[i];
  }
  tc::named_barrier(1, 256);
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < NA; ++i) acc_c[i] += xs[i * 128];
  if constexpr (KEYS)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc_d[i] += xs[(NA + i) * 128];

  // write each row once (a walk that was empty writes zeros)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int x = xr + half * 8;
    if (x >= nrows) continue;
    float* oc;
    float* od = nullptr;
    if (KEYS) {
      const long long row = ((long long)b * a.Sk + x) * a.Hkv + hk;
      oc = static_cast<float*>(a.dk) + row * D;
      od = static_cast<float*>(a.dv) + row * D;
    } else {
      const long long row = ((long long)b * a.Sq + x) * a.H + h;
      oc = static_cast<float*>(a.dq) + row * D;
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<float2*>(oc + i * 8 + 2 * t) =
          make_float2(acc_c[4 * i + 2 * half] * a.scale,
                      acc_c[4 * i + 2 * half + 1] * a.scale);
      if constexpr (KEYS)
        *reinterpret_cast<float2*>(od + i * 8 + 2 * t) =
            make_float2(acc_d[4 * i + 2 * half], acc_d[4 * i + 2 * half + 1]);
    }
  }
}

template <int D, bool KEYS>
int launch_tf32_pass(const Args& a, const Scratch& s, int batch,
                     cudaStream_t stream) {
  using Cf = TfCfg<D, KEYS>;
  auto* kernel = fa_bwd_tf32<D, KEYS>;
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cf::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(batch * (KEYS ? a.Hkv : a.H), KEYS ? s.TK : s.TQ);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, Cf::THREADS, Cf::SMEM, stream>>>(a, s);
  return (int)cudaGetLastError();
}

// the pre-pass, then the dQ pass, then the dK/dV pass
template <int D>
int launch_tf32(const Args& a, int batch, cudaStream_t stream) {
  Scratch s;
  tf_scratch(batch, a.Sq, a.Sk, a.H, a.Hkv, D, a.delta, &s);
  const long long jobs =
      2LL * batch * a.H * s.TQ + 2LL * batch * a.Hkv * s.TK;
  if (jobs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fa_bwd_prep<D><<<(unsigned)jobs, 256, 0, stream>>>(a, s, batch);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  e = launch_tf32_pass<D, false>(a, s, batch, stream);
  if (e != 0) return e;
  return launch_tf32_pass<D, true>(a, s, batch, stream);
}

// A check of the tf32 wgmma the float32 route builds on: one warpgroup
// multiplies A (64 x 8, row-major) by B (8 x 32, given as 32 rows of 8 k)
// once as an SS product from 128-byte swizzled K-major tiles and once as an
// RS product with A in registers in the tf32 fragment layout (tc.cuh),
// each operand word passed as it is: d_ss and d_rs (64 x 32, row-major).
__global__ void __launch_bounds__(128) tf32_probe(const float* A,
                                                  const float* B,
                                                  float* d_ss, float* d_rs) {
  __shared__ __align__(1024) float sa[64 * 32];
  __shared__ __align__(1024) float sb[32 * 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 64 * 32; i += 128) {
    const int r = i / 32, f = i % 32;
    sa[r * 32 + (((f >> 2) ^ (r & 7)) << 2) + (f & 3)] = f < 8 ? A[r * 8 + f] : 0.f;
  }
  for (int i = tid; i < 32 * 32; i += 128) {
    const int r = i / 32, f = i % 32;
    sb[r * 32 + (((f >> 2) ^ (r & 7)) << 2) + (f & 3)] = f < 8 ? B[r * 8 + f] : 0.f;
  }
  tc::fence_proxy_async();
  __syncthreads();
  float d[16], e[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = e[i] = 0.f;
  const int r0 = warp * 16 + g;
  const uint32_t a[4] = {__float_as_uint(A[r0 * 8 + t]), __float_as_uint(A[(r0 + 8) * 8 + t]),
                         __float_as_uint(A[r0 * 8 + t + 4]),
                         __float_as_uint(A[(r0 + 8) * 8 + t + 4])};
  const uint64_t db = tc::desc(tc::smem_u32(sb), 16, 1024, 128);
  tc::wgmma_fence();
  tc::wgmma_tf32_ss<32>(d, tc::desc(tc::smem_u32(sa), 16, 1024, 128), db, 0);
  tc::wgmma_tf32_rs<32, 0>(e, a, db);
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
  tc::fence_regs(d);
  tc::fence_regs(e);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = r0 + ((i >> 1) & 1) * 8, col = (i >> 2) * 8 + 2 * t + (i & 1);
    d_ss[row * 32 + col] = d[i];
    d_rs[row * 32 + col] = e[i];
  }
}

int launch_tf32_d(int D, const Args& a, int batch, cudaStream_t s) {
  switch (D) {
    case 16: return launch_tf32<16>(a, batch, s);
    case 32: return launch_tf32<32>(a, batch, s);
    case 64: return launch_tf32<64>(a, batch, s);
    case 80: return launch_tf32<80>(a, batch, s);
    case 128: return launch_tf32<128>(a, batch, s);
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
  static constexpr int REGS = 232;
  static constexpr int PRODUCER_REGS = 40;
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
  // (D, rows, heads, batch), boxes of SW / 2 columns by box rows
  auto map = [&](CUtensorMap* t, const void* p, int rows, int heads,
                 long long st, long long sb, int box) {
    return tc::make_map(t, true, p, {D, rows, heads, batch},
                        {st * 2, 2LL * D, sb * 2}, {SW / 2, box, 1, 1}, SW);
  };
  const bool ok =
      KEYS ? map(&m.a, a.k, a.Sk, a.Hkv, a.skt, a.skb, R) &&
                 map(&m.b, a.v, a.Sk, a.Hkv, a.svt, a.svb, R) &&
                 map(&m.c, a.q, a.Sq, a.H, a.sqt, a.sqb, W) &&
                 map(&m.d, a.dout, a.Sq, a.H, a.sdt, a.sdb, W)
           : map(&m.a, a.q, a.Sq, a.H, a.sqt, a.sqb, R) &&
                 map(&m.b, a.dout, a.Sq, a.H, a.sdt, a.sdb, R) &&
                 map(&m.c, a.k, a.Sk, a.Hkv, a.skt, a.skb, W) &&
                 map(&m.d, a.v, a.Sk, a.Hkv, a.svt, a.svb, W);
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

// fixed rows, walk rows of the dK/dV pass, the rows of the unit that
// skips a tile (a consumer warpgroup) and walk rows of the dQ pass, of
// each route
template <int D>
void geometry(int dtype, int* out) {
  if (dtype == 0) {
    out[0] = TfCfg<D, true>::R;
    out[1] = TfCfg<D, true>::W;
    out[2] = 64;
    out[3] = TfCfg<D, false>::W;
  } else {
    out[0] = WgCfg<D>::R;
    out[1] = WgCfg<D>::W;
    out[2] = 64;
    out[3] = WgCfg<D>::W;
  }
}

}  // namespace

// dtype: 0 float32 (3xTF32), 1 bfloat16, for q, k, v, out, dout, dq, dk
// and dv.  Strides are in elements; each of q, k, v, out and dout has a
// head stride of D and unit feature stride, and every base pointer and
// batch or sequence stride of q, k, v, out and dout is 16-byte aligned;
// lse (B,Sq,H) float32, dq (B,Sq,H,D) and dk, dv (B,Sk,Hkv,D) are
// contiguous.  delta is the route's float32 scratch, 256-byte aligned, of
// repro_flash_attention_backward_scratch floats: bf16, delta (B,Sq,H),
// which the dQ pass writes; float32, the pre-pass's images (delta among
// them).  Launches two kernels on the stream (bf16) or three (float32:
// the pre-pass first); returns the cudaError_t of the launches.
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
  return dtype == 0 ? launch_tf32_d(D, a, batch, s)
                    : launch_wg_d(D, a, batch, s);
}

// tf32_probe on the stream (A, B and the outputs on the card)
extern "C" int repro_flash_attention_backward_tf32_probe(const float* A,
                                                         const float* B,
                                                         float* d_ss,
                                                         float* d_rs,
                                                         void* stream) {
  tf32_probe<<<1, 128, 0, (cudaStream_t)stream>>>(A, B, d_ss, d_rs);
  return (int)cudaGetLastError();
}

// The floats of scratch route dtype needs for these shapes (the wrapper
// allocates them and passes them as delta), in *floats.
extern "C" int repro_flash_attention_backward_scratch(int dtype, int batch,
                                                      int Sq, int Sk, int H,
                                                      int Hkv, int D,
                                                      long long* floats) {
  if ((dtype != 0 && dtype != 1) || batch < 1 || Sq < 1 || Sk < 1 || H < 1 ||
      Hkv < 1 || (D != 16 && D != 32 && D != 64 && D != 80 && D != 128))
    return (int)cudaErrorInvalidValue;
  *floats = dtype == 0 ? tf_scratch(batch, Sq, Sk, H, Hkv, D, nullptr, nullptr)
                       : (long long)batch * Sq * H;
  return 0;
}

// The launch geometry of route dtype at head dim D, which
// flash_attention.backward_walks and backward_tiles mirror: out[0] the
// fixed tile's rows, out[1] the dK/dV pass's walk tile's, out[2] the rows
// of the unit that skips a walk tile (a consumer warpgroup, in both
// routes), out[3] the dQ pass's walk tile's.
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
