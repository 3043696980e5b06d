// FlashAttention forward with online softmax over q (B,Sq,H,D) and
// k, v (B,Sk,Hkv,D), grouped-query heads (q head h reads kv head
// h / (H/Hkv)), optional causal masking at an offset q_offset (query row
// i sits at position q_offset + i), padded tails masked.  q, k and v are
// float32 or bfloat16; out is written in q's type, and the log-sum-exp
// lse (B,Sq,H) in float32 for the recomputing backward.
//
// Replaces: the Pallas TPU kernel flash_attention_pallas / _fa_kernel in
// src/repro/kernels/flash_attention.py:22-77, and the forward of
// src/repro/kernels/flash_vjp.py (_fwd_impl), which is the route the
// model takes beyond 1024 positions.  The Pallas kernel has no q_offset,
// so it could not serve the prefill into a cache; this kernel takes one.
// Masked logits are the finite -1e30 of flash_vjp.py, so a fully masked
// tile gives no NaN.
//
// What bounds it on an H100: the two products, over the visible (query,
// key) pairs.  At the long-context prefill (q (4,4096,16,128) against a
// 4113-slot cache, causal) they come to 274.9 GFLOP against about
// 100 MB of q, k, v and out: 0.278 ms at the bf16 tensor-core peak
// (989 TF/s), 1.666 ms in float32 as 3xTF32 (495/3 TF/s).
//
// Common to both routes: one CTA per (q tile, head, batch), q tiles
// issued heaviest first; the CTA walks key tiles only up to the causal
// edge q_offset + (last row of the tile) + 1, so a cache's unwritten tail
// is never read, and a warp (or warpgroup) whose rows all lie before a
// tile skips it.  Q is staged once; K and V tiles are double-buffered, the
// next tile in flight while this one computes.  K and V are read through
// their batch and sequence strides, by kv head (never repeated).  Scores
// stay in the product's accumulator registers: the mask is applied there
// in fragment coordinates (only on tiles that cross the causal edge or
// Sk), the online softmax runs in base 2 with quad shuffles for the row
// max and sum, and P becomes the A operand of P V without passing through
// shared memory.
//
// bf16 route, on wgmma: two consumer warpgroups of 64 q rows (BQ = 128)
// and one producer warp, 128-key tiles.  The producer issues every copy
// as TMA boxes of 64 columns (fewer at D < 64) written with the 128-byte
// swizzle (64, 32 at D = 32, 16), into a two-stage ring of K and V tiles
// guarded by mbarriers (full: the bytes landed; empty: all eight consumer
// warps are done), so the warpgroups never meet at a CTA barrier.  S =
// Q K^T is an SS wgmma (both K-major); P, rounded to bf16, is the
// register A operand of an RS wgmma against V read MN-major.  l sums the
// unrounded P.  About 161 KB of shared memory at D = 128: one CTA an SM.
//
// Head dim 80 (zamba2-2.7b's attention, which runs float32 and so takes
// the mma.sync route beyond 1024 slots).  float32: 80 columns are 20
// 16-byte chunks and 10 output slices of 8, so the template takes it as
// it is: 64-key tiles, (64 + 4 * 64) rows of 84 floats = 107,520 bytes,
// still two CTAs an SM; a row pitch of 84 floats (20 banks mod 32) keeps
// every fragment load free of bank conflicts, as 68 and 132 do.  bf16:
// 80 columns are not a whole number of 64-column 128-byte-swizzled
// boxes, so the tiles are padded to 128 columns (DP), two boxes a row:
// the tensor maps keep D = 80, and TMA fills the columns past 80 with
// zeros (the bytes still count toward the mbarrier's transaction).  Q K^T
// runs only the 5 k16 steps that hold data (exact); P V runs at N = 128
// against the zero columns, and the epilogue writes the first 80.  The
// padding costs 60% more P V products and the shared memory of D = 128
// (one CTA an SM), and keeps one layout, one descriptor rule and one
// product shape (m64n128k16) for both head sizes; an m64n80 product
// would read 80 columns across the boundary of two swizzle atoms, which
// no other route here exercises.
//
// float32 route, on 3xTF32 mma.sync (m16n8k8): four warps of 16 q rows
// (BQ = 64), 64-key tiles (32 at D = 128, so two CTAs fit on an SM),
// staged by 16-byte cp.async.  Rows are padded by 4 floats, so every
// fragment load is free of bank conflicts.  Each operand is split into
// big and small halves, each rounded to TF32 (about 22 bits of the
// operand together), as it leaves shared memory (Q reloaded for
// each tile rather than held).  P passes from the S accumulators to the
// A fragments of P V in place: A's k slots t and t+4 are taken as keys 2t
// and 2t+1, and V's B fragment is read with the same order.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// Which 16-byte chunk (row, c) of a rows x C-chunk tile the idx-th copy
// moves: eight rows of one chunk per quarter warp (128 contiguous bytes
// in either shared layout), a warp's four chunks of a row contiguous in
// global memory.
template <int C>
__device__ __forceinline__ void chunk_of(int idx, int& row, int& c) {
  const int q = idx >> 3;
  c = q % C;
  row = (q / C) * 8 + (idx & 7);
}

// Causal edge of the CTA's rows and the number of key tiles it walks.
__device__ __forceinline__ int kv_end(const Args& a, int q0, int qrows) {
  return a.causal ? min(a.Sk, a.q_offset + q0 + qrows) : a.Sk;
}

// ------------------------------------------------------------ f32 route
template <int D>
struct F32Cfg {
  static constexpr int THREADS = 128;
  static constexpr int BQ = 64;
  static constexpr int BK = D == 128 ? 32 : 64;
  static constexpr int LD = D + 4;  // floats per staged row
  static constexpr int C = D / 4;   // 16-byte chunks per row
  static constexpr size_t SMEM = (size_t)(BQ + 4 * BK) * LD * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(128, 2) fa_f32(Args a) {
  using Cfg = F32Cfg<D>;
  constexpr int BQ = Cfg::BQ, BK = Cfg::BK, LD = Cfg::LD, C = Cfg::C;
  constexpr int NJ = BK / 8;  // score slices of 8 keys
  constexpr int NO = D / 8;   // output slices of 8 columns
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                  // BQ x LD
  float* Ks = Qs + BQ * LD;         // 2 stages of BK x LD
  float* Vs = Ks + 2 * BK * LD;     // 2 stages of BK x LD

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * BQ;
  const int qrows = min(BQ, a.Sq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const float* q = static_cast<const float*>(a.q) + b * a.sqb + (long long)h * D;
  const float* k = static_cast<const float*>(a.k) + b * a.skb + (long long)hk * D;
  const float* v = static_cast<const float*>(a.v) + b * a.svb + (long long)hk * D;

  for (int i = tid; i < BQ * C; i += Cfg::THREADS) {
    int r, c;
    chunk_of<C>(i, r, c);
    const bool ok = r < qrows;
    tc::cp_async16(Qs + r * LD + c * 4, ok ? q + (q0 + r) * a.sqt + c * 4 : q, ok);
  }
  const int end = kv_end(a, q0, qrows);
  const int ntiles = (end + BK - 1) / BK;
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * BK;
    float* kd = Ks + stage * BK * LD;
    float* vd = Vs + stage * BK * LD;
    for (int i = tid; i < BK * C; i += Cfg::THREADS) {
      int r, c;
      chunk_of<C>(i, r, c);
      const bool ok = k0 + r < a.Sk;
      tc::cp_async16(kd + r * LD + c * 4, ok ? k + (k0 + r) * a.skt + c * 4 : k, ok);
      tc::cp_async16(vd + r * LD + c * 4, ok ? v + (k0 + r) * a.svt + c * 4 : v, ok);
    }
  };
  load_kv(0, 0);
  tc::cp_async_commit();

  const int r0 = warp * 16;            // this warp's rows in the tile
  const int rowA = q0 + r0 + g;        // rows of c0/c1 and c2/c3
  const float scale2 = a.scale * LOG2E;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1, (it + 1) & 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * BK;
    const float* Kt = Ks + (it & 1) * BK * LD;
    const float* Vt = Vs + (it & 1) * BK * LD;
    // a warp whose rows all lie before the tile's first key skips it
    const bool live = !a.causal || k0 <= a.q_offset + q0 + r0 + 15;
    if (live) {
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float* qa = Qs + (r0 + g) * LD + kk * 8 + t;
        uint32_t ab[4], as[4];
        tc::split(qa[0], ab[0], as[0]);
        tc::split(qa[8 * LD], ab[1], as[1]);
        tc::split(qa[4], ab[2], as[2]);
        tc::split(qa[8 * LD + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float* kb = Kt + (j * 8 + g) * LD + kk * 8 + t;
          uint32_t bb[2], bs[2];
          tc::split(kb[0], bb[0], bs[0]);
          tc::split(kb[4], bb[1], bs[1]);
          tc::mma_3xtf32(s[j], ab, as, bb, bs);
        }
      }
      // mask (only where the tile crosses Sk or the causal edge) and
      // scale into base 2
      const bool masked = k0 + BK > a.Sk ||
                          (a.causal && k0 + BK - 1 > a.q_offset + q0 + r0);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[j][c] * scale2;
          if (masked) {
            const int key = k0 + j * 8 + 2 * t + (c & 1);
            const int qpos = a.q_offset + rowA + (c >> 1) * 8;
            if (key >= a.Sk || (a.causal && key > qpos)) x = NEG_INF;
          }
          s[j][c] = x;
          if (c < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp2f(s[j][c] - (c < 2 ? mx0 : mx1));
          s[j][c] = p;
          if (c < 2) sum0 += p; else sum1 += p;
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
      // o += P V: slot t holds key 2t, slot t+4 key 2t+1
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t pb[4], ps[4];
        tc::split(s[j][0], pb[0], ps[0]);
        tc::split(s[j][2], pb[1], ps[1]);
        tc::split(s[j][1], pb[2], ps[2]);
        tc::split(s[j][3], pb[3], ps[3]);
        const float* vb = Vt + (j * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t bb[2], bs[2];
          tc::split(vb[n * 8], bb[0], bs[0]);
          tc::split(vb[LD + n * 8], bb[1], bs[1]);
          tc::mma_3xtf32(o[n], pb, ps, bb, bs);
        }
      }
    }
    __syncthreads();  // the next iteration's copy reuses this stage
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + half * 8;
    if (r >= qrows) continue;
    const long long row = ((long long)b * a.Sq + q0 + r) * a.H + h;
    const float lsafe = fmaxf(half ? l1 : l0, 1e-30f);
    const float inv = 1.f / lsafe;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(out + row * D + n * 8 + 2 * t) =
          make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    if (t == 0) a.lse[row] = (half ? m1 : m0) * LN2 + logf(lsafe);
  }
}

// ----------------------------------------------------------- bf16 route
template <int D>
struct Bf16Cfg {
  static constexpr int THREADS = 288;  // two consumer warpgroups + a producer warp
  static constexpr int BQ = 128;
  static constexpr int BK = 128;
  static constexpr int STAGES = 2;
  static constexpr int SW = D >= 64 ? 128 : 2 * D;  // swizzled row, bytes
  static constexpr int COLS = SW / 2;               // columns of one box
  static constexpr int DP = (D + COLS - 1) / COLS * COLS;  // padded columns
  static constexpr int TILE = BK * DP * 2;  // bytes of one K or V tile
  // tiles, barriers, and room to align the tiles to 1024 bytes
  static constexpr size_t SMEM = (size_t)BQ * DP * 2 +
                                 (size_t)STAGES * 2 * TILE +
                                 8 * (1 + 2 * STAGES) + 1024;
};

struct Maps {  // 4-D tensor maps (D, rows, heads, batch) of q, k and v
  CUtensorMap q, k, v;
};

template <int D>
__global__ void __launch_bounds__(288, 1)
    fa_bf16(const __grid_constant__ Maps maps, Args a) {
  using Cfg = Bf16Cfg<D>;
  constexpr int BQ = Cfg::BQ, BK = Cfg::BK, ST = Cfg::STAGES;
  constexpr int SW = Cfg::SW, COLS = Cfg::COLS, DP = Cfg::DP;
  constexpr int NB = DP / COLS;
  constexpr int NS = BK / 2;  // score accumulators a thread holds
  constexpr int NO = DP / 2;  // output accumulators (padded columns too)
  extern __shared__ __align__(128) unsigned char bsm[];
  // a tile of R rows is NB boxes of R rows x SW bytes (columns
  // COLS b .. COLS b + COLS - 1), each as TMA writes it with the SW-byte
  // swizzle, box b at byte b * R * SW; every tile starts on 1024 bytes
  unsigned char* Qs = bsm + ((1024 - (tc::smem_u32(bsm) & 1023)) & 1023);
  unsigned char* Ks = Qs + BQ * DP * 2;            // ST tiles of BK rows
  unsigned char* Vs = Ks + ST * Cfg::TILE;         // ST tiles of BK rows
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * Cfg::TILE);
  uint64_t* full = q_full + 1;                     // K and V of a stage landed
  uint64_t* empty = full + ST;                     // every consumer warp is done

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * BQ;
  const int qrows = min(BQ, a.Sq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (kv_end(a, q0, qrows) + BK - 1) / BK;

  if (tid == 0) {
    tc::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      tc::mbar_init(full + s, 1);
      tc::mbar_init(empty + s, 8);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer: one thread issues every TMA copy
    if (lane != 0) return;
    tc::mbar_expect_tx(q_full, BQ * DP * 2);
    for (int c = 0; c < NB; ++c)
      tc::tma_load_4d(Qs + c * BQ * SW, &maps.q, q_full, c * COLS, q0, h, b);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % ST, n = it / ST;
      if (n > 0) tc::mbar_wait(empty + s, (n - 1) & 1);
      tc::mbar_expect_tx(full + s, 2 * Cfg::TILE);
      for (int c = 0; c < NB; ++c) {
        tc::tma_load_4d(Ks + s * Cfg::TILE + c * BK * SW, &maps.k, full + s,
                        c * COLS, it * BK, hk, b);
        tc::tma_load_4d(Vs + s * Cfg::TILE + c * BK * SW, &maps.v, full + s,
                        c * COLS, it * BK, hk, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = wg * 64;
  const int rowA = q0 + wrow0 + (warp & 3) * 16 + g;
  const float scale2 = a.scale * LOG2E;
  const uint32_t q_addr = tc::smem_u32(Qs) + wrow0 * SW;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  tc::mbar_wait(q_full, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % ST, k0 = it * BK;
    tc::mbar_wait(full + s, (it / ST) & 1);
    const uint32_t k_addr = tc::smem_u32(Ks + s * Cfg::TILE);
    const uint32_t v_addr = tc::smem_u32(Vs + s * Cfg::TILE);
    // a warpgroup whose rows all lie before the tile's first key skips it
    const bool live = !a.causal || k0 <= a.q_offset + q0 + wrow0 + 63;
    if (live) {
      float sc[NS];
      tc::wgmma_fence();
      // k16 step kk: box kk / (SW/32), 32 bytes into its rows; only the
      // steps over the D real columns
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk / (SW / 32), off = (kk % (SW / 32)) * 32;
        tc::wgmma_ss_m64n128k16(
            sc, tc::desc(q_addr + box * BQ * SW + off, 16, 8 * SW, SW),
            tc::desc(k_addr + box * BK * SW + off, 16, 8 * SW, SW), kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(sc);

      // mask (only where the tile crosses Sk or the causal edge) and
      // scale into base 2; sc[4i + e]: row g (+8 for e >= 2), key
      // k0 + 8i + 2t + (e & 1)
      const bool masked = k0 + BK > a.Sk ||
                          (a.causal && k0 + BK - 1 > a.q_offset + q0 + wrow0);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = sc[i] * scale2;
        if (masked) {
          const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
          const int qpos = a.q_offset + rowA + ((i >> 1) & 1) * 8;
          if (key >= a.Sk || (a.causal && key > qpos)) x = NEG_INF;
        }
        sc[i] = x;
        if ((i & 2) == 0) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const bool lo = (i & 2) == 0;
        const float e0 = exp2f(sc[i] - (lo ? mx0 : mx1));
        const float e1 = exp2f(sc[i + 1] - (lo ? mx0 : mx1));
        if (lo) sum0 += e0 + e1; else sum1 += e0 + e1;
        // accumulator pair i/2 of slice i/4 -> A register ((i/2) % 4) of
        // k16 step i/8: a0 (g, 2t), a1 (g+8, 2t), a2 (g, 2t+8), a3 (g+8, 2t+8)
        p[i >> 3][(i >> 1) & 3] = tc::pack_bf16(e0, e1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? al1 : al0;

      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // V MN-major: 16 keys a step (two atoms), boxes BK * SW apart
        const uint64_t dv =
            tc::desc(v_addr + kk * 16 * SW, BK * SW, 8 * SW, SW);
        tc::wgmma_rs<DP>(o, p[kk], dv);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(empty + s);  // this warp is done with the stage
  }

  using bf = __nv_bfloat16;
  bf* out = static_cast<bf*>(a.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rowA - q0 + half * 8;
    if (r >= qrows) continue;
    const long long row = ((long long)b * a.Sq + q0 + r) * a.H + h;
    const float lsafe = fmaxf(half ? l1 : l0, 1e-30f);
    const float inv = 1.f / lsafe;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)  // the real columns only
      *reinterpret_cast<uint32_t*>(out + row * D + i * 8 + 2 * t) =
          tc::pack_bf16(o[4 * i + 2 * half] * inv, o[4 * i + 2 * half + 1] * inv);
    if (t == 0) a.lse[row] = (half ? m1 : m0) * LN2 + logf(lsafe);
  }
}

template <int D>
int launch(int dtype, const Args& a, int batch, cudaStream_t stream) {
  auto* kernel32 = fa_f32<D>;
  auto* kernel16 = fa_bf16<D>;
  const size_t smem = dtype == 0 ? F32Cfg<D>::SMEM : Bf16Cfg<D>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dtype == 0 ? reinterpret_cast<const void*>(kernel32)
                   : reinterpret_cast<const void*>(kernel16),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (dtype == 0) {
    dim3 grid((a.Sq + F32Cfg<D>::BQ - 1) / F32Cfg<D>::BQ, a.H, batch);
    kernel32<<<grid, F32Cfg<D>::THREADS, smem, stream>>>(a);
  } else {
    Maps maps;
    constexpr int SW = Bf16Cfg<D>::SW;
    // (D, rows, heads, batch), boxes of SW / 2 columns by box rows
    auto map = [&](CUtensorMap* m, const void* p, int rows, int heads,
                   long long st, long long sb, int box) {
      return tc::make_map(m, true, p, {D, rows, heads, batch},
                          {st * 2, 2LL * D, sb * 2}, {SW / 2, box, 1, 1}, SW);
    };
    if (!map(&maps.q, a.q, a.Sq, a.H, a.sqt, a.sqb, Bf16Cfg<D>::BQ) ||
        !map(&maps.k, a.k, a.Sk, a.Hkv, a.skt, a.skb, Bf16Cfg<D>::BK) ||
        !map(&maps.v, a.v, a.Sk, a.Hkv, a.svt, a.svb, Bf16Cfg<D>::BK))
      return (int)cudaErrorInvalidValue;
    dim3 grid((a.Sq + Bf16Cfg<D>::BQ - 1) / Bf16Cfg<D>::BQ, a.H, batch);
    kernel16<<<grid, Bf16Cfg<D>::THREADS, smem, stream>>>(maps, a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (3xTF32 mma.sync route), 1 bfloat16 (wgmma route),
// for q, k, v and out.  Strides are in elements; q's head stride is D
// and k's and v's D, each with unit feature stride, and every base
// pointer and batch or sequence stride 16-byte aligned; out (B,Sq,H,D)
// and lse (B,Sq,H) are contiguous.  Returns the cudaError_t of the
// launch.
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
  const int item = dtype == 0 ? 4 : 2;
  const long long strides[6] = {sqb, sqt, skb, skt, svb, svt};
  for (long long s : strides)
    if ((s * item) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  Args a{q, k, v, out, lse, Sq, Sk, H, Hkv, q_offset, causal ? 1 : 0, scale,
         sqb, sqt, skb, skt, svb, svt};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(dtype, a, batch, s);
    case 32: return launch<32>(dtype, a, batch, s);
    case 64: return launch<64>(dtype, a, batch, s);
    case 80: return launch<80>(dtype, a, batch, s);
    case 128: return launch<128>(dtype, a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}
