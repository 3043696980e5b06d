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
// 0.039 ms) bound it.  What a design must keep short is the latency of
// its loads and its serial sections, and the work it repeats per head.
//
// What the design does about it: the sequential part is only the walk
// over block boundaries, elementwise over P x N, and every product runs
// on the tensor cores (mma.sync.m16n8k8 TF32 through csrc/tc.cuh: each
// float32 operand as two TF32 halves, 3xTF32; a bf16 operand is exact in
// TF32 and drops its cross term).  Work is cut into items: one batch, one
// 64-step block and a slice of up to SLICE consecutive heads of one group
// (a group of rep = H / G heads in ceil(rep / SLICE) slices of nearly
// equal size; a slice never crosses a group).  Four or five launches, no
// atomics:
//   1. local_kernel and 3. grad_kernel are persistent: one CTA an SM (the
//      grid the device's SM count, or the item count if smaller), CTA c
//      taking items c, c + grid, ..  in order, so the result does not
//      depend on scheduling.  Eight consumer warps compute; a ninth, the
//      producer, fills a ring of stages (two for the gradient pass, four
//      for the local pass) with each head's tiles by TMA (a box a tile,
//      completing on the stage's mbarrier), so a head's loads, and the
//      next item's first head's, overlap the heads before's products.  A
//      box is a row of 68 or 72 values by 64 steps or rows: the values
//      past P, N or T arrive as zeros, which pads the rows (fragment loads
//      free of most bank conflicts) and zeroes the tail block's missing
//      steps.  B, C and dt of an item are staged once for its heads (dt
//      loaded into the producer's registers while the item before
//      finishes), and the heads' cumsums run one thread a head, in
//      parallel, each sequential within its head (neighbouring la's stay
//      consistent, and their differences are the decays L; a tree scan
//      measured 2-4 times further from a float64 reference in dx and ddt).
//      The local pass: each head's own share of the state at the block's
//      end, sum_s w_s x_s B_s^T, and of the adjoint at its start, sum_t
//      exp(la_t) dy_t C_t^T (two P x N products over the block's steps,
//      their k-steps taken in turns), and the block's decay exp(la_last);
//   2. walk_kernel, a thread per (direction, batch, head, state entry):
//      h_in at every boundary walking forward from h0, G_out at every
//      boundary walking backward from dh, in place in two float32
//      (B, H, T/64 + 1, P, N) buffers (170 MB at zamba2's microbatch);
//   3. the gradient pass: per item, each warp's 16 x 32 tile of C B^T is
//      formed once and kept in registers for the slice's heads; per head,
//      dy x^T, then P1 = (C B^T) o L o dt and P2 = (dy x^T) o L o dt into
//      shared memory (a barrier of the consumers), then dx, and the head's
//      shares of dB and dC added in head order to each warp's registers,
//      each from two products whose k-steps are taken in turns (two
//      independent chains for the scheduler); one float32 partial of dB
//      and dC a slice is written.  The per-head epilogue (dla, da, ddt, the block's shares of
//      dA and dD) runs on one warp, taken in turn (its small arrays
//      double-buffered).  Each product has a fresh accumulator over at
//      most 64 terms, its 3xTF32 cross terms one of their own;
//   4. group_sum_kernel: dB and dC summed over each group's slices in
//      order (a float32 (B, T, G *
//      slices, N) scratch each);
//   5. head_sum_kernel: dA and dD over the blocks and the batch, in order.
// About 227 KB of shared memory for the float32 gradient pass, one CTA an
// SM.  B and C are read by group, x, B, C and dy through their batch and
// time strides (where rows, strides or bases are not 16-byte aligned,
// which TMA needs, the producer copies value by value, zeros past T).  The
// tail block stops at T: its missing steps get dt = 0 and zero rows, and
// P1, P2 and the adjoint's weights are masked past T besides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int BL = 64;          // steps per block
constexpr int MAX_P = 64;
constexpr int MAX_N = 64;
constexpr int SLICE = 8;        // heads an item takes at most
constexpr int WARPS = 8;        // consumer warps
constexpr int CONSUMERS = 32 * WARPS;
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int LDF = 68;         // padded float32 row: x, dy, B, C, G_out, P2
constexpr int LDQ = 72;         // float32 row of h_in and P1; a bf16 row
constexpr int DS = BL + 1;      // row of a head's per-step arrays
constexpr int WALK_THREADS = 256;
constexpr int SUM_THREADS = 256;
// the epilogue's arrays: rowM [2][BL], colS [4][BL], vpart [2][BL],
// qpart [2][BL], red [3][WARPS]
constexpr int SMALL = 10 * BL + 3 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
// the ring's stages: two for the gradient pass (its stages are 70 KB),
// four for the local pass
template <bool GRAD>
constexpr int STAGES = GRAD ? 2 : 4;
// mbarriers: a ring stage filled and emptied (up to 4 each), an item's B,
// C and dt filled and emptied
constexpr int BAR_FULL = 0, BAR_EMPTY = 4, BAR_BC_FULL = 8,
              BAR_BC_EMPTY = 9, NBAR = 10;

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
  float* dB_part;    // (B, T, G * nsl, N): each slice's share
  float* dC_part;
  void* dB;          // (B, T, G, N), B's type
  void* dC;
  float* dA_part;    // (B, H, nb)
  float* dD_part;    // (B, H, nb)
  float* dA;         // (H,)
  float* dD;         // (H,), may be null
  float* dh0;        // (B, H, P, N), may be null
  int batch, T, H, P, G, N, nb;
  int nsl;     // slices a group
  int items;   // batch * nb * G * nsl
  int vec;     // rows 16-byte aligned: tiles by TMA
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
// p[0] = v0 and, where two, p[1] = v1: one 8-byte (float32) or 4-byte
// (bf16) store where pair (p then lies on such a boundary)
__device__ __forceinline__ void put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
template <typename T>
__device__ __forceinline__ void put_pair(T* p, float v0, float v1, bool two,
                                         bool pair) {
  if (pair && two) {
    put2(p, v0, v1);
  } else {
    put(p, v0);
    if (two) put(p + 1, v1);
  }
}

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

// Shared memory of a pass, byte offsets: B and C of the item (rows of LDT
// values of T), its heads' dt [SLICE][DS], their la, c (the cumsum of dt),
// exp(la), exp(la_last - la), w and dt [6][SLICE][DS]; the ring's two stages
// (x and dy, and for the gradient pass G_out and h_in); for the gradient
// pass P1, P2 and two sets of the epilogue's arrays; the mbarriers
__host__ __device__ constexpr int align128(int n) { return (n + 127) & ~127; }

template <typename T, bool GRAD>
struct Smem {
  static constexpr int LDT = sizeof(T) == 4 ? LDF : LDQ;
  static constexpr int TT = BL * LDT * (int)sizeof(T);   // x, dy, B, C
  static constexpr int TG = MAX_P * LDF * 4;             // G_out
  static constexpr int TH = MAX_P * LDQ * 4;             // h_in
  static constexpr int STAGE = 2 * TT + (GRAD ? TG + TH : 0);
  static constexpr int B_ = 0, C_ = TT, DT = 2 * TT;
  static constexpr int DEC = DT + align128(SLICE * DS * 4);
  static constexpr int RING = DEC + align128(6 * SLICE * DS * 4);
  static constexpr int P1_ = RING + STAGES<GRAD> * STAGE;
  static constexpr int P2_ = P1_ + (GRAD ? BL * LDQ * 4 : 0);
  static constexpr int SM_ = P2_ + (GRAD ? BL * LDF * 4 : 0);
  static constexpr int BAR = SM_ + (GRAD ? align128(2 * SMALL * 4) : 0);
  static constexpr int BYTES = BAR + NBAR * 8;
  static_assert(TT % 128 == 0 && TG % 128 == 0 && TH % 128 == 0,
                "tiles the TMA unit writes start 128-byte aligned");
};
static_assert(Smem<float, true>::BYTES <= 232448,
              "the float32 gradient pass fits an SM's shared memory");

// The tensor maps the TMA copies read (made on the host where the rows
// are 16-byte aligned): x, dy, B and C as (features, heads or groups,
// steps, batch), boxes of a row of LDT values by 64 steps; the states and
// adjoints as (N, P, boundaries, batch x heads), boxes of 68 or 72 by 64.
// A box's values past the tensor (features past P or N, steps past T,
// rows past P) arrive as zeros: the stage's padding and tail.
struct Maps {
  CUtensorMap x, dy, Bm, Cm, states, adj;
};

// An item: batch b, block j, slice gs of group g: heads h0 .. h0 + nh - 1
struct Item {
  int b, j, g, gs, h0, nh;
};

__device__ __forceinline__ Item item_at(const Args& a, int i) {
  Item it;
  const int ns = a.G * a.nsl;
  it.gs = i % ns;
  const int bj = i / ns;
  it.j = bj % a.nb;
  it.b = bj / a.nb;
  it.g = it.gs / a.nsl;
  const int k = it.gs - it.g * a.nsl, rep = a.H / a.G;
  it.h0 = it.g * rep + k * rep / a.nsl;
  it.nh = it.g * rep + (k + 1) * rep / a.nsl - it.h0;
  return it;
}

__device__ __forceinline__ void consumer_sync() {
  tc::named_barrier(1, CONSUMERS);
}

// ---------------------------------------------------------- the producer
// Where the rows are not 16-byte aligned: rows 0 .. nrows - 1 of `width`
// values into dst (row stride ldd) from src (row stride st), zeros past
// row `valid`, value by value by the producer warp's lanes
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ldd, const T* src,
                                          long long st, int valid, int nrows,
                                          int width, int lane) {
  for (int r = lane; r < nrows; r += 32) {
    const T* sr = src + (long long)r * st;
    for (int c = 0; c < width; ++c)
      dst[r * ldd + c] = r < valid ? sr[c] : T(0.f);
  }
}

// The producer warp: for each of the CTA's items in order, the first
// head's tiles into the ring, then the item's dt (loaded ahead), B and C
// (once the consumers are done with the item before's), then the other
// heads' tiles; a stage is filled once the consumers have emptied it.
// Tiles come by TMA, a box a tile from lane 0, completing on the stage's
// mbarrier; where the rows are not 16-byte aligned, value by value.
template <typename T, bool GRAD>
__device__ void produce(const Maps& maps, const Args& a, unsigned char* sm,
                        uint64_t* bar) {
  using L = Smem<T, GRAD>;
  const int lane = threadIdx.x & 31;
  const bool tma = a.vec != 0;
  const int P = a.P, N = a.N;
  // stores of this warp's lanes released to the consumers by lane 0's
  // arrival, which counts the TMA copies' bytes
  auto filled = [&](uint64_t* b, uint32_t bytes) {
    __threadfence_block();
    __syncwarp();
    if (lane == 0) tc::mbar_expect_tx(b, tma ? bytes : 0u);
  };
  uint32_t k = 0, m = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x, ++m) {
    const Item it = item_at(a, i);
    const int t0 = it.j * BL, clen = min(BL, a.T - t0);
    auto head = [&](int hh) {
      constexpr int NS = STAGES<GRAD>;
      const int s = k % NS;
      const uint32_t n = k / NS;
      if (n > 0) tc::mbar_wait(&bar[BAR_EMPTY + s], (n - 1) & 1);
      uint64_t* full = &bar[BAR_FULL + s];
      unsigned char* st = sm + L::RING + s * L::STAGE;
      const int h = it.h0 + hh;
      const long long bh = (long long)it.b * a.H + h;
      if (!tma) {
        copy_rows(reinterpret_cast<T*>(st), L::LDT,
                  static_cast<const T*>(a.x) + it.b * a.sxb + t0 * a.sxt +
                      (long long)h * P,
                  a.sxt, clen, BL, P, lane);
        copy_rows(reinterpret_cast<T*>(st + L::TT), L::LDT,
                  static_cast<const T*>(a.dy) + it.b * a.sdb + t0 * a.sdt +
                      (long long)h * P,
                  a.sdt, clen, BL, P, lane);
        if constexpr (GRAD) {
          const long long PN = (long long)P * N;
          copy_rows(reinterpret_cast<float*>(st + 2 * L::TT), LDF,
                    a.adj + (bh * (a.nb + 1) + it.j + 1) * PN, N, P, P, N,
                    lane);
          copy_rows(reinterpret_cast<float*>(st + 2 * L::TT + L::TG), LDQ,
                    a.states + (bh * (a.nb + 1) + it.j) * PN, N, P, P, N,
                    lane);
        }
      }
      filled(full, L::STAGE);
      if (tma && lane == 0) {
        tc::tma_load_4d(st, &maps.x, full, 0, h, t0, it.b);
        tc::tma_load_4d(st + L::TT, &maps.dy, full, 0, h, t0, it.b);
        if constexpr (GRAD) {
          tc::tma_load_4d(st + 2 * L::TT, &maps.adj, full, 0, 0, it.j + 1,
                          (int)bh);
          tc::tma_load_4d(st + 2 * L::TT + L::TG, &maps.states, full, 0, 0,
                          it.j, (int)bh);
        }
      }
      ++k;
    };
    head(0);
    // the item's dt (zero past T) into registers, all loads in flight,
    // while the consumers finish the item before
    constexpr int NDT = SLICE * BL / 32;
    float dv[NDT];
#pragma unroll
    for (int q = 0; q < NDT; ++q) {
      const int e = lane + 32 * q, t = e / it.nh, hh = e - t * it.nh;
      dv[q] = e < it.nh * BL && t < clen
                  ? a.dt[((long long)it.b * a.T + t0 + t) * a.H + it.h0 + hh]
                  : 0.f;
    }
    if (m > 0) tc::mbar_wait(&bar[BAR_BC_EMPTY], (m - 1) & 1);
    uint64_t* bcf = &bar[BAR_BC_FULL];
    float* dtv = reinterpret_cast<float*>(sm + L::DT);
#pragma unroll
    for (int q = 0; q < NDT; ++q) {
      const int e = lane + 32 * q, t = e / it.nh, hh = e - t * it.nh;
      if (e < it.nh * BL) dtv[hh * DS + t] = dv[q];
    }
    if (!tma) {
      copy_rows(reinterpret_cast<T*>(sm + L::B_), L::LDT,
                static_cast<const T*>(a.Bm) + it.b * a.sbb + t0 * a.sbt +
                    (long long)it.g * N,
                a.sbt, clen, BL, N, lane);
      copy_rows(reinterpret_cast<T*>(sm + L::C_), L::LDT,
                static_cast<const T*>(a.Cm) + it.b * a.scb + t0 * a.sct +
                    (long long)it.g * N,
                a.sct, clen, BL, N, lane);
    }
    filled(bcf, 2 * L::TT);
    if (tma && lane == 0) {
      tc::tma_load_4d(sm + L::B_, &maps.Bm, bcf, 0, it.g, t0, it.b);
      tc::tma_load_4d(sm + L::C_, &maps.Cm, bcf, 0, it.g, t0, it.b);
    }
    for (int hh = 1; hh < it.nh; ++hh) head(hh);
  }
}

// ------------------------------------------------------------- products
template <bool EXACT>
__device__ __forceinline__ void frag(float v, uint32_t& big, uint32_t& small) {
  if constexpr (EXACT) {
    big = tc::exact(v);
    small = 0u;
  } else {
    tc::split(v, big, small);
  }
}

// One k-step of 8 of acc += A B for a warp's 16 rows and 4 n-tiles of 8
// columns (a tile past an operand's width reads its zero columns): a(r,
// k) is A's element at the warp's row r, b(k, c) B's at the warp's column
// c.  In 3xTF32 (an operand flagged exact, a bf16 value, takes one TF32
// half and drops its cross term), the two small cross terms summed in sm,
// an accumulator of their own added at the end: a tile's passes are then
// two independent chains, not one of three dependent products.
template <bool AEX, bool BEX, typename FA, typename FB>
__device__ __forceinline__ void mm_step(float (&acc)[4][4],
                                        float (&sm)[4][4], FA a, FB b,
                                        int k0, int g, int t) {
  uint32_t ab[4], as[4], bb[4][2], bs[4][2];
  frag<AEX>(a(g, k0 + t), ab[0], as[0]);
  frag<AEX>(a(g + 8, k0 + t), ab[1], as[1]);
  frag<AEX>(a(g, k0 + t + 4), ab[2], as[2]);
  frag<AEX>(a(g + 8, k0 + t + 4), ab[3], as[3]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    frag<BEX>(b(k0 + t, 8 * nt + g), bb[nt][0], bs[nt][0]);
    frag<BEX>(b(k0 + t + 4, 8 * nt + g), bb[nt][1], bs[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if constexpr (!AEX) tc::mma_tf32(sm[nt], as, bb[nt]);
    if constexpr (!BEX) tc::mma_tf32(sm[nt], ab, bs[nt]);
    tc::mma_tf32(acc[nt], ab, bb[nt]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

__device__ __forceinline__ void add(float (&acc)[4][4],
                                    const float (&sm)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += sm[i][e];
}

// acc += A B over k in [lo, hi) (multiples of 8), k in order
template <bool AEX, bool BEX, typename FA, typename FB>
__device__ __forceinline__ void mm(float (&acc)[4][4], FA a, FB b, int lo,
                                   int hi, int g, int t) {
  float sm[4][4];
  zero(sm);
#pragma unroll 2
  for (int k0 = lo; k0 < hi; k0 += 8)
    mm_step<AEX, BEX>(acc, sm, a, b, k0, g, t);
  add(acc, sm);
}

// acc1 += A1 B1 over [lo1, hi1) and acc2 += A2 B2 over [lo2, hi2), each in
// order of k, the two products' steps taken in turns: two independent
// chains for the warp scheduler, where one would stall on its loads
template <bool A1X, bool B1X, bool A2X, bool B2X, typename F1, typename G1,
          typename F2, typename G2>
__device__ __forceinline__ void mm2(float (&acc1)[4][4], F1 a1, G1 b1,
                                    int lo1, int hi1, float (&acc2)[4][4],
                                    F2 a2, G2 b2, int lo2, int hi2, int g,
                                    int t) {
  float s1[4][4], s2[4][4];
  zero(s1);
  zero(s2);
  int k1 = lo1, k2 = lo2;
#pragma unroll 2
  for (; k1 < hi1 && k2 < hi2; k1 += 8, k2 += 8) {
    mm_step<A1X, B1X>(acc1, s1, a1, b1, k1, g, t);
    mm_step<A2X, B2X>(acc2, s2, a2, b2, k2, g, t);
  }
  for (; k1 < hi1; k1 += 8) mm_step<A1X, B1X>(acc1, s1, a1, b1, k1, g, t);
  for (; k2 < hi2; k2 += 8) mm_step<A2X, B2X>(acc2, s2, a2, b2, k2, g, t);
  add(acc1, s1);
  add(acc2, s2);
}

// The item's decays, head hh's row hh of each [SLICE][DS] array: la (the
// inclusive cumsum of A dt over the block) and c (the cumsum of dt, la =
// A c), each by one thread a head in order; then exp(la), exp(la_last -
// la), w = exp(la_last - la) dt and a copy of dt (the staged dt's stage
// is refilled while the item's last epilogue runs) by every consumer
__device__ __forceinline__ void item_decays(const Args& a, const Item& it,
                                            const float* dtv, float* dec) {
  float* la = dec;
  float* cd = la + SLICE * DS;
  float* el = cd + SLICE * DS;
  float* te = el + SLICE * DS;
  float* wv = te + SLICE * DS;
  float* dc = wv + SLICE * DS;
  const int tid = threadIdx.x;
  if (tid < it.nh) {
    const float A = a.A[it.h0 + tid];
    const float* d = dtv + tid * DS;
    float s = 0.f, c = 0.f;
#pragma unroll 8
    for (int i = 0; i < BL; ++i) {
      s += A * d[i];
      la[tid * DS + i] = s;
      c += d[i];
      cd[tid * DS + i] = c;
    }
  }
  consumer_sync();
  for (int e = tid; e < it.nh * BL; e += CONSUMERS) {
    const int h = e / BL, o = h * DS + (e - h * BL);
    const float l = la[o], last = la[h * DS + BL - 1];
    el[o] = expf(l);
    te[o] = expf(last - l);
    wv[o] = te[o] * dtv[o];
    dc[o] = dtv[o];
  }
  consumer_sync();
}

// ------------------------------------------------------------ 1. local
template <typename T>
__device__ void consume_local(const Args& a, unsigned char* sm,
                              uint64_t* bar) {
  using L = Smem<T, false>;
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LDT = L::LDT;
  const T* Bs = reinterpret_cast<const T*>(sm + L::B_);
  const T* Cs = reinterpret_cast<const T*>(sm + L::C_);
  const float* dtv = reinterpret_cast<const float*>(sm + L::DT);
  float* dec = reinterpret_cast<float*>(sm + L::DEC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  const int P = a.P, N = a.N;
  const bool active = r0 < round8(P) && c0 < round8(N);
  const long long PN = (long long)P * N;
  uint32_t k = 0, m = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x, ++m) {
    const Item it = item_at(a, i);
    const int clen = min(BL, a.T - it.j * BL);
    tc::mbar_wait(&bar[BAR_BC_FULL], m & 1);
    item_decays(a, it, dtv, dec);
    for (int hh = 0; hh < it.nh; ++hh, ++k) {
      const int s = k % STAGES<false>;
      tc::mbar_wait(&bar[BAR_FULL + s], (k / STAGES<false>) & 1);
      const unsigned char* st = sm + L::RING + s * L::STAGE;
      const T* Xs = reinterpret_cast<const T*>(st);
      const T* DYs = reinterpret_cast<const T*>(st + L::TT);
      const float* el = dec + 2 * SLICE * DS + hh * DS;
      const float* wv = dec + 4 * SLICE * DS + hh * DS;
      const long long bh = (long long)it.b * a.H + it.h0 + hh;
      if (active) {
        // the state's share (x diag(w))^T B and the adjoint's (dy
        // diag(exp(la)))^T C, rows p, columns n, over the block's steps
        // (those past T, rows read from the last step's, weighted 0)
        float hs[4][4], gs[4][4];
        zero(hs);
        zero(gs);
        mm2<false, EX, false, EX>(
            hs,
            [&](int r, int kk) { return to_f(Xs[kk * LDT + r0 + r]) * wv[kk]; },
            [&](int kk, int c) { return to_f(Bs[kk * LDT + c0 + c]); }, 0, BL,
            gs,
            [&](int r, int kk) {
              return to_f(DYs[kk * LDT + r0 + r]) * (kk < clen ? el[kk] : 0.f);
            },
            [&](int kk, int c) { return to_f(Cs[kk * LDT + c0 + c]); }, 0, BL,
            g, t);
        float* hl = a.states + (bh * (a.nb + 1) + it.j + 1) * PN;
        float* gl = a.adj + (bh * (a.nb + 1) + it.j) * PN;
        const bool pair = (N & 1) == 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int p = r0 + g + 4 * e, n = c0 + 8 * q + 2 * t;
            if (p < P && n < N) {
              put_pair(hl + p * N + n, hs[q][e], hs[q][e + 1], n + 1 < N, pair);
              put_pair(gl + p * N + n, gs[q][e], gs[q][e + 1], n + 1 < N, pair);
            }
          }
      }
      if (threadIdx.x == 0) a.decay[bh * a.nb + it.j] = el[BL - 1];
      // the warp's reads of the stage (and at the item's last head, of B
      // and C) are done
      __syncwarp();
      if (lane == 0) {
        tc::mbar_arrive(&bar[BAR_EMPTY + s]);
        if (hh == it.nh - 1) tc::mbar_arrive(&bar[BAR_BC_EMPTY]);
      }
    }
    consumer_sync();   // the decays' readers are done
  }
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
// The per-head epilogue on one warp: dla, da (a reverse sum within the
// block: a warp scan over pairs of steps), ddt and the block's shares of
// dA and dD, in a fixed order.  dA = sum dt da regrouped by c (la = A c):
// the M share, + sum_t q_t c_t + sum_s u_s (c_last - c_s) + c_last
// exp(la_last) <G_out, h_in>; sum dt da would weight dla by la itself,
// where dla's terms cancel.  q is masked past T (its rows read the last
// step's); u is 0 there (dt = 0).
__device__ __forceinline__ void epilogue(const Args& a, const float* S,
                                         const float* dts, const float* el,
                                         const float* te, const float* cd,
                                         float A, int clen, long long row0,
                                         long long part, int lane) {
  const float* rowM = S;
  const float* colS = S + 2 * BL;
  const float* vpart = S + 6 * BL;
  const float* qpart = S + 8 * BL;
  const float* red = S + 10 * BL;
  float gh = 0.f, xd = 0.f, dA = 0.f;
  for (int w = 0; w < WARPS; ++w) {
    gh += red[w];
    xd += red[WARPS + w];
    dA += red[2 * WARPS + w];
  }
  float dla[2], col[2], v[2], u = 0.f, qu = 0.f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = 2 * lane + e;
    col[e] = colS[i] + colS[BL + i] + colS[2 * BL + i] + colS[3 * BL + i];
    v[e] = te[i] * (vpart[i] + vpart[BL + i]);
    const float q = i < clen ? el[i] * (qpart[i] + qpart[BL + i]) : 0.f;
    const float ui = dts[i] * v[e];
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
    if (i < clen) a.ddt[row0 + (long long)i * a.H] = col[e] + v[e] + A * da[e];
  }
  if (lane == 0) {
    a.dA_part[part] = dA;
    a.dD_part[part] = xd;
  }
}

template <typename T>
__device__ void consume_grad(const Args& a, unsigned char* sm,
                             uint64_t* bar) {
  using L = Smem<T, true>;
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LDT = L::LDT;
  const T* Bs = reinterpret_cast<const T*>(sm + L::B_);
  const T* Cs = reinterpret_cast<const T*>(sm + L::C_);
  const float* dtv = reinterpret_cast<const float*>(sm + L::DT);
  float* dec = reinterpret_cast<float*>(sm + L::DEC);
  float* P1 = reinterpret_cast<float*>(sm + L::P1_);   // (C_t.B_s) L_ts dt_s
  float* P2 = reinterpret_cast<float*>(sm + L::P2_);   // (dy_t.x_s) L_ts dt_s
  float* smalls = reinterpret_cast<float*>(sm + L::SM_);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, cw = warp >> 2;
  const int r0 = 16 * rw, c0 = 32 * cw;
  const int H = a.H, P = a.P, N = a.N, P8 = round8(P), N8 = round8(N);
  uint32_t k = 0, m = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x, ++m) {
    const Item it = item_at(a, i);
    const int t0 = it.j * BL, clen = min(BL, a.T - t0);
    tc::mbar_wait(&bar[BAR_BC_FULL], m & 1);
    item_decays(a, it, dtv, dec);
    // C B^T (its causal blocks are used), the slice's heads' alike
    float cb[4][4];
    zero(cb);
    mm<EX, EX>(cb, [&](int r, int kk) { return to_f(Cs[(r0 + r) * LDT + kk]); },
               [&](int kk, int c) { return to_f(Bs[(c0 + c) * LDT + kk]); }, 0,
               N8, g, t);
    // dB (rows s) and dC (rows t), columns n: the slice's heads summed in
    // order
    float dBs[4][4], dCs[4][4];
    zero(dBs);
    zero(dCs);
    for (int hh = 0; hh < it.nh; ++hh, ++k) {
      const int s = k % STAGES<true>;
      tc::mbar_wait(&bar[BAR_FULL + s], (k / STAGES<true>) & 1);
      const unsigned char* st = sm + L::RING + s * L::STAGE;
      const T* Xs = reinterpret_cast<const T*>(st);                // steps x P
      const T* DYs = reinterpret_cast<const T*>(st + L::TT);       // steps x P
      const float* Gs = reinterpret_cast<const float*>(st + 2 * L::TT);  // P x N
      const float* Hs =
          reinterpret_cast<const float*>(st + 2 * L::TT + L::TG);   // P x N
      const float* dts = dec + 5 * SLICE * DS + hh * DS;
      const float* la = dec + hh * DS;
      const float* cd = dec + SLICE * DS + hh * DS;
      const float* el = dec + 2 * SLICE * DS + hh * DS;
      const float* te = dec + 3 * SLICE * DS + hh * DS;
      const float* wv = dec + 4 * SLICE * DS + hh * DS;
      float* S = smalls + (hh & 1) * SMALL;
      float* rowM = S;             // [2][BL]: rowsum(M), per column half
      float* colS = S + 2 * BL;    // [4][BL]: colsum(M / dt), per row block
      float* vpart = S + 6 * BL;   // [2][BL]: x_s.(G_out B_s)
      float* qpart = S + 8 * BL;   // [2][BL]: C_t.(h_in^T dy_t)
      float* red = S + 10 * BL;    // [3][WARPS]: <G_out, h_in>, x.dy, dA's
                                   // M share, per warp
      const int h = it.h0 + hh;
      const long long row0 = ((long long)it.b * a.T + t0) * H + h;

      // <G_out, h_in> and the block's x.dy (steps before T): row tid / 4,
      // every fourth column from tid % 4; summed by warps in a fixed tree,
      // then over the warps in order
      {
        const int row = tid >> 2;
        float gh = 0.f, xd = 0.f;
        if (row < P8)
          for (int n = tid & 3; n < N8; n += 4)
            gh = fmaf(Gs[row * LDF + n], Hs[row * LDQ + n], gh);
        if (row < clen)
          for (int p = tid & 3; p < P8; p += 4)
            xd = fmaf(to_f(Xs[row * LDT + p]), to_f(DYs[row * LDT + p]), xd);
#pragma unroll
        for (int o = 16; o; o >>= 1) {
          gh += __shfl_xor_sync(FULL, gh, o);
          xd += __shfl_xor_sync(FULL, xd, o);
        }
        if (lane == 0) {
          red[warp] = gh;
          red[WARPS + warp] = xd;
        }
      }

      // ---- dy x^T (its causal blocks are used); P1 and P2 (rows t past
      // T and columns s > t zero); M = P1 o dy x^T summed by rows, M / dt
      // by columns
      {
        float dx[4][4];
        zero(dx);
        mm<EX, EX>(dx,
                   [&](int r, int kk) { return to_f(DYs[(r0 + r) * LDT + kk]); },
                   [&](int kk, int c) { return to_f(Xs[(c0 + c) * LDT + kk]); },
                   0, P8, g, t);
        // dA's share of M: sum M_ts (c_t - c_s), each weight a span of steps
        float rs[2] = {0.f, 0.f}, cs[4][2], dam = 0.f, p1p = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int e = 0; e < 2; ++e) cs[q][e] = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tr = r0 + g + 8 * (e >> 1);
            const int sc = c0 + 8 * q + 2 * t + (e & 1);
            float p1 = 0.f, p2 = 0.f;
            if (sc <= tr && tr < clen) {
              const float Lts = expf(la[tr] - la[sc]);
              const float sv = cb[q][e] * Lts * dx[q][e];   // M_ts / dt_s
              const float mv = sv * dts[sc];
              p1 = cb[q][e] * Lts * dts[sc];
              p2 = dx[q][e] * Lts * dts[sc];
              rs[e >> 1] += mv;
              cs[q][e & 1] += sv;
              dam = fmaf(mv, cd[tr] - cd[sc], dam);
            }
            dx[q][e] = p2;   // the product is read; its register keeps P2
            if (e & 1) {   // the pair (sc - 1, sc) of row tr at once
              put2(P1 + tr * LDQ + sc - 1, p1p, p1);
              put2(P2 + tr * LDF + sc - 1, dx[q][e - 1], p2);
            }
            p1p = p1;
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
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = cs[q][e];
            v += __shfl_xor_sync(FULL, v, 4);
            v += __shfl_xor_sync(FULL, v, 8);
            v += __shfl_xor_sync(FULL, v, 16);
            if (g == 0) colS[rw * BL + c0 + 8 * q + 2 * t + e] = v;
          }
#pragma unroll
        for (int o = 16; o; o >>= 1) dam += __shfl_xor_sync(FULL, dam, o);
        if (lane == 0) red[2 * WARPS + warp] = dam;
      }
      consumer_sync();

      // ---- dx: rows s, columns p.  P1^T dy over t >= s, then w_s (G_out B_s)
      {
        const float Dh = a.D ? a.D[h] : 0.f;
        float acc[4][4], gb[4][4];
        zero(acc);
        zero(gb);
        mm2<false, EX, EX, false>(
            acc, [&](int r, int kk) { return P1[kk * LDQ + r0 + r]; },
            [&](int kk, int c) { return to_f(DYs[kk * LDT + c0 + c]); }, r0, BL,
            gb, [&](int r, int kk) { return to_f(Bs[(r0 + r) * LDT + kk]); },
            [&](int kk, int c) { return Gs[(c0 + c) * LDF + kk]; }, 0, N8, g,
            t);
        float vs[2] = {0.f, 0.f};
        T* dxo = static_cast<T*>(a.dx);
        const bool pair = (P & 1) == 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int ss = r0 + g + 4 * e, p = c0 + 8 * q + 2 * t;
            float v[2];
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              vs[e >> 1] = fmaf(to_f(Xs[ss * LDT + p + f]), gb[q][e + f],
                                vs[e >> 1]);
              v[f] = acc[q][e + f] + wv[ss] * gb[q][e + f] +
                     Dh * to_f(DYs[ss * LDT + p + f]);
            }
            if (ss < clen && p < P)
              put_pair(dxo + (row0 + (long long)ss * H) * P + p, v[0], v[1],
                       p + 1 < P, pair);
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
      // ---- the head's share of dB: rows s, columns n.  P2^T C over t >=
      // s, then w_s (G_out^T x_s)
      if (c0 < N8) {
        float acc[4][4], gx[4][4];
        zero(acc);
        zero(gx);
        mm2<false, EX, EX, false>(
            acc, [&](int r, int kk) { return P2[kk * LDF + r0 + r]; },
            [&](int kk, int c) { return to_f(Cs[kk * LDT + c0 + c]); }, r0, BL,
            gx, [&](int r, int kk) { return to_f(Xs[(r0 + r) * LDT + kk]); },
            [&](int kk, int c) { return Gs[kk * LDF + c0 + c]; }, 0, P8, g, t);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dBs[q][e] += acc[q][e] + wv[r0 + g + 8 * (e >> 1)] * gx[q][e];
      }
      // ---- the head's share of dC: rows t, columns n.  P2 B over s <= t,
      // then exp(la_t) (h_in^T dy_t)
      {
        float acc[4][4], hd[4][4];
        zero(acc);
        zero(hd);
        if (c0 < N8)
          mm2<false, EX, EX, false>(
              acc, [&](int r, int kk) { return P2[(r0 + r) * LDF + kk]; },
              [&](int kk, int c) { return to_f(Bs[kk * LDT + c0 + c]); }, 0,
              r0 + 16, hd,
              [&](int r, int kk) { return to_f(DYs[(r0 + r) * LDT + kk]); },
              [&](int kk, int c) { return Hs[kk * LDQ + c0 + c]; }, 0, P8, g,
              t);
        float qs[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tr = r0 + g + 8 * (e >> 1);
            const int n = c0 + 8 * q + 2 * t + (e & 1);
            qs[e >> 1] = fmaf(to_f(Cs[tr * LDT + n]), hd[q][e], qs[e >> 1]);
            dCs[q][e] += acc[q][e] + el[tr] * hd[q][e];
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
      consumer_sync();
      if (tid == 0) {   // the stage's readers are done, and at the last
        tc::mbar_arrive(&bar[BAR_EMPTY + s]);   // head B's and C's
        if (hh == it.nh - 1) tc::mbar_arrive(&bar[BAR_BC_EMPTY]);
      }
      // the epilogue on warp hh % WARPS, while the others go on
      if (warp == (hh & (WARPS - 1)))
        epilogue(a, S, dts, el, te, cd, a.A[h], clen, row0,
                 ((long long)it.b * H + h) * a.nb + it.j, lane);
    }
    // the slice's float32 partial of dB and dC
    {
      const long long ns = (long long)a.G * a.nsl;
      const bool pair = (N & 1) == 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = r0 + g + 4 * e, n = c0 + 8 * q + 2 * t;
          if (r < clen && n < N) {
            const long long o =
                (((long long)it.b * a.T + t0 + r) * ns + it.gs) * N + n;
            const bool two = n + 1 < N;
            put_pair(a.dB_part + o, dBs[q][e], dBs[q][e + 1], two, pair);
            put_pair(a.dC_part + o, dCs[q][e], dCs[q][e + 1], two, pair);
          }
        }
    }
    consumer_sync();   // the last epilogue has read the decays
  }
}

// ------------------------------------------------------- the passes
// the pass's roles: the producer warp, then the consumers
template <typename T, bool GRAD>
__device__ __forceinline__ void run_pass(const Maps& maps, const Args& a) {
  using L = Smem<T, GRAD>;
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  // zeros where no copy writes: columns past P and N, rows of h_in and
  // G_out past P (the products read them up to a multiple of 8)
  for (int i = threadIdx.x; i < L::BAR / 16; i += THREADS)
    reinterpret_cast<float4*>(sm)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
    // filled: the producer's lane 0 (and the TMA copies' bytes);
    // emptied: the gradient pass's thread 0 after a barrier of the
    // consumers, the local pass's consumer warps
    constexpr int EMPTIED = GRAD ? 1 : WARPS;
    for (int i = 0; i < STAGES<GRAD>; ++i) {
      tc::mbar_init(&bar[BAR_FULL + i], 1);
      tc::mbar_init(&bar[BAR_EMPTY + i], EMPTIED);
    }
    tc::mbar_init(&bar[BAR_BC_FULL], 1);
    tc::mbar_init(&bar[BAR_BC_EMPTY], EMPTIED);
    tc::mbar_init_fence();
  }
  tc::fence_proxy_async();   // the zeros before any TMA copy
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    produce<T, GRAD>(maps, a, sm, bar);
    return;
  }
  if constexpr (GRAD)
    consume_grad<T>(a, sm, bar);
  else
    consume_local<T>(a, sm, bar);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    local_kernel(const __grid_constant__ Maps maps, Args a) {
  run_pass<T, false>(maps, a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    grad_kernel(const __grid_constant__ Maps maps, Args a) {
  run_pass<T, true>(maps, a);
}

// ------------------------------------------------------------- 4, 5. sums
// dB (blockIdx.y 0) and dC (1): each group's slices summed in order
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS) group_sum_kernel(Args a) {
  const int G = a.G, N = a.N, nsl = a.nsl;
  const long long e = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (e >= (long long)a.batch * a.T * G * N) return;
  const long long bt = e / ((long long)G * N);
  const int gn = (int)(e - bt * G * N), gi = gn / N, n = gn - gi * N;
  const float* part = (blockIdx.y == 0 ? a.dB_part : a.dC_part) +
                      (bt * G * nsl + (long long)gi * nsl) * N + n;
  float s = 0.f;
  for (int r = 0; r < nsl; ++r) s += part[(long long)r * N];
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

// x, dy, B and C (features, heads or groups, steps, batch) and the states
// and adjoints (N, P, boundaries, batch x heads), as Maps says
template <typename T>
bool make_maps(Maps* m, const Args& a) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int LDT = Smem<T, true>::LDT;
  const int item = BF ? 2 : 4;
  const long long B = a.batch, T_ = a.T, H = a.H, G = a.G, P = a.P,
                  N = a.N, nb1 = a.nb + 1;
  const long long sx[3] = {P * item, a.sxt * item, a.sxb * item};
  const long long sd[3] = {P * item, a.sdt * item, a.sdb * item};
  const long long sb[3] = {N * item, a.sbt * item, a.sbb * item};
  const long long sc[3] = {N * item, a.sct * item, a.scb * item};
  const long long ss[3] = {N * 4, P * N * 4, nb1 * P * N * 4};
  using tc::make_map;
  return make_map(&m->x, BF, a.x, {P, H, T_, B}, sx, {LDT, 1, BL, 1}, 0) &&
         make_map(&m->dy, BF, a.dy, {P, H, T_, B}, sd, {LDT, 1, BL, 1}, 0) &&
         make_map(&m->Bm, BF, a.Bm, {N, G, T_, B}, sb, {LDT, 1, BL, 1}, 0) &&
         make_map(&m->Cm, BF, a.Cm, {N, G, T_, B}, sc, {LDT, 1, BL, 1}, 0) &&
         make_map(&m->states, false, a.states, {N, P, nb1, B * H}, ss,
                  {LDQ, MAX_P, 1, 1}, 0) &&
         make_map(&m->adj, false, a.adj, {N, P, nb1, B * H}, ss,
                  {LDF, MAX_P, 1, 1}, 0);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int local_smem = Smem<T, false>::BYTES;
  constexpr int grad_smem = Smem<T, true>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&local_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, local_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(&grad_kernel<T>),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           grad_smem);
  if (e != cudaSuccess) return (int)e;
  // one persistent CTA an SM
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  const int grid = a.items < sms ? a.items : sms;
  Maps maps;
  if (a.vec && !make_maps<T>(&maps, a)) return (int)cudaErrorInvalidValue;
  local_kernel<T><<<grid, THREADS, local_smem, stream>>>(maps, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long entries = (long long)a.batch * a.H * a.P * a.N;
  walk_kernel<<<dim3((unsigned)((entries + WALK_THREADS - 1) / WALK_THREADS),
                     2), WALK_THREADS, 0, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  grad_kernel<T><<<grid, THREADS, grad_smem, stream>>>(maps, a);
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
// The scratch buffers are the wrapper's (see Args; a group has
// ceil((H / G) / SLICE) slices).
// Returns the cudaError_t of the launches.
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
  const int nb = (T + BL - 1) / BL, rep = H / G;
  const int nsl = (rep + SLICE - 1) / SLICE;
  const long long items = (long long)batch * nb * G * nsl;
  if (items > 0x7fffffffLL || !dB_part || !dC_part)
    return (int)cudaErrorInvalidValue;
  Args a{x,     dt,      A,       Bm,      Cm,      D,       h0,    dy,
         dh,    states,  adj,     decay,   dx,      ddt,     dB_part,
         dC_part, dB,    dC,      dA_part, dD_part, dA,      dD,    dh0,
         batch, T,       H,       P,       G,       N,       nb,
         nsl,   (int)items, 0,
         sxb,   sxt,     sbb,     sbt,     scb,     sct,     sdb,   sdt};
  // TMA copies need rows of a multiple of 16 bytes (the states' rows are
  // N floats), strides to match and 16-byte aligned bases
  const int item = dtype == 0 ? 4 : 2;
  a.vec = (P * item) % 16 == 0 && (N * item) % 16 == 0 && N % 4 == 0 &&
          (sxb * item) % 16 == 0 && (sxt * item) % 16 == 0 &&
          (sbb * item) % 16 == 0 && (sbt * item) % 16 == 0 &&
          (scb * item) % 16 == 0 && (sct * item) % 16 == 0 &&
          (sdb * item) % 16 == 0 && (sdt * item) % 16 == 0 &&
          ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm | (uintptr_t)dy |
           (uintptr_t)states | (uintptr_t)adj) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(a, s) : launch<__nv_bfloat16>(a, s);
}

// The launch geometry the wrapper sizes its scratch by and mirrors in
// Python: out[0] the block length BL, out[1] the walk's WALK_THREADS,
// out[2] the most heads a slice takes, SLICE.
extern "C" int repro_mamba2_ssd_backward_geometry(int* out) {
  out[0] = BL;
  out[1] = WALK_THREADS;
  out[2] = SLICE;
  return 0;
}
