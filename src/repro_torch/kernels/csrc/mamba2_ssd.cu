// Mamba2 SSD (state-space duality) chunked scan, with the D skip and the
// final state, over x (B,T,H,P), dt (B,T,H), A (H,), B/C (B,T,G,N) and an
// initial state (B,H,P,N).  x, B and C are float32 or bfloat16; y is
// written in x's type; dt, A, D and the states are float32.
//
// Replaces: the Pallas TPU kernel mamba2_ssd_pallas / _ssd_kernel in
// src/repro/kernels/mamba2_ssd.py:22-68.  Its wrapper transposes x, dt,
// B and C to head-major, writes B and C repeated from G groups to H
// heads, and pads the tail to a whole chunk; its grid walks (batch,
// head, chunk) with the P x N state in VMEM scratch.
//
// Per chunk of c steps (la = cumsum(A dt) within the chunk):
//   y_t = sum_{s<=t} (C_t . B_s) exp(la_t - la_s) dt_s x_s + exp(la_t) C_t . h
//   h  <- exp(la_last) h + sum_s exp(la_last - la_s) dt_s x_s B_s^T
// then y_t += D x_t.  The chunked form is exact for any chunk length, so
// the kernel walks tiles of min(chunk, 32) steps: only rounding differs.
//
// What bounds it on an H100: the bytes.  At zamba2's shape (B=16,
// T=512, H=80, P=N=64) the 384 MB of x, y, B, C and states take 0.115
// ms (0.064 ms in bf16).  The products, counted at chunk length 1 (the
// fewest: the causal half of C B^T grows with the length), are 10.9
// GFLOP: 0.066 ms in float32 as 3xTF32 (495/3 TF/s); at the kernel's
// 32-step tiles they are 13.5 GFLOP, 0.082 ms.
//
// What the design does about it: every product runs on the tensor cores
// as mma.sync.m16n8k8 in TF32, each float32 operand split into two
// halves rounded to TF32 (3xTF32, about 22 bits of the operand); a bf16
// operand is exact in TF32 and drops its cross term,
// so C B^T takes one pass for bf16 inputs and the others two:
//   C B^T        over N, the causal blocks only (s < end of the row tile);
//   (C B^T o L o dt) x over the tile's steps, the scores passed from the
//                accumulators to the A fragments in place (A's k slots t
//                and t+4 are taken as steps 2t and 2t+1, and x's B
//                fragment is read in that order);
//   exp(la) C h^T over N, accumulated first and scaled per row;
//   x^T diag(w) B over the tile's steps for the state, w_s =
//                exp(la_last - la_s) dt_s.
// The decay exp(la_t - la_s) is applied to the C B^T accumulators in
// fragment coordinates; its exponent stays <= 0.  One CTA of four warps
// walks a (batch, head)'s tiles in order: warp w holds rows 16w..16w+15
// of the P x N state in accumulator fragments for the whole walk, which
// pass through shared memory once a tile to become the B operand of
// C h^T; for y, warp w takes row tile w % 2 and every other column tile
// of P.  The next tile's x, B, C and dt are staged by cp.async (16-byte
// copies where rows and strides allow) while this one computes.  Rows
// are padded (float32 by 4, bf16 by 8 values) so fragment loads are free
// of bank conflicts at P = N = 64; about 70 KB of shared memory, three
// CTAs on an SM.  B and C are read by group (h / (H/G)), never repeated
// per head, and x, B and C in place through their batch and time
// strides.  The tail tile stops at T: its missing steps would add
// nothing to y and not decay h.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int CT = 32;         // steps per tile
constexpr int MAX_CHUNK = 128;
constexpr int MAX_P = 64;
constexpr int MAX_N = 64;
constexpr int NT_Y = MAX_P / 16;  // column tiles of y a warp holds (4)
constexpr int NT_H = MAX_N / 8;   // column tiles of the state (8)

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;   // may be null
  const float* h0;
  void* y;
  float* h_out;
  int T, H, P, G, N, chunk, vec;
  long long sxb, sxt;  // x strides (elements) of batch and time
  long long sbb, sbt;  // B strides
  long long scb, sct;  // C strides
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
// padded row length of a staged tile, in elements
template <typename T>
__host__ __device__ constexpr int ld_of(int n) {
  return round8(n) + (sizeof(T) == 4 ? 4 : 8);
}

// Stage rows [0, CT) of one operand of the tile at t0 (rows past clen
// zero): 16-byte cp.async when vec, else plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      long long st, int width, int clen,
                                      bool vec, int tid) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const int cpr = width / PER;  // 16-byte chunks per row
    for (int i = tid; i < CT * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < clen;
      tc::cp_async16(dst + r * ld + c * PER, ok ? src + r * st + c * PER : src,
                     ok);
    }
  } else {
    for (int i = tid; i < CT * width; i += THREADS) {
      const int r = i / width, c = i - r * width;
      dst[r * ld + c] = r < clen ? src[r * st + c] : T(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 3) ssd_kernel(Args a) {
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;  // exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int P = a.P, N = a.N, Tn = a.T, H = a.H;
  const int P8 = round8(P), N8 = round8(N);
  const int c = min(a.chunk, CT);
  const int g_ = h / (H / a.G);
  const int LX = ld_of<T>(P), LN = ld_of<T>(N), LH = N8 + 4;
  // two stages of x, B, C (CT x LX, CT x LN, CT x LN) and dt, then the
  // state (MAX_P x LH floats)
  const int stage_bytes = CT * (LX + 2 * LN) * (int)sizeof(T) + CT * 4;
  float* hs = reinterpret_cast<float*>(smem + 2 * stage_bytes);
  auto X_of = [&](int s) { return reinterpret_cast<T*>(smem + s * stage_bytes); };
  auto B_of = [&](int s) { return X_of(s) + CT * LX; };
  auto C_of = [&](int s) { return B_of(s) + CT * LN; };
  auto dt_of = [&](int s) { return reinterpret_cast<float*>(C_of(s) + CT * LN); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float A = a.A[h];
  const float Dh = a.D ? a.D[h] : 0.f;
  const T* x = static_cast<const T*>(a.x) + b * a.sxb + (long long)h * P;
  const T* Bg = static_cast<const T*>(a.Bm) + b * a.sbb + (long long)g_ * N;
  const T* Cg = static_cast<const T*>(a.Cm) + b * a.scb + (long long)g_ * N;
  const float* dt = a.dt + (long long)b * Tn * H + h;            // step H
  T* y = static_cast<T*>(a.y) + ((long long)b * Tn * H + h) * P;  // step H*P
  const long long hbase = ((long long)b * H + h) * P * N;
  const bool vec = a.vec != 0;

  // zero everything once: the pads past P and N are read by the
  // products and never written
  for (int i = tid; i < (2 * stage_bytes + MAX_P * LH * 4) / 4; i += THREADS)
    reinterpret_cast<float*>(smem)[i] = 0.f;

  // the state: warp w holds rows 16w + g (+8), columns 8n + 2t (+1)
  float hst[NT_H][4];
#pragma unroll
  for (int n = 0; n < NT_H; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * warp + g + (e >> 1) * 8, col = 8 * n + 2 * t + (e & 1);
      hst[n][e] = p < P && col < N ? a.h0[hbase + (long long)p * N + col] : 0.f;
    }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NT_H; ++n)
    if (8 * n < N8)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hs[(16 * warp + g + (e >> 1) * 8) * LH + 8 * n + 2 * t + (e & 1)] =
            hst[n][e];

  auto load_tile = [&](int t0, int s) {
    const int clen = min(c, Tn - t0);
    stage<T>(X_of(s), LX, x + t0 * a.sxt, a.sxt, P, clen, vec, tid);
    stage<T>(B_of(s), LN, Bg + t0 * a.sbt, a.sbt, N, clen, vec, tid);
    stage<T>(C_of(s), LN, Cg + t0 * a.sct, a.sct, N, clen, vec, tid);
    for (int i = tid; i < CT; i += THREADS) {
      const bool ok = i < clen;
      tc::cp_async4(dt_of(s) + i, ok ? dt + (long long)(t0 + i) * H : dt, ok);
    }
  };
  load_tile(0, 0);
  tc::cp_async_commit();

  const int ntiles = (Tn + c - 1) / c;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * c, clen = min(c, Tn - t0), s = it & 1;
    if (it + 1 < ntiles) load_tile(t0 + c, s ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const T* Xs = X_of(s);
    const T* Bs = B_of(s);
    const T* Cs = C_of(s);
    const float* dts = dt_of(s);

    // ---- la = inclusive cumsum of A dt over the tile, step `lane` in
    // lane `lane` of every warp (read across lanes by shuffles), and
    // w_s = exp(la_last - la_s) dt_s
    constexpr unsigned FULL = 0xffffffffu;
    const float d = lane < clen ? dts[lane] : 0.f;
    float la = A * d;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, la, off);
      if (lane >= off) la += o;
    }
    const float la_last = __shfl_sync(FULL, la, clen - 1);
    const float w = expf(la_last - la) * d;

    // ---- y for row tile mi, column tiles ph, ph + 2, ...
    const int mi = warp & 1, ph = warp >> 1;
    const int rt0 = 16 * mi;
    if (rt0 < clen) {
      const int nsj = 2 * (mi + 1);   // score slices: s < 16 (mi + 1)
      float cb[4][4], yv[NT_Y][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
#pragma unroll
      for (int n = 0; n < NT_Y; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yv[n][e] = 0.f;
      // C B^T and C h^T share C's fragments
      for (int kk = 0; kk < N8 / 8; ++kk) {
        uint32_t ab[4], as[4];
        const T* ca = Cs + (rt0 + g) * LN + kk * 8 + t;
        tc::split_ld(ca[0], ab[0], as[0]);
        tc::split_ld(ca[8 * LN], ab[1], as[1]);
        tc::split_ld(ca[4], ab[2], as[2]);
        tc::split_ld(ca[8 * LN + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nsj) {
            uint32_t bb[2], bs[2];
            const T* bp = Bs + (j * 8 + g) * LN + kk * 8 + t;
            tc::split_ld(bp[0], bb[0], bs[0]);
            tc::split_ld(bp[4], bb[1], bs[1]);
            tc::mma_3xtf32<EX, EX>(cb[j], ab, as, bb, bs);
          }
        }
#pragma unroll
        for (int n = 0; n < NT_Y; ++n) {
          const int col = (ph + 2 * n) * 8;
          if (col < P8) {
            uint32_t bb[2], bs[2];
            const float* hp = hs + (col + g) * LH + kk * 8 + t;
            tc::split(hp[0], bb[0], bs[0]);
            tc::split(hp[4], bb[1], bs[1]);
            tc::mma_3xtf32<EX, false>(yv[n], ab, as, bb, bs);
          }
        }
      }
      const int trA = rt0 + g, trB = trA + 8;
      const float laA = __shfl_sync(FULL, la, trA);
      const float laB = __shfl_sync(FULL, la, trB);
      const float eA = expf(laA), eB = expf(laB);
#pragma unroll
      for (int n = 0; n < NT_Y; ++n) {
        yv[n][0] *= eA;
        yv[n][1] *= eA;
        yv[n][2] *= eB;
        yv[n][3] *= eB;
      }
      // scores: (C B^T) o exp(la_t - la_s) dt_s on s <= t < clen
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int sc = j * 8 + 2 * t + e;
          const float las = __shfl_sync(FULL, la, sc);
          const float ds = __shfl_sync(FULL, d, sc);
          cb[j][e] = sc <= trA && trA < clen
                         ? cb[j][e] * expf(laA - las) * ds : 0.f;
          cb[j][e + 2] = sc <= trB && trB < clen
                             ? cb[j][e + 2] * expf(laB - las) * ds : 0.f;
        }
      // y += scores x: A's slot t is step 2t, slot t+4 step 2t+1
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nsj) {
          uint32_t ab[4], as[4];
          tc::split(cb[j][0], ab[0], as[0]);
          tc::split(cb[j][2], ab[1], as[1]);
          tc::split(cb[j][1], ab[2], as[2]);
          tc::split(cb[j][3], ab[3], as[3]);
          const T* xp = Xs + (j * 8 + 2 * t) * LX + g;
#pragma unroll
          for (int n = 0; n < NT_Y; ++n) {
            const int col = (ph + 2 * n) * 8;
            if (col < P8) {
              uint32_t bb[2], bs[2];
              tc::split_ld(xp[col], bb[0], bs[0]);
              tc::split_ld(xp[LX + col], bb[1], bs[1]);
              tc::mma_3xtf32<false, EX>(yv[n], ab, as, bb, bs);
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT_Y; ++n) {
        const int col = (ph + 2 * n) * 8;
        if (col >= P8) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tr = (e >> 1) ? trB : trA;
          const int p = col + 2 * t + (e & 1);
          if (tr < clen && p < P)
            put(y + (long long)(t0 + tr) * H * P + p,
                yv[n][e] + Dh * to_f(Xs[tr * LX + p]));
        }
      }
    }

    // ---- state: h <- exp(la_last) h + (x diag(w))^T B, rows 16w..
    const int pr = 16 * warp;
    if (pr < P8) {
      const float decay = expf(la_last);
#pragma unroll
      for (int n = 0; n < NT_H; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hst[n][e] *= decay;
      const bool lo = pr + g < P8, hi = pr + g + 8 < P8;
      for (int k0 = 0; k0 < c; k0 += 8) {
        const int s0 = k0 + 2 * t;     // slot t: step s0, slot t+4: s0 + 1
        const float w0 = __shfl_sync(FULL, w, s0);
        const float w1 = __shfl_sync(FULL, w, s0 + 1);
        const T* xa = Xs + s0 * LX + pr + g;
        uint32_t ab[4], as[4];
        tc::split(lo ? to_f(xa[0]) * w0 : 0.f, ab[0], as[0]);
        tc::split(hi ? to_f(xa[8]) * w0 : 0.f, ab[1], as[1]);
        tc::split(lo ? to_f(xa[LX]) * w1 : 0.f, ab[2], as[2]);
        tc::split(hi ? to_f(xa[LX + 8]) * w1 : 0.f, ab[3], as[3]);
        const T* bp = Bs + s0 * LN + g;
#pragma unroll
        for (int n = 0; n < NT_H; ++n) {
          if (8 * n < N8) {
            uint32_t bb[2], bs[2];
            tc::split_ld(bp[8 * n], bb[0], bs[0]);
            tc::split_ld(bp[LN + 8 * n], bb[1], bs[1]);
            tc::mma_3xtf32<false, EX>(hst[n], ab, as, bb, bs);
          }
        }
      }
    }
    __syncthreads();  // every read of hs and of this stage is done
#pragma unroll
    for (int n = 0; n < NT_H; ++n)
      if (8 * n < N8)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hs[(pr + g + (e >> 1) * 8) * LH + 8 * n + 2 * t + (e & 1)] = hst[n][e];
  }

#pragma unroll
  for (int n = 0; n < NT_H; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * warp + g + (e >> 1) * 8, col = 8 * n + 2 * t + (e & 1);
      if (p < P && col < N) a.h_out[hbase + (long long)p * N + col] = hst[n][e];
    }
}

template <typename T>
size_t smem_bytes(const Args& a) {
  const int stage = CT * (ld_of<T>(a.P) + 2 * ld_of<T>(a.N)) * (int)sizeof(T) + CT * 4;
  return (size_t)2 * stage + (size_t)MAX_P * (round8(a.N) + 4) * 4;
}

template <typename T>
int launch(Args a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&ssd_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte copies need whole 16-byte rows, strides and base pointers
  const int item = sizeof(T);
  a.vec = (a.P * item) % 16 == 0 && (a.N * item) % 16 == 0 &&
          (a.sxb * item) % 16 == 0 && (a.sxt * item) % 16 == 0 &&
          (a.sbb * item) % 16 == 0 && (a.sbt * item) % 16 == 0 &&
          (a.scb * item) % 16 == 0 && (a.sct * item) % 16 == 0 &&
          ((uintptr_t)a.x | (uintptr_t)a.Bm | (uintptr_t)a.Cm) % 16 == 0;
  dim3 grid(a.H, batch);
  ssd_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y).  Strides are in elements;
// x's head stride is P and B/C's group stride N, each with unit feature
// stride; dt and y are contiguous.  Returns the cudaError_t of the launch.
extern "C" int repro_mamba2_ssd(int dtype, const void* x, const float* dt,
                                const float* A, const void* Bm, const void* Cm,
                                const float* D, const float* h0, void* y,
                                float* h_out, int batch, int T, int H, int P,
                                int G, int N, int chunk, long long sxb,
                                long long sxt, long long sbb, long long sbt,
                                long long scb, long long sct, void* stream) {
  if (batch < 1 || batch > 65535 || T < 1 || H < 1 || G < 1 || H % G != 0 ||
      P < 1 || P > MAX_P || N < 1 || N > MAX_N || chunk < 1 ||
      chunk > MAX_CHUNK || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{x, dt, A, Bm, Cm, D, h0, y, h_out, T, H, P, G, N, chunk, 0,
         sxb, sxt, sbb, sbt, scb, sct};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(a, batch, s)
                    : launch<__nv_bfloat16>(a, batch, s);
}
