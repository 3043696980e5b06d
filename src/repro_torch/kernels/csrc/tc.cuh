// Warp-level building blocks for Hopper's tensor cores, shared by the
// flash-attention (K3) and Mamba2 SSD (K4) kernels.  All inline PTX,
// for sm_90a:
//
// - cp.async: 16-byte asynchronous copies from global to shared memory
//   (zero-filled past an edge), committed and waited on in groups;
// - TMA: a box of a 4-D tensor map (made on the host) copied into shared
//   memory, completing on an mbarrier; mbarrier init / arrive / wait (a
//   wait that never ends traps, or, in kernels that hand registers over,
//   gives up);
// - mma.sync.m16n8k8 in TF32 with fp32 accumulation, and the 3xTF32
//   product that keeps close to a float32 operand's accuracy: x = big +
//   small, each half rounded to the nearest TF32 value, and a b ~
//   a_s b_b + a_b b_s + a_b b_b, the small terms first;
// - wgmma.mma_async for bf16 operands with fp32 accumulation: the
//   shared-memory matrix descriptor of the no-swizzle (interleaved)
//   layout, the fence / commit / wait of a warpgroup, the product with
//   both operands in shared memory (SS) and with A in registers (RS);
// - wgmma.mma_async for tf32 operands (k8), SS and RS, with fp32
//   accumulation; both shared-memory operands K-major (tf32 has no
//   MN-major form); a bulk copy (the TMA unit, no tensor map) of a
//   contiguous block into shared memory;
// - setmaxnreg, which hands registers from a producer warpgroup to the
//   consumer warpgroups;
// - on the host, the 4-D tensor map of a bf16 (B, S, heads, D) operand
//   that the TMA copies read.
//
// Fragment layouts (g = lane / 4, t = lane % 4), as the PTX ISA gives
// them:
//   m16n8k8 tf32  A: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//                 B: b0 (k t, n g)  b1 (k t+4, n g)
//                 C: c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   wgmma m64nN   D: warp w of the warpgroup holds rows 16w..16w+15;
//                 d[4i + {0,1,2,3}] = C of the i-th 8-column slice
//                 RS A (bf16, k16): a0 (g, 2t..2t+1)  a1 (g+8, 2t..2t+1)
//                             a2 (g, 2t+8..+9) a3 (g+8, 2t+8..+9)
//                 RS A (tf32, k8): a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)
//                             a3 (g+8, t+4), rows of warp w's 16 as D's,
//                             one float32 word a register read as TF32
//                             from its top 19 bits
//
// The no-swizzle layout stores a matrix as core matrices of 8 rows x
// 16 bytes, each 128 contiguous bytes (one row per 16 bytes).  In a
// descriptor (CUTLASS's GmmaDescriptor, cute/arch/mma_sm90_desc.hpp),
// SBO is the byte step between core matrices along M or N and LBO the
// step along K, for K-major and MN-major operands alike.  A swizzled
// layout (what TMA writes with CU_TENSOR_MAP_SWIZZLE_{32,64,128}B) keeps
// rows of W = 32, 64 or 128 bytes in atoms of 8 rows (8W bytes, aligned
// to 8W): K-major, SBO is the step between atoms along M/N and a k16
// step advances the start by 32 bytes inside the row; MN-major, SBO is
// the step between atoms along K and LBO between blocks of W bytes
// along M/N.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- cp.async
// 16 bytes from gmem to smem; when !ok nothing is read and the 16 bytes
// are zero-filled (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes (one float), the same rule
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------ TF32
// x = big + small, each rounded to the nearest TF32 value, ties away
// from zero (the rounding of cvt.rna.tf32.f32, for finite x), on the
// integer pipe: add half a TF32 step (bit 12) to the bits, then clear
// the low 13.  big clears them; small need not, since a TF32 product
// ignores them.  small = x - big is exact in float32 and at most half a
// TF32 step of x, so the pair holds x to 2^-23 of its magnitude (2^-21
// with the halves truncated instead), and a product drops only the
// small-by-small term, below 2^-22 of it: about 22 bits
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}
// x = big + small exactly, for an operand stored in shared memory: big
// rounded to the nearest TF32 value as split rounds it (to TF32 truncated
// where that rounding would carry into the exponent of infinity), its low
// 13 bits clear; small = x - big in float32, exact, which a TF32 product
// reads truncated to its top 19 bits (about 21 bits of x in all); a zero
// small takes x's sign, so that big + small is x bit for bit, -0 too
__device__ __forceinline__ void split_exact(float x, float& big,
                                            float& small) {
  const uint32_t u = __float_as_uint(x);
  uint32_t r = (u + 0x1000u) & 0xffffe000u;
  if ((r & 0x7f800000u) == 0x7f800000u) r = u & 0xffffe000u;
  big = __uint_as_float(r);
  small = x - big;
  if (small == 0.f) small = copysignf(0.f, x);
}
// a bf16 value widened to float32 is exact in TF32
__device__ __forceinline__ uint32_t exact(float x) { return __float_as_uint(x); }

// d += a b, one m16n8k8 TF32 product (not volatile: a pure function of
// its registers, which the compiler may interleave with independent ones)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b in 3xTF32: the two small cross terms
// first, then the big product.  An operand that is exact in TF32 (a
// bf16 value widened) has no small half, and its cross term is skipped:
// two passes when one operand is exact, one when both are.
template <bool A_EXACT = false, bool B_EXACT = false>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  if constexpr (!A_EXACT) mma_tf32(d, as, bb);
  if constexpr (!B_EXACT) mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}
// one operand value from shared memory, as big and small TF32 halves
__device__ __forceinline__ void split_ld(float x, uint32_t& big,
                                         uint32_t& small) {
  split(x, big, small);
}
__device__ __forceinline__ void split_ld(__nv_bfloat16 x, uint32_t& big,
                                         uint32_t& small) {
  big = exact(__bfloat162float(x));
  small = 0u;
}

// ------------------------------------------------------- TMA, mbarrier
// mbarrier in shared memory: init with an arrival count, arrive (with
// a count of bytes the tensor copies will complete), wait on a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// arrive where pred holds, by a predicated instruction (no branch: a
// warpgroup with products in flight may run it, where a branch on the
// lane would make ptxas serialize the products)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed; a wait that
// never ends traps (a launch error) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();
  }
}
// the same wait without the trap, for kernels whose roles take their own
// register counts by setmaxnreg: a trap in their code makes ptxas give
// every role the launch's count.  After about 2^24 polls it returns as if
// the phase had completed, so a barrier that never completes gives wrong
// numbers and not a card that hangs.
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0; n < (1u << 24); ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}
// bytes (a multiple of 16) from a contiguous block at src to dst, both
// 16-byte aligned, by the TMA unit, completing on bar's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// one box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ----------------------------------------------------------------- wgmma
// descriptor of an operand at smem address addr; lbo and sbo in bytes
// (multiples of 16); swizzle the row width in bytes of the swizzle atom
// (8 rows): 128, 64, 32, or 0 for the no-swizzle layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int swizzle = 0) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2
                          : swizzle == 32 ? 3 : 0;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
// shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to the async proxy that wgmma reads through; then a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// accumulator registers may not be touched while a wgmma that writes
// them is in flight: this keeps the compiler from moving them
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (+)= A B over k16: A (64 x 16) and B (16 x 128) both K-major in shared
// memory, described by da and db; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (+)= A B over k16: A (64 x 16) and B (16 x 64) both K-major in shared
// memory, described by da and db; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d += A B over k16: A (64 x 16) bf16 in registers (the m64 accumulator
// layout, two values to a register), B (16 x 16) MN-major in shared
// memory, described by db.
__device__ __forceinline__ void wgmma_rs_m64n16k16(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d += A B over k16: A (64 x 16) bf16 in registers (the m64 accumulator
// layout, two values to a register), B (16 x 32) MN-major in shared
// memory, described by db.
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d += A B over k16: A (64 x 16) bf16 in registers (the m64 accumulator
// layout, two values to a register), B (16 x 64) MN-major in shared
// memory, described by db.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d += A B over k16: A (64 x 16) bf16 in registers (the m64 accumulator
// layout, two values to a register), B (16 x 128) MN-major in shared
// memory, described by db.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the SS product of width N (64 or 128) and the RS product of width N
// (16, 32, 64 or 128), picked at compile time
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "SS wgmma at N 64 or 128");
  if constexpr (N == 64) wgmma_ss_m64n64k16(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_ss_m64n128k16(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "RS wgmma at N 16, 32, 64 or 128");
  if constexpr (N == 16) wgmma_rs_m64n16k16(d, a, db);
  if constexpr (N == 32) wgmma_rs_m64n32k16(d, a, db);
  if constexpr (N == 64) wgmma_rs_m64n64k16(d, a, db);
  if constexpr (N == 128) wgmma_rs_m64n128k16(d, a, db);
}

// ---------------------------------------------------------- tf32 wgmma
// Each k8 step reads 32 bytes of a K-major row, as a k16 step of bf16
// does: in a 128-byte swizzled tile, step kk starts 32 kk bytes into the
// rows of its atom column, SBO 1024 (8 rows of 128 bytes).  The D
// fragment is the bf16 products' (d[4i + e], above); A in registers takes
// the tf32 layout above, so an accumulator slice passes to the A operand
// of the next product with its k slots t and t + 4 taken as columns 2t
// and 2t + 1 (a0 = d[4i], a1 = d[4i + 2], a2 = d[4i + 1], a3 = d[4i + 3]),
// and the B operand must hold its k rows in that order in each group of
// 8: 0, 2, 4, 6, 1, 3, 5, 7.
// d (+)= A B over k8 in TF32: A (64 x 8) and B (8 x 32) both K-major in
// shared memory, described by da and db; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_ss_m64n32k8(float (&d)[16], uint64_t da,
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (+)= A B over k8 in TF32: A (64 x 8) and B (8 x 64) both K-major in
// shared memory, described by da and db; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_ss_m64n64k8(float (&d)[32], uint64_t da,
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d[OFF..] += A B over k8 in TF32: A (64 x 8) in registers (the tf32 A
// fragment above), B (8 x 16) K-major in shared memory, described by db;
// the 8 accumulators from d[OFF] (a 16-column slice of a wider D)
template <int OFF, int R>
__device__ __forceinline__ void wgmma_tf32_rs_m64n16k8(float (&d)[R],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  static_assert(OFF + 8 <= R, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[OFF..] += A B over k8 in TF32: A (64 x 8) in registers (the tf32 A
// fragment above), B (8 x 32) K-major in shared memory, described by db;
// the 16 accumulators from d[OFF] (a 32-column slice of a wider D)
template <int OFF, int R>
__device__ __forceinline__ void wgmma_tf32_rs_m64n32k8(float (&d)[R],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  static_assert(OFF + 16 <= R, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// the SS product of width N (32 or 64), and the RS product of width N (16
// or 32) into d[OFF..], picked at compile time
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64, "tf32 SS wgmma at N 32 or 64");
  if constexpr (N == 32) wgmma_tf32_ss_m64n32k8(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_tf32_ss_m64n64k8(d, da, db, scale_d);
}
template <int N, int OFF, int R>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[R],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(N == 16 || N == 32, "tf32 RS wgmma at N 16 or 32");
  if constexpr (N == 16) wgmma_tf32_rs_m64n16k8<OFF>(d, a, db);
  if constexpr (N == 32) wgmma_tf32_rs_m64n32k8<OFF>(d, a, db);
}

// ------------------------------------------------------------- setmaxnreg
// Registers handed between warpgroups (sm_90a): every warp of a
// warpgroup that exists runs it (a warpgroup may be a lone warp).  dec
// lowers the warpgroup's count a thread to N and returns the rest to the
// CTA's pool; inc waits until the pool holds enough to raise it to N.
// ptxas honours it only where the roles split once and never rejoin.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// a barrier among the n threads (whole warps) that name barrier id (1-15;
// __syncthreads is barrier 0)
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ------------------------------------------------------- tensor maps (host)
// A 4-D tensor map of float32 or bf16 values: dims d[0] (unit stride) ..
// d[3], byte strides st[0..2] of dims 1..3, boxes of box[0..3] values
// written with the sw-byte swizzle (0 none, else 128, 64 or 32); values
// past the tensor, and columns past d[0] in a box that crosses it, read
// as zeros.  A dimension of size 1 is never stepped: its stride is taken
// as the tensor's span, so that it is aligned and aliases no other.
inline bool make_map(CUtensorMap* map, bool bf16, const void* base,
                     const long long (&d)[4], const long long (&st)[3],
                     const int (&box)[4], int sw) {
  long long span = d[0] * (bf16 ? 2 : 4);
  for (int i = 0; i < 3; ++i)
    if (d[i + 1] > 1 && st[i] * d[i + 1] > span) span = st[i] * d[i + 1];
  const cuuint64_t dims[4] = {(cuuint64_t)d[0], (cuuint64_t)d[1],
                              (cuuint64_t)d[2], (cuuint64_t)d[3]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = (cuuint64_t)(d[i + 1] == 1 ? span : st[i]);
  const cuuint32_t boxes[4] = {(cuuint32_t)box[0], (cuuint32_t)box[1],
                               (cuuint32_t)box[2], (cuuint32_t)box[3]};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             4, const_cast<void*>(base), dims, strides, boxes, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             sw == 0    ? CU_TENSOR_MAP_SWIZZLE_NONE
             : sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
             : sw == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
