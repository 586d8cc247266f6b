// Hopper (sm_90a) building blocks for hand-written kernels: mbarrier
// waits and arrivals, TMA tensor loads, the warpgroup matrix
// multiply (wgmma) and its shared-memory descriptors, register
// reallocation between warpgroups, the tile layout TMA writes and the
// descriptors that read it, the bf16 epilogue from registers, and the
// host-side tensor-map encoder.  Included by flash_fwd.cu and flash_bwd.cu.
//
// Conventions: shared-memory addresses are 32-bit offsets in the shared
// window (smem_u32); a tile that TMA writes with a 128-byte (64-byte)
// swizzle starts on a 1024-byte (512-byte) boundary, so the swizzle phase
// the wgmma descriptors assume (base offset 0) holds.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edl_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make initialised barriers visible to the async proxy (TMA) and to the
// other threads of the block; follow with a block-wide barrier
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A barrier
// starts in phase 0, so waiting on parity 1 passes at once: that is how
// a producer finds every ring stage free on its first round.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Copy the box at coordinates (c0, c1, c2, c3) of a 4-d tensor map into
// shared memory at `dst`; the transfer counts its bytes down on `bar`.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- small pieces ------------------------------------------------------------

// 2^x on the special-function unit (inputs of -inf give +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// ---- warpgroups --------------------------------------------------------------

// Hand registers back (producer) or take them (consumers).  Every warp of
// the warpgroup executes it, on a path the compiler can see it on from
// the kernel's entry (one if/else on the warpgroup index).
template <uint32_t kRegs> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <uint32_t kRegs> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// a barrier over `threads` threads only (id 0 is __syncthreads')
__device__ __forceinline__ void named_barrier_sync(uint32_t id,
                                                   uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at a named barrier without waiting for it
__device__ __forceinline__ void named_barrier_arrive(uint32_t id,
                                                     uint32_t threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// Before the first wgmma of a batch, and after ordinary instructions
// wrote its register operands (accumulator or A fragments).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most kPending committed groups are still running
template <int kPending> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keep the compiler from moving reads or writes of a wgmma register
// operand across the asynchronous product: apply to every accumulator
// and A-fragment register after the wait (and to accumulators before
// the product).
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <typename T, int N>
__device__ __forceinline__ void fence_operands(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

// Swizzle modes, as the descriptor's layout field and TMA name them.
enum Swizzle : uint32_t { kSwizzle128B = 1, kSwizzle64B = 2 };

// The 64-bit shared-memory matrix descriptor of a wgmma operand:
// start address, leading and stride byte offsets (16-byte units) and
// the swizzle mode; base offset 0 (tiles sit on swizzle-atom boundaries).
//   K-major (the reduction index contiguous, rows of 64 or 128 bytes):
//     SBO = bytes between consecutive 8-row groups (8 rows), LBO unused.
//     A k-step of 16 elements moves the start address by 32 bytes.
//   MN-major (the output index contiguous, the transpose bit set):
//     SBO = bytes between consecutive 8-row groups along the reduction;
//     LBO = bytes between consecutive swizzle atoms along the output
//     index (64 elements at 128 bytes, 32 at 64 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, Swizzle swizzle) {
  uint64_t desc = (addr & 0x3FFFFu) >> 4;
  desc |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  desc |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  desc |= static_cast<uint64_t>(swizzle) << 62;
  return desc;
}

// The f32 accumulator of an m64nN product, per thread of the warpgroup
// (warp w, lane l): element 4j + 2h + e is row 16w + l/4 + 8h, column
// 8j + 2(l%4) + e.  The bf16 A fragment of an m64k16 product in
// registers has the same pattern over its 16 columns, so the accumulator
// of columns [16kk, 16kk + 16) packs into the A fragment of k-step kk:
// a[i] = bf16x2(acc[8kk + 2i], acc[8kk + 2i + 1]).

// D[64][128] (+)= A[64][16] . B[16][128], A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64][32] += A[64][16] . B[16][32], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D[64][64] += A[64][16] . B[16][64], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D[64][128] += A[64][16] . B[16][128], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D[64][64] (+)= A[64][16] . B[16][64], A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64][32] (+)= A[64][16] . B[16][32], A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64][N] (+)= A . B, both K-major in shared memory (the first k-step
// of a product passes scale_d 0 to overwrite D)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 32) wgmma_m64n32k16_ss(d, desc_a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_m64n64k16_ss(d, desc_a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_m64n128k16_ss(d, desc_a, desc_b, scale_d);
}

// D[64][N] += A . B, A in registers, B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (N == 32) wgmma_m64n32k16_rs(d, a, desc_b, 1);
  if constexpr (N == 64) wgmma_m64n64k16_rs(d, a, desc_b, 1);
  if constexpr (N == 128) wgmma_m64n128k16_rs(d, a, desc_b, 1);
}

// The A fragments of k-steps [0, N / 16) packed from an f32 accumulator
// over N columns (see the layout note above)
template <int N>
__device__ __forceinline__ void pack_a_fragments(const float (&acc)[N / 2],
                                                 uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
    }
  }
}

// ---- tiles in shared memory --------------------------------------------------

// A bf16 tile of D columns as TMA writes it: D / kCols column chunks of
// [rows][kCols], each swizzled (128-byte rows at D >= 64, 64-byte rows at
// D = 32) and starting on a swizzle-atom boundary, one TMA box each.
template <int D> struct ChunkedTile {
  static constexpr int kCols = D == 32 ? 32 : 64;  // columns per chunk
  static constexpr int kChunks = D / kCols;
  static constexpr uint32_t kRowBytes = kCols * 2;
  static constexpr Swizzle kSwizzle = D == 32 ? kSwizzle64B : kSwizzle128B;
  static constexpr CUtensorMapSwizzle kTmaSwizzle =
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr uint32_t kSbo = 8 * kRowBytes;  // 8 rows
  static constexpr uint32_t bytes(int rows) { return rows * D * 2; }

  // K-major operand (the reduction runs over the D columns), k-step kk:
  // rows from `tile` on, in a tile of kRows rows (`tile` may point
  // inside it, at a multiple of 8 rows)
  template <int kRows>
  static __device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
    const uint32_t chunk = (kk * 16) / kCols;
    const uint32_t within = ((kk * 16) % kCols) * 2;
    return make_desc(tile + chunk * kRows * kRowBytes + within, 16, kSbo,
                     kSwizzle);
  }
  // MN-major operand (the reduction runs over the rows, N = D; the
  // transpose bit set), k-step kk: rows [16kk, 16kk + 16) of a kRows-row
  // tile
  template <int kRows>
  static __device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
    return make_desc(tile + kk * 16 * kRowBytes, kRows * kRowBytes, kSbo,
                     kSwizzle);
  }
};

// TMA of the D columns of kRows rows at (row, head, batch) into the
// chunked tile at `dst`, one box per column chunk, counted on `bar`
template <int D, int kRows>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row,
                                          int b) {
  using Tile = ChunkedTile<D>;
#pragma unroll
  for (int c = 0; c < Tile::kChunks; ++c) {
    tma_load_4d(dst + c * kRows * Tile::kRowBytes, map, bar, c * Tile::kCols,
                head, row, b);
  }
}

// ---- epilogue ----------------------------------------------------------------

// Row r_wg + 8r (r = 0, 1) of this thread's m64nD f32 accumulator, times
// `scale`, rounded to bf16 and stored to the D values at `dst`, 16 bytes
// a store.  A quad holds a row's 8-column blocks two columns per thread;
// four shuffles turn every 4 blocks around so that each thread holds one
// whole.  Every lane of the warp calls it; only `live` rows are stored.
template <int D>
__device__ __forceinline__ void store_row_bf16(const float (&acc)[D / 2],
                                               int r, float scale,
                                               __nv_bfloat16* dst, bool live) {
  const int lane = threadIdx.x % 32;
  const int c = lane % 4;
  uint32_t words[D / 8];  // block j: columns 8j + 2c, + 1
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    words[j] = pack_bf16(acc[4 * j + 2 * r] * scale,
                         acc[4 * j + 2 * r + 1] * scale);
  }
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int g = 0; g < D / 32; ++g) {
    uint32_t block[4];  // block 4g + c, from quad threads 0..3
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // send thread (c + k) % 4 its share of block 4g + (c + k) % 4;
      // receive this thread's from thread (c - k) % 4
      const int to = (c + k) & 3;
      const int from = (c - k) & 3;
      uint32_t send = words[4 * g];
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        if (to == i) send = words[4 * g + i];
      }
      const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | from);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (from == i) block[i] = got;
      }
    }
    if (live) out[4 * g + c] = make_uint4(block[0], block[1], block[2], block[3]);
  }
}

// ---- host --------------------------------------------------------------------

// the number of SMs of the current device: a persistent grid's size
inline int sm_count() {
  int device = 0, count = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess) {
    return 0;
  }
  return count;
}

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda; null if the driver has none.
inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      ptr = nullptr;
    }
    return reinterpret_cast<TensorMapEncodeTiled>(ptr);
  }();
  return fn;
}

// A bf16 tensor map over a contiguous (d3, d2, d1, d0) array (d0
// innermost) with boxes of (1, box2, 1, box0) elements: for a
// (B, S, H, D) tensor, box0 columns of one head's box2 rows.  Elements
// past the array's edge load as zeros.
inline cudaError_t make_bf16_map_4d(CUtensorMap* map, const void* base,
                                    uint64_t d0, uint64_t d1, uint64_t d2,
                                    uint64_t d3, uint32_t box0, uint32_t box2,
                                    CUtensorMapSwizzle swizzle) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {box0, 1, box2, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace edl_sm90
