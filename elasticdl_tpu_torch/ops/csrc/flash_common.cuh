// Pieces shared by the flash-attention kernels for Hopper (sm_90a): the
// f32 kernels' tile sizes, tile loader and per-warp CUDA-core products
// (the bf16 kernels' pieces are in flash_sm90.cuh), and the dispatch on
// dtype and head dim.  Included by flash_fwd.cu and flash_bwd.cu.
//
// Layout: (B, S, heads, D), contiguous; a (b, head) sequence has row
// stride heads*D, which is how the kernels fold (B, S, H, D) into the TPU
// code's (B*H, S, D) without moving data.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace edl_flash {

constexpr int kBlockM = 64;  // rows of the tile a block owns
constexpr int kBlockN = 64;  // rows of each tile it loops over
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = kBlockM / kWarps;  // 16 rows per warp
constexpr float kNegInf = -1e30f;            // the TPU kernel's _NEG_INF

// Copy rows [row0, row0 + kRows) of one (b, head) sequence into a dense
// [kRows][D] shared tile, 16 bytes per thread per step; rows at or past
// n_valid are zero (the ragged edge).
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int n_valid, long row_stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = D / kVec;
  for (int i = threadIdx.x; i < kRows * kVecsPerRow; i += kThreads) {
    const int r = i / kVecsPerRow;
    const int c = (i % kVecsPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * D + c) = val;
  }
}

// ---- the two products, per warp (f32) ------------------------------------
// abt: s[16][N] = a[16][D] . b[N][D]^T          (s: f32, ld kBlockN)
// ab:  o[16][D] += p[16][N] . v[N][D]           (o: f32, ld D)
// The f32 forward uses them as S = Q K^T and O += P V; the f32 backward
// as S = Q K^T, dP = dO V^T, dQ += dS K (per q row) and S^T = K Q^T,
// dP^T = V dO^T, dV += P^T dO, dK += dS^T Q (per k row).

template <typename T, int D> struct WarpMma;

template <int D> struct WarpMma<float, D> {
  // CUDA-core FMAs in f32.  Lane l owns columns l and l + 32 of the abt
  // product (all 16 rows) and columns l, l + 32, ... of the ab product.
  // The reduction index is rotated by the lane so that lanes reading
  // rows D floats apart hit different shared-memory banks.
  static __device__ __forceinline__ void abt(const float* a, const float* b,
                                             float* s) {
    const int lane = threadIdx.x & 31;
    float acc[kWarpRows][2];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) acc[r][0] = acc[r][1] = 0.0f;
    for (int i = 0; i < D; ++i) {
      const int d = (i + lane) % D;
      const float b0 = b[lane * D + d];
      const float b1 = b[(lane + 32) * D + d];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        const float av = a[r * D + d];
        acc[r][0] = fmaf(av, b0, acc[r][0]);
        acc[r][1] = fmaf(av, b1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      s[r * kBlockN + lane] = acc[r][0];
      s[r * kBlockN + lane + 32] = acc[r][1];
    }
  }

  static __device__ __forceinline__ void ab(const float* p, const float* v,
                                            float* o) {
    const int lane = threadIdx.x & 31;
    constexpr int kCols = D / 32;
    float acc[kWarpRows][kCols];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = o[r * D + lane + 32 * c];
    }
    for (int j = 0; j < kBlockN; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = v[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        const float pr = p[r * kBlockN + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pr, vv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[r * D + lane + 32 * c] = acc[r][c];
    }
  }
};

// Instantiate launcher L<T, D> for the runtime dtype (0 = float32,
// 1 = bfloat16) and head dim (32, 64, 128); anything else is refused.
template <template <typename, int> class L, typename... Args>
cudaError_t dispatch(int dtype, int head_dim, Args... args) {
  if (dtype == 0) {
    switch (head_dim) {
      case 32: return L<float, 32>::run(args...);
      case 64: return L<float, 64>::run(args...);
      case 128: return L<float, 128>::run(args...);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 32: return L<__nv_bfloat16, 32>::run(args...);
      case 64: return L<__nv_bfloat16, 64>::run(args...);
      case 128: return L<__nv_bfloat16, 128>::run(args...);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace edl_flash

extern "C" const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
