// Pieces shared by the flash-attention kernels for Hopper (sm_90a):
// tile sizes, the tile loader and the two per-warp products the backward
// kernels and the f32 forward are built from (the bf16 forward's pieces
// are in flash_sm90.cuh).  Included by flash_fwd.cu and flash_bwd.cu.
//
// Layout: (B, S, heads, D), contiguous; a (b, head) sequence has row
// stride heads*D, which is how the kernels fold (B, S, H, D) into the TPU
// code's (B*H, S, D) without moving data.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace edl_flash {

constexpr int kBlockM = 64;  // rows of the tile a block owns
constexpr int kBlockN = 64;  // rows of each tile it loops over
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = kBlockM / kWarps;  // 16: one WMMA row tile
constexpr float kNegInf = -1e30f;            // the TPU kernel's _NEG_INF

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// ---- the two products, per warp ------------------------------------------
// abt: s[16][N] = a[16][D] . b[N][D]^T          (s: f32, ld kBlockN)
// ab:  o[16][D] += p[16][N] . v[N][D]           (o: f32, ld D)
// The forward uses them as S = Q K^T and O += P V; the backward as
// S = Q K^T, dP = dO V^T, dQ += dS K (per q row) and S^T = K Q^T,
// dP^T = V dO^T, dV += P^T dO, dK += dS^T Q (per k row).

template <typename T, int D> struct WarpMma;

template <int D> struct WarpMma<__nv_bfloat16, D> {
  using bf16 = __nv_bfloat16;
  using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                                       bf16, nvcuda::wmma::row_major>;
  using FragBCol = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                                          bf16, nvcuda::wmma::col_major>;
  using FragBRow = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                                          bf16, nvcuda::wmma::row_major>;
  using FragC =
      nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

  static __device__ __forceinline__ void abt(const bf16* a, const bf16* b,
                                             float* s) {
    using namespace nvcuda;
    FragC acc[kBlockN / 16];
#pragma unroll
    for (int n = 0; n < kBlockN / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + kk, D);
#pragma unroll
      for (int n = 0; n < kBlockN / 16; ++n) {
        // column-major B with ld D: B(k, n) = b[n][k], i.e. b^T
        FragBCol fb;
        wmma::load_matrix_sync(fb, b + n * 16 * D + kk, D);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 16; ++n) {
      wmma::store_matrix_sync(s + n * 16, acc[n], kBlockN,
                              wmma::mem_row_major);
    }
  }

  static __device__ __forceinline__ void ab(const bf16* p, const bf16* v,
                                            float* o) {
    using namespace nvcuda;
    FragA fa[kBlockN / 16];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      wmma::load_matrix_sync(fa[kk], p + kk * 16, kBlockN);
    }
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragC acc;
      wmma::load_matrix_sync(acc, o + n * 16, D, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        FragBRow fb;
        wmma::load_matrix_sync(fb, v + kk * 16 * D + n * 16, D);
        wmma::mma_sync(acc, fa[kk], fb, acc);
      }
      wmma::store_matrix_sync(o + n * 16, acc, D, wmma::mem_row_major);
    }
  }
};

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
