// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, bound to
// Python through a plain C interface (ctypes; built by
// elasticdl_tpu_torch/ops/_build.py).
//
// Replaces: the Pallas TPU kernels _flash_dq_kernel and _flash_dkv_kernel
// in elasticdl_tpu/ops/attention.py, driven there by _flash_backward.
// Given the forward's q, k, v, its row logsumexp lse of the SCALED scores,
// the output gradient dO and delta = rowsum(dO * O) (a torch reduction in
// the wrapper, as the JAX package keeps it outside its kernels):
//   P  = exp(sm_scale * Q K^T - lse)      rebuilt per tile, never stored
//   dP = dO V^T,   dS = P * (dP - delta)
//   dQ = sm_scale * dS K,   dK = sm_scale * dS^T Q,   dV = P^T dO
// Causal masking is in global positions (row >= col); a masked P is 0,
// as exp(-1e30 - lse) is in the TPU kernels.  GQA: q head h reads kv
// head h / (heads / kv_heads), the map of _kv_head there.
//
// Layout: q, dO, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KVH, D), all
// contiguous; lse and delta (B*H, Sq) f32.
//
// Bound at the training shape (B=8, S=2048, H=12, D=64, bf16, causal):
// B*H*D*pairs = 12.9 G with pairs = S(S+1)/2, so dQ does three products,
// 6 * 12.9 G = 77 GFLOP (78 us at 989 TFLOP/s), and dK/dV four, 103 GFLOP
// (104 us); each moves about 100-130 MB (30-40 us at 3.35 TB/s).  Both
// are bound by operations, so every product runs on wgmma and nothing
// but the inputs and the outputs touches device memory.
//
// Two kernels, so that every output is written once by one block and
// nothing needs atomics (results are bit-reproducible, and dK/dV sum a
// GQA group in f32 before rounding once).  bf16, both kernels: a
// persistent grid of one block of three warpgroups per SM, walking a
// list of 128-row work tiles longest first (a snake over the blocks, as
// the forward does).
// - Warpgroup 0 is the producer: it hands most of its registers to the
//   consumers (setmaxnreg) and one thread issues the TMA loads over 4-d
//   tensor maps of the (B, S, H, D) tensors (the head is a coordinate;
//   rows past S load as zeros): the work tile's two resident tiles, then
//   streamed tiles into a ring of 4 shared-memory stages, each guarded
//   by a "full" mbarrier (TMA counts its bytes in) and an "empty" one
//   (every consumer warp arrives when done with it).  The ring runs on
//   across work tiles; the next work tile's resident tiles load as soon
//   as the last product that reads this one's is done.
// - Warpgroups 1 and 2 each own 64 rows of the work tile and keep S, dP,
//   P, dS and their output accumulators in registers.  Products that
//   make S or dP read both operands K-major from swizzled shared memory;
//   products that accumulate take P or dS as register A fragments (packed
//   straight from the f32 accumulators, as the forward packs P) and read
//   the streamed or resident tile MN-major (the transpose bit).  The
//   accumulating products of one streamed tile are still running while
//   the next tile's S and dP are issued and waited for, so the tensor
//   cores run under the elementwise work; the two warpgroups share them
//   freely (the forward's ping-pong turns measured slower here, where
//   the elementwise work is shorter than the products).  Only tiles that
//   cross the causal diagonal or the ragged end are masked.
// - dQ (flash_bwd_dq_sm90_kernel): the work tile is 128 q rows of one
//   (batch, q head); resident Q and dO; streamed k/v tiles of 128 rows
//   (64 at D 128) up to the diagonal.  Per k/v tile: S = Q K^T,
//   dP = dO V^T, then P = 2^(S * sm_scale * log2 e - lse * log2 e) and dS
//   with each row's lse and delta in registers, and dQ += dS K.
// - dK/dV (flash_bwd_dkv_sm90_kernel): the work tile is 128 k rows of one
//   (batch, kv head); resident K and V; streamed q/dO tiles of 64 rows
//   (32 at D 128) of every q head of its GQA group, from the diagonal on
//   (only the TMA head coordinate changes between heads).  Each stage
//   also carries its q rows' lse (log2 units; +inf past S, so those
//   columns' P is 0) and delta, written by the producer warp's lanes
//   (arrivals beside TMA's bytes on the stage's full barrier).  Per q
//   tile, on the transposed
//   products: S^T = K Q^T, dP^T = V dO^T, P^T and dS^T with the columns'
//   lse and delta from the stage, then dV += P^T dO and dK += dS^T Q.
// - Epilogue: the f32 accumulator times sm_scale (dV: 1), rounded to bf16
//   once, 16 bytes a store straight from registers.
// P and dS are rounded to bf16 before their products, as the forward
// rounds P.
//
// f32: wgmma has no f32 x f32 form (TF32 would round the inputs), so f32
// stays on the CUDA cores (flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel):
// one block of 4 warps per 64-row tile, each warp owning 16 rows, every
// tile and product in shared memory, loaded synchronously.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace edl_flash;
using namespace edl_sm90;

// ---- bf16: wgmma, TMA and an mbarrier ring ----------------------------------

constexpr int kWgRows = 64;  // rows of the work tile per consumer warpgroup
constexpr int kConsumerWgs = 2;
constexpr int kTileRows = kWgRows * kConsumerWgs;  // rows per work tile
constexpr int kSm90Threads = 128 * (1 + kConsumerWgs);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 40*128 + 232*256 <= 65536
constexpr int kStages = 4;
// Every block takes more than half of the SM's shared memory, so that two
// blocks of the persistent grid never share an SM.
constexpr int kMinSmemBytes = 120 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

// rows of each streamed tile, as many as the registers hold: k/v rows for
// dQ (S, dP, dS and dQ); q/dO rows for dK/dV (S^T, dP^T, P^T, dS^T, dK
// and dV)
template <int D> constexpr int kDqStreamRows = D == 128 ? 64 : 128;
template <int D> constexpr int kDkvStreamRows = D == 128 ? 32 : 64;

// Shared-memory carve-up of one block: two resident tiles of kTileRows
// rows, then the ring (stage s: two streamed tiles of kRows rows), then
// each stage's lse and delta (kRows f32 each; dK/dV only), then the
// barriers res_full, res_empty, full[kStages], empty[kStages].  Every
// tile starts on a 1024-byte boundary.
template <int D, int kRows> struct BwdLayout {
  using Tile = ChunkedTile<D>;
  static constexpr uint32_t res_bytes = Tile::bytes(kTileRows);
  static constexpr uint32_t str_bytes = Tile::bytes(kRows);
  static constexpr uint32_t res0 = 0;
  static constexpr uint32_t res1 = res_bytes;
  static constexpr uint32_t ring = 2 * res_bytes;
  static __device__ __forceinline__ uint32_t str0(int s) {
    return ring + 2 * s * str_bytes;
  }
  static __device__ __forceinline__ uint32_t str1(int s) {
    return str0(s) + str_bytes;
  }
  static constexpr uint32_t stats = ring + 2 * kStages * str_bytes;
  static __device__ __forceinline__ uint32_t lse(int s) {
    return stats + s * 2 * kRows * 4;
  }
  static __device__ __forceinline__ uint32_t delta(int s) {
    return lse(s) + kRows * 4;
  }
  static constexpr uint32_t bars = stats + kStages * 2 * kRows * 4;
  static constexpr uint32_t bytes = bars + 8 * (2 + 2 * kStages);
  // + slack to align the base to 1024 bytes
  static constexpr int alloc =
      bytes + 1024 > kMinSmemBytes ? bytes + 1024 : kMinSmemBytes;
  static_assert(str_bytes % 1024 == 0 && res_bytes % 1024 == 0,
                "tiles on swizzle-atom boundaries");
  static_assert(alloc <= 232448, "shared memory of one block");
};

// One work tile: kTileRows rows (from row0) of one (batch, head) out of
// `count` of them, `levels` tiles deep.  The list runs level by level,
// the last level first if `last_first` (so that causal tiles come longest
// first); block k takes entries k, 2G - 1 - k, 2G + k, ... of it (G
// blocks, a snake, so that no block takes the longest of every round).
struct WorkTile {
  int b, h, row0;
  bool valid;
  __device__ __forceinline__ WorkTile(int round, int heads, int count,
                                      int levels, bool last_first) {
    const int k = round & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int w = round * gridDim.x + k;
    valid = w < count * levels;
    const int level = w / count;
    const int bh = w % count;
    b = bh / heads;
    h = bh % heads;
    row0 = (last_first ? levels - 1 - level : level) * kTileRows;
  }
};

// The barriers and tiles of one block, from the dynamic shared memory.
template <typename L> struct Smem {
  uint32_t base;            // shared-window address, 1024-aligned
  unsigned char* ptr;       // the same, generic
  __device__ __forceinline__ Smem(unsigned char* raw) {
    const uint32_t raw_u32 = smem_u32(raw);
    base = (raw_u32 + 1023u) & ~1023u;
    ptr = raw + (base - raw_u32);
  }
  __device__ __forceinline__ uint32_t res_full() const { return base + L::bars; }
  __device__ __forceinline__ uint32_t res_empty() const { return res_full() + 8; }
  __device__ __forceinline__ uint32_t full(int s) const {
    return res_full() + 16 + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return full(kStages) + 8 * s;
  }
  // one thread: the counts of the barriers (`full_count` arrivals on each
  // full barrier, one per consumer warp on each empty one)
  __device__ __forceinline__ void init(uint32_t full_count) const {
    mbar_init(res_full(), 1);
    mbar_init(res_empty(), 4 * kConsumerWgs);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), full_count);
      mbar_init(empty(s), 4 * kConsumerWgs);
    }
    mbar_fence_init();
  }
};

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_bwd_dq_sm90_kernel(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_do,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int batch, int heads,
                         int kv_heads, int seq_q, int seq_k, int causal,
                         float scale_log2, float sm_scale) {
  constexpr int kRows = kDqStreamRows<D>;
  using L = BwdLayout<D, kRows>;
  using Tile = ChunkedTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<L> sm(smem_raw);
  const int bh_count = batch * heads;
  const int q_tiles = (seq_q + kTileRows - 1) / kTileRows;
  const int group = heads / kv_heads;
  // exclusive bound on the kv rows the q tile at q0 sees, in streamed tiles
  auto k_tiles = [&](int q0) {
    const int col_end = causal ? min(seq_k, min(q0 + kTileRows, seq_q)) : seq_k;
    return (col_end + kRows - 1) / kRows;
  };

  if (threadIdx.x == 0) sm.init(1);
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_do);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int it = 0;  // k/v tiles loaded so far
      for (int round = 0;; ++round) {
        const WorkTile w(round, heads, bh_count, q_tiles, causal);
        if (!w.valid) break;
        // the consumers are done with the last work tile's q and dO
        mbar_wait(sm.res_empty(), (round & 1) ^ 1);
        mbar_arrive_expect_tx(sm.res_full(), 2 * L::res_bytes);
        load_rows<D, kTileRows>(sm.base + L::res0, &tm_q, sm.res_full(), w.h,
                                w.row0, w.b);
        load_rows<D, kTileRows>(sm.base + L::res1, &tm_do, sm.res_full(), w.h,
                                w.row0, w.b);
        const int n_tiles = k_tiles(w.row0);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % kStages;
          mbar_wait(sm.empty(s), ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(sm.full(s), 2 * L::str_bytes);
          load_rows<D, kRows>(sm.base + L::str0(s), &tm_k, sm.full(s),
                              w.h / group, t * kRows, w.b);
          load_rows<D, kRows>(sm.base + L::str1(s), &tm_v, sm.full(s),
                              w.h / group, t * kRows, w.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows of each work tile each
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int quad_col = 2 * (lane % 4);
    // this thread's accumulator rows: r_wg and r_wg + 8 of the warpgroup
    const int r_wg = 16 * warp + lane / 4;
    const uint32_t q_wg = sm.base + L::res0 + wg * kWgRows * Tile::kRowBytes;
    const uint32_t do_wg = sm.base + L::res1 + wg * kWgRows * Tile::kRowBytes;

    float dqacc[D / 2];
    float sacc[kRows / 2];   // S, then P in f32
    float dpacc[kRows / 2];  // dP, then dS in f32
    uint32_t dsa[kRows / 16][4];  // dS in bf16: the A fragments of dS K

    int it = 0;  // k/v tiles consumed so far
    for (int round = 0;; ++round) {
      const WorkTile w(round, heads, bh_count, q_tiles, causal);
      if (!w.valid) break;
      const int n_tiles = k_tiles(w.row0);
      const int wg_row0 = w.row0 + wg * kWgRows;
      const int row0 = wg_row0 + r_wg;
      const long bh = (long)w.b * heads + w.h;
      float lse2[2], dlt[2];  // this thread's rows' lse (log2 units), delta
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const bool live = row < seq_q;
        lse2[r] = live ? lse[bh * seq_q + row] * kLog2e : 0.0f;
        dlt[r] = live ? delta[bh * seq_q + row] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.0f;
      fence_operands(dqacc);
      mbar_wait(sm.res_full(), round & 1);

      // The products of k/v tile t - 1 (dQ += dS K) run while tile t's
      // S and dP are issued and waited for.
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = (it + t) % kStages;
        mbar_wait(sm.full(stage), ((it + t) / kStages) & 1);
        const uint32_t k_s = sm.base + L::str0(stage);
        const uint32_t v_s = sm.base + L::str1(stage);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss<kRows>(sacc, Tile::template k_major<kTileRows>(q_wg, kk),
                          Tile::template k_major<kRows>(k_s, kk), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss<kRows>(dpacc, Tile::template k_major<kTileRows>(do_wg, kk),
                          Tile::template k_major<kRows>(v_s, kk), kk > 0);
        }
        wgmma_commit();
        if (t > 0) {
          wgmma_wait<2>();  // dQ += dS K of tile t - 1 has landed
          fence_operands(dqacc);
#pragma unroll
          for (int kk = 0; kk < kRows / 16; ++kk) fence_operands(dsa[kk]);
          if (lane == 0) mbar_arrive(sm.empty((it + t - 1) % kStages));
        }
        wgmma_wait<1>();  // S has landed
        fence_operands(sacc);
        const int k0 = t * kRows;
        const bool masked = (causal && k0 + kRows - 1 > wg_row0) ||
                            k0 + kRows > seq_k;
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          const int r = (i / 2) % 2;
          float p = ex2(fmaf(sacc[i], scale_log2, -lse2[r]));
          if (masked) {
            const int col = k0 + 8 * (i / 4) + quad_col + (i % 2);
            if (col >= seq_k || (causal && col > row0 + 8 * r)) p = 0.0f;
          }
          sacc[i] = p;
        }
        wgmma_wait<0>();  // dP has landed
        fence_operands(dpacc);
        // the last product that reads q and dO is done
        if (t == n_tiles - 1 && lane == 0) mbar_arrive(sm.res_empty());
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          dpacc[i] = sacc[i] * (dpacc[i] - dlt[(i / 2) % 2]);
        }
        pack_a_fragments<kRows>(dpacc, dsa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          wgmma_rs<D>(dqacc, dsa[kk], Tile::template mn_major<kRows>(k_s, kk));
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_operands(dqacc);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) fence_operands(dsa[kk]);
      if (lane == 0) mbar_arrive(sm.empty((it + n_tiles - 1) % kStages));
      it += n_tiles;

      // ---- epilogue: sm_scale * dQ in bf16
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        store_row_bf16<D>(dqacc, r, sm_scale,
                          dq + (((long)w.b * seq_q + row) * heads + w.h) * D,
                          row < seq_q);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_bwd_dkv_sm90_kernel(__grid_constant__ const CUtensorMap tm_q,
                          __grid_constant__ const CUtensorMap tm_do,
                          __grid_constant__ const CUtensorMap tm_k,
                          __grid_constant__ const CUtensorMap tm_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int batch, int heads,
                          int kv_heads, int seq_q, int seq_k, int causal,
                          float scale_log2, float sm_scale) {
  constexpr int kRows = kDkvStreamRows<D>;
  using L = BwdLayout<D, kRows>;
  using Tile = ChunkedTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<L> sm(smem_raw);
  const int bkv_count = batch * kv_heads;
  const int k_tiles = (seq_k + kTileRows - 1) / kTileRows;
  const int q_tiles = (seq_q + kRows - 1) / kRows;
  const int group = heads / kv_heads;
  // causal: the first q tile with a row at or below the k tile's first
  // row; full attention: every q tile
  auto first_q_tile = [&](int k0) { return causal ? k0 / kRows : 0; };
  auto q_iters = [&](int k0) {
    return group * max(0, q_tiles - first_q_tile(k0));
  };

  // each full barrier: TMA's arrival and one per lane of the producer
  // warp, which writes the stage's lse and delta
  if (threadIdx.x == 0) sm.init(1 + 32);
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: its first warp keeps the ring full, lane 0
    // issuing the TMA loads
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_map(&tm_q);
        tma_prefetch_map(&tm_do);
        tma_prefetch_map(&tm_k);
        tma_prefetch_map(&tm_v);
      }
      int it = 0;  // q tiles loaded so far
      for (int round = 0;; ++round) {
        // causal k tiles in their natural order see the most q tiles first
        const WorkTile w(round, kv_heads, bkv_count, k_tiles, false);
        if (!w.valid) break;
        if (lane == 0) {
          // the consumers are done with the last work tile's k and v
          mbar_wait(sm.res_empty(), (round & 1) ^ 1);
          mbar_arrive_expect_tx(sm.res_full(), 2 * L::res_bytes);
          load_rows<D, kTileRows>(sm.base + L::res0, &tm_k, sm.res_full(),
                                  w.h, w.row0, w.b);
          load_rows<D, kTileRows>(sm.base + L::res1, &tm_v, sm.res_full(),
                                  w.h, w.row0, w.b);
        }
        const int t_first = first_q_tile(w.row0);
        for (int g = 0; g < group; ++g) {
          const int h = w.h * group + g;
          const long bh = (long)w.b * heads + h;
          for (int t = t_first; t < q_tiles; ++t, ++it) {
            const int s = it % kStages;
            const int q0 = t * kRows;
            mbar_wait(sm.empty(s), ((it / kStages) & 1) ^ 1);
            if (lane == 0) {
              mbar_arrive_expect_tx(sm.full(s), 2 * L::str_bytes);
              load_rows<D, kRows>(sm.base + L::str0(s), &tm_q, sm.full(s), h,
                                  q0, w.b);
              load_rows<D, kRows>(sm.base + L::str1(s), &tm_do, sm.full(s), h,
                                  q0, w.b);
            }
            float* lse_s = reinterpret_cast<float*>(sm.ptr + L::lse(s));
            float* delta_s = reinterpret_cast<float*>(sm.ptr + L::delta(s));
            // one row at a time: the producer runs on kProducerRegs
#pragma unroll 1
            for (int i = lane; i < kRows; i += 32) {
              const int row = q0 + i;
              const bool live = row < seq_q;
              lse_s[i] = live ? lse[bh * seq_q + row] * kLog2e
                              : __int_as_float(0x7f800000u);  // +inf: P = 0
              delta_s[i] = live ? delta[bh * seq_q + row] : 0.0f;
            }
            mbar_arrive(sm.full(s));  // releases this lane's stores
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 k rows of each work tile each
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int quad_col = 2 * (lane % 4);
    const int r_wg = 16 * warp + lane / 4;
    const uint32_t k_wg = sm.base + L::res0 + wg * kWgRows * Tile::kRowBytes;
    const uint32_t v_wg = sm.base + L::res1 + wg * kWgRows * Tile::kRowBytes;

    float dkacc[D / 2];
    float dvacc[D / 2];
    float sacc[kRows / 2];   // S^T, then P^T in f32
    float dpacc[kRows / 2];  // dP^T, then dS^T in f32
    uint32_t pa[kRows / 16][4];   // P^T in bf16: the A fragments of P^T dO
    uint32_t dsa[kRows / 16][4];  // dS^T in bf16: those of dS^T Q

    int it = 0;  // q tiles consumed so far
    for (int round = 0;; ++round) {
      const WorkTile w(round, kv_heads, bkv_count, k_tiles, false);
      if (!w.valid) break;
      const int kw0 = w.row0 + wg * kWgRows;  // the warpgroup's first k row
      const int krow0 = kw0 + r_wg;           // this thread's first k row
      const int t_first = first_q_tile(w.row0);
      const int n_iters = q_iters(w.row0);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.0f;
      fence_operands(dkacc);
      fence_operands(dvacc);
      mbar_wait(sm.res_full(), round & 1);
      if (n_iters == 0 && lane == 0) mbar_arrive(sm.res_empty());

      // The products of q tile i - 1 (dV += P^T dO, dK += dS^T Q) run
      // while tile i's S^T and dP^T are issued and waited for.
      int t = t_first;  // q tile of this iteration, within its q head
      for (int i = 0; i < n_iters; ++i, t = t + 1 < q_tiles ? t + 1 : t_first) {
        const int stage = (it + i) % kStages;
        mbar_wait(sm.full(stage), ((it + i) / kStages) & 1);
        const uint32_t q_s = sm.base + L::str0(stage);
        const uint32_t do_s = sm.base + L::str1(stage);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss<kRows>(sacc, Tile::template k_major<kTileRows>(k_wg, kk),
                          Tile::template k_major<kRows>(q_s, kk), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss<kRows>(dpacc, Tile::template k_major<kTileRows>(v_wg, kk),
                          Tile::template k_major<kRows>(do_s, kk), kk > 0);
        }
        wgmma_commit();
        if (i > 0) {
          wgmma_wait<2>();  // tile i - 1's dV and dK have landed
          fence_operands(dkacc);
          fence_operands(dvacc);
#pragma unroll
          for (int kk = 0; kk < kRows / 16; ++kk) {
            fence_operands(pa[kk]);
            fence_operands(dsa[kk]);
          }
          if (lane == 0) mbar_arrive(sm.empty((it + i - 1) % kStages));
        }
        wgmma_wait<1>();  // S^T has landed
        fence_operands(sacc);
        const float* lse_s = reinterpret_cast<const float*>(sm.ptr + L::lse(stage));
        const float* delta_s =
            reinterpret_cast<const float*>(sm.ptr + L::delta(stage));
        const int q0 = t * kRows;
        const bool masked = causal && q0 < kw0 + kWgRows - 1;
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          // columns 8j + quad_col, + 1 of every row of this thread
          const float2 l2 =
              *reinterpret_cast<const float2*>(lse_s + 8 * j + quad_col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // row krow0 + 8 (e / 2)
            float p = ex2(fmaf(sacc[4 * j + e], scale_log2,
                               e % 2 ? -l2.y : -l2.x));
            if (masked && q0 + 8 * j + quad_col + (e % 2) < krow0 + 8 * (e / 2)) {
              p = 0.0f;
            }
            sacc[4 * j + e] = p;
          }
        }
        pack_a_fragments<kRows>(sacc, pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          wgmma_rs<D>(dvacc, pa[kk], Tile::template mn_major<kRows>(do_s, kk));
        }
        wgmma_commit();
        wgmma_wait<1>();  // dP^T has landed; dV may still run
        fence_operands(dpacc);
        // the last product that reads k and v is done
        if (i == n_iters - 1 && lane == 0) mbar_arrive(sm.res_empty());
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(delta_s + 8 * j + quad_col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dpacc[4 * j + e] =
                sacc[4 * j + e] * (dpacc[4 * j + e] - (e % 2 ? d2.y : d2.x));
          }
        }
        pack_a_fragments<kRows>(dpacc, dsa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          wgmma_rs<D>(dkacc, dsa[kk], Tile::template mn_major<kRows>(q_s, kk));
        }
        wgmma_commit();
      }
      // unconditional, so that the compiler sees every accumulator land
      // before the epilogue on every path (else it serializes the wgmmas)
      wgmma_wait<0>();
      fence_operands(dkacc);
      fence_operands(dvacc);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        fence_operands(pa[kk]);
        fence_operands(dsa[kk]);
      }
      if (n_iters > 0 && lane == 0) {
        mbar_arrive(sm.empty((it + n_iters - 1) % kStages));
      }
      it += n_iters;

      // ---- epilogue: sm_scale * dK and dV in bf16, at the kv-head shape
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = krow0 + 8 * r;
        const long off = (((long)w.b * seq_k + row) * kv_heads + w.h) * D;
        store_row_bf16<D>(dkacc, r, sm_scale, dk + off, row < seq_k);
        store_row_bf16<D>(dvacc, r, 1.0f, dv + off, row < seq_k);
      }
    }
  }
}

// Tensor maps over q and dO (heads) and k and v (kv heads), with boxes
// of q_rows and kv_rows rows
template <int D>
cudaError_t backward_maps(CUtensorMap (&maps)[4], const void* q,
                          const void* dout, const void* k, const void* v,
                          int batch, int heads, int kv_heads, int seq_q,
                          int seq_k, int q_rows, int kv_rows) {
  using Tile = ChunkedTile<D>;
  cudaError_t err;
  if ((err = make_bf16_map_4d(&maps[0], q, D, heads, seq_q, batch, Tile::kCols,
                              q_rows, Tile::kTmaSwizzle)) != cudaSuccess ||
      (err = make_bf16_map_4d(&maps[1], dout, D, heads, seq_q, batch,
                              Tile::kCols, q_rows, Tile::kTmaSwizzle)) !=
          cudaSuccess ||
      (err = make_bf16_map_4d(&maps[2], k, D, kv_heads, seq_k, batch,
                              Tile::kCols, kv_rows, Tile::kTmaSwizzle)) !=
          cudaSuccess ||
      (err = make_bf16_map_4d(&maps[3], v, D, kv_heads, seq_k, batch,
                              Tile::kCols, kv_rows, Tile::kTmaSwizzle)) !=
          cudaSuccess) {
    return err;
  }
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

// The persistent grid over `work` tiles, after raising the kernel's
// shared-memory limit to `smem`; 0 on failure.
template <typename Kernel>
int persistent_grid(Kernel kernel, int smem, long work) {
  if (set_smem(kernel, smem) != cudaSuccess) return 0;
  const int sms = sm_count();
  if (sms <= 0 || work <= 0 || work > INT32_MAX / 2) return 0;
  return static_cast<int>(work < sms ? work : sms);
}

template <int D> struct Sm90Dq {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int batch, int heads,
                         int kv_heads, int seq_q, int seq_k, int causal,
                         float sm_scale, cudaStream_t stream) {
    using L = BwdLayout<D, kDqStreamRows<D>>;
    CUtensorMap maps[4];
    cudaError_t err = backward_maps<D>(maps, q, dout, k, v, batch, heads,
                                       kv_heads, seq_q, seq_k, kTileRows,
                                       kDqStreamRows<D>);
    if (err != cudaSuccess) return err;
    auto kernel = flash_bwd_dq_sm90_kernel<D>;
    const int grid = persistent_grid(
        kernel, L::alloc,
        (long)batch * heads * ((seq_q + kTileRows - 1) / kTileRows));
    if (grid == 0) return cudaErrorInvalidValue;
    kernel<<<grid, kSm90Threads, L::alloc, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse, delta,
        static_cast<__nv_bfloat16*>(dq), batch, heads, kv_heads, seq_q, seq_k,
        causal, sm_scale * kLog2e, sm_scale);
    return cudaGetLastError();
  }
};

template <int D> struct Sm90Dkv {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int batch,
                         int heads, int kv_heads, int seq_q, int seq_k,
                         int causal, float sm_scale, cudaStream_t stream) {
    constexpr int kRows = kDkvStreamRows<D>;
    using L = BwdLayout<D, kRows>;
    CUtensorMap maps[4];
    cudaError_t err = backward_maps<D>(maps, q, dout, k, v, batch, heads,
                                       kv_heads, seq_q, seq_k, kRows,
                                       kTileRows);
    if (err != cudaSuccess) return err;
    auto kernel = flash_bwd_dkv_sm90_kernel<D>;
    const int grid = persistent_grid(
        kernel, L::alloc,
        (long)batch * kv_heads * ((seq_k + kTileRows - 1) / kTileRows));
    if (grid == 0) return cudaErrorInvalidValue;
    kernel<<<grid, kSm90Threads, L::alloc, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        batch, heads, kv_heads, seq_q, seq_k, causal, sm_scale * kLog2e,
        sm_scale);
    return cudaGetLastError();
  }
};

// ---- f32: CUDA cores ----------------------------------------------------------

// dQ block: byte offsets, each a multiple of 128 bytes; dS overwrites dP.
template <int D> struct F32DqSmem {
  static constexpr size_t q = 0;                                   // [M][D]
  static constexpr size_t dout = q + kBlockM * D * sizeof(float);  // [M][D]
  static constexpr size_t k = dout + kBlockM * D * sizeof(float);  // [N][D]
  static constexpr size_t v = k + kBlockN * D * sizeof(float);     // [N][D]
  static constexpr size_t s = v + kBlockN * D * sizeof(float);     // [M][N]
  static constexpr size_t dp = s + kBlockM * kBlockN * sizeof(float);
  static constexpr size_t dq = dp + kBlockM * kBlockN * sizeof(float);
  static constexpr size_t bytes = dq + kBlockM * D * sizeof(float);  // [M][D]
};

// dK/dV block: the k tile's rows are M, the q tile's rows N; P overwrites
// S and dS overwrites dP.
template <int D> struct F32DkvSmem {
  static constexpr size_t k = 0;                                   // [M][D]
  static constexpr size_t v = k + kBlockM * D * sizeof(float);     // [M][D]
  static constexpr size_t q = v + kBlockM * D * sizeof(float);     // [N][D]
  static constexpr size_t dout = q + kBlockN * D * sizeof(float);  // [N][D]
  static constexpr size_t dk = dout + kBlockN * D * sizeof(float); // [M][D]
  static constexpr size_t dv = dk + kBlockM * D * sizeof(float);   // [M][D]
  static constexpr size_t s = dv + kBlockM * D * sizeof(float);    // [M][N]
  static constexpr size_t dp = s + kBlockM * kBlockN * sizeof(float);
  static constexpr size_t lse = dp + kBlockM * kBlockN * sizeof(float);  // [N]
  static constexpr size_t delta = lse + kBlockN * sizeof(float);         // [N]
  static constexpr size_t bytes = delta + kBlockN * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int heads, int kv_heads, int seq_q, int seq_k,
                        int causal, float sm_scale) {
  using L = F32DqSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q);
  float* do_s = reinterpret_cast<float*>(smem + L::dout);
  float* k_s = reinterpret_cast<float*>(smem + L::k);
  float* v_s = reinterpret_cast<float*>(smem + L::v);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp);
  float* dq_s = reinterpret_cast<float*>(smem + L::dq);

  // causal tiles near the bottom see the most kv tiles: issue them first
  const int q_tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = q_tile * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kvh = h / (heads / kv_heads);

  const long q_stride = (long)heads * D;
  const long kv_stride = (long)kv_heads * D;
  const long q_off = ((long)b * seq_q * heads + h) * D;
  const float* k_seq = k + ((long)b * seq_k * kv_heads + kvh) * D;
  const float* v_seq = v + ((long)b * seq_k * kv_heads + kvh) * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // elementwise layout: lane pair (2r, 2r+1) owns warp row r, half each
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = q0 + warp * kWarpRows + r;  // global q row
  const bool row_live = row < seq_q;
  const float lse_r = row_live ? lse[(long)bh * seq_q + row] : 0.0f;
  const float delta_r = row_live ? delta[(long)bh * seq_q + row] : 0.0f;

  load_tile<float, D, kBlockM>(q_s, q + q_off, q0, seq_q, q_stride);
  load_tile<float, D, kBlockM>(do_s, dout + q_off, q0, seq_q, q_stride);
  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) dq_s[i] = 0.0f;

  const int w_rows = warp * kWarpRows;
  float* s_w = s_s + w_rows * kBlockN;
  float* dp_w = dp_s + w_rows * kBlockN;
  float* dq_w = dq_s + w_rows * D;

  int col_end = seq_k;  // exclusive bound on the kv columns this tile sees
  if (causal) col_end = min(seq_k, min(q0 + kBlockM, seq_q));
  const int n_tiles = (col_end + kBlockN - 1) / kBlockN;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<float, D, kBlockN>(k_s, k_seq, k0, seq_k, kv_stride);
    load_tile<float, D, kBlockN>(v_s, v_seq, k0, seq_k, kv_stride);
    __syncthreads();

    WarpMma<float, D>::abt(q_s + w_rows * D, k_s, s_w);
    WarpMma<float, D>::abt(do_s + w_rows * D, v_s, dp_w);
    __syncwarp();

    for (int i = 0; i < 32; ++i) {
      const int j = half * 32 + ((i + lane) & 31);  // rotated: distinct banks
      const int col = k0 + j;
      const bool live = row_live && col < seq_k && (!causal || col <= row);
      const float p =
          live ? expf(s_w[r * kBlockN + j] * sm_scale - lse_r) : 0.0f;
      dp_w[r * kBlockN + j] = p * (dp_w[r * kBlockN + j] - delta_r);  // dS
    }
    __syncwarp();

    WarpMma<float, D>::ab(dp_w, k_s, dq_w);
    __syncwarp();
  }

  if (row_live) {
    const float* src = dq_w + r * D + half * (D / 2);
    float* dst = dq + q_off + row * q_stride + half * (D / 2);
    for (int i = 0; i < D / 2; ++i) dst[i] = src[i] * sm_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int heads, int kv_heads, int seq_q, int seq_k,
                         int causal, float sm_scale) {
  using L = F32DkvSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem + L::k);
  float* v_s = reinterpret_cast<float*>(smem + L::v);
  float* q_s = reinterpret_cast<float*>(smem + L::q);
  float* do_s = reinterpret_cast<float*>(smem + L::dout);
  float* dk_s = reinterpret_cast<float*>(smem + L::dk);
  float* dv_s = reinterpret_cast<float*>(smem + L::dv);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  // k tile 0 meets every causal q tile: natural order is longest first
  const int k0 = blockIdx.x * kBlockM;
  const int bkv = blockIdx.y;
  const int b = bkv / kv_heads;
  const int kvh = bkv % kv_heads;
  const int group = heads / kv_heads;

  const long q_stride = (long)heads * D;
  const long kv_stride = (long)kv_heads * D;
  const long kv_off = ((long)b * seq_k * kv_heads + kvh) * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int krow = k0 + warp * kWarpRows + r;  // global k row
  const bool krow_live = krow < seq_k;

  load_tile<float, D, kBlockM>(k_s, k + kv_off, k0, seq_k, kv_stride);
  load_tile<float, D, kBlockM>(v_s, v + kv_off, k0, seq_k, kv_stride);
  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) {
    dk_s[i] = 0.0f;
    dv_s[i] = 0.0f;
  }

  const int w_rows = warp * kWarpRows;
  float* s_w = s_s + w_rows * kBlockN;
  float* dp_w = dp_s + w_rows * kBlockN;

  // causal: the first q tile with a row at or below this tile's first
  // column (both tiles are 64 rows); full attention: every q tile
  const int t_first = causal ? k0 / kBlockN : 0;
  const int n_tiles = (seq_q + kBlockN - 1) / kBlockN;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const int bh = b * heads + h;
    const long q_off = ((long)b * seq_q * heads + h) * D;
    for (int t = t_first; t < n_tiles; ++t) {
      const int q0 = t * kBlockN;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<float, D, kBlockN>(q_s, q + q_off, q0, seq_q, q_stride);
      load_tile<float, D, kBlockN>(do_s, dout + q_off, q0, seq_q, q_stride);
      for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
        const bool live = q0 + i < seq_q;
        lse_s[i] = live ? lse[(long)bh * seq_q + q0 + i] : 0.0f;
        delta_s[i] = live ? delta[(long)bh * seq_q + q0 + i] : 0.0f;
      }
      __syncthreads();

      WarpMma<float, D>::abt(k_s + w_rows * D, q_s, s_w);    // S^T
      WarpMma<float, D>::abt(v_s + w_rows * D, do_s, dp_w);  // dP^T
      __syncwarp();

      for (int i = 0; i < 32; ++i) {
        const int j = half * 32 + ((i + lane) & 31);
        const int qrow = q0 + j;
        const bool live =
            krow_live && qrow < seq_q && (!causal || qrow >= krow);
        const float p =
            live ? expf(s_w[r * kBlockN + j] * sm_scale - lse_s[j]) : 0.0f;
        dp_w[r * kBlockN + j] = p * (dp_w[r * kBlockN + j] - delta_s[j]);
        s_w[r * kBlockN + j] = p;
      }
      __syncwarp();

      WarpMma<float, D>::ab(s_w, do_s, dv_s + w_rows * D);   // dV += P^T dO
      WarpMma<float, D>::ab(dp_w, q_s, dk_s + w_rows * D);   // dK += dS^T Q
      __syncwarp();
    }
  }

  if (krow_live) {
    const int c0 = half * (D / 2);
    const float* dk_src = dk_s + (w_rows + r) * D + c0;
    const float* dv_src = dv_s + (w_rows + r) * D + c0;
    float* dk_dst = dk + kv_off + krow * kv_stride + c0;
    float* dv_dst = dv + kv_off + krow * kv_stride + c0;
    for (int i = 0; i < D / 2; ++i) {
      dk_dst[i] = dk_src[i] * sm_scale;
      dv_dst[i] = dv_src[i];
    }
  }
}

template <int D> struct F32Dq {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int batch, int heads,
                         int kv_heads, int seq_q, int seq_k, int causal,
                         float sm_scale, cudaStream_t stream) {
    auto kernel = flash_bwd_dq_f32_kernel<D>;
    cudaError_t err = set_smem(kernel, F32DqSmem<D>::bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq_q + kBlockM - 1) / kBlockM, batch * heads);
    kernel<<<grid, kThreads, F32DqSmem<D>::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), heads, kv_heads, seq_q, seq_k, causal,
        sm_scale);
    return cudaGetLastError();
  }
};

template <int D> struct F32Dkv {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int batch,
                         int heads, int kv_heads, int seq_q, int seq_k,
                         int causal, float sm_scale, cudaStream_t stream) {
    auto kernel = flash_bwd_dkv_f32_kernel<D>;
    cudaError_t err = set_smem(kernel, F32DkvSmem<D>::bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq_k + kBlockM - 1) / kBlockM, batch * kv_heads);
    kernel<<<grid, kThreads, F32DkvSmem<D>::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), heads,
        kv_heads, seq_q, seq_k, causal, sm_scale);
    return cudaGetLastError();
  }
};

// the launchers of each dtype: f32 on CUDA cores, bf16 on wgmma + TMA
template <typename T, int D> struct Dq : F32Dq<D> {};
template <int D> struct Dq<__nv_bfloat16, D> : Sm90Dq<D> {};
template <typename T, int D> struct Dkv : F32Dkv<D> {};
template <int D> struct Dkv<__nv_bfloat16, D> : Sm90Dkv<D> {};

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma + TMA).  Each
// returns the cudaError_t of its launch (0 = success); the caller raises
// on anything else.
int edl_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, int batch, int heads, int kv_heads, int seq_q,
                     int seq_k, int head_dim, int causal, float sm_scale,
                     int dtype, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0) return cudaErrorInvalidValue;
  return dispatch<Dq>(dtype, head_dim, q, k, v, dout, lse, delta, dq, batch,
                      heads, kv_heads, seq_q, seq_k, causal, sm_scale,
                      static_cast<cudaStream_t>(stream));
}

int edl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, int batch, int heads, int kv_heads,
                      int seq_q, int seq_k, int head_dim, int causal,
                      float sm_scale, int dtype, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0) return cudaErrorInvalidValue;
  return dispatch<Dkv>(dtype, head_dim, q, k, v, dout, lse, delta, dk, dv,
                       batch, heads, kv_heads, seq_q, seq_k, causal,
                       sm_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
