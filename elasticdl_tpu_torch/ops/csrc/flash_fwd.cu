// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; built by elasticdl_tpu_torch/ops/_build.py).
//
// Replaces: the Pallas TPU kernel _flash_kernel in
// elasticdl_tpu/ops/attention.py, driven there by _flash_forward.
// Computes, per (batch, q head) and q row:
//   s   = sm_scale * q . k_j           over the kv rows j it may see
//   out = sum_j softmax(s)_j v_j       in the input dtype
//   lse = logsumexp_j s_j              in f32 (of the SCALED scores)
// Causal masking is in global positions (row >= col), as in the TPU
// kernel.  GQA: q head h reads kv head h / (heads / kv_heads), the same
// map as _kv_head there.
//
// Layout: q, out (B, Sq, H, D); k, v (B, Sk, KVH, D), all contiguous;
// lse (B*H, Sq) f32.  The (B, S, H, D) -> (B*H, S, D) fold of the TPU
// code costs no data movement: the TMA tensor maps span (D, H, S, B),
// and a head is one coordinate of the box.
//
// Bound at the served shape (B=4, S=2048, H=12, D=64, bf16, causal):
//   work    2*B*H*S^2*D = 25.8 GFLOP (causal halves the two products),
//           26 us at the card's 989 TFLOP/s bf16 tensor-core peak;
//   traffic q, k, v, out = 50 MB, 15 us at 3.35 TB/s;
//   so it is bound by operations.  At D 64 the softmax's exponentials
//   (16 a clock per SM) take as long as the products, so the design
//   keeps the tensor cores and the special-function units busy at once:
//
// bf16 (flash_fwd_sm90_kernel): a persistent grid, one block of three
// warpgroups per SM, walking a list of work tiles (a 128-row q tile of
// one (batch, head); causal tiles longest first, dealt out in a snake).
// - Warpgroup 0 is the producer: it hands most of its registers to the
//   others (setmaxnreg) and one thread issues the TMA loads, a work
//   tile's q tile and then its 128-row k/v tiles into a ring of
//   shared-memory stages, each guarded by a "full" mbarrier (TMA counts
//   its bytes in) and an "empty" one (every consumer warp arrives when
//   done with it).  The ring runs on across work tiles, and the next q
//   tile loads as soon as the last product that reads this one is done,
//   so a tile's start overlaps the last one's end.
// - Warpgroups 1 and 2 each own 64 q rows of the work tile.  Per k/v
//   tile: S = Q K^T with wgmma (both operands K-major in swizzled shared
//   memory), the online softmax on the accumulator fragments in
//   registers (exp2 with sm_scale*log2(e) folded in; a row's max and sum
//   need two shuffles in its quad), P rounded to bf16 in registers and
//   O += P V with the register-A wgmma (V MN-major: the transpose bit).
//   Tile t's softmax overlaps P V of tile t - 1 in the same warpgroup,
//   and the two warpgroups take turns at the tensor cores (ping-pong),
//   so one's softmax runs under the other's products.  Only tiles that
//   cross the causal diagonal or the ragged end of the sequence are
//   masked; tiles past the diagonal are never loaded.
// - Epilogue: O / l in bf16 straight from registers, 16 bytes a store
//   after a shuffle within each quad; lse = ln2 * (m2 + log2 l) written
//   by the thread that owns the row.  Rows past the sequence arrive from
//   TMA as zeros and are never written, so any S works.
//
// f32 (flash_fwd_f32_kernel): wgmma has no f32 x f32 form (TF32 would
// round the inputs), so f32 stays on the CUDA cores: one block of 4 warps
// per (64-row q tile, b*H + h), each warp owning 16 q rows; S, P and the
// f32 output accumulator in shared memory.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace edl_flash;
using namespace edl_sm90;

// ---- bf16: wgmma, TMA and an mbarrier ring ----------------------------------

constexpr int kSm90BlockM = 128;  // q rows per work tile
constexpr int kWgRows = 64;       // q rows per consumer warpgroup
constexpr int kSm90BlockN = 128;  // kv rows per tile
constexpr int kConsumerWgs = kSm90BlockM / kWgRows;
constexpr int kSm90Threads = 128 * (1 + kConsumerWgs);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 40*128 + 232*256 <= 65536
// named barrier kTurnBarrier + wg: consumer warpgroup wg's turn at the
// tensor cores (0 is __syncthreads')
constexpr int kTurnBarrier = 1;
// Two blocks on one SM would ask for more registers than it has once the
// consumers grow to kConsumerRegs (and would leave another SM of the
// persistent grid idle), so every block takes more than half of the SM's
// shared memory.
constexpr int kMinSmemBytes = 120 * 1024;

// Shared-memory carve-up of one block.  A tile of R rows is stored as
// D / kCols column chunks of [R][kCols] bf16, each swizzled as TMA writes
// it (128-byte rows at D >= 64, 64-byte rows at D = 32), each starting on
// a 1024-byte boundary.
template <int D, int kStages> struct Sm90Layout {
  static constexpr int kCols = D == 32 ? 32 : 64;  // columns per chunk
  static constexpr int kChunks = D / kCols;
  static constexpr uint32_t kRowBytes = kCols * 2;
  static constexpr Swizzle kSwizzle = D == 32 ? kSwizzle64B : kSwizzle128B;
  static constexpr uint32_t q_chunk = kSm90BlockM * kRowBytes;
  static constexpr uint32_t kv_chunk = kSm90BlockN * kRowBytes;
  static constexpr uint32_t q_bytes = q_chunk * kChunks;
  static constexpr uint32_t kv_bytes = kv_chunk * kChunks;  // one k or v tile
  // q tile, then stage s's k tile and v tile, then the barriers:
  // q_full, q_empty, full[kStages], empty[kStages]
  static constexpr uint32_t q = 0;
  static constexpr uint32_t ring = q_bytes;
  static constexpr uint32_t bars = ring + 2 * kStages * kv_bytes;
  static __device__ __forceinline__ uint32_t k(int s) {
    return ring + 2 * s * kv_bytes;
  }
  static __device__ __forceinline__ uint32_t v(int s) {
    return k(s) + kv_bytes;
  }
  static constexpr uint32_t bytes = bars + 8 * (2 + 2 * kStages);
  // + slack to align the base to 1024 bytes
  static constexpr int alloc =
      bytes + 1024 > kMinSmemBytes ? bytes + 1024 : kMinSmemBytes;
  static_assert(alloc <= 232448, "shared memory of one block");
};

// O += P V at N = D
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 32) wgmma_m64n32k16_rs(o, a, b, 1);
  if constexpr (D == 64) wgmma_m64n64k16_rs(o, a, b, 1);
  if constexpr (D == 128) wgmma_m64n128k16_rs(o, a, b, 1);
}

// One work tile: a 128-row q tile of one (batch, head).  The list runs
// causal tiles longest first; block k takes entries k, 2G - 1 - k,
// 2G + k, ... of it (G blocks, a snake, so that no block takes the
// longest of every round).
struct WorkTile {
  int b, h, q0, n_tiles;
  bool valid;
  __device__ __forceinline__ WorkTile(int round, int heads, int bh_count,
                                      int q_tiles, int seq_q, int seq_k,
                                      int causal) {
    const int k = round & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int w = round * gridDim.x + k;
    valid = w < bh_count * q_tiles;
    const int level = w / bh_count;
    const int bh = w % bh_count;
    b = bh / heads;
    h = bh % heads;
    q0 = (causal ? q_tiles - 1 - level : level) * kSm90BlockM;
    // exclusive bound on the kv columns this q tile can see
    int col_end = seq_k;
    if (causal) col_end = min(seq_k, min(q0 + kSm90BlockM, seq_q));
    n_tiles = (col_end + kSm90BlockN - 1) / kSm90BlockN;
  }
};

template <int D, int kStages>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tm_q,
                      __grid_constant__ const CUtensorMap tm_k,
                      __grid_constant__ const CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int batch, int heads,
                      int kv_heads, int seq_q, int seq_k, int causal,
                      float scale_log2) {
  using L = Sm90Layout<D, kStages>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::q;
  const uint32_t bar_q_full = base + L::bars;
  const uint32_t bar_q_empty = bar_q_full + 8;
  const uint32_t bar_full = bar_q_empty + 8;          // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage
  const int bh_count = batch * heads;
  const int q_tiles = (seq_q + kSm90BlockM - 1) / kSm90BlockM;
  const int group = heads / kv_heads;

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, 4 * kConsumerWgs);  // one per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * kConsumerWgs);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full, across
    // this block's work tiles
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int it = 0;  // k/v tiles loaded so far
      for (int round = 0;; ++round) {
        const WorkTile w(round, heads, bh_count, q_tiles, seq_q, seq_k,
                         causal);
        if (!w.valid) break;
        // the consumers are done with the last tile's q
        mbar_wait(bar_q_empty, (round & 1) ^ 1);
        mbar_arrive_expect_tx(bar_q_full, L::q_bytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(q_s + c * L::q_chunk, &tm_q, bar_q_full, c * L::kCols,
                      w.h, w.q0, w.b);
        }
        for (int t = 0; t < w.n_tiles; ++t, ++it) {
          const int s = it % kStages;
          mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t full = bar_full + 8 * s;
          mbar_arrive_expect_tx(full, 2 * L::kv_bytes);
#pragma unroll
          for (int c = 0; c < L::kChunks; ++c) {
            tma_load_4d(base + L::k(s) + c * L::kv_chunk, &tm_k, full,
                        c * L::kCols, w.h / group, t * kSm90BlockN, w.b);
            tma_load_4d(base + L::v(s) + c * L::kv_chunk, &tm_v, full,
                        c * L::kCols, w.h / group, t * kSm90BlockN, w.b);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows of each work tile each
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int quad_col = 2 * (lane % 4);
    // this thread's accumulator rows: r_wg and r_wg + 8 of the warpgroup
    const int r_wg = 16 * warp + lane / 4;
    // the warpgroup's rows within each column chunk of the q tile
    const uint32_t q_wg = q_s + wg * kWgRows * L::kRowBytes;
    constexpr uint32_t kSbo = 8 * L::kRowBytes;  // 8 rows
    const float neg_inf = __int_as_float(0xff800000u);

    float o[D / 2];
    float m[2];  // running max, log2 units
    float l[2];  // this thread's share of the running sum
    float sacc[kSm90BlockN / 2];  // S, then P in f32
    uint32_t pa[kSm90BlockN / 16][4];  // P in bf16: the A fragments of P V
    float alpha[2];  // the rescale of the earlier tiles' O and l
    int wg_row0 = 0, row0 = 0;  // the warpgroup's and this thread's row

    // S = Q K^T on the k tile of `stage` (the first k-step overwrites S)
    auto issue_s = [&](int stage) {
      const uint32_t k_s = base + L::k(stage);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t chunk = (kk * 16) / L::kCols;
        const uint32_t within = ((kk * 16) % L::kCols) * 2;
        const uint64_t da = make_desc(q_wg + chunk * L::q_chunk + within, 16,
                                      kSbo, L::kSwizzle);
        const uint64_t db = make_desc(k_s + chunk * L::kv_chunk + within, 16,
                                      kSbo, L::kSwizzle);
        wgmma_m64n128k16_ss(sacc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V on the v tile of `stage`
    auto issue_pv = [&](int stage) {
      const uint32_t v_s = base + L::v(stage);
#pragma unroll
      for (int kk = 0; kk < kSm90BlockN / 16; ++kk) {
        const uint64_t dv = make_desc(v_s + kk * 16 * L::kRowBytes,
                                      L::kv_chunk, kSbo, L::kSwizzle);
        wgmma_pv<D>(o, pa[kk], dv);
      }
      wgmma_commit();
    };
    // the online softmax of kv tile t on S in registers: scale into log2
    // units, mask, raise the running max, S -> P = 2^(s - m), and fold
    // the row sums into l; leaves the rescale of O in alpha
    auto softmax = [&](int t) {
      const int k0 = t * kSm90BlockN;
      const bool masked = (causal && k0 + kSm90BlockN - 1 > wg_row0) ||
                          k0 + kSm90BlockN > seq_k;
#pragma unroll
      for (int i = 0; i < kSm90BlockN / 2; ++i) sacc[i] *= scale_log2;
      if (masked) {
#pragma unroll
        for (int i = 0; i < kSm90BlockN / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + quad_col + (i % 2);
          const int row = row0 + 8 * ((i / 2) % 2);
          if (col >= seq_k || (causal && col > row)) sacc[i] = neg_inf;
        }
      }
      float m_new[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kSm90BlockN / 2; ++i) {
        m_new[(i / 2) % 2] = fmaxf(m_new[(i / 2) % 2], sacc[i]);
      }
      // every row sees at least one live column in every tile it loads
      // (column k0 <= its row), so m_new is finite from the first tile on
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
        alpha[r] = ex2(m[r] - m_new[r]);  // 0 on the first tile
        m[r] = m_new[r];
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kSm90BlockN / 2; ++i) {
        sacc[i] = ex2(sacc[i] - m[(i / 2) % 2]);
        sum[(i / 2) % 2] += sacc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
    };
    // rescale O, then P in bf16 straight from the accumulator into the
    // A fragments
    auto rescale_and_pack = [&] {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
#pragma unroll
      for (int kk = 0; kk < kSm90BlockN / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[kk][j] = pack_bf16(sacc[8 * kk + 2 * j], sacc[8 * kk + 2 * j + 1]);
        }
      }
    };
    // The two warpgroups take turns at the tensor cores (ping-pong): each
    // issues its products only after the other has issued its own, so
    // one's softmax runs while the other's products do.  Barrier
    // kTurnBarrier + wg is "warpgroup wg's turn"; in every work tile
    // warpgroup 1 opens the first turn for warpgroup 0 and leaves its own
    // last turn unpassed, so every barrier completes as often as it is
    // waited on.
    auto take_turn = [&] { named_barrier_sync(kTurnBarrier + wg, 256); };
    auto pass_turn = [&] {
      named_barrier_arrive(kTurnBarrier + (1 - wg), 256);
    };
    // the last product that reads q has landed: q may be reloaded
    auto release_q = [&] {
      if (lane == 0) mbar_arrive(bar_q_empty);
    };

    int it = 0;  // k/v tiles consumed so far
    for (int round = 0;; ++round) {
      const WorkTile w(round, heads, bh_count, q_tiles, seq_q, seq_k, causal);
      if (!w.valid) break;
      const int n_tiles = w.n_tiles;
      wg_row0 = w.q0 + wg * kWgRows;
      row0 = wg_row0 + r_wg;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
      m[0] = m[1] = neg_inf;
      l[0] = l[1] = 0.0f;
      if (wg == 1) pass_turn();

      // Within a warpgroup, kv tile t's softmax runs while the tensor
      // cores do P V of tile t - 1: S_t and PV_{t-1} are issued together,
      // the wait for S_t leaves PV_{t-1} in flight, and O is touched only
      // once it has landed.
      mbar_wait(bar_q_full, round & 1);
      mbar_wait(bar_full + 8 * (it % kStages), (it / kStages) & 1);
      take_turn();
      wgmma_fence();
      issue_s(it % kStages);
      pass_turn();
      wgmma_wait<0>();
      fence_operands(sacc);
      if (n_tiles == 1) release_q();
      softmax(0);
      rescale_and_pack();
      for (int t = 1; t < n_tiles; ++t) {
        const int stage = (it + t) % kStages;
        const int prev = (it + t - 1) % kStages;
        mbar_wait(bar_full + 8 * stage, ((it + t) / kStages) & 1);
        fence_operands(o);
        take_turn();
        wgmma_fence();
        issue_s(stage);
        issue_pv(prev);
        pass_turn();
        wgmma_wait<1>();  // S_t has landed; PV_{t-1} may still run
        fence_operands(sacc);
        if (t == n_tiles - 1) release_q();
        softmax(t);
        wgmma_wait<0>();
        fence_operands(o);
#pragma unroll
        for (int kk = 0; kk < kSm90BlockN / 16; ++kk) fence_operands(pa[kk]);
        if (lane == 0) mbar_arrive(bar_empty + 8 * prev);  // stage is free
        rescale_and_pack();
      }
      const int last = (it + n_tiles - 1) % kStages;
      fence_operands(o);
      take_turn();
      wgmma_fence();
      issue_pv(last);
      if (wg == 0) pass_turn();
      wgmma_wait<0>();
      fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < kSm90BlockN / 16; ++kk) fence_operands(pa[kk]);
      if (lane == 0) mbar_arrive(bar_empty + 8 * last);
      it += n_tiles;

      // ---- epilogue: O / l in bf16, 16 bytes per store.  A quad holds
      // a row's 8-column blocks two columns per thread; four shuffles
      // turn every 4 blocks around so that each thread holds one whole.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const int c = lane % 4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const float inv_l = 1.0f / l[r];
        uint32_t words[D / 8];  // block j: columns 8j + quad_col, + 1
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          words[j] = pack_bf16(o[4 * j + 2 * r] * inv_l,
                               o[4 * j + 2 * r + 1] * inv_l);
        }
        uint4* dst = reinterpret_cast<uint4*>(
            out + (((long)w.b * seq_q + row) * heads + w.h) * D);
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
            const uint32_t got =
                __shfl_sync(0xffffffffu, send, (lane & ~3) | from);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (from == i) block[i] = got;
            }
          }
          if (row < seq_q) {
            dst[4 * g + c] = make_uint4(block[0], block[1], block[2], block[3]);
          }
        }
      }
      if (c == 0) {
        constexpr float kLn2 = 0.69314718055994530942f;
        const long bh = (long)w.b * heads + w.h;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < seq_q) {
            lse[bh * seq_q + row] = kLn2 * (m[r] + __log2f(l[r]));
          }
        }
      }
    }
  }
}

template <int D, int kStages> struct Sm90Forward {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         void* out, float* lse, int batch, int heads,
                         int kv_heads, int seq_q, int seq_k, int causal,
                         float sm_scale, cudaStream_t stream) {
    using L = Sm90Layout<D, kStages>;
    constexpr CUtensorMapSwizzle swizzle =
        D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    CUtensorMap tm_q, tm_k, tm_v;
    cudaError_t err;
    if ((err = make_bf16_map_4d(&tm_q, q, D, heads, seq_q, batch, L::kCols,
                                kSm90BlockM, swizzle)) != cudaSuccess ||
        (err = make_bf16_map_4d(&tm_k, k, D, kv_heads, seq_k, batch, L::kCols,
                                kSm90BlockN, swizzle)) != cudaSuccess ||
        (err = make_bf16_map_4d(&tm_v, v, D, kv_heads, seq_k, batch, L::kCols,
                                kSm90BlockN, swizzle)) != cudaSuccess) {
      return err;
    }
    auto kernel = flash_fwd_sm90_kernel<D, kStages>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
    if (err != cudaSuccess) return err;
    const long work = (long)batch * heads *
                      ((seq_q + kSm90BlockM - 1) / kSm90BlockM);
    const int sms = sm_count();
    if (sms <= 0 || work > INT32_MAX / 2) return cudaErrorInvalidValue;
    const int grid = static_cast<int>(work < sms ? work : sms);
    constexpr float kLog2e = 1.4426950408889634f;
    kernel<<<grid, kSm90Threads, L::alloc, stream>>>(
        tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), lse, batch,
        heads, kv_heads, seq_q, seq_k, causal, sm_scale * kLog2e);
    return cudaGetLastError();
  }
};

// ---- f32: CUDA cores ----------------------------------------------------------

// Shared-memory carve-up (byte offsets, each a multiple of 128 bytes).
template <int D> struct F32Smem {
  static constexpr size_t q = 0;                                   // [M][D]
  static constexpr size_t k = q + kBlockM * D * sizeof(float);     // [N][D]
  static constexpr size_t v = k + kBlockN * D * sizeof(float);     // [N][D]
  static constexpr size_t s = v + kBlockN * D * sizeof(float);     // [M][N]
  static constexpr size_t o = s + kBlockM * kBlockN * sizeof(float);  // [M][D]
  static constexpr size_t bytes = o + kBlockM * D * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int heads, int kv_heads,
                     int seq_q, int seq_k, int causal, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + F32Smem<D>::q);
  float* k_s = reinterpret_cast<float*>(smem + F32Smem<D>::k);
  float* v_s = reinterpret_cast<float*>(smem + F32Smem<D>::v);
  float* s_s = reinterpret_cast<float*>(smem + F32Smem<D>::s);
  float* o_s = reinterpret_cast<float*>(smem + F32Smem<D>::o);

  // causal tiles near the bottom see the most kv tiles: issue them first
  const int q_tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = q_tile * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kvh = h / (heads / kv_heads);

  const long q_stride = (long)heads * D;
  const long kv_stride = (long)kv_heads * D;
  const float* q_seq = q + ((long)b * seq_q * heads + h) * D;
  const float* k_seq = k + ((long)b * seq_k * kv_heads + kvh) * D;
  const float* v_seq = v + ((long)b * seq_k * kv_heads + kvh) * D;
  float* o_seq = out + ((long)b * seq_q * heads + h) * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // softmax layout: lane pair (2r, 2r+1) owns warp row r, one half each
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = q0 + warp * kWarpRows + r;  // global q row

  load_tile<float, D, kBlockM>(q_s, q_seq, q0, seq_q, q_stride);
  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) o_s[i] = 0.0f;

  const float* q_w = q_s + warp * kWarpRows * D;
  float* s_w = s_s + warp * kWarpRows * kBlockN;
  float* o_w = o_s + warp * kWarpRows * D;

  float m_i = kNegInf;  // running max of this row's scaled scores
  float l_i = 0.0f;     // running sum of exp(s - m_i)

  // exclusive bound on the kv columns this q tile can see
  int col_end = seq_k;
  if (causal) col_end = min(seq_k, min(q0 + kBlockM, seq_q));
  const int n_tiles = (col_end + kBlockN - 1) / kBlockN;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<float, D, kBlockN>(k_s, k_seq, k0, seq_k, kv_stride);
    load_tile<float, D, kBlockN>(v_s, v_seq, k0, seq_k, kv_stride);
    __syncthreads();

    WarpMma<float, D>::abt(q_w, k_s, s_w);
    __syncwarp();

    // online softmax over this tile, for row `row`, columns of `half`;
    // P overwrites S in place
    float* s_row = s_w + r * kBlockN + half * 32;
    float tile_max = kNegInf;
    for (int i = 0; i < 32; ++i) {
      const int j = (i + lane) & 31;  // rotated: lanes hit distinct banks
      const int col = k0 + half * 32 + j;
      const bool live = col < seq_k && (!causal || col <= row);
      const float sv = live ? s_row[j] * sm_scale : kNegInf;
      s_row[j] = sv;
      tile_max = fmaxf(tile_max, sv);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m_i, tile_max);
    const float alpha = expf(m_i - m_new);
    float tile_sum = 0.0f;
    for (int i = 0; i < 32; ++i) {
      const int j = (i + lane) & 31;
      const int col = k0 + half * 32 + j;
      const bool live = col < seq_k && (!causal || col <= row);
      const float pv = live ? expf(s_row[j] - m_new) : 0.0f;
      tile_sum += pv;
      s_row[j] = pv;
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    l_i = alpha * l_i + tile_sum;
    m_i = m_new;
    float* o_row = o_w + r * D + half * (D / 2);
    for (int i = 0; i < D / 2; ++i) {
      o_row[(i + lane) % (D / 2)] *= alpha;
    }
    __syncwarp();

    WarpMma<float, D>::ab(s_w, v_s, o_w);
    __syncwarp();
  }

  if (row < seq_q) {
    const float inv_l = 1.0f / l_i;
    const float* o_row = o_w + r * D + half * (D / 2);
    float* dst = o_seq + row * q_stride + half * (D / 2);
    for (int i = 0; i < D / 2; ++i) dst[i] = o_row[i] * inv_l;
    if (half == 0) lse[(long)bh * seq_q + row] = m_i + logf(l_i);
  }
}

template <int D> struct F32Forward {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         void* out, float* lse, int batch, int heads,
                         int kv_heads, int seq_q, int seq_k, int causal,
                         float sm_scale, cudaStream_t stream) {
    auto kernel = flash_fwd_f32_kernel<D>;
    const int smem = static_cast<int>(F32Smem<D>::bytes);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq_q + kBlockM - 1) / kBlockM, batch * heads);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, heads,
        kv_heads, seq_q, seq_k, causal, sm_scale);
    return cudaGetLastError();
  }
};

// k/v ring depth of the bf16 kernel (as deep as fits at D 128; one more
// stage at D <= 64 measured faster)
template <int D> constexpr int kRingStages = D == 128 ? 3 : 4;

// the launcher of each dtype: f32 on CUDA cores, bf16 on wgmma + TMA
template <typename T, int D> struct Forward : F32Forward<D> {};
template <int D>
struct Forward<__nv_bfloat16, D> : Sm90Forward<D, kRingStages<D>> {};

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma + TMA).  Returns
// the cudaError_t of the launch (0 = success); the caller raises on
// anything else.
int edl_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  float* lse, int batch, int heads, int kv_heads, int seq_q,
                  int seq_k, int head_dim, int causal, float sm_scale,
                  int dtype, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0) return cudaErrorInvalidValue;
  return dispatch<Forward>(dtype, head_dim, q, k, v, out, lse, batch, heads,
                           kv_heads, seq_q, seq_k, causal, sm_scale,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
