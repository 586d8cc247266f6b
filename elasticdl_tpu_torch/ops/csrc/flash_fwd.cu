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
// code is done here by strides: a (b, h) sequence has row stride H*D.
//
// Bound at the served shape (B=4, S=2048, H=12, D=64, bf16, causal):
//   work    2*B*H*S^2*D = 25.8 GFLOP (causal halves the two products),
//           26 us at the card's 989 TFLOP/s bf16 tensor-core peak;
//   traffic q, k, v, out = 50 MB, 15 us at 3.35 TB/s;
//   so it is bound by operations.
//
// Design (simple and correct first; wgmma, TMA and warp specialisation
// are later work): one block of 4 warps per (q tile of 64 rows, b*H+h).
// The TPU kernel's sequential chunk axis, with m/l/acc carried across
// grid steps in VMEM scratch, becomes a loop over 64-row k/v tiles
// inside the block.  Each warp owns 16 q rows end to end: it computes
// its rows of S = Q K^T into shared memory (bf16: WMMA tensor-core tiles
// with f32 accumulation; f32: CUDA-core FMAs, so f32 stays f32), runs
// the online softmax on them (running max and sum in registers, two
// lanes per row), rescales its rows of the f32 output accumulator in
// shared memory, and adds P V.  Only the k/v tile loads need the whole
// block to synchronise.  The loop stops at the causal diagonal; the
// ragged edge (S not a multiple of 64) is masked in the kernel, so any
// S works.  Causal q tiles are issued longest first.

#include "flash_common.cuh"

namespace {

using namespace edl_flash;

// Shared-memory carve-up (byte offsets; every piece is a multiple of
// 128 bytes, so every WMMA pointer below stays 32-byte aligned).
template <typename T, int D> struct Smem {
  static constexpr size_t q = 0;                                   // T [M][D]
  static constexpr size_t k = q + kBlockM * D * sizeof(T);         // T [N][D]
  static constexpr size_t v = k + kBlockN * D * sizeof(T);         // T [N][D]
  static constexpr size_t s = v + kBlockN * D * sizeof(T);         // f32 [M][N]
  static constexpr size_t p = s + kBlockM * kBlockN * sizeof(float);  // T [M][N]
  static constexpr size_t o = p + kBlockM * kBlockN * sizeof(T);   // f32 [M][D]
  static constexpr size_t bytes = o + kBlockM * D * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int heads, int kv_heads, int seq_q,
                 int seq_k, int causal, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + Smem<T, D>::q);
  T* k_s = reinterpret_cast<T*>(smem + Smem<T, D>::k);
  T* v_s = reinterpret_cast<T*>(smem + Smem<T, D>::v);
  float* s_s = reinterpret_cast<float*>(smem + Smem<T, D>::s);
  T* p_s = reinterpret_cast<T*>(smem + Smem<T, D>::p);
  float* o_s = reinterpret_cast<float*>(smem + Smem<T, D>::o);

  // causal tiles near the bottom see the most kv tiles: issue them first
  const int q_tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = q_tile * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kvh = h / (heads / kv_heads);

  const long q_stride = (long)heads * D;
  const long kv_stride = (long)kv_heads * D;
  const T* q_seq = q + ((long)b * seq_q * heads + h) * D;
  const T* k_seq = k + ((long)b * seq_k * kv_heads + kvh) * D;
  const T* v_seq = v + ((long)b * seq_k * kv_heads + kvh) * D;
  T* o_seq = out + ((long)b * seq_q * heads + h) * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // softmax layout: lane pair (2r, 2r+1) owns warp row r, one half each
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = q0 + warp * kWarpRows + r;  // global q row

  load_tile<T, D, kBlockM>(q_s, q_seq, q0, seq_q, q_stride);
  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) o_s[i] = 0.0f;

  const T* q_w = q_s + warp * kWarpRows * D;
  float* s_w = s_s + warp * kWarpRows * kBlockN;
  T* p_w = p_s + warp * kWarpRows * kBlockN;
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
    load_tile<T, D, kBlockN>(k_s, k_seq, k0, seq_k, kv_stride);
    load_tile<T, D, kBlockN>(v_s, v_seq, k0, seq_k, kv_stride);
    __syncthreads();

    WarpMma<T, D>::abt(q_w, k_s, s_w);
    __syncwarp();

    // online softmax over this tile, for row `row`, columns of `half`
    float* s_row = s_w + r * kBlockN + half * 32;
    T* p_row = p_w + r * kBlockN + half * 32;
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
      p_row[j] = from_float<T>(pv);
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    l_i = alpha * l_i + tile_sum;
    m_i = m_new;
    float* o_row = o_w + r * D + half * (D / 2);
    for (int i = 0; i < D / 2; ++i) {
      o_row[(i + lane) % (D / 2)] *= alpha;
    }
    __syncwarp();

    WarpMma<T, D>::ab(p_w, v_s, o_w);
    __syncwarp();
  }

  if (row < seq_q) {
    const float inv_l = 1.0f / l_i;
    const float* o_row = o_w + r * D + half * (D / 2);
    T* dst = o_seq + row * q_stride + half * (D / 2);
    for (int i = 0; i < D / 2; ++i) dst[i] = from_float<T>(o_row[i] * inv_l);
    if (half == 0) lse[(long)bh * seq_q + row] = m_i + logf(l_i);
  }
}

template <typename T, int D> struct Forward {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         void* out, float* lse, int batch, int heads,
                         int kv_heads, int seq_q, int seq_k, int causal,
                         float sm_scale, cudaStream_t stream) {
    auto kernel = flash_fwd_kernel<T, D>;
    const int smem = static_cast<int>(Smem<T, D>::bytes);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq_q + kBlockM - 1) / kBlockM, batch * heads);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, heads, kv_heads,
        seq_q, seq_k, causal, sm_scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 = success); the caller raises on anything else.
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
