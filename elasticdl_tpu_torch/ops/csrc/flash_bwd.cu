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
// are bound by operations.
//
// Design (simple and correct first; wgmma, TMA and a single pass with an
// atomic dQ are later work).  Two kernels, so that every output is
// written once by one block and nothing needs atomics:
//
// - dQ: one block of 4 warps per (64-row q tile, b*H + h).  It loops
//   over the k/v tiles up to the causal diagonal (the TPU kernel's
//   sequential k-chunk grid axis becomes this loop).  Each warp owns 16
//   q rows end to end: S = Q K^T and dP = dO V^T into shared memory, P
//   and dS elementwise (two lanes per row, lse and delta in registers),
//   then dQ += dS K into its rows of an f32 accumulator in shared memory.
// - dK/dV: one block per (64-row k tile, b*KVH + kv head).  It loops
//   over the group's q heads and, for each, over the q tiles from the
//   diagonal on, so it sums the GQA group itself and writes dK and dV at
//   the kv-head shape directly (the TPU code writes per-q-head partials
//   and sums them in jnp).  Each warp owns 16 k rows and works on the
//   transposed products S^T = K Q^T and dP^T = V dO^T, so that
//   dV += P^T dO and dK += dS^T Q land in its own accumulator rows and
//   only the q/dO tile loads synchronise the block.
//
// bf16 inputs run all five products on the tensor cores (WMMA 16x16x16,
// f32 accumulation); P and dS are rounded to bf16 before their products,
// as the forward rounds P.  f32 inputs take CUDA-core FMAs, so f32 stays
// f32.  The ragged edge (S not a multiple of 64) is loaded as zeros and
// masked, so any S works.  Shared memory is up to 225 KB a block (dK/dV,
// f32, D 128), hence cudaFuncSetAttribute before each launch.

#include "flash_common.cuh"

namespace {

using namespace edl_flash;

// The f32 products read P and dS straight from the f32 S and dP tiles
// (overwritten in place); bf16 needs its own rounded copies.
template <typename T>
constexpr size_t rounded_tile_bytes() {
  return sizeof(T) == sizeof(float) ? 0 : kBlockM * kBlockN * sizeof(T);
}

// dQ block: byte offsets, each a multiple of 128 bytes.
template <typename T, int D> struct DqSmem {
  static constexpr size_t q = 0;                                 // T [M][D]
  static constexpr size_t dout = q + kBlockM * D * sizeof(T);    // T [M][D]
  static constexpr size_t k = dout + kBlockM * D * sizeof(T);    // T [N][D]
  static constexpr size_t v = k + kBlockN * D * sizeof(T);       // T [N][D]
  static constexpr size_t s = v + kBlockN * D * sizeof(T);       // f32 [M][N]
  static constexpr size_t dp = s + kBlockM * kBlockN * sizeof(float);
  static constexpr size_t ds_own = dp + kBlockM * kBlockN * sizeof(float);
  static constexpr size_t ds = rounded_tile_bytes<T>() ? ds_own : dp;
  static constexpr size_t dq = ds_own + rounded_tile_bytes<T>();  // f32 [M][D]
  static constexpr size_t bytes = dq + kBlockM * D * sizeof(float);
};

// dK/dV block: the k tile's rows are M, the q tile's rows N.
template <typename T, int D> struct DkvSmem {
  static constexpr size_t k = 0;                                 // T [M][D]
  static constexpr size_t v = k + kBlockM * D * sizeof(T);       // T [M][D]
  static constexpr size_t q = v + kBlockM * D * sizeof(T);       // T [N][D]
  static constexpr size_t dout = q + kBlockN * D * sizeof(T);    // T [N][D]
  static constexpr size_t dk = dout + kBlockN * D * sizeof(T);   // f32 [M][D]
  static constexpr size_t dv = dk + kBlockM * D * sizeof(float); // f32 [M][D]
  static constexpr size_t s = dv + kBlockM * D * sizeof(float);  // f32 [M][N]
  static constexpr size_t dp = s + kBlockM * kBlockN * sizeof(float);
  static constexpr size_t p_own = dp + kBlockM * kBlockN * sizeof(float);
  static constexpr size_t p = rounded_tile_bytes<T>() ? p_own : s;
  static constexpr size_t ds_own = p_own + rounded_tile_bytes<T>();
  static constexpr size_t ds = rounded_tile_bytes<T>() ? ds_own : dp;
  static constexpr size_t lse = ds_own + rounded_tile_bytes<T>();  // f32 [N]
  static constexpr size_t delta = lse + kBlockN * sizeof(float);   // f32 [N]
  static constexpr size_t bytes = delta + kBlockN * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int heads, int kv_heads, int seq_q, int seq_k, int causal,
                    float sm_scale) {
  using L = DqSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::q);
  T* do_s = reinterpret_cast<T*>(smem + L::dout);
  T* k_s = reinterpret_cast<T*>(smem + L::k);
  T* v_s = reinterpret_cast<T*>(smem + L::v);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp);
  T* ds_s = reinterpret_cast<T*>(smem + L::ds);
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
  const T* k_seq = k + ((long)b * seq_k * kv_heads + kvh) * D;
  const T* v_seq = v + ((long)b * seq_k * kv_heads + kvh) * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // elementwise layout: lane pair (2r, 2r+1) owns warp row r, half each
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = q0 + warp * kWarpRows + r;  // global q row
  const bool row_live = row < seq_q;
  const float lse_r = row_live ? lse[(long)bh * seq_q + row] : 0.0f;
  const float delta_r = row_live ? delta[(long)bh * seq_q + row] : 0.0f;

  load_tile<T, D, kBlockM>(q_s, q + q_off, q0, seq_q, q_stride);
  load_tile<T, D, kBlockM>(do_s, dout + q_off, q0, seq_q, q_stride);
  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) dq_s[i] = 0.0f;

  const int w_rows = warp * kWarpRows;
  float* s_w = s_s + w_rows * kBlockN;
  float* dp_w = dp_s + w_rows * kBlockN;
  T* ds_w = ds_s + w_rows * kBlockN;
  float* dq_w = dq_s + w_rows * D;

  int col_end = seq_k;  // exclusive bound on the kv columns this tile sees
  if (causal) col_end = min(seq_k, min(q0 + kBlockM, seq_q));
  const int n_tiles = (col_end + kBlockN - 1) / kBlockN;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<T, D, kBlockN>(k_s, k_seq, k0, seq_k, kv_stride);
    load_tile<T, D, kBlockN>(v_s, v_seq, k0, seq_k, kv_stride);
    __syncthreads();

    WarpMma<T, D>::abt(q_s + w_rows * D, k_s, s_w);
    WarpMma<T, D>::abt(do_s + w_rows * D, v_s, dp_w);
    __syncwarp();

    for (int i = 0; i < 32; ++i) {
      const int j = half * 32 + ((i + lane) & 31);  // rotated: distinct banks
      const int col = k0 + j;
      const bool live = row_live && col < seq_k && (!causal || col <= row);
      const float p =
          live ? expf(s_w[r * kBlockN + j] * sm_scale - lse_r) : 0.0f;
      const float ds = p * (dp_w[r * kBlockN + j] - delta_r);
      ds_w[r * kBlockN + j] = from_float<T>(ds);
    }
    __syncwarp();

    WarpMma<T, D>::ab(ds_w, k_s, dq_w);
    __syncwarp();
  }

  if (row_live) {
    const float* src = dq_w + r * D + half * (D / 2);
    T* dst = dq + q_off + row * q_stride + half * (D / 2);
    for (int i = 0; i < D / 2; ++i) dst[i] = from_float<T>(src[i] * sm_scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int kv_heads, int seq_q,
                     int seq_k, int causal, float sm_scale) {
  using L = DkvSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem + L::k);
  T* v_s = reinterpret_cast<T*>(smem + L::v);
  T* q_s = reinterpret_cast<T*>(smem + L::q);
  T* do_s = reinterpret_cast<T*>(smem + L::dout);
  float* dk_s = reinterpret_cast<float*>(smem + L::dk);
  float* dv_s = reinterpret_cast<float*>(smem + L::dv);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp);
  T* p_s = reinterpret_cast<T*>(smem + L::p);
  T* ds_s = reinterpret_cast<T*>(smem + L::ds);
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

  load_tile<T, D, kBlockM>(k_s, k + kv_off, k0, seq_k, kv_stride);
  load_tile<T, D, kBlockM>(v_s, v + kv_off, k0, seq_k, kv_stride);
  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) {
    dk_s[i] = 0.0f;
    dv_s[i] = 0.0f;
  }

  const int w_rows = warp * kWarpRows;
  float* s_w = s_s + w_rows * kBlockN;
  float* dp_w = dp_s + w_rows * kBlockN;
  T* p_w = p_s + w_rows * kBlockN;
  T* ds_w = ds_s + w_rows * kBlockN;

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
      load_tile<T, D, kBlockN>(q_s, q + q_off, q0, seq_q, q_stride);
      load_tile<T, D, kBlockN>(do_s, dout + q_off, q0, seq_q, q_stride);
      for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
        const bool live = q0 + i < seq_q;
        lse_s[i] = live ? lse[(long)bh * seq_q + q0 + i] : 0.0f;
        delta_s[i] = live ? delta[(long)bh * seq_q + q0 + i] : 0.0f;
      }
      __syncthreads();

      WarpMma<T, D>::abt(k_s + w_rows * D, q_s, s_w);    // S^T
      WarpMma<T, D>::abt(v_s + w_rows * D, do_s, dp_w);  // dP^T
      __syncwarp();

      for (int i = 0; i < 32; ++i) {
        const int j = half * 32 + ((i + lane) & 31);
        const int qrow = q0 + j;
        const bool live =
            krow_live && qrow < seq_q && (!causal || qrow >= krow);
        const float p =
            live ? expf(s_w[r * kBlockN + j] * sm_scale - lse_s[j]) : 0.0f;
        const float ds = p * (dp_w[r * kBlockN + j] - delta_s[j]);
        p_w[r * kBlockN + j] = from_float<T>(p);
        ds_w[r * kBlockN + j] = from_float<T>(ds);
      }
      __syncwarp();

      WarpMma<T, D>::ab(p_w, do_s, dv_s + w_rows * D);   // dV += P^T dO
      WarpMma<T, D>::ab(ds_w, q_s, dk_s + w_rows * D);   // dK += dS^T Q
      __syncwarp();
    }
  }

  if (krow_live) {
    const int c0 = half * (D / 2);
    const float* dk_src = dk_s + (w_rows + r) * D + c0;
    const float* dv_src = dv_s + (w_rows + r) * D + c0;
    T* dk_dst = dk + kv_off + krow * kv_stride + c0;
    T* dv_dst = dv + kv_off + krow * kv_stride + c0;
    for (int i = 0; i < D / 2; ++i) {
      dk_dst[i] = from_float<T>(dk_src[i] * sm_scale);
      dv_dst[i] = from_float<T>(dv_src[i]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

template <typename T, int D> struct Dq {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int batch, int heads,
                         int kv_heads, int seq_q, int seq_k, int causal,
                         float sm_scale, cudaStream_t stream) {
    auto kernel = flash_bwd_dq_kernel<T, D>;
    cudaError_t err = set_smem(kernel, DqSmem<T, D>::bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq_q + kBlockM - 1) / kBlockM, batch * heads);
    kernel<<<grid, kThreads, DqSmem<T, D>::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), heads, kv_heads, seq_q, seq_k, causal, sm_scale);
    return cudaGetLastError();
  }
};

template <typename T, int D> struct Dkv {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int batch,
                         int heads, int kv_heads, int seq_q, int seq_k,
                         int causal, float sm_scale, cudaStream_t stream) {
    auto kernel = flash_bwd_dkv_kernel<T, D>;
    cudaError_t err = set_smem(kernel, DkvSmem<T, D>::bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq_k + kBlockM - 1) / kBlockM, batch * kv_heads);
    kernel<<<grid, kThreads, DkvSmem<T, D>::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), heads, kv_heads, seq_q,
        seq_k, causal, sm_scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t of its
// launch (0 = success); the caller raises on anything else.
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
