// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd_call). Same function: for each (bh, query row i),
//   s_ij = (q_i . k_j in fp32) * sm_scale, -inf where causal and i < j
//   (positions counted from 0 in both, not aligned to the end),
// an online softmax over key tiles with running max m and sum l (the
// rescale is 0 while the running max is still -inf), p rounded to v's
// dtype before the p . v product, then o = acc / max(l, 1e-30) in q's
// dtype and lse = m + log(max(l, 1e-30)) in fp32 ([BH, Lq]; the TPU's
// sublane-replicated [BH, 8, Lq] copy is not kept).
//
// What bounds it on the card: operations. At the training path's shape
// (BH 192, L 2048, D 128, causal) the two products are 2.06e11 FLOP, 0.21
// ms at the bf16 tensor-core peak, against 0.12 ms to move q, k, v and o.
// Design, kept simple for a first port: as the TPU grid, one block per (bh,
// q tile), walking the key tiles in order with m, l and the fp32
// accumulator in shared memory, so no two blocks write the same output and
// nothing needs atomics. Causal blocks stop at the diagonal tile, and the
// blocks with the longest rows are scheduled first. Products go through
// flash::tile_mm (wmma on the tensor cores for bf16). Loads are plain
// 16-byte vectors, not yet overlapped with the math: cp.async or TMA
// double-buffering and wgmma are the next steps.
//
// Plain C interface (loaded with ctypes): flash_attention_fwd() launches on
// the given stream and returns the cudaError_t of the launch.

#include "flash_attention.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int Lq, int Lk, int causal, float sm_scale) {
  using G = Tiles<T, D>;
  constexpr int B = G::kBlock;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * B;  // longest rows first
  const int bh = blockIdx.y;
  unsigned char* smem = dynamic_smem();
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + G::kTileT);
  T* v_s = reinterpret_cast<T*>(smem + 2 * G::kTileT);
  float* s_s = reinterpret_cast<float*>(smem + 3 * G::kTileT);
  T* p_s = reinterpret_cast<T*>(smem + 3 * G::kTileT + G::kTileS);
  float* o_s = reinterpret_cast<float*>(smem + 3 * G::kTileT + G::kTileS +
                                        G::kTileP);
  float* m_s = reinterpret_cast<float*>(smem + 3 * G::kTileT + G::kTileS +
                                        G::kTileP + G::kTileO);
  float* l_s = m_s + B;
  float* c_s = l_s + B;  // this tile's rescale of each row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<T, B, D>(q_s, G::kLdT, q + ((size_t)bh * Lq + q0) * D);
  for (int e = threadIdx.x; e < B * D; e += kThreads)
    o_s[(e / D) * G::kLdO + e % D] = 0.f;
  for (int r = threadIdx.x; r < B; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  int nk = Lk / B;
  if (causal) nk = min(nk, (q0 + B - 1) / B + 1);  // skip above the diagonal
  const T* kg = k + (size_t)bh * Lk * D;
  const T* vg = v + (size_t)bh * Lk * D;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * B;
    __syncthreads();  // the last tile's readers of k_s, v_s, p_s are done
    load_tile<T, B, D>(k_s, G::kLdT, kg + (size_t)k0 * D);
    load_tile<T, B, D>(v_s, G::kLdT, vg + (size_t)k0 * D);
    __syncthreads();
    tile_mm<B, B, D, false, true, false>(s_s, G::kLdS, q_s, G::kLdT, k_s,
                                         G::kLdT, sm_scale);
    __syncthreads();
    // online softmax: one warp per row, lanes over the tile's keys
    for (int r = warp; r < B; r += kWarps) {
      float* srow = s_s + r * G::kLdS;
      const int qpos = q0 + r;
      float mx = -INFINITY;
      for (int c = lane; c < B; c += 32) {
        if (causal && qpos < k0 + c) srow[c] = -INFINITY;
        mx = fmaxf(mx, srow[c]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < B; c += 32) {
        const float s = srow[c];
        const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
        p_s[r * G::kLdP + c] = from_f<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < B * D; e += kThreads) {
      const int r = e / D;
      o_s[r * G::kLdO + (e - r * D)] *= c_s[r];
    }
    __syncthreads();
    tile_mm<B, D, B, false, false, true>(o_s, G::kLdO, p_s, G::kLdP, v_s,
                                         G::kLdT, 1.f);
  }
  __syncthreads();
  store_tile<T, B, D>(o + ((size_t)bh * Lq + q0) * D, o_s, G::kLdO,
                      [&](int r) { return fmaxf(l_s[r], 1e-30f); });
  for (int r = threadIdx.x; r < B; r += kThreads)
    lse[(size_t)bh * Lq + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int Lq, int Lk, int causal,
                   float sm_scale, cudaStream_t stream) {
  using G = Tiles<T, D>;
  const void* ptrs[] = {q, k, v, o, lse};
  cudaError_t err = check_args(BH, Lq, Lk, G::kBlock, ptrs, 5);
  if (err != cudaSuccess) return err;
  const size_t smem =
      3 * G::kTileT + G::kTileS + G::kTileP + G::kTileO + 3 * G::kRow;
  auto kernel = flash_fwd_kernel<T, D>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Lq / G::kBlock, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Lq, Lk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v and o alike). q [BH, Lq, D], k/v
// [BH, Lk, D], o [BH, Lq, D], lse fp32 [BH, Lq]; D 128; Lq and Lk multiples
// of the tile (64 rows for bf16, 32 for fp32). Returns 0 on success, else
// the cudaError_t code.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, void* lse, int BH, int Lq,
                        int Lk, int D, int causal, float sm_scale,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128) return (int)cudaErrorInvalidValue;  // the head dim built
  if (dtype == kF32)
    return (int)launch<float, 128>(q, k, v, o, lse, BH, Lq, Lk, causal,
                                   sm_scale, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, lse, BH, Lq, Lk,
                                           causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
