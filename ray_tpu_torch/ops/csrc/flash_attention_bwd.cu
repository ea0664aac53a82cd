// Flash-attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels ray_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (both launched by _bwd_call). Same functions: from the
// forward's lse and delta = rowsum(do * o) - dlse (computed by the caller,
// outside the kernels, as _bwd_call does), each recomputes per (query i,
// key j)
//   s_ij = (q_i . k_j in fp32) * sm_scale (-inf where causal and i < j),
//   p_ij = exp(s_ij - lse_i),  dp_ij = do_i . v_j,
//   ds_ij = p_ij * (dp_ij - delta_i),
// and accumulates in fp32
//   dq_i += (sum_j ds_ij k_j) * sm_scale          (flash_dq_kernel)
//   dv_j += sum_i p_ij do_i,
//   dk_j += (sum_i ds_ij q_i) * sm_scale          (flash_dkv_kernel)
// with p rounded to do's dtype and ds to k's (q's) dtype before each
// product, as the TPU kernels do.
//
// What bounds them on the card: operations. At the training path's shape
// (BH 192, L 2048, D 128, causal) dq does 3 products (3.09e11 FLOP, 0.31 ms
// at the bf16 tensor-core peak) and dk/dv 4 (4.12e11 FLOP, 0.42 ms); the
// bytes take about 0.15 ms. Design, kept simple for a first port: as the
// TPU grids, one block per (bh, q tile) walking the key tiles for dq, and
// one block per (bh, k tile) walking the query tiles for dk/dv, each
// accumulating its own rows in shared memory, so no two blocks write the
// same output and nothing needs atomics. Causal blocks skip the tiles above
// the diagonal. Products go through flash::tile_mm (wmma on the tensor
// cores for bf16). Fusing the two kernels, overlapping loads with the math
// and wgmma are the next steps.
//
// Plain C interface (loaded with ctypes): flash_attention_dq() and
// flash_attention_dkv() launch on the given stream and return the
// cudaError_t of the launch.

#include "flash_attention.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Lq, int Lk, int causal, float sm_scale) {
  using G = Tiles<T, D>;
  constexpr int B = G::kBlock;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * B;  // longest rows first
  const int bh = blockIdx.y;
  unsigned char* smem = dynamic_smem();
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + G::kTileT);
  T* k_s = reinterpret_cast<T*>(smem + 2 * G::kTileT);
  T* v_s = reinterpret_cast<T*>(smem + 3 * G::kTileT);
  float* s_s = reinterpret_cast<float*>(smem + 4 * G::kTileT);
  float* dp_s = reinterpret_cast<float*>(smem + 4 * G::kTileT + G::kTileS);
  T* ds_s = reinterpret_cast<T*>(smem + 4 * G::kTileT + 2 * G::kTileS);
  float* dq_s = reinterpret_cast<float*>(smem + 4 * G::kTileT +
                                         2 * G::kTileS + G::kTileP);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * G::kTileT +
                                          2 * G::kTileS + G::kTileP +
                                          G::kTileO);
  float* delta_s = lse_s + B;

  const size_t row0 = (size_t)bh * Lq + q0;
  load_tile<T, B, D>(q_s, G::kLdT, q + row0 * D);
  load_tile<T, B, D>(do_s, G::kLdT, dout + row0 * D);
  for (int r = threadIdx.x; r < B; r += kThreads) {
    lse_s[r] = lse[row0 + r];
    delta_s[r] = delta[row0 + r];
  }
  for (int e = threadIdx.x; e < B * D; e += kThreads)
    dq_s[(e / D) * G::kLdO + e % D] = 0.f;
  int nk = Lk / B;
  if (causal) nk = min(nk, (q0 + B - 1) / B + 1);  // skip above the diagonal
  const T* kg = k + (size_t)bh * Lk * D;
  const T* vg = v + (size_t)bh * Lk * D;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * B;
    __syncthreads();  // the last tile's readers of k_s and ds_s are done
    load_tile<T, B, D>(k_s, G::kLdT, kg + (size_t)k0 * D);
    load_tile<T, B, D>(v_s, G::kLdT, vg + (size_t)k0 * D);
    __syncthreads();
    tile_mm<B, B, D, false, true, false>(s_s, G::kLdS, q_s, G::kLdT, k_s,
                                         G::kLdT, sm_scale);
    tile_mm<B, B, D, false, true, false>(dp_s, G::kLdS, do_s, G::kLdT, v_s,
                                         G::kLdT, 1.f);
    __syncthreads();
    for (int e = threadIdx.x; e < B * B; e += kThreads) {
      const int r = e / B;
      const int c = e - r * B;
      const float s = (causal && q0 + r < k0 + c) ? -INFINITY
                                                  : s_s[r * G::kLdS + c];
      const float p = expf(s - lse_s[r]);  // a masked score gives 0
      ds_s[r * G::kLdP + c] =
          from_f<T>(p * (dp_s[r * G::kLdS + c] - delta_s[r]));
    }
    __syncthreads();
    tile_mm<B, D, B, false, false, true>(dq_s, G::kLdO, ds_s, G::kLdP, k_s,
                                         G::kLdT, sm_scale);
  }
  __syncthreads();
  store_tile<T, B, D>(dq + row0 * D, dq_s, G::kLdO, [](int) { return 1.f; });
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Lq, int Lk, int causal,
    float sm_scale) {
  using G = Tiles<T, D>;
  constexpr int B = G::kBlock;
  const int k0 = blockIdx.x * B;  // causal: the first key tiles see most rows
  const int bh = blockIdx.y;
  unsigned char* smem = dynamic_smem();
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + G::kTileT);
  T* q_s = reinterpret_cast<T*>(smem + 2 * G::kTileT);
  T* do_s = reinterpret_cast<T*>(smem + 3 * G::kTileT);
  float* s_s = reinterpret_cast<float*>(smem + 4 * G::kTileT);
  float* dp_s = reinterpret_cast<float*>(smem + 4 * G::kTileT + G::kTileS);
  T* p_s = reinterpret_cast<T*>(smem + 4 * G::kTileT + 2 * G::kTileS);
  T* ds_s = reinterpret_cast<T*>(smem + 4 * G::kTileT + 2 * G::kTileS +
                                 G::kTileP);
  float* dk_s = reinterpret_cast<float*>(smem + 4 * G::kTileT +
                                         2 * G::kTileS + 2 * G::kTileP);
  float* dv_s = reinterpret_cast<float*>(smem + 4 * G::kTileT +
                                         2 * G::kTileS + 2 * G::kTileP +
                                         G::kTileO);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * G::kTileT +
                                          2 * G::kTileS + 2 * G::kTileP +
                                          2 * G::kTileO);
  float* delta_s = lse_s + B;

  const size_t krow0 = (size_t)bh * Lk + k0;
  load_tile<T, B, D>(k_s, G::kLdT, k + krow0 * D);
  load_tile<T, B, D>(v_s, G::kLdT, v + krow0 * D);
  for (int e = threadIdx.x; e < B * D; e += kThreads) {
    const int at = (e / D) * G::kLdO + e % D;
    dk_s[at] = 0.f;
    dv_s[at] = 0.f;
  }
  // causal: query tile qt sees key k0 once qt * B + B - 1 >= k0
  const int qt0 = causal ? k0 / B : 0;
  const int nq = Lq / B;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * B;
    const size_t row0 = (size_t)bh * Lq + q0;
    __syncthreads();  // the last tile's readers of q_s, do_s, p_s, ds_s
    load_tile<T, B, D>(q_s, G::kLdT, q + row0 * D);
    load_tile<T, B, D>(do_s, G::kLdT, dout + row0 * D);
    for (int r = threadIdx.x; r < B; r += kThreads) {
      lse_s[r] = lse[row0 + r];
      delta_s[r] = delta[row0 + r];
    }
    __syncthreads();
    tile_mm<B, B, D, false, true, false>(s_s, G::kLdS, q_s, G::kLdT, k_s,
                                         G::kLdT, sm_scale);
    tile_mm<B, B, D, false, true, false>(dp_s, G::kLdS, do_s, G::kLdT, v_s,
                                         G::kLdT, 1.f);
    __syncthreads();
    for (int e = threadIdx.x; e < B * B; e += kThreads) {
      const int r = e / B;  // query row of the tile
      const int c = e - r * B;  // key column
      const float s = (causal && q0 + r < k0 + c) ? -INFINITY
                                                  : s_s[r * G::kLdS + c];
      const float p = expf(s - lse_s[r]);
      p_s[r * G::kLdP + c] = from_f<T>(p);
      ds_s[r * G::kLdP + c] =
          from_f<T>(p * (dp_s[r * G::kLdS + c] - delta_s[r]));
    }
    __syncthreads();
    // dv += p^T . do and dk += (ds^T . q) * sm_scale: A read transposed
    tile_mm<B, D, B, true, false, true>(dv_s, G::kLdO, p_s, G::kLdP, do_s,
                                        G::kLdT, 1.f);
    tile_mm<B, D, B, true, false, true>(dk_s, G::kLdO, ds_s, G::kLdP, q_s,
                                        G::kLdT, sm_scale);
  }
  __syncthreads();
  store_tile<T, B, D>(dk + krow0 * D, dk_s, G::kLdO, [](int) { return 1.f; });
  store_tile<T, B, D>(dv + krow0 * D, dv_s, G::kLdO, [](int) { return 1.f; });
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int Lq, int Lk, int causal,
                      float sm_scale, cudaStream_t stream) {
  using G = Tiles<T, D>;
  const void* ptrs[] = {q, k, v, dout, lse, delta, dq};
  cudaError_t err = check_args(BH, Lq, Lk, G::kBlock, ptrs, 7);
  if (err != cudaSuccess) return err;
  const size_t smem =
      4 * G::kTileT + 2 * G::kTileS + G::kTileP + G::kTileO + 2 * G::kRow;
  auto kernel = flash_dq_kernel<T, D>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Lq / G::kBlock, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Lq, Lk, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int Lq, int Lk, int causal,
                       float sm_scale, cudaStream_t stream) {
  using G = Tiles<T, D>;
  const void* ptrs[] = {q, k, v, dout, lse, delta, dk, dv};
  cudaError_t err = check_args(BH, Lq, Lk, G::kBlock, ptrs, 8);
  if (err != cudaSuccess) return err;
  const size_t smem = 4 * G::kTileT + 2 * G::kTileS + 2 * G::kTileP +
                      2 * G::kTileO + 2 * G::kRow;
  auto kernel = flash_dkv_kernel<T, D>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Lk / G::kBlock, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v, do and the gradients alike). q/do/dq
// [BH, Lq, D], k/v/dk/dv [BH, Lk, D], lse/delta fp32 [BH, Lq]; D 128; Lq
// and Lk multiples of the tile (64 rows for bf16, 32 for fp32). Each
// returns 0 on success, else the cudaError_t code.
int flash_attention_dq(int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const void* lse,
                       const void* delta, void* dq, int BH, int Lq, int Lk,
                       int D, int causal, float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128) return (int)cudaErrorInvalidValue;  // the head dim built
  if (dtype == kF32)
    return (int)launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, BH, Lq,
                                      Lk, causal, sm_scale, s);
  if (dtype == kBF16)
    return (int)launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq,
                                              BH, Lq, Lk, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

int flash_attention_dkv(int dtype, const void* q, const void* k,
                        const void* v, const void* dout, const void* lse,
                        const void* delta, void* dk, void* dv, int BH, int Lq,
                        int Lk, int D, int causal, float sm_scale,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, BH,
                                       Lq, Lk, causal, sm_scale, s);
  if (dtype == kBF16)
    return (int)launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk,
                                               dv, BH, Lq, Lk, causal,
                                               sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
