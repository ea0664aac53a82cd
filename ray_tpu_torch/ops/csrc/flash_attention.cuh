// Shared pieces of the flash-attention kernels for Hopper (sm_90a):
// flash_attention_fwd.cu (forward) and flash_attention_bwd.cu (dq, dk/dv).
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, L, D] row-major (D = 128);
// lse is fp32 [BH, Lq] as the forward writes it, and the backward reads
// lse and delta as fp32 [BH, padded_rows(Lq)]. Element type T is fp32 or bf16, the
// same for every tensor of one call; every product accumulates in fp32.
//
// Every tile lives in shared memory. A tile of q/k/v/do rows holds kBlock
// rows of D elements (64 rows for bf16, 32 for fp32, whose tiles take twice
// the bytes); score and probability tiles are kBlock x kBlock; the fp32
// accumulators (o, dq, dk, dv) are kBlock x D. Row pitches are padded by 16
// bytes (T tiles) or 4 floats (fp32 tiles) against bank conflicts, and every
// tile starts on 32 bytes, as wmma's loads and stores require.
//
// tile_mm is the one product primitive: bf16 operands go to the tensor
// cores through nvcuda::wmma (16x16x16, fp32 accumulate), each warp owning
// strips of two 16x16 output tiles so an A fragment serves two B fragments;
// fp32 operands take a CUDA-core loop in full fp32 (the tensor cores'
// fp32 input, TF32, keeps only 10 mantissa bits).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int kThreads = 256;  // eight warps per block
constexpr int kWarps = kThreads / 32;

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T, int D>
struct Tiles {
  static constexpr int kBlock = sizeof(T) == 2 ? 64 : 32;
  static constexpr int kPad = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLdT = D + kPad;       // q/k/v/do tiles (T)
  static constexpr int kLdS = kBlock + 4;     // score tiles (fp32)
  static constexpr int kLdP = kBlock + kPad;  // probability tiles (T)
  static constexpr int kLdO = D + 4;          // accumulators (fp32)
  static constexpr size_t kTileT = sizeof(T) * kBlock * kLdT;
  static constexpr size_t kTileS = sizeof(float) * kBlock * kLdS;
  static constexpr size_t kTileP = sizeof(T) * kBlock * kLdP;
  static constexpr size_t kTileO = sizeof(float) * kBlock * kLdO;
  static constexpr size_t kRow = sizeof(float) * kBlock;  // one per tile row
  static_assert(kTileT % 32 == 0 && kTileS % 32 == 0 && kTileP % 32 == 0 &&
                    kTileO % 32 == 0 && kRow % 32 == 0,
                "every tile must start on 32 bytes");
  static_assert(D % 16 == 0 && kBlock % 32 == 0, "tile shape");
};

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(128) unsigned char smem[];
  return smem;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kRows rows of a row-major [*, D] array into a tile of row pitch ld, one
// 16-byte vector per thread and step; rows at or past `rows` (the last
// tile of a sequence whose length the tile does not divide) are zeros and
// are not read
template <typename T, int kRows, int D>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, int ld,
                                          const T* __restrict__ src,
                                          int rows) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = D / kVec;
  for (int e = threadIdx.x; e < kRows * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * kVec;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        r < rows
            ? __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * D + c))
            : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the first `rows` rows (at most kRows) of an fp32 accumulator tile,
// divided by div(row), into a row-major [*, D] array of T
template <typename T, int kRows, int D, typename Div>
__device__ __forceinline__ void store_tile(T* __restrict__ dst,
                                           const float* __restrict__ acc,
                                           int ld, int rows, Div div) {
  for (int e = threadIdx.x; e < min(rows, kRows) * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    dst[(size_t)r * D + d] = from_f<T>(acc[r * ld + d] / div(r));
  }
}

// C (fp32, pitch ldc) = (kAccumulate ? C : 0) + scale * (A . B), with A
// M x K and B K x N, all in shared memory. A is row-major (a[i * lda + k])
// or, with kTransA, stored transposed (a[k * lda + i]); B is row-major
// (b[k * ldb + n]) or, with kTransB, stored transposed (b[n * ldb + k]).
// The product is formed in full, then scaled, then added: as the TPU
// kernels' "acc += dot(...) * scale". Callers synchronise around it.
template <int M, int N, int K, bool kTransA, bool kTransB, bool kAccumulate>
__device__ __forceinline__ void tile_mm(float* __restrict__ c, int ldc,
                                        const __nv_bfloat16* __restrict__ a,
                                        int lda,
                                        const __nv_bfloat16* __restrict__ b,
                                        int ldb, float scale) {
  using namespace nvcuda;
  using LayoutA = typename std::conditional<kTransA, wmma::col_major,
                                            wmma::row_major>::type;
  using LayoutB = typename std::conditional<kTransB, wmma::col_major,
                                            wmma::row_major>::type;
  constexpr int kG = 2;  // 16x16 output tiles per warp strip
  constexpr int kStrips = N / (16 * kG);
  static_assert(M % 16 == 0 && K % 16 == 0 && N % (16 * kG) == 0,
                "tile_mm shape");
  const int warp = threadIdx.x >> 5;
  for (int strip = warp; strip < (M / 16) * kStrips; strip += kWarps) {
    const int i0 = (strip / kStrips) * 16;
    const int j0 = (strip % kStrips) * 16 * kG;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) wmma::fill_fragment(acc[g], 0.f);
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> fa;
      wmma::load_matrix_sync(fa, kTransA ? a + k0 * lda + i0 : a + i0 * lda + k0,
                             lda);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int n0 = j0 + g * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> fb;
        wmma::load_matrix_sync(
            fb, kTransB ? b + n0 * ldb + k0 : b + k0 * ldb + n0, ldb);
        wmma::mma_sync(acc[g], fa, fb, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float* cp = c + i0 * ldc + j0 + g * 16;
      if (kAccumulate) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> old;
        wmma::load_matrix_sync(old, cp, ldc, wmma::mem_row_major);
#pragma unroll
        for (int t = 0; t < old.num_elements; ++t)
          old.x[t] += acc[g].x[t] * scale;
        wmma::store_matrix_sync(cp, old, ldc, wmma::mem_row_major);
      } else {
#pragma unroll
        for (int t = 0; t < acc[g].num_elements; ++t) acc[g].x[t] *= scale;
        wmma::store_matrix_sync(cp, acc[g], ldc, wmma::mem_row_major);
      }
    }
  }
}

template <int M, int N, int K, bool kTransA, bool kTransB, bool kAccumulate>
__device__ __forceinline__ void tile_mm(float* __restrict__ c, int ldc,
                                        const float* __restrict__ a, int lda,
                                        const float* __restrict__ b, int ldb,
                                        float scale) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int i = e / N;
    const int j = e - i * N;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      sum = fmaf(kTransA ? a[k * lda + i] : a[i * lda + k],
                 kTransB ? b[j * ldb + k] : b[k * ldb + j], sum);
    float* cp = c + i * ldc + j;
    *cp = kAccumulate ? *cp + sum * scale : sum * scale;
  }
}

// what every entry point checks before it launches. Any length L >= 1:
// the kernels mask the last q tile and the last key tile. lse and delta,
// read by the backward kernels, are [BH, padded_rows(Lq)] (the wrapper
// pads them with zeros), so a tile's values come whole and aligned.
inline cudaError_t check_args(int BH, int Lq, int Lk,
                              const void* const* ptrs, int n_ptrs) {
  if (BH <= 0 || BH > 65535 || Lq <= 0 || Lk <= 0)
    return cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

// the row pitch of the backward kernels' lse and delta: Lq rounded up to
// a multiple of 64
__host__ __device__ __forceinline__ int padded_rows(int Lq) {
  return (Lq + 63) & ~63;
}

// tags that carry a type or a head dim into a generic lambda
template <typename T>
struct Type {
  using type = T;
};
template <int D>
using Dim = std::integral_constant<int, D>;

// The first designs: fp32 at D 64 and 128, bf16 at D 64. f(Type<T>,
// Dim<D>) is called for a launch's dtype and head dim, and its result
// returned; `none` for the others.
template <typename F, typename R>
R with_first_design(int dtype, int D, F f, R none) {
  if (dtype == kF32 && D == 64) return f(Type<float>{}, Dim<64>{});
  if (dtype == kF32 && D == 128) return f(Type<float>{}, Dim<128>{});
  if (dtype == kBF16 && D == 64) return f(Type<__nv_bfloat16>{}, Dim<64>{});
  return none;
}

// a first design's one tile (blk_q, blk_k): kBlock x kBlock
template <typename T, int D>
bool first_design_tile(int blk_q, int blk_k) {
  return blk_q == Tiles<T, D>::kBlock && blk_k == Tiles<T, D>::kBlock;
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace flash
