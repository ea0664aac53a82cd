// Paged decode attention for Hopper (sm_90a), split over pages.
//
// Replaces the TPU kernel ray_tpu/ops/paged_attention.py::_decode_kernel
// (launched by _paged_attention_pallas). Same function: one decode token
// per sequence, q [B, Hq, D], over a paged KV pool [P, Hkv, ps, D] in q's
// dtype (fp32 or bf16); sequence b sees the first
// min(seq_lens[b], max_pages * ps) slots of the pages named by its row of
// page_table. GQA: query head i reads kv head i / (Hq / Hkv).
//
// What bounds it on the card: bytes. Each visible K/V slot read once,
// plus q and o, over the H100's 3.35 TB/s; the products (4 * len * Hq * D
// FLOP) take a small fraction of that time even on CUDA cores.
//
// Design. The TPU grid (B, max_pages) walks a sequence's pages in order on
// one core. Here one block per (sequence, kv head, split) walks a split of
// pages_per_split consecutive pages, so one long sequence spreads over many
// SMs; the wrapper takes the split size from decode_plan
// (ops/paged_attention.py), from the shapes alone, so the host reads no
// lengths: 8 pages (of 16 slots) at the serving batch of 8 x 2048
// tokens, 32 at 8 x 8192, two pages of 32 at bench_llm.py's widths. A split that
// starts past its sequence's end writes an empty partial (m = -inf, l = 0)
// and stops. A second launch merges the splits' (m, l, acc) without
// atomics, in a fixed order, so the result is repeatable; with a single
// split the first launch writes the output itself.
//
// bf16 pools, paged_decode_sm90_kernel (paged_ring.cuh): a ring of 2
// stages of 32 slots (K and V of whole pages, in bf16 as stored, landed by
// TMA boxes with the 128-byte swizzle against bank conflicts) filled by a
// producer warp, two consumer warps taking the stages in turn, products on
// the tensor cores (mma.sync m16n8k16, the kv head's query rows padded to
// 16), the online softmax on the accumulator fragments once per stage, and
// a merge whose warps read the splits in parallel
// (paged_decode_merge_sm90_kernel). What it does about the first port's
// walk (one page in flight per block in registers, V widened to fp32 in
// shared memory, three block barriers and two 5-step shuffle reductions
// per page, CUDA-core products, a fixed split size, a serial merge): 32 KB
// of pages in flight per block and six blocks an SM at head dim 128 (ring
// depth measured: 2, 4 and 6 stages, PERF.md), no widening pass and no
// block barrier in the walk, one 2-step reduction per stage.
//
// fp32 pools (the oracle) keep the first port's walk and merge
// (paged_split.cuh, shared with the ragged kernel's decode rows): one
// block of four warps per split, the next page's loads in registers during
// this page's softmax and p.v, products on CUDA cores in fp32.
//
// It reads no page id at or past ceil(len / ps), so the table's unused
// tail may hold anything, and takes the ids it reads as lying in [0, P).
// Built for head dim 64 or 128, pages of 8, 16 or 32 slots and 1, 2, 4 or
// 8 query heads per kv head (Llama 3: 128, 16, 4; the JAX package's
// serving benchmark: 64, 32, 2); launch() names where another goes.
//
// Plain C interface (loaded with ctypes): paged_attention() launches on
// the given stream and returns the cudaError_t of the launches.

#include <type_traits>

#include "paged_ring.cuh"
#include "paged_split.cuh"

namespace {

using paged::kThreads;

enum DType { kF32 = 0, kBF16 = 1 };

// fp32: grid (split, kv head, sequence), the block walks one split of the
// sequence's pages for one kv head (paged_split.cuh)
template <typename T, int kPS, int kQpk, int kD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,                 // [B, Hq, D]
    const T* __restrict__ k_pages,           // [P, Hkv, ps, D]
    const T* __restrict__ v_pages,           // [P, Hkv, ps, D]
    const int32_t* __restrict__ page_table,  // [B, max_pages]
    const int32_t* __restrict__ seq_lens,    // [B]
    T* __restrict__ out,                     // [B, Hq, D]: one split
    float* __restrict__ work,                // partials: several splits
    int Hkv, int max_pages, int pages_per_split, float sm_scale) {
  __shared__ paged::SplitSmem<kPS, kQpk, kD> sm;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Hq = Hkv * kQpk;
  const size_t row0 = (size_t)b * Hq + (size_t)h * kQpk;  // first q row
  // visible slots (the table holds max_pages * ps)
  const int len = min(max(seq_lens[b], 0), max_pages * kPS);
  const paged::SplitOut<T> dst{out + row0 * kD, work,
                               (size_t)gridDim.z * Hq, row0};
  paged::split_walk<T, T, false, kPS, kQpk, kD>(
      sm, q + row0 * kD, k_pages, v_pages, nullptr, nullptr,
      page_table + (size_t)b * max_pages, len, Hkv, h, split, gridDim.x,
      pages_per_split, sm_scale, dst);
}

// One block per (sequence, query head) row: the splits' partials merged
// in split order, empty splits skipped.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) paged_decode_merge_kernel(
    const float* __restrict__ work, T* __restrict__ out, int rows,
    int n_splits) {
  const size_t r = blockIdx.x;
  paged::merge_splits<T, kD>(work, rows, r, n_splits, out + r * kD);
}

// bf16: grid (split, kv head, sequence), the ring walk of paged_ring.cuh;
// the pools through tensor maps (ring::make_page_map)
template <int kPS, int kQpk, int kD>
__global__ void __launch_bounds__(ring::kThreads) paged_decode_sm90_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out,
    float* __restrict__ work, int Hkv, int max_pages, int pages_per_split,
    float sm_scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t Hq = (size_t)Hkv * kQpk;
  const size_t row0 = (size_t)b * Hq + (size_t)h * kQpk;  // first q row
  const int len = min(max(seq_lens[b], 0), max_pages * kPS);
  ring::split_walk<kPS, kQpk, kD>(
      q + row0 * kD, &tm_k, &tm_v, page_table + (size_t)b * max_pages,
      len, Hkv, h, split, gridDim.x, pages_per_split, sm_scale,
      out + row0 * kD, work, (size_t)gridDim.z * Hq, row0);
}

// bf16: one block per (sequence, query head) row, its warps reading the
// splits in parallel
template <int kD>
__global__ void __launch_bounds__(ring::kMergeThreads)
    paged_decode_merge_sm90_kernel(const float* __restrict__ work,
                                   __nv_bfloat16* __restrict__ out, int rows,
                                   int n_splits) {
  const size_t r = blockIdx.x;
  ring::merge_parallel<kD>(work, rows, r, n_splits, out + r * kD);
}

struct Args {
  const void *q, *k_pages, *v_pages, *page_table, *seq_lens;
  void *out, *work;
  int B, P, Hq, Hkv, ps, D, max_pages, pages_per_split;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int kPS, int kQpk, int kD>
cudaError_t launch_kernels(const Args& a) {
  const int n_splits =
      a.max_pages / a.pages_per_split + (a.max_pages % a.pages_per_split != 0);
  if (n_splits > 1 && a.work == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(n_splits < 1 ? 1 : n_splits, a.Hkv, a.B);
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using B16 = __nv_bfloat16;
    CUtensorMap tm_k, tm_v;
    if ((err = ring::make_page_map(&tm_k, a.k_pages, a.P, a.Hkv, kPS,
                                   kD)) != cudaSuccess ||
        (err = ring::make_page_map(&tm_v, a.v_pages, a.P, a.Hkv, kPS,
                                   kD)) != cudaSuccess)
      return err;
    auto kernel = paged_decode_sm90_kernel<kPS, kQpk, kD>;
    constexpr size_t smem = ring::Layout<kD>::kSmem;
    if constexpr (smem > 48 * 1024) {  // a deeper ring than the design's
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, ring::kThreads, smem, a.stream>>>(
        static_cast<const B16*>(a.q), tm_k, tm_v,
        static_cast<const int32_t*>(a.page_table),
        static_cast<const int32_t*>(a.seq_lens), static_cast<B16*>(a.out),
        static_cast<float*>(a.work), a.Hkv, a.max_pages, a.pages_per_split,
        a.sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || n_splits <= 1) return err;
    paged_decode_merge_sm90_kernel<kD>
        <<<a.B * a.Hq, ring::kMergeThreads, 0, a.stream>>>(
            static_cast<const float*>(a.work), static_cast<B16*>(a.out),
            a.B * a.Hq, n_splits);
    return cudaGetLastError();
  } else {
    paged_decode_kernel<T, kPS, kQpk, kD><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
        static_cast<const T*>(a.v_pages),
        static_cast<const int32_t*>(a.page_table),
        static_cast<const int32_t*>(a.seq_lens), static_cast<T*>(a.out),
        static_cast<float*>(a.work), a.Hkv, a.max_pages, a.pages_per_split,
        a.sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || n_splits <= 1) return err;
    paged_decode_merge_kernel<T, kD><<<a.B * a.Hq, kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.work), static_cast<T*>(a.out),
        a.B * a.Hq, n_splits);
    return cudaGetLastError();
  }
}

template <typename T, int kPS, int kD>
cudaError_t by_q_per_kv(const Args& a) {
  switch (a.Hq / a.Hkv) {
    case 1: return launch_kernels<T, kPS, 1, kD>(a);
    case 2: return launch_kernels<T, kPS, 2, kD>(a);
    case 4: return launch_kernels<T, kPS, 4, kD>(a);
    case 8: return launch_kernels<T, kPS, 8, kD>(a);
  }
  return cudaErrorInvalidValue;  // a group size not built
}

template <typename T, int kD>
cudaError_t by_page_size(const Args& a) {
  switch (a.ps) {
    case 8: return by_q_per_kv<T, 8, kD>(a);
    case 16: return by_q_per_kv<T, 16, kD>(a);
    case 32: return by_q_per_kv<T, 32, kD>(a);
  }
  return cudaErrorInvalidValue;  // a page size not built
}

template <typename T>
cudaError_t launch(const Args& a) {
  // q, K and V load as whole 16-byte vectors: the pointers must be 16-byte
  // aligned (each row then is, D * sizeof(T) being a multiple of 16)
  if ((uintptr_t)a.q % 16 != 0 || (uintptr_t)a.k_pages % 16 != 0 ||
      (uintptr_t)a.v_pages % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (a.D == 64) return by_page_size<T, 64>(a);
  if (a.D == 128) return by_page_size<T, 128>(a);
  return cudaErrorInvalidValue;  // a head dim not built
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, pools and out alike); P pages in each pool.
// page_table int32 [B, max_pages], seq_lens int32 [B]. work: fp32,
// B * Hq * n_splits * (D + 2) floats when n_splits = ceil(max_pages /
// pages_per_split) > 1, else unused. Returns 0 on success, else the
// cudaError_t code.
int paged_attention(int dtype, const void* q, const void* k_pages,
                    const void* v_pages, const void* page_table,
                    const void* seq_lens, void* out, void* work, int B,
                    int P, int Hq, int Hkv, int ps, int D, int max_pages,
                    int pages_per_split, float sm_scale, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || B > 65535 || P <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      D <= 0 || ps <= 0 || max_pages < 0 || pages_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q,         k_pages,         v_pages,  page_table,
               seq_lens,  out,             work,     B,
               P,         Hq,              Hkv,      ps,
               D,         max_pages,       pages_per_split, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == kF32) return (int)launch<float>(a);
  if (dtype == kBF16) return (int)launch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// slots of one stage of the bf16 walk's ring, which decode_plan
// (ops/paged_attention.py) builds its split sizes from
int paged_decode_stage_slots() { return ring::kSlots; }

}  // extern "C"
