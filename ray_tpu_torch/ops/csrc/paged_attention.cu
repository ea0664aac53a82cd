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
// one core. Here one block of four warps per (sequence, kv head, split)
// walks a split of pages_per_split consecutive pages, so one long sequence
// spreads over many SMs. The wrapper's choice, 16 pages (256 tokens) a
// split, makes a decode batch of 8 at 2048 tokens 8 x 8 x 8 = 512 blocks on
// 132 SMs, where one block per (sequence, kv head) would be 64; the
// number of splits comes from the table's shape (max_pages), never from the
// lengths, so the host reads nothing. A split that starts past its
// sequence's end writes an empty partial (m = -inf, l = 0) and stops.
// The block reads its q_per_kv query rows once, into registers, and each
// K/V page once for all of them, the next page's 16-byte loads in flight
// during this page's softmax and p.v. A second launch merges the splits'
// (m, l, acc) in split order, without atomics, so the result is
// deterministic; with a single split the first launch writes the output
// itself. The walk and the merge live in paged_split.cuh, which the
// ragged kernel's decode rows share; the arithmetic, per page exactly as
// the TPU kernel's, is described there.
//
// It reads no page id at or past ceil(len / ps), so the table's unused
// tail may hold anything, and takes the ids it reads as lying in [0, P).
// Products run on CUDA cores in fp32: q_per_kv rows against a 16-slot page
// is too little work per page for tensor cores to pay. Built for head dim
// 64 or 128, pages of 8, 16 or 32 slots and 1, 2, 4 or 8 query heads per
// kv head (Llama 3: 128, 16, 4; the JAX package's serving benchmark: 64,
// 32, 2); launch() names where another goes.
//
// Plain C interface (loaded with ctypes): paged_attention() launches on
// the given stream and returns the cudaError_t of the launches.

#include "paged_split.cuh"

namespace {

using paged::kThreads;

enum DType { kF32 = 0, kBF16 = 1 };

// grid (split, kv head, sequence): the block walks one split of the
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

struct Args {
  const void *q, *k_pages, *v_pages, *page_table, *seq_lens;
  void *out, *work;
  int B, Hq, Hkv, ps, D, max_pages, pages_per_split;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int kPS, int kQpk, int kD>
cudaError_t launch_kernels(const Args& a) {
  const int n_splits =
      a.max_pages / a.pages_per_split + (a.max_pages % a.pages_per_split != 0);
  if (n_splits > 1 && a.work == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(n_splits < 1 ? 1 : n_splits, a.Hkv, a.B);
  paged_decode_kernel<T, kPS, kQpk, kD><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages),
      static_cast<const int32_t*>(a.page_table),
      static_cast<const int32_t*>(a.seq_lens), static_cast<T*>(a.out),
      static_cast<float*>(a.work), a.Hkv, a.max_pages, a.pages_per_split,
      a.sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits <= 1) return err;
  paged_decode_merge_kernel<T, kD><<<a.B * a.Hq, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.work), static_cast<T*>(a.out), a.B * a.Hq,
      n_splits);
  return cudaGetLastError();
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

// dtype: 0 fp32, 1 bf16 (q, pools and out alike). page_table int32
// [B, max_pages], seq_lens int32 [B]. work: fp32, B * Hq * n_splits *
// (D + 2) floats when n_splits = ceil(max_pages / pages_per_split) > 1,
// else unused. Returns 0 on success, else the cudaError_t code.
int paged_attention(int dtype, const void* q, const void* k_pages,
                    const void* v_pages, const void* page_table,
                    const void* seq_lens, void* out, void* work, int B,
                    int Hq, int Hkv, int ps, int D, int max_pages,
                    int pages_per_split, float sm_scale, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      ps <= 0 || max_pages < 0 || pages_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k_pages, v_pages, page_table, seq_lens,
               out, work,   B,       Hq,         Hkv,
               ps, D,       max_pages, pages_per_split, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == kF32) return (int)launch<float>(a);
  if (dtype == kBF16) return (int)launch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
