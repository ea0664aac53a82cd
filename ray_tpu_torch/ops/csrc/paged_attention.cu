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
// K/V page once for all of them. Per page: thread (slot j, chunk c) holds
// a 1/TPS slice of slot j's K row (TPS = 128 / ps threads per slot) and
// the same slice of every query row; the partial dots are summed over the
// slot's TPS lanes by shuffles; one warp per query head then makes the
// page's online-softmax update; V goes to shared memory as fp32 (slots
// past the length as 0), and each thread accumulates p.v for one head-dim
// column of every query head in registers. The next page's K and V loads
// (16-byte vectors) are issued before this page's softmax and p.v, so they
// fly during them. A second launch merges the splits' (m, l, acc) in split
// order, without atomics, so the result is deterministic; with a single
// split the first launch writes the output itself.
//
// Exactly as the TPU kernel, per page: the fp32 score is scaled after the
// product; slots at or past the length are -inf and give p = 0; m_new =
// max(m, page max); the rescale is 0 while m is -inf; l sums the unrounded
// p; p is rounded to v's dtype before p.v, accumulated in fp32; the output
// is acc / max(l, 1e-30), so a length-0 sequence comes back exactly 0.
// The merge: M = max m_i, o = sum e^(m_i - M) acc_i /
// max(sum e^(m_i - M) l_i, 1e-30) over the non-empty splits.
//
// It reads no page id at or past ceil(len / ps), so the table's unused
// tail may hold anything, and takes the ids it reads as lying in [0, P).
// Products run on CUDA cores in fp32: q_per_kv rows against a 16-slot page
// is too little work per page for tensor cores to pay. Built for head dim
// 128, pages of 8 or 16 slots and 1, 2, 4 or 8 query heads per kv head
// (Llama 3: 4); launch() names where another goes.
//
// Plain C interface (loaded with ctypes): paged_attention() launches on
// the given stream and returns the cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// p in v's dtype, as the TPU kernel's p.astype(v.dtype)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of elements, widened to fp32
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

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
  constexpr int kN = 16 / sizeof(T);     // elements per 16-byte vector
  constexpr int kTPS = kThreads / kPS;   // threads per slot
  constexpr int kEPT = kD / kTPS;        // head-dim elements per thread
  constexpr int kVec = kEPT / kN;        // K (and V) vectors per thread
  constexpr int kCols = kD / kThreads;   // p.v columns per thread
  constexpr int kRows = (kQpk + kWarps - 1) / kWarps;  // heads per warp
  static_assert(kTPS * kPS == kThreads && kTPS <= 32, "page size");
  static_assert(kEPT % kN == 0 && kD % kThreads == 0, "head dim");
  static_assert(kVec * kN * kThreads == kPS * kD, "V vectors per thread");

  __shared__ __align__(16) float v_s[2][kPS * kD];  // V of a page, fp32
  __shared__ float s_s[kQpk][kPS];                  // the page's scores
  __shared__ __align__(16) float p_s[kQpk][kPS];    // p in v's dtype
  __shared__ float c_s[kQpk];                       // the page's rescale
  __shared__ float m_s[kQpk], l_s[kQpk];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * kQpk;
  const size_t row0 = (size_t)b * Hq + (size_t)h * kQpk;  // first q row
  const size_t rows = (size_t)gridDim.z * Hq;
  float* m_w = work;                          // [B * Hq, n_splits]
  float* l_w = work + rows * n_splits;        // [B * Hq, n_splits]
  float* acc_w = work + 2 * rows * n_splits;  // [B * Hq, n_splits, D]

  // visible slots (the table holds max_pages * ps) and this split's pages
  const int len = min(max(seq_lens[b], 0), max_pages * kPS);
  const int n_pages = (len + kPS - 1) / kPS;
  const int p_begin = split * pages_per_split;
  const int p_end = min(p_begin + pages_per_split, n_pages);
  if (n_splits > 1 && p_begin >= p_end) {  // past the sequence: empty
    if (tid < kQpk) {
      m_w[(row0 + tid) * n_splits + split] = -INFINITY;
      l_w[(row0 + tid) * n_splits + split] = 0.f;
    }
    return;
  }

  // thread (slot j, chunk c) covers head-dim elements c*kEPT .. +kEPT
  const int j = tid / kTPS, c = tid % kTPS;
  float qf[kQpk][kEPT];
#pragma unroll
  for (int qi = 0; qi < kQpk; ++qi)
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      unpack(load16(q + (row0 + qi) * kD + c * kEPT + v * kN),
             &qf[qi][v * kN], q);

  float m_r[kRows], l_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.f;
  }
  float acc[kQpk][kCols];
#pragma unroll
  for (int qi = 0; qi < kQpk; ++qi)
#pragma unroll
    for (int col = 0; col < kCols; ++col) acc[qi][col] = 0.f;

  // K: this thread's slice of slot j; V: vectors tid, tid + kThreads, ...
  const int32_t* pt = page_table + (size_t)b * max_pages;
  uint4 kr[kVec], vr[kVec];
  auto load_page = [&](int p) {
    const size_t base = ((size_t)pt[p] * Hkv + h) * (kPS * kD);
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      kr[v] = load16(k_pages + base + tid * kEPT + v * kN);
      vr[v] = load16(v_pages + base + (size_t)(tid + v * kThreads) * kN);
    }
  };
  if (p_begin < p_end) load_page(p_begin);

  for (int p = p_begin, buf = 0; p < p_end; ++p, buf ^= 1) {
    const int n = min(kPS, len - p * kPS);  // valid slots of this page
    // V into shared memory; slots past the length as 0, so that p.v can
    // run over the whole page (p is 0 there, and 0 * garbage may not be)
    float* vb = v_s[buf];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int e = (tid + v * kThreads) * kN;  // element in the page
      float f[kN];
      unpack(vr[v], f, v_pages);
      const bool valid = e / kD < n;
#pragma unroll
      for (int t = 0; t < kN; t += 4)
        *reinterpret_cast<float4*>(vb + e + t) =
            valid ? make_float4(f[t], f[t + 1], f[t + 2], f[t + 3])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // slot j's scores: partial dots over this thread's slice, summed over
    // the slot's kTPS lanes
    float kf[kEPT];
#pragma unroll
    for (int v = 0; v < kVec; ++v) unpack(kr[v], &kf[v * kN], k_pages);
#pragma unroll
    for (int qi = 0; qi < kQpk; ++qi) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kEPT; ++i) dot = fmaf(qf[qi][i], kf[i], dot);
#pragma unroll
      for (int off = kTPS / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      if (c == 0) s_s[qi][j] = j < n ? dot * sm_scale : -INFINITY;
    }
    // the next page's loads fly during this page's softmax and p.v
    if (p + 1 < p_end) load_page(p + 1);
    __syncthreads();

    // the page's online-softmax update: one warp per query head, lane =
    // slot
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = warp + r * kWarps;
      if (qi < kQpk) {
        const float s = lane < kPS ? s_s[qi][lane] : -INFINITY;
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_new = fmaxf(m_r[r], mx);
        const float pe = s == -INFINITY ? 0.f : expf(s - m_new);
        float sum = pe;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(kFull, sum, off);
        const float corr =
            m_r[r] == -INFINITY ? 0.f : expf(m_r[r] - m_new);
        if (lane < kPS) p_s[qi][lane] = round_to(pe, v_pages);
        if (lane == 0) c_s[qi] = corr;
        l_r[r] = l_r[r] * corr + sum;
        m_r[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p.v for column tid (+ kThreads ...) of each head
#pragma unroll
    for (int qi = 0; qi < kQpk; ++qi) {
      const float corr = c_s[qi];
#pragma unroll
      for (int col = 0; col < kCols; ++col) acc[qi][col] *= corr;
    }
#pragma unroll
    for (int j0 = 0; j0 < kPS; j0 += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int col = 0; col < kCols; ++col)
          vv[t][col] = vb[(j0 + t) * kD + col * kThreads + tid];
#pragma unroll
      for (int qi = 0; qi < kQpk; ++qi) {
        const float4 pp = *reinterpret_cast<const float4*>(&p_s[qi][j0]);
#pragma unroll
        for (int col = 0; col < kCols; ++col) {
          float a = acc[qi][col];
          a = fmaf(pp.x, vv[0][col], a);
          a = fmaf(pp.y, vv[1][col], a);
          a = fmaf(pp.z, vv[2][col], a);
          a = fmaf(pp.w, vv[3][col], a);
          acc[qi][col] = a;
        }
      }
    }
  }

  // each warp's heads' m and l, for every thread
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = warp + r * kWarps;
    if (qi < kQpk && lane == 0) {
      m_s[qi] = m_r[r];
      l_s[qi] = l_r[r];
    }
  }
  __syncthreads();
  if (n_splits == 1) {
#pragma unroll
    for (int qi = 0; qi < kQpk; ++qi) {
      const float l = fmaxf(l_s[qi], 1e-30f);
#pragma unroll
      for (int col = 0; col < kCols; ++col)
        store_f(out + (row0 + qi) * kD + col * kThreads + tid,
                acc[qi][col] / l);
    }
    return;
  }
#pragma unroll
  for (int qi = 0; qi < kQpk; ++qi)
#pragma unroll
    for (int col = 0; col < kCols; ++col)
      acc_w[((row0 + qi) * n_splits + split) * kD + col * kThreads + tid] =
          acc[qi][col];
  if (tid < kQpk) {
    m_w[(row0 + tid) * n_splits + split] = m_s[tid];
    l_w[(row0 + tid) * n_splits + split] = l_s[tid];
  }
}

// One block per (sequence, query head) row: the splits' partials merged
// in split order, empty splits skipped.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) paged_decode_merge_kernel(
    const float* __restrict__ work, T* __restrict__ out, int rows,
    int n_splits) {
  constexpr int kCols = kD / kThreads;
  const size_t r = blockIdx.x;
  const int tid = threadIdx.x;
  const float* m_w = work + r * n_splits;
  const float* l_w = work + (size_t)rows * n_splits + r * n_splits;
  const float* acc_w =
      work + 2 * (size_t)rows * n_splits + r * n_splits * kD;
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, m_w[s]);
  float num[kCols];
#pragma unroll
  for (int col = 0; col < kCols; ++col) num[col] = 0.f;
  float den = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_splits; ++s) {
    const float m = m_w[s];
    if (m == -INFINITY) continue;  // an empty split
    const float w = expf(m - M);
    den += w * l_w[s];
#pragma unroll
    for (int col = 0; col < kCols; ++col)
      num[col] += w * acc_w[(size_t)s * kD + col * kThreads + tid];
  }
#pragma unroll
  for (int col = 0; col < kCols; ++col)
    store_f(out + r * kD + col * kThreads + tid,
            num[col] / fmaxf(den, 1e-30f));
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

template <typename T, int kPS>
cudaError_t by_q_per_kv(const Args& a) {
  switch (a.Hq / a.Hkv) {
    case 1: return launch_kernels<T, kPS, 1, 128>(a);
    case 2: return launch_kernels<T, kPS, 2, 128>(a);
    case 4: return launch_kernels<T, kPS, 4, 128>(a);
    case 8: return launch_kernels<T, kPS, 8, 128>(a);
  }
  return cudaErrorInvalidValue;  // a group size not built
}

template <typename T>
cudaError_t launch(const Args& a) {
  // q, K and V load as whole 16-byte vectors: the pointers must be 16-byte
  // aligned (each row then is, D * sizeof(T) being a multiple of 16)
  if ((uintptr_t)a.q % 16 != 0 || (uintptr_t)a.k_pages % 16 != 0 ||
      (uintptr_t)a.v_pages % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (a.D != 128) return cudaErrorInvalidValue;  // a head dim not built
  if (a.ps == 8) return by_q_per_kv<T, 8>(a);
  if (a.ps == 16) return by_q_per_kv<T, 16>(a);
  return cudaErrorInvalidValue;  // a page size not built
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
