// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/paged_attention.py::_ragged_kernel
// (launched by _ragged_attention_pallas). Same function: a ragged token
// batch q [T, Hq, D] of R rows over a paged KV pool [P, Hkv, ps, D]; token
// t = q_start[r] + j of row r sees the first vis = kv_len[r] - q_len[r] +
// j + 1 slots of its row's pages (a token no row owns: vis 0, output 0).
// Each block finds its token's row itself from the [R] descriptors.
// GQA: the Hq / Hkv query heads of one kv head share its K/V. Online
// softmax across the kv positions in fp32; int8 pools are dequantized on
// load (k_f32 = k_i8 * scale, scale bf16 per (page, head, slot)).
//
// What bounds it on the card: bytes. The least traffic is each row's
// visible K/V read once, plus q and o, over the H100's 3.35 TB/s (a long
// prefill chunk moves the bound towards operations: 4 * vis * Hq * D per
// token). Design, kept simple for a first port: one block per (token, kv
// head), four warps. The block stages the group's q rows in shared memory
// (fp32), walks the visible positions in tiles of 32 (one kv position per
// lane), stages each tile of K and V once in shared memory, dequantized,
// and keeps the accumulator, max and sum in shared memory. The tile's K/V
// arrive as 16-byte vector loads, all of them in flight at once, and the
// next tile's loads are started before the current tile's math, so memory
// latency overlaps compute. The head dim is a template parameter; 128
// (Llama 3) is the one built, and launch() names where another goes (any
// D whose row, D * sizeof(pool element), is whole 16-byte vectors). q and
// fp pools share one dtype (fp32 or bf16); int8 pools take either q.
// It never reads a slot at or past vis, so page
// 0 (the scratch page, garbage by contract) is only read by the rows that
// point at it on purpose. Tokens of one row each re-read the row's prefix,
// so a prefill chunk reads its prefix once per token (mostly from L2):
// tensor-core tiles per (row, q-block, kv head) that read it once per
// block, and a split over pages for short decode batches, are the next
// steps.
//
// Exactly as the TPU kernel: a masked score is -inf and contributes p = 0;
// the rescale of the running sum is 0 while the running max is still -inf
// (no exp(-inf - -inf) NaN); the final sum is floored at 1e-30, so a
// padding token (no visible slot) comes back exactly 0.
//
// Plain C interface (loaded with ctypes): ragged_paged_attention() launches
// on the given stream and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // kv positions per tile: one per lane
constexpr int kThreads = 128;  // four warps per block

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of pool elements, widened to fp32
template <typename KT>
struct Vec16 {
  static constexpr int kN = 16 / sizeof(KT);
};
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4],
                                       const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8],
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16],
                                       const int8_t*) {
  const int8_t* p = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(p[i]);
}

// Register-staged K/V of one tile: thread tid holds
// vectors tid, tid + kThreads, ... of the tile's kTile * kD / N vectors.
template <typename KT, bool kHasScales, int kD>
struct TileRegs {
  static constexpr int kN = Vec16<KT>::kN;
  static constexpr int kPerRow = kD / kN;
  static constexpr int kPerTile = kTile * kPerRow;
  static constexpr int kPerThread = (kPerTile + kThreads - 1) / kThreads;
  static_assert(kD % kN == 0, "head dim must fill whole 16-byte vectors");
  uint4 k[kPerThread], v[kPerThread];
  float ks[kPerThread], vs[kPerThread];

  // start the loads of the tile at kv position s0 (n valid rows)
  __device__ __forceinline__ void load(
      const KT* __restrict__ k_pages, const KT* __restrict__ v_pages,
      const __nv_bfloat16* __restrict__ k_scale,
      const __nv_bfloat16* __restrict__ v_scale,
      const int32_t* __restrict__ pt, int s0, int n, int Hkv, int h,
      int ps, int tid) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / kPerRow;
      if (e < kPerTile && j < n) {
        const int pos = s0 + j;
        const size_t slot =
            ((size_t)pt[pos / ps] * Hkv + h) * ps + (pos % ps);
        const size_t off = slot * kD + (size_t)(e % kPerRow) * kN;
        k[i] = *reinterpret_cast<const uint4*>(k_pages + off);
        v[i] = *reinterpret_cast<const uint4*>(v_pages + off);
        if (kHasScales) {
          ks[i] = __bfloat162float(k_scale[slot]);
          vs[i] = __bfloat162float(v_scale[slot]);
        }
      }
    }
  }

  // widen (and dequantize) the staged tile into shared memory
  __device__ __forceinline__ void store(float* k_s, float* v_s, int n,
                                        int tid) const {
    constexpr int kStride = kD + 1;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / kPerRow;
      if (e < kPerTile && j < n) {
        const int d0 = (e % kPerRow) * kN;
        float fk[kN], fv[kN];
        unpack(k[i], fk, static_cast<const KT*>(nullptr));
        unpack(v[i], fv, static_cast<const KT*>(nullptr));
#pragma unroll
        for (int t = 0; t < kN; ++t) {
          k_s[j * kStride + d0 + t] = kHasScales ? fk[t] * ks[i] : fk[t];
          v_s[j * kD + d0 + t] = kHasScales ? fv[t] * vs[i] : fv[t];
        }
      }
    }
  }
};

template <typename QT, typename KT, bool kHasScales, int kD>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const QT* __restrict__ q,                   // [T, Hq, D]
    const KT* __restrict__ k_pages,             // [P, Hkv, ps, D]
    const KT* __restrict__ v_pages,             // [P, Hkv, ps, D]
    const __nv_bfloat16* __restrict__ k_scale,  // [P, Hkv, ps] or null
    const __nv_bfloat16* __restrict__ v_scale,  // [P, Hkv, ps] or null
    const int32_t* __restrict__ page_table,     // [R, max_pages]
    const int32_t* __restrict__ q_start,        // [R]
    const int32_t* __restrict__ q_len,          // [R]
    const int32_t* __restrict__ kv_len,         // [R]
    QT* __restrict__ out,                       // [T, Hq, D]
    int R, int Hq, int Hkv, int ps, int max_pages, float sm_scale) {
  extern __shared__ float smem[];
  __shared__ int row_s, vis_s;
  constexpr int D = kD;
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int qpk = Hq / Hkv;
  const int kstride = D + 1;  // padded: lane j reads row j, no bank clash
  float* q_s = smem;                    // [qpk, D]
  float* acc_s = q_s + qpk * D;         // [qpk, D]
  float* k_s = acc_s + qpk * D;         // [kTile, D + 1]
  float* v_s = k_s + kTile * kstride;   // [kTile, D]
  float* p_s = v_s + kTile * D;         // [qpk, kTile]
  float* m_s = p_s + qpk * kTile;       // [qpk] running max
  float* l_s = m_s + qpk;               // [qpk] running sum
  float* c_s = l_s + qpk;               // [qpk] this tile's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // this token's row (the first whose span holds t) and visible length;
  // a token no row owns sees nothing. Warp 0 tests 32 rows at a time.
  if (warp == 0) {
    int row = -1, vis = 0;
    for (int r0 = 0; r0 < R && row < 0; r0 += 32) {
      const int r = r0 + lane;
      int qs = 0, ql = 0;
      if (r < R) {
        qs = q_start[r];
        ql = q_len[r];
      }
      const unsigned hit =
          __ballot_sync(0xffffffffu, r < R && t >= qs && t < qs + ql);
      if (hit) {
        const int src = __ffs(hit) - 1;
        const int v = (r < R) ? kv_len[r] - ql + (t - qs) + 1 : 0;
        row = r0 + src;
        vis = __shfl_sync(0xffffffffu, v, src);
      }
    }
    if (lane == 0) {
      row_s = row < 0 ? 0 : row;
      vis_s = vis;
    }
  }
  __syncthreads();
  const int vis = vis_s;
  const int32_t* pt = page_table + (size_t)row_s * max_pages;
  const size_t qoff = ((size_t)t * Hq + (size_t)h * qpk) * D;

  for (int e = tid; e < qpk * D; e += blockDim.x) {
    q_s[e] = load_f(q + qoff + e);
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < qpk; i += blockDim.x) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }

  TileRegs<KT, kHasScales, kD> regs;
  if (vis > 0)
    regs.load(k_pages, v_pages, k_scale, v_scale, pt, 0, min(kTile, vis),
              Hkv, h, ps, tid);
  __syncthreads();

  for (int s0 = 0; s0 < vis; s0 += kTile) {
    const int n = min(kTile, vis - s0);
    regs.store(k_s, v_s, n, tid);
    if (s0 + kTile < vis)  // next tile's loads fly during this tile
      regs.load(k_pages, v_pages, k_scale, v_scale, pt, s0 + kTile,
                min(kTile, vis - s0 - kTile), Hkv, h, ps, tid);
    __syncthreads();

    // scores and the online-softmax update: one warp per query head,
    // lane j scores kv position s0 + j
    for (int qi = warp; qi < qpk; qi += nwarps) {
      float s = -INFINITY;
      if (lane < n) {
        const float* qr = q_s + qi * D;
        const float* kr = k_s + lane * kstride;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * sm_scale;
      }
      float mx = s;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, mx);
      const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
      float sum = p;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[qi * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
        m_s[qi] = m_new;
        l_s[qi] = l_s[qi] * corr + sum;
        c_s[qi] = corr;
      }
    }
    __syncthreads();

    for (int e = tid; e < qpk * D; e += blockDim.x) {
      const int qi = e / D;
      const int d = e - qi * D;
      const float* pr = p_s + qi * kTile;
      float a = acc_s[e] * c_s[qi];
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < qpk * D; e += blockDim.x) {
    const float l = fmaxf(l_s[e / D], 1e-30f);
    store_f(out + qoff + e, acc_s[e] / l);
  }
}

struct Args {
  const void *q, *k_pages, *v_pages, *k_scale, *v_scale;
  const void *page_table, *q_start, *q_len, *kv_len;
  void* out;
  int T, R, Hq, Hkv, ps, D, max_pages;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename KT, bool kHasScales, int kD>
cudaError_t launch_kernel(const Args& a) {
  const int qpk = a.Hq / a.Hkv;
  constexpr int D = kD;
  const size_t smem = sizeof(float) * (2 * qpk * D + kTile * (D + 1) +
                                       kTile * D + qpk * kTile + 3 * qpk);
  auto kernel = ragged_paged_attention_kernel<QT, KT, kHasScales, kD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(a.T, a.Hkv);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pages),
      static_cast<const KT*>(a.v_pages),
      static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale),
      static_cast<const int32_t*>(a.page_table),
      static_cast<const int32_t*>(a.q_start),
      static_cast<const int32_t*>(a.q_len),
      static_cast<const int32_t*>(a.kv_len), static_cast<QT*>(a.out), a.R,
      a.Hq, a.Hkv, a.ps, a.max_pages, a.sm_scale);
  return cudaGetLastError();
}

template <typename QT, typename KT, bool kHasScales>
cudaError_t launch(const Args& a) {
  // K/V load as whole 16-byte vectors: the pool pointers must be 16-byte
  // aligned (each row then is, D * sizeof(KT) being a multiple of 16)
  if ((uintptr_t)a.k_pages % 16 != 0 || (uintptr_t)a.v_pages % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (a.D == 128) return launch_kernel<QT, KT, kHasScales, 128>(a);
  return cudaErrorInvalidValue;  // a head dim not built
}

}  // namespace

extern "C" {

// q_dtype: 0 fp32, 1 bf16. kv_dtype: q_dtype, or 2 int8 (scales
// required). Head dim 128. Row descriptors q_start/q_len/kv_len are int32 [R]. Returns
// 0 on success, else the cudaError_t code.
int ragged_paged_attention(int q_dtype, int kv_dtype, const void* q,
                           const void* k_pages, const void* v_pages,
                           const void* k_scale, const void* v_scale,
                           const void* page_table, const void* q_start,
                           const void* q_len, const void* kv_len, void* out,
                           int T, int R, int Hq, int Hkv, int ps, int D,
                           int max_pages, float sm_scale, void* stream) {
  if (T == 0) return 0;
  if (R <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || ps <= 0)
    return (int)cudaErrorInvalidValue;
  const bool scales = k_scale != nullptr && v_scale != nullptr;
  if ((kv_dtype == kI8) != scales) return (int)cudaErrorInvalidValue;
  const Args a{q,      k_pages, v_pages, k_scale,   v_scale,
               page_table, q_start, q_len, kv_len, out,
               T,      R,       Hq,      Hkv,       ps,
               D,      max_pages, sm_scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == kF32 && kv_dtype == kF32)
    return (int)launch<float, float, false>(a);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return (int)launch<float, int8_t, true>(a);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16, false>(a);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return (int)launch<__nv_bfloat16, int8_t, true>(a);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
