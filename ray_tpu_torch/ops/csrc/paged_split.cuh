// The split walk over pages and its merge, shared by the decode op
// (paged_attention.cu) and the decode rows of the ragged kernel
// (ragged_paged_attention.cu).
//
// One block of four warps walks a split of consecutive pages of one
// sequence for one kv head and its kQpk query heads. Per page: thread
// (slot j, chunk c) holds a 1/TPS slice of slot j's K row (TPS = 128 / ps
// threads per slot) and the same slice of every query row; the partial
// dots are summed over the slot's TPS lanes by shuffles; one warp per
// query head then makes the page's online-softmax update; V goes to shared
// memory as fp32 (slots past the length as 0), and each thread accumulates
// p.v for one head-dim column of every query head in registers (at head
// dim 64, threads 0..63; the rest sit p.v out). The next
// page's K and V loads are issued before this page's softmax and p.v, so
// they fly during them. A split that starts past its sequence's end writes
// an empty partial (m = -inf, l = 0) and stops; with a single split the
// walk writes the output itself.
//
// Per page, exactly as the TPU's _decode_kernel: the fp32 score is scaled
// after the product; slots at or past the length are -inf and give p = 0;
// m_new = max(m, page max); the rescale is 0 while m is -inf; l sums the
// unrounded p; p is rounded to v's dtype before p.v, accumulated in fp32;
// the output is acc / max(l, 1e-30), so a length-0 sequence comes back
// exactly 0. The merge: M = max m_i, o = sum e^(m_i - M) acc_i /
// max(sum e^(m_i - M) l_i, 1e-30) over the non-empty splits, in split
// order, without atomics, so the result is repeatable.
//
// Pools in q's dtype (fp32, bf16), or int8 with a bf16 scale per (page,
// head, slot), dequantized on load as the TPU's _ragged_kernel does: the
// score is (q . k_i8) * k_scale * sm_scale and V is v_i8 * v_scale in fp32,
// so p, which meets an fp32 V, is not rounded. The walk reads no page id
// at or past ceil(len / ps) and no slot at or past len in V (K rows of the
// last page past len are read and their scores masked).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 128;  // four warps per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// p in v's dtype, as the TPU kernel's p.astype(v.dtype); int8 V meets p
// dequantized to fp32, so p stays fp32
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(float x, const int8_t*) { return x; }

// kBytes of elements in registers, loaded as the widest vectors that fit
template <int kBytes>
struct Raw {
  static_assert(kBytes % 16 == 0, "whole 16-byte vectors");
  uint4 v[kBytes / 16];
  __device__ __forceinline__ void load(const void* p) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      v[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ uint32_t word(int i) const {
    const uint4& u = v[i / 4];
    return (i & 3) == 0 ? u.x : (i & 3) == 1 ? u.y : (i & 3) == 2 ? u.z : u.w;
  }
};
template <>
struct Raw<8> {
  uint2 v;
  __device__ __forceinline__ void load(const void* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ uint32_t word(int i) const {
    return i == 0 ? v.x : v.y;
  }
};
template <>
struct Raw<4> {
  uint32_t v;
  __device__ __forceinline__ void load(const void* p) {
    v = *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ uint32_t word(int) const { return v; }
};

// the elements of a Raw, widened to fp32 (f holds kBytes / sizeof(T))
template <int kBytes>
__device__ __forceinline__ void unpack(const Raw<kBytes>& r, float* f,
                                       const float*) {
#pragma unroll
  for (int i = 0; i < kBytes / 4; ++i) f[i] = __uint_as_float(r.word(i));
}
template <int kBytes>
__device__ __forceinline__ void unpack(const Raw<kBytes>& r, float* f,
                                       const __nv_bfloat16*) {
#pragma unroll
  for (int i = 0; i < kBytes / 4; ++i) {
    const uint32_t w = r.word(i);
    f[2 * i] = __uint_as_float(w << 16);
    f[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
  }
}
template <int kBytes>
__device__ __forceinline__ void unpack(const Raw<kBytes>& r, float* f,
                                       const int8_t*) {
#pragma unroll
  for (int i = 0; i < kBytes / 4; ++i) {
    const uint32_t w = r.word(i);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = static_cast<float>(static_cast<int8_t>(w >> (8 * b)));
  }
}

// the shared memory of one split walk
template <int kPS, int kQpk, int kD>
struct SplitSmem {
  __align__(16) float v_s[2][kPS * kD];  // V of a page, fp32
  float s_s[kQpk][kPS];                  // the page's scores
  __align__(16) float p_s[kQpk][kPS];    // p in v's dtype
  float c_s[kQpk];                       // the page's rescale
  float m_s[kQpk], l_s[kQpk];
};

// Where a walk leaves its result: the output rows themselves (one split),
// or the partials (m, l, acc) of rows row0 .. row0 + kQpk - 1 of a work
// buffer of `rows` rows: m [rows, n_splits], l [rows, n_splits], acc
// [rows, n_splits, D].
template <typename QT>
struct SplitOut {
  QT* out;  // [kQpk, D]: the group's output rows
  float* work;
  size_t rows, row0;
};

// One split of one sequence for one kv head: q_rows [kQpk, D] (16-byte
// aligned), pt the sequence's page table, len its visible slots (at most
// the table's max_pages * ps).
template <typename QT, typename KT, bool kScales, int kPS, int kQpk, int kD>
__device__ __forceinline__ void split_walk(
    SplitSmem<kPS, kQpk, kD>& sm, const QT* __restrict__ q_rows,
    const KT* __restrict__ k_pages, const KT* __restrict__ v_pages,
    const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale,
    const int32_t* __restrict__ pt, int len, int Hkv, int h, int split,
    int n_splits, int pages_per_split, float sm_scale,
    const SplitOut<QT>& dst) {
  constexpr int kTPS = kThreads / kPS;       // threads per slot
  constexpr int kEPT = kD / kTPS;            // head-dim elements per thread
  constexpr int kQB = kEPT * sizeof(QT) < 16 ? kEPT * sizeof(QT) : 16;
  constexpr int kQN = kQB / sizeof(QT);      // q elements per vector
  constexpr int kQVec = kEPT / kQN;          // q vectors per row and thread
  constexpr int kBytes = kEPT * sizeof(KT);  // K (and V) bytes per thread
  constexpr int kVB = kBytes < 16 ? kBytes : 16;  // bytes per V vector
  constexpr int kVE = kVB / sizeof(KT);           // elements per V vector
  constexpr int kVVec = kBytes / kVB;             // V vectors per thread
  // p.v: thread tid < kColT accumulates columns tid, tid + kColT, ... (at
  // head dim 64 the other half of the block sits this part out)
  constexpr int kColT = kD < kThreads ? kD : kThreads;
  constexpr int kCols = kD / kColT;               // p.v columns per thread
  constexpr int kRows = (kQpk + kWarps - 1) / kWarps;  // heads per warp
  static_assert(kTPS * kPS == kThreads && kTPS <= 32, "page size");
  static_assert(kEPT % kQN == 0 && kD % kColT == 0, "head dim");
  static_assert(kVVec * kVE * kThreads == kPS * kD, "V vectors per thread");
  static_assert(kVB == 4 || kVB == 8 || kVB == 16,
                "V vectors of 4, 8 or 16 bytes");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* m_w = dst.work;                                // [rows, n_splits]
  float* l_w = dst.work + dst.rows * n_splits;          // [rows, n_splits]
  float* acc_w = dst.work + 2 * dst.rows * n_splits;    // [.., n_splits, D]
  const size_t row0 = dst.row0;

  // this split's pages
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
    for (int v = 0; v < kQVec; ++v) {
      Raw<kQB> r;
      r.load(q_rows + qi * kD + c * kEPT + v * kQN);
      unpack(r, &qf[qi][v * kQN], q_rows);
    }

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
  Raw<kBytes> kr;
  Raw<kVB> vr[kVVec];
  float ks = 1.f, vs[kVVec];
  auto load_page = [&](int p) {
    const size_t slot0 = ((size_t)pt[p] * Hkv + h) * kPS;
    const size_t base = slot0 * kD;
    kr.load(k_pages + base + tid * kEPT);
#pragma unroll
    for (int v = 0; v < kVVec; ++v)
      vr[v].load(v_pages + base + (size_t)(tid + v * kThreads) * kVE);
    if (kScales) {
      ks = __bfloat162float(k_scale[slot0 + j]);
#pragma unroll
      for (int v = 0; v < kVVec; ++v)
        vs[v] = __bfloat162float(
            v_scale[slot0 + (tid + v * kThreads) * kVE / kD]);
    }
  };
  if (p_begin < p_end) load_page(p_begin);

  for (int p = p_begin, buf = 0; p < p_end; ++p, buf ^= 1) {
    const int n = min(kPS, len - p * kPS);  // valid slots of this page
    // V into shared memory; slots past the length as 0, so that p.v can
    // run over the whole page (p is 0 there, and 0 * garbage may not be)
    float* vb = sm.v_s[buf];
#pragma unroll
    for (int v = 0; v < kVVec; ++v) {
      const int e = (tid + v * kThreads) * kVE;  // element in the page
      float f[kVE];
      unpack(vr[v], f, v_pages);
      const bool valid = e / kD < n;
      const float sc = kScales ? vs[v] : 1.f;
#pragma unroll
      for (int t = 0; t < kVE; t += 4)
        *reinterpret_cast<float4*>(vb + e + t) =
            valid ? make_float4(f[t] * sc, f[t + 1] * sc, f[t + 2] * sc,
                                f[t + 3] * sc)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // slot j's scores: partial dots over this thread's slice, summed over
    // the slot's kTPS lanes
    float kf[kEPT];
    unpack(kr, kf, k_pages);
    const float kscale = kScales ? ks * sm_scale : sm_scale;
#pragma unroll
    for (int qi = 0; qi < kQpk; ++qi) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kEPT; ++i) dot = fmaf(qf[qi][i], kf[i], dot);
#pragma unroll
      for (int off = kTPS / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      if (c == 0) sm.s_s[qi][j] = j < n ? dot * kscale : -INFINITY;
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
        const float s = lane < kPS ? sm.s_s[qi][lane] : -INFINITY;
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
        if (lane < kPS) sm.p_s[qi][lane] = round_to(pe, v_pages);
        if (lane == 0) sm.c_s[qi] = corr;
        l_r[r] = l_r[r] * corr + sum;
        m_r[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p.v for column tid (+ kColT ...) of each head
    if (tid < kColT) {
#pragma unroll
      for (int qi = 0; qi < kQpk; ++qi) {
        const float corr = sm.c_s[qi];
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
            vv[t][col] = vb[(j0 + t) * kD + col * kColT + tid];
#pragma unroll
        for (int qi = 0; qi < kQpk; ++qi) {
          const float4 pp =
              *reinterpret_cast<const float4*>(&sm.p_s[qi][j0]);
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
  }

  // each warp's heads' m and l, for every thread
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = warp + r * kWarps;
    if (qi < kQpk && lane == 0) {
      sm.m_s[qi] = m_r[r];
      sm.l_s[qi] = l_r[r];
    }
  }
  __syncthreads();
  if (n_splits == 1) {
    if (tid < kColT) {
#pragma unroll
      for (int qi = 0; qi < kQpk; ++qi) {
        const float l = fmaxf(sm.l_s[qi], 1e-30f);
#pragma unroll
        for (int col = 0; col < kCols; ++col)
          store_f(dst.out + qi * kD + col * kColT + tid, acc[qi][col] / l);
      }
    }
    return;
  }
  if (tid < kColT) {
#pragma unroll
    for (int qi = 0; qi < kQpk; ++qi)
#pragma unroll
      for (int col = 0; col < kCols; ++col)
        acc_w[((row0 + qi) * n_splits + split) * kD + col * kColT + tid] =
            acc[qi][col];
  }
  if (tid < kQpk) {
    m_w[(row0 + tid) * n_splits + split] = sm.m_s[tid];
    l_w[(row0 + tid) * n_splits + split] = sm.l_s[tid];
  }
}

// Row r of a work buffer of `rows` rows: its splits' partials merged in
// split order, empty splits skipped, into out_row [D] (one block of
// kThreads threads).
template <typename T, int kD>
__device__ __forceinline__ void merge_splits(const float* __restrict__ work,
                                             size_t rows, size_t r,
                                             int n_splits,
                                             T* __restrict__ out_row) {
  constexpr int kColT = kD < kThreads ? kD : kThreads;  // as split_walk
  constexpr int kCols = kD / kColT;
  const int tid = threadIdx.x;
  if (tid >= kColT) return;
  const float* m_w = work + r * n_splits;
  const float* l_w = work + rows * n_splits + r * n_splits;
  const float* acc_w = work + 2 * rows * n_splits + r * n_splits * kD;
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
      num[col] += w * acc_w[(size_t)s * kD + col * kColT + tid];
  }
#pragma unroll
  for (int col = 0; col < kCols; ++col)
    store_f(out_row + col * kColT + tid, num[col] / fmaxf(den, 1e-30f));
}

}  // namespace paged
