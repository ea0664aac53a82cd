// The decode op's bf16 walk for Hopper (sm_90a): a ring of pages in shared
// memory filled by TMA copies, products on the tensor cores (mma.sync),
// and a merge of the splits that reads them in parallel. Included by
// paged_attention.cu; the fp32 pools (the oracle) keep the walk of
// paged_split.cuh, which the ragged kernel's decode rows share.
//
// Function, per split of one sequence and kv head, as the TPU's
// _decode_kernel computes it page by page: s = (q . k in fp32) * sm_scale,
// slots at or past the length -inf; m_new = max(m, max s); p = 0 where s
// is -inf, else e^(s - m_new); the rescale e^(m - m_new), 0 while m is
// -inf; l sums the unrounded p; p is rounded to bf16 (V's dtype) before an
// fp32 p . v. One update covers a stage of kSlots slots (several pages of
// 8 or 16 slots, one of 32) instead of one page: the same function, with p
// rounded against the running maximum of the stage instead of the page's,
// which moves a term by less than a bf16 step. The split's output is
// acc / max(l, 1e-30), so a length-0 sequence gives exactly 0.
//
// What bounds it: bytes (each visible K/V slot read once at 3.35 TB/s);
// the products are 4 * len * Hq * D FLOP, far below the tensor cores'
// rate. So the design keeps bytes in flight and spends little on the way:
//   - one block of three warps per (sequence, kv head, split): warp 2 is
//     the producer, lane i of which issues, for page i of a stage, a TMA
//     copy of its K rows and one of its V rows per 64 columns of the head
//     dim (a [ps][64] bf16 box of the pool seen as [P * Hkv][ps][D]) into
//     a kStages-slot ring in dynamic shared memory, in bf16 as stored,
//     completing on the stage's full mbarrier; the page ids of a stage are
//     read by the producer's lanes while it waits for a free slot. No page
//     id at or past ceil(len / ps) is read. The boxes land with the
//     128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), so
//     the 8 rows an ldmatrix reads, and the K loads of a quarter warp,
//     fall on 8 different 16-byte bank groups: stored as in the pool, 128
//     or 256 bytes a row, they all fell on the same 4 banks
//     (chip_compare.py ring, "unswizzled"). Warps 0 and 1 consume the
//     stages in turn, each with its own
//     online-softmax state, so that one's products run while the other
//     waits for its next stage; each waits on its
//     stage's full barrier and arrives on its empty barrier when done, and
//     at the end warp 1 hands its state to warp 0 through shared memory,
//     which merges the two in that order;
//   - s = q . k^T by mma.sync m16n8k16 (bf16, fp32 accumulate): the A tile
//     is the kv head's kQpk query rows, padded to 16 with zeros, held in
//     registers for the block's life; B is the stage's K, read with one
//     16-byte load per lane and pair of k steps. The head dim is permuted
//     alike in q's and k's fragments (lane t of a quad takes d 64i + 16t
//     + 8c .. +7 for k steps 4i + 2c and 4i + 2c + 1), which leaves the
//     dot products as they are, needs no transposing load, and puts the
//     loads of a quarter warp (rows g, g + 1) on distinct bank groups;
//   - the online softmax runs on the accumulator fragments (a row's 32
//     scores sit in the four lanes of a quad: two shuffles for its max);
//     p, rounded to bf16 in registers, is the A operand of o += p . v, whose
//     B fragments ldmatrix.trans reads from V as stored;
//   - a split that starts past its sequence's end writes an empty partial
//     (m = -inf, l = 0); V rows of the last stage past the split's last
//     visible slot are zeroed before p . v, so that no NaN in a page's
//     unused slots (or in shared memory never written) reaches the sum.
// merge_parallel: one block of four warps per (sequence, query head) row;
// warp w takes the w-th quarter of the splits (lanes across the head dim),
// and the four partials are combined in warp order, so the output repeats
// bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace ring {

using sm90::bar_arrive;
using sm90::bar_expect_tx;
using sm90::bar_init;
using sm90::bar_init_fence;
using sm90::bar_wait;
using sm90::fence_async_smem;
using sm90::pack_bf16;
using sm90::Ring;
using sm90::smem_addr;
using sm90::tma_load;

constexpr int kSlots = 32;       // slots of one stage (several pages, or one)
constexpr int kStages = 2;       // ring slots, one per consumer
constexpr int kConsumers = 2;    // consumer warps, taking stages in turn
constexpr int kThreads = 32 * (kConsumers + 1);  // and the producer warp
constexpr int kMergeThreads = 128;
constexpr int kMaxQpk = 8;
constexpr uint32_t kHalf = kSlots * 128;  // a stage's rows of 64 columns

// A stage's K (then V): per 64 columns of the head dim (a "half" at head
// dim 128), its kSlots rows of 128 bytes, swizzled; from a 1024-byte
// aligned base, so that each page's box starts a swizzle atom.
template <int kD>
struct Layout {
  static constexpr uint32_t kRows = kD / 64 * kHalf;  // K (or V) of a stage
  static constexpr uint32_t kStage = 2 * kRows;
  // the second consumer's (m, l, acc) of its kQpk rows, for the first
  static constexpr uint32_t kCombine = kStages * kStage;
  static constexpr uint32_t kBars = kCombine + 4 * kMaxQpk * (kD + 2);
  static constexpr size_t kSmem = kBars + 16 * kStages + 1024;  // + align
  static_assert(kHalf % 1024 == 0 && kBars % 16 == 0, "alignment");
};

// A 3-D map over a bf16 pool [P, Hkv, ps, D] seen as [P * Hkv][ps][D],
// boxes of one (page, kv head)'s ps rows by 64 columns, with the 128-byte
// swizzle that chunk_at undoes.
inline cudaError_t make_page_map(CUtensorMap* map, const void* pool, int P,
                                 int Hkv, int ps, int D) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(ps),
                              static_cast<cuuint64_t>(P) * Hkv};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(ps) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(ps), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(pool),
      dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// byte offset, from K's (or V's) base of a stage, of the 16-byte chunk c
// (columns 8c .. 8c + 7) of slot row r
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  return (c >> 3) * kHalf + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// d (16 x 8, fp32) += a (16 x 16 bf16, rows 8..15 zero) . b (16 x 8)
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed: lane i gives row i % 8 of matrix
// i / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One split of one sequence for one kv head (the block's work). pt: the
// sequence's page table; len: its visible slots (at most max_pages * ps);
// out: its kQpk output rows (one split); work: m [rows, n_splits], l
// [rows, n_splits], acc [rows, n_splits, D] (several splits), with this
// group's rows from row0.
template <int kPS, int kQpk, int kD>
__device__ __forceinline__ void split_walk(
    const __nv_bfloat16* __restrict__ q_rows, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const int32_t* __restrict__ pt, int len,
    int Hkv, int h, int split,
    int n_splits, int pages_per_split, float sm_scale,
    __nv_bfloat16* __restrict__ out, float* __restrict__ work, size_t rows,
    size_t row0) {
  using L = Layout<kD>;
  constexpr int kStagePages = kSlots / kPS;
  constexpr uint32_t kBox = kPS * 128;  // a page's rows of 64 columns
  constexpr int kPairs = kD / 32;  // pairs of k steps over the head dim
  constexpr int kNt = kD / 8;      // n tiles of p . v
  static_assert(kSlots % kPS == 0 && kStagePages <= 32, "page size");
  static_assert(kQpk <= kMaxQpk && kD % 64 == 0, "geometry");
  // each ring slot always goes to the same consumer, which waits for its
  // phases in order: an mbarrier's parity tells apart only consecutive
  // phases, and a consumer two phases ahead of a slot would pass its wait
  static_assert((kConsumers == 1 || kConsumers == 2) &&
                    kStages % kConsumers == 0,
                "consumer warps");

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_pages = (len + kPS - 1) / kPS;
  const int p_begin = split * pages_per_split;
  const int p_end = min(p_begin + pages_per_split, n_pages);
  float* m_w = work;
  float* l_w = work + rows * n_splits;
  float* acc_w = work + 2 * rows * n_splits;
  if (p_begin >= p_end) {  // past the sequence (or a length-0 sequence)
    if (warp != 0) return;
    if (n_splits > 1) {
      if (lane < kQpk) {
        m_w[(row0 + lane) * n_splits + split] = -INFINITY;
        l_w[(row0 + lane) * n_splits + split] = 0.f;
      }
    } else {
      for (int e = lane; e < kQpk * kD / 2; e += 32)
        reinterpret_cast<uint32_t*>(out)[e] = 0u;
    }
    return;
  }
  const int n_stages = (p_end - p_begin + kStagePages - 1) / kStagePages;
  // the split's last visible slot, plus one
  const int end = min(len, p_end * kPS);

  extern __shared__ __align__(128) unsigned char raw[];
  const uint32_t raw_addr = smem_addr(raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  unsigned char* smem = raw + (base - raw_addr);
  auto full = [&](int s) { return base + L::kBars + 8 * s; };
  auto empty = [&](int s) { return base + L::kBars + 8 * (kStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 32);  // every consumer lane
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers) {  // producer
    for (int st = 0; st < n_stages; ++st) {
      const Ring<kStages> r(st);
      const int p0 = p_begin + st * kStagePages;
      const int np = min(kStagePages, p_end - p0);
      const int id = lane < np ? pt[p0 + lane] : 0;
      if (lane == 0) {
        bar_wait(empty(r.slot), r.parity ^ 1);
        bar_expect_tx(full(r.slot), 2 * np * kPS * kD * 2);
      }
      __syncwarp();
      if (lane < np) {
        const uint32_t dst = base + r.slot * L::kStage + lane * kBox;
#pragma unroll
        for (int c = 0; c < kD / 64; ++c) {
          tma_load(dst + c * kHalf, tm_k, full(r.slot), 64 * c, 0,
                   id * Hkv + h);
          tma_load(dst + L::kRows + c * kHalf, tm_v, full(r.slot), 64 * c,
                   0, id * Hkv + h);
        }
      }
    }
    return;
  }

  // the 16-byte chunk of the head dim (8 columns from 8 * chunk) that
  // this lane holds for pair j of k steps
  auto pair_chunk = [&](int j) { return 8 * (j >> 1) + 2 * t + (j & 1); };
  // consumer: this lane's share of the query rows as A fragments (row g,
  // zeros past kQpk; the head dim permuted as the K fragments are)
  uint4 qa[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j)
    qa[j] = g < kQpk ? *reinterpret_cast<const uint4*>(q_rows + g * kD +
                                                       8 * pair_chunk(j))
                     : make_uint4(0u, 0u, 0u, 0u);
  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m = -INFINITY, l = 0.f;  // row g's running max; this lane's sum

  for (int st = warp; st < n_stages; st += kConsumers) {
    const Ring<kStages> r(st);
    const uint32_t ks = base + r.slot * L::kStage;
    const uint32_t vs = ks + L::kRows;
    const unsigned char* k_smem = smem + r.slot * L::kStage;
    const int slot0 = (p_begin + st * kStagePages) * kPS;
    const int valid = min(end - slot0, kSlots);  // >= 1
    bar_wait(full(r.slot), r.parity);
    if (valid < kSlots) {  // the last stage: V rows past `end` to zero
      for (int e = valid * kD / 8 + lane; e < kSlots * kD / 8; e += 32)
        *reinterpret_cast<uint4*>(smem + r.slot * L::kStage + L::kRows +
                                  chunk_at(e / (kD / 8), e % (kD / 8))) =
            make_uint4(0u, 0u, 0u, 0u);
      fence_async_smem();  // before the async proxy rewrites the slot
      __syncwarp();
    }

    // s = q . k^T: 4 n tiles of 8 slots
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const uint4 kb = *reinterpret_cast<const uint4*>(
            k_smem + chunk_at(8 * n + g, pair_chunk(j)));
        mma16816(s[n], qa[j].x, qa[j].y, kb.x, kb.y);
        mma16816(s[n], qa[j].z, qa[j].w, kb.z, kb.w);
      }
    }
    // the stage's online-softmax update (row g: s[n][0..1], slots
    // 8n + 2t, +1)
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x =
            8 * n + 2 * t + e < valid ? s[n][e] * sm_scale : -INFINITY;
        s[n][e] = x;
        mx = fmaxf(mx, x);
      }
    mx = quad_max(mx);
    const float m_new = fmaxf(m, mx);
    const float corr = m == -INFINITY ? 0.f : expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = s[n][e] == -INFINITY ? 0.f : expf(s[n][e] - m_new);
        s[n][e] = p;
        sum += p;  // the unrounded p
      }
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }
    // o += bf16(p) . v: 2 k steps of 16 slots, n tiles of 8 columns
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const int mi = lane >> 3;
      const int row = 16 * kk + 8 * (mi & 1) + (lane & 7);
#pragma unroll
      for (int n = 0; n < kNt; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + chunk_at(row, n + (mi >> 1)));
        mma16816(acc[n], a0, a2, b[0], b[1]);
        mma16816(acc[n + 1], a0, a2, b[2], b[3]);
      }
    }
    __syncwarp();
    bar_arrive(empty(r.slot));
  }

  // the two consumers' states combined in warp order: warp 1 hands its
  // rows' (m, l, acc) to warp 0 through shared memory
  l = quad_sum(l);
  if constexpr (kConsumers == 2) {
    float* cm = reinterpret_cast<float*>(smem + L::kCombine);
    float* cl = cm + kMaxQpk;
    float* cacc = cl + kMaxQpk;
    if (warp == 1 && g < kQpk) {
#pragma unroll
      for (int n = 0; n < kNt; ++n)
        *reinterpret_cast<float2*>(cacc + g * kD + 8 * n + 2 * t) =
            make_float2(acc[n][0], acc[n][1]);
      if (t == 0) {
        cm[g] = m;
        cl[g] = l;
      }
    }
    sm90::named_sync(1, 32 * kConsumers);
    if (warp != 0) return;
    if (g < kQpk) {
      const float m1 = cm[g], M = fmaxf(m, m1);
      const float w0 = m == -INFINITY ? 0.f : expf(m - M);
      const float w1 = m1 == -INFINITY ? 0.f : expf(m1 - M);
      l = w0 * l + w1 * cl[g];
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        const float2 o = *reinterpret_cast<const float2*>(
            cacc + g * kD + 8 * n + 2 * t);
        acc[n][0] = w0 * acc[n][0] + w1 * o.x;
        acc[n][1] = w0 * acc[n][1] + w1 * o.y;
      }
      m = M;
    }
  }
  if (g >= kQpk) return;
  if (n_splits == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int n = 0; n < kNt; ++n)
      reinterpret_cast<uint32_t*>(out + g * kD + 8 * n + 2 * t)[0] =
          pack_bf16(acc[n][0] * inv, acc[n][1] * inv);
    return;
  }
  const size_t at = (row0 + g) * n_splits + split;
#pragma unroll
  for (int n = 0; n < kNt; ++n)
    *reinterpret_cast<float2*>(acc_w + at * kD + 8 * n + 2 * t) =
        make_float2(acc[n][0], acc[n][1]);
  if (t == 0) {
    m_w[at] = m;
    l_w[at] = l;
  }
}

// Row r of a work buffer of `rows` rows (m, l, acc as split_walk writes
// them): the splits merged into out_row [D], by a block of kMergeThreads.
// Warp w takes splits [w c, w c + c), c = ceil(n_splits / 4), each lane
// D / 32 columns; the warps' partials (max, weighted sums) are combined in
// warp order. Empty splits (m = -inf) are skipped.
template <int kD>
__device__ __forceinline__ void merge_parallel(const float* __restrict__ work,
                                               size_t rows, size_t r,
                                               int n_splits,
                                               __nv_bfloat16* __restrict__ out_row) {
  constexpr int kWarps = kMergeThreads / 32;
  constexpr int kV = kD / 32;  // columns per lane
  __shared__ float part_m[kWarps], part_l[kWarps];
  __shared__ __align__(16) float part_acc[kWarps][kD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* m_w = work + r * n_splits;
  const float* l_w = work + rows * n_splits + r * n_splits;
  const float* acc_w = work + 2 * rows * n_splits + r * n_splits * kD;
  const int chunk = (n_splits + kWarps - 1) / kWarps;
  const int s0 = min(warp * chunk, n_splits);
  const int s1 = min(s0 + chunk, n_splits);
  float M = -INFINITY;
  for (int s = s0; s < s1; ++s) M = fmaxf(M, m_w[s]);
  float num[kV], den = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) num[i] = 0.f;
  for (int s = s0; s < s1; ++s) {
    const float m = m_w[s];
    if (m == -INFINITY) continue;
    const float w = expf(m - M);
    den += w * l_w[s];
    const float* a = acc_w + (size_t)s * kD + lane * kV;
#pragma unroll
    for (int i = 0; i < kV; ++i) num[i] += w * a[i];
  }
#pragma unroll
  for (int i = 0; i < kV; ++i) part_acc[warp][lane * kV + i] = num[i];
  if (lane == 0) {
    part_m[warp] = M;
    part_l[warp] = den;
  }
  __syncthreads();
  if (threadIdx.x >= kD) return;
  float Mall = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) Mall = fmaxf(Mall, part_m[w]);
  float total = 0.f, dall = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (part_m[w] == -INFINITY) continue;
    const float x = expf(part_m[w] - Mall);
    total += x * part_acc[w][threadIdx.x];
    dall += x * part_l[w];
  }
  out_row[threadIdx.x] = __float2bfloat16_rn(total / fmaxf(dall, 1e-30f));
}

}  // namespace ring
