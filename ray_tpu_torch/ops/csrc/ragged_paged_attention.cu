// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/paged_attention.py::_ragged_kernel
// (launched by _ragged_attention_pallas). Same function: a ragged token
// batch q [T, Hq, D] of R rows over a paged KV pool [P, Hkv, ps, D]; token
// t = q_start[r] + j of row r sees the first vis = kv_len[r] - q_len[r] +
// j + 1 slots of its row's pages (at most the table's max_pages * ps; a
// token no row owns: output 0). GQA: the Hq / Hkv query heads of one kv
// head share its K/V. Online softmax across the kv positions in fp32;
// int8 pools carry a bf16 scale per (page, head, slot). Exactly as the TPU
// kernel: a masked score is -inf and contributes p = 0; the rescale of the
// running sum is 0 while the running max is still -inf (no NaN); the
// final sum is floored at 1e-30, so a token that sees nothing comes back
// exactly 0.
//
// What bounds it on the card: bytes. The least traffic is each row's
// visible K/V (and int8 scales) read once, plus q and o, over the H100's
// 3.35 TB/s; the products (4 * vis * Hq * D FLOP per token) take less at
// the bf16 tensor-core peak even for a prefill chunk of 512 tokens.
//
// bf16 q (pools bf16 or int8), the engine's path: two launches. The first
// runs two kinds of block, 128 threads each, side by side in one grid,
// planned on the host from the engine's static hints (decode_rows,
// max_q_len) and the table's shape, never from the lengths, so the host
// reads nothing back:
//   - prefill tiles: rows r >= decode_rows, one block per (row, q block,
//     kv head). The block's 64 tile rows are BM = 64 / (Hq / Hkv) tokens x
//     the kv head's query heads, token-major (Llama 3: 16 tokens x 4
//     heads), so one K/V tile serves them all and the row's prefix is read
//     once per q block, where the first port read it once per token. A
//     block takes q blocks b, b + nb, ... (nb = ceil(min(max_q_len, T) /
//     BM)) until its row's q_len is covered, so wrong hints cost time, not
//     results; the last q blocks, which see the most keys, start first.
//     64-slot K/V tiles come page by page from the row's table into a
//     two-stage shared-memory ring by cp.async (16-byte vectors, the next
//     tile in flight during this one's products; slots past the q block's
//     last visible slot are zero-filled, never read, and tiles past it are
//     skipped). s = q.k^T is wgmma m64n64k16 (both operands in shared
//     memory, 128-byte swizzle), the online softmax runs in registers on
//     the fp32 accumulator (2^x by ex2.approx; a token's mask at vis only
//     on the tiles that reach past the block's first token), and p,
//     rounded to bf16 in registers, is the A operand of o += p.v (wgmma
//     m64n128k16, m64n64k16 at head dim 64; V read MN-major). o leaves
//     through shared memory, row by row up to the row's q_len: tokens past
//     it belong to the next row.
//   - decode rows: rows r < decode_rows (q_len <= 1 by contract), one
//     block per (row, kv head, split of pages_per_split pages): the decode
//     op's split walk (paged_split.cuh), so a short decode batch spreads
//     over the SMs where one block per (token, kv head) left most idle.
// The second launch merges the decode splits in split order (no atomics:
// the output is repeatable) and writes 0 to every token no block wrote:
// one warp per token tests the [R] descriptors.
//
// int8 pools on the tensor cores without a dequantized copy in device
// memory: the int8 K and V tiles come into the ring as they are and are
// widened to bf16 in shared memory (exact: |v| <= 127 needs 7 bits), the
// score column of slot c is scaled by k_scale[c] in fp32 after q.k^T
// (the plain version scales k before the product: the same fp32 products,
// another rounding order), and v_scale[c] is folded into p before p is
// rounded to bf16 for p.v. The plain version dequantizes in fp32 and does
// not round p; rounding p * v_scale moves each term of p.v by at most half
// a bf16 step (2^-9 of it), as rounding p does for bf16 pools, and the
// decode rows keep p in fp32 against V dequantized in fp32.
//
// fp32 q (the engine's fp32 oracle, pools fp32 or int8) keeps the first
// port's design: one block per (token, kv head) that finds its token's row
// from the [R] descriptors and walks the visible positions in 32-slot
// tiles on CUDA cores in fp32, K/V dequantized on load into shared memory,
// the next tile's 16-byte loads in flight during this tile's math.
//
// Built for head dim 64 or 128 (the bf16 prefill tiles templated on it: at
// 64 a bf16 row is one 128-byte swizzled box, q.k^T takes 4 k steps and
// p.v is wgmma m64n64k16); the bf16 path for pages of 8, 16 or 32 slots
// and 1, 2, 4 or 8 query heads per kv head (Llama 3: 128, 16, 4; the JAX
// package's serving benchmark: 64, 32, 2). Plain C interface
// (loaded with ctypes): ragged_paged_attention() launches on the given
// stream and returns the cudaError_t of the launches.

#include <algorithm>
#include <type_traits>

#include "flash_sm90.cuh"
#include "paged_split.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Args {
  const void *q, *k_pages, *v_pages, *k_scale, *v_scale;
  const int32_t *page_table, *q_start, *q_len, *kv_len;
  void* out;
  float* work;  // the decode splits' partials
  int T, R, Hq, Hkv, ps, D, max_pages;
  int decode_rows, q_blocks, pages_per_split;
  int n_splits, prefill_blocks, decode_blocks;  // derived by the entry point
  float sm_scale;
};

// ------------------------------------------------ fp32 q: the first design

namespace f32 {

constexpr int kTile = 32;      // kv positions per tile: one per lane
constexpr int kThreads = 128;  // four warps per block

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

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

template <typename KT, bool kHasScales, int kD>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const float* __restrict__ q,                // [T, Hq, D]
    const KT* __restrict__ k_pages,             // [P, Hkv, ps, D]
    const KT* __restrict__ v_pages,             // [P, Hkv, ps, D]
    const __nv_bfloat16* __restrict__ k_scale,  // [P, Hkv, ps] or null
    const __nv_bfloat16* __restrict__ v_scale,  // [P, Hkv, ps] or null
    const int32_t* __restrict__ page_table,     // [R, max_pages]
    const int32_t* __restrict__ q_start,        // [R]
    const int32_t* __restrict__ q_len,          // [R]
    const int32_t* __restrict__ kv_len,         // [R]
    float* __restrict__ out,                    // [T, Hq, D]
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
      vis_s = min(vis, max_pages * ps);
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

template <typename KT, bool kHasScales, int D>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  const int qpk = a.Hq / a.Hkv;
  const size_t smem = sizeof(float) * (2 * qpk * D + kTile * (D + 1) +
                                       kTile * D + qpk * kTile + 3 * qpk);
  auto kernel = ragged_paged_attention_kernel<KT, kHasScales, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(a.T, a.Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const KT*>(a.k_pages),
      static_cast<const KT*>(a.v_pages),
      static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale), a.page_table, a.q_start,
      a.q_len, a.kv_len, static_cast<float*>(a.out), a.R, a.Hq, a.Hkv, a.ps,
      a.max_pages, a.sm_scale);
  return cudaGetLastError();
}

template <typename KT, bool kHasScales>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.D == 64) return launch_d<KT, kHasScales, 64>(a, stream);
  return launch_d<KT, kHasScales, 128>(a, stream);
}

}  // namespace f32

// -------------------------------- bf16 q: prefill tiles and decode splits

namespace bf16 {

using namespace sm90;
using paged::kThreads;  // 128: one warpgroup
using paged::kWarps;
using BF = __nv_bfloat16;

constexpr int kRows = 64;                 // prefill tile rows: tokens x heads
constexpr int kKeys = 64;                 // slots of a key tile
constexpr uint32_t kBox = 64 * 128;       // [64 rows][64 bf16], swizzled: 8 KB
constexpr uint32_t kScaleB = kKeys * 2;   // a tile's 64 bf16 scales

// Shared memory of a prefill block at head dim kD, from a 1024-byte
// aligned base: the q tile (its rows also carry o out), then a two-stage
// ring. A [64, kD] bf16 tile is kD / 64 swizzled boxes of 64 columns. bf16
// pools: a stage holds the K and V tiles the products read. int8 pools: a
// stage holds the int8 K and V tiles (row = slot, unswizzled) and their
// scales, widened at their turn into one pair of bf16 tiles.
template <typename KT, int kD>
struct Layout {
  static constexpr bool kI8 = std::is_same<KT, int8_t>::value;
  static constexpr uint32_t kTileB = (kD / 64) * kBox;  // a [64, kD] tile
  static constexpr uint32_t kRawB = kKeys * kD;        // its int8 form
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kTileB, kV = 2 * kTileB;  // int8: bf16 K, V
  static constexpr uint32_t kRing = kI8 ? 3 * kTileB : kTileB;
  static constexpr uint32_t kStage =
      kI8 ? 2 * kRawB + 2 * kScaleB : 2 * kTileB;
  // D 128: 80 or 80.25 KB; D 64: 40 or 40.25 KB
  static constexpr uint32_t kBytes = kRing + 2 * kStage;
  static_assert(kD == 64 || kD == 128, "head dim");
};

// The prefill tile's online-softmax step on this thread's 32 scores (two
// rows of the m64n64 accumulator, q.k^T unscaled): s becomes p = 2^(s' -
// m), s' = s * sm_scale * log2(e) (times the column's k scale for int8
// pools; -inf at or past the row's visible length, tested only on an edge
// tile); m is the running max (log2 units), l this thread's share of the
// sum of the unrounded p; returns the rescale of the o accumulator in
// corr.
template <bool kI8>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool edge, int k0, const int (&vis)[2], int t, float scale_log2,
    const BF* ks) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = acc_col(i, t);
    float x = s[i] * scale_log2;
    if constexpr (kI8) x *= __bfloat162float(ks[col]);
    if (edge && k0 + col >= vis[acc_half(i)]) x = -INFINITY;
    s[i] = x;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[acc_half(i)] = fmaxf(mx[acc_half(i)], s[i]);
  float base_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    // a row that has seen only masked slots keeps m = -inf: p = 0 and
    // corr = 0 follow from ex2(-inf) without a NaN
    base_m[h] = mx[h] == -INFINITY ? 0.f : mx[h];
    corr[h] = ex2(m[h] - base_m[h]);
    m[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(s[i] - base_m[acc_half(i)]);
    l[acc_half(i)] += p;  // the unrounded p
    s[i] = p;
  }
}

// One prefill block: (row, first q block, kv head) from its index, the
// last q blocks first (the host's ragged_prefill_block mirrors this).
template <typename KT, int kPS, int kQpk, int kD>
__device__ __forceinline__ void prefill_block(const Args& a, int blk,
                                              unsigned char* smem,
                                              uint32_t base) {
  using L = Layout<KT, kD>;
  constexpr bool kI8 = L::kI8;
  constexpr int kBM = kRows / kQpk;  // tokens of a q block
  constexpr int kVecB = kD / 8;      // 16-byte vectors of a bf16 row
  constexpr int kVecI = kD / 16;     // of an int8 row
  static_assert(kKeys % kPS == 0 && kPS % 8 == 0, "page size");
  const int Hkv = a.Hkv, Hq = a.Hq;
  const int Rp = a.R - a.decode_rows;
  const int h = blk % Hkv;
  const int rest = blk / Hkv;
  const int row = a.decode_rows + rest % Rp;
  const int b_first = a.q_blocks - 1 - rest / Rp;
  const int qs = a.q_start[row], ql = a.q_len[row], kl = a.kv_len[row];
  const int32_t* pt = a.page_table + (size_t)row * a.max_pages;
  const int max_kv = a.max_pages * kPS;
  const BF* q = static_cast<const BF*>(a.q);
  const KT* kp = static_cast<const KT*>(a.k_pages);
  const KT* vp = static_cast<const KT*>(a.v_pages);
  BF* out = static_cast<BF*>(a.out);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = a.sm_scale * kLog2e;

  for (int b = b_first; b * kBM < ql; b += a.q_blocks) {
    const int j0 = b * kBM;             // the q block's first token in the row
    const int n_tok = min(kBM, ql - j0);
    const int vis0 = kl - ql + j0 + 1;  // visible slots of token j0
    const int vis_lo = min(max(vis0, 0), max_kv);
    const int vis_hi = min(max(vis0 + n_tok - 1, 0), max_kv);
    const int n_kt = (vis_hi + kKeys - 1) / kKeys;  // tiles past: skipped
    // this thread's two tile rows (16 warp + g, + 8): their tokens' visible
    // slots (rows past the chunk: the block's largest, and never stored)
    int vis[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tok = (16 * warp + g + 8 * hh) / kQpk;
      vis[hh] = tok < n_tok ? min(max(vis0 + tok, 0), max_kv) : vis_hi;
    }

    // the K/V tile kt into ring stage st: 16-byte vectors, slot by slot
    // from the row's pages; slots at or past vis_hi zero-filled, not read
    auto load_tile = [&](int kt, int st) {
      const uint32_t dst = base + L::kRing + st * L::kStage;
      const int s0 = kt * kKeys;
      if constexpr (!kI8) {
#pragma unroll
        for (int i = 0; i < kKeys * kVecB / kThreads; ++i) {
          const int e = tid + i * kThreads;
          const int slot = e / kVecB, chunk = e % kVecB;
          const int pos = s0 + slot;
          const bool ok = pos < vis_hi;
          const size_t off =
              ok ? (((size_t)pt[pos / kPS] * Hkv + h) * kPS + pos % kPS) * kD +
                       chunk * 8
                 : 0;
          const uint32_t o =
              (chunk >> 3) * kBox + swizzled(slot, (chunk & 7) * 8);
          cp_async16(dst + o, kp + off, ok);
          cp_async16(dst + L::kTileB + o, vp + off, ok);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kKeys * kVecI / kThreads; ++i) {
          const int e = tid + i * kThreads;
          const int slot = e / kVecI, chunk = e % kVecI;
          const int pos = s0 + slot;
          const bool ok = pos < vis_hi;
          const size_t off =
              ok ? (((size_t)pt[pos / kPS] * Hkv + h) * kPS + pos % kPS) * kD +
                       chunk * 16
                 : 0;
          cp_async16(dst + slot * kD + chunk * 16, kp + off, ok);
          cp_async16(dst + L::kRawB + slot * kD + chunk * 16, vp + off, ok);
        }
        if (tid < 16) {  // the scales: 8 slots (of one page) a vector
          const int which = tid >> 3, pos = s0 + 8 * (tid & 7);
          const bool ok = pos < vis_hi;
          const size_t off =
              ok ? ((size_t)pt[pos / kPS] * Hkv + h) * kPS + pos % kPS : 0;
          const BF* src =
              static_cast<const BF*>(which ? a.v_scale : a.k_scale) + off;
          cp_async16(dst + 2 * L::kRawB + which * kScaleB + (tid & 7) * 16,
                     src, ok);
        }
      }
    };

    float acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
    float l[2] = {0.f, 0.f};              // this thread's share of the sum
    if (n_kt > 0) {
      // the q tile: row r is token j0 + r / kQpk, head h * kQpk + r % kQpk
#pragma unroll
      for (int i = 0; i < kRows * kVecB / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kVecB, chunk = e % kVecB;
        const int tok = r / kQpk, tq = qs + j0 + tok;
        const bool ok = tok < n_tok && tq < a.T;
        const BF* src =
            ok ? q + ((size_t)tq * Hq + h * kQpk + r % kQpk) * kD + chunk * 8
               : q;
        cp_async16(base + L::kQ + (chunk >> 3) * kBox +
                       swizzled(r, (chunk & 7) * 8),
                   src, ok);
      }
      load_tile(0, 0);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < n_kt) {  // the next tile flies during this one
        load_tile(kt + 1, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      const unsigned char* stage = smem + L::kRing + st * L::kStage;
      uint32_t k_addr = base + L::kRing + st * L::kStage;
      uint32_t v_addr = k_addr + L::kTileB;
      if constexpr (kI8) {  // the int8 tiles, widened to bf16 (exact)
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kKeys * kVecI / kThreads; ++i) {
          const int e = tid + i * kThreads;
          const int slot = e / kVecI, chunk = e % kVecI;
#pragma unroll
          for (int kv = 0; kv < 2; ++kv) {
            const uint4 u = *reinterpret_cast<const uint4*>(
                stage + kv * L::kRawB + slot * kD + chunk * 16);
            const uint32_t w[4] = {u.x, u.y, u.z, u.w};
            uint32_t bw[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const uint32_t x = w[k >> 1] >> (16 * (k & 1));
              bw[k] = pack_bf16(static_cast<float>(static_cast<int8_t>(x)),
                                static_cast<float>(
                                    static_cast<int8_t>(x >> 8)));
            }
            // d 16 chunk .. + 15: bf16 chunks 2 chunk, 2 chunk + 1
            unsigned char* tile = smem + (kv ? L::kV : L::kK) +
                                  (chunk >> 2) * kBox;
            const int c8 = (2 * chunk) & 7;
            *reinterpret_cast<uint4*>(tile + swizzled(slot, c8 * 8)) =
                make_uint4(bw[0], bw[1], bw[2], bw[3]);
            *reinterpret_cast<uint4*>(tile + swizzled(slot, c8 * 8 + 8)) =
                make_uint4(bw[4], bw[5], bw[6], bw[7]);
          }
        }
        k_addr = base + L::kK;
        v_addr = base + L::kV;
      }
      fence_async_smem();  // the copies and stores, seen by wgmma
      __syncthreads();

      // s = q.k^T (64 x 64, fp32), kD / 16 k steps
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        mma_ss_n64(s, desc_k(base + L::kQ, kBox, kk), desc_k(k_addr, kBox, kk),
                   kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      const BF* ks = reinterpret_cast<const BF*>(stage + 2 * L::kRawB);
      const BF* vs = ks + kKeys;
      float corr[2];
      const int k0 = kt * kKeys;
      const bool edge = k0 + kKeys > vis_lo;
      softmax_tile<kI8>(s, m, l, corr, edge, k0, vis, t, scale_log2, ks);
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) acc[i] *= corr[acc_half(i)];
      // p (int8: times the column's v scale, 0 where masked) in bf16: the
      // A operand of p.v, 16 slots a k step
      uint32_t pa[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float p0 = s[2 * i], p1 = s[2 * i + 1];
        if constexpr (kI8) {
          const int col = acc_col(2 * i, t);  // and col + 1
          p0 = p0 > 0.f ? p0 * __bfloat162float(vs[col]) : 0.f;
          p1 = p1 > 0.f ? p1 * __bfloat162float(vs[col + 1]) : 0.f;
        }
        pa[i] = pack_bf16(p0, p1);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (kD == 128)
          mma_rs_n128(acc, pa + 4 * kk, desc_mn(v_addr, kBox, kk));
        else
          mma_rs_n64<1>(acc, pa + 4 * kk, desc_mn(v_addr, kBox, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();  // the stage's tiles are free for tile kt + 2
    }

    // o = acc / max(l, 1e-30), bf16, through the q tile's rows, then row
    // by row up to the chunk's end: past it are the next row's tokens
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / fmaxf(quad_sum(l[hh]), 1e-30f);
    store_acc_bf16(smem + L::kQ, kBox, acc, inv, warp, g, t);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows * kVecB / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kVecB, chunk = e % kVecB;
      const int tok = r / kQpk, tq = qs + j0 + tok;
      if (tok < n_tok && tq < a.T)
        *reinterpret_cast<uint4*>(
            out + ((size_t)tq * Hq + h * kQpk + r % kQpk) * kD + chunk * 8) =
            *reinterpret_cast<const uint4*>(smem + L::kQ + (chunk >> 3) * kBox +
                                            swizzled(r, (chunk & 7) * 8));
    }
    __syncthreads();  // the q tile is free for the next q block
  }
}

// One decode block: (row, kv head, split) from its index, the split walk
// of paged_split.cuh on token q_start[row] (an inactive row: nothing).
template <typename KT, int kPS, int kQpk, int kD>
__device__ __forceinline__ void decode_block(const Args& a, int i,
                                             unsigned char* smem) {
  const int S = a.n_splits;
  const int split = i % S, h = (i / S) % a.Hkv, r = i / (S * a.Hkv);
  if (a.q_len[r] <= 0) return;  // the merge skips it too
  const int tok = a.q_start[r];
  if (tok < 0 || tok >= a.T) return;
  const int len = min(max(a.kv_len[r], 0), a.max_pages * kPS);
  const size_t row0 = (size_t)tok * a.Hq + (size_t)h * kQpk;  // q, o row
  auto& sm = *reinterpret_cast<paged::SplitSmem<kPS, kQpk, kD>*>(smem);
  const paged::SplitOut<BF> dst{
      static_cast<BF*>(a.out) + row0 * kD, a.work,
      (size_t)a.decode_rows * a.Hq, (size_t)r * a.Hq + (size_t)h * kQpk};
  paged::split_walk<BF, KT, std::is_same<KT, int8_t>::value, kPS, kQpk, kD>(
      sm, static_cast<const BF*>(a.q) + row0 * kD,
      static_cast<const KT*>(a.k_pages), static_cast<const KT*>(a.v_pages),
      static_cast<const BF*>(a.k_scale), static_cast<const BF*>(a.v_scale),
      a.page_table + (size_t)r * a.max_pages, len, a.Hkv, h, split, S,
      a.pages_per_split, a.sm_scale, dst);
}

// blocks [0, prefill_blocks) take prefill tiles, the rest decode splits
template <typename KT, int kPS, int kQpk, int kD>
__global__ void __launch_bounds__(kThreads) ragged_sm90_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  const uint32_t raw = smem_addr(dyn_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = dyn_smem + (base - raw);
  if ((int)blockIdx.x < a.prefill_blocks)
    prefill_block<KT, kPS, kQpk, kD>(a, blockIdx.x, smem, base);
  else
    decode_block<KT, kPS, kQpk, kD>(a, blockIdx.x - a.prefill_blocks, smem);
}

// The second launch: blocks [0, merge) merge the decode rows' splits (one
// per (row, query head)); then one warp per token writes 0 over every token
// that no block of the first launch wrote (a decode row writes q_start, a
// prefill row q_start .. q_start + q_len - 1).
template <int kD>
__global__ void __launch_bounds__(kThreads) ragged_finish_kernel(
    const Args a) {
  const int merge = a.n_splits > 1 ? a.decode_rows * a.Hq : 0;
  BF* out = static_cast<BF*>(a.out);
  if ((int)blockIdx.x < merge) {
    const int r = blockIdx.x / a.Hq, head = blockIdx.x % a.Hq;
    const int tok = a.q_start[r];
    if (a.q_len[r] <= 0 || tok < 0 || tok >= a.T) return;
    paged::merge_splits<BF, kD>(a.work, (size_t)a.decode_rows * a.Hq,
                                blockIdx.x, a.n_splits,
                                out + ((size_t)tok * a.Hq + head) * kD);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int tok = (blockIdx.x - merge) * kWarps + (threadIdx.x >> 5);
  if (tok >= a.T) return;
  for (int r0 = 0; r0 < a.R; r0 += 32) {
    const int r = r0 + lane;
    bool wrote = false;
    if (r < a.R) {
      const int qs = a.q_start[r], ql = a.q_len[r];
      wrote = ql > 0 &&
              (r < a.decode_rows ? tok == qs : tok >= qs && tok < qs + ql);
    }
    if (__any_sync(paged::kFull, wrote)) return;
  }
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)tok * a.Hq * kD);
  for (int e = lane; e < a.Hq * kD / 8; e += 32) dst[e] = make_uint4(0, 0, 0, 0);
}

template <typename KT, int kPS, int kQpk, int kD>
cudaError_t launch_kernels(const Args& a, cudaStream_t stream) {
  auto kernel = ragged_sm90_kernel<KT, kPS, kQpk, kD>;
  const size_t prefill_smem = Layout<KT, kD>::kBytes + 1024;  // + alignment
  const size_t decode_smem =
      sizeof(paged::SplitSmem<kPS, kQpk, kD>) + 1024;
  const size_t most = std::max(prefill_smem, decode_smem);
  const size_t smem = a.prefill_blocks > 0 ? most : decode_smem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.prefill_blocks + a.decode_blocks;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (blocks > 0) {
    kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int merge = a.n_splits > 1 ? a.decode_rows * a.Hq : 0;
  const int zero = (a.T + kWarps - 1) / kWarps;
  ragged_finish_kernel<kD><<<merge + zero, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename KT, int kPS, int kD>
cudaError_t by_q_per_kv(const Args& a, cudaStream_t stream) {
  switch (a.Hq / a.Hkv) {
    case 1: return launch_kernels<KT, kPS, 1, kD>(a, stream);
    case 2: return launch_kernels<KT, kPS, 2, kD>(a, stream);
    case 4: return launch_kernels<KT, kPS, 4, kD>(a, stream);
    case 8: return launch_kernels<KT, kPS, 8, kD>(a, stream);
  }
  return cudaErrorInvalidValue;  // a group size not built
}

template <typename KT, int kD>
cudaError_t by_page_size(const Args& a, cudaStream_t stream) {
  switch (a.ps) {
    case 8: return by_q_per_kv<KT, 8, kD>(a, stream);
    case 16: return by_q_per_kv<KT, 16, kD>(a, stream);
    case 32: return by_q_per_kv<KT, 32, kD>(a, stream);
  }
  return cudaErrorInvalidValue;  // a page size not built
}

template <typename KT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.D == 64) return by_page_size<KT, 64>(a, stream);
  return by_page_size<KT, 128>(a, stream);
}

}  // namespace bf16

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// q_dtype: 0 fp32, 1 bf16. kv_dtype: q_dtype, or 2 int8 (scales
// required). Head dim 64 or 128; for bf16 q pages of 8, 16 or 32 slots. Row descriptors q_start/q_len/kv_len are int32
// [R], page_table int32 [R, max_pages]. Hints, for bf16 q (fp32 q ignores
// them): rows [0, decode_rows) have q_len <= 1 and go to the decode
// splits of pages_per_split pages; every other row to prefill tiles,
// q_blocks of them per (row, kv head) in the grid. work: fp32, decode_rows
// * Hq * n_splits * (D + 2) floats when decode_rows > 0 and n_splits =
// ceil(max_pages / pages_per_split) > 1, else unused. Returns 0 on
// success, else the cudaError_t code.
int ragged_paged_attention(int q_dtype, int kv_dtype, const void* q,
                           const void* k_pages, const void* v_pages,
                           const void* k_scale, const void* v_scale,
                           const void* page_table, const void* q_start,
                           const void* q_len, const void* kv_len, void* out,
                           void* work, int T, int R, int Hq, int Hkv, int ps,
                           int D, int max_pages, int decode_rows,
                           int q_blocks, int pages_per_split, float sm_scale,
                           void* stream) {
  if (T == 0) return 0;
  if (R <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128) ||
      ps <= 0 ||
      max_pages <= 0 || decode_rows < 0 || decode_rows > R ||
      q_blocks < 1 || pages_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const bool scales = k_scale != nullptr && v_scale != nullptr;
  if ((kv_dtype == kI8) != scales) return (int)cudaErrorInvalidValue;
  // K/V (and q, o, the scales on the bf16 path) move as 16-byte vectors
  if (!aligned16(k_pages) || !aligned16(v_pages))
    return (int)cudaErrorMisalignedAddress;
  Args a{q, k_pages, v_pages, k_scale, v_scale,
         static_cast<const int32_t*>(page_table),
         static_cast<const int32_t*>(q_start),
         static_cast<const int32_t*>(q_len),
         static_cast<const int32_t*>(kv_len), out, static_cast<float*>(work),
         T, R, Hq, Hkv, ps, D, max_pages, decode_rows, q_blocks,
         pages_per_split, /*n_splits=*/0, /*prefill_blocks=*/0,
         /*decode_blocks=*/0, sm_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return (int)f32::launch<float, false>(a, s);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return (int)f32::launch<int8_t, true>(a, s);
  if (q_dtype != kBF16 || (kv_dtype != kBF16 && kv_dtype != kI8))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(out) ||
      (scales && (!aligned16(k_scale) || !aligned16(v_scale))))
    return (int)cudaErrorMisalignedAddress;
  a.n_splits = (max_pages + pages_per_split - 1) / pages_per_split;
  a.prefill_blocks = (R - decode_rows) * q_blocks * Hkv;
  a.decode_blocks = decode_rows * Hkv * a.n_splits;
  if (decode_rows > 0 && a.n_splits > 1 && work == nullptr)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == kBF16) return (int)bf16::launch<__nv_bfloat16>(a, s);
  return (int)bf16::launch<int8_t>(a, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
