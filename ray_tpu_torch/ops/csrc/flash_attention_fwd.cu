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
// ms at the bf16 tensor-core peak (989 TFLOP/s), against 0.12 ms to move q,
// k, v and o.
//
// bf16, flash_fwd_sm90_kernel: one block per (bh, 128-row q tile), the
// blocks of 8 bh's in flight together so their k and v stay in L2, the
// longest rows first among them, causal blocks stopping at the diagonal
// tile; no two blocks write the same output, nothing needs atomics. The
// block is warp-specialised: a producer warpgroup, one thread of which
// issues TMA loads of the q tile once and of 128-key k and v tiles into a
// 2-slot ring (k and v each with full and empty mbarriers), and two
// consumer warpgroups of 64 q rows each. What the design does about the
// limits of the first port (wmma through shared memory):
//   - accumulators live in registers: s = q.k^T is 8 wgmma m64n128k16
//     (both operands in shared memory) into 64 fp32 registers a thread,
//     the online softmax runs on them (row max across a quad's lanes, 2^x
//     by ex2.approx), the o accumulator is rescaled in registers, and p,
//     rounded to bf16 in registers, is the register A operand of
//     o += p.v (wgmma m64n128k16, v read MN-major with the transpose bit);
//   - wgmma, the only path to the full tensor-core rate, replaces
//     mma.sync-based wmma and its per-strip fragment reloads;
//   - loads overlap the math: the producer keeps the next k and v tiles
//     in flight, a k slot is freed as soon as its q.k^T is done, and a
//     consumer waits only on the mbarrier of the tile it needs;
//   - the math overlaps itself: each warpgroup issues tile j's q.k^T and
//     tile j-1's p.v together and runs tile j's softmax while p.v runs,
//     and the two warpgroups take turns to issue (named barriers), so one
//     warpgroup's products run under the other's softmax;
//   - registers and shared memory: setmaxnreg gives the producer 24
//     registers and the consumers 240 (no spills); q (32 KB) and the ring
//     (2 x 64 KB) take 160 KB, one block of 12 warps per SM.
// o leaves through shared memory (the warpgroup's q rows, swizzled) by a
// TMA store, which also drops rows at or past Lq; keys at or past Lk read
// as zeros through the 3-D tensor maps and are masked to -inf. So any
// length works: a box that hangs over the end of a sequence still
// delivers its whole bytes (zeros past the end), which the full barrier
// expects, and only the last key tile (the edge tile) pays for the mask.
//
// Tile variants (the C entry point takes the tile; autotune_blocks in
// ops/flash_attention.py times them and picks one per shape): (blk_q,
// blk_k) = (128, 128), the design above and the default; (128, 64), k/v
// tiles of 64 keys through a 4-slot ring (q 32 KB + 4 x 32 KB, 161 KB):
// s is an m64n64 product (32 scores a thread), p.v takes 4 k steps, and
// the last two key tiles carry the mask (the block's 128-row diagonal
// spans two; warpgroup 0's p on the second is 0). Both take the same
// registers (168 at the launch bound) and neither spills.
//
// fp32 (the training oracle only; wgmma's fp32 input is TF32):
// flash_fwd_kernel, one block per (bh, 32-row q tile) with m, l and the
// accumulator in shared memory, products by flash::tile_mm on CUDA cores.
// Head dim 64, both dtypes, also takes flash_fwd_kernel (bf16: 64-row
// tiles, wmma); the sm90 design is built for head dim 128 only.
//
// Plain C interface (loaded with ctypes): flash_attention_fwd() launches on
// the given stream and returns the cudaError_t of the launch.

#include "flash_attention.cuh"
#include "flash_sm90.cuh"

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

  const int rows = min(B, Lq - q0);  // the last q tile may be partial
  load_tile<T, B, D>(q_s, G::kLdT, q + ((size_t)bh * Lq + q0) * D, rows);
  for (int e = threadIdx.x; e < B * D; e += kThreads)
    o_s[(e / D) * G::kLdO + e % D] = 0.f;
  for (int r = threadIdx.x; r < B; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  int nk = (Lk + B - 1) / B;
  if (causal) nk = min(nk, q0 / B + 1);  // skip above the diagonal
  const T* kg = k + (size_t)bh * Lk * D;
  const T* vg = v + (size_t)bh * Lk * D;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * B;
    const int keys = min(B, Lk - k0);  // keys past Lk: zeros, masked below
    __syncthreads();  // the last tile's readers of k_s, v_s, p_s are done
    load_tile<T, B, D>(k_s, G::kLdT, kg + (size_t)k0 * D, keys);
    load_tile<T, B, D>(v_s, G::kLdT, vg + (size_t)k0 * D, keys);
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
        if (c >= keys || (causal && qpos < k0 + c)) srow[c] = -INFINITY;
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
  store_tile<T, B, D>(o + ((size_t)bh * Lq + q0) * D, o_s, G::kLdO, rows,
                      [&](int r) { return fmaxf(l_s[r], 1e-30f); });
  for (int r = threadIdx.x; r < rows; r += kThreads)
    lse[(size_t)bh * Lq + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int Lq, int Lk, int causal,
                   float sm_scale, cudaStream_t stream) {
  using G = Tiles<T, D>;
  const void* ptrs[] = {q, k, v, o, lse};
  cudaError_t err = check_args(BH, Lq, Lk, ptrs, 5);
  if (err != cudaSuccess) return err;
  const size_t smem =
      3 * G::kTileT + G::kTileS + G::kTileP + G::kTileO + 3 * G::kRow;
  auto kernel = flash_fwd_kernel<T, D>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + G::kBlock - 1) / G::kBlock, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Lq, Lk, causal, sm_scale);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16: wgmma + TMA ring

namespace fwd90 {

using namespace sm90;

constexpr int kRows = 128;               // q rows of a block
constexpr int kThreads = 384;            // producer + two consumer warpgroups
constexpr uint32_t kBoxQ = kRows * 128;  // one [128][64] bf16 box: 16 KB

// A tile variant: k/v tiles of kKeys keys (128, or 64) through a ring of
// kStages slots. Shared memory, from a 1024-byte aligned base: q, the k
// ring, the v ring, then the barriers (q full; k full, v full, k empty,
// v empty per slot).
template <int kKeys, int kStages>
struct Variant {
  static constexpr uint32_t kBoxK = kKeys * 128;  // one [kKeys][64] box
  static constexpr uint32_t kTile = 2 * kBoxK;    // a [kKeys, 128] tile
  static constexpr uint32_t kQ = 0, kK = 2 * kBoxQ;
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBars = kV + kStages * kTile;
  static constexpr size_t kSmem = kBars + 8 * (1 + 4 * kStages) + 1024;
  static constexpr int keys = kKeys, stages = kStages;
  static_assert(kKeys == 128 || kKeys == 64, "key tiles of 128 or 64");
};

// One tile's online-softmax step on this thread's scores s (two rows of
// the m64nN accumulator, N = 2 * R keys, q.k^T unscaled): s becomes p =
// 2^(s' - m) with s' = s * sm_scale * log2(e) (-inf where masked: only on
// an edge tile), m the running max (log2 units); l (this thread's share
// of the sum of the unrounded p) is rescaled and added to; corr, the
// rescale of the o accumulator, is returned.
template <int R>
__device__ __forceinline__ void softmax_tile(float (&s)[R], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool edge, int k0, int row0,
                                             int t, int Lk, int causal,
                                             float scale_log2) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float x = s[i] * scale_log2;
    if (edge) {
      const int col = k0 + acc_col(i, t);
      const int row = row0 + 8 * acc_half(i);
      if (col >= Lk || (causal && row < col)) x = -INFINITY;
    }
    s[i] = x;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < R; ++i) mx[acc_half(i)] = fmaxf(mx[acc_half(i)], s[i]);
  float base_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    // a row that has seen only masked keys keeps m = -inf: p = 0 and
    // corr = 0 follow from ex2(-inf) without a NaN
    base_m[h] = mx[h] == -INFINITY ? 0.f : mx[h];
    corr[h] = ex2(m[h] - base_m[h]);
    m[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float p = ex2(s[i] - base_m[acc_half(i)]);
    s[i] = p;
    l[acc_half(i)] += p;  // the unrounded p
  }
}

// s = q.k^T of one key tile (the warpgroup's 64 rows x kKeys keys, fp32),
// both operands K-major in shared memory
template <int kKeys>
__device__ __forceinline__ void qk_product(float (&s)[kKeys / 2],
                                           uint32_t qa, uint32_t k_tile) {
  constexpr uint32_t kBoxK = kKeys * 128;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if constexpr (kKeys == 128)
      mma_ss_n128(s, desc_k(qa, kBoxQ, kk), desc_k(k_tile, kBoxK, kk),
                  kk > 0);
    else
      mma_ss_n64(s, desc_k(qa, kBoxQ, kk), desc_k(k_tile, kBoxK, kk),
                 kk > 0);
  }
}

// o += p.v of one key tile: p (bf16) the register A operand, v MN-major
template <int kKeys>
__device__ __forceinline__ void pv_product(float (&acc)[64],
                                           const uint32_t (&pa)[kKeys / 4],
                                           uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    mma_rs_n128(acc, pa + 4 * kk, desc_mn(v_tile, kKeys * 128, kk));
}

// whether key tile kt of the nk a block reads needs the mask: with 128-key
// tiles the last one (keys past Lk; causal, the diagonal tile); with
// 64-key tiles the last two (causal, the two tiles the block's 128-row
// diagonal spans: the first lies on warpgroup 0's diagonal and on no key
// past warpgroup 1's rows, the second on warpgroup 1's diagonal and past
// every row of warpgroup 0, whose p there is 0)
template <int kKeys>
__device__ __forceinline__ bool edge_tile(int kt, int nk) {
  if constexpr (kKeys == kRows)
    return kt == nk - 1;
  else
    return kt >= nk - kRows / kKeys;
}

template <int kKeys, int kStages>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse,
    int BH, int Lq, int Lk, int causal, float sm_scale) {
  using V = Variant<kKeys, kStages>;
  const int n_tiles = (Lq + kRows - 1) / kRows;
  const TileOrder order = tile_order(BH, n_tiles);
  const int bh = order.bh;
  const int q0 = (n_tiles - 1 - order.rank) * kRows;  // longest rows first
  int nk = (Lk + kKeys - 1) / kKeys;
  // causal: stop at the last tile of the block's diagonal
  if (causal) nk = min(nk, q0 / kKeys + kRows / kKeys);

  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_addr(raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  unsigned char* smem = raw + (base - raw_addr);
  const uint32_t q_full = base + V::kBars;
  auto bar = [&](int kind, int s) {  // kind: k full, v full, k / v empty
    return base + V::kBars + 8 + 8 * (kind * kStages + s);
  };
  auto k_full = [&](int s) { return bar(0, s); };
  auto v_full = [&](int s) { return bar(1, s); };
  auto k_empty = [&](int s) { return bar(2, s); };
  auto v_empty = [&](int s) { return bar(3, s); };
  auto k_tile = [&](int s) { return base + V::kK + s * V::kTile; };
  auto v_tile = [&](int s) { return base + V::kV + s * V::kTile; };
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full(s), 1);
      bar_init(v_full(s), 1);
      bar_init(k_empty(s), 2 * 128);  // every consumer thread
      bar_init(v_empty(s), 2 * 128);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      bar_expect_tx(q_full, 2 * kBoxQ);
      tma_load(base + V::kQ, &tm_q, q_full, 0, q0, bh);
      tma_load(base + V::kQ + kBoxQ, &tm_q, q_full, 64, q0, bh);
      for (int kt = 0; kt < nk; ++kt) {
        const Ring<kStages> r(kt);
        bar_wait(k_empty(r.slot), r.parity ^ 1);
        bar_expect_tx(k_full(r.slot), V::kTile);
        tma_load(k_tile(r.slot), &tm_k, k_full(r.slot), 0, kt * kKeys, bh);
        tma_load(k_tile(r.slot) + V::kBoxK, &tm_k, k_full(r.slot), 64,
                 kt * kKeys, bh);
        bar_wait(v_empty(r.slot), r.parity ^ 1);
        bar_expect_tx(v_full(r.slot), V::kTile);
        tma_load(v_tile(r.slot), &tm_v, v_full(r.slot), 0, kt * kKeys, bh);
        tma_load(v_tile(r.slot) + V::kBoxK, &tm_v, v_full(r.slot), 64,
                 kt * kKeys, bh);
      }
    }
    return;
  }

  // consumers: warpgroup w owns q rows q0 + 64 w .. + 63
  regs_inc<240>();
  const int w = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int row0 = q0 + 64 * w + 16 * warp + g;  // rows row0, row0 + 8
  const uint32_t qa = base + V::kQ + 64 * w * 128;  // this warpgroup's q rows
  const float scale_log2 = sm_scale * kLog2e;    // s in log2 units

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  float corr[2];
  uint32_t pa[kKeys / 4];  // the last tile's p, bf16: the A operand of p.v
  // ping-pong: the warpgroups issue their products in turns (named
  // barriers 3 + w), so one's products run under the other's softmax
  auto my_turn = [&] { named_sync(3 + w, 256); };
  auto your_turn = [&] { named_arrive(3 + (1 - w), 256); };
  if (w == 1) your_turn();  // warpgroup 0 goes first
  bar_wait(q_full, 0);

  // tile 0: s = q.k^T (64 x kKeys, fp32), then its softmax
  {
    float s[kKeys / 2];
    bar_wait(k_full(0), 0);
    my_turn();
    wgmma_fence();
    qk_product<kKeys>(s, qa, k_tile(0));
    wgmma_commit();
    your_turn();
    wgmma_wait<0>();
    fence_regs(s);
    bar_arrive(k_empty(0));
    softmax_tile(s, m, l, corr, edge_tile<kKeys>(0, nk), 0, row0, t, Lk,
                 causal, scale_log2);
    a_frag(pa, s);
  }
  // tile kt: its q.k^T and the last tile's p.v issued back to back; the
  // softmax of tile kt runs while p.v does
  for (int kt = 1; kt < nk; ++kt) {
    const Ring<kStages> r(kt), last(kt - 1);
    float s[kKeys / 2];
    bar_wait(k_full(r.slot), r.parity);
    bar_wait(v_full(last.slot), last.parity);
    my_turn();
    wgmma_fence();
    qk_product<kKeys>(s, qa, k_tile(r.slot));
    wgmma_commit();
    pv_product<kKeys>(acc, pa, v_tile(last.slot));
    wgmma_commit();
    your_turn();
    wgmma_wait<1>();  // q.k^T done, p.v may still run
    fence_regs(s);
    bar_arrive(k_empty(r.slot));
    softmax_tile(s, m, l, corr, edge_tile<kKeys>(kt, nk), kt * kKeys, row0,
                 t, Lk, causal, scale_log2);
    wgmma_wait<0>();
    fence_regs(acc);
    bar_arrive(v_empty(last.slot));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= corr[acc_half(i)];
    a_frag(pa, s);
  }
  // the last tile's p.v
  {
    const Ring<kStages> last(nk - 1);
    bar_wait(v_full(last.slot), last.parity);
    my_turn();
    wgmma_fence();
    pv_product<kKeys>(acc, pa, v_tile(last.slot));
    wgmma_commit();
    your_turn();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  if (w == 0) my_turn();  // takes warpgroup 1's opening arrival

  // epilogue: o = acc / max(l, 1e-30) into this warpgroup's q rows (read
  // by no one now), then one TMA store; lse per row
  float inv[2], lsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] = fmaxf(quad_sum(l[h]), 1e-30f);
    inv[h] = 1.f / lsum[h];
  }
  store_acc_bf16(smem + V::kQ + 64 * w * 128, kBoxQ, acc, inv, warp, g, t);
  fence_async_smem();
  named_sync(1 + w, 128);
  if (tid == 0 && q0 + 64 * w < Lq) {
    tma_store(&tm_o, qa, 0, q0 + 64 * w, bh);
    tma_store(&tm_o, qa + kBoxQ, 64, q0 + 64 * w, bh);
    tma_store_wait();
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < Lq)
        lse[(size_t)bh * Lq + row] = m[h] * kLn2 + logf(lsum[h]);
    }
  }
}

template <int kKeys, int kStages>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int Lq, int Lk, int causal,
                   float sm_scale, cudaStream_t stream) {
  using V = Variant<kKeys, kStages>;
  const void* ptrs[] = {q, k, v, o, lse};
  cudaError_t err = check_args(BH, Lq, Lk, ptrs, 5);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if ((err = make_tmap(&tm_q, q, BH, Lq, kRows)) != cudaSuccess ||
      (err = make_tmap(&tm_k, k, BH, Lk, kKeys)) != cudaSuccess ||
      (err = make_tmap(&tm_v, v, BH, Lk, kKeys)) != cudaSuccess ||
      (err = make_tmap(&tm_o, o, BH, Lq, 64)) != cudaSuccess)
    return err;
  auto kernel = flash_fwd_sm90_kernel<kKeys, kStages>;
  err = allow_smem(kernel, V::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = BH * ((Lq + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, V::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), BH, Lq, Lk, causal,
      sm_scale);
  return cudaGetLastError();
}

// The variants built, by tile (blk_q, blk_k) in the JAX kernel's roles:
// blk_q query rows a block, blk_k keys a streamed tile. The first is the
// default. f(Variant) is called with the tile's variant, and its result
// returned; a tile not built gives `none`.
template <typename F, typename R>
R with_variant(int blk_q, int blk_k, F f, R none) {
  if (blk_q == kRows && blk_k == 128) return f(Variant<128, 2>{});
  if (blk_q == kRows && blk_k == 64) return f(Variant<64, 4>{});
  return none;
}

}  // namespace fwd90

template <typename T, int D>
size_t first_design_smem() {
  using G = Tiles<T, D>;
  return 3 * G::kTileT + G::kTileS + G::kTileP + G::kTileO + 3 * G::kRow;
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v and o alike). q [BH, Lq, D], k/v
// [BH, Lk, D], o [BH, Lq, D], lse fp32 [BH, Lq]; D 128 (bf16: the sm90
// design) or 64 (the first design); any Lq, Lk >= 1 (the last q tile and
// key tile are masked). (blk_q, blk_k) names the tile variant: bf16 at D
// 128 (128, 128) or (128, 64); the first design (64, 64) in bf16, (32, 32)
// in fp32. Returns 0 on success, else the cudaError_t code
// (cudaErrorInvalidValue for a tile or head dim not built).
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, void* lse, int BH, int Lq,
                        int Lk, int D, int causal, int blk_q, int blk_k,
                        float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = (int)cudaErrorInvalidValue;
  if (dtype == kBF16 && D == 128)
    return fwd90::with_variant(
        blk_q, blk_k,
        [&](auto variant) {
          using V = decltype(variant);
          return (int)fwd90::launch<V::keys, V::stages>(
              q, k, v, o, lse, BH, Lq, Lk, causal, sm_scale, s);
        },
        bad);
  return with_first_design(
      dtype, D,
      [&](auto t, auto dim) {
        using T = typename decltype(t)::type;
        constexpr int kD = decltype(dim)::value;
        return first_design_tile<T, kD>(blk_q, blk_k)
                   ? (int)launch<T, kD>(q, k, v, o, lse, BH, Lq, Lk, causal,
                                        sm_scale, s)
                   : bad;
      },
      bad);
}

// The dynamic shared memory, in bytes, that a launch of tile (blk_q,
// blk_k) takes at (dtype, D); 0 for a tile or head dim not built.
int flash_attention_fwd_smem(int dtype, int D, int blk_q, int blk_k) {
  if (dtype == kBF16 && D == 128)
    return fwd90::with_variant(
        blk_q, blk_k,
        [](auto variant) { return (int)decltype(variant)::kSmem; }, 0);
  return with_first_design(
      dtype, D,
      [&](auto t, auto dim) {
        using T = typename decltype(t)::type;
        constexpr int kD = decltype(dim)::value;
        return first_design_tile<T, kD>(blk_q, blk_k)
                   ? (int)first_design_smem<T, kD>()
                   : 0;
      },
      0);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
