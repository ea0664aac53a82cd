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
// at the bf16 tensor-core peak of 989 TFLOP/s) and dk/dv 4 (4.12e11 FLOP,
// 0.42 ms); the bytes take about 0.15 ms.
//
// flash_dq_kernel and flash_dkv_kernel (fp32, the training oracle, and
// head dim 64 in both dtypes), the first port's design: as the TPU grids,
// one block per (bh, q tile) walking the key tiles for dq, and one block
// per (bh, k tile) walking the query tiles for dk/dv, each accumulating its
// own rows in shared memory; products through flash::tile_mm (wmma on the
// tensor cores for bf16, CUDA cores for fp32).
//
// bf16 dq at head dim 128, flash_dq_sm90_kernel: one block per (bh,
// 128-row q tile), the blocks of 8 bh's in flight together so their k and
// v stay in L2, the longest causal rows first among them. A producer
// warpgroup, one thread of which issues the TMA loads: q and do of the
// block once (with their 128 lse and delta values by bulk copy), then
// 64-key k and v tiles through a 4-slot ring (k and v each with full and
// empty mbarriers), stopping at the block's diagonal when causal. Two
// consumer warpgroups own 64 q rows each and hold their q rows in
// registers as wgmma A fragments, read once; per key tile
//   s = q . k^T (wgmma m64n64k16, A in registers, k K-major in shared
//   memory), dp = do . v^T (both in shared memory), p = 2^(s * sm_scale *
//   log2 e - lse * log2 e) with the causal mask on the warpgroup's
//   diagonal tile only,
//   ds = p (dp - delta) in registers, rounded to bf16 as the A operand of
//   dq += ds . k (wgmma m64n128k16, k read MN-major with the transpose
//   bit);
// tile j's s and dp are issued together with tile j-1's dq product, and
// ds of tile j is formed while that product runs. dq stays in registers
// (64 fp32 a thread) for the block's life; the Pallas body's per-tile
// "* sm_scale" is applied once to the fp32 sum in the epilogue, as for
// dk. A warpgroup stops at its own diagonal tile; warpgroup 0 releases
// warpgroup 1's diagonal tile unread. dq leaves through shared memory (the
// warpgroup's q rows) by TMA stores, which drop rows at or past Lq. What
// the design does about the first port's limits (s, dp and dq in shared
// memory, wmma, synchronous loads with a block barrier between products):
// every accumulator lives in registers, wgmma replaces wmma, the loads fly
// under the math, and setmaxnreg gives the consumers 240 registers. Tuned
// on the card at the training shape (PERF.md): with 2 ring slots a slot
// came free only after both warpgroups' dq products on it, and the next
// tile's products waited on its load (0.746 ms); 3 slots 0.577, 4 slots
// 0.565, and q in registers, which halves the shared-memory reads of
// q . k^T, 0.533. Ping-pong between the warpgroups (the forward's) cost
// 1-2%; do in registers too spilled.
//
// bf16 dk/dv, flash_dkv_sm90_kernel: one block per (bh, 128-key tile), the
// blocks of 8 bh's in flight together so their q and do stay in L2, the
// first key tiles (which see the most query rows) first among them. A
// producer warpgroup, one thread of which issues the TMA loads: k and v of
// the block once, then 64-row query tiles (q, do, and their 64 lse and
// delta values by bulk copy) through a 2-slot mbarrier ring. Two consumer
// warpgroups own 64 keys each and compute everything transposed, so every
// product has its A operand in shared memory or registers and its
// accumulator in registers:
//   s^T = k . q^T, dp^T = v . do^T (wgmma m64n64k16, operands in shared
//   memory), p^T = exp(s^T * sm_scale - lse[column]) (2^x by ex2.approx)
//   with causal masking on the diagonal tiles only,
//   ds^T = p^T (dp^T - delta[column]);
//   dv += bf16(p^T) . do and dk += bf16(ds^T) . q (wgmma m64n128k16, A in
//   registers, do and q read MN-major with the transpose bit); the dk
//   product overlaps the computation of ds^T.
// dk and dv stay in registers (2 x 64 fp32 a thread) for the block's life;
// the Pallas body's per-tile "* sm_scale" on dk's products is applied once
// to the fp32 sum in the epilogue, which moves results by fp32 rounding
// only, far below the bf16 output's step. What the design does about the
// first port's limits: no accumulator goes through shared memory; wgmma
// replaces wmma; loads overlap the math, consumers waiting only on the
// mbarrier of the tile they need; setmaxnreg gives the consumers 240
// registers, and k, v and the ring take 130 KB. dk and dv leave through
// shared memory (the warpgroup's k and v rows) by TMA stores, which drop
// keys at or past Lk. No two blocks write the same rows, nothing uses
// atomics, and the output is bit-for-bit repeatable.
//
// Plain C interface (loaded with ctypes): flash_attention_dq() and
// flash_attention_dkv() launch on the given stream and return the
// cudaError_t of the launch.

#include "flash_attention.cuh"
#include "flash_sm90.cuh"

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
  const size_t srow0 = (size_t)bh * padded_rows(Lq) + q0;  // lse, delta
  const int rows = min(B, Lq - q0);  // the last q tile may be partial
  load_tile<T, B, D>(q_s, G::kLdT, q + row0 * D, rows);
  load_tile<T, B, D>(do_s, G::kLdT, dout + row0 * D, rows);
  for (int r = threadIdx.x; r < B; r += kThreads) {
    lse_s[r] = lse[srow0 + r];
    delta_s[r] = delta[srow0 + r];
  }
  for (int e = threadIdx.x; e < B * D; e += kThreads)
    dq_s[(e / D) * G::kLdO + e % D] = 0.f;
  int nk = (Lk + B - 1) / B;
  if (causal) nk = min(nk, q0 / B + 1);  // skip above the diagonal
  const T* kg = k + (size_t)bh * Lk * D;
  const T* vg = v + (size_t)bh * Lk * D;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * B;
    const int keys = min(B, Lk - k0);  // keys past Lk: zeros, p masked
    __syncthreads();  // the last tile's readers of k_s and ds_s are done
    load_tile<T, B, D>(k_s, G::kLdT, kg + (size_t)k0 * D, keys);
    load_tile<T, B, D>(v_s, G::kLdT, vg + (size_t)k0 * D, keys);
    __syncthreads();
    tile_mm<B, B, D, false, true, false>(s_s, G::kLdS, q_s, G::kLdT, k_s,
                                         G::kLdT, sm_scale);
    tile_mm<B, B, D, false, true, false>(dp_s, G::kLdS, do_s, G::kLdT, v_s,
                                         G::kLdT, 1.f);
    __syncthreads();
    for (int e = threadIdx.x; e < B * B; e += kThreads) {
      const int r = e / B;
      const int c = e - r * B;
      const float s = (c >= keys || (causal && q0 + r < k0 + c))
                          ? -INFINITY
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
  store_tile<T, B, D>(dq + row0 * D, dq_s, G::kLdO, rows,
                      [](int) { return 1.f; });
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
  const int keys = min(B, Lk - k0);  // the last key tile may be partial
  load_tile<T, B, D>(k_s, G::kLdT, k + krow0 * D, keys);
  load_tile<T, B, D>(v_s, G::kLdT, v + krow0 * D, keys);
  for (int e = threadIdx.x; e < B * D; e += kThreads) {
    const int at = (e / D) * G::kLdO + e % D;
    dk_s[at] = 0.f;
    dv_s[at] = 0.f;
  }
  // causal: query tile qt sees key k0 once qt * B + B - 1 >= k0
  const int qt0 = causal ? k0 / B : 0;
  const int nq = (Lq + B - 1) / B;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * B;
    const size_t row0 = (size_t)bh * Lq + q0;
    const size_t srow0 = (size_t)bh * padded_rows(Lq) + q0;  // lse, delta
    const int rows = min(B, Lq - q0);  // rows past Lq: zeros
    __syncthreads();  // the last tile's readers of q_s, do_s, p_s, ds_s
    load_tile<T, B, D>(q_s, G::kLdT, q + row0 * D, rows);
    load_tile<T, B, D>(do_s, G::kLdT, dout + row0 * D, rows);
    for (int r = threadIdx.x; r < B; r += kThreads) {
      lse_s[r] = lse[srow0 + r];
      delta_s[r] = delta[srow0 + r];
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
      // rows past Lq need no mask: q, do, lse and delta are zeros there,
      // so p = 1 and p . do = ds = 0
      const float s = (c >= keys || (causal && q0 + r < k0 + c))
                          ? -INFINITY
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
  store_tile<T, B, D>(dk + krow0 * D, dk_s, G::kLdO, keys,
                      [](int) { return 1.f; });
  store_tile<T, B, D>(dv + krow0 * D, dv_s, G::kLdO, keys,
                      [](int) { return 1.f; });
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int Lq, int Lk, int causal,
                      float sm_scale, cudaStream_t stream) {
  using G = Tiles<T, D>;
  const void* ptrs[] = {q, k, v, dout, lse, delta, dq};
  cudaError_t err = check_args(BH, Lq, Lk, ptrs, 7);
  if (err != cudaSuccess) return err;
  const size_t smem =
      4 * G::kTileT + 2 * G::kTileS + G::kTileP + G::kTileO + 2 * G::kRow;
  auto kernel = flash_dq_kernel<T, D>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + G::kBlock - 1) / G::kBlock, BH);
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
  cudaError_t err = check_args(BH, Lq, Lk, ptrs, 8);
  if (err != cudaSuccess) return err;
  const size_t smem = 4 * G::kTileT + 2 * G::kTileS + 2 * G::kTileP +
                      2 * G::kTileO + 2 * G::kRow;
  auto kernel = flash_dkv_kernel<T, D>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lk + G::kBlock - 1) / G::kBlock, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, causal, sm_scale);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16 dq: wgmma + TMA ring

namespace dq90 {

using namespace sm90;

constexpr int kRows = 128;     // q rows of a block (64 per consumer warpgroup)
constexpr int kKeys = 64;      // keys of a streamed k/v tile
constexpr int kStages = 4;     // k/v ring slots
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr uint32_t kBoxQ = kRows * 128;  // a [128][64] bf16 box: 16 KB
constexpr uint32_t kBoxK = kKeys * 128;  // a [64][64] bf16 box: 8 KB
// shared memory, from a 1024-byte aligned base: q and do (two boxes each),
// lse and delta (128 fp32 each), the k ring and the v ring (two boxes a
// slot), then the barriers (q/do full; k full, v full, k empty, v empty
// per slot)
constexpr uint32_t kQ = 0, kDo = 2 * kBoxQ;
constexpr uint32_t kLse = 4 * kBoxQ, kDelta = kLse + 4 * kRows;
constexpr uint32_t kK = kDelta + 4 * kRows;
constexpr uint32_t kV = kK + kStages * 2 * kBoxK;
constexpr uint32_t kBars = kV + kStages * 2 * kBoxK;
constexpr size_t kSmem = kBars + 8 * (1 + 4 * kStages) + 1024;
static_assert(kK % 1024 == 0, "the ring keeps the swizzle");

// s = q.k^T and dp = do.v^T of one key tile: the warpgroup's 64 rows x
// 64 keys, fp32; q from registers (qf: the A fragments of its 8 k steps),
// do from shared memory, k and v K-major in shared memory
__device__ __forceinline__ void products(float (&s)[32], float (&dp)[32],
                                         const uint32_t (&qf)[32],
                                         uint32_t doa, uint32_t k_tile,
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma_rs_n64<0>(s, qf + 4 * kk, desc_k(k_tile, kBoxK, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma_ss_n64(dp, desc_k(doa, kBoxQ, kk), desc_k(v_tile, kBoxK, kk),
               kk > 0);
}

// ds = p (dp - delta) into s, p = 2^(s sm_scale log2e - lse log2e) for
// the thread's two rows (row0, row0 + 8); on an edge tile p is 0 where
// the row precedes the key (causal) and, with kPartial (Lk not a multiple
// of the key tile), where the key is at or past Lk; keys counted from k0.
// Without kPartial an edge tile is a causal one, and the test is the one
// the full-tile lengths always ran.
template <bool kPartial>
__device__ __forceinline__ void form_ds(float (&s)[32], const float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&dlt)[2], bool edge,
                                        int row0, int k0, int t, int Lk,
                                        int causal, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = acc_half(i);
    float p = ex2(s[i] * scale_log2 - lse2[h]);
    const int key = k0 + acc_col(i, t);
    bool masked = row0 + 8 * h < key;
    if constexpr (kPartial) masked = key >= Lk || (causal && masked);
    if (edge && masked) p = 0.f;
    s[i] = p * (dp[i] - dlt[h]);
  }
}

// dq += bf16(ds) . k: 4 k steps of 16 keys, k read MN-major
__device__ __forceinline__ void dq_product(float (&dq)[64],
                                           const uint32_t (&dsa)[16],
                                           uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs_n128(dq, dsa + 4 * kk, desc_mn(k_tile, kBoxK, kk));
}

template <bool kPartial>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_dq,
    const float* __restrict__ lse, const float* __restrict__ delta, int BH,
    int Lq, int Lk, int causal, float sm_scale) {
  const int n_tiles = (Lq + kRows - 1) / kRows;
  const TileOrder order = tile_order(BH, n_tiles);
  const int bh = order.bh;
  const int q0 = (n_tiles - 1 - order.rank) * kRows;  // longest rows first
  // lse and delta of the block's rows, whole 64-row pieces of the padded
  // [BH, padded_rows(Lq)] arrays (zeros past Lq)
  const int Lp = padded_rows(Lq);
  const int rows = min(kRows, Lp - q0);
  // the key tiles warpgroup w reads: causal, up to its own diagonal tile
  const int nk_all = (Lk + kKeys - 1) / kKeys;
  auto tiles_of = [&](int w) {
    return causal ? min(nk_all, q0 / kKeys + w + 1) : nk_all;
  };
  const int nk = tiles_of(1);  // the producer's: the longer of the two

  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_addr(raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  unsigned char* smem = raw + (base - raw_addr);
  const uint32_t qd_full = base + kBars;
  auto bar = [&](int kind, int s) {  // kind: k full, v full, k / v empty
    return base + kBars + 8 + 8 * (kind * kStages + s);
  };
  auto k_full = [&](int s) { return bar(0, s); };
  auto v_full = [&](int s) { return bar(1, s); };
  auto k_empty = [&](int s) { return bar(2, s); };
  auto v_empty = [&](int s) { return bar(3, s); };
  auto k_tile = [&](int s) { return base + kK + s * 2 * kBoxK; };
  auto v_tile = [&](int s) { return base + kV + s * 2 * kBoxK; };
  if (threadIdx.x == 0) {
    bar_init(qd_full, 1);
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
      bar_expect_tx(qd_full, 4 * kBoxQ + 8 * rows);
      tma_load(base + kQ, &tm_q, qd_full, 0, q0, bh);
      tma_load(base + kQ + kBoxQ, &tm_q, qd_full, 64, q0, bh);
      tma_load(base + kDo, &tm_do, qd_full, 0, q0, bh);
      tma_load(base + kDo + kBoxQ, &tm_do, qd_full, 64, q0, bh);
      bulk_load(base + kLse, lse + (size_t)bh * Lp + q0, 4 * rows, qd_full);
      bulk_load(base + kDelta, delta + (size_t)bh * Lp + q0, 4 * rows,
                qd_full);
      for (int kt = 0; kt < nk; ++kt) {
        const Ring<kStages> r(kt);
        bar_wait(k_empty(r.slot), r.parity ^ 1);
        bar_expect_tx(k_full(r.slot), 2 * kBoxK);
        tma_load(k_tile(r.slot), &tm_k, k_full(r.slot), 0, kt * kKeys, bh);
        tma_load(k_tile(r.slot) + kBoxK, &tm_k, k_full(r.slot), 64,
                 kt * kKeys, bh);
        bar_wait(v_empty(r.slot), r.parity ^ 1);
        bar_expect_tx(v_full(r.slot), 2 * kBoxK);
        tma_load(v_tile(r.slot), &tm_v, v_full(r.slot), 0, kt * kKeys, bh);
        tma_load(v_tile(r.slot) + kBoxK, &tm_v, v_full(r.slot), 64,
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
  const int row0 = q0 + 64 * w + 16 * warp + g;    // rows row0, row0 + 8
  const uint32_t qa = base + kQ + 64 * w * 128;    // this warpgroup's q rows
  const uint32_t doa = base + kDo + 64 * w * 128;  // and do rows
  const int n = tiles_of(w);
  const float scale_log2 = sm_scale * kLog2e;

  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  bar_wait(qd_full, 0);
  // this thread's two rows' lse (log2 units) and delta; rows at or past
  // Lq read what the shared memory held, and their dq is never stored
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * w + 16 * warp + g + 8 * h;
    lse2[h] = reinterpret_cast<const float*>(smem + kLse)[r] * kLog2e;
    dlt[h] = reinterpret_cast<const float*>(smem + kDelta)[r];
  }
  // this thread's share of its warpgroup's q rows, read once from the
  // swizzled tile as the A fragments of q.k^T's 8 k steps (an SS product
  // of 64 keys reads as many shared-memory bytes per k step as the
  // tensor cores take clocks to multiply them)
  uint32_t qf[32];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 64 * w + 16 * warp + g + 8 * (i & 1);
      const int col = 16 * kk + 8 * (i >> 1) + 2 * t;
      qf[4 * kk + i] = *reinterpret_cast<const uint32_t*>(
          smem + kQ + (col >> 6) * kBoxQ + swizzled(row, col & 63));
    }
  // a key tile needs the mask where its last key passes the warpgroup's
  // first row (causal: the warpgroup's diagonal tile) or Lk (the last
  // tile, kPartial only)
  auto edge = [&](int kt) {
    return (causal && kt * kKeys + kKeys - 1 > q0 + 64 * w) ||
           (kPartial && kt * kKeys + kKeys > Lk);
  };

  uint32_t dsa[16];  // the last tile's ds in bf16: its dq product's A
  {
    float s[32], dp[32];
    bar_wait(k_full(0), 0);
    bar_wait(v_full(0), 0);
    wgmma_fence();
    products(s, dp, qf, doa, k_tile(0), v_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    bar_arrive(v_empty(0));
    form_ds<kPartial>(s, dp, lse2, dlt, edge(0), row0, 0, t, Lk, causal,
                      scale_log2);
    a_frag(dsa, s);
  }
  // tile kt: its s and dp, then the last tile's dq product, issued back to
  // back; ds of tile kt is formed while the dq product runs
  for (int kt = 1; kt < n; ++kt) {
    const Ring<kStages> r(kt), last(kt - 1);
    float s[32], dp[32];
    bar_wait(k_full(r.slot), r.parity);
    bar_wait(v_full(r.slot), r.parity);
    wgmma_fence();
    products(s, dp, qf, doa, k_tile(r.slot), v_tile(r.slot));
    wgmma_commit();
    dq_product(dq, dsa, k_tile(last.slot));
    wgmma_commit();
    wgmma_wait<1>();  // s and dp done, the dq product may still run
    fence_regs(s);
    fence_regs(dp);
    bar_arrive(v_empty(r.slot));
    form_ds<kPartial>(s, dp, lse2, dlt, edge(kt), row0, kt * kKeys, t, Lk,
                      causal, scale_log2);
    wgmma_wait<0>();
    fence_regs(dq);
    bar_arrive(k_empty(last.slot));
    a_frag(dsa, s);
  }
  {
    const Ring<kStages> last(n - 1);
    wgmma_fence();
    dq_product(dq, dsa, k_tile(last.slot));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    bar_arrive(k_empty(last.slot));
  }
  // causal: the tile on warpgroup 1's diagonal lies above every row of
  // warpgroup 0, which releases it unread once it has arrived (arriving
  // earlier could count towards the slot's previous phase)
  for (int kt = n; kt < nk; ++kt) {
    const Ring<kStages> r(kt);
    bar_wait(k_full(r.slot), r.parity);
    bar_wait(v_full(r.slot), r.parity);
    bar_arrive(k_empty(r.slot));
    bar_arrive(v_empty(r.slot));
  }

  // epilogue: dq * sm_scale as bf16 into this warpgroup's q rows (read by
  // no one now), then TMA stores, which drop rows at or past Lq
  const float dq_scale[2] = {sm_scale, sm_scale};
  store_acc_bf16(smem + kQ + 64 * w * 128, kBoxQ, dq, dq_scale, warp, g, t);
  fence_async_smem();
  named_sync(1 + w, 128);
  if (tid == 0 && q0 + 64 * w < Lq) {
    tma_store(&tm_dq, qa, 0, q0 + 64 * w, bh);
    tma_store(&tm_dq, qa + kBoxQ, 64, q0 + 64 * w, bh);
    tma_store_wait();
  }
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int BH, int Lq, int Lk, int causal,
                   float sm_scale, cudaStream_t stream) {
  const void* ptrs[] = {q, k, v, dout, lse, delta, dq};
  cudaError_t err = check_args(BH, Lq, Lk, ptrs, 7);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if ((err = make_tmap(&tm_q, q, BH, Lq, kRows)) != cudaSuccess ||
      (err = make_tmap(&tm_do, dout, BH, Lq, kRows)) != cudaSuccess ||
      (err = make_tmap(&tm_k, k, BH, Lk, kKeys)) != cudaSuccess ||
      (err = make_tmap(&tm_v, v, BH, Lk, kKeys)) != cudaSuccess ||
      (err = make_tmap(&tm_dq, dq, BH, Lq, 64)) != cudaSuccess)
    return err;
  // a last key tile past Lk needs the key mask; full tiles run the
  // instantiation without it. The boxes fill k and v past Lk with zeros,
  // so such a key adds ds . 0 to dq, but p = 2^(-lse log2e) there, which
  // overflows to inf (and inf . 0 = NaN) for a row whose scores all lie
  // below about -88: the mask keeps that row finite.
  auto kernel = Lk % kKeys ? flash_dq_sm90_kernel<true>
                           : flash_dq_sm90_kernel<false>;
  err = allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = BH * ((Lq + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), BH, Lq, Lk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace dq90

// --------------------------------------------- bf16 dk/dv: wgmma + TMA ring

namespace dkv90 {

using namespace sm90;

constexpr int kKeys = 128;    // keys of a block (64 per consumer warpgroup)
constexpr int kQRows = 64;    // query rows of a streamed tile
constexpr int kStages = 2;    // query-tile ring slots
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr uint32_t kBoxK = kKeys * 128;   // a [128][64] bf16 box: 16 KB
constexpr uint32_t kBoxQ = kQRows * 128;  // a [64][64] bf16 box: 8 KB
// shared memory, from a 1024-byte aligned base: k and v (two boxes each),
// then per ring slot q, do (two boxes each), lse and delta (64 fp32 each),
// then the barriers (k/v full; full and empty per slot)
constexpr uint32_t kK = 0, kV = 2 * kBoxK;
constexpr uint32_t kSlot0 = 4 * kBoxK;
constexpr uint32_t kQ = 0, kDo = 2 * kBoxQ, kLse = 4 * kBoxQ;
constexpr uint32_t kDelta = kLse + 4 * kQRows;
constexpr uint32_t kSlotBytes = kDelta + 4 * kQRows + 512;  // 1024-aligned
constexpr uint32_t kBars = kSlot0 + kStages * kSlotBytes;
constexpr size_t kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
constexpr uint32_t kSlotTx = 4 * kBoxQ + 8 * kQRows;  // bytes per q tile
static_assert(kSlotBytes % 1024 == 0, "ring slots keep the swizzle");

__global__ void __launch_bounds__(kThreads, 1) flash_dkv_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_dk,
    const __grid_constant__ CUtensorMap tm_dv,
    const float* __restrict__ lse, const float* __restrict__ delta, int BH,
    int Lq, int Lk, int causal, float sm_scale) {
  const TileOrder order = tile_order(BH, (Lk + kKeys - 1) / kKeys);
  const int bh = order.bh;
  const int k0 = order.rank * kKeys;  // causal: the first tiles see most rows
  // causal: query tile qt sees a key of the block once qt * 64 + 63 >= k0
  const int qt0 = causal ? k0 / kQRows : 0;
  const int n_iter = max((Lq + kQRows - 1) / kQRows - qt0, 0);
  const int Lp = padded_rows(Lq);  // the pitch of lse and delta

  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_addr(raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  unsigned char* smem = raw + (base - raw_addr);
  const uint32_t kv_full = base + kBars;
  auto full = [&](int s) { return base + kBars + 8 + 8 * s; };
  auto empty = [&](int s) { return base + kBars + 8 + 8 * (kStages + s); };
  auto slot = [&](int s) { return kSlot0 + s * kSlotBytes; };
  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 2 * 128);  // every consumer thread
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      bar_expect_tx(kv_full, 4 * kBoxK);
      tma_load(base + kK, &tm_k, kv_full, 0, k0, bh);
      tma_load(base + kK + kBoxK, &tm_k, kv_full, 64, k0, bh);
      tma_load(base + kV, &tm_v, kv_full, 0, k0, bh);
      tma_load(base + kV + kBoxK, &tm_v, kv_full, 64, k0, bh);
      for (int it = 0; it < n_iter; ++it) {
        const Ring<kStages> r(it);
        const int q0 = (qt0 + it) * kQRows;
        const uint32_t d = base + slot(r.slot);
        bar_wait(empty(r.slot), r.parity ^ 1);
        bar_expect_tx(full(r.slot), kSlotTx);
        tma_load(d + kQ, &tm_q, full(r.slot), 0, q0, bh);
        tma_load(d + kQ + kBoxQ, &tm_q, full(r.slot), 64, q0, bh);
        tma_load(d + kDo, &tm_do, full(r.slot), 0, q0, bh);
        tma_load(d + kDo + kBoxQ, &tm_do, full(r.slot), 64, q0, bh);
        bulk_load(d + kLse, lse + (size_t)bh * Lp + q0, 4 * kQRows,
                  full(r.slot));
        bulk_load(d + kDelta, delta + (size_t)bh * Lp + q0, 4 * kQRows,
                  full(r.slot));
      }
    }
    return;
  }

  // consumers: warpgroup w owns keys k0 + 64 w .. + 63
  regs_inc<240>();
  const int w = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int key0 = k0 + 64 * w + 16 * warp + g;  // keys key0, key0 + 8
  const uint32_t ka = base + kK + 64 * w * 128;  // this warpgroup's k rows
  const uint32_t va = base + kV + 64 * w * 128;  // and v rows
  const float scale_log2 = sm_scale * kLog2e;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  bar_wait(kv_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const Ring<kStages> r(it);
    const int q0 = (qt0 + it) * kQRows;
    const uint32_t qb = base + slot(r.slot) + kQ;
    const uint32_t dob = base + slot(r.slot) + kDo;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + slot(r.slot) + kLse);
    const float* delta_s =
        reinterpret_cast<const float*>(smem + slot(r.slot) + kDelta);

    // s^T = k . q^T and dp^T = v . do^T (64 keys x 64 queries, fp32)
    float st[32], dpt[32];
    bar_wait(full(r.slot), r.parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      mma_ss_n64(st, desc_k(ka, kBoxK, kk), desc_k(qb, kBoxQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      mma_ss_n64(dpt, desc_k(va, kBoxK, kk), desc_k(dob, kBoxQ, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // p^T = exp(s^T * sm_scale - lse[query]); masked (causal diagonal
    // tiles, keys past Lk) to 0. Query rows past Lq need no mask: the
    // boxes fill q and do with zeros there and lse and delta are padded
    // with zeros, so p = 1, dv += 1 . 0, dp = 0 and ds = 1 (0 - 0) = 0.
    const bool edge = (causal && q0 < k0 + kKeys) || k0 + kKeys > Lk;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = acc_col(i, t);
      float p = ex2(st[i] * scale_log2 - lse_s[col] * kLog2e);
      if (edge) {
        const int key = key0 + 8 * acc_half(i);
        if (key >= Lk || (causal && q0 + col < key)) p = 0.f;
      }
      st[i] = p;
    }
    // dv += bf16(p^T) . do, in flight while ds^T is formed
    uint32_t pa[16];
    a_frag(pa, st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_n128(dv, pa + 4 * kk, desc_mn(dob, kBoxQ, kk));
    wgmma_commit();
    // ds^T = p^T (dp^T - delta[query]); dk += bf16(ds^T) . q
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dpt[i] = st[i] * (dpt[i] - delta_s[acc_col(i, t)]);
    uint32_t dsa[16];
    a_frag(dsa, dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_n128(dk, dsa + 4 * kk, desc_mn(qb, kBoxQ, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    bar_arrive(empty(r.slot));
  }

  // epilogue: dk * sm_scale and dv as bf16 into this warpgroup's k and v
  // rows (read by no one now), then TMA stores
  const float dk_scale[2] = {sm_scale, sm_scale}, one[2] = {1.f, 1.f};
  store_acc_bf16(smem + kK + 64 * w * 128, kBoxK, dk, dk_scale, warp, g, t);
  store_acc_bf16(smem + kV + 64 * w * 128, kBoxK, dv, one, warp, g, t);
  fence_async_smem();
  named_sync(1 + w, 128);
  if (tid == 0 && k0 + 64 * w < Lk) {
    tma_store(&tm_dk, ka, 0, k0 + 64 * w, bh);
    tma_store(&tm_dk, ka + kBoxK, 64, k0 + 64 * w, bh);
    tma_store(&tm_dv, va, 0, k0 + 64 * w, bh);
    tma_store(&tm_dv, va + kBoxK, 64, k0 + 64 * w, bh);
    tma_store_wait();
  }
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int BH, int Lq, int Lk, int causal,
                   float sm_scale, cudaStream_t stream) {
  const void* ptrs[] = {q, k, v, dout, lse, delta, dk, dv};
  cudaError_t err = check_args(BH, Lq, Lk, ptrs, 8);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  if ((err = make_tmap(&tm_q, q, BH, Lq, kQRows)) != cudaSuccess ||
      (err = make_tmap(&tm_do, dout, BH, Lq, kQRows)) != cudaSuccess ||
      (err = make_tmap(&tm_k, k, BH, Lk, kKeys)) != cudaSuccess ||
      (err = make_tmap(&tm_v, v, BH, Lk, kKeys)) != cudaSuccess ||
      (err = make_tmap(&tm_dk, dk, BH, Lk, 64)) != cudaSuccess ||
      (err = make_tmap(&tm_dv, dv, BH, Lk, 64)) != cudaSuccess)
    return err;
  err = allow_smem(flash_dkv_sm90_kernel, kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = BH * ((Lk + kKeys - 1) / kKeys);
  flash_dkv_sm90_kernel<<<blocks, kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), BH, Lq, Lk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace dkv90

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v, do and the gradients alike). q/do/dq
// [BH, Lq, D], k/v/dk/dv [BH, Lk, D], lse/delta fp32 [BH, Lp] with Lp = Lq
// rounded up to 64 (the padding zeros); D 128 (bf16: the sm90 designs) or
// 64 (the first designs); any Lq, Lk >= 1 (the last q tile and key tile
// are masked). Each returns 0 on success, else the cudaError_t code.
int flash_attention_dq(int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const void* lse,
                       const void* delta, void* dq, int BH, int Lq, int Lk,
                       int D, int causal, float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (D == 64)  // the first design at head dim 64, both dtypes
    return dtype == kF32
               ? (int)launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, BH,
                                           Lq, Lk, causal, sm_scale, s)
               : (int)launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta,
                                                   dq, BH, Lq, Lk, causal,
                                                   sm_scale, s);
  if (D != 128) return (int)cudaErrorInvalidValue;  // a head dim not built
  if (dtype == kF32)
    return (int)launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, BH, Lq,
                                      Lk, causal, sm_scale, s);
  return (int)dq90::launch(q, k, v, dout, lse, delta, dq, BH, Lq, Lk, causal,
                           sm_scale, s);
}

int flash_attention_dkv(int dtype, const void* q, const void* k,
                        const void* v, const void* dout, const void* lse,
                        const void* delta, void* dk, void* dv, int BH, int Lq,
                        int Lk, int D, int causal, float sm_scale,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return dtype == kF32
               ? (int)launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk,
                                            dv, BH, Lq, Lk, causal, sm_scale,
                                            s)
               : (int)launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse,
                                                    delta, dk, dv, BH, Lq, Lk,
                                                    causal, sm_scale, s);
  if (D != 128) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, BH,
                                       Lq, Lk, causal, sm_scale, s);
  return (int)dkv90::launch(q, k, v, dout, lse, delta, dk, dv, BH, Lq, Lk,
                            causal, sm_scale, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
