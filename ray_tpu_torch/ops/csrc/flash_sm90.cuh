// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) and of the ragged
// kernel's prefill tiles (ragged_paged_attention.cu): TMA tensor maps,
// loads and stores; cp.async; the mbarrier ring; wgmma descriptors and
// instructions (bf16 operands, fp32 accumulators in registers); the
// accumulator fragment helpers the register softmax works on. Written from
// the PTX ISA.
//
// Tiles in shared memory. A [rows, 128] bf16 tile is held as two TMA boxes
// of [rows][64] (d 0..63, then d 64..127), each row 128 bytes with the
// 128-byte swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)),
// every box on 1024 bytes. wgmma reads such a box
//   - K-major (the reduction runs along d, as q and k in q.k^T): the
//     descriptor starts at the box plus 32 bytes per 16-element k step,
//     8-row groups 1024 bytes apart (SBO);
//   - MN-major (the reduction runs along the rows, as v in p.v): the
//     descriptor starts 16 rows (2048 bytes) further per k step, 8-row
//     groups 1024 bytes apart (SBO), the second 64-wide d half one box
//     further (LBO), and the instruction's transpose bit set.
//
// Accumulator layout of wgmma m64nNk16 (fp32, 128 threads): warp w of the
// warpgroup holds rows 16w..16w+15; lane = 4g + t holds, for each 8-column
// block j, d[4j + 0..1] at (row 16w + g, columns 8j + 2t, +1) and
// d[4j + 2..3] at (row 16w + g + 8, the same columns). So a row's values
// sit in the four lanes of a quad, and the fp32 accumulator of one product,
// rounded to bf16 in pairs, is the register A operand of the next one.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the library does not link
// (only the runtime), so it is looked up once through the runtime's
// entry-point query
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D map over a row-major [BH, L, 128] bf16 array, boxes of
// [1][box_rows][64] with the 128-byte swizzle. Being 3-D, a box that runs
// past row L of one bh is clipped there: loads fill zeros, stores drop the
// rows, and nothing of the next bh is touched.
inline cudaError_t make_tmap(CUtensorMap* map, const void* base, int BH,
                             int L, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {128, static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {128 * 2, static_cast<cuuint64_t>(L) * 256};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------- device side

// Which (bh, tile rank) a block of a 1-D grid of BH * tiles blocks takes.
// Blocks start in index order, so the blocks of kGroup bh's are in flight
// together and share their streamed tiles in L2 (k and v for the forward,
// q and do for dk/dv: 1 MB per bh at L 2048); within a group, rank 0
// (the longest work) first.
struct TileOrder {
  int bh, rank;
};

__device__ __forceinline__ TileOrder tile_order(int BH, int tiles) {
  constexpr int kGroup = 8;
  const int block = blockIdx.x;
  const int group = block / (kGroup * tiles);
  const int in = block - group * kGroup * tiles;
  const int n = min(kGroup, BH - group * kGroup);
  return {group * kGroup + in % n, in / n};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset, inside a box of 128-byte rows with the 128-byte swizzle, of
// element (row, col) (col < 64, 2-byte elements)
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

// mbarriers: a full barrier per ring slot counts the producer's arrival
// and the bytes its copies deliver; an empty one counts consumer threads
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ring slot and phase parity of the i-th item through a kStages ring
template <int kStages>
struct Ring {
  int slot;
  uint32_t parity;
  __device__ __forceinline__ explicit Ring(int i)
      : slot(i % kStages), parity((i / kStages) & 1) {}
};

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// a contiguous copy of bytes (a multiple of 16, both ends on 16 bytes)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wait until the issued stores have read their shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (src is then not read). Completion: cp_async_commit groups the copies
// issued so far, cp_async_wait<n> waits until at most n groups are pending.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(valid ? 16 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// make this thread's shared-memory writes (stores and completed cp.async
// copies) visible to the async proxy: the TMA unit and wgmma's operand reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// ------------------------------------------------------------------ wgmma

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: the box at addr, k step kk (16 elements) of 8 over d
__device__ __forceinline__ uint64_t desc_k(uint32_t box0, uint32_t box_bytes,
                                           int kk) {
  return desc(box0 + (kk >> 2) * box_bytes + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: k step kk over the rows, the two d halves box_bytes
// apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t box0, uint32_t box_bytes,
                                            int kk) {
  return desc(box0 + kk * 2048, box_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define SM90_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_D32(i) SM90_D8(i), SM90_D8(i + 8), SM90_D8(i + 16), SM90_D8(i + 24)

// d (64 x 64, fp32) = (accumulate ? d : 0) + A . B^T, A and B K-major in
// shared memory (A 64 x 16, B 64 x 16)
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) = (accumulate ? d : 0) + A . B^T, A and B K-major in
// shared memory (A 64 x 16, B 128 x 16)
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D32(0), SM90_D32(32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) += A . B, A (64 x 16 bf16) in registers as four
// packed pairs (see a_frag), B (16 x 128) MN-major in shared memory
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                            const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D32(0), SM90_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, fp32) = (accumulate ? d : 0) + A . B, A (64 x 16 bf16) in
// registers as four packed pairs (see a_frag), B (16 x 64) in shared
// memory: MN-major with kTransB (one 128-byte swizzled box wide, so the
// descriptor's LBO is not read), K-major without
template <int kTransB>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : SM90_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate), "n"(kTransB));
}

#undef SM90_D32
#undef SM90_D8

// ------------------------------------------------- accumulator fragments

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the accumulator's 16-column block kk, rounded to bf16, as the register A
// operand of a k step: a[4 kk .. 4 kk + 3] (the m64k16 A fragment: for
// lane 4g + t of warp w, rows 16w + g and 16w + g + 8, columns 2t, 2t + 1
// and 2t + 8, 2t + 9 of the k step's 16)
template <int N>
__device__ __forceinline__ void a_frag(uint32_t* a, const float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// which of the thread's two rows (0: g, 1: g + 8) and which column of the
// m64nN accumulator register i holds, for lane = 4g + t
__device__ __forceinline__ constexpr int acc_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

// 2^x in one instruction (ex2(-inf) = 0; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the four lanes of a quad (the lanes holding one row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the m64nN accumulator (N = 2 * R: 128, or 64), times scale[half] and
// rounded to bf16, written into a [64, N] tile held as N / 64 swizzled
// boxes (64 rows each, the second half of d box_bytes after the first)
// starting at row 0 of tile: the layout a TMA store of the tile reads
template <int R>
__device__ __forceinline__ void store_acc_bf16(unsigned char* tile,
                                               uint32_t box_bytes,
                                               const float (&acc)[R],
                                               const float (&scale)[2],
                                               int warp, int g, int t) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(tile + (col >> 6) * box_bytes +
                                   swizzled(row, col & 63)) =
          pack_bf16(acc[4 * j + 2 * h] * scale[h],
                    acc[4 * j + 2 * h + 1] * scale[h]);
    }
  }
}

}  // namespace sm90
