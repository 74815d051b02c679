// Hopper (sm_90a) building blocks shared by the port's kernels: TMA tile
// loads and 1-D bulk copies that complete on an mbarrier, TMA tile stores,
// the mbarrier itself, and bf16 wgmma on 128-byte-swizzled shared-memory
// tiles with A from shared memory (SS) or from registers (RS). Inline PTX
// only, so a source that includes this header still builds in seconds.
//
// Tiles: every operand tile here is rows of 64 bf16 (128 bytes: one swizzle
// row), written by TMA with CU_TENSOR_MAP_SWIZZLE_128B at a 1024-byte
// aligned address (8 rows = one 1024-byte swizzle atom). wgmma reads such a
// tile
//  - K-major (the product's depth runs along the 128-byte row): descriptor
//    at the tile, SBO 1024 bytes (the next 8 rows); the k-th step of 16
//    elements starts 32 bytes further (`desc + 2 * k`, in 16-byte units),
//    the hardware applying the swizzle to the address it forms;
//  - MN-major (the depth runs down the rows, the transpose bit set; an A or
//    a B operand): the 64-wide output dimension is the one 128-byte row,
//    and the k-th step of 16 rows starts 16 * 128 bytes further (`desc +
//    128 * k`); the two 8-row groups of a step are SBO = 1024 bytes apart.
//    LBO is the stride between 64-element panels of the output dimension:
//    unused at width 64 (set to the same 1024), the panel's bytes for a
//    wider product whose operand is stored as consecutive 64-column panels
//    (`desc_mnmajor_panels`).
// Accumulator layout of m64nNk16 (f32, N / 2 registers a thread): warp w of
// the warpgroup owns rows 16 w .. 16 w + 15; lane (g = lane / 4, t = lane %
// 4) holds d[4 j + e] at row 16 w + g + 8 (e >= 2), column 8 j + 2 t + (e & 1).
// An RS A fragment (64 x 16 bf16, 4 registers of two) has the same row and
// column map as mma.sync's m16n8k16 A, so the accumulator of a 64-wide
// product turns into the four k-steps' A fragments by packing pairs
// (`acc_to_a`), as FlashAttention-3 does.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- device side ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 1024-byte aligned start of dynamic shared memory (128-byte swizzle atoms).
__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier to wait for `bytes` of TMA traffic.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `phase` has completed. A barrier starts in
// phase 0; waiting on parity 1 before any phase completed returns at once,
// which is how a producer passes its first round of "empty" waits.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  }
}

// TMA: one thread asks for a box of the tensor map at the given coordinates
// (innermost first); the bytes are credited to `bar` on arrival. Elements
// outside the tensor read as zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A 1-D bulk copy (no tensor map): `bytes` contiguous bytes from global memory
// to shared memory, credited to `bar` on arrival. Both addresses and the size
// must be multiples of 16 bytes.
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// TMA store: one thread writes a box of shared memory to the tensor map at the
// given coordinates; elements outside the tensor are not written. Stores are
// tracked per issuing thread in bulk groups: `bulk_commit` closes a group,
// `bulk_wait_read<N>` waits until at most N groups still read shared memory,
// `bulk_wait<N>` until at most N are still writing.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes visible to the async proxy (a TMA
// store that reads them next).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of the 16-byte chunk `chunk` (0..7) of row `row` in a tile of
// 128-byte rows written or read by TMA with the 128-byte swizzle (1024-byte
// aligned): the chunk index is XORed with the row's place in its 8-row atom.
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Synchronises the `count` threads (whole warps) that name barrier `id` (1..15;
// 0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Arrives on named barrier `id` without waiting (a `named_barrier` of the
// same id and count is the other side).
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (see the top).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 |
         1ull << 62;  // layout type 1: 128-byte swizzle
}
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) {
  return desc_sw128(tile, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile) {
  return desc_sw128(tile, 1024, 1024);
}
// An MN-major operand wider than 64: 64-column panels `panel_bytes` apart.
__device__ __forceinline__ uint64_t desc_mnmajor_panels(const void* tile, uint32_t panel_bytes) {
  return desc_sw128(tile, panel_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait that orders them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for register A fragments that an asynchronous RS wgmma reads:
// they stay live, and unchanged, until the wait that this follows.
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

#define HOPPER_D32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (64 x 64 f32) (+)= A (64 x 16, shared) . B (16 x 64, shared); scale_d = 0
// overwrites d. TA / TB: the transpose bits (0: K-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : HOPPER_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers: see the top) . B (16 x 64, shared).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TB));
}

#define HOPPER_D64(d)                                                                      \
  HOPPER_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),        \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),        \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128 f32) (+)= A (64 x 16, shared) . B (16 x 128, shared), as the
// m64n64k16 product above; an MN-major B of width 128 is two 64-column panels
// (`desc_mnmajor_panels`).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : HOPPER_D64(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

#undef HOPPER_D64
#undef HOPPER_D32

// 2^x by the special-function unit alone (results below 2^-126 flush to 0,
// which a softmax over a row normalised by its max never notices).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16 pair, `lo` in the low half (round to nearest even).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The accumulator of a 64 x 64 product (32 floats) as the A fragments of its
// four k-steps of 16 columns, rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k][0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
    a[k][1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
    a[k][2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
    a[k][3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
  }
}

// ---- host side --------------------------------------------------------------------

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so that
// a library using it links against libcudart only.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tiled tensor map of `rank` dimensions (innermost first): `dims` elements,
// `strides` the byte strides of dimensions 1.. (none for rank 1), `box` the
// tile in elements. Out-of-range elements load as zero.
inline cudaError_t make_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                   const void* base, const uint64_t* dims,
                                   const uint64_t* strides, const uint32_t* box,
                                   CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], s[4] = {0, 0, 0, 0};
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), d, s,
                        b, e, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
