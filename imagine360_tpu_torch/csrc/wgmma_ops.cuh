// Primitives of the Hopper GEMM of K7 (dense_matmul.cu,
// dense_matmul_wgmma_kernel) and of the biased D = 32 attention body of K3,
// K6a and K6b (attn_wgmma_bias.cuh), beside those of attn_wgmma.cuh that they share
// (mbarriers, 3-D and 4-D TMA copies, wgmma fences and waits, m64n128k16,
// ex2.approx.ftz, the tensor-map encoder): 2-D TMA copies; TMA stores that
// return before the shared memory has been read (bulk groups committed and
// waited for apart, so a tile's stores overlap the next tile's products);
// descriptors of 64-byte-swizzled tiles (rows of 64 bytes: D = 32 bf16, or
// 32 output columns); and the warpgroup products of the widths these two
// kernels take. Raw PTX, no CUTLASS or CuTe header.
#pragma once

#include "attn_wgmma.cuh"

namespace i360 {

constexpr int kWgSmemLimit = 232448;   // the shared memory a block may have on sm_90

// One box of a 2-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One box from shared memory to a 2-D (3-, 4-, 5-D) tensor map, rows outside it
// clipped, in this thread's open bulk group: bulk_commit closes the group,
// bulk_wait_read<N> waits until at most N groups still read shared memory.
__device__ __forceinline__ void tma_store_2d_async(const CUtensorMap* map, uint32_t src, int c0,
                                                   int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"((uint64_t)map), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_3d_async(const CUtensorMap* map, uint32_t src, int c0,
                                                   int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"((uint64_t)map), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d_async(const CUtensorMap* map, uint32_t src, int c0,
                                                   int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"((uint64_t)map), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_5d_async(const CUtensorMap* map, uint32_t src, int c0,
                                                   int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], "
      "[%1];\n" ::"l"((uint64_t)map), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until every committed store has been written (before the block ends).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The `n` threads that take named barrier `id` (1..15; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Descriptor of a 64-byte-swizzled tile of 64-byte rows at shared address
// `addr` (512-byte aligned for the pattern, or advanced within a row by a
// k-step): 8-row groups 512 bytes apart (SBO), LBO unused (1), layout type
// 2 (64-byte swizzle). It serves a K-major operand of 32 bf16 (Q and K at
// D = 32: 32 bytes a k-step) and an MN-major one 32 columns wide (V at
// D = 32: 16 key rows, 1024 bytes, a k-step).
__device__ __forceinline__ uint64_t wg_desc64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

// d (+)= a·b for one m64n64k16 step, a and b from shared memory, K-major
// (TA, TB 0) or MN-major (1: the transpose bit); scale_d 0: d = a·b.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= a·b for one m64n160k16 step, a and b from shared memory, K-major
// (TA, TB 0) or MN-major (1: the transpose bit); scale_d 0: d = a·b.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n160(float (&d)[80], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, %83, %84;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d += a·b for one m64n32k16 step: a the bf16 A fragment in registers, b
// from shared memory MN-major (TB 1: the transpose bit) or K-major (0).
template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// d (+)= a·b for one m64nNk16 step, both from shared memory, K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 160, "a width a kernel takes");
  if constexpr (N == 64) wgmma_ss_n64<0, 0>(d, da, db, scale_d);
  else if constexpr (N == 128) wgmma_qk<0, 0>(d, da, db, scale_d);
  else wgmma_ss_n160<0, 0>(d, da, db, scale_d);
}

// d (+)= a·b for one m64nNk16 step, both from shared memory, MN-major (the
// transpose bits: the sequence-minor Q and K of attn_wgmma_bias.cuh).
template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t da, uint64_t db,
                                            int scale_d) {
  static_assert(N == 64 || N == 128, "a width a kernel takes");
  if constexpr (N == 64) wgmma_ss_n64<1, 1>(d, da, db, scale_d);
  else wgmma_qk<1, 1>(d, da, db, scale_d);
}

// A bf16 or float32 map of a row-major [rows, cols] matrix (row stride
// cols elements): dims {cols, rows}, boxes {b0, b1}.
inline bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, int itemsize,
                        const void* ptr, long rows, long cols, int b0, int b1,
                        CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * itemsize};
  const cuuint32_t box[2] = {(cuuint32_t)b0, (cuuint32_t)b1};
  return encode_map(map, type, ptr, 2, dims, strides, box, swizzle);
}

}  // namespace i360
