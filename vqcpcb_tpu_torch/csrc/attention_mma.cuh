// Tensor-core pieces of the attention kernels (attention_bwd_mma.cuh,
// attention_fwd_mma.cuh, attention_fwd_f32.cuh), as inline PTX for sm_90a:
//  - mma.sync.aligned.m16n8k16 on bf16 operands with f32 accumulation;
//  - wgmma.mma_async m64nNk8 on tf32 operands with f32 accumulation (A in
//    registers, B by a shared-memory descriptor), and the split of an f32
//    value into two tf32 halves for 3xTF32 products;
//  - ldmatrix (x4, plain and .trans) loading the operand fragments of a
//    16 x 16 A tile (stored as it is or transposed) or of two 16 x 8 B
//    tiles from shared memory;
//  - cp.async staging of 16-byte chunks (bf16 inputs), or loads converted
//    to bf16 (f32 inputs), into row-padded shared tiles;
//  - the repacking of two f32 accumulator tiles (16 x 8) into one bf16 A
//    fragment (16 x 16), so a product's result feeds the next product
//    without leaving registers.
// Fragment layout of m16n8k16 (lane = 4 * g + c): A holds rows g and g + 8,
// columns 2c, 2c+1 and 2c+8, 2c+9; B holds k rows 2c, 2c+1 and 2c+8, 2c+9 of
// column g; the accumulator holds rows g and g + 8, columns 2c and 2c+1.
// Fragment layout of m16n8k8 tf32 (and of each warp's 16 rows of a wgmma
// m64nNk8 A operand): A holds rows g and g + 8 of columns c (a0, a1) and
// c + 4 (a2, a3); the accumulator is m16n8k16's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

// Shared tiles are bf16 rows of a head dim padded to a multiple of 16
// (zeros beyond it add nothing to a product) plus 8 elements: the 16-byte
// rows that one ldmatrix reads then fall in 8 different bank quads.
constexpr int kPad = 8;
template <int D> struct Dims {
  static constexpr int kDot = D < 16 ? 16 : D;    // head dim in the products
  static constexpr int kRow = kDot + kPad;        // elements per shared row
  static constexpr int kChunks = kDot / 8;        // 16-byte chunks per row
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a . b, one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero) as
// the 32-bit pattern the tensor cores read.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 relative: hi = tf32(x), lo = tf32(x - hi)
// (x - hi is exact in f32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// ---- wgmma (sm_90a): a warpgroup's 64-row products, B in shared memory ----
// Descriptor of a K-major shared tile without swizzle: core matrices of 8
// rows x 16 bytes (128 contiguous bytes), `lbo` bytes between core matrices
// adjacent along K, `sbo` bytes between adjacent groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// Before a wgmma whose registers (A, accumulators) ordinary code wrote.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every committed wgmma group has completed.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory writes by ordinary stores, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += a . b, m64nNk8 on tf32 operands with f32 sums: a in registers (each
// warp its 16 rows in the A layout of m16n8k8), b (N x 8, K-major) by its
// descriptor; d in the accumulator layout of m16n8k8 repeated over N / 8
// column tiles (d[4j .. 4j + 3] for columns 8j .. 8j + 7).
template <int N> struct WgmmaTf32;
template <> struct WgmmaTf32<8> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WgmmaTf32<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WgmmaTf32<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WgmmaTf32<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WgmmaTf32<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A fragment of the 16 x 16 tile at (row0, col0) of a row-major tile with
// `ld` elements per row: A[m][k] = tile[row0 + m][col0 + k].
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int row0, int col0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, smem_addr(tile + (row0 + (lane & 15)) * ld + col0 +
                           (lane >> 4) * 8));
}

// A fragment of a transposed tile: A[m][k] = tile[k0 + k][m0 + m].
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4],
                                             const __nv_bfloat16* tile, int ld,
                                             int k0, int m0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(a, smem_addr(tile + (k0 + (lane & 7) + (lane >> 4) * 8) * ld +
                                 m0 + ((lane >> 3) & 1) * 8));
}

// B fragments of the two n-tiles n0 and n0 + 8 over k0..k0+15 of a tile
// that stores B as it is, B[k][n] = tile[k][n]: b[0], b[1] for n0 and b[2],
// b[3] for n0 + 8.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const __nv_bfloat16* tile, int ld,
                                             int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, smem_addr(tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                     ld + n0 + (lane >> 4) * 8));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two accumulator tiles (columns 0-7 and 8-15 of a 16 x 16 block), rounded
// to bf16, as the A fragment of that block.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 16-byte chunk (8 elements) of a staged row: bf16 sources by cp.async,
// f32 sources loaded and rounded to bf16 (round to nearest even, the
// rounding of every dot-type conversion here).
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src) {
  cp_async16(dst, src);
}

__device__ __forceinline__ void stage_chunk(__nv_bfloat16* dst,
                                            const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  const float4 y = *reinterpret_cast<const float4*>(src + 4);
  uint4 v;
  v.x = pack_bf16(x.x, x.y);
  v.y = pack_bf16(x.z, x.w);
  v.z = pack_bf16(y.x, y.y);
  v.w = pack_bf16(y.z, y.w);
  *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ void zero_chunk(__nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Stage `rows` rows of head dim D (row r at src + (first + r) * stride)
// into a padded tile; rows outside [0, valid) and columns from D up to the
// padded head dim are zeros. All threads of the block take part.
template <int D, int kThreads, typename In>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile,
                                           const In* __restrict__ src,
                                           long long stride, int first,
                                           int rows, int valid) {
  using Dm = Dims<D>;
  for (int i = threadIdx.x; i < rows * Dm::kChunks; i += kThreads) {
    const int r = i / Dm::kChunks, ch = i - r * Dm::kChunks;
    __nv_bfloat16* dst = tile + r * Dm::kRow + ch * 8;
    const int row = first + r;
    if (row >= 0 && row < valid && ch * 8 < D)
      stage_chunk(dst, src + row * stride + ch * 8);
    else
      zero_chunk(dst);
  }
}

// True when every staged row of a view starts on 16 bytes: the base and
// each of its element strides (batch, head, row) aligned.
template <typename In>
inline bool rows_aligned(const void* p, long long sb, long long sh,
                         long long sl) {
  const long long step = 16 / sizeof(In);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % step == 0 &&
         sh % step == 0 && sl % step == 0;
}

}  // namespace mma
