// Tensor-core pieces of the bf16-dot attention backward kernels
// (attention_bwd_mma.cuh, fused_attention_bwd.cu, relbias_attention_bwd.cu),
// as inline PTX for sm_90a:
//  - mma.sync.aligned.m16n8k16 on bf16 operands with f32 accumulation;
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
