// Relative-bias attention forward for inference, Hopper (sm_90a).
//
// Replaces: vqcpcb_tpu/ops/pallas_attention.py:_relbias_fwd_kernel (math in
// _relbias_fwd_head), which the inference route reaches through
// fused_attention -> fused_attention_train_relbias at dropout 0. Per (b, h):
//
//   out[t] = softmax_s( q_t.k_s + mask[t, s] + q_t.E[s + (S-1) - t/r] ) . v
//
// with E = [e1; e2[1:]] the combined (2S-1, d) table of head h and r = T/S.
// Rounding follows the TPU kernel: q, k, v and E are rounded to the dot type
// (bf16 by default) before the products, products accumulate in f32, the
// row softmax is f32 (exp(x - max) / sum), the weights are rounded to the dot
// type before w.v, and the output is stored in f32.
//
// What bounds it on the H100: at the decoder's self-attention (T = S = 384,
// d = 64) the three products are 3 * 2*T*S*d flops per (b, h) against
// 4 * T*d*4 bytes of q, k, v and out, about 96 flops per byte -- below the
// ~295 at which the bf16 tensor cores become the limit, so the bound is the
// bytes (0.48 ms at batch 512, 8 heads). This first version runs the
// products on the CUDA cores (no wgmma, no TMA), so it is bound by its
// shared-memory loads and FMAs instead, well above that bound.
//
// Design: one block of 8 warps per (b, h, tile of TQ query rows). The block
// stages K and V of its (b, h) in shared memory in the dot type, and the rows
// of E that its tile's shifts can address (S + (TQ-1)/r + 1 rows) beside
// them: each bias entry is then an indexed read E[s + shift(t)] of shared
// memory -- the TPU kernel's log-step lane rolls (_row_shift) were a Mosaic
// workaround and have no counterpart here. K and E rows are padded by one
// 32-bit word so lanes reading 32 different rows hit 32 different banks.
// Each warp takes one query row at a time: lanes split the keys for the
// score row (q in registers, q.k and q.E in one pass), keep the row in
// shared memory, reduce max and sum with shuffles, round the weights, then
// split the head dimension for w.v. The query tile shrinks until the block
// fits the card's shared memory; the launcher reports a shape that does not
// fit even at one row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 64;

enum : int { kErrHeadDim = -1, kErrSharedMemory = -2 };

template <typename Elem> struct Dot;

template <> struct Dot<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return make_float2(p[0], p[1]);
  }
  static constexpr int kPad = 1;   // elements: one 32-bit word
};

template <> struct Dot<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static constexpr int kPad = 2;   // elements: one 32-bit word
};

__host__ __device__ inline int table_rows(int S, int tile, int ratio) {
  return S + (tile - 1) / ratio + 1;
}

template <typename Elem>
__host__ __device__ inline size_t smem_bytes(int S, int D, int tile, int ratio) {
  const int stride = D + Dot<Elem>::kPad;
  return sizeof(Elem) * ((size_t)S * stride + (size_t)S * D +
                      (size_t)table_rows(S, tile, ratio) * stride) +
         sizeof(float) * (size_t)kWarps * S;
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
relbias_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ mask,
                   const float* __restrict__ e, float* __restrict__ out,
                   int H, int T, int S, int tile) {
  using DT = Dot<Elem>;
  constexpr int kStride = D + DT::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* ks = reinterpret_cast<Elem*>(smem_raw);
  Elem* vs = ks + (size_t)S * kStride;
  Elem* es = vs + (size_t)S * D;
  const int ratio = T / S;
  const int n_table = table_rows(S, tile, ratio);
  float* rows = reinterpret_cast<float*>(es + (size_t)n_table * kStride);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * tile;
  const int t1 = min(t0 + tile, T);
  const long long bh = (long long)b * H + h;
  const float* qb = q + bh * T * D;
  const float* kb = k + bh * S * D;
  const float* vb = v + bh * S * D;
  const int shift_lo = (S - 1) - (t1 - 1) / ratio;   // smallest shift in the tile
  const float* eb = e + ((long long)h * (2 * S - 1) + shift_lo) * D;
  const int e_count = min(n_table, 2 * S - 1 - shift_lo);

  for (int i = threadIdx.x; i < S * D; i += kThreads) {
    const int s = i / D, j = i - s * D;
    ks[s * kStride + j] = DT::store(__ldg(kb + i));
    vs[i] = DT::store(__ldg(vb + i));
  }
  for (int i = threadIdx.x; i < e_count * D; i += kThreads) {
    const int s = i / D, j = i - s * D;
    es[s * kStride + j] = DT::store(__ldg(eb + i));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = rows + warp * S;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    float qr[D];
#pragma unroll
    for (int j = 0; j < D; ++j) qr[j] = DT::round(__ldg(qb + (long long)t * D + j));
    const int shift = (S - 1) - t / ratio - shift_lo;   // local table offset
    const float* mrow = mask + (long long)t * S;

    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) {
      const Elem* kr = ks + s * kStride;
      const Elem* er = es + (s + shift) * kStride;
      float acc_k = 0.f, acc_e = 0.f;
#pragma unroll
      for (int j = 0; j < D; j += 2) {
        const float2 kk = DT::load2(kr + j);
        const float2 ee = DT::load2(er + j);
        acc_k = fmaf(qr[j], kk.x, acc_k);
        acc_k = fmaf(qr[j + 1], kk.y, acc_k);
        acc_e = fmaf(qr[j], ee.x, acc_e);
        acc_e = fmaf(qr[j + 1], ee.y, acc_e);
      }
      const float score = __fadd_rn(__fadd_rn(acc_k, __ldg(mrow + s)), acc_e);
      row[s] = score;
      m = fmaxf(m, score);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float p = expf(row[s] - m);
      row[s] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int s = lane; s < S; s += 32) row[s] = DT::round(row[s] / sum);
    __syncwarp();

    for (int p = lane; p < D / 2; p += 32) {
      float ax = 0.f, ay = 0.f;
      for (int s = 0; s < S; ++s) {
        const float w = row[s];
        const float2 vv = DT::load2(vs + s * D + 2 * p);
        ax = fmaf(w, vv.x, ax);
        ay = fmaf(w, vv.y, ay);
      }
      float* o = out + (bh * T + t) * D + 2 * p;
      o[0] = ax;
      o[1] = ay;
    }
    __syncwarp();   // the row buffer is rewritten by the next query row
  }
}

template <typename Elem, int D>
int launch(const float* q, const float* k, const float* v, const float* mask,
           const float* e, float* out, int B, int H, int T, int S,
           cudaStream_t stream) {
  int device = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  const int ratio = T / S;
  int tile = kMaxTile;
  while (tile > 1 && smem_bytes<Elem>(S, D, tile, ratio) > (size_t)max_smem)
    tile >>= 1;
  const size_t bytes = smem_bytes<Elem>(S, D, tile, ratio);
  if (bytes > (size_t)max_smem) return kErrSharedMemory;
  cudaFuncSetAttribute(relbias_fwd_kernel<Elem, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  dim3 grid((T + tile - 1) / tile, H, B);
  relbias_fwd_kernel<Elem, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, mask, e, out, H, T, S, tile);
  return (int)cudaGetLastError();
}

template <typename Elem>
int dispatch(int D, const float* q, const float* k, const float* v,
             const float* mask, const float* e, float* out, int B, int H,
             int T, int S, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<Elem, 8>(q, k, v, mask, e, out, B, H, T, S, stream);
    case 16: return launch<Elem, 16>(q, k, v, mask, e, out, B, H, T, S, stream);
    case 32: return launch<Elem, 32>(q, k, v, mask, e, out, B, H, T, S, stream);
    case 64: return launch<Elem, 64>(q, k, v, mask, e, out, B, H, T, S, stream);
    case 128: return launch<Elem, 128>(q, k, v, mask, e, out, B, H, T, S, stream);
    default: return kErrHeadDim;
  }
}

}  // namespace

extern "C" {

// q: (B, H, T, D) f32, already scaled by D**-0.5; k, v: (B, H, S, D) f32;
// mask: (T, S) f32, finite (-inf clamped to -1e30 by the caller);
// e: (H, 2S-1, D) f32, the combined table [e1; e2[1:]]; out: (B, H, T, D)
// f32. All contiguous on the device; T % S == 0. bf16_dots selects bf16 or
// f32 rounding of the dot inputs. Returns 0 when launched, -1 for an
// unsupported head dimension, -2 when K, V and the table do not fit in shared
// memory, else the cudaError_t of the launch.
int relbias_attention_fwd(const float* q, const float* k, const float* v,
                          const float* mask, const float* e, float* out,
                          int B, int H, int T, int S, int D, int bf16_dots,
                          void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_dots
             ? dispatch<__nv_bfloat16>(D, q, k, v, mask, e, out, B, H, T, S, st)
             : dispatch<float>(D, q, k, v, mask, e, out, B, H, T, S, st);
}

}  // extern "C"
