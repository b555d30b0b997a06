// Relative-bias attention forward, Hopper (sm_90a).
//
// Replaces: vqcpcb_tpu/ops/pallas_attention.py:_relbias_fwd_kernel_packed
// (training, packed (B, L, H*d) layout) and :_relbias_fwd_kernel
// ((B*H, L, d) layout; the inference route reaches it through
// fused_attention at dropout 0), both computing _relbias_fwd_head. Per (b, h):
//
//   w[t]   = softmax_s( q_t.k_s + mask[t, s] + q_t.E[s + (S-1) - t/r] )
//   out[t] = dropout(w[t]) . v
//
// with E = [e1; e2[1:]] the combined (2S-1, d) table of head h and r = T/S.
// Rounding follows the TPU kernel: q, k, v and E are rounded to the dot type
// (bf16 by default) before the products, products accumulate in f32, the
// row softmax is f32 (exp(x - max) / sum), dropout scales the kept weights
// by 1/(1-rate) in f32, the weights are rounded to the dot type before w.v,
// and the output is stored in the input type (f32 or bf16). Dropout is the
// TPU kernel's counter-based hash (relbias_common.cuh), so the backward
// regenerates the same mask. One kernel reads any layout whose last axis is
// contiguous through per-tensor (batch, head, row) strides.
//
// Two kernels, by the dot type:
//  - bf16 dots (K2-fwd in training, K3-fwd at serving with f32 inputs):
//    fwd_mma::fwd_kernel of attention_fwd_mma.cuh -- exact f32 score and
//    bias chains in registers, the full f32 score rows in shared memory,
//    the softmax in PyTorch's warp order, w.v on the tensor cores, K, V and
//    the table window streamed in blocks of 64 keys. That header says what
//    bounds it and why its weights equal the plain version's bit for bit.
//  - f32 dots: relbias_fwd_kernel below, on the CUDA cores. One block of 8
//    warps per (b, h, tile of TQ query rows) stages K and V of its (b, h)
//    and the rows of E that its tile's shifts can address (S + (TQ-1)/r + 1
//    rows) in shared memory; each bias entry is an indexed read
//    E[s + shift(t)] (the TPU kernel's log-step lane rolls, _row_shift,
//    were a Mosaic workaround and have no counterpart here). Each warp takes
//    one query row at a time: lanes split the keys for the score row (q in
//    registers, q.k and q.E in one pass), keep the row in shared memory,
//    reduce max and sum with shuffles, drop the weights, then split the
//    head dimension for w.v. The query tile shrinks until the block fits
//    the card's shared memory; the launcher reports a shape that does not
//    fit even at one row.
#include "attention_fwd_mma.cuh"
#include "relbias_common.cuh"

namespace {

using namespace relbias;

template <typename In, typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
relbias_fwd_kernel(const In* __restrict__ q, const In* __restrict__ k,
                   const In* __restrict__ v, const float* __restrict__ mask,
                   const float* __restrict__ e, In* __restrict__ out,
                   Layout lq, Layout lkv, Layout lo, int B, int H, int T,
                   int S, int tile, uint32_t seed, uint32_t threshold,
                   float inv_keep, int dropout) {
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
  const In* qb = q + b * lq.b + h * lq.h;
  In* ob = out + b * lo.b + h * lo.h;
  const int shift_lo = (S - 1) - (t1 - 1) / ratio;   // smallest shift in the tile
  const float* eb = e + ((long long)h * (2 * S - 1) + shift_lo) * D;
  const int e_count = min(n_table, 2 * S - 1 - shift_lo);
  stage_kv_table<In, Elem, D>(k + b * lkv.b + h * lkv.h,
                              v + b * lkv.b + h * lkv.h, lkv.l, eb, e_count, S,
                              ks, vs, es);
  __syncthreads();

  const uint32_t key = stream_key(seed, h, b, B);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = rows + warp * S;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    float qr[D];
#pragma unroll
    for (int j = 0; j < D; ++j) qr[j] = DT::round(to_float(qb[t * lq.l + j]));
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
      const float score = __fadd_rn(__fadd_rn(acc_k, mrow[s]), acc_e);
      row[s] = score;
      m = fmaxf(m, score);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float p = expf(row[s] - m);
      row[s] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) {
      float w = row[s] / sum;
      if (dropout)
        w = dropout_keep(key, t, s, S, threshold) ? w * inv_keep : 0.f;
      row[s] = DT::round(w);
    }
    __syncwarp();

    for (int p = lane; p < D / 2; p += 32) {
      float ax = 0.f, ay = 0.f;
      for (int s = 0; s < S; ++s) {
        const float w = row[s];
        const float2 vv = DT::load2(vs + s * D + 2 * p);
        ax = fmaf(w, vv.x, ax);
        ay = fmaf(w, vv.y, ay);
      }
      In* o = ob + t * lo.l + 2 * p;
      o[0] = from_float<In>(ax);
      o[1] = from_float<In>(ay);
    }
    __syncwarp();   // the row buffer is rewritten by the next query row
  }
}

template <typename In, typename Elem, int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const float* e, void* out, const Layout* lay, int B, int H, int T,
           int S, uint32_t seed, uint32_t threshold, float inv_keep,
           int dropout, cudaStream_t stream) {
  size_t bytes = 0;
  const int tile = pick_tile<Elem>(S, D, T / S, 1, 0, &bytes);
  if (!tile) return kErrSharedMemory;
  cudaFuncSetAttribute(relbias_fwd_kernel<In, Elem, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  dim3 grid((T + tile - 1) / tile, H, B);
  relbias_fwd_kernel<In, Elem, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(k),
      static_cast<const In*>(v), mask, e, static_cast<In*>(out), lay[0],
      lay[1], lay[2], B, H, T, S, tile, seed, threshold, inv_keep, dropout);
  return (int)cudaGetLastError();
}

template <typename In, typename Elem>
int dispatch(int D, const void* q, const void* k, const void* v,
             const float* mask, const float* e, void* out, const Layout* lay,
             int B, int H, int T, int S, uint32_t seed, uint32_t threshold,
             float inv_keep, int dropout, cudaStream_t st) {
#define RELBIAS_FWD_CASE(DIM)                                                 \
  case DIM:                                                                   \
    return launch<In, Elem, DIM>(q, k, v, mask, e, out, lay, B, H, T, S,     \
                                 seed, threshold, inv_keep, dropout, st);
  switch (D) {
    RELBIAS_FWD_CASE(8)
    RELBIAS_FWD_CASE(16)
    RELBIAS_FWD_CASE(32)
    RELBIAS_FWD_CASE(64)
    RELBIAS_FWD_CASE(128)
    default: return kErrHeadDim;
  }
#undef RELBIAS_FWD_CASE
}

}  // namespace

extern "C" {

// q: (B, H, T, D) view, already scaled by D**-0.5; k, v: (B, H, S, D) views
// sharing one set of strides; out: a (B, H, T, D) view. `strides` holds 9
// element strides (batch, head, row) for q, k/v and out; the last axis of each
// is contiguous. mask: (T, S) f32, finite (-inf clamped to -1e30 by the
// caller); e: (H, 2S-1, D) f32, the combined table [e1; e2[1:]]. T % S == 0.
// in_bf16 selects bf16 (else f32) q, k, v and out; bf16_dots bf16 (else f32)
// rounding of the dot inputs (bf16 inputs need bf16 dots). dropout != 0
// applies the hash mask with stream seed + h*B + b, the threshold
// min(round(rate * 2^32), 2^32 - 1) and the keep scale 1/(1-rate). Returns 0
// when launched, -1 for an unsupported head dimension, -2 when K, V and the
// table do not fit in shared memory, -3 for bf16 inputs with f32 dots, else
// the cudaError_t of the launch.
int relbias_attention_fwd(const void* q, const void* k, const void* v,
                          const float* mask, const float* e, void* out,
                          const long long* strides, int B, int H, int T, int S,
                          int D, int in_bf16, int bf16_dots, uint32_t seed,
                          uint32_t threshold, float inv_keep, int dropout,
                          void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  const Layout lay[3] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]}};
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16 && !bf16_dots) return kErrDtype;
  if (!bf16_dots)
    return dispatch<float, float>(D, q, k, v, mask, e, out, lay, B, H, T, S,
                                  seed, threshold, inv_keep, dropout, st);
  if (in_bf16) {
    const fwd_mma::FwdArgs<__nv_bfloat16> a = {
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, e, {nullptr, 0, 0, 0},
        static_cast<__nv_bfloat16*>(out), lay[0], lay[1], lay[2], B, H, T, S,
        seed, threshold, inv_keep, dropout, 0};
    return fwd_mma::dispatch_fwd<__nv_bfloat16, true>(D, a, st);
  }
  const fwd_mma::FwdArgs<float> a = {
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, e, {nullptr, 0, 0, 0},
      static_cast<float*>(out), lay[0], lay[1], lay[2], B, H, T, S, seed,
      threshold, inv_keep, dropout, 0};
  return fwd_mma::dispatch_fwd<float, true>(D, a, st);
}

}  // extern "C"
