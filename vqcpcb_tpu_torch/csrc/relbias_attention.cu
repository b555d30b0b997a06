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
//  - f32 dots (VQCPCB_PALLAS_BF16_DOTS=0): fwd_f32::fwd_kernel of
//    attention_fwd_f32.cuh with the relative bias (kRel) -- K and V
//    streamed in blocks of 64 keys, the rows of E that a (query tile, key
//    block) pair addresses (at most 127) put through the same 3xTF32
//    tensor-core product as K into a bias tile that the scores read
//    skewed, an online softmax in registers, exact skipping of dead key
//    blocks; within 1e-5 of the plain version. Its shared memory does not
//    grow with S: the CUDA-core kernel it replaced staged K, V and the
//    table window of a whole (b, h) plane and refused S > 287 (f32,
//    d = 64), the flagship's T = S = 384 among them. That header says what
//    bounds it.
#include "attention_fwd_f32.cuh"
#include "attention_fwd_mma.cuh"
#include "relbias_common.cuh"

using relbias::Layout;

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
// when launched, -1 for an unsupported head dimension, -2 when the bf16-dot
// kernel's score rows do not fit in shared memory (S > 4096; the f32-dot
// kernel's shared memory does not grow with S), -3 for bf16 inputs with f32
// dots, else the cudaError_t of the launch.
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
  if (in_bf16 && !bf16_dots) return relbias::kErrDtype;
  if (!bf16_dots) {
    fwd_f32::Args<float> a = {
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, {nullptr, 0, 0, 0},
        static_cast<float*>(out), lay[0], lay[1], lay[2], B, H, T, S, 1, 1,
        seed, threshold, inv_keep, dropout, 0, e};
    return fwd_f32::dispatch<float, true>(D, a, st);
  }
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
