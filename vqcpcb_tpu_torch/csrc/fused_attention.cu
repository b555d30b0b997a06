// Fused attention forward with an explicit bias, Hopper (sm_90a).
//
// Replaces: vqcpcb_tpu/ops/pallas_attention.py:_kernel (K4, the inference
// kernel behind fused_attention) and :_train_fwd_kernel (K6-fwd, the forward
// of the custom VJP fused_attention_train). Per (b, h) plane, p = b*H + h:
//
//   w[t]   = softmax_s( q_t.k_s + mask[t, s] + bias[p, t, s] )
//   out[t] = dropout(w[t]) . v
//
// The bias is a (B*H, T, S) f32 tensor read through strides: a (B*H, 1, 1)
// placeholder is read with zero strides, and no bias at all is a null
// pointer. The two TPU kernels differ only in their rounding, which the
// caller picks: K4 keeps q, k, v, the weights and both products in f32
// (f32 dots, pallas_attention.py:33-41); K6-fwd rounds q, k, v and the
// dropped weights to the dot type (bf16 on the card) before the products
// (:196-208). Products accumulate in f32, the row softmax is f32
// (exp(x - max) / sum), dropout scales the kept weights by 1/(1-rate) in f32
// with the counter-based hash of relbias_common.cuh on the stream
// seed + b*H + h (K6's program_id, :203-204; the relbias kernels use
// seed + h*B + b), and the output is stored in the input type.
//
// Two kernels, by the dot type, each with its own note on what bounds it
// and what its design does about that:
//  - bf16 dots (K6-fwd): fwd_mma::fwd_kernel of attention_fwd_mma.cuh --
//    exact f32 score chains, the full f32 score rows in shared memory, the
//    softmax in PyTorch's warp order, w.v on the tensor cores; its weights
//    equal the plain version's bit for bit.
//  - f32 dots (K4, and K6 with f32 dots): fwd_f32::fwd_kernel of
//    attention_fwd_f32.cuh -- K and V streamed in blocks of 64 keys, an
//    online softmax in registers, exact skipping of fully masked key
//    blocks, and both products in 3xTF32 on the tensor cores (f32
//    accuracy: within 1e-5 of the plain version).
#include "attention_fwd_f32.cuh"
#include "attention_fwd_mma.cuh"
#include "relbias_common.cuh"

using relbias::Bias;
using relbias::Layout;

extern "C" {

// q: (B, H, T, D) view, already scaled by D**-0.5; k, v: (B, H, S, D) views
// sharing one set of strides; out: a (B, H, T, D) view. `strides` holds 12
// element strides: (batch, head, row) for q, k/v and out, then the bias's
// (plane, row, column). mask: (T, S) f32, finite (-inf clamped to -1e30 by
// the caller); bias: (B*H, T, S) f32 read through its strides (zero strides
// for a broadcast placeholder), or null. in_bf16 selects bf16 (else f32) q,
// k, v and out; bf16_dots bf16 (else f32) rounding of the dot inputs and of
// the weights before w.v. dropout != 0 applies the hash mask with stream
// seed + b*H + h, the threshold min(round(rate * 2^32), 2^32 - 1) and the
// keep scale 1/(1-rate). Returns 0 when launched, -1 for an unsupported head
// dimension, -2 when a block does not fit in shared memory, else the
// cudaError_t of the launch.
int fused_attention_fwd(const void* q, const void* k, const void* v,
                        const float* mask, const float* bias, void* out,
                        const long long* strides, int B, int H, int T, int S,
                        int D, int in_bf16, int bf16_dots, uint32_t seed,
                        uint32_t threshold, float inv_keep, int dropout,
                        void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  const Layout lay[3] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]}};
  const Bias bv = {bias, strides[9], strides[10], strides[11]};
  cudaStream_t st = (cudaStream_t)stream;
  if (!bf16_dots) {
    if (in_bf16) {
      const fwd_f32::Args<__nv_bfloat16> a = {
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), mask, bv,
          static_cast<__nv_bfloat16*>(out), lay[0], lay[1], lay[2], B, H, T, S,
          1, 1, seed, threshold, inv_keep, dropout, 0};
      return fwd_f32::dispatch<__nv_bfloat16>(D, a, st);
    }
    const fwd_f32::Args<float> a = {
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, bv, static_cast<float*>(out),
        lay[0], lay[1], lay[2], B, H, T, S, 1, 1, seed, threshold, inv_keep,
        dropout, 0};
    return fwd_f32::dispatch<float>(D, a, st);
  }
  if (in_bf16) {
    const fwd_mma::FwdArgs<__nv_bfloat16> a = {
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, nullptr, bv,
        static_cast<__nv_bfloat16*>(out), lay[0], lay[1], lay[2], B, H, T, S,
        seed, threshold, inv_keep, dropout, 0};
    return fwd_mma::dispatch_fwd<__nv_bfloat16, false>(D, a, st);
  }
  const fwd_mma::FwdArgs<float> a = {
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, nullptr, bv, static_cast<float*>(out),
      lay[0], lay[1], lay[2], B, H, T, S, seed, threshold, inv_keep, dropout, 0};
  return fwd_mma::dispatch_fwd<float, false>(D, a, st);
}

}  // extern "C"
