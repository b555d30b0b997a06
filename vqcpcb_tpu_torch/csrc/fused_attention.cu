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
// What bounds it on the H100: per plane 2 T x S x d products against q, k,
// v and out (and a real bias's T*S f32 values). K4's products are f32, so
// at T = S = 384, d = 64 its 4*T*S*d flops per plane (about 2.3 ms at
// B = 4096 planes) over the 67 TFLOP/s f32 rate outweigh its bytes (about
// 0.5 ms at 3.35 TB/s): it is bound by operations. K6-fwd's bf16 products
// sit below the tensor cores' ridge of ~295 flops per byte (about 190 here),
// so its bound is its bytes.
//
// Two kernels, by the dot type:
//  - bf16 dots (K6-fwd): fwd_mma::fwd_kernel of attention_fwd_mma.cuh --
//    exact f32 score chains in registers, the full f32 score rows in shared
//    memory, the softmax in PyTorch's warp order, w.v on the tensor cores,
//    K and V streamed in blocks of 64 keys, fully masked key blocks skipped
//    where that is exact. That header says why its weights equal the plain
//    version's bit for bit.
//  - f32 dots (K4, and K6 with f32 dots): fused_fwd_kernel below, the
//    relative-bias forward's f32 kernel (relbias_attention.cu) without the
//    table. One block of 8 warps per (b, h, tile of 64 query rows) stages K
//    (rows padded by one word against bank conflicts) and V of its plane in
//    shared memory; each warp takes one query row at a time: lanes split
//    the keys for the score row (q in registers), keep the row in shared
//    memory, reduce max and sum with shuffles, drop the weights, then split
//    the head dimension for w.v. At S = 384, d = 64 the block takes 210 KB
//    of shared memory; the launcher reports a shape that does not fit.
#include "attention_fwd_mma.cuh"
#include "relbias_common.cuh"

namespace {

using namespace relbias;

// K (padded rows) and V in the dot type, and one f32 score row per warp.
template <typename Elem>
size_t smem_bytes(int S, int D) {
  return sizeof(Elem) * ((size_t)S * (D + Dot<Elem>::kPad) + (size_t)S * D) +
         sizeof(float) * (size_t)kWarps * S;
}

template <typename In, typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const In* __restrict__ q, const In* __restrict__ k,
                 const In* __restrict__ v, const float* __restrict__ mask,
                 Bias bias, In* __restrict__ out, Layout lq, Layout lkv,
                 Layout lo, int H, int T, int S, uint32_t seed,
                 uint32_t threshold, float inv_keep, int dropout) {
  using DT = Dot<Elem>;
  constexpr int kStride = D + DT::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* ks = reinterpret_cast<Elem*>(smem_raw);
  Elem* vs = ks + (size_t)S * kStride;
  float* rows = reinterpret_cast<float*>(vs + (size_t)S * D);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kMaxTile;
  const int t1 = min(t0 + kMaxTile, T);
  const int plane = b * H + h;
  const In* qb = q + b * lq.b + h * lq.h;
  In* ob = out + b * lo.b + h * lo.h;
  stage_kv_table<In, Elem, D>(k + b * lkv.b + h * lkv.h,
                              v + b * lkv.b + h * lkv.h, lkv.l, nullptr, 0, S,
                              ks, vs, nullptr);
  __syncthreads();

  const uint32_t key = plane_key(seed, plane);
  const float* bp = bias.p ? bias.p + plane * bias.bh : nullptr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = rows + warp * S;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    float qr[D];
#pragma unroll
    for (int j = 0; j < D; ++j) qr[j] = DT::round(to_float(qb[t * lq.l + j]));
    const float* mrow = mask + (long long)t * S;
    const float* brow = bp ? bp + t * bias.t : nullptr;

    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) {
      const Elem* kr = ks + s * kStride;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < D; j += 2) {
        const float2 kk = DT::load2(kr + j);
        acc = fmaf(qr[j], kk.x, acc);
        acc = fmaf(qr[j + 1], kk.y, acc);
      }
      float score = __fadd_rn(acc, mrow[s]);
      if (brow) score = __fadd_rn(score, brow[s * bias.s]);
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
           Bias bias, void* out, const Layout* lay, int B, int H, int T,
           int S, uint32_t seed, uint32_t threshold, float inv_keep,
           int dropout, cudaStream_t stream) {
  int device = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  const size_t bytes = smem_bytes<Elem>(S, D);
  if (bytes > (size_t)max_smem) return kErrSharedMemory;
  cudaFuncSetAttribute(fused_fwd_kernel<In, Elem, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  dim3 grid((T + kMaxTile - 1) / kMaxTile, H, B);
  fused_fwd_kernel<In, Elem, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(k),
      static_cast<const In*>(v), mask, bias, static_cast<In*>(out), lay[0],
      lay[1], lay[2], H, T, S, seed, threshold, inv_keep, dropout);
  return (int)cudaGetLastError();
}

template <typename In, typename Elem>
int dispatch(int D, const void* q, const void* k, const void* v,
             const float* mask, Bias bias, void* out, const Layout* lay,
             int B, int H, int T, int S, uint32_t seed, uint32_t threshold,
             float inv_keep, int dropout, cudaStream_t st) {
#define FUSED_FWD_CASE(DIM)                                                   \
  case DIM:                                                                   \
    return launch<In, Elem, DIM>(q, k, v, mask, bias, out, lay, B, H, T, S,  \
                                 seed, threshold, inv_keep, dropout, st);
  switch (D) {
    FUSED_FWD_CASE(8)
    FUSED_FWD_CASE(16)
    FUSED_FWD_CASE(32)
    FUSED_FWD_CASE(64)
    FUSED_FWD_CASE(128)
    default: return kErrHeadDim;
  }
#undef FUSED_FWD_CASE
}

}  // namespace

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
// dimension, -2 when K and V do not fit in shared memory, else the
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
#define FUSED_FWD_ARGS                                                        \
  D, q, k, v, mask, bv, out, lay, B, H, T, S, seed, threshold, inv_keep,     \
      dropout, st
  if (!bf16_dots)
    return in_bf16 ? dispatch<__nv_bfloat16, float>(FUSED_FWD_ARGS)
                   : dispatch<float, float>(FUSED_FWD_ARGS);
#undef FUSED_FWD_ARGS
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
