// Fused attention backward with an explicit bias, Hopper (sm_90a).
//
// Replaces: vqcpcb_tpu/ops/pallas_attention.py:_train_bwd_kernel (K6-bwd,
// a real (B*H, T, S) bias, whose cotangent is the score gradient ds) and
// :_train_bwd_kernel_nobias (K6-bwd-nobias, the (B*H, 1, 1) zero
// placeholder, whose cotangent is zero), the backward of the custom VJP
// fused_attention_train. Per (b, h) plane p = b*H + h, with the forward's
// scores, softmax w and dropout mask (stream seed + b*H + h) regenerated:
//
//   dw = keep * (do . v^T) / (1-rate)      ds = w * (dw - sum_s dw*w)
//   dq = ds . k      dk = ds^T . q         dv = w_drop^T . do
//   dbias[p] = ds (K6-bwd only)            dmask += ds over (b, h), on request
//
// Rounding follows the TPU kernels (:214-241): q, k, v and do are rounded to
// the dot type before the products, w_drop before dv and ds before dq and
// dk; the scores, the softmax, the dropout and ds stay f32, and dbias and
// dmask are the f32 ds. The two TPU kernels share all of their arithmetic;
// here they are one template that writes ds to dbias or does not.
//
// dmask: the TPU accumulates it over its sequential grid into one (T, S)
// block (:273-281). CUDA blocks run concurrently, so it is added with f32
// atomics, and only when the caller asks (a mask that requires a gradient;
// the model's masks are constants, so the main path never does).
//
// What bounds it on the H100: five T x S x d products per plane (q.k, do.v,
// ds.k, ds^T.q, w_drop^T.do) against q, k, v, do in and dq, dk, dv out --
// about 270 flops per bf16 byte at T = S = 384, d = 64, just below the
// tensor cores' ridge of ~295, so its bytes bound it, narrowly (0.027 ms at
// B = 32, H = 8); K6-bwd also writes the B*H*T*S f32 values of dbias
// (0.117 ms).
//
// bf16 dots (every training call on the card): the tensor-core rows and
// cols kernels of attention_bwd_mma.cuh, whose note gives the design.
// f32 dots (VQCPCB_PALLAS_BF16_DOTS=0): the rows kernel of
// attention_bwd_f32.cuh (K and V streamed through shared memory in blocks
// of 64 keys, the score rows in the (B, H, T, S) f32 scratch, ds and w_drop
// written there, dq a second sweep over the key blocks; it replaces a
// kernel that staged K, V and two score rows of S per warp and refused
// S > 397 at d = 64, S > 209 at d = 128), then the cols kernel
// (attention_bwd_cols.cuh): dk and dv per (b, h, 32 keys). Neither one's
// shared memory grows with S.
#include "attention_bwd_cols.cuh"
#include "attention_bwd_f32.cuh"
#include "attention_bwd_mma.cuh"

namespace {

using namespace relbias;

// f32 dots: the streamed rows kernel, then the cols kernel.
template <int D, bool kWriteBias>
int launch_f32(const float* q, const float* k, const float* v,
               const float* mask, Bias bias, const float* dout, float* dq,
               float* dk, float* dv, float* dbias, float* dmask, float* ds,
               float* wd, const Layout* lay, int B, int H, int T, int S,
               uint32_t seed, uint32_t threshold, float inv_keep, int dropout,
               cudaStream_t stream) {
  const bwd_f32::RowsArgs a = {q, k, v, mask, nullptr, bias, dout, dq, ds,
                               wd, dbias, dmask, lay[0], lay[1], lay[2],
                               lay[3], B, H, T, S, seed, threshold, inv_keep,
                               dropout};
  const int err = bwd_f32::launch_rows<D, false, kWriteBias>(a, stream);
  if (err) return err;
  return launch_cols_f32<D>(q, dout, ds, wd, dk, dv, lay[0], lay[2], lay[4],
                            B, H, T, S, stream);
}

// bf16 dots: the tensor-core rows and cols kernels.
template <typename In, int D, bool kWriteBias>
int launch_mma(const void* q, const void* k, const void* v, const float* mask,
               Bias bias, const void* dout, void* dq, void* dk, void* dv,
               float* dbias, float* dmask, void* ds, void* wd, float* sc,
               const Layout* lay, int B, int H, int T, int S, uint32_t seed,
               uint32_t threshold, float inv_keep, int dropout,
               cudaStream_t stream) {
  bwd_mma::RowsArgs<In> a;
  a.q = static_cast<const In*>(q);
  a.k = static_cast<const In*>(k);
  a.v = static_cast<const In*>(v);
  a.dout = static_cast<const In*>(dout);
  a.mask = mask;
  a.bias = bias;
  a.e = nullptr;
  a.dq = static_cast<In*>(dq);
  a.ds = static_cast<__nv_bfloat16*>(ds);
  a.wd = static_cast<__nv_bfloat16*>(wd);
  a.scores = sc;
  a.dbias = dbias;
  a.dmask = dmask;
  a.dq_part = nullptr;
  a.lq = lay[0];
  a.lkv = lay[1];
  a.ldo = lay[2];
  a.ldq = lay[3];
  a.B = B;
  a.H = H;
  a.T = T;
  a.S = S;
  a.Sp = bwd_mma::scratch_cols(S);
  a.seed = seed;
  a.threshold = threshold;
  a.inv_keep = inv_keep;
  a.dropout = dropout;
  return bwd_mma::launch_rows_cols<In, D, false, kWriteBias>(
      a, static_cast<In*>(dk), static_cast<In*>(dv), lay[4], stream);
}

template <bool kWriteBias>
int dispatch(int D, int in_bf16, int bf16_dots, const void* q, const void* k,
             const void* v, const float* mask, Bias bias, const void* dout,
             void* dq, void* dk, void* dv, float* dbias, float* dmask,
             void* ds, void* wd, float* sc, const Layout* lay, int B, int H,
             int T, int S, uint32_t seed, uint32_t threshold, float inv_keep,
             int dropout, cudaStream_t st) {
#define FUSED_BWD_ARGS                                                        \
  q, k, v, mask, bias, dout, dq, dk, dv, dbias, dmask, ds, wd, sc, lay, B, H, \
      T, S, seed, threshold, inv_keep, dropout, st
#define FUSED_BWD_CASE(DIM)                                                   \
  case DIM:                                                                   \
    if (!bf16_dots)                                                           \
      return launch_f32<DIM, kWriteBias>(                                     \
          static_cast<const float*>(q), static_cast<const float*>(k),         \
          static_cast<const float*>(v), mask, bias,                           \
          static_cast<const float*>(dout), static_cast<float*>(dq),           \
          static_cast<float*>(dk), static_cast<float*>(dv), dbias, dmask,     \
          static_cast<float*>(ds), static_cast<float*>(wd), lay, B, H, T, S,  \
          seed, threshold, inv_keep, dropout, st);                            \
    return in_bf16                                                            \
               ? launch_mma<__nv_bfloat16, DIM, kWriteBias>(FUSED_BWD_ARGS)   \
               : launch_mma<float, DIM, kWriteBias>(FUSED_BWD_ARGS);
  switch (D) {
    FUSED_BWD_CASE(8)
    FUSED_BWD_CASE(16)
    FUSED_BWD_CASE(32)
    FUSED_BWD_CASE(64)
    FUSED_BWD_CASE(128)
    default: return kErrHeadDim;
  }
#undef FUSED_BWD_CASE
#undef FUSED_BWD_ARGS
}

}  // namespace

extern "C" {

// The forward's inputs (q, k, v views, mask, bias, the same seed, threshold
// and keep scale) plus dout, a (B, H, T, D) view of the output's gradient.
// `strides` holds 18 element strides: (batch, head, row) for q, k/v, dout,
// dq and dk/dv, then the bias's (plane, row, column). Writes dq (a
// (B, H, T, D) view) and dk, dv ((B, H, S, D) views sharing one set of
// strides) in the input type; when dbias is not null (K6-bwd) writes the f32
// score gradient to dbias (B*H, T, S), else (K6-bwd-nobias) writes none;
// when dmask is not null adds the f32 score gradient summed over (b, h) into
// dmask (T, S), which the caller zeroes. ds_scratch and wd_scratch each hold
// B*H*T*Sp elements of the dot type, Sp = S rounded up to a multiple of 64,
// wd_scratch right after ds_scratch; sc_scratch 2*B*H*T*Sp + 3*B*H*T floats
// (bf16 dots only: the scores, the dropped do . v^T and the row
// statistics). Returns 0 when
// launched, -1 for an unsupported head dimension, -2 when a bf16-dot kernel
// does not fit in shared memory (S > 4096), -3 for bf16 inputs with f32 dots, -4 when a bf16-dot
// call gets rows that do not start on 16 bytes, -5 when wd_scratch does not
// follow ds_scratch, else the first cudaError_t of the launches.
int fused_attention_bwd(const void* q, const void* k, const void* v,
                        const float* mask, const float* bias,
                        const void* dout, void* dq, void* dk, void* dv,
                        float* dbias, float* dmask, void* ds_scratch,
                        void* wd_scratch, float* sc_scratch,
                        const long long* strides, int B,
                        int H, int T, int S, int D, int in_bf16,
                        int bf16_dots, uint32_t seed, uint32_t threshold,
                        float inv_keep, int dropout, void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  if (in_bf16 && !bf16_dots) return kErrDtype;
  Layout lay[5];
  for (int i = 0; i < 5; ++i)
    lay[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Bias bv = {bias, strides[15], strides[16], strides[17]};
  cudaStream_t st = (cudaStream_t)stream;
  return dbias ? dispatch<true>(D, in_bf16, bf16_dots, q, k, v, mask, bv,
                                dout, dq, dk, dv, dbias, dmask, ds_scratch,
                                wd_scratch, sc_scratch, lay, B, H, T, S, seed,
                                threshold, inv_keep, dropout, st)
               : dispatch<false>(D, in_bf16, bf16_dots, q, k, v, mask, bv,
                                 dout, dq, dk, dv, nullptr, dmask, ds_scratch,
                                 wd_scratch, sc_scratch, lay, B, H, T, S,
                                 seed, threshold, inv_keep, dropout, st);
}

}  // extern "C"
