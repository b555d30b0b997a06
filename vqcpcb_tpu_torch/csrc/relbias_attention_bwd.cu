// Relative-bias attention backward, Hopper (sm_90a).
//
// Replaces: vqcpcb_tpu/ops/pallas_attention.py:_relbias_bwd_kernel_packed
// (training, packed (B, L, H*d) layout) and :_relbias_bwd_kernel
// ((B*H, L, d) layout), both computing _relbias_bwd_head. Per (b, h), with
// the forward's scores, softmax w and dropout mask regenerated:
//
//   dw    = keep * (do . v^T) / (1-rate)        ds = w * (dw - sum_s dw*w)
//   dq    = ds . k + dc . E                     dk = ds^T . q
//   dv    = w_drop^T . do                       dc[t, s + shift(t)] = ds[t, s]
//   dE   += dc^T . q   (summed over the batch)  dmask += ds (over b and h)
//
// with shift(t) = (S-1) - t/r and E = [e1; e2[1:]]. Rounding follows the TPU
// kernel: q, k, v, E and do are rounded to the dot type before the products;
// ds (and so dc) is rounded before the dq, dk and dE products and w_drop
// before dv; products accumulate in f32; dmask is built from the f32 ds. The
// softmax row term is sum_s dw*w: under dropout and rounding it is not
// rowsum(do * out).
//
// What bounds it on the H100: eight T x S x d products per (b, h) (scores,
// bias, do.v^T, two for dq, dk, dv, dE) against q, k, v, do in and dq, dk,
// dv out -- about 440 flops per bf16 byte at T = S = 384, d = 64, above the
// card's ridge of about 295, so the bf16 tensor-core rate bounds it (0.039
// ms at B = 32, H = 8).
//
// bf16 dots (every training call on the card): the tensor-core rows, cols
// and table kernels of attention_bwd_mma.cuh, whose note gives the design
// (dE in fixed-order partial sums over groups of the batch, no atomics).
// f32 dots (the f32 rule, off the main path): the CUDA-core kernels below,
// three on one stream, no atomics but the optional dmask:
//  1. rows: one block of 8 warps per (b, h, tile of query rows) stages K, V
//     and the table window as the forward does. Each warp takes one row:
//     scores, q.E bias and do.v^T in one pass over the keys, the softmax,
//     the regenerated dropout, the row term, ds; then dq from the row of ds
//     held in shared memory. It writes ds and w_drop to (B, H, T, S) f32
//     scratch.
//  2. cols (attention_bwd_cols.cuh): one block per (b, h, 32 key columns)
//     owns the dk and dv rows of its columns in registers.
//  3. table: one block per (h, 32 rows of E) loops over the batch and the
//     query rows that address its rows (a contiguous range of t for each
//     row j of E), staging q and the band ds[t, j - shift(t)] of the
//     scratch; dE for its rows is summed over the batch in registers.
#include "attention_bwd_cols.cuh"
#include "attention_bwd_mma.cuh"

namespace {

using namespace relbias;

constexpr int kTableTile = 32;   // rows of E per table block
static_assert(kTableTile == kColTile, "cols and table share the warp map");

template <int D>
__global__ void __launch_bounds__(kThreads)
relbias_bwd_rows_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ mask,
                        const float* __restrict__ e,
                        const float* __restrict__ dout, float* __restrict__ dq,
                        float* __restrict__ ds_out, float* __restrict__ wd_out,
                        float* __restrict__ dmask, Layout lq, Layout lkv,
                        Layout ldo, Layout ldq, int B, int H, int T, int S,
                        int tile, uint32_t seed, uint32_t threshold,
                        float inv_keep, int dropout) {
  using In = float;
  using Elem = float;
  using DT = Dot<Elem>;
  constexpr int kStride = D + DT::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* ks = reinterpret_cast<Elem*>(smem_raw);
  Elem* vs = ks + (size_t)S * kStride;
  Elem* es = vs + (size_t)S * D;
  const int ratio = T / S;
  const int n_table = table_rows(S, tile, ratio);
  float* rows = reinterpret_cast<float*>(es + (size_t)n_table * kStride);
  float* vecs = rows + (size_t)kWarps * 2 * S;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * tile;
  const int t1 = min(t0 + tile, T);
  const In* qb = q + b * lq.b + h * lq.h;
  const In* dob = dout + b * ldo.b + h * ldo.h;
  In* dqb = dq + b * ldq.b + h * ldq.h;
  const long long scratch = (long long)(b * H + h) * T * S;
  const int shift_lo = (S - 1) - (t1 - 1) / ratio;
  const float* eb = e + ((long long)h * (2 * S - 1) + shift_lo) * D;
  const int e_count = min(n_table, 2 * S - 1 - shift_lo);
  stage_kv_table<In, Elem, D>(k + b * lkv.b + h * lkv.h,
                              v + b * lkv.b + h * lkv.h, lkv.l, eb, e_count, S,
                              ks, vs, es);
  __syncthreads();

  const uint32_t key = stream_key(seed, h, b, B);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wrow = rows + warp * 2 * S;   // scores -> w -> rounded ds
  float* dwrow = wrow + S;             // do.v^T -> dropped dw
  float* dor = vecs + warp * D;        // the row of do, rounded
  for (int t = t0 + warp; t < t1; t += kWarps) {
    float qr[D];
#pragma unroll
    for (int j = 0; j < D; ++j) qr[j] = DT::round(to_float(qb[t * lq.l + j]));
    for (int j = lane; j < D; j += 32)
      dor[j] = DT::round(to_float(dob[t * ldo.l + j]));
    __syncwarp();
    const int shift = (S - 1) - t / ratio - shift_lo;
    const float* mrow = mask + (long long)t * S;

    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) {
      const Elem* kr = ks + s * kStride;
      const Elem* er = es + (s + shift) * kStride;
      const Elem* vr = vs + s * D;
      float acc_k = 0.f, acc_e = 0.f, acc_v = 0.f;
#pragma unroll
      for (int j = 0; j < D; j += 2) {
        const float2 kk = DT::load2(kr + j);
        const float2 ee = DT::load2(er + j);
        const float2 vv = DT::load2(vr + j);
        acc_k = fmaf(qr[j], kk.x, acc_k);
        acc_k = fmaf(qr[j + 1], kk.y, acc_k);
        acc_e = fmaf(qr[j], ee.x, acc_e);
        acc_e = fmaf(qr[j + 1], ee.y, acc_e);
        acc_v = fmaf(dor[j], vv.x, acc_v);
        acc_v = fmaf(dor[j + 1], vv.y, acc_v);
      }
      const float score = __fadd_rn(__fadd_rn(acc_k, mrow[s]), acc_e);
      wrow[s] = score;
      dwrow[s] = acc_v;
      m = fmaxf(m, score);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float p = expf(wrow[s] - m);
      wrow[s] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    float row_term = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float w = wrow[s] / sum;
      float dw = dwrow[s], w_drop = w;
      if (dropout) {
        const bool kept = dropout_keep(key, t, s, S, threshold);
        w_drop = kept ? w * inv_keep : 0.f;
        dw = kept ? dw * inv_keep : 0.f;
      }
      wd_out[scratch + (long long)t * S + s] = DT::store(w_drop);
      row_term = __fadd_rn(row_term, __fmul_rn(dw, w));
      wrow[s] = w;
      dwrow[s] = dw;
    }
    row_term = warp_sum(row_term);
    for (int s = lane; s < S; s += 32) {
      const float ds = wrow[s] * (dwrow[s] - row_term);
      if (dmask) atomicAdd(dmask + (long long)t * S + s, ds);
      ds_out[scratch + (long long)t * S + s] = DT::store(ds);
      wrow[s] = DT::round(ds);
    }
    __syncwarp();

    // dq = ds . k + dc . E, the two products summed apart as the TPU kernel
    // does; lanes split the head dimension
    for (int p = lane; p < D / 2; p += 32) {
      float kx = 0.f, ky = 0.f, ex = 0.f, ey = 0.f;
      for (int s = 0; s < S; ++s) {
        const float d = wrow[s];
        const float2 kk = DT::load2(ks + s * kStride + 2 * p);
        const float2 ee = DT::load2(es + (s + shift) * kStride + 2 * p);
        kx = fmaf(d, kk.x, kx);
        ky = fmaf(d, kk.y, ky);
        ex = fmaf(d, ee.x, ex);
        ey = fmaf(d, ee.y, ey);
      }
      In* o = dqb + t * ldq.l + 2 * p;
      o[0] = from_float<In>(kx + ex);
      o[1] = from_float<In>(ky + ey);
    }
    __syncwarp();   // the row buffers are rewritten by the next query row
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
relbias_bwd_table_kernel(const float* __restrict__ q,
                         const float* __restrict__ ds, float* __restrict__ de,
                         Layout lq, int B, int H, int T, int S) {
  using In = float;
  using Elem = float;
  using DT = Dot<Elem>;
  constexpr int kPairs = (D / 2 + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* qs = reinterpret_cast<Elem*>(smem_raw);
  Elem* band = qs + kRowChunk * D;

  const int h = blockIdx.y;
  const int j0 = blockIdx.x * kTableTile;
  const int ratio = T / S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // row j of E is read by the query rows t with 0 <= j - shift(t) < S, i.e.
  // S-1-j <= t/r <= 2S-2-j: the block's rows need t in [t_lo, t_hi)
  const int t_lo = max(0, S - kTableTile - j0) * ratio;
  const int t_hi = min(T, (2 * S - 1 - j0) * ratio);

  float acc[kColsPerWarp][kPairs][2] = {};
  for (int b = 0; b < B; ++b) {
    const In* qb = q + b * lq.b + h * lq.h;
    const long long scratch = (long long)(b * H + h) * T * S;
    for (int t0 = t_lo; t0 < t_hi; t0 += kRowChunk) {
      const int n = min(kRowChunk, t_hi - t0);
      stage_rows<In, Elem, D>(qb, lq.l, t0, n, qs);
      for (int i = threadIdx.x; i < n * kTableTile; i += kThreads) {
        const int r = i / kTableTile, c = i - r * kTableTile;
        const int t = t0 + r;
        const int s = j0 + c - (S - 1) + t / ratio;
        band[i] = (s >= 0 && s < S) ? ds[scratch + (long long)t * S + s]
                                    : DT::store(0.f);
      }
      __syncthreads();
      for (int r = 0; r < n; ++r) {
#pragma unroll
        for (int pi = 0; pi < kPairs; ++pi) {
          const int p = lane + 32 * pi;
          if (p >= D / 2) break;
          const float2 qq = DT::load2(qs + r * D + 2 * p);
#pragma unroll
          for (int cw = 0; cw < kColsPerWarp; ++cw) {
            const float dc = DT::load(band[r * kTableTile + warp + cw * kWarps]);
            acc[cw][pi][0] = fmaf(dc, qq.x, acc[cw][pi][0]);
            acc[cw][pi][1] = fmaf(dc, qq.y, acc[cw][pi][1]);
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int cw = 0; cw < kColsPerWarp; ++cw) {
    const int j = j0 + warp + cw * kWarps;
    if (j >= 2 * S - 1) continue;
#pragma unroll
    for (int pi = 0; pi < kPairs; ++pi) {
      const int p = lane + 32 * pi;
      if (p >= D / 2) break;
      float* o = de + ((long long)h * (2 * S - 1) + j) * D + 2 * p;
      o[0] = acc[cw][pi][0];
      o[1] = acc[cw][pi][1];
    }
  }
}

// f32 dots: the CUDA-core rows, cols and table kernels.
template <int D>
int launch_f32(const float* q, const float* k, const float* v,
               const float* mask, const float* e, const float* dout,
               float* dq, float* dk, float* dv, float* dmask, float* de,
               float* ds, float* wd, const Layout* lay, int B, int H, int T,
               int S, uint32_t seed, uint32_t threshold, float inv_keep,
               int dropout, cudaStream_t stream) {
  size_t bytes = 0;
  const int tile = pick_tile<float>(S, D, T / S, 2, 1, &bytes);
  if (!tile) return kErrSharedMemory;
  cudaFuncSetAttribute(relbias_bwd_rows_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  relbias_bwd_rows_kernel<D>
      <<<dim3((T + tile - 1) / tile, H, B), kThreads, bytes, stream>>>(
          q, k, v, mask, e, dout, dq, ds, wd, dmask, lay[0], lay[1], lay[2],
          lay[3], B, H, T, S, tile, seed, threshold, inv_keep, dropout);
  int err = (int)cudaGetLastError();
  if (err) return err;

  err = launch_cols_f32<D>(q, dout, ds, wd, dk, dv, lay[0], lay[2], lay[4], B,
                           H, T, S, stream);
  if (err) return err;

  const int table_bytes = (int)(sizeof(float) * kRowChunk * (D + kTableTile));
  cudaFuncSetAttribute(relbias_bwd_table_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       table_bytes);
  relbias_bwd_table_kernel<D>
      <<<dim3((2 * S - 1 + kTableTile - 1) / kTableTile, H), kThreads,
         table_bytes, stream>>>(q, ds, de, lay[0], B, H, T, S);
  return (int)cudaGetLastError();
}

// bf16 dots: the tensor-core rows and cols kernels, then dq's table part,
// the table kernel and the sum of its partial tables. de_partial holds the
// table kernel's per-group sums, then dq's f32 ds . k part.
template <typename In, int D>
int launch_mma(const void* q, const void* k, const void* v, const float* mask,
               const void* e, const void* dout, void* dq, void* dk, void* dv,
               float* dmask, float* de, float* de_partial, void* ds, void* wd,
               float* sc, const Layout* lay, int B, int H, int T, int S,
               uint32_t seed, uint32_t threshold, float inv_keep, int dropout,
               cudaStream_t stream) {
  bwd_mma::RowsArgs<In> a;
  a.q = static_cast<const In*>(q);
  a.k = static_cast<const In*>(k);
  a.v = static_cast<const In*>(v);
  a.dout = static_cast<const In*>(dout);
  a.mask = mask;
  a.bias = {nullptr, 0, 0, 0};
  a.e = static_cast<const __nv_bfloat16*>(e);
  a.dq = static_cast<In*>(dq);
  a.ds = static_cast<__nv_bfloat16*>(ds);
  a.wd = static_cast<__nv_bfloat16*>(wd);
  a.scores = sc;
  a.dbias = nullptr;
  a.dmask = dmask;
  a.dq_part = de_partial +
              (long long)bwd_mma::table_groups(B) * H * (2 * S - 1) * D;
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
  const int err = bwd_mma::launch_rows_cols<In, D, true, false>(
      a, static_cast<In*>(dk), static_cast<In*>(dv), lay[4], stream);
  if (err) return err;
  return bwd_mma::launch_relbias<In, D>(a, de_partial, de, stream);
}

int dispatch(int D, int in_bf16, int bf16_dots, const void* q, const void* k,
             const void* v, const float* mask, const void* e,
             const void* dout, void* dq, void* dk, void* dv, float* dmask,
             float* de, float* de_partial, void* ds, void* wd, float* sc,
             const Layout* lay, int B, int H, int T, int S, uint32_t seed,
             uint32_t threshold, float inv_keep, int dropout,
             cudaStream_t st) {
#define RELBIAS_BWD_ARGS                                                      \
  q, k, v, mask, e, dout, dq, dk, dv, dmask, de, de_partial, ds, wd, sc, lay, \
      B, H, T, S, seed, threshold, inv_keep, dropout, st
#define RELBIAS_BWD_CASE(DIM)                                                 \
  case DIM:                                                                   \
    if (!bf16_dots)                                                           \
      return launch_f32<DIM>(                                                 \
          static_cast<const float*>(q), static_cast<const float*>(k),         \
          static_cast<const float*>(v), mask, static_cast<const float*>(e),   \
          static_cast<const float*>(dout), static_cast<float*>(dq),           \
          static_cast<float*>(dk), static_cast<float*>(dv), dmask, de,        \
          static_cast<float*>(ds), static_cast<float*>(wd), lay, B, H, T, S,  \
          seed, threshold, inv_keep, dropout, st);                            \
    return in_bf16 ? launch_mma<__nv_bfloat16, DIM>(RELBIAS_BWD_ARGS)         \
                   : launch_mma<float, DIM>(RELBIAS_BWD_ARGS);
  switch (D) {
    RELBIAS_BWD_CASE(8)
    RELBIAS_BWD_CASE(16)
    RELBIAS_BWD_CASE(32)
    RELBIAS_BWD_CASE(64)
    RELBIAS_BWD_CASE(128)
    default: return kErrHeadDim;
  }
#undef RELBIAS_BWD_CASE
#undef RELBIAS_BWD_ARGS
}

}  // namespace

extern "C" {

// The forward's inputs (q, k, v views, mask, the combined table e, the same
// seed, threshold and keep scale) plus dout, a (B, H, T, D) view of the
// output's gradient. e is (H, 2S-1, D) in the dot type. Writes dq (a
// (B, H, T, D) view) and dk, dv ((B, H, S, D) views sharing one set of
// strides) in the input type, de (H, 2S-1, D) f32 (summed over the batch),
// and, when dmask is not null, adds the f32 score gradient summed over
// (b, h) into dmask (T, S), which the caller zeroes. ds_scratch and
// wd_scratch each hold B*H*T*Sp elements of the dot type, Sp = S rounded
// up to a multiple of 64, wd_scratch right after ds_scratch; de_partial
// holds min(B, 8)*H*(2S-1)*D + B*H*T*D floats and sc_scratch 2*B*H*T*Sp +
// 3*B*H*T floats (bf16 dots only: the table kernel's per-group sums and
// dq's ds . k part; the scores, the dropped do . v^T and the row
// statistics). `strides` holds 15 element strides (batch, head, row) for
// q, k/v, dout, dq and dk/dv. Returns 0 when launched, -1 for an
// unsupported head dimension, -2 when a kernel does not fit in shared
// memory, -3 for bf16 inputs with f32 dots, -4 when a bf16-dot call gets
// rows that do not start on 16 bytes, -5 when wd_scratch does not follow
// ds_scratch, else the first cudaError_t of the launches.
int relbias_attention_bwd(const void* q, const void* k, const void* v,
                          const float* mask, const void* e, const void* dout,
                          void* dq, void* dk, void* dv, float* dmask,
                          float* de, float* de_partial, void* ds_scratch,
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
  return dispatch(D, in_bf16, bf16_dots, q, k, v, mask, e, dout, dq, dk, dv,
                  dmask, de, de_partial, ds_scratch, wd_scratch, sc_scratch,
                  lay, B, H, T, S, seed, threshold, inv_keep, dropout,
                  (cudaStream_t)stream);
}

}  // extern "C"
