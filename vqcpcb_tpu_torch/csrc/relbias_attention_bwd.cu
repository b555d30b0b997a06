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
// f32 dots (VQCPCB_PALLAS_BF16_DOTS=0): three kernels on one stream, no
// atomics but the optional dmask, none of whose shared memory grows with S:
//  1. rows (attention_bwd_f32.cuh, with the relative bias): K, V and the
//     table window stream through shared memory in blocks of 64 keys; the
//     scores, the softmax, the dropout, the row term, ds and w_drop go
//     along (B, H, T, S) f32 scratch rows, and dq = ds . k + dc . E is a
//     second sweep over the key blocks. It replaces a kernel that staged
//     the whole plane and refused S > 273 (d = 64), the flagship's 384
//     among them; that header says what bounds it.
//  2. cols (attention_bwd_cols.cuh): one block per (b, h, 32 key columns)
//     owns the dk and dv rows of its columns in registers.
//  3. table: one block per (h, 32 rows of E, group of the batch) loops over
//     its group's sequences and the query rows that address its rows (a
//     contiguous range of t for each row j of E), staging q and the band
//     ds[t, j - shift(t)] of the scratch; dE for its rows is summed over the
//     group in registers, then over the groups in a fixed order
//     (attention_bwd_mma.cuh's table-sum kernel), as with bf16 dots.
#include "attention_bwd_cols.cuh"
#include "attention_bwd_f32.cuh"
#include "attention_bwd_mma.cuh"

namespace {

using namespace relbias;

constexpr int kTableTile = 32;   // rows of E per table block
static_assert(kTableTile == kColTile, "cols and table share the warp map");

template <int D>
__global__ void __launch_bounds__(kThreads)
relbias_bwd_table_kernel(const float* __restrict__ q,
                         const float* __restrict__ ds, float* __restrict__ partial,
                         Layout lq, int B, int H, int T, int S) {
  using In = float;
  using Elem = float;
  using DT = Dot<Elem>;
  constexpr int kPairs = (D / 2 + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* qs = reinterpret_cast<Elem*>(smem_raw);
  Elem* band = qs + kRowChunk * D;

  const int h = blockIdx.y;
  const int grp = blockIdx.z;
  const int j0 = blockIdx.x * kTableTile;
  const int ratio = T / S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // row j of E is read by the query rows t with 0 <= j - shift(t) < S, i.e.
  // S-1-j <= t/r <= 2S-2-j: the block's rows need t in [t_lo, t_hi)
  const int t_lo = max(0, S - kTableTile - j0) * ratio;
  const int t_hi = min(T, (2 * S - 1 - j0) * ratio);
  // the group's contiguous share of the batch
  const int per_group = (B + gridDim.z - 1) / gridDim.z;
  const int b_hi = min(B, (grp + 1) * per_group);

  float acc[kColsPerWarp][kPairs][2] = {};
  for (int b = grp * per_group; b < b_hi; ++b) {
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
      float* o = partial + (((long long)grp * H + h) * (2 * S - 1) + j) * D + 2 * p;
      o[0] = acc[cw][pi][0];
      o[1] = acc[cw][pi][1];
    }
  }
}

// f32 dots: the streamed rows kernel, then the cols and table kernels.
template <int D>
int launch_f32(const float* q, const float* k, const float* v,
               const float* mask, const float* e, const float* dout,
               float* dq, float* dk, float* dv, float* dmask, float* de,
               float* de_partial, float* ds, float* wd, const Layout* lay,
               int B, int H, int T, int S, uint32_t seed, uint32_t threshold,
               float inv_keep, int dropout, cudaStream_t stream) {
  bwd_f32::RowsArgs a = {q, k, v, mask, e, {nullptr, 0, 0, 0}, dout, dq, ds,
                         wd, nullptr, dmask, lay[0], lay[1], lay[2], lay[3],
                         B, H, T, S, seed, threshold, inv_keep, dropout};
  int err = bwd_f32::launch_rows<D, true, false>(a, stream);
  if (err) return err;

  err = launch_cols_f32<D>(q, dout, ds, wd, dk, dv, lay[0], lay[2], lay[4], B,
                           H, T, S, stream);
  if (err) return err;

  const int table_bytes = (int)(sizeof(float) * kRowChunk * (D + kTableTile));
  const int groups = bwd_mma::table_groups(B);
  cudaFuncSetAttribute(relbias_bwd_table_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       table_bytes);
  relbias_bwd_table_kernel<D>
      <<<dim3((2 * S - 1 + kTableTile - 1) / kTableTile, H, groups), kThreads,
         table_bytes, stream>>>(q, ds, de_partial, lay[0], B, H, T, S);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)H * (2 * S - 1) * D;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  bwd_mma::table_sum_kernel<<<blocks, 256, 0, stream>>>(de_partial, de, n, groups);
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
          de_partial, static_cast<float*>(ds), static_cast<float*>(wd), lay,  \
          B, H, T, S, seed, threshold, inv_keep, dropout, st);                \
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
// holds min(B, 8)*H*(2S-1)*D floats, the table kernel's per-group sums,
// and with bf16 dots B*H*T*D more, dq's ds . k part; sc_scratch 2*B*H*T*Sp
// + 3*B*H*T floats (bf16 dots only: the scores, the dropped do . v^T and
// the row statistics). `strides` holds 15 element strides (batch, head, row) for
// q, k/v, dout, dq and dk/dv. Returns 0 when launched, -1 for an
// unsupported head dimension, -2 when a bf16-dot kernel does not fit in
// shared memory (S > 4096), -3 for bf16 inputs with f32 dots, -4 when a bf16-dot call gets
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
