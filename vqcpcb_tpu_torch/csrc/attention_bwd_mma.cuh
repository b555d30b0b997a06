// The attention backward on Hopper's tensor cores: the bf16-dot instances
// of K6-bwd / K6-bwd-nobias (fused_attention_bwd.cu) and K2-bwd / K3-bwd
// (relbias_attention_bwd.cu). The f32-dot instances keep the CUDA-core
// kernels of those files: tensor cores would take f32 operands only as
// TF32, which drops the f32 rule's mantissa, and no main path runs them
// (bf16 dots are what training always runs on the card).
//
// Per (b, h) plane, with the forward's scores, softmax w and dropout mask
// regenerated (rounding points of pallas_attention.py:_relbias_bwd_head and
// _train_bwd_kernel*: q, k, v, do and E in bf16 before the products; the
// scores, softmax, dropout and ds in f32; w_drop rounded before dv and ds
// before dq, dk and dE):
//
//   dw = keep * (do . v^T) / (1-rate)      ds = w * (dw - sum_s dw*w)
//   dq = ds . k [+ dc . E]     dk = ds^T . q     dv = w_drop^T . do
//   [dE += dc^T . q]  with dc[t, s + shift(t)] = ds[t, s] (relative bias)
//
// What bounds it on the H100: five (K6) or eight (K2) T x S x d products per
// plane against q, k, v, do in and dq, dk, dv out. At B = 32, H = 8,
// T = S = 384, d = 64 that is 24-39 GFLOP on 25-38 MB, below the bf16
// tensor-core rate's ridge for K6 (its bytes bound it, 0.027 ms) and above it
// for K2 (0.039 ms of operations).
//
// What sets the design besides: the softmax weights are rounded to bf16
// before dv, so a weight whose f32 value differs from the plain version's in
// its last bit may round to the neighbouring bf16 value and move dv by one
// bf16 step times do -- a difference as large as skipping a rounding point.
// The weights and ds therefore equal the plain version's bit for bit: the
// scores, the relative bias and do . v^T are f32 dot products taken one
// fmaf after another over the head dim, as an f32 matrix product on the
// card takes them (CUDA cores; the tensor cores' sums round otherwise);
// the softmax sum follows PyTorch's warp softmax and the row term
// sum_s dw*w PyTorch's reduction of a last dimension (rows_kernel and
// row_term_kernel below). The products after the rounding points -- dq =
// ds . k, dq_E = dc . E, dk, dv, dE, more than half of the flops -- run on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums), their operands
// staged by cp.async into padded shared tiles for ldmatrix:
//  1. rows: one block of 4 warps per (b, h, 64 query rows), 16 rows a warp;
//     K and V (and, for the stats, the rows of E the tile addresses) come
//     in blocks of 64 keys, double-buffered. A stats launch writes the f32
//     scores and the dropped dw = do . v^T to scratch, the row max and sum
//     to row statistics and e = dw * w to the e scratch; row_term_kernel
//     sums e per row; a gradient launch reads scores and dw back and forms
//     w, ds (dbias and dmask on request), dq (its ds . k part, with the
//     relative bias), and bf16 ds and w_drop to (B, H, T, Sp) scratch
//     (Sp = S rounded up to 64).
//  2. cols: one block of 4 warps per (b, h, 64 keys) walks the query rows in
//     chunks of 64: dk += ds^T . q and dv += w_drop^T . do on the tensor
//     cores, in registers; no cross-block sum.
//  3. relative bias only: dqe_kernel, on the rows kernel's grid, adds
//     dq_E = dc . E to dq's ds . k part from the ds scratch; the table
//     kernel, one block per (64 rows of E, h, group of batch elements),
//     gathers the skewed band dc from the ds scratch and forms
//     dE += dc^T . q; a last kernel sums the groups' partial tables in a
//     fixed order. No float atomics: every result is deterministic but
//     dmask (atomics, only when a mask wants a gradient).
// The ds / w_drop scratch (2 x 75 MB at the shape above) stays: the table
// and dq_E kernels read ds in any case.
// What bounds the design itself: the f32 fmaf chains of the stats launch
// (scores, bias, do . v^T), each fmaf with a bf16-to-f32 widening of a
// shared operand beside it; about half of K2-bwd's device time on an H100.
// Hence: each chain runs once (the gradient launch reads dw back rather
// than recompute it: 151 MB more scratch at the shape above, written once
// and read once); the stats launch stages only what each pass reads, so
// three of its blocks fit an SM; the gradient launch stages K alone, and
// dq_E, with its table window and dc tiles, has a kernel of its own; at
// T = S (ratio 1) the bias reuses each table row it loads for both of a
// lane's query rows; the table kernel loads the next item's skewed band
// before the current item's products. wgmma with TMA and skipping fully
// masked causal tiles are later work.
#pragma once

#include "attention_mma.cuh"
#include "relbias_common.cuh"

namespace bwd_mma {

using relbias::Bias;
using relbias::Layout;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                 // query rows, keys, rows of E per block
constexpr int kTileTiles = kTile / 8;     // n-tiles of a 64-key block
constexpr int kWin = 80;                  // table rows one warp's 16 rows address
constexpr int kBlockWin = 128;            // table rows one block's 64 rows address
constexpr int kDcLd = kWin + mma::kPad;   // bf16 per row of a warp's dc tile
constexpr int kSLd = kTile + mma::kPad;   // bf16 per row of a staged scratch tile
constexpr int kTableGroups = 8;           // batch groups of the table kernel

// Columns of a scratch row: S rounded up to whole key blocks, so every row
// starts on 16 bytes and the padding columns hold zeros.
inline int scratch_cols(int S) { return (S + kTile - 1) / kTile * kTile; }

inline int table_groups(int B) { return B < kTableGroups ? B : kTableGroups; }

template <typename In>
struct RowsArgs {
  const In* q;
  const In* k;
  const In* v;
  const In* dout;
  const float* mask;             // (T, S), finite
  Bias bias;                     // explicit bias (K6), p may be null
  const __nv_bfloat16* e;        // (H, 2S-1, D) table in bf16 (K2/K3)
  In* dq;
  __nv_bfloat16* ds;             // (B, H, T, Sp) scratch; wd follows it in
  __nv_bfloat16* wd;             // one allocation, which first holds e f32
  float* scores;                 // (B, H, T, Sp) f32 scores, then the
                                 // (B, H, T, Sp) dropped do . v^T, then
                                 // 3 x B*H*T row stats (max, sum, row term)
  float* dbias;                  // (B*H, T, S) or null
  float* dmask;                  // (T, S) or null
  float* dq_part;                // (B, H, T, D) f32 ds . k part of dq (K2/K3)
  Layout lq, lkv, ldo, ldq;
  int B, H, T, S, Sp;
  uint32_t seed, threshold;
  float inv_keep;
  int dropout;
};

// Rows of one staging buffer of the rows kernel: the gradient launch stages
// K per key block; the stats launch K (and the table window) in pass 1 and
// V alone, in K's place, in pass 3.
template <bool kRelbias, bool kGrad>
__host__ __device__ constexpr int stage_rows_count() {
  return kGrad ? kTile : kTile + (kRelbias ? kBlockWin : 0);
}

// q and do and two staging buffers: at d = 64, 72 KB for the stats launch
// with the relative bias (three blocks an SM) and 37 KB for the gradient
// launch.
template <int D, bool kRelbias, bool kGrad>
constexpr size_t rows_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (2 * kTile + 2 * stage_rows_count<kRelbias, kGrad>()) *
         mma::Dims<D>::kRow;
}

// Eight consecutive bf16 of a shared row, as f32.
__device__ __forceinline__ void load8(float (&f)[8], const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// The thread's accumulator positions of a 16-row by 64-key block, each an
// f32 dot product over the head dim taken as an f32 dot product is, one fmaf
// after another in ascending order: rows `at` (the warp's 16) by rows `bt`
// (the block's 64 keys; the first 8 kNT of them for kNT < 8). Index
// [nt][x]: row g + 8 * (x >> 1), key nt * 8 + 2c + (x & 1).
template <int D, int kNT = kTileTiles>
__device__ __forceinline__ void dots_fma(float (&acc)[kNT][4],
                                         const __nv_bfloat16* at,
                                         const __nv_bfloat16* bt, int ld) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nt][x] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += 8) {
    float a0[8], a1[8];
    load8(a0, at + g * ld + d0);
    load8(a1, at + (g + 8) * ld + d0);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float b[8];
        load8(b, bt + (nt * 8 + 2 * c + e) * ld + d0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[nt][e] = fmaf(a0[j], b[j], acc[nt][e]);
          acc[nt][2 + e] = fmaf(a1[j], b[j], acc[nt][2 + e]);
        }
      }
    }
  }
}

// The relative bias of the thread's positions, q_t . E[s + shift(t)], each
// as dots_fma takes a dot product; `es` holds the block's table window, and
// row t reads window row w_off + (s - s0) + (tw + 15)/r - t/r.
template <int D, int kNT = kTileTiles>
__device__ __forceinline__ void bias_fma(float (&acc)[kNT][4],
                                         const __nv_bfloat16* at,
                                         const __nv_bfloat16* es, int ld,
                                         int w_off, int tw, int ratio) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  int skew[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    skew[half] = w_off + (tw + 15) / ratio - (tw + g + 8 * half) / ratio;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nt][x] = 0.f;
  if (ratio == 1) {
    // rows g and g + 8 read window rows 8 apart: what row g + 8 reads at
    // n-tile nt, row g read at nt - 1, so each row loaded serves both (half
    // the loads and bf16 widenings of the general case below)
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += 8) {
      float a[2][8], prev[2][8];
      load8(a[0], at + g * ld + d0);
      load8(a[1], at + (g + 8) * ld + d0);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        load8(prev[e], es + (2 * c + e + skew[1]) * ld + d0);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float b[8];
          load8(b, es + (nt * 8 + 2 * c + e + skew[0]) * ld + d0);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[nt][e] = fmaf(a[0][j], b[j], acc[nt][e]);
            acc[nt][2 + e] = fmaf(a[1][j], prev[e][j], acc[nt][2 + e]);
            prev[e][j] = b[j];
          }
        }
      }
    }
    return;
  }
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += 8) {
    float a[2][8];
    load8(a[0], at + g * ld + d0);
    load8(a[1], at + (g + 8) * ld + d0);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float b[8];
        load8(b, es + (nt * 8 + 2 * c + (x & 1) + skew[x >> 1]) * ld + d0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[nt][x] = fmaf(a[x >> 1][j], b[j], acc[nt][x]);
      }
    }
  }
}

// Write a warp's 16 x D accumulator as rows row0 + (0..15) of `out` (row
// stride `ld`), rows below `rows` only.
template <int D, typename Out>
__device__ __forceinline__ void store_acc(
    const float (&acc)[mma::Dims<D>::kDot / 8][4], Out* out, long long ld,
    int row0, int rows) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < mma::Dims<D>::kDot / 8; ++nt) {
    const int d = nt * 8 + 2 * c;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + g + 8 * half;
      if (r >= rows) continue;
      out[r * ld + d] = relbias::from_float<Out>(acc[nt][2 * half]);
      out[r * ld + d + 1] = relbias::from_float<Out>(acc[nt][2 * half + 1]);
    }
  }
}

// The rows kernel, in two launches with the row-term sum between them:
//  kGrad = false (stats): pass 1 the scores (+ mask, + bias) into the f32
//    scratch and the row max; pass 2 the softmax sum in PyTorch's warp
//    softmax order (each of 32 lanes sums the keys s = lane (mod 32) in
//    ascending order, then a butterfly over lanes 16, 8, 4, 2, 1); pass 3
//    w, dw = do . v^T with the dropout into its scratch, and e = dw * w into
//    the e scratch. It writes the row max and sum to the stats.
//  kGrad = true (gradient): one pass: w, dw read back from its scratch,
//    ds = w * (dw - row term) in f32 (dbias and dmask on request), bf16 ds
//    and w_drop to the scratch, dq += ds . k with bf16 ds straight from the
//    registers (K alone is staged). With the
//    relative bias it writes that f32 sum to dq_part, and dqe_kernel adds
//    dc . E to it, the two parts summed apart as the TPU kernel sums them.
template <typename In, int D, bool kRelbias, bool kWriteBias, bool kGrad>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const RowsArgs<In> a) {
  using Dm = mma::Dims<D>;
  constexpr int LD = Dm::kRow;
  constexpr int kDTiles = Dm::kDot / 8;
  constexpr int kStageRows = stage_rows_count<kRelbias, kGrad>();
  constexpr int kPasses = kGrad ? 1 : 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile * LD;
  __nv_bfloat16* stages = dos + kTile * LD;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int tw = t0 + warp * 16;            // the warp's first query row
  const int plane = b * a.H + h;
  const int T = a.T, S = a.S, Sp = a.Sp;
  const long long n_rows = (long long)a.B * a.H * T;
  const int ratio = kRelbias ? T / S : 1;
  const int nb = Sp / kTile;                // key blocks
  const In* kb = a.k + b * a.lkv.b + h * a.lkv.h;
  const In* vb = a.v + b * a.lkv.b + h * a.lkv.h;
  // key block s0 addresses table rows s0 + e_off .. + kBlockWin; the warp's
  // rows address the kWin of them from w_off on
  const int e_off = (S - 1) - (t0 + kTile - 1) / ratio;
  const int w_off = (t0 + kTile - 1) / ratio - (tw + 15) / ratio;
  const uint32_t key = kRelbias ? relbias::stream_key(a.seed, h, b, a.B)
                                : relbias::plane_key(a.seed, plane);
  const float* bp = a.bias.p ? a.bias.p + plane * a.bias.bh : nullptr;
  float* scores = a.scores + (long long)plane * T * Sp;
  float* dws = scores + n_rows * Sp;        // the dropped do . v^T
  float* stats = a.scores + 2 * n_rows * Sp;  // max, sum, row term: n_rows each
  float* e_out = reinterpret_cast<float*>(a.ds) + (long long)plane * T * Sp;

  // the stats launch stages K (and the window) for pass 1, nothing for
  // pass 2, which reads only the scores, and V in K's place for pass 3
  auto stage_block = [&](int it, int buf) {
    const int pass = kGrad ? 2 : it / nb;
    if (pass == 1) return;
    __nv_bfloat16* ks = stages + buf * kStageRows * LD;
    const int s0 = (it % nb) * kTile;
    if (kGrad || pass == 0)
      mma::stage_rows<D, kThreads>(ks, kb, a.lkv.l, s0, kTile, S);
    if (!kGrad && pass == 2)
      mma::stage_rows<D, kThreads>(ks, vb, a.lkv.l, s0, kTile, S);
    if (kRelbias && !kGrad && pass == 0)
      mma::stage_rows<D, kThreads>(ks + kTile * LD,
                                   a.e + (long long)h * (2 * S - 1) * D,
                                   (long long)D, s0 + e_off, kBlockWin,
                                   2 * S - 1);
  };

  if (!kGrad)
    mma::stage_rows<D, kThreads>(qs, a.q + b * a.lq.b + h * a.lq.h, a.lq.l,
                                 t0, kTile, T);
  if (!kGrad)
    mma::stage_rows<D, kThreads>(dos, a.dout + b * a.ldo.b + h * a.ldo.h,
                                 a.ldo.l, t0, kTile, T);
  stage_block(0, 0);
  mma::cp_async_commit();

  // per thread: rows tw + g and tw + g + 8 (index `half`)
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {1.f, 1.f};
  float r_row[2] = {0.f, 0.f};
  if (kGrad) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = tw + g + 8 * half;
      if (t < T) {
        const long long row = (long long)plane * T + t;
        m_row[half] = stats[row];
        l_row[half] = stats[n_rows + row];
        r_row[half] = stats[2 * n_rows + row];
      } else {
        m_row[half] = 0.f;
      }
    }
  }
  // the sums of exp(score - max) by key modulo 32: index (nt % 4) * 2 + e
  // holds key residue (nt % 4) * 8 + 2c + e
  float l_res[2][8] = {};
  float dqk[kDTiles][4] = {};

  for (int it = 0; it < kPasses * nb; ++it) {
    const int buf = it & 1;
    if (it + 1 < kPasses * nb) {
      stage_block(it + 1, buf ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int pass = kGrad ? 2 : it / nb;
    const int s0 = (it % nb) * kTile;
    const __nv_bfloat16* ks = stages + buf * kStageRows * LD;
    const __nv_bfloat16* vs = ks;                // pass 3 of the stats launch
    const __nv_bfloat16* es = ks + kTile * LD;   // the stats launch's window

    if (!kGrad && it == nb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = m_row[half];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        m_row[half] = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      }
    } else if (!kGrad && it == 2 * nb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* v = l_res[half];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = v[j] + v[j ^ 4];       // key bit 4
#pragma unroll
        for (int j = 0; j < 2; ++j) v[j] = v[j] + v[j ^ 2];       // key bit 3
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = v[j] + __shfl_xor_sync(0xffffffffu, v[j], 2);   // key bit 2
          v[j] = v[j] + __shfl_xor_sync(0xffffffffu, v[j], 1);   // key bit 1
        }
        l_row[half] = v[0] + v[1];                                // key bit 0
      }
    }

    float sc[kTileTiles][4];
    float dw[kTileTiles][4];
    if (pass == 0) {
      // the scores, + mask (+ bias); -inf past the last key
      dots_fma<D>(sc, qs + warp * 16 * LD, ks, LD);
      if constexpr (kRelbias)
        bias_fma<D>(dw, qs + warp * 16 * LD, es, LD, w_off, tw, ratio);
#pragma unroll
      for (int nt = 0; nt < kTileTiles; ++nt) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int half = x >> 1;
          const int t = tw + g + 8 * half;
          const int s = s0 + nt * 8 + 2 * c + (x & 1);
          float score = -INFINITY;
          if (s < S) {
            const bool row = t < T;
            score = __fadd_rn(sc[nt][x], row ? a.mask[(long long)t * S + s] : 0.f);
            if constexpr (kRelbias) {
              score = __fadd_rn(score, dw[nt][x]);
            } else {
              if (bp && row)
                score = __fadd_rn(score, bp[t * a.bias.t + s * a.bias.s]);
            }
          }
          sc[nt][x] = score;
          m_row[half] = fmaxf(m_row[half], score);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = tw + g + 8 * half;
          if (t < T)
            *reinterpret_cast<float2*>(scores + (long long)t * Sp + s0 + nt * 8 + 2 * c) =
                make_float2(sc[nt][2 * half], sc[nt][2 * half + 1]);
        }
      }
      __syncthreads();   // the next iteration stages into this buffer
      continue;
    }

    // p = exp(score - max) from the scores of pass 1 (this thread's own)
#pragma unroll
    for (int nt = 0; nt < kTileTiles; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = tw + g + 8 * half;
        float2 v = make_float2(0.f, 0.f);
        if (t < T)
          v = *reinterpret_cast<const float2*>(scores + (long long)t * Sp + s0 +
                                               nt * 8 + 2 * c);
        sc[nt][2 * half] = expf(v.x - m_row[half]);
        sc[nt][2 * half + 1] = expf(v.y - m_row[half]);
      }
    }
    if (pass == 1) {
#pragma unroll
      for (int nt = 0; nt < kTileTiles; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          l_res[x >> 1][(nt & 3) * 2 + (x & 1)] += sc[nt][x];
      __syncthreads();
      continue;
    }

    // w; do . v^T with the dropout (the stats launch's, read back by the
    // gradient launch)
    if constexpr (kGrad) {
#pragma unroll
      for (int nt = 0; nt < kTileTiles; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = tw + g + 8 * half;
          float2 v = make_float2(0.f, 0.f);
          if (t < T)
            v = *reinterpret_cast<const float2*>(dws + (long long)t * Sp + s0 +
                                                 nt * 8 + 2 * c);
          dw[nt][2 * half] = v.x;
          dw[nt][2 * half + 1] = v.y;
        }
      }
    } else {
      dots_fma<D>(dw, dos + warp * 16 * LD, vs, LD);
    }
    uint32_t kept_bits = 0xffffffffu;   // bit 4 * nt + x
#pragma unroll
    for (int nt = 0; nt < kTileTiles; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        sc[nt][x] = sc[nt][x] / l_row[x >> 1];
        if (a.dropout) {
          const int t = tw + g + 8 * (x >> 1);
          const int s = s0 + nt * 8 + 2 * c + (x & 1);
          if (!relbias::dropout_keep(key, t, s, S, a.threshold)) {
            kept_bits &= ~(1u << (4 * nt + x));
            if (!kGrad) dw[nt][x] = 0.f;
          } else if (!kGrad) {
            dw[nt][x] *= a.inv_keep;
          }
        }
      }
    }

    if constexpr (!kGrad) {
      // dw to its scratch; e = dw * w, summed into the row term by
      // row_term_kernel
#pragma unroll
      for (int nt = 0; nt < kTileTiles; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = tw + g + 8 * half;
          if (t < T) {
            const long long at = (long long)t * Sp + s0 + nt * 8 + 2 * c;
            *reinterpret_cast<float2*>(dws + at) =
                make_float2(dw[nt][2 * half], dw[nt][2 * half + 1]);
            *reinterpret_cast<float2*>(e_out + at) =
                make_float2(__fmul_rn(dw[nt][2 * half], sc[nt][2 * half]),
                            __fmul_rn(dw[nt][2 * half + 1], sc[nt][2 * half + 1]));
          }
        }
      }
    } else {
      // w_drop and ds in f32; ds to dbias / dmask; bf16 to the scratch
      __nv_bfloat16* dsb = a.ds + (long long)plane * T * Sp;
      __nv_bfloat16* wdb = a.wd + (long long)plane * T * Sp;
#pragma unroll
      for (int nt = 0; nt < kTileTiles; ++nt) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int half = x >> 1;
          const int t = tw + g + 8 * half;
          const int s = s0 + nt * 8 + 2 * c + (x & 1);
          const float w = sc[nt][x];
          const float w_drop =
              (kept_bits >> (4 * nt + x)) & 1u ? w * a.inv_keep : 0.f;
          const float ds = w * (dw[nt][x] - r_row[half]);
          if (t < T && s < S) {
            if constexpr (kWriteBias)
              a.dbias[((long long)plane * T + t) * S + s] = ds;
            if (a.dmask) atomicAdd(a.dmask + (long long)t * S + s, ds);
          }
          sc[nt][x] = ds;
          dw[nt][x] = w_drop;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = tw + g + 8 * half;
          if (t < T) {
            const long long at = (long long)t * Sp + s0 + nt * 8 + 2 * c;
            *reinterpret_cast<uint32_t*>(dsb + at) =
                mma::pack_bf16(sc[nt][2 * half], sc[nt][2 * half + 1]);
            *reinterpret_cast<uint32_t*>(wdb + at) =
                mma::pack_bf16(dw[nt][2 * half], dw[nt][2 * half + 1]);
          }
        }
      }

      // dq += ds . k, ds in bf16 straight from the registers
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t ads[4];
        mma::acc_to_a(ads, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < kDTiles / 2; ++np) {
          uint32_t bk[4];
          mma::load_b_trans(bk, ks, LD, kk * 16, np * 16);
          mma::mma_bf16(dqk[2 * np], ads, bk[0], bk[1]);
          mma::mma_bf16(dqk[2 * np + 1], ads, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();   // the next iteration stages into this buffer
  }

  if constexpr (!kGrad) {
    if (c == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = tw + g + 8 * half;
        if (t < T) {
          stats[(long long)plane * T + t] = m_row[half];
          stats[n_rows + (long long)plane * T + t] = l_row[half];
        }
      }
    }
  } else if constexpr (kRelbias) {
    store_acc<D>(dqk, a.dq_part + (long long)plane * T * D, (long long)D, tw, T);
  } else {
    store_acc<D>(dqk, a.dq + b * a.ldq.b + h * a.ldq.h, a.ldq.l, tw, T);
  }
}

// The row term sum_s e[t, s] of every row, one warp a row, in the order of
// PyTorch's reduction of a contiguous last dimension (ATen Reduce.cuh:
// `block_width` lanes, each with four accumulators -- over 4-element
// vectors when S >= 128, else over elements W apart -- combined in order,
// then a shuffle-down tree over the lanes with offsets halving), so that
// ds = w * (dw - row term) equals the plain version's bit for bit.
__global__ void row_term_kernel(const float* __restrict__ e, float* __restrict__ stats,
                                long long n_rows, int S, int Sp) {
  const long long row = blockIdx.x * (long long)(blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float* er = e + row * Sp;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int width;
  if (S >= 128) {
    width = 32;
    for (int v = lane; 4 * v + 3 < S; v += 32)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += er[4 * v + j];
    const int tail = S - S % 4 + lane;
    if (tail < S) acc[0] += er[tail];
  } else {
    width = 1;
    while (width * 2 <= S && width < 32) width *= 2;
    int idx = lane;
    for (; idx + 3 * width < S; idx += 4 * width)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += er[idx + j * width];
#pragma unroll
    for (int j = 0; j < 4; ++j, idx += width)
      if (idx < S) acc[j] += er[idx];
  }
  float v = ((acc[0] + acc[1]) + acc[2]) + acc[3];
  if (lane >= width) v = 0.f;
  for (int offset = width >> 1; offset > 0; offset >>= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, offset);
  if (lane == 0) stats[2 * n_rows + row] = v;
}

// acc (the warp's 16 columns of `at` by the head dim) += at[:, col0:+16]^T .
// bt over the 64 staged rows: at is (64, kSLd) bf16, bt (64, LD) bf16.
template <int D>
__device__ __forceinline__ void acc_tn(float (&acc)[mma::Dims<D>::kDot / 8][4],
                                       const __nv_bfloat16* at, int col0,
                                       const __nv_bfloat16* bt) {
  using Dm = mma::Dims<D>;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t aa[4];
    mma::load_a_trans(aa, at, kSLd, kk * 16, col0);
#pragma unroll
    for (int np = 0; np < Dm::kDot / 16; ++np) {
      uint32_t bb[4];
      mma::load_b_trans(bb, bt, Dm::kRow, kk * 16, np * 16);
      mma::mma_bf16(acc[2 * np], aa, bb[0], bb[1]);
      mma::mma_bf16(acc[2 * np + 1], aa, bb[2], bb[3]);
    }
  }
}

template <int D>
constexpr size_t cols_smem_bytes() {
  return sizeof(__nv_bfloat16) * 2 *
         (2 * kTile * mma::Dims<D>::kRow + 2 * kTile * kSLd);
}

// Stage 64 rows x 64 columns of a (T, Sp) bf16 scratch plane by cp.async;
// rows past T are zeros.
__device__ __forceinline__ void stage_scratch(__nv_bfloat16* tile,
                                              const __nv_bfloat16* plane,
                                              int Sp, int t0, int s0, int T) {
  for (int i = threadIdx.x; i < kTile * kTile / 8; i += kThreads) {
    const int r = i >> 3, ch = i & 7;
    __nv_bfloat16* dst = tile + r * kSLd + ch * 8;
    if (t0 + r < T)
      mma::cp_async16(dst, plane + (long long)(t0 + r) * Sp + s0 + ch * 8);
    else
      mma::zero_chunk(dst);
  }
}

template <typename In, int D>
__global__ void __launch_bounds__(kThreads)
cols_kernel(const In* __restrict__ q, const In* __restrict__ dout,
            const __nv_bfloat16* __restrict__ ds,
            const __nv_bfloat16* __restrict__ wd, In* __restrict__ dk,
            In* __restrict__ dv, Layout lq, Layout ldo, Layout ldkv, int H,
            int T, int S, int Sp) {
  using Dm = mma::Dims<D>;
  constexpr int LD = Dm::kRow;
  constexpr int kStage = 2 * kTile * LD + 2 * kTile * kSLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const In* qb = q + b * lq.b + h * lq.h;
  const In* dob = dout + b * ldo.b + h * ldo.h;
  const long long plane = (long long)(b * H + h) * T * Sp;
  const int nc = (T + kTile - 1) / kTile;

  auto stage = [&](int chunk, int buf) {
    __nv_bfloat16* qs = stages + buf * kStage;
    const int t0 = chunk * kTile;
    mma::stage_rows<D, kThreads>(qs, qb, lq.l, t0, kTile, T);
    mma::stage_rows<D, kThreads>(qs + kTile * LD, dob, ldo.l, t0, kTile, T);
    stage_scratch(qs + 2 * kTile * LD, ds + plane, Sp, t0, s0, T);
    stage_scratch(qs + 2 * kTile * LD + kTile * kSLd, wd + plane, Sp, t0, s0,
                  T);
  };

  float adk[Dm::kDot / 8][4] = {};
  float adv[Dm::kDot / 8][4] = {};
  stage(0, 0);
  mma::cp_async_commit();
  for (int it = 0; it < nc; ++it) {
    const int buf = it & 1;
    if (it + 1 < nc) {
      stage(it + 1, buf ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qs = stages + buf * kStage;
    const __nv_bfloat16* dss = qs + 2 * kTile * LD;
    acc_tn<D>(adk, dss, warp * 16, qs);
    acc_tn<D>(adv, dss + kTile * kSLd, warp * 16, qs + kTile * LD);
    __syncthreads();
  }
  const long long at = b * ldkv.b + h * ldkv.h;
  store_acc<D>(adk, dk + at, ldkv.l, s0 + warp * 16, S);
  store_acc<D>(adv, dv + at, ldkv.l, s0 + warp * 16, S);
}

template <int D>
constexpr size_t dqe_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (2 * (kBlockWin * mma::Dims<D>::kRow + kTile * kSLd) +
          kWarps * 16 * kDcLd);
}

// dq = dq_part + dc . E for the relative bias: one block of 4 warps per
// (b, h, 64 query rows), 16 rows a warp. Per key block it stages the bf16 ds
// of its rows (the gradient launch's scratch) and the 128 table rows they
// address; each warp writes its ds skewed into a zeroed dc tile over the 80
// table rows its 16 rows address, dc[i, s - s0 + (tw+15)/r - t/r] = ds[t, s],
// and adds dc . E_win on the tensor cores. Apart from the gradient launch,
// which then holds only K and V, both fill three blocks an SM.
template <typename In, int D>
__global__ void __launch_bounds__(kThreads)
dqe_kernel(const __nv_bfloat16* __restrict__ ds,
           const __nv_bfloat16* __restrict__ e,
           const float* __restrict__ dq_part, In* __restrict__ dq, Layout ldq,
           int H, int T, int S, int Sp) {
  using Dm = mma::Dims<D>;
  constexpr int LD = Dm::kRow;
  constexpr int kDTiles = Dm::kDot / 8;
  constexpr int kStage = kBlockWin * LD + kTile * kSLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tw = t0 + warp * 16;
  const int plane = b * H + h;
  const int ratio = T / S;
  const int nb = Sp / kTile;
  const int e_off = (S - 1) - (t0 + kTile - 1) / ratio;
  const int w_off = (t0 + kTile - 1) / ratio - (tw + 15) / ratio;
  const __nv_bfloat16* dsp = ds + (long long)plane * T * Sp;
  __nv_bfloat16* dc = stages + 2 * kStage + warp * 16 * kDcLd;

  auto stage = [&](int blk, int buf) {
    __nv_bfloat16* es = stages + buf * kStage;
    mma::stage_rows<D, kThreads>(es, e + (long long)h * (2 * S - 1) * D,
                                 (long long)D, blk * kTile + e_off, kBlockWin,
                                 2 * S - 1);
    stage_scratch(es + kBlockWin * LD, dsp, Sp, t0, blk * kTile, T);
  };

  float acc[kDTiles][4] = {};
  stage(0, 0);
  mma::cp_async_commit();
  for (int it = 0; it < nb; ++it) {
    const int buf = it & 1;
    if (it + 1 < nb) {
      stage(it + 1, buf ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* es = stages + buf * kStage;
    const __nv_bfloat16* dss = es + kBlockWin * LD + warp * 16 * kSLd;
    const int s0 = it * kTile;
    for (int i = lane; i < 16 * kDcLd / 8; i += 32) mma::zero_chunk(dc + i * 8);
    __syncwarp();
    for (int x = lane; x < 16 * kTile; x += 32) {
      const int i = x / kTile, j = x % kTile;
      if (s0 + j < S)
        dc[i * kDcLd + j + (tw + 15) / ratio - (tw + i) / ratio] =
            dss[i * kSLd + j];
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kWin / 16; ++kk) {
      uint32_t adc[4];
      mma::load_a(adc, dc, kDcLd, 0, kk * 16);
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        uint32_t be[4];
        mma::load_b_trans(be, es, LD, w_off + kk * 16, np * 16);
        mma::mma_bf16(acc[2 * np], adc, be[0], be[1]);
        mma::mma_bf16(acc[2 * np + 1], adc, be[2], be[3]);
      }
    }
    __syncthreads();   // the next iteration stages into this buffer
  }
  // dq = (ds . k) + (dc . E) in f32, rounded once
  const int g = lane >> 2, c = lane & 3;
  const float* part = dq_part + (long long)plane * T * D;
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
    const int d = nt * 8 + 2 * c;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = tw + g + 8 * half;
      if (t >= T) continue;
      const float2 p = *reinterpret_cast<const float2*>(part + (long long)t * D + d);
      In* out = dq + b * ldq.b + h * ldq.h + t * ldq.l + d;
      out[0] = relbias::from_float<In>(p.x + acc[nt][2 * half]);
      out[1] = relbias::from_float<In>(p.y + acc[nt][2 * half + 1]);
    }
  }
}

template <int D>
constexpr size_t table_smem_bytes() {
  return sizeof(__nv_bfloat16) * 2 *
         (kTile * mma::Dims<D>::kRow + kTile * kSLd);
}

// dE over one group of batch elements for 64 rows of E = [e1; e2[1:]]:
// row j is read by the query rows t with 0 <= j - shift(t) < S, shift(t) =
// (S-1) - t/r, a contiguous range of t for each block of rows. The skewed
// band dc of the next item is loaded into registers before the products of
// the current one and stored to shared memory after them, so its loads
// (2-byte, at no common alignment) wait behind the products.
constexpr int kGather = kTile * kTile / kThreads;   // dc values per thread

template <typename In, int D>
__global__ void __launch_bounds__(kThreads)
table_kernel(const In* __restrict__ q, const __nv_bfloat16* __restrict__ ds,
             float* __restrict__ partial, Layout lq, int B, int H, int T,
             int S, int Sp) {
  using Dm = mma::Dims<D>;
  constexpr int LD = Dm::kRow;
  constexpr int kStage = kTile * LD + kTile * kSLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int h = blockIdx.y;
  const int grp = blockIdx.z;
  const int j0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const int ratio = T / S;
  const int per_group = (B + gridDim.z - 1) / gridDim.z;
  const int b_lo = grp * per_group;
  const int b_hi = min(B, b_lo + per_group);
  const int t_lo = max(0, S - kTile - j0) * ratio;
  const int t_hi = min(T, (2 * S - 1 - j0) * ratio);
  const int per_b = t_hi > t_lo ? (t_hi - t_lo + kTile - 1) / kTile : 0;
  const int n = b_hi > b_lo ? (b_hi - b_lo) * per_b : 0;

  // thread i holds column jj = i % 64 of rows i / 64 + 2k of the band
  const int jj = threadIdx.x % kTile;
  const int r0 = threadIdx.x / kTile;
  __nv_bfloat16 held[kGather];
  auto stage_q = [&](int item, int buf) {
    const int b = b_lo + item / per_b;
    const int t0 = t_lo + (item % per_b) * kTile;
    mma::stage_rows<D, kThreads>(stages + buf * kStage, q + b * lq.b + h * lq.h,
                                 lq.l, t0, kTile, t_hi);
  };
  auto gather = [&](int item) {
    const int b = b_lo + item / per_b;
    const int t0 = t_lo + (item % per_b) * kTile;
    const __nv_bfloat16* plane = ds + (long long)(b * H + h) * T * Sp;
#pragma unroll
    for (int k = 0; k < kGather; ++k) {
      const int t = t0 + r0 + k * (kThreads / kTile);
      const int s = j0 + jj - (S - 1) + t / ratio;
      held[k] = (t < t_hi && s >= 0 && s < S) ? plane[(long long)t * Sp + s]
                                              : __float2bfloat16(0.f);
    }
  };
  auto put = [&](int buf) {
    __nv_bfloat16* dcs = stages + buf * kStage + kTile * LD;
#pragma unroll
    for (int k = 0; k < kGather; ++k)
      dcs[(r0 + k * (kThreads / kTile)) * kSLd + jj] = held[k];
  };

  float acc[Dm::kDot / 8][4] = {};
  if (n > 0) {
    stage_q(0, 0);
    mma::cp_async_commit();
    gather(0);
    put(0);
  }
  for (int it = 0; it < n; ++it) {
    const int buf = it & 1;
    if (it + 1 < n) {
      stage_q(it + 1, buf ^ 1);
      mma::cp_async_commit();
      gather(it + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qs = stages + buf * kStage;
    acc_tn<D>(acc, qs + kTile * LD, warp * 16, qs);
    // the other buffer's last reader finished before the barrier above
    if (it + 1 < n) put(buf ^ 1);
    __syncthreads();
  }
  store_acc<D>(acc, partial + ((long long)grp * H + h) * (2 * S - 1) * D,
               (long long)D, j0 + warp * 16, 2 * S - 1);
}

// de = the sum of the groups' partial tables, group 0 first.
__global__ void table_sum_kernel(const float* __restrict__ partial,
                                 float* __restrict__ de, long long n,
                                 int groups) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int grp = 0; grp < groups; ++grp) acc += partial[grp * n + i];
    de[i] = acc;
  }
}

inline int max_smem() {
  int device = 0, bytes = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return bytes;
}

// The rows kernel's two launches with the row-term sum between them, then
// the cols kernel, on `stream`; returns 0, an error code of
// relbias_common.cuh, or the first launch's cudaError_t.
template <typename In, int D, bool kRelbias, bool kWriteBias>
int launch_rows_cols(const RowsArgs<In>& a, In* dk, In* dv, Layout ldkv,
                     cudaStream_t stream) {
  if (!mma::rows_aligned<In>(a.q, a.lq.b, a.lq.h, a.lq.l) ||
      !mma::rows_aligned<In>(a.k, a.lkv.b, a.lkv.h, a.lkv.l) ||
      !mma::rows_aligned<In>(a.v, a.lkv.b, a.lkv.h, a.lkv.l) ||
      !mma::rows_aligned<In>(a.dout, a.ldo.b, a.ldo.h, a.ldo.l))
    return relbias::kErrAlign;
  const long long n_rows = (long long)a.B * a.H * a.T;
  // the e scratch of the stats launch is the ds and w_drop scratch, as one
  if (reinterpret_cast<const char*>(a.wd) !=
      reinterpret_cast<const char*>(a.ds) + 2 * n_rows * a.Sp)
    return relbias::kErrScratch;
  constexpr size_t stats_bytes = rows_smem_bytes<D, kRelbias, false>();
  constexpr size_t rows_bytes = rows_smem_bytes<D, kRelbias, true>();
  constexpr size_t cols_bytes = cols_smem_bytes<D>();
  if (rows_bytes > (size_t)max_smem() || cols_bytes > (size_t)max_smem())
    return relbias::kErrSharedMemory;
  const dim3 rows_grid((a.T + kTile - 1) / kTile, a.H, a.B);
  cudaFuncSetAttribute(rows_kernel<In, D, kRelbias, kWriteBias, false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)stats_bytes);
  rows_kernel<In, D, kRelbias, kWriteBias, false>
      <<<rows_grid, kThreads, stats_bytes, stream>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  row_term_kernel<<<(unsigned)((n_rows + 7) / 8), 256, 0, stream>>>(
      reinterpret_cast<const float*>(a.ds), a.scores + 2 * n_rows * a.Sp,
      n_rows, a.S, a.Sp);
  err = (int)cudaGetLastError();
  if (err) return err;
  cudaFuncSetAttribute(rows_kernel<In, D, kRelbias, kWriteBias, true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)rows_bytes);
  rows_kernel<In, D, kRelbias, kWriteBias, true>
      <<<rows_grid, kThreads, rows_bytes, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  cudaFuncSetAttribute(cols_kernel<In, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)cols_bytes);
  cols_kernel<In, D><<<dim3(a.Sp / kTile, a.H, a.B), kThreads, cols_bytes,
                       stream>>>(a.q, a.dout, a.ds, a.wd, dk, dv, a.lq, a.ldo,
                                 ldkv, a.H, a.T, a.S, a.Sp);
  return (int)cudaGetLastError();
}

// The relative bias's last launches, after launch_rows_cols: dq = dq_part +
// dc . E, the table kernel, and the fixed-order sum of its partial tables
// into de.
template <typename In, int D>
int launch_relbias(const RowsArgs<In>& a, float* partial, float* de,
                   cudaStream_t stream) {
  const int B = a.B, H = a.H, T = a.T, S = a.S, Sp = a.Sp;
  constexpr size_t dqe_bytes = dqe_smem_bytes<D>();
  if (dqe_bytes > (size_t)max_smem()) return relbias::kErrSharedMemory;
  cudaFuncSetAttribute(dqe_kernel<In, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)dqe_bytes);
  dqe_kernel<In, D><<<dim3((T + kTile - 1) / kTile, H, B), kThreads, dqe_bytes,
                      stream>>>(a.ds, a.e, a.dq_part, a.dq, a.ldq, H, T, S, Sp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const In* q = a.q;
  const __nv_bfloat16* ds = a.ds;
  const Layout lq = a.lq;
  constexpr size_t bytes = table_smem_bytes<D>();
  const int groups = table_groups(B);
  cudaFuncSetAttribute(table_kernel<In, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  table_kernel<In, D><<<dim3((2 * S - 1 + kTile - 1) / kTile, H, groups),
                        kThreads, bytes, stream>>>(q, ds, partial, lq, B, H, T,
                                                   S, Sp);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)H * (2 * S - 1) * D;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  table_sum_kernel<<<blocks, 256, 0, stream>>>(partial, de, n, groups);
  return (int)cudaGetLastError();
}

}  // namespace bwd_mma
