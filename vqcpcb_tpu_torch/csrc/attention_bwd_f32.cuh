// The rows pass of the attention backward's f32-dot instances, Hopper
// (sm_90a): the relative-bias backward (K2-bwd, K3-bwd) launched from
// relbias_attention_bwd.cu, and K6-bwd / K6-bwd-nobias launched from
// fused_attention_bwd.cu, each with f32 dots (VQCPCB_PALLAS_BF16_DOTS=0).
//
// Replaces: vqcpcb_tpu/ops/pallas_attention.py:_relbias_bwd_kernel_packed
// (:895) and :_relbias_bwd_kernel (:582) (kRel), :_train_bwd_kernel (:211)
// and :_train_bwd_kernel_nobias (:244), under _dots_dtype() = f32: the
// part of _relbias_bwd_head / the K6 backward that works along query rows.
// Per (b, h) plane and query row t, with the forward's scores, softmax and
// dropout mask regenerated:
//
//   score[s] = (q_t . k_s + mask[t, s]) + bias[t, s]
//              (kRel: bias[t, s] = q_t . E[s + (S-1) - t/r])
//   w = softmax(score)     dw = keep * (do_t . v_s) / (1-rate)
//   ds = w * (dw - sum_s dw*w)              w_drop = keep * w / (1-rate)
//   dq_t = ds . k (+ dc . E, summed apart: dc[t, s + (S-1) - t/r] = ds[t, s])
//
// ds and w_drop go to the (B, H, T, S) f32 scratch (row stride S) that the
// cols kernel (attention_bwd_cols.cuh: dk, dv) and, with kRel, the table
// kernel (dE) read; K6-bwd writes ds to dbias too, and dmask += ds by f32
// atomics when the caller asks (a mask that needs a gradient). dq needs no
// atomics: a second backward gives the same bits.
//
// What bounds it: the TPU kernel holds the whole (b, h) plane in VMEM. The
// CUDA-core kernels it replaces staged K, V (and the table window) of the
// whole plane, plus two f32 score rows of S per warp, in shared memory: at
// d = 64 about 840 S bytes, so S <= 273 with the relative bias and S <= 397
// without (S <= 209 at d = 128), below the flagship's T = S = 384 with the
// bias. Its work is five (kRel) or three (K6) of the backward's eight (or
// five) T x S x d products, on the CUDA cores (f32 fmaf chains; an
// f32-accurate tensor-core product would be 3xTF32); at the flagship's
// training shape the bound of the whole backward is its operations.
//
// What the design does about it: nothing in shared memory grows with S.
//  - A block of 8 warps owns 32 query rows of one (b, h) plane, a warp 4 of
//    them, lanes splitting the keys. Sweep 1 streams K, V and (kRel) the
//    window of E rows that the block's rows address for a block of 64 keys
//    (at most 64 + 31 rows: E[jlo + i], jlo = s0 + (S-1) - tmax/r, tmax
//    the block's last row) through shared memory, rows padded to d + 4
//    words so that 8 lanes reading 8 rows by 16 bytes hit 32 banks. Each
//    lane computes its keys' scores and do . v^T by fmaf chains and stores
//    them to the ds and w_drop scratch, keeping a running max of its row.
//  - Three passes along each row's scratch, each lane on its own keys
//    (no block synchronisation): p = exp(score - max) and its sum; the row
//    term sum dw * w; ds and w_drop, written over the scores and do . v^T.
//  - Sweep 2 streams K and the window again for dq: lanes split the head
//    dimension, each key's ds broadcast from the lane that owns it by a
//    shuffle, dq's two products held in registers across the key blocks.
//  - Key blocks whose mask entries are all the clamp (the causal mask's
//    upper blocks) are skipped in both sweeps where that is exact: their
//    weights are 0 when every row of the block has a live entry.
//  - Two blocks an SM up to d = 64 (at most 128 registers a thread).
// Shapes: d in {8, 16, 32, 64, 128}, any T and S (T a multiple of S with
// kRel); shared memory at d = 64 about 63 KB with kRel, 37 KB without.
#pragma once

#include "relbias_common.cuh"

namespace bwd_f32 {

using relbias::Bias;
using relbias::Layout;

constexpr int kWarps = relbias::kWarps;        // 8
constexpr int kThreads = relbias::kThreads;    // 256
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows a block
constexpr int kKeys = 64;                      // keys per streamed block
constexpr int kWinRows = kKeys + kRows;        // rows of E a pair addresses, at most
constexpr float kClamp = -1e30f;               // finite_mask's clamp of -inf

struct RowsArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* mask;   // (T, S), finite
  const float* e;      // kRel: the (H, 2S-1, d) f32 combined table
  Bias bias;           // not kRel: p may be null
  const float* dout;
  float* dq;
  float* ds;           // (B, H, T, S) f32: scores, then ds
  float* wd;           // (B, H, T, S) f32: do . v^T, then w_drop
  float* dbias;        // K6-bwd: (B*H, T, S) f32, or null
  float* dmask;        // (T, S) f32 summed over (b, h), or null
  Layout lq, lkv, ldo, ldq;
  int B, H, T, S;
  uint32_t seed, threshold;
  float inv_keep;
  int dropout;
};

template <int D>
__host__ __device__ constexpr int row_ld() {
  return D + 4;
}

template <int D, bool kRel>
__host__ __device__ inline size_t rows_smem_bytes() {
  return sizeof(float) *
         ((size_t)(2 * kKeys + (kRel ? kWinRows : 0)) * row_ld<D>() +
          (size_t)kWarps * D);
}

// Rows [first, first + n) of a (rows, D) view with row stride `row` into a
// padded tile; rows from `valid` on, and past n, are zeros up to `rows`.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      long long row, int first, int n,
                                      int valid, int rows) {
  constexpr int LD = row_ld<D>();
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * LD + c] =
        r < n && first + r < valid ? src[(first + r) * row + c] : 0.f;
  }
}

template <int D, bool kRel, bool kWriteBias>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
rows_kernel(const RowsArgs a) {
  constexpr int LD = row_ld<D>();
  constexpr int kPairs = (D / 2 + 31) / 32;   // column pairs a lane owns in dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kKeys * LD;
  float* es = vs + kKeys * LD;                 // kRel
  float* dos = es + (kRel ? kWinRows * LD : 0);

  const int T = a.T, S = a.S;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kRows;
  const int tmax = min(t0 + kRows - 1, T - 1);
  const int ratio = kRel ? T / S : 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* qb = a.q + b * a.lq.b + h * a.lq.h;
  const float* kb = a.k + b * a.lkv.b + h * a.lkv.h;
  const float* vb = a.v + b * a.lkv.b + h * a.lkv.h;
  const float* dob = a.dout + b * a.ldo.b + h * a.ldo.h;
  const float* eh = kRel ? a.e + (long long)h * (2 * S - 1) * D : nullptr;
  const int plane = b * a.H + h;
  const long long scratch = (long long)plane * T * S;
  const uint32_t key = kRel ? relbias::stream_key(a.seed, h, b, a.B)
                            : relbias::plane_key(a.seed, plane);
  const float* bp = a.bias.p ? a.bias.p + plane * a.bias.bh : nullptr;
  float* dor = dos + warp * D;                 // the row of do
  // the warp's rows t0 + warp + 8 rr; their window offsets tmax/r - t/r
  int woff[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
    woff[rr] = tmax / ratio - min(t0 + warp + kWarps * rr, tmax) / ratio;
  auto stage_block = [&](int s0, int nk, bool with_v) {
    stage<D>(ks, kb, a.lkv.l, s0, nk, S, kKeys);
    if (with_v) stage<D>(vs, vb, a.lkv.l, s0, nk, S, kKeys);
    if constexpr (kRel) {
      const int n_win = nk + tmax / ratio - t0 / ratio;
      stage<D>(es, eh, D, s0 + (S - 1) - tmax / ratio, n_win, 2 * S - 1,
               kWinRows);
    }
  };

  // Dead key blocks: when every row of the block has a mask entry above the
  // clamp, a key block whose entries are all the clamp has weights of
  // exactly 0; its scores are the clamp as computed (the products are far
  // below the clamp's rounding step) and its do . v^T enters nothing, so
  // sweep 1 writes the clamp and 0 and sweep 2 skips it (blocks past the
  // 64th are computed in sweep 2). A fully masked row (weights 1/S) makes
  // the block skip nothing.
  bool dead_row = false;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = t0 + warp + kWarps * rr;
    if (t >= T) break;
    bool live = false;
    for (int s = lane; s - lane < S && !live; s += 32)
      live = __any_sync(0xffffffffu, s < S && a.mask[(long long)t * S + s] != kClamp);
    dead_row |= !live;
  }
  const bool may_skip = !__syncthreads_or(dead_row);
  auto block_live = [&](int s0, int nk) {   // the same on every thread
    if (!may_skip) return true;
    bool live = false;
    for (int i = threadIdx.x; i < (tmax - t0 + 1) * nk; i += kThreads) {
      const int r = i / nk;
      live |= a.mask[(long long)(t0 + r) * S + s0 + i - r * nk] != kClamp;
    }
    return __syncthreads_or(live) != 0;
  };
  unsigned long long live_bits = 0;

  // sweep 1: scores and do . v^T into the scratch, each lane's running max
  float m[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) m[rr] = -INFINITY;
  for (int s0 = 0; s0 < S; s0 += kKeys) {
    const int nk = min(kKeys, S - s0);
    if (!block_live(s0, nk)) {
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int t = t0 + warp + kWarps * rr;
        if (t >= T) break;
        for (int kk = lane; kk < nk; kk += 32) {
          a.ds[scratch + (long long)t * S + s0 + kk] = kClamp;
          a.wd[scratch + (long long)t * S + s0 + kk] = 0.f;
        }
        m[rr] = fmaxf(m[rr], kClamp);
      }
      continue;
    }
    if (s0 / kKeys < 64) live_bits |= 1ull << (s0 / kKeys);
    stage_block(s0, nk, true);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int t = t0 + warp + kWarps * rr;
      if (t >= T) break;
      float qr[D];
#pragma unroll
      for (int j = 0; j < D; ++j) qr[j] = qb[t * a.lq.l + j];
      for (int j = lane; j < D; j += 32) dor[j] = dob[t * a.ldo.l + j];
      __syncwarp();
      const float* mrow = a.mask + (long long)t * S;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kk = lane + 32 * u;          // the key within the block
        if (kk >= nk) break;
        const float* kr = ks + kk * LD;
        const float* vr = vs + kk * LD;
        const float* er = es + (kk + woff[rr]) * LD;
        float acc_k = 0.f, acc_e = 0.f, acc_v = 0.f;
#pragma unroll
        for (int j = 0; j < D; j += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + j);
          const float4 v4 = *reinterpret_cast<const float4*>(vr + j);
          const float4 d4 = *reinterpret_cast<const float4*>(dor + j);
          acc_k = fmaf(qr[j], k4.x, acc_k);
          acc_k = fmaf(qr[j + 1], k4.y, acc_k);
          acc_k = fmaf(qr[j + 2], k4.z, acc_k);
          acc_k = fmaf(qr[j + 3], k4.w, acc_k);
          acc_v = fmaf(d4.x, v4.x, acc_v);
          acc_v = fmaf(d4.y, v4.y, acc_v);
          acc_v = fmaf(d4.z, v4.z, acc_v);
          acc_v = fmaf(d4.w, v4.w, acc_v);
          if constexpr (kRel) {
            const float4 e4 = *reinterpret_cast<const float4*>(er + j);
            acc_e = fmaf(qr[j], e4.x, acc_e);
            acc_e = fmaf(qr[j + 1], e4.y, acc_e);
            acc_e = fmaf(qr[j + 2], e4.z, acc_e);
            acc_e = fmaf(qr[j + 3], e4.w, acc_e);
          }
        }
        const int s = s0 + kk;
        float score = __fadd_rn(acc_k, mrow[s]);
        if constexpr (kRel) score = __fadd_rn(score, acc_e);
        if (bp) score = __fadd_rn(score, bp[t * a.bias.t + s * a.bias.s]);
        a.ds[scratch + (long long)t * S + s] = score;
        a.wd[scratch + (long long)t * S + s] = acc_v;
        m[rr] = fmaxf(m[rr], score);
      }
      __syncwarp();   // dor is rewritten by the next row
    }
    __syncthreads();  // the tiles are restaged by the next block
  }

  // along each row: the softmax, the dropout, the row term, ds and w_drop
  // (each lane reads back only the entries it wrote)
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = t0 + warp + kWarps * rr;
    if (t >= T) break;
    float* srow = a.ds + scratch + (long long)t * S;
    float* wrow = a.wd + scratch + (long long)t * S;
    const float mx = relbias::warp_max(m[rr]);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float p = expf(srow[s] - mx);
      srow[s] = p;
      sum += p;
    }
    sum = relbias::warp_sum(sum);
    float row_term = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float w = srow[s] / sum;
      float dw = wrow[s];
      if (a.dropout)
        dw = relbias::dropout_keep(key, t, s, S, a.threshold) ? dw * a.inv_keep
                                                               : 0.f;
      row_term = __fadd_rn(row_term, __fmul_rn(dw, w));
    }
    row_term = relbias::warp_sum(row_term);
    for (int s = lane; s < S; s += 32) {
      const float w = srow[s] / sum;
      float dw = wrow[s], w_drop = w;
      if (a.dropout) {
        const bool kept = relbias::dropout_keep(key, t, s, S, a.threshold);
        w_drop = kept ? w * a.inv_keep : 0.f;
        dw = kept ? dw * a.inv_keep : 0.f;
      }
      const float ds = w * (dw - row_term);
      if (kWriteBias) a.dbias[scratch + (long long)t * S + s] = ds;
      if (a.dmask) atomicAdd(a.dmask + (long long)t * S + s, ds);
      srow[s] = ds;
      wrow[s] = w_drop;
    }
  }

  // sweep 2: dq = ds . k (+ dc . E), the two products summed apart; lanes
  // split the head dimension, each key's ds broadcast from its lane
  float dk_acc[kRowsPerWarp][kPairs][2] = {};
  float de_acc[kRel ? kRowsPerWarp : 1][kPairs][2] = {};
  for (int s0 = 0; s0 < S; s0 += kKeys) {
    const int nk = min(kKeys, S - s0);
    if (s0 / kKeys < 64 && !((live_bits >> (s0 / kKeys)) & 1)) continue;
    stage_block(s0, nk, false);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int t = t0 + warp + kWarps * rr;
      if (t >= T) break;
      const float* srow = a.ds + scratch + (long long)t * S + s0;
      const float own0 = lane < nk ? srow[lane] : 0.f;
      const float own1 = lane + 32 < nk ? srow[lane + 32] : 0.f;
      for (int kk = 0; kk < nk; ++kk) {
        const float d = __shfl_sync(0xffffffffu, kk < 32 ? own0 : own1, kk & 31);
#pragma unroll
        for (int pi = 0; pi < kPairs; ++pi) {
          const int p = lane + 32 * pi;
          if (p < D / 2) {
            const float2 k2 = *reinterpret_cast<const float2*>(ks + kk * LD + 2 * p);
            dk_acc[rr][pi][0] = fmaf(d, k2.x, dk_acc[rr][pi][0]);
            dk_acc[rr][pi][1] = fmaf(d, k2.y, dk_acc[rr][pi][1]);
            if constexpr (kRel) {
              const float2 e2 = *reinterpret_cast<const float2*>(
                  es + (kk + woff[rr]) * LD + 2 * p);
              de_acc[rr][pi][0] = fmaf(d, e2.x, de_acc[rr][pi][0]);
              de_acc[rr][pi][1] = fmaf(d, e2.y, de_acc[rr][pi][1]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = t0 + warp + kWarps * rr;
    if (t >= T) break;
    float* o = a.dq + b * a.ldq.b + h * a.ldq.h + t * a.ldq.l;
#pragma unroll
    for (int pi = 0; pi < kPairs; ++pi) {
      const int p = lane + 32 * pi;
      if (p < D / 2) {
        float x = dk_acc[rr][pi][0], y = dk_acc[rr][pi][1];
        if constexpr (kRel) {
          x += de_acc[rr][pi][0];
          y += de_acc[rr][pi][1];
        }
        o[2 * p] = x;
        o[2 * p + 1] = y;
      }
    }
  }
}

// Launch the rows pass on `stream`: one block per (32 query rows, h, b).
// Returns kErrSharedMemory when the block does not fit (it does at every
// d here: 122 KB at d = 128 with kRel), else the launch's cudaError_t.
template <int D, bool kRel, bool kWriteBias>
int launch_rows(const RowsArgs& a, cudaStream_t stream) {
  auto kernel = rows_kernel<D, kRel, kWriteBias>;
  const size_t bytes = rows_smem_bytes<D, kRel>();
  int device = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (bytes > (size_t)max_smem) return relbias::kErrSharedMemory;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  kernel<<<dim3((a.T + kRows - 1) / kRows, a.H, a.B), kThreads, bytes,
           stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bwd_f32
