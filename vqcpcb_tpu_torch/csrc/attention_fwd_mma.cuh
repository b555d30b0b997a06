// The attention forward's bf16-dot instances, Hopper (sm_90a): K2-fwd and
// K3-fwd (relbias_attention.cu) and K6-fwd (fused_attention.cu), for f32 or
// bf16 inputs. The f32-dot instances are K4 and K6's f32-dot forward
// (attention_fwd_f32.cuh: 3xTF32 on the tensor cores) and the f32-dot
// relative-bias forward (the CUDA-core kernel of relbias_attention.cu).
//
// Replaces: vqcpcb_tpu/ops/pallas_attention.py:_relbias_fwd_kernel_packed
// (K2-fwd), :_relbias_fwd_kernel (K3-fwd) and :_train_fwd_kernel (K6-fwd).
// Per (b, h) plane, with the rounding points of _relbias_fwd_head and
// _train_fwd_kernel (q, k, v and E in bf16 before the products):
//
//   score[t, s] = ((q_t . k_s) + mask[t, s]) + bias[t, s]
//   w[t]  = exp(score[t] - max) / sum          (f32, full row)
//   out[t] = bf16(dropout(w[t])) . v           (f32 sums, stored as the input)
//
// with bias = q_t . E[s + (S-1) - t/r] (relative bias, r = T/S, E the
// combined table), K6's explicit f32 bias, or none.
//
// What bounds it on the H100: at B = 32, H = 8, T = S = 384, d = 64 the
// two (K6) or three (K2) T x S x d products per plane are 4.8-7.2 GFLOP on
// about 50 MB of bf16 q, k, v and out (and the f32 mask and table): below
// the bf16 tensor-core ridge, so the bound is the bytes (0.015 ms).
//
// What sets the design: the weights are rounded to bf16 before w . v, and a
// weight whose f32 value differs from the plain version's in its last bit
// may round to the other bf16 neighbour, moving out as far as a skipped
// rounding point (the backward's lesson, attention_bwd_mma.cuh). So the
// weights equal the plain version's bit for bit:
//  - the scores and the relative bias are f32 fmaf chains over the head dim
//    in ascending order, as an f32 matrix product on the card takes them:
//    the backward's dots_fma and bias_fma at half width, a register tile in
//    the mma accumulator layout (each thread 2 query rows x 8 keys of a
//    warp's 16 x 32 slice of a key block; every K / E element loaded from
//    shared memory feeds two rows' chains, every q element eight keys', and
//    at ratio 1 each table row loaded serves two query rows);
//  - the scores stay resident in shared memory as f32 until the whole row
//    is known; the max, exp and sum then read them in the layout of
//    PyTorch's warp softmax itself: one warp per row, lane l takes the keys
//    s = l (mod 32) in ascending order, then a butterfly over lanes 16, 8,
//    4, 2, 1 -- the order by construction, no reconstruction from the tile;
//  - w = p / sum, dropout by the K5 hash with the f32 keep scale, then bf16.
// Only the product after the rounding point, out = bf16(w_drop) . v, runs on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums): each warp rounds
// its 16 rows' weights of a 16-key slice straight into an A fragment and
// multiplies it by V fragments loaded with ldmatrix.trans.
//
// Blocks: G row groups of 16 query rows (G = 4, 2 or 1, the launcher's
// choice: the most resident warps an SM, then the larger tile), two warps a
// group, each taking one half (32 keys) of every key block in passes 1 and
// 3 and half the group's rows in pass 2; the halves of w . v are summed at
// the end. K (and the window of E the block's rows address) and then V
// stream through shared memory in blocks of 64 keys by cp.async,
// double-buffered, instead of the whole (b, h) plane; what stays resident
// is the block's q tile and its f32 score rows (16 G x S, 50 KB at G = 2,
// S = 384: three blocks, 12 warps, an SM for K6, two for K2 with its table
// window). Three passes: (1) the scores of every live key block, the mask
// (and bias) terms loaded ahead of the chains; (2) per row max, exp and
// sum, the exps written over the scores; (3) w . v over the live key
// blocks, whose first V block is staged during pass 2.
//
// Skipping fully masked key blocks, where it is exact: a key block is dead
// for the block's query rows when every mask entry of the pair is the clamp
// value -1e30 (finite_mask's -inf). When, besides, every query row of the
// tile has a mask entry above -1e29, those entries' scores lie within
// |q.k + bias| of it, so for any |q.k + bias| < 1e29 the row max is above
// -2e29, every dead entry's score is below -9e29, and exp(score - max) is
// exactly 0: the dead blocks add exact zeros to the sum and to w . v, and
// are skipped in all three passes. A tile with a fully masked row (its
// weights are the uniform 1/S) skips nothing.
#pragma once

#include "attention_bwd_mma.cuh"

namespace fwd_mma {

using bwd_mma::kTile;        // keys per staged block
using bwd_mma::kTileTiles;   // n-tiles of a key block
using relbias::Bias;
using relbias::Layout;

constexpr int kMaxGroups = 4;      // row groups of 16 rows, two warps each
constexpr float kClamp = -1e30f;       // finite_mask's clamp of -inf
constexpr float kLiveFloor = -1e29f;   // a row entry above it keeps the row live

template <typename In>
struct FwdArgs {
  const In* q;
  const In* k;
  const In* v;
  const float* mask;   // (T, S), finite
  const float* e;      // (H, 2S-1, D) f32 table (relative bias), else null
  Bias bias;           // explicit bias (K6), p may be null
  In* out;
  Layout lq, lkv, lo;
  int B, H, T, S;
  uint32_t seed, threshold;
  float inv_keep;
  int dropout;
  int aligned;         // every staged q, k, v row starts on 16 bytes
};

// Shared memory of a block of `groups` row groups: the q tile, two staging
// buffers (64 keys of K or V, and the relative bias's table window of
// 64 + 16 groups rows), the f32 score rows (S rounded up to 64, plus 8 floats
// so a warp's float2 stores of 4 rows fall in 32 different banks), the
// row sums and two 64-bit flag words.
__host__ __device__ inline int score_ld(int S) {
  return (S + kTile - 1) / kTile * kTile + 8;
}

__host__ __device__ inline int stage_rows_of(int groups, bool relbias) {
  return kTile + (relbias ? kTile + 16 * groups : 0);
}

template <int D>
__host__ __device__ inline size_t fwd_smem_bytes(int groups, int S,
                                                 bool relbias) {
  const int rows = 16 * groups;
  return sizeof(__nv_bfloat16) * mma::Dims<D>::kRow *
             (size_t)(rows + 2 * stage_rows_of(groups, relbias)) +
         sizeof(float) * ((size_t)rows * score_ld(S) + rows) +
         2 * sizeof(unsigned long long);
}

// Stage `rows` rows of head dim D (row r at src + (first + r) * stride)
// into a padded bf16 tile, as mma::stage_rows does, for any block size and
// for rows that need not start on 16 bytes (element by element, rounded to
// nearest even like every other conversion here). bf16 rows on 16 bytes go
// by cp.async; f32 rows (the table, f32 inputs) are loaded eight chunks a
// thread at a time before any is converted and stored, so a thread waits
// for one round trip per eight chunks rather than one per chunk.
template <int D, typename In>
__device__ __forceinline__ void stage(__nv_bfloat16* tile,
                                      const In* __restrict__ src,
                                      long long stride, int first, int rows,
                                      int valid, bool aligned) {
  using Dm = mma::Dims<D>;
  const int n = rows * Dm::kChunks;
  if (aligned && sizeof(In) == 2) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / Dm::kChunks, ch = i - r * Dm::kChunks;
      __nv_bfloat16* dst = tile + r * Dm::kRow + ch * 8;
      const int row = first + r;
      if (row >= 0 && row < valid && ch * 8 < D)
        mma::stage_chunk(dst, src + row * stride + ch * 8);
      else
        mma::zero_chunk(dst);
    }
    return;
  }
  // (bf16 rows reach this loop only when misaligned: one chunk at a time
  // keeps the batch's registers out of the kernels that stage nothing else)
  constexpr int kBatch = sizeof(In) == 4 ? 8 : 1;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    float x[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = i / Dm::kChunks, ch = i - r * Dm::kChunks;
      const int row = first + r;
      const bool live = i < n && row >= 0 && row < valid && ch * 8 < D;
      const In* p = src + (live ? row * stride + ch * 8 : 0);
      if (live && aligned) {
        if constexpr (sizeof(In) == 4) {
          const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
          const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
          x[u][0] = lo.x; x[u][1] = lo.y; x[u][2] = lo.z; x[u][3] = lo.w;
          x[u][4] = hi.x; x[u][5] = hi.y; x[u][6] = hi.z; x[u][7] = hi.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          x[u][e] = live ? relbias::to_float(p[e]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= n) break;
      const int r = i / Dm::kChunks, ch = i - r * Dm::kChunks;
      uint4 v;
      v.x = mma::pack_bf16(x[u][0], x[u][1]);
      v.y = mma::pack_bf16(x[u][2], x[u][3]);
      v.z = mma::pack_bf16(x[u][4], x[u][5]);
      v.w = mma::pack_bf16(x[u][6], x[u][7]);
      *reinterpret_cast<uint4*>(tile + r * Dm::kRow + ch * 8) = v;
    }
  }
}

// The next set bit of `bits` above bit `j` (-1 for j = -1: the first), or -1.
__device__ __forceinline__ int next_block(unsigned long long bits, int j) {
  const unsigned long long rest = j >= 63 ? 0ull : bits & (~0ull << (j + 1));
  return rest ? __ffsll((long long)rest) - 1 : -1;
}

template <typename In, int D, bool kRelbias>
__global__ void __launch_bounds__(2 * kMaxGroups * 32)
fwd_kernel(const FwdArgs<In> a) {
  using Dm = mma::Dims<D>;
  constexpr int LD = Dm::kRow;
  constexpr int kDTiles = Dm::kDot / 8;
  constexpr int kNT = kTileTiles / 2;              // n-tiles of a warp's 32 keys
  const int warps = blockDim.x >> 5;
  const int groups = warps >> 1;
  const int rows = 16 * groups;
  const int T = a.T, S = a.S;
  const int ld_s = score_ld(S);
  const int nb = (ld_s - 8) / kTile;               // key blocks
  const int stage_n = stage_rows_of(groups, kRelbias);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* stages = qs + rows * LD;
  float* scores = reinterpret_cast<float*>(stages + 2 * stage_n * LD);
  float* sums = scores + rows * ld_s;
  unsigned long long* flags = reinterpret_cast<unsigned long long*>(sums + rows);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * rows;
  const int n_rows = min(rows, T - t0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int rg = warp >> 1;                        // the warp's row group
  const int kh = warp & 1;                         // and half of each key block
  const int tw = t0 + rg * 16;                     // the group's first row
  const int plane = b * a.H + h;
  const int ratio = kRelbias ? T / S : 1;
  const In* kb = a.k + b * a.lkv.b + h * a.lkv.h;
  const In* vb = a.v + b * a.lkv.b + h * a.lkv.h;
  // key block s0 addresses table rows s0 + e_off .. + 64 + rows; the
  // group's rows address those from w_off on (bwd_mma::bias_fma)
  const int e_off = (S - 1) - (t0 + rows - 1) / ratio;
  const int w_off = (t0 + rows - 1) / ratio - (tw + 15) / ratio;
  const uint32_t key = kRelbias ? relbias::stream_key(a.seed, h, b, a.B)
                                : relbias::plane_key(a.seed, plane);
  const float* bp = a.bias.p ? a.bias.p + plane * a.bias.bh : nullptr;
  const bool aligned = a.aligned != 0;

  auto stage_k = [&](int j, int buf) {
    __nv_bfloat16* ks = stages + buf * stage_n * LD;
    stage<D>(ks, kb, a.lkv.l, j * kTile, kTile, S, aligned);
    if constexpr (kRelbias)
      stage<D>(ks + kTile * LD, a.e + (long long)h * (2 * S - 1) * D,
               (long long)D, j * kTile + e_off, stage_n - kTile, 2 * S - 1,
               true);
  };
  auto stage_v = [&](int j, int buf) {
    stage<D>(stages + buf * stage_n * LD, vb, a.lkv.l, j * kTile, kTile, S,
             aligned);
  };

  stage<D>(qs, a.q + b * a.lq.b + h * a.lq.h, a.lq.l, t0, rows, T, aligned);

  // which key blocks hold a mask entry other than the clamp, and which
  // rows one above kLiveFloor: the tile's n_rows x S mask entries, one
  // contiguous run, read in batches of eight independent loads a thread
  // (16 bytes each where every row starts on 16 bytes)
  if (threadIdx.x == 0) flags[0] = flags[1] = 0ull;
  __syncthreads();
  {
    unsigned long long live = 0ull, rows_live = 0ull;
    const float* run = a.mask + (long long)t0 * S;
    const int vec = (S & 3) == 0 ? 4 : 1;          // entries a load
    const int n = n_rows * S / vec;
    for (int i0 = threadIdx.x; i0 < n; i0 += 8 * blockDim.x) {
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * blockDim.x;
        x[u] = make_float4(kClamp, kClamp, kClamp, kClamp);
        if (i < n) {
          if (vec == 4) x[u] = __ldg(reinterpret_cast<const float4*>(run) + i);
          else x[u].x = __ldg(run + i);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = vec * (i0 + u * blockDim.x);
        if (i >= n_rows * S) break;
        const int r = i / S, s = i - r * S;        // the entries share a row
        const float hi = fmaxf(fmaxf(x[u].x, x[u].y), fmaxf(x[u].z, x[u].w));
        const float lo = fminf(fminf(x[u].x, x[u].y), fminf(x[u].z, x[u].w));
        if (hi != kClamp || lo != kClamp) live |= 1ull << (s / kTile);
        if (hi > kLiveFloor) rows_live |= 1ull << r;
      }
    }
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const unsigned long long bits = w ? rows_live : live;
      const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)bits);
      const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(bits >> 32));
      if (lane == 0 && (lo | hi))
        atomicOr(&flags[w], ((unsigned long long)hi << 32) | lo);
    }
  }
  __syncthreads();
  const unsigned long long all_rows =
      n_rows == 64 ? ~0ull : (1ull << n_rows) - 1;
  const unsigned long long all_blocks = nb == 64 ? ~0ull : (1ull << nb) - 1;
  const unsigned long long live =
      (flags[1] & all_rows) == all_rows ? flags[0] & all_blocks : all_blocks;

  // pass 1: the scores (+ mask, + bias) of the live key blocks, each warp
  // its group's 16 rows by its 32 keys of the block; -inf past the last key
  int j = next_block(live, -1);
  stage_k(j, 0);
  mma::cp_async_commit();
  float* srow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    srow[half] = scores + (rg * 16 + g + 8 * half) * ld_s;
  for (int buf = 0; j >= 0; buf ^= 1) {
    const int jn = next_block(live, j);
    if (jn >= 0) {
      stage_k(jn, buf ^ 1);
      mma::cp_async_commit();
    }
    // the mask (and bias) terms, loaded ahead of the chains
    const int s0 = j * kTile + 32 * kh;
    float add[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = tw + g + 8 * (x >> 1);
        const int s = s0 + nt * 8 + 2 * c + (x & 1);
        add[nt][x] = 0.f;
        if (t < T && s < S) add[nt][x] = a.mask[(long long)t * S + s];
      }
    }
    float bias_k[kRelbias ? 1 : kNT][4];
    if constexpr (!kRelbias) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = tw + g + 8 * (x >> 1);
          const int s = s0 + nt * 8 + 2 * c + (x & 1);
          bias_k[nt][x] = bp && t < T && s < S
                              ? bp[t * a.bias.t + s * a.bias.s] : 0.f;
        }
    }
    if (jn >= 0) mma::cp_async_wait<1>();
    else mma::cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16* ks = stages + buf * stage_n * LD;
    float sc[kNT][4];
    bwd_mma::dots_fma<D, kNT>(sc, qs + rg * 16 * LD, ks + 32 * kh * LD, LD);
    float bi[kRelbias ? kNT : 1][4];
    if constexpr (kRelbias)
      bwd_mma::bias_fma<D, kNT>(bi, qs + rg * 16 * LD,
                                ks + (kTile + 32 * kh) * LD, LD, w_off, tw,
                                ratio);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int s = s0 + nt * 8 + 2 * c + (x & 1);
        float score = -INFINITY;
        if (s < S) {
          score = __fadd_rn(sc[nt][x], add[nt][x]);
          if constexpr (kRelbias) {
            score = __fadd_rn(score, bi[nt][x]);
          } else {
            if (bp) score = __fadd_rn(score, bias_k[nt][x]);
          }
        }
        sc[nt][x] = score;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(srow[half] + s0 + nt * 8 + 2 * c) =
            make_float2(sc[nt][2 * half], sc[nt][2 * half + 1]);
    }
    __syncthreads();   // the next iteration stages into this buffer
    j = jn;
  }

  // V's first live block streams in during pass 2
  j = next_block(live, -1);
  stage_v(j, 0);
  mma::cp_async_commit();

  // pass 2, one warp per row in PyTorch's warp-softmax layout: the max,
  // then p = exp(score - max) over the scores and the sum of p; each warp
  // 8 of its group's rows, four at a time, each with its own chains
  for (int r0 = 8 * kh; r0 < 8 * kh + 8; r0 += 4) {
    float* row[4];
    float m[4], sum[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      row[u] = scores + (rg * 16 + r0 + u) * ld_s;
      m[u] = -INFINITY;
      sum[u] = 0.f;
    }
    for (int s = lane; s < S; s += 32) {
      if ((live >> (s / kTile)) & 1ull) {
#pragma unroll
        for (int u = 0; u < 4; ++u) m[u] = fmaxf(m[u], row[u][s]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) m[u] = relbias::warp_max(m[u]);
    for (int s = lane; s < S; s += 32) {
      if ((live >> (s / kTile)) & 1ull) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float p = expf(row[u][s] - m[u]);
          row[u][s] = p;
          sum[u] += p;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      sum[u] = relbias::warp_sum(sum[u]);
      // rows past T hold no scores: their weights are set to 0 in pass 3
      if (lane == 0) sums[rg * 16 + r0 + u] = tw + r0 + u < T ? sum[u] : 1.f;
    }
  }
  __syncthreads();
  float l_row[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) l_row[half] = sums[rg * 16 + g + 8 * half];

  // pass 3: out = bf16(w_drop) . v over the live key blocks, each warp its
  // 32 keys of each, the weights rounded straight into A fragments, 16
  // keys at a time; the two warps of a group sum their parts at the end
  float acc[kDTiles][4] = {};
  for (int buf = 0; j >= 0; buf ^= 1) {
    const int jn = next_block(live, j);
    if (jn >= 0) {
      stage_v(jn, buf ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* vs = stages + buf * stage_n * LD;
#pragma unroll
    for (int kk = 2 * kh; kk < 2 * kh + 2; ++kk) {
      float wt[2][4];   // keys 16 kk + (0..7), + (8..15), accumulator layout
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = tw + g + 8 * half;
          const int s = j * kTile + kk * 16 + hi * 8 + 2 * c;
          const float2 p = *reinterpret_cast<const float2*>(srow[half] + s);
          const float pv[2] = {p.x, p.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float w = 0.f;
            if (t < T && s + e < S) {
              w = pv[e] / l_row[half];
              if (a.dropout)
                w = relbias::dropout_keep(key, t, s + e, S, a.threshold)
                        ? w * a.inv_keep
                        : 0.f;
            }
            wt[hi][2 * half + e] = w;
          }
        }
      }
      uint32_t aw[4];
      mma::acc_to_a(aw, wt[0], wt[1]);
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        uint32_t bv[4];
        mma::load_b_trans(bv, vs, LD, kk * 16, np * 16);
        mma::mma_bf16(acc[2 * np], aw, bv[0], bv[1]);
        mma::mma_bf16(acc[2 * np + 1], aw, bv[2], bv[3]);
      }
    }
    __syncthreads();   // the next iteration stages into this buffer
    j = jn;
  }
  // the second half's part through the (now idle) staging buffers, in the
  // accumulator layout: part[group][tile][x][lane]
  float* part = reinterpret_cast<float*>(stages) + rg * kDTiles * 4 * 32 + lane;
  if (kh == 1) {
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) part[(nt * 4 + x) * 32] = acc[nt][x];
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[nt][x] += part[(nt * 4 + x) * 32];
    bwd_mma::store_acc<D>(acc, a.out + b * a.lo.b + h * a.lo.h, a.lo.l, tw, T);
  }
}

// Launch the forward on `stream`: the number of row groups (4, 2 or 1, no
// more than T needs) with the most resident warps an SM, ties to the larger
// tile, whose shared memory fits. Returns 0, kErrSharedMemory when not even
// one group's block fits, or the cudaError_t of the launch.
template <typename In, int D, bool kRelbias>
int launch_fwd(FwdArgs<In> a, cudaStream_t stream) {
  auto kernel = fwd_kernel<In, D, kRelbias>;
  if (a.S > 64 * kTile) return relbias::kErrSharedMemory;   // 64 flag bits
  const int max_bytes = bwd_mma::max_smem();
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       max_bytes);
  int top = kMaxGroups;
  while (top > 1 && 16 * (top / 2) >= a.T) top /= 2;
  int groups = 0, best = 0;
  size_t bytes = 0;
  for (int w = top; w >= 1; w /= 2) {
    const size_t need = fwd_smem_bytes<D>(w, a.S, kRelbias);
    if (need > (size_t)max_bytes) continue;
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 64 * w,
                                                  need);
    if (2 * w * blocks > best) {
      best = 2 * w * blocks;
      groups = w;
      bytes = need;
    }
  }
  if (!groups) return relbias::kErrSharedMemory;
  a.aligned = mma::rows_aligned<In>(a.q, a.lq.b, a.lq.h, a.lq.l) &&
              mma::rows_aligned<In>(a.k, a.lkv.b, a.lkv.h, a.lkv.l) &&
              mma::rows_aligned<In>(a.v, a.lkv.b, a.lkv.h, a.lkv.l);
  const int rows = 16 * groups;
  kernel<<<dim3((a.T + rows - 1) / rows, a.H, a.B), 64 * groups, bytes,
           stream>>>(a);
  return (int)cudaGetLastError();
}

// The head-dim dispatch of launch_fwd.
template <typename In, bool kRelbias>
int dispatch_fwd(int D, const FwdArgs<In>& a, cudaStream_t stream) {
  switch (D) {
    case 8: return launch_fwd<In, 8, kRelbias>(a, stream);
    case 16: return launch_fwd<In, 16, kRelbias>(a, stream);
    case 32: return launch_fwd<In, 32, kRelbias>(a, stream);
    case 64: return launch_fwd<In, 64, kRelbias>(a, stream);
    case 128: return launch_fwd<In, 128, kRelbias>(a, stream);
    default: return relbias::kErrHeadDim;
  }
}

}  // namespace fwd_mma
