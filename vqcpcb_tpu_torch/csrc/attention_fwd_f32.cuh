// The attention forward's f32-dot instances, Hopper (sm_90a): K4 (f32 or
// bf16 inputs) and K6's forward with f32 dots, launched from
// fused_attention.cu, and the relative-bias forward (K2-fwd, K3-fwd) with
// f32 dots, launched from relbias_attention.cu.
//
// Replaces: vqcpcb_tpu/ops/pallas_attention.py:_kernel (K4, behind
// fused_attention, :32-95), and :_train_fwd_kernel (:194) with f32 dots;
// with kRel, :_relbias_fwd_kernel_packed (:875) and :_relbias_fwd_kernel
// (:571) under _dots_dtype() = f32 (VQCPCB_PALLAS_BF16_DOTS=0), both
// _relbias_fwd_head. Per (b, h) plane, p = b*H + h, f32 throughout:
//
//   w[t]   = softmax_s( (q_t . k_s + mask[t, s]) + bias[p, t, s] )
//   out[t] = dropout(w[t]) . v
//
// where with kRel bias[t, s] = q_t . E[s + (S-1) - t/r], E = [e1; e2[1:]]
// the (2S-1, d) table of head h, r = T/S, and dropout draws stream
// seed + h*B + b (K6 and K4: seed + b*H + h).
//
// The TPU kernel never rounds its weights to a narrower type, so the card
// may take the sums in its own order (an online softmax) as long as the
// result stays within 1e-5 of the plain version (chip_smoke.py K4_ATOL).
//
// What bounds it on the H100: at the absolute prefill's self-attention,
// B*H = 4096 planes of T = S = 384, d = 64, causal, the live (unmasked)
// products are 4 d T (T+1) / 2 flops a plane, 7.8e10 flops in all; products
// that keep f32 accuracy run at best at a third of the 495 TFLOP/s TF32
// rate (three TF32 products each, below), 0.47 ms; q, k, v and out are
// 1.6e9 bytes at 3.35 TB/s, 0.48 ms: the bound is the bytes (chip_smoke.py
// computes both). Its CUDA-core predecessor staged K and V of the whole
// plane per query tile, one warp per query row with one shared-memory load
// per two FMAs, computed the masked upper half, and ran at 22 ms.
//
// What the design does about it:
//  - Products on the tensor cores in 3xTF32, as warpgroup products
//    (wgmma m64nNk8, tf32 in, f32 sums): each f32 operand x = hi + lo with
//    hi = tf32(x) and lo = tf32(x - hi), and a.b = a_lo.b_hi + a_hi.b_lo +
//    a_hi.b_hi; the dropped a_lo.b_lo is below 2^-22 of the product. One
//    block is one warpgroup on 64 query rows. q's halves are A fragments in
//    registers, loaded and split for each block of keys (held from one
//    block to the next, they spilled); K and V are split once per block of
//    keys into shared tiles in the core-matrix layout wgmma reads
//    (split_k, split_v). p . v takes its A fragment straight from the score
//    accumulator: a thread's columns 2c and 2c+1 of an 8-key tile stand at
//    k-indices c and c+4, and V's tile puts its keys in that order. (Per
//    thread, mma.sync m16n8k8 chains ran the same products at half the
//    rate: 8 dependent chains a warp keep its tf32 pipe latency-bound.)
//  - Online softmax in registers: a block of 64 keys at a time, each warp
//    16 query rows (the m16 of the mma), a running row max and sum, the
//    output accumulator rescaled when the max grows, one division at the
//    end. Keys past S get -inf before the max (and zero K / V rows).
//    Dropout zeroes the dropped exps by the K5 hash on stream seed + b*H + h
//    and scales the kept ones by 1/(1-rate) before p . v; the sum is taken
//    before dropout, as the plain version's softmax is.
//  - K and V stream through shared memory by cp.async, f32 rows of d + 4
//    words: the next live block lands while this one is computed. K is
//    split before q . k^T, V while the tensor cores take it. Views whose
//    rows do not start on 16 bytes, and bf16 inputs, take a
//    synchronous-load instance of the same kernel.
//  - Occupancy: two blocks (8 warps) an SM, held there by registers (the
//    score and output accumulators and the tf32 halves of p, about 240 a
//    thread) and shared memory (97 KB at d = 64). Loads that would be held
//    across the products (the mask terms) come after them; a version that
//    loaded the mask ahead spilled and ran 1.5x slower.
//  - Exact skipping of dead key blocks, the rule of attention_fwd_mma.cuh:
//    a key block is skipped for a query tile only when every mask entry of
//    the pair is the -1e30 clamp and every row of the tile has an entry
//    above -1e29; a tile with a fully masked row (uniform weights 1/S)
//    skips nothing. At 384 x 384 causal, 21 of the 36 (tile, block) pairs
//    are live. The scan also marks the pairs whose mask entries are all 0
//    (every pair of a zero mask, the causal blocks below the diagonal):
//    their mask terms are not loaded.
//  - The mask is the same for every plane, so a block scans the rows of its
//    query tiles once (a row to its first live entry, a pair whole) and
//    then serves `planes` planes (up to 8), every tile of each in turn: the
//    tiles of one plane re-read its K and V while they are in L2, and no
//    causal tile waits on another block. With few planes (the explicit-bias
//    prefill's 64), the tiles spread over blocks too.
//  - The relative bias (kRel). The TPU kernel holds a whole (b, h) plane and
//    its table in VMEM; its CUDA-core predecessor here staged K, V and the
//    table window of the plane in shared memory and so stopped at S = 287
//    (f32, d = 64). Here the bias streams with the keys: for query tile
//    [t0, t0 + 64) and key block [s0, s0 + 64) the rows of E that the
//    pair addresses are the window jlo + i, jlo = s0 + (S-1) - tmax/r,
//    i < n_keys + tmax/r - t0/r <= 127 (tmax the tile's last row). Before
//    q . k^T the window goes through the same 3xTF32 product as K, in
//    chunks of 64 rows split into K's tiles (read from L2, where the
//    table of every head stays), into a 64 x 128 f32 tile C in shared
//    memory; the score then adds its skewed entry, bias[t, s] =
//    C[t - t0, (s - s0) + tmax/r - t/r], after the mask term, as the
//    plain version adds them. C shares V's split tiles, so V is split
//    after the scores are formed, and the next block's K and V land while
//    the softmax and p . v run. The TPU kernel's log-step lane rolls
//    (_row_shift) were a Mosaic workaround: the skew is an indexed read.
// Shapes: d in {8, 16, 32, 64, 128}, any T and S (shared memory does not
// grow with S but for one flag bit per key block and query tile; T <= 32
// computes 64 rows, of which T are kept).
#pragma once

#include "attention_mma.cuh"
#include "relbias_common.cuh"

namespace fwd_f32 {

using relbias::Bias;
using relbias::Layout;

constexpr int kKeys = 64;            // keys per streamed block
constexpr int kKeyTiles = kKeys / 8; // n-tiles of a block's scores
constexpr int kRows = 64;            // query rows a block: a wgmma's m64
constexpr int kThreads = 128;        // one warpgroup, 16 query rows a warp
constexpr float kClamp = -1e30f;     // finite_mask's clamp of -inf
constexpr float kLiveFloor = -1e29f; // a row entry above it keeps the row live
constexpr float kLog2e = 1.4426950408889634f;   // exp(x) = exp2(x log2(e))

template <typename In>
struct Args {
  const In* q;
  const In* k;
  const In* v;
  const float* mask;   // (T, S), finite
  Bias bias;           // p may be null
  In* out;
  Layout lq, lkv, lo;
  int B, H, T, S;
  int planes;          // (b, h) planes a block serves
  int tiles_per_block; // query tiles a block serves, of each plane
  uint32_t seed, threshold;
  float inv_keep;
  int dropout;
  int mask_vec;        // S % 4 == 0 and the mask starts on 16 bytes
  const float* e;      // kRel: the (H, 2S-1, d) f32 combined table
};

__host__ __device__ inline int key_blocks(int S) {
  return (S + kKeys - 1) / kKeys;
}
// Keys of block j that the products read: its keys below S, rounded up to
// whole 8-key tiles.
__host__ __device__ inline int key_rows(int S, int j) {
  const int n = S - j * kKeys;
  return n >= kKeys ? kKeys : (n + 7) / 8 * 8;
}
__host__ __device__ inline int flag_words(int S) {
  return (key_blocks(S) + 31) / 32;
}

// Shared memory of a block: per query tile a skip word, and the live and
// the all-zero bits of its key blocks (rounded up to 16 bytes); then the
// raw K and V blocks (f32 rows of d + 4 words, cp.async's targets) and
// their tf32 halves in the layouts of split_k and split_v.
__host__ __device__ inline size_t flag_bytes(int T, int S) {
  const int tiles = (T + kRows - 1) / kRows;
  return ((size_t)tiles * (1 + 2 * flag_words(S)) * 4 + 15) / 16 * 16;
}

// kRel: the bias tile C (kRows rows of kWin window entries, row stride
// kCLd) shares the region of V's split tiles.
constexpr int kWin = 2 * kKeys;
constexpr int kCLd = kWin + 4;

template <int D, bool kRel>
__host__ __device__ inline size_t v_split_floats() {
  return kRel && kRows * kCLd > 2 * kKeys * D ? (size_t)kRows * kCLd
                                             : (size_t)2 * kKeys * D;
}

template <int D, bool kRel = false>
__host__ __device__ inline size_t smem_bytes(int T, int S) {
  return flag_bytes(T, S) +
         sizeof(float) * (kKeys * (2 * (D + 4) + 2 * D) + v_split_floats<D, kRel>());
}

// Stage keys [first, first + rows) of K and V (key r of each at
// src + r * stride) into f32 tiles of row stride D + 4; keys from S on are
// zeros. Each thread takes one 16-byte column of every (kThreads / (D/4))-th
// row. kAsync: f32 rows on 16 bytes, by cp.async; else loaded (and widened)
// here.
template <int D, bool kAsync, typename In>
__device__ __forceinline__ void stage_kv(float* kt, float* vt,
                                         const In* __restrict__ k,
                                         const In* __restrict__ v,
                                         long long stride, int first, int rows,
                                         int S) {
  constexpr int kChunks = D / 4;   // 16-byte chunks of an f32 row
  const int ch = threadIdx.x % kChunks;
  for (int r = threadIdx.x / kChunks; r < rows; r += kThreads / kChunks) {
    const int off = r * (D + 4) + ch * 4;
    if (first + r < S) {
      const long long at = (first + r) * stride + ch * 4;
      if constexpr (kAsync) {
        mma::cp_async16(kt + off, k + at);
        mma::cp_async16(vt + off, v + at);
      } else {
        const In* pk = k + at;
        const In* pv = v + at;
        *reinterpret_cast<float4*>(kt + off) =
            make_float4(relbias::to_float(pk[0]), relbias::to_float(pk[1]),
                        relbias::to_float(pk[2]), relbias::to_float(pk[3]));
        *reinterpret_cast<float4*>(vt + off) =
            make_float4(relbias::to_float(pv[0]), relbias::to_float(pv[1]),
                        relbias::to_float(pv[2]), relbias::to_float(pv[3]));
      }
    } else {
      *reinterpret_cast<float4*>(kt + off) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vt + off) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Entries [i, i + 4) of a mask row (clamp values past S or past the row).
__device__ __forceinline__ float4 mask4(const float* __restrict__ row, int i,
                                        int S, bool vec) {
  if (vec) {
    if (i < S) return __ldg(reinterpret_cast<const float4*>(row + i));
    return make_float4(kClamp, kClamp, kClamp, kClamp);
  }
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = i + e < S ? __ldg(row + i + e) : kClamp;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// The skip flags of the query tiles [tile0, tile1), once per block:
// skip[tile] = 1 when
// every row of the tile has a mask entry above kLiveFloor; the tile's
// bits[tile * nw + j / 32] hold the key blocks j with an entry other than
// the clamp, and zero[tile * nw + j / 32] those whose entries are all 0 (no
// mask term to load). Rows: a thread a row, 32 entries a step, to the first
// live entry. Pairs: a warp a (tile, key block) pair, half a warp a row of
// 64 entries, 16 rows a step, every row of the pair.
__device__ void scan_mask(const float* __restrict__ mask, int T, int S,
                          int tile0, int tile1, bool vec, uint32_t* skip,
                          uint32_t* bits, uint32_t* zero) {
  const int tiles = (T + kRows - 1) / kRows;
  const int nb = key_blocks(S), nw = flag_words(S);
  for (int i = threadIdx.x; i < tiles * (1 + 2 * nw); i += blockDim.x)
    skip[i] = i < tiles;   // then bits and zero, all clear
  __syncthreads();
  for (int t = tile0 * kRows + threadIdx.x; t < min(T, tile1 * kRows);
       t += blockDim.x) {
    const float* row = mask + (long long)t * S;
    bool live = false;
    for (int s0 = 0; s0 < S && !live; s0 += 32) {
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = mask4(row, s0 + 4 * u, S, vec);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        live |= fmaxf(fmaxf(x[u].x, x[u].y), fmaxf(x[u].z, x[u].w)) > kLiveFloor;
    }
    if (!live) skip[t / kRows] = 0;   // a benign race: every writer writes 0
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pr = warp; pr < (tile1 - tile0) * nb; pr += blockDim.x >> 5) {
    const int tile = tile0 + pr / nb, j = pr % nb;
    const int t0 = tile * kRows, n_rows = min(kRows, T - t0);
    const int col = j * kKeys + 4 * (lane & 15);
    bool live = false, nonzero = false;
    for (int r0 = 0; r0 < n_rows; r0 += 16) {
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r0 + 2 * u + (lane >> 4);
        x[u] = r < n_rows ? mask4(mask + (long long)(t0 + r) * S, col, S, vec)
                          : make_float4(kClamp, kClamp, kClamp, kClamp);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float e[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
        const bool row_in = r0 + 2 * u + (lane >> 4) < n_rows;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          live |= e[k] != kClamp;   // the padding past S and T is the clamp
          nonzero |= row_in && col + k < S && e[k] != 0.f;
        }
      }
    }
    live = __any_sync(0xffffffffu, live);
    nonzero = __any_sync(0xffffffffu, nonzero);
    if (lane == 0) {
      if (live) atomicOr(&bits[tile * nw + (j >> 5)], 1u << (j & 31));
      if (!nonzero) atomicOr(&zero[tile * nw + (j >> 5)], 1u << (j & 31));
    }
  }
  __syncthreads();
}

// The next key block after j (-1 for j = -1: the first) that the tile
// computes: every block, or with skipping the next live one; -1 if none.
__device__ __forceinline__ int next_block(const uint32_t* bits, bool skip,
                                          int nb, int j) {
  if (!skip) return j + 1 < nb ? j + 1 : -1;
  for (int i = j + 1; i < nb;) {
    const uint32_t w = bits[i >> 5] >> (i & 31);
    if (w) return i + __ffs(w) - 1;
    i = (i | 31) + 1;
  }
  return -1;
}

// x = hi + lo, four values at a time (mma::split_tf32).
__device__ __forceinline__ void split4(const float (&x)[4], float* hi,
                                       float* lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) mma::split_tf32(x[e], h[e], l[e]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The tf32 halves of a staged K (split_k) and V (split_v) block in the
// K-major core-matrix layouts the products read (consecutive threads write
// consecutive 16 bytes): K as B of q . k^T (n = key, k = d) at
// ((key/8) (D/4) + d/4) 32 + (key%8) 4 + d%4 floats; V as B of p . v
// (n = d, k = key) at ((d/8) 16 + k/4) 32 + (d%8) 4 + k%4, where within
// each 8 keys 8j + 2c + e stands at k = 8j + c + 4e: the k order of the A
// fragment that p . v takes straight from the score accumulator. Only the
// block's first key_tiles 8-key tiles are split: p . v reads no other V
// rows, and the scores of other K rows are replaced by -inf.
template <int D>
__device__ __forceinline__ void split_k(const float* kraw, float* khi,
                                        float* klo, int key_tiles) {
  for (int i = threadIdx.x; i < 2 * key_tiles * D; i += blockDim.x) {
    const int key = (i >> 3) / (D / 4) * 8 + (i & 7);
    const int d = (i >> 3) % (D / 4) * 4;
    const float4 x4 = *reinterpret_cast<const float4*>(kraw + key * (D + 4) + d);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    split4(x, khi + 4 * i, klo + 4 * i);
  }
}

template <int D>
__device__ __forceinline__ void split_v(const float* vraw, float* vhi,
                                        float* vlo, int key_tiles) {
  constexpr int LD = D + 4;
  for (int n = threadIdx.x; n < 2 * key_tiles * D; n += blockDim.x) {
    const int q = (n >> 3) / (D / 8);
    const int d = (n >> 3) % (D / 8) * 8 + (n & 7);
    const int i = ((d >> 3) * 16 + q) * 8 + (n & 7);
    const float* col = vraw + (8 * (q >> 1) + (q & 1)) * LD + d;
    const float x[4] = {col[0], col[2 * LD], col[4 * LD], col[6 * LD]};
    split4(x, vhi + 4 * i, vlo + 4 * i);
  }
}

// The tf32 halves of window rows [first, first + rows) of one head's table
// (row j at eh + j * D), in split_k's layout: rows at or past n_table are
// zeros. Read from global memory (L2) by 16-byte loads.
template <int D>
__device__ __forceinline__ void split_e(const float* __restrict__ eh,
                                        int first, int rows, int n_table,
                                        float* khi, float* klo) {
  const int key_tiles = (rows + 7) / 8;
  for (int i = threadIdx.x; i < 2 * key_tiles * D; i += blockDim.x) {
    const int key = (i >> 3) / (D / 4) * 8 + (i & 7);
    const int d = (i >> 3) % (D / 4) * 4;
    const int row = first + key;
    const float4 x4 =
        key < rows && row < n_table
            ? __ldg(reinterpret_cast<const float4*>(eh + (long long)row * D + d))
            : make_float4(0.f, 0.f, 0.f, 0.f);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    split4(x, khi + 4 * i, klo + 4 * i);
  }
}

template <typename In, int D, bool kAsync, bool kRel>
__global__ void __launch_bounds__(kThreads, 2)
fwd_kernel(const Args<In> a) {
  constexpr int LD = D + 4;
  constexpr int kDTiles = D / 8;   // k-steps of q . k^T, n-tiles of out
  // q's halves for all k-steps at once (d = 128: one k-step at a time)
  constexpr bool kQRegs = D <= 64;
  const int T = a.T, S = a.S;
  const int nb = key_blocks(S), nw = flag_words(S);
  const int tiles = (T + kRows - 1) / kRows;
  const int ratio = kRel ? T / S : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* skip = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* bits = skip + tiles;
  uint32_t* zero = bits + tiles * nw;
  float* kraw = reinterpret_cast<float*>(smem_raw + flag_bytes(T, S));
  float* vraw = kraw + kKeys * LD;
  float* khi = vraw + kKeys * LD;
  float* klo = khi + kKeys * D;
  float* vhi = klo + kKeys * D;
  float* vlo = vhi + kKeys * D;
  float* cb = vhi;   // kRel: the bias tile C, in V's split tiles

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int tile0 = blockIdx.y * a.tiles_per_block;
  const int tile1 = min(tiles, tile0 + a.tiles_per_block);
  scan_mask(a.mask, T, S, tile0, tile1, a.mask_vec != 0, skip, bits, zero);

  const int plane_end = min(a.B * a.H, (int)(blockIdx.x + 1) * a.planes);
  for (int plane = blockIdx.x * a.planes; plane < plane_end; ++plane) {
    const int b = plane / a.H, h = plane - b * a.H;
    const In* qb = a.q + b * a.lq.b + h * a.lq.h;
    const In* kb = a.k + b * a.lkv.b + h * a.lkv.h;
    const In* vb = a.v + b * a.lkv.b + h * a.lkv.h;
    In* ob = a.out + b * a.lo.b + h * a.lo.h;
    const uint32_t key = kRel ? relbias::stream_key(a.seed, h, b, a.B)
                              : relbias::plane_key(a.seed, plane);
    const float* bp = a.bias.p ? a.bias.p + plane * a.bias.bh : nullptr;
    const float* eh = kRel ? a.e + (long long)h * (2 * S - 1) * D : nullptr;
    for (int tile = tile0; tile < tile1; ++tile) {
      const int tw = tile * kRows + 16 * warp;     // the warp's first row
      const int t0 = tile * kRows;
      const int tmax = min(t0 + kRows - 1, T - 1);  // the tile's last row
      // kRel: the window offset of the thread's two rows, tmax/r - t/r
      int woff[2] = {0, 0};
      if constexpr (kRel) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          woff[r] = tmax / ratio - min(tw + g + 8 * r, tmax) / ratio;
      }
      const bool skips = skip[tile] != 0;
      const uint32_t* tbits = bits + tile * nw;
      int j = next_block(tbits, skips, nb, -1);
      stage_kv<D, kAsync>(kraw, vraw, kb, vb, a.lkv.l, j * kKeys,
                          key_rows(S, j), S);
      mma::cp_async_commit();
      // q's entries of the A fragment of k-step kk (rows g, g + 8; columns
      // c, c + 4), zeros past T
      auto q_load = [&](int kk, float (&v)[4]) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = tw + g + 8 * (x & 1);
          const int col = kk * 8 + c + 4 * (x >> 1);
          v[x] = t < T ? relbias::to_float(qb[t * a.lq.l + col]) : 0.f;
        }
      };

      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float o[D / 2] = {};
      while (true) {
        const int s0 = j * kKeys;
        const int n_tiles = min(kKeyTiles, (S - s0 + 7) / 8);
        // q's entries of this block's products, loaded ahead of the split
        float qv[kQRegs ? kDTiles : 1][4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int kk = 0; kk < kDTiles; ++kk) q_load(kk, qv[kk]);
        }
        uint32_t qh[kQRegs ? kDTiles : 1][4], ql[kQRegs ? kDTiles : 1][4];
        auto q_split = [&]() {
          if constexpr (kQRegs) {
#pragma unroll
            for (int kk = 0; kk < kDTiles; ++kk)
#pragma unroll
              for (int x = 0; x < 4; ++x)
                mma::split_tf32(qv[kk][x], qh[kk][x], ql[kk][x]);
          }
        };
        // acc += q . B^T in 3xTF32, B the 64 rows split into khi / klo;
        // issued, not waited for (d = 128: waited for k-step by k-step)
        float sc[4 * kKeyTiles];
        auto q_product = [&](float (&acc)[4 * kKeyTiles]) {
#pragma unroll
          for (int i = 0; i < 4 * kKeyTiles; ++i) acc[i] = 0.f;
          mma::wgmma_fence();
          constexpr uint32_t kSboK = 32 * D;   // bytes between 8-key groups
#pragma unroll
          for (int kk = 0; kk < kDTiles; ++kk) {
            const uint64_t bh = mma::smem_desc(khi + 64 * kk, 128, kSboK);
            const uint64_t bl = mma::smem_desc(klo + 64 * kk, 128, kSboK);
            if constexpr (kQRegs) {
              mma::WgmmaTf32<kKeys>::run(acc, ql[kk], bh);
              mma::WgmmaTf32<kKeys>::run(acc, qh[kk], bl);
              mma::WgmmaTf32<kKeys>::run(acc, qh[kk], bh);
            } else {   // one k-step at a time, its fragments held until done
              float v[4];
              uint32_t ah[4], al[4];
              q_load(kk, v);
#pragma unroll
              for (int x = 0; x < 4; ++x) mma::split_tf32(v[x], ah[x], al[x]);
              mma::wgmma_fence();
              mma::WgmmaTf32<kKeys>::run(acc, al, bh);
              mma::WgmmaTf32<kKeys>::run(acc, ah, bl);
              mma::WgmmaTf32<kKeys>::run(acc, ah, bh);
              mma::wgmma_commit();
              mma::wgmma_wait_all();
            }
          }
          mma::wgmma_commit();
        };
        if constexpr (kRel) q_split();
        mma::cp_async_wait<0>();   // this block's K and V
        __syncthreads();
        if constexpr (kRel) {
          // C = q . E_window^T over the window's chunks of 64 rows, each
          // thread's entries (rows g, g + 8; columns 2c, 2c + 1 of each
          // 8-row tile) stored to C's rows of its warp
          const int jlo = s0 + (S - 1) - tmax / ratio;
          const int n_win = min(kKeys, S - s0) + tmax / ratio - t0 / ratio;
          for (int ch = 0; ch * kKeys < n_win; ++ch) {
            split_e<D>(eh, jlo + ch * kKeys, min(kKeys, n_win - ch * kKeys),
                       2 * S - 1, khi, klo);
            mma::fence_proxy_async();
            __syncthreads();
            q_product(sc);
            mma::wgmma_wait_all();
#pragma unroll
            for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                *reinterpret_cast<float2*>(
                    cb + (16 * warp + g + 8 * r) * kCLd + ch * kKeys + 8 * nt + 2 * c) =
                    make_float2(sc[4 * nt + 2 * r], sc[4 * nt + 2 * r + 1]);
            __syncthreads();   // khi / klo are split again
          }
        }
        split_k<D>(kraw, khi, klo, n_tiles);
        mma::fence_proxy_async();
        __syncthreads();
        if constexpr (!kRel) q_split();
        // scores = q . k^T over the 64 keys of the block, issued here and
        // waited for once V is split (kRel: before; C holds V's tiles)
        q_product(sc);
        if constexpr (!kRel) {
          split_v<D>(vraw, vhi, vlo, n_tiles);
          mma::fence_proxy_async();
          __syncthreads();
        }
        const int jn = next_block(tbits, skips, nb, j);
        if constexpr (!kRel) {
          if (jn >= 0)             // the next live block lands meanwhile
            stage_kv<D, kAsync>(kraw, vraw, kb, vb, a.lkv.l, jn * kKeys,
                                key_rows(S, jn), S);
          mma::cp_async_commit();
        }
        mma::wgmma_wait_all();

        // (q.k + mask) + bias, -inf past the last key. The mask terms are
        // loaded only where the pair has entries other than 0, and after
        // the products (ahead of them, they would hold registers the
        // products need).
        const bool masked = !((zero[tile * nw + (j >> 5)] >> (j & 31)) & 1u);
        float add[kKeyTiles][4];
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int t = tw + g + 8 * (x >> 1);
            const int s = s0 + nt * 8 + 2 * c + (x & 1);
            add[nt][x] = masked && nt < n_tiles && t < T && s < S
                             ? __ldg(a.mask + (long long)t * S + s) : 0.f;
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int t = tw + g + 8 * (x >> 1);
            const int s = s0 + nt * 8 + 2 * c + (x & 1);
            float score = -INFINITY;
            if (nt < n_tiles && s < S) {
              score = __fadd_rn(sc[4 * nt + x], add[nt][x]);
              if (bp && t < T)
                score = __fadd_rn(score, bp[t * a.bias.t + s * a.bias.s]);
              if (kRel && t < T)
                score = __fadd_rn(score, cb[(t - t0) * kCLd + (s - s0) +
                                            woff[x >> 1]]);
            }
            sc[4 * nt + x] = score;
            mx[x >> 1] = fmaxf(mx[x >> 1], score);
          }
        }
        if constexpr (kRel) {
          __syncthreads();         // every warp has read its rows of C
          split_v<D>(vraw, vhi, vlo, n_tiles);
          mma::fence_proxy_async();
          __syncthreads();
          if (jn >= 0)             // the next live block lands meanwhile
            stage_kv<D, kAsync>(kraw, vraw, kb, vb, a.lkv.l, jn * kKeys,
                                key_rows(S, jn), S);
          mma::cp_async_commit();
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float alpha = exp2f((m[r] - mx[r]) * kLog2e);   // 0 at first
          m[r] = mx[r];
          l[r] *= alpha;
#pragma unroll
          for (int dt = 0; dt < kDTiles; ++dt) {
            o[4 * dt + 2 * r] *= alpha;
            o[4 * dt + 2 * r + 1] *= alpha;
          }
        }
        // p = exp(score - max) into the sum; dropout on what enters p . v,
        // split into the tf32 halves of the A fragments: the scores' n-tile
        // kk is k-step kk, its columns 2c, 2c+1 at k-indices c, c+4
        uint32_t ph[kKeyTiles][4] = {}, pl[kKeyTiles][4] = {};
        if (tw < T) {
#pragma unroll
          for (int nt = 0; nt < kKeyTiles; ++nt) {
            if (nt < n_tiles) {
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const float p = exp2f((sc[4 * nt + x] - m[x >> 1]) * kLog2e);
                l[x >> 1] += p;
                sc[4 * nt + x] = p;
              }
            }
          }
          if (a.dropout) {
#pragma unroll
            for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const int s = s0 + nt * 8 + 2 * c + (x & 1);
                const float p = sc[4 * nt + x];
                sc[4 * nt + x] =
                    relbias::dropout_keep(key, tw + g + 8 * (x >> 1), s, S,
                                          a.threshold) ? p * a.inv_keep : 0.f;
              }
            }
          }
#pragma unroll
          for (int nt = 0; nt < kKeyTiles; ++nt) {
            if (nt < n_tiles) {
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const int y = (x >> 1) | ((x & 1) << 1);   // A register of (row, k)
                mma::split_tf32(sc[4 * nt + x], ph[nt][y], pl[nt][y]);
              }
            }
          }
        }
        // o += p . v in 3xTF32, over the key tiles that hold keys
        mma::wgmma_fence();
        constexpr uint32_t kSboV = 16 * 128;   // bytes between 8-dim groups
#pragma unroll
        for (int kk = 0; kk < kKeyTiles; ++kk) {
          if (kk < n_tiles) {
            const uint64_t bh = mma::smem_desc(vhi + 64 * kk, 128, kSboV);
            const uint64_t bl = mma::smem_desc(vlo + 64 * kk, 128, kSboV);
            mma::WgmmaTf32<D>::run(o, pl[kk], bh);
            mma::WgmmaTf32<D>::run(o, ph[kk], bl);
            mma::WgmmaTf32<D>::run(o, ph[kk], bh);
          }
        }
        mma::wgmma_commit();
        mma::wgmma_wait_all();
        if (jn < 0) break;
        j = jn;
      }

      // out = o / (the row's sum over the quad)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int t = tw + g + 8 * r;
        if (t < T) {
          In* orow = ob + t * a.lo.l + 2 * c;
#pragma unroll
          for (int dt = 0; dt < kDTiles; ++dt) {
            orow[dt * 8] = relbias::from_float<In>(o[4 * dt + 2 * r] / l[r]);
            orow[dt * 8 + 1] =
                relbias::from_float<In>(o[4 * dt + 2 * r + 1] / l[r]);
          }
        }
      }
    }
  }
}

inline int device_attribute(cudaDeviceAttr what) {
  int device = 0, value = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&value, what, device);
  return value;
}

// Launch on `stream`: one warpgroup a block, as many planes a block (up to
// 8: the mask scan is per block) as leave a full wave of resident blocks;
// with fewer planes than two waves, a block serves some of their query
// tiles.
// Returns 0, kErrSharedMemory when a block does not fit, or the
// cudaError_t of the launch.
template <typename In, int D, bool kAsync, bool kRel>
int launch(Args<In> a, cudaStream_t stream) {
  auto kernel = fwd_kernel<In, D, kAsync, kRel>;
  const size_t bytes = smem_bytes<D, kRel>(a.T, a.S);
  if (bytes > (size_t)device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin))
    return relbias::kErrSharedMemory;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  const long long n_planes = (long long)a.B * a.H;
  const long long wave =
      (long long)device_attribute(cudaDevAttrMultiProcessorCount) * per_sm;
  // few planes: the query tiles of a plane spread over blocks too
  const int tiles = (a.T + kRows - 1) / kRows;
  int tile_groups = 1;
  while (tile_groups < tiles && n_planes * tile_groups < 2 * wave) tile_groups *= 2;
  a.tiles_per_block = (tiles + tile_groups - 1) / tile_groups;
  tile_groups = (tiles + a.tiles_per_block - 1) / a.tiles_per_block;
  int planes = 1;
  while (planes < 8 &&
         (n_planes + 2 * planes - 1) / (2 * planes) * tile_groups >= wave)
    planes *= 2;
  while ((n_planes + planes - 1) / planes > 0x7fffffffLL) planes *= 2;
  a.planes = planes;
  kernel<<<dim3((unsigned)((n_planes + planes - 1) / planes), tile_groups),
           kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The launcher for one input type and head dim: cp.async where the input
// is f32 and every q, k, v row starts on 16 bytes, else synchronous loads.
template <typename In, int D, bool kRel>
int launch_any(const Args<In>& a, cudaStream_t stream) {
  if constexpr (sizeof(In) == 4) {
    if (mma::rows_aligned<In>(a.q, a.lq.b, a.lq.h, a.lq.l) &&
        mma::rows_aligned<In>(a.k, a.lkv.b, a.lkv.h, a.lkv.l) &&
        mma::rows_aligned<In>(a.v, a.lkv.b, a.lkv.h, a.lkv.l))
      return launch<In, D, true, kRel>(a, stream);
  }
  return launch<In, D, false, kRel>(a, stream);
}

// kRel: the relative bias from a.e (T a multiple of S), no explicit bias.
template <typename In, bool kRel = false>
int dispatch(int D, Args<In> a, cudaStream_t stream) {
  a.mask_vec = a.S % 4 == 0 && reinterpret_cast<uintptr_t>(a.mask) % 16 == 0;
  switch (D) {
    case 8: return launch_any<In, 8, kRel>(a, stream);
    case 16: return launch_any<In, 16, kRel>(a, stream);
    case 32: return launch_any<In, 32, kRel>(a, stream);
    case 64: return launch_any<In, 64, kRel>(a, stream);
    case 128: return launch_any<In, 128, kRel>(a, stream);
    default: return relbias::kErrHeadDim;
  }
}

}  // namespace fwd_f32
