// The key-column pass of the f32-dot attention backward kernels
// (relbias_attention_bwd.cu, fused_attention_bwd.cu; the bf16-dot instances
// run the tensor-core cols kernel of attention_bwd_mma.cuh): given the
// score gradient ds and the dropped weights w_drop of every (b, h) plane in
// (B, H, T, S) f32 scratch,
//
//   dk = ds^T . q        dv = w_drop^T . do
//
// One block per (b, h, 32 key columns) walks the query rows in chunks of 64,
// staging q, do and the scratch columns, and owns the dk and dv rows of its
// columns in registers: no cross-block reduction.
#pragma once

#include "relbias_common.cuh"

namespace relbias {

constexpr int kColTile = 32;     // key columns per cols block
constexpr int kRowChunk = 64;    // query rows staged at a time
constexpr int kColsPerWarp = kColTile / kWarps;

// Stage rows [t0, t0 + n) of a (T, D) view, rounded to the dot type.
template <typename In, typename Elem, int D>
__device__ __forceinline__ void stage_rows(const In* __restrict__ src,
                                           long long row, int t0, int n,
                                           Elem* dst) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, j = i - r * D;
    dst[i] = Dot<Elem>::store(to_float(src[(t0 + r) * row + j]));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_cols_kernel(const float* __restrict__ q, const float* __restrict__ dout,
                const float* __restrict__ ds, const float* __restrict__ wd,
                float* __restrict__ dk, float* __restrict__ dv, Layout lq,
                Layout ldo, Layout ldkv, int H, int T, int S) {
  using In = float;
  using Elem = float;
  using DT = Dot<Elem>;
  constexpr int kPairs = (D / 2 + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* qs = reinterpret_cast<Elem*>(smem_raw);
  Elem* dos = qs + kRowChunk * D;
  Elem* dss = dos + kRowChunk * D;
  Elem* wds = dss + kRowChunk * kColTile;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = blockIdx.x * kColTile;
  const In* qb = q + b * lq.b + h * lq.h;
  const In* dob = dout + b * ldo.b + h * ldo.h;
  const long long scratch = (long long)(b * H + h) * T * S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float adk[kColsPerWarp][kPairs][2] = {};
  float adv[kColsPerWarp][kPairs][2] = {};
  for (int t0 = 0; t0 < T; t0 += kRowChunk) {
    const int n = min(kRowChunk, T - t0);
    stage_rows<In, Elem, D>(qb, lq.l, t0, n, qs);
    stage_rows<In, Elem, D>(dob, ldo.l, t0, n, dos);
    for (int i = threadIdx.x; i < n * kColTile; i += kThreads) {
      const int r = i / kColTile, s = s0 + i - r * kColTile;
      const long long at = scratch + (long long)(t0 + r) * S + s;
      dss[i] = s < S ? ds[at] : DT::store(0.f);
      wds[i] = s < S ? wd[at] : DT::store(0.f);
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
#pragma unroll
      for (int pi = 0; pi < kPairs; ++pi) {
        const int p = lane + 32 * pi;
        if (p >= D / 2) break;
        const float2 qq = DT::load2(qs + r * D + 2 * p);
        const float2 dd = DT::load2(dos + r * D + 2 * p);
#pragma unroll
        for (int cw = 0; cw < kColsPerWarp; ++cw) {
          const int c = warp + cw * kWarps;
          const float dsv = DT::load(dss[r * kColTile + c]);
          const float wdv = DT::load(wds[r * kColTile + c]);
          adk[cw][pi][0] = fmaf(dsv, qq.x, adk[cw][pi][0]);
          adk[cw][pi][1] = fmaf(dsv, qq.y, adk[cw][pi][1]);
          adv[cw][pi][0] = fmaf(wdv, dd.x, adv[cw][pi][0]);
          adv[cw][pi][1] = fmaf(wdv, dd.y, adv[cw][pi][1]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int cw = 0; cw < kColsPerWarp; ++cw) {
    const int s = s0 + warp + cw * kWarps;
    if (s >= S) continue;
#pragma unroll
    for (int pi = 0; pi < kPairs; ++pi) {
      const int p = lane + 32 * pi;
      if (p >= D / 2) break;
      const long long at = b * ldkv.b + h * ldkv.h + s * ldkv.l + 2 * p;
      dk[at] = from_float<In>(adk[cw][pi][0]);
      dk[at + 1] = from_float<In>(adk[cw][pi][1]);
      dv[at] = from_float<In>(adv[cw][pi][0]);
      dv[at + 1] = from_float<In>(adv[cw][pi][1]);
    }
  }
}

// Launch the cols pass on `stream`; returns the launch's cudaError_t.
template <int D>
int launch_cols_f32(const float* q, const float* dout, const float* ds,
                    const float* wd, float* dk, float* dv, Layout lq,
                    Layout ldo, Layout ldkv, int B, int H, int T, int S,
                    cudaStream_t stream) {
  const int bytes = (int)(sizeof(float) * kRowChunk * (2 * D + 2 * kColTile));
  cudaFuncSetAttribute(bwd_cols_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  bwd_cols_kernel<D>
      <<<dim3((S + kColTile - 1) / kColTile, H, B), kThreads, bytes, stream>>>(
          q, dout, ds, wd, dk, dv, lq, ldo, ldkv, H, T, S);
  return (int)cudaGetLastError();
}

}  // namespace relbias
