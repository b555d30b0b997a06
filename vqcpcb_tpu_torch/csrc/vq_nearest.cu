// Nearest-codebook search for the product vector quantizer, Hopper (sm_90a).
//
// Replaces: vqcpcb_tpu/ops/pallas_vq.py:_kernel (reached through
// _pallas_indices_one_codebook and nearest_codebook_indices), the Pallas TPU
// kernel that takes argmin_s |x|^2 - 2 x.e_s + |e_s|^2 per sub-codebook.
//
// What bounds it on the H100: neither bytes nor operations but latency. At
// the encoder's shape (d = 3, S = 32, K = 1) each row reads 12 bytes of x
// and writes one int32 against 96 multiply-adds; a whole call (N = 96 to
// 12,288 rows) moves at most 200 KB, well under a microsecond at the HBM
// rate, so what a launch costs is its chain of dependent steps: the loads of
// x and the codebook, the distances, the scan and the store.
//
// Two kernels, chosen by shape alone before the launch:
//
// vq_nearest_instance<D, S, G>, compiled for the shapes the configurations
// use: (d, S) = (3, 32), every encoder config's, and (4, 16), the
// configs/*_scaleup_midi.py product quantizer's (codebook_dim 8 split over
// 2 sub-codebooks of 16 codes). A group of G lanes serves one (n, k)
// row; 256-thread blocks take 256 / G consecutive rows of the flat (N * K)
// row order, so neighbouring groups read neighbouring rows of x. No shared
// memory and no barrier: each lane loads the row's x into registers once,
// loads its S / G consecutive codes through the read-only path (the whole
// sub-codebook, at most 512 bytes, is an L1 / L2 broadcast), computes their
// norms in registers, and scans them in index order with a strict `<`; then
// log2(G) xor-shuffles take the lexicographic minimum of (distance, index),
// so ties still go to the lowest index. Every loop is unrolled at compile
// time.
//
// vq_nearest_kernel, for every other shape (d and S at run time): one thread
// per (n, k) row, blocks of 256 consecutive rows of one sub-codebook
// (blockIdx.y = k). The block stages its sub-codebook in shared memory a
// tile of codes at a time, with the tile's norms beside it, and every thread
// scans it from there.
//
// Both keep the arithmetic of the reference in one order, rounding for
// rounding: |x|^2, x.e and |e|^2 as fmaf chains over j = 0..d-1, the
// distance (|x|^2 - 2 x.e) + |e|^2 with the three outer operations rounded
// separately (no contraction into an FMA), ties to the lowest index as
// jnp.argmin / torch.argmin give them. So an instance gives the run-time
// kernel's indices bit for bit (the smoke and the tests hold them so).
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;   // 32 KB of codes (and their norms) per tile

__global__ void vq_nearest_kernel(const float* __restrict__ x,
                                  const float* __restrict__ e,
                                  int* __restrict__ out,
                                  int n_rows, int k_books, int s_codes,
                                  int d, int tile_codes) {
  __shared__ float tile[kTileFloats];
  float* norms = tile + tile_codes * d;
  const int book = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = n < n_rows;
  const float* xr = x + ((long long)n * k_books + book) * d;
  const float* eb = e + (long long)book * s_codes * d;

  float x2 = 0.f;
  if (valid) {
    for (int j = 0; j < d; ++j) {
      const float xv = __ldg(xr + j);
      x2 = fmaf(xv, xv, x2);
    }
  }
  float best_dist = INFINITY;
  int best = 0;
  for (int s0 = 0; s0 < s_codes; s0 += tile_codes) {
    const int count = min(tile_codes, s_codes - s0);
    __syncthreads();   // the previous tile is no longer read
    for (int i = threadIdx.x; i < count * d; i += kThreads)
      tile[i] = __ldg(eb + (long long)s0 * d + i);
    __syncthreads();
    for (int c = threadIdx.x; c < count; c += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < d; ++j) acc = fmaf(tile[c * d + j], tile[c * d + j], acc);
      norms[c] = acc;
    }
    __syncthreads();
    if (valid) {
      for (int c = 0; c < count; ++c) {
        float xe = 0.f;
        for (int j = 0; j < d; ++j) xe = fmaf(__ldg(xr + j), tile[c * d + j], xe);
        const float dist =
            __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, xe)), norms[c]);
        if (dist < best_dist) {
          best_dist = dist;
          best = s0 + c;
        }
      }
    }
  }
  if (valid) out[(long long)n * k_books + book] = best;
}

// One (n, k) row per group of G lanes (G a power of two dividing 32), S / G
// codes per lane; see the note at the top.
template <int D, int S, int G>
__global__ void __launch_bounds__(kThreads)
vq_nearest_instance(const float* __restrict__ x, const float* __restrict__ e,
                    int* __restrict__ out, int rows, int k_books) {
  static_assert(32 % G == 0 && S % G == 0, "G must divide 32 and S");
  constexpr int kPerLane = S / G;
  const int sub = threadIdx.x % G;
  const int row = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool valid = row < rows;   // the whole warp takes part in the shuffles

  float xv[D];
  float x2 = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    xv[j] = valid ? __ldg(x + (long long)row * D + j) : 0.f;
    x2 = fmaf(xv[j], xv[j], x2);
  }
  const float* eb = e + (long long)(valid ? row % k_books : 0) * S * D
                    + sub * kPerLane * D;
  float ev[kPerLane * D];
#pragma unroll
  for (int i = 0; i < kPerLane * D; ++i) ev[i] = __ldg(eb + i);

  float best_dist = INFINITY;
  int best = 0;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    float norm = 0.f, xe = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      norm = fmaf(ev[c * D + j], ev[c * D + j], norm);
      xe = fmaf(xv[j], ev[c * D + j], xe);
    }
    const float dist = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, xe)), norm);
    if (dist < best_dist) {
      best_dist = dist;
      best = sub * kPerLane + c;
    }
  }
  // (INFINITY, 0) loses to any finite distance and, among lanes that found
  // none, leaves index 0: the serial scan's answer in both cases
#pragma unroll
  for (int step = 1; step < G; step <<= 1) {
    const float other_dist = __shfl_xor_sync(0xffffffffu, best_dist, step);
    const int other = __shfl_xor_sync(0xffffffffu, best, step);
    if (other_dist < best_dist || (other_dist == best_dist && other < best)) {
      best_dist = other_dist;
      best = other;
    }
  }
  if (valid && sub == 0) out[row] = best;
}

// Does nothing: launched with vq_nearest_kernel's grid and block, its time is
// the floor any launch of that shape pays (the smoke times it beside K1).
__global__ void empty_kernel() {}

// The least a correct vq_nearest_kernel does, on its grid and block: the
// block stages its sub-codebook (its first tile) in shared memory, each
// thread reads its x row and writes one int that depends on both. No
// distances, no scan: its time is the floor of a kernel that must load x
// and the codebook before it can store an index (the smoke times it beside
// K1 and the empty kernel).
__global__ void io_floor_kernel(const float* __restrict__ x,
                                const float* __restrict__ e,
                                int* __restrict__ out,
                                int n_rows, int k_books, int s_codes, int d) {
  __shared__ float tile[kTileFloats];
  const int book = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int count = min(s_codes * d, kTileFloats);
  const float* eb = e + (long long)book * s_codes * d;
  for (int i = threadIdx.x; i < count; i += kThreads) tile[i] = __ldg(eb + i);
  __syncthreads();
  if (n < n_rows) {
    const float* xr = x + ((long long)n * k_books + book) * d;
    float acc = tile[threadIdx.x % count];
    for (int j = 0; j < d; ++j) acc += __ldg(xr + j);
    out[(long long)n * k_books + book] = acc > 0.f;
  }
}

// The compiled instances, by the `instance` argument of vq_nearest_launch.
enum { kRunTime = 0, kInstanceD3S32 = 1, kInstanceD4S16 = 2 };

// The instance <D, S, G> over `rows` = N * K flat rows.
template <int D, int S, int G>
int launch_instance(const float* x, const float* e, int* out, int rows,
                    int k_books, cudaStream_t stream) {
  constexpr int kRows = kThreads / G;
  vq_nearest_instance<D, S, G><<<(rows + kRows - 1) / kRows, kThreads, 0,
                                 stream>>>(x, e, out, rows, k_books);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest d the tile takes (one code and its norm must fit).
int vq_nearest_max_dim() { return kTileFloats - 1; }

// x: (N, K, d) f32, e: (K, S, d) f32, out: (N, K) int32, all contiguous on
// the device. instance: kRunTime (any shape d <= vq_nearest_max_dim()) or
// the compiled instance of (d, S); -1 when (d, S) is not that instance's.
// Returns cudaGetLastError() after the launch (0 = launched).
int vq_nearest_launch(const float* x, const float* e, int* out, int n_rows,
                      int k_books, int s_codes, int d, int instance,
                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_rows == 0) return 0;
  switch (instance) {
    case kInstanceD3S32:
      if (d != 3 || s_codes != 32) return -1;
      return launch_instance<3, 32, 8>(x, e, out, n_rows * k_books, k_books, st);
    case kInstanceD4S16:
      if (d != 4 || s_codes != 16) return -1;
      return launch_instance<4, 16, 8>(x, e, out, n_rows * k_books, k_books, st);
    case kRunTime:
      break;
    default:
      return -1;
  }
  const int tile_codes = std::min(s_codes, kTileFloats / (d + 1));
  dim3 grid((n_rows + kThreads - 1) / kThreads, k_books);
  vq_nearest_kernel<<<grid, kThreads, 0, st>>>(
      x, e, out, n_rows, k_books, s_codes, d, tile_codes);
  return (int)cudaGetLastError();
}

// The empty kernel on vq_nearest_kernel's grid for (n_rows, k_books).
int vq_empty_launch(int n_rows, int k_books, void* stream) {
  if (n_rows == 0) return 0;
  dim3 grid((n_rows + kThreads - 1) / kThreads, k_books);
  empty_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The I/O floor kernel on vq_nearest_kernel's grid, with its arguments.
int vq_io_floor_launch(const float* x, const float* e, int* out, int n_rows,
                       int k_books, int s_codes, int d, void* stream) {
  if (n_rows == 0) return 0;
  dim3 grid((n_rows + kThreads - 1) / kThreads, k_books);
  io_floor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, e, out, n_rows, k_books, s_codes, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
