// Nearest-codebook search for the product vector quantizer, Hopper (sm_90a).
//
// Replaces: vqcpcb_tpu/ops/pallas_vq.py:_kernel (reached through
// _pallas_indices_one_codebook and nearest_codebook_indices), the Pallas TPU
// kernel that takes argmin_s |x|^2 - 2 x.e_s + |e_s|^2 per sub-codebook.
//
// What bounds it on the H100: the bytes. At the encoder's shape (d = 3,
// S = 32, K = 1) each row reads 12 bytes of x and writes one int32 against
// 96 multiply-adds, far below the card's ~20 operations per byte in f32
// outside the tensor cores; a whole encode call (N = B * 24 rows) moves a few
// hundred KB, so at serving sizes the launch itself dominates.
//
// Design: one thread per (n, k) row, blocks of 256 consecutive rows of one
// sub-codebook (blockIdx.y = k), so neighbouring threads read neighbouring
// rows of x. The block stages its sub-codebook in shared memory a tile of
// codes at a time, with the tile's norms |e_s|^2 beside it, so the codebook
// is read from device memory once per block and every thread scans it from
// shared memory (all lanes read the same code: a broadcast). The distance
// keeps the expanded formula in the order of the reference,
// (|x|^2 - 2 x.e) + |e|^2, with the three outer operations rounded
// separately (no contraction into an FMA), and the scan is a strict `<` in
// index order, so ties go to the lowest index as jnp.argmin / torch.argmin
// give them.
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

// Does nothing: launched with vq_nearest_kernel's grid and block, its time is
// the floor any launch of that shape pays (the smoke times the two side by
// side).
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

}  // namespace

extern "C" {

// Largest d the tile takes (one code and its norm must fit).
int vq_nearest_max_dim() { return kTileFloats - 1; }

// x: (N, K, d) f32, e: (K, S, d) f32, out: (N, K) int32, all contiguous on
// the device. Returns cudaGetLastError() after the launch (0 = launched).
int vq_nearest_launch(const float* x, const float* e, int* out, int n_rows,
                      int k_books, int s_codes, int d, void* stream) {
  if (n_rows == 0) return 0;
  const int tile_codes = std::min(s_codes, kTileFloats / (d + 1));
  dim3 grid((n_rows + kThreads - 1) / kThreads, k_books);
  vq_nearest_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, e, out, n_rows, k_books, s_codes, d, tile_codes);
  return (int)cudaGetLastError();
}

// The empty kernel on vq_nearest_launch's grid for (n_rows, k_books).
int vq_empty_launch(int n_rows, int k_books, void* stream) {
  if (n_rows == 0) return 0;
  dim3 grid((n_rows + kThreads - 1) / kThreads, k_books);
  empty_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The I/O floor kernel on vq_nearest_launch's grid, with its arguments.
int vq_io_floor_launch(const float* x, const float* e, int* out, int n_rows,
                       int k_books, int s_codes, int d, void* stream) {
  if (n_rows == 0) return 0;
  dim3 grid((n_rows + kThreads - 1) / kThreads, k_books);
  io_floor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, e, out, n_rows, k_books, s_codes, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
