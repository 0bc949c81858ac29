// Multi-width RBF Gram sum for MK-MMD, f32, for sm_90a.
//
//   S(x, y) = sum_{i<n, j<m} mean_w exp(-max(d2_ij, 0) / (2 w sigma)),
//   d2_ij = ||x_i||^2 + ||y_j||^2 - 2 x_i . y_j
//
// Replaces the TPU kernel src/repro/kernels/mk_mmd.py:gram_sum
// (_gram_sum_kernel), which carried one scalar through a sequential grid.
// Hopper runs blocks in parallel and in no order, so this is two passes:
//   1. a 2-D grid of (32-row x tile, 32-row y tile) blocks; each stages its
//      rows in shared memory 32 features at a time, forms d2 by the same
//      identity (clamped at 0), applies every width, masks the ragged edge
//      and writes ONE partial sum;
//   2. one block sums the partials in a fixed order and divides by the
//      number of widths.
// No float atomics: repeated runs agree bit for bit.
//
// What bounds it on the card: at the FedMMD main-path shape (n = m = 10,
// d = 64) the work is ~10^4 flops and ~5 KB, far below what one launch
// costs, so the two launches' latency bounds it.  At large n, m the inner
// loop is FFMA-bound (2 d flops per pair plus one expf per width); the
// design keeps the n x m Gram matrix out of device memory, so bytes stay
// O((n + m) d).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // rows of x and of y per block
constexpr int kChunk = 32;       // features staged per pass over d
constexpr int kThreads = 256;    // 32 columns x 8 row groups
constexpr int kMaxWidths = 8;

struct Widths {
  float w[kMaxWidths];
  int n;
};

__global__ void gram_partial_kernel(const float* __restrict__ x,
                                    const float* __restrict__ y,
                                    const float* __restrict__ sigma_ptr,
                                    float* __restrict__ partials,
                                    int n, int m, int d, Widths widths) {
  __shared__ float xs[kTile][kChunk + 1];
  __shared__ float ys[kTile][kChunk + 1];
  __shared__ float x2s[kTile];
  __shared__ float y2s[kTile];
  __shared__ float warp_sums[kThreads / 32];

  const int tid = threadIdx.x;
  const int tx = tid % kTile;      // column (y row) within the tile
  const int ty = tid / kTile;      // row group: rows ty, ty+8, ty+16, ty+24
  const int i0 = blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;

  if (tid < kTile) x2s[tid] = 0.f;
  else if (tid < 2 * kTile) y2s[tid - kTile] = 0.f;

  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, k = e % kChunk;
      const bool kin = k0 + k < d;
      xs[r][k] = (kin && i0 + r < n) ? x[(size_t)(i0 + r) * d + k0 + k] : 0.f;
      ys[r][k] = (kin && j0 + r < m) ? y[(size_t)(j0 + r) * d + k0 + k] : 0.f;
    }
    __syncthreads();
    if (tid < kTile) {
      float s = 0.f;
      for (int k = 0; k < kChunk; ++k) s += xs[tid][k] * xs[tid][k];
      x2s[tid] += s;
    } else if (tid < 2 * kTile) {
      const int r = tid - kTile;
      float s = 0.f;
      for (int k = 0; k < kChunk; ++k) s += ys[r][k] * ys[r][k];
      y2s[r] += s;
    }
    for (int k = 0; k < kChunk; ++k) {
      const float yv = ys[tx][k];
#pragma unroll
      for (int q = 0; q < 4; ++q) dot[q] += xs[ty + 8 * q][k] * yv;
    }
    __syncthreads();
  }

  const float sigma = *sigma_ptr;
  float acc = 0.f;
  const int j = j0 + tx;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = ty + 8 * q;
    if (i0 + r < n && j < m) {
      float d2 = x2s[r] + y2s[tx] - 2.f * dot[q];
      d2 = fmaxf(d2, 0.f);
      for (int v = 0; v < widths.n; ++v)
        acc += expf(-d2 / (2.f * widths.w[v] * sigma));
    }
  }

  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (tid % 32 == 0) warp_sums[tid / 32] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void gram_finish_kernel(const float* __restrict__ partials,
                                   int n_partials, int n_widths,
                                   float* __restrict__ out) {
  __shared__ float buf[kThreads];
  float s = 0.f;
  for (int p = threadIdx.x; p < n_partials; p += kThreads) s += partials[p];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = buf[0] / (float)n_widths;
}

}  // namespace

extern "C" {

// Number of partial sums the caller must allocate for (n, m).
int gram_sum_n_partials(int n, int m) {
  return ((n + kTile - 1) / kTile) * ((m + kTile - 1) / kTile);
}

// x [n, d], y [m, d], sigma [1] and out [1] on the device, f32, row-major.
// partials: gram_sum_n_partials(n, m) floats of scratch.  widths: a host
// array of n_widths (1..8) floats.  Returns cudaGetLastError().
int gram_sum_f32(const float* x, const float* y, const float* sigma,
                 float* partials, float* out, int n, int m, int d,
                 const float* widths, int n_widths, void* stream) {
  if (n_widths < 1 || n_widths > kMaxWidths || n < 1 || m < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  Widths w;
  w.n = n_widths;
  for (int v = 0; v < kMaxWidths; ++v) w.w[v] = v < n_widths ? widths[v] : 1.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  gram_partial_kernel<<<grid, kThreads, 0, s>>>(x, y, sigma, partials, n, m,
                                                d, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_finish_kernel<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y,
                                            n_widths, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
