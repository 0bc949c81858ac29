// Multi-width RBF Gram sum and the whole MK-MMD term, f32, for sm_90a.
//
//   S(x, y) = sum_{i<n, j<m} mean_w exp(-max(d2_ij, 0) / (2 w sigma)),
//   d2_ij = ||x_i||^2 + ||y_j||^2 - 2 x_i . y_j
//   MMD^2   = S(x, x) / n^2 + S(y, y) / m^2 - 2 S(x, y) / (n m),
//   sigma   = mean_ij d2_ij(x, y) (unclamped) + 1e-8, a stop-grad input
//
// Replaces the TPU kernel src/repro/kernels/mk_mmd.py:gram_sum
// (_gram_sum_kernel), which carried one scalar through a sequential grid;
// the JAX package assembles MMD^2 from three of its sums and sigma in XLA
// (src/repro/kernels/ops.py:mk_mmd2).  Two routes here:
//
// The fused term (mk_mmd2_fwd_kernel, mk_mmd2_bwd_kernel), for n, m <= 64
// rows (the FedMMD main paths: 10 x 10 x 64 on the CNN, 8 x 8 x 576 on
// the LM's pooled features).  One block of 256 threads does the whole term
// in one launch forward and one backward: it stages Z = [x; y] in shared
// memory in chunks of features (cp.async), forms G = Z Z^T in 4 x 4 tiles
// whose features are split over up to 32 threads (so the small main-path
// shapes keep every thread busy), the diagonal gives the norms, and sigma,
// the three sums and the result follow in shared memory, every sum in a
// fixed order.  The backward recomputes G, turns it into
// k'(d2) = d/d(d2) mean_w exp(-d2 / (2 w sigma)) in place, and writes
//   dx_i = g [4/n^2 sum_j k'xx_ij (x_i - x_j)
//             - 4/(nm) sum_j k'xy_ij (x_i - y_j)]
//   dy_j = g [4/m^2 sum_l k'yy_jl (y_j - y_l)
//             - 4/(nm) sum_i k'xy_ij (y_j - x_i)]
// (dy only when asked: FedMMD's global features are detached), reading g
// and sigma from the device.  What bounds it on the card: ~10^4 to 10^6
// flops and a few KB, far below one launch, so launch latency and the
// host's dispatch of the ops around it do: the fused term replaces three
// Gram-sum calls of two launches each and some 175 eager ops a local step
// (sigma, the combination, the closed-form backward) with two launches.
//
// The Gram sum alone (gram_partial_kernel, gram_finish_kernel), which the
// term takes for n or m above 64, in two passes:
//   1. a 2-D grid of (32-row x tile, 32-row y tile) blocks; each stages its
//      rows in shared memory 32 features at a time, forms d2 by the same
//      identity (clamped at 0), applies every width, masks the ragged edge
//      and writes ONE partial sum;
//   2. one block sums the partials in a fixed order and divides by the
//      number of widths.
// At large n, m its inner loop is FFMA-bound (2 d flops per pair plus one
// expf per width); it keeps the n x m Gram matrix out of device memory, so
// bytes stay O((n + m) d).
//
// No float atomics anywhere: repeated runs agree bit for bit.
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

// ------------------------------------------------------ the fused term ----
//
// Z = [x; y] stacks the N = n + m rows; G = Z Z^T ([N][N], symmetric) holds
// the xx, xy (and yx) and yy dot products, its diagonal the norms.

constexpr int kFusedRows = 64;                 // n, m at most
constexpr int kStageFloats = 16384;            // staged Z chunk
constexpr int kFusedWarps = kThreads / 32;

// Features staged per pass over d, and the (odd) row stride they get.
__host__ __device__ inline int fused_chunk(int n, int m, int d) {
  const int c = kStageFloats / (n + m) - 1;
  return c < d ? c : d;
}

// Shared memory of a fused launch, in floats: G, the staged rows, the
// norms, four row sums of 64 and the reduction scratch.
__host__ __device__ inline int fused_smem_floats(int n, int m, int d) {
  const int N = n + m;
  return N * N + N * (fused_chunk(n, m, d) + 1) + N + 4 * kFusedRows + 16;
}

constexpr int kFusedMaxSmem =
    4 * (4 * kFusedRows * kFusedRows + kStageFloats + 2 * kFusedRows +
         4 * kFusedRows + 16);

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Features c0 .. c0 + cw - 1 of the N rows of Z into st ([N][RS]), all of
// them in flight at once (cp.async), then waited for; the caller
// synchronises the block.
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           float* st, int n, int m, int d,
                                           int c0, int cw, int RS) {
  for (int f = threadIdx.x; f < (n + m) * cw; f += kThreads) {
    const int r = f / cw, k = f % cw;
    const float* row = r < n ? x + (size_t)r * d : y + (size_t)(r - n) * d;
    cp_async4(&st[r * RS + k], row + c0 + k);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sums v over the block, warp by warp then the warps in order; every
// thread gets the total.  red holds kFusedWarps + 1 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kFusedWarps; ++w) s += red[w];
    red[kFusedWarps] = s;
  }
  __syncthreads();
  const float total = red[kFusedWarps];
  __syncthreads();                 // red is free again
  return total;
}

// G = Z Z^T and the norms z2 (its diagonal).  G is cut in 4 x 4 tiles;
// each tile's features are split over S neighbouring threads (S a power
// of two, as many as leave no thread idle, at most 32) that take every
// S-th feature of each chunk, their 16 partial sums added by an xor
// shuffle in a fixed order and by the group's first thread into G.  A
// tile is always the same group's, and G[a][b] and G[b][a] take the same
// products in the same order, so G is exactly symmetric.
__device__ void gram_z(const float* __restrict__ x,
                       const float* __restrict__ y, float* G, float* st,
                       float* z2, int n, int m, int d) {
  const int tid = threadIdx.x, N = n + m;
  const int C = fused_chunk(n, m, d), RS = C | 1;
  const int nt = (N + 3) / 4, tiles = nt * nt;
  int S = 1;
  while (S < 32 && 2 * S * tiles <= kThreads) S *= 2;
  const int s = tid % S, per_pass = kThreads / S;
  for (int e = tid; e < N * N; e += kThreads) G[e] = 0.f;
  for (int c0 = 0; c0 < d; c0 += C) {
    const int cw = min(C, d - c0);
    stage_rows(x, y, st, n, m, d, c0, cw, RS);
    __syncthreads();
    for (int base = 0; base < tiles; base += per_pass) {
      const int t = base + tid / S;
      const int a0 = t / nt * 4, b0 = t % nt * 4;
      float acc[4][4] = {};
      if (t < tiles) {
        for (int k = s; k < cw; k += S) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            av[i] = a0 + i < N ? st[(a0 + i) * RS + k] : 0.f;
            bv[i] = b0 + i < N ? st[(b0 + i) * RS + k] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      for (int off = S / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
      if (t < tiles && s == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (a0 + i < N && b0 + j < N)
              G[(a0 + i) * N + b0 + j] += acc[i][j];
      }
    }
    __syncthreads();
  }
  if (tid < N) z2[tid] = G[tid * N + tid];
  __syncthreads();
}

// sigma = mean of the unclamped cross d2 + 1e-8
__device__ __forceinline__ float fused_sigma(const float* G, const float* z2,
                                             float* red, int n, int m) {
  const int N = n + m;
  float s = 0.f;
  for (int e = threadIdx.x; e < n * m; e += kThreads) {
    const int a = e / m, b = n + e % m;
    s += z2[a] + z2[b] - 2.f * G[a * N + b];
  }
  return block_sum(s, red) / (float)(n * m) + 1e-8f;
}

__global__ void __launch_bounds__(kThreads, 1)
mk_mmd2_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, int n, int m, int d,
                   Widths widths) {
  extern __shared__ float smem[];
  const int N = n + m;
  float* G = smem;                                          // [N][N]
  float* st = G + N * N;                                    // [N][RS]
  float* z2 = st + N * (fused_chunk(n, m, d) + 1);          // [N]
  float* red = z2 + N + 4 * kFusedRows;

  gram_z(x, y, G, st, z2, n, m, d);
  const float sigma = fused_sigma(G, z2, red, n, m);
  float axx = 0.f, axy = 0.f, ayy = 0.f;
  for (int e = threadIdx.x; e < N * N; e += kThreads) {
    const int a = e / N, b = e % N;
    if (a >= n && b < n) continue;           // yx: the same as xy
    const float d2 = fmaxf(z2[a] + z2[b] - 2.f * G[e], 0.f);
    float k = 0.f;
    for (int v = 0; v < widths.n; ++v)
      k += expf(-d2 / (2.f * widths.w[v] * sigma));
    if (b < n) axx += k;
    else if (a < n) axy += k;
    else ayy += k;
  }
  const float nw = (float)widths.n;
  const float sxx = block_sum(axx, red) / nw;
  const float sxy = block_sum(axy, red) / nw;
  const float syy = block_sum(ayy, red) / nw;
  if (threadIdx.x == 0) {
    out[0] = sxx / (float)(n * n) + syy / (float)(m * m) -
             2.f * sxy / (float)(n * m);
    out[1] = sigma;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mk_mmd2_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ sigma_ptr,
                   const float* __restrict__ g_ptr, float* __restrict__ dx,
                   float* __restrict__ dy, int n, int m, int d,
                   Widths widths) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, N = n + m;
  const int C = fused_chunk(n, m, d), RS = C | 1;
  float* G = smem;                   // [N][N], then k'
  float* st = G + N * N;             // [N][RS]
  float* z2 = st + N * (C + 1);      // [N]
  float* rxx = z2 + N;               // row sums of k'xx
  float* rxy = rxx + kFusedRows;     // row sums of k'xy
  float* cxy = rxy + kFusedRows;     // column sums of k'xy
  float* ryy = cxy + kFusedRows;     // row sums of k'yy

  gram_z(x, y, G, st, z2, n, m, d);
  const float sigma = *sigma_ptr;
  const float nw = (float)widths.n;
  // k'(d2) in place of each entry (each thread its own entries)
  for (int e = tid; e < N * N; e += kThreads) {
    const float d2 = fmaxf(z2[e / N] + z2[e % N] - 2.f * G[e], 0.f);
    float kp = 0.f;
    for (int v = 0; v < widths.n; ++v) {
      const float s2 = 2.f * widths.w[v] * sigma;
      kp += expf(-d2 / s2) * (-1.f / s2);
    }
    G[e] = kp / nw;
  }
  __syncthreads();
  const float* K = G;
  if (tid < n) {                     // x rows: k'xx and k'xy row sums
    float sxx = 0.f, sxy = 0.f;
    for (int j = 0; j < n; ++j) sxx += K[tid * N + j];
    for (int j = 0; j < m; ++j) sxy += K[tid * N + n + j];
    rxx[tid] = sxx;
    rxy[tid] = sxy;
  } else if (tid >= 128 && tid < 128 + m) {  // y rows: k'xy column sums
    const int r = tid - 128;                 // and k'yy row sums
    float cx = 0.f, syy = 0.f;
    for (int i = 0; i < n; ++i) cx += K[i * N + n + r];
    for (int l = 0; l < m; ++l) syy += K[(n + r) * N + n + l];
    cxy[r] = cx;
    ryy[r] = syy;
  }
  const float g = *g_ptr;
  const float cxx = 4.f * g / (float)(n * n);
  const float cyy = 4.f * g / (float)(m * m);
  const float cnm = 4.f * g / (float)(n * m);
  const float* xs = st;              // staged x rows
  const float* ys = st + n * RS;     // staged y rows
  for (int c0 = 0; c0 < d; c0 += C) {
    const int cw = min(C, d - c0);
    __syncthreads();                 // the row sums; the last chunk read
    stage_rows(x, y, st, n, m, d, c0, cw, RS);
    __syncthreads();
    if (dx != nullptr) {
      for (int f = tid; f < n * cw; f += kThreads) {
        const int i = f / cw, k = f % cw;
        float sx = 0.f, sy = 0.f;
        const float* Ki = K + i * N;
        for (int j = 0; j < n; ++j) sx = fmaf(Ki[j], xs[j * RS + k], sx);
        for (int j = 0; j < m; ++j) sy = fmaf(Ki[n + j], ys[j * RS + k], sy);
        const float xi = xs[i * RS + k];
        dx[(size_t)i * d + c0 + k] =
            cxx * (rxx[i] * xi - sx) - cnm * (rxy[i] * xi - sy);
      }
    }
    if (dy != nullptr) {
      for (int f = tid; f < m * cw; f += kThreads) {
        const int j = f / cw, k = f % cw;
        float sy = 0.f, sx = 0.f;
        const float* Kj = K + (n + j) * N + n;
        for (int l = 0; l < m; ++l) sy = fmaf(Kj[l], ys[l * RS + k], sy);
        for (int i = 0; i < n; ++i)
          sx = fmaf(K[i * N + n + j], xs[i * RS + k], sx);
        const float yj = ys[j * RS + k];
        dy[(size_t)j * d + c0 + k] =
            cyy * (ryy[j] * yj - sy) - cnm * (cxy[j] * yj - sx);
      }
    }
  }
}

Widths make_widths(const float* widths, int n_widths) {
  Widths w;
  w.n = n_widths;
  for (int v = 0; v < kMaxWidths; ++v) w.w[v] = v < n_widths ? widths[v] : 1.f;
  return w;
}

// Lifts the dynamic shared-memory limit of both fused kernels once.
int fused_attr() {
  static bool done = false;
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(
        mk_mmd2_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kFusedMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mk_mmd2_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kFusedMaxSmem);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  return 0;
}

bool fused_shape_ok(int n, int m, int d, int n_widths) {
  return n >= 1 && m >= 1 && d >= 1 && n <= kFusedRows && m <= kFusedRows &&
         n_widths >= 1 && n_widths <= kMaxWidths;
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
  const Widths w = make_widths(widths, n_widths);
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

// The fused term, n, m <= 64: x [n, d], y [m, d] on the device, f32,
// row-major; out [2] receives MMD^2 and sigma.  widths: a host array of
// n_widths (1..8) floats.  One launch.  Returns cudaGetLastError().
int mk_mmd2_fwd_f32(const float* x, const float* y, float* out, int n, int m,
                    int d, const float* widths, int n_widths, void* stream) {
  if (!fused_shape_ok(n, m, d, n_widths)) return (int)cudaErrorInvalidValue;
  const int rc = fused_attr();
  if (rc != 0) return rc;
  mk_mmd2_fwd_kernel<<<1, kThreads, 4 * fused_smem_floats(n, m, d),
                       static_cast<cudaStream_t>(stream)>>>(
      x, y, out, n, m, d, make_widths(widths, n_widths));
  return (int)cudaGetLastError();
}

// Its backward: sigma [1] (out[1] of the forward) and g [1] (dLoss /
// dMMD^2) on the device; dx [n, d] and dy [m, d] are written where not
// null.  One launch.  Returns cudaGetLastError().
int mk_mmd2_bwd_f32(const float* x, const float* y, const float* sigma,
                    const float* g, float* dx, float* dy, int n, int m, int d,
                    const float* widths, int n_widths, void* stream) {
  if (!fused_shape_ok(n, m, d, n_widths)) return (int)cudaErrorInvalidValue;
  const int rc = fused_attr();
  if (rc != 0) return rc;
  mk_mmd2_bwd_kernel<<<1, kThreads, 4 * fused_smem_floats(n, m, d),
                       static_cast<cudaStream_t>(stream)>>>(
      x, y, sigma, g, dx, dy, n, m, d, make_widths(widths, n_widths));
  return (int)cudaGetLastError();
}

}  // extern "C"
