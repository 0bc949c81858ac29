// FedFusion `conv` operator, f32, for sm_90a (paper Eq. 6):
//
//   out[t, c] = sum_k f_g[t, k] W[k, c] + sum_k f_l[t, k] W[C + k, c]
//
// with f_g, f_l [T, C] and W [2C, C] row-major.  The concatenation
// [f_g, f_l] is never built: the contraction walks K = 2C and takes its
// A operand from f_g for k < C and from f_l for k >= C, into one
// accumulator.
//
// Replaces the TPU kernel src/repro/kernels/fusion_conv.py:fusion_conv
// (_fusion_kernel).  A plain shared-memory tiled GEMM: each block owns a
// 64-token x 64-channel output tile (the grid loops over C in 64-wide
// tiles, so any C works), stages 16-deep slices of A and W in shared
// memory, and each of its 256 threads keeps a 4 x 4 register tile.  The
// ragged ends of T, C and 2C are masked.  Products are FFMA in f32 (no
// TF32), so the numbers follow the f32 reference up to summation order.
//
// What bounds it on the card: at C = 64 it moves 12 bytes per token and
// does 4 C^2 = 16384 flops per token, so bytes (3.35 TB/s) and f32 FFMA
// (67 TFLOP/s) bound it about equally; at the training shape (T = 490) one
// launch's latency dominates.  Tensor cores (wgmma), TMA and a deeper
// pipeline are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kBT = 64;        // tokens per block
constexpr int kBC = 64;        // output channels per block
constexpr int kBK = 16;        // contraction slice staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void fusion_conv_kernel(const float* __restrict__ fg,
                                   const float* __restrict__ fl,
                                   const float* __restrict__ w,
                                   float* __restrict__ out, int T, int C) {
  __shared__ float as[kBK][kBT + 4];   // A slice, k-major
  __shared__ float bs[kBK][kBC + 4];   // W slice

  const int tid = threadIdx.x;
  const int tr = tid / 16;   // token group: tokens tr*4 .. tr*4+3
  const int tc = tid % 16;   // channel group: channels tc*4 .. tc*4+3
  const int t0 = blockIdx.x * kBT;
  const int c0 = blockIdx.y * kBC;
  const int K = 2 * C;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBT * kBK; e += kThreads) {
      const int tt = e / kBK, kk = e % kBK;
      const int t = t0 + tt, k = k0 + kk;
      float v = 0.f;
      if (t < T && k < K)
        v = k < C ? fg[(size_t)t * C + k] : fl[(size_t)t * C + (k - C)];
      as[kk][tt] = v;
    }
    for (int e = tid; e < kBK * kBC; e += kThreads) {
      const int kk = e / kBC, cc = e % kBC;
      const int k = k0 + kk, c = c0 + cc;
      bs[kk][cc] = (k < K && c < C) ? w[(size_t)k * C + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][tr * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tc * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + tr * 4 + i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc * 4 + j;
      if (c < C) out[(size_t)t * C + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// f_g, f_l [T, C], w [2C, C] and out [T, C] on the device, f32, row-major
// and contiguous.  Returns cudaGetLastError().
int fusion_conv_f32(const float* fg, const float* fl, const float* w,
                    float* out, int T, int C, void* stream) {
  if (T < 1 || C < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((T + kBT - 1) / kBT, (C + kBC - 1) / kBC);
  fusion_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fg, fl, w, out, T, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
