// FedFusion `conv` operator, f32, for sm_90a (paper Eq. 6):
//
//   out[t, c] = sum_k f_g[t, k] W[k, c] + sum_k f_l[t, k] W[C + k, c]
//
// with f_g, f_l [T, C] and W [2C, N] row-major: N = C, or N = C / m for
// the column block a tensor-parallel rank holds, which writes out [T, N].
// The concatenation [f_g, f_l] is never built: the contraction walks K = 2C and takes its
// A operand from f_g for k < C and from f_l for k >= C.
//
// Replaces the TPU kernel src/repro/kernels/fusion_conv.py:fusion_conv
// (_fusion_kernel).  An f32 SGEMM tiled for this card, in two tilings (the
// host picks one from the shape, kernels/fusion_conv.py conv_plan):
//
//   large  128 tokens x 64 channels a block of 128 threads, each thread an
//          8 x 8 register tile (rows tm*4 + {0..3} and + 64, channels
//          tn*4 + {0..3} and + 32), K in 16-deep slices;
//   small  16 x 32 a block, 4 x 4 a thread, K in 32-deep slices whose
//          depth four warps split; at the end warps 1..3 hand their sums
//          to warp 0 through shared memory, which adds them in warp order.
//          For T = 490 (the CNN's training shape) that is 62 blocks where
//          the large tiling would give 4.
//
// Two shared-memory stages: while one slice is used, the next one's W
// arrives by 16-byte cp.async and its A (float4s along k, from f_g or
// f_l) waits in registers, stored transposed (k-major, [BK][BM + 4]) once
// the slice is done.  At each depth a thread reads its A rows and W
// channels as float4s (2 + 2 in the large tiling: 16 FFMAs per 128-bit
// load; a quarter warp shares its A address and reads 8 neighbouring W
// float4s, so no bank conflicts), the next depth's while this one's FFMAs
// run.  Where C % 4 != 0 (or N % 4 != 0) or a pointer is not 16-byte aligned the same
// kernel loads and stores single floats.  Products are FFMA in f32 (no
// TF32), every sum is taken in a fixed order, so the result is bitwise
// repeatable and follows the f32 reference up to summation order.
//
// What bounds it on the card: 4 T C^2 flops against 12 T C + 8 C^2 bytes.
// At C = 576 (smollm-135m's fusion, T = 8,192) operations: 10.9 GFLOP,
// 0.162 ms at 67 TFLOP/s; at C = 64 bytes and operations about equally
// (T = 100,352: 0.023 / 0.025 ms); at T = 490 one launch's latency.  The
// large tiling runs at about half the FFMA peak (PERF.md): by count it
// issues 16 FFMAs per shared-memory load and per 4 wavefronts, so neither
// the loads nor bank conflicts should bind it; what does is not resolved
// without a profiler.  Its 163 registers leave 3 blocks an SM; capping
// them at 128 (4 blocks) was slower, and A read row-major (float4s along
// k, 32 registers of fragments) was 1.2x slower.  Tensor cores (TF32 /
// bf16 wgmma) and TMA would change the numerics and are later work.
// ptxas (-Xptxas=-v, nvcc 12.9): small 77 registers, large 163, no
// spills.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups (the newest) are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// A tiling: BM tokens x BN channels a block, TM x TN outputs a thread, K in
// BK-deep slices through two stages, each slice's depth split among KS
// thread groups.
template <int BM_, int BN_, int TM_, int TN_, int KS_, int BK_>
struct ConvTile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, KS = KS_;
  static constexpr int BK = BK_;
  static constexpr int NTM = BM / TM, NTN = BN / TN;  // threads a group
  static constexpr int GT = NTM * NTN;
  static constexpr int THREADS = GT * KS;
  static constexpr int AS = BM + 4;                   // row stride of A^T
  static constexpr int STAGE = BK * AS + BK * BN;     // floats a stage
  static constexpr int KQ = BK / KS;                  // depth a group
  static constexpr int APT = BM * BK / 4 / THREADS;   // A float4s a thread
  static constexpr int RING = 2 * STAGE;
  static constexpr int RED = (KS - 1) * BM * BN;      // hand-over floats
  static constexpr int FLOATS = RING > RED ? RING : RED;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && NTN == 8 && GT % 32 == 0 &&
                    APT >= 1 && APT * THREADS * 4 == BM * BK,
                "tile shape");
};

using Small = ConvTile<16, 32, 4, 4, 4, 32>;
using Large = ConvTile<128, 64, 8, 8, 1, 16>;

// At least one block an SM: with that bound ptxas gives the large tiling
// 163 registers; left to its default it gave 159 and ran 1.15x slower at
// (8,192, 576) (PERF.md).
template <typename P>
__global__ void __launch_bounds__(P::THREADS, 1)
fusion_conv_kernel(const float* __restrict__ fg, const float* __restrict__ fl,
                   const float* __restrict__ w, float* __restrict__ out,
                   int T, int C, int N, int vec) {
  constexpr int BM = P::BM, BN = P::BN, BK = P::BK, AS = P::AS;
  constexpr int TM = P::TM, TN = P::TN, NTM = P::NTM, NTN = P::NTN;
  constexpr int KQ = P::KQ;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int grp = tid / P::GT, gt = tid % P::GT;
  const int tm = gt / NTN, tn = gt % NTN;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K = 2 * C;
  const int n_slices = (K + BK - 1) / BK;

  // A's slice s (rows t0.., depth s * BK..) into registers, 4 floats of a
  // row each, then into a stage transposed ([BK][AS]: k-major)
  float4 ra[P::APT];
  auto load_a = [&](int s) {
#pragma unroll
    for (int i = 0; i < P::APT; ++i) {
      const int e = tid + i * P::THREADS;
      const int m = e / (BK / 4), k = s * BK + 4 * (e % (BK / 4));
      const int t = t0 + m;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vec) {   // C % 4 == 0: the 4 floats lie wholly in f_g or in f_l
        if (t < T && k < K)
          v = __ldg(reinterpret_cast<const float4*>(
              k < C ? fg + (size_t)t * C + k : fl + (size_t)t * C + (k - C)));
      } else if (t < T) {
        float x[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = k + c;
          x[c] = kk >= K ? 0.f
                         : kk < C ? __ldg(fg + (size_t)t * C + kk)
                                  : __ldg(fl + (size_t)t * C + (kk - C));
        }
        v = make_float4(x[0], x[1], x[2], x[3]);
      }
      ra[i] = v;
    }
  };
  auto store_a = [&](int st) {
    float* As = smem + st * P::STAGE;
#pragma unroll
    for (int i = 0; i < P::APT; ++i) {
      const int e = tid + i * P::THREADS;
      const int m = e / (BK / 4), k = 4 * (e % (BK / 4));
      As[k * AS + m] = ra[i].x;
      As[(k + 1) * AS + m] = ra[i].y;
      As[(k + 2) * AS + m] = ra[i].z;
      As[(k + 3) * AS + m] = ra[i].w;
    }
  };
  // W's slice s into a stage ([BK][BN]) by cp.async
  auto issue_w = [&](int s, int st) {
    float* Bs = smem + st * P::STAGE + BK * AS;
    for (int e = tid; e < BK * (BN / 4); e += P::THREADS) {
      const int kr = e / (BN / 4), n = n0 + 4 * (e % (BN / 4));
      const int k = s * BK + kr;
      float* dst = &Bs[kr * BN + n - n0];
      if (vec) {
        const bool ok = k < K && n < N;
        cp_async16(dst, ok ? w + (size_t)k * N + n : w, ok);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = k < K && n + i < N;
          cp_async4(dst + i, ok ? w + (size_t)k * N + n + i : w, ok);
        }
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_a(0);
  issue_w(0, 0);
  cp_async_commit();
  store_a(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int it = 0; it < n_slices; ++it) {
    const bool more = it + 1 < n_slices;
    if (more) {          // the next slice is in flight during this one
      load_a(it + 1);
      issue_w(it + 1, (it + 1) & 1);
    }
    cp_async_commit();
    const float* As = smem + (it & 1) * P::STAGE;
    const float* Bs = As + BK * AS;
    // fragments of depth k: TM rows of A (float4s of 4 rows) and TN
    // channels of W, the next depth's loaded while this one is used
    float4 fa[2][TM / 4], fb[2][TN / 4];
    auto load_frag = [&](int buf, int k) {
#pragma unroll
      for (int h = 0; h < TM / 4; ++h)
        fa[buf][h] = *reinterpret_cast<const float4*>(
            &As[k * AS + h * NTM * 4 + tm * 4]);
#pragma unroll
      for (int h = 0; h < TN / 4; ++h)
        fb[buf][h] = *reinterpret_cast<const float4*>(
            &Bs[k * BN + h * NTN * 4 + tn * 4]);
    };
    load_frag(0, grp * KQ);
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      if (q + 1 < KQ) load_frag((q + 1) & 1, grp * KQ + q + 1);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float x = lane(fa[q & 1][i / 4], i % 4);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(x, lane(fb[q & 1][j / 4], j % 4), acc[i][j]);
      }
    }
    if (more) store_a((it + 1) & 1);
    cp_async_wait<0>();
    __syncthreads();
  }

  if constexpr (P::KS > 1) {
    // groups 1.. hand their sums to group 0, which adds them in order
    float* red = smem;   // [KS - 1][TM * TN][GT]
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          red[((grp - 1) * TM * TN + i * TN + j) * P::GT + gt] = acc[i][j];
    }
    __syncthreads();
    if (grp > 0) return;
    for (int g = 1; g < P::KS; ++g)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += red[((g - 1) * TM * TN + i * TN + j) * P::GT + gt];
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + (i / 4) * NTM * 4 + tm * 4 + i % 4;
    if (t >= T) continue;
    float* row = out + (size_t)t * N;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int n = n0 + (j / 4) * NTN * 4 + tn * 4;
      if (vec) {
        if (n < N)
          *reinterpret_cast<float4*>(&row[n]) =
              make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                          acc[i][j + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) row[n + e] = acc[i][j + e];
      }
    }
  }
}

template <typename P>
int launch(const float* fg, const float* fl, const float* w, float* out,
           int T, int C, int N, int vec, cudaStream_t stream) {
  constexpr size_t smem = P::FLOATS * sizeof(float);
  if constexpr (smem > 48 * 1024) {
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          fusion_conv_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
      attr_set = true;
    }
  }
  dim3 grid((T + P::BM - 1) / P::BM, (N + P::BN - 1) / P::BN);
  fusion_conv_kernel<P><<<grid, P::THREADS, smem, stream>>>(fg, fl, w, out, T,
                                                           C, N, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f_g, f_l [T, C], w [2C, N] and out [T, N] on the device, f32, row-major
// and contiguous (N = C for the whole operator; N < C for a column block of
// w, as a tensor-parallel rank holds); plan 0 takes the small tiling, 1 the
// large one.  Returns cudaGetLastError().
int fusion_conv_f32(const float* fg, const float* fl, const float* w,
                    float* out, int T, int C, int N, int plan, void* stream) {
  if (T < 1 || C < 1 || N < 1 || (plan != 0 && plan != 1))
    return (int)cudaErrorInvalidValue;
  const uintptr_t addr = (uintptr_t)fg | (uintptr_t)fl | (uintptr_t)w |
                         (uintptr_t)out;
  const int vec = C % 4 == 0 && N % 4 == 0 && addr % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return plan == 1 ? launch<Large>(fg, fl, w, out, T, C, N, vec, st)
                   : launch<Small>(fg, fl, w, out, T, C, N, vec, st);
}

}  // extern "C"
