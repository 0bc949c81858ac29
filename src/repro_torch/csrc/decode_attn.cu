// GQA flash-decode, f32, for sm_90a: one query token against a KV cache,
//
//   o[b, 0, g*rep + j, :] = softmax_l(scale * q[b, 0, g*rep + j, :] . k[b, l, g, :],
//                                     l < valid_len) @ v[b, :, g, :]
//
// q [B, 1, H, hd], k / v caches [B, L, KV, hd], o like q, H = KV * rep, all
// contiguous; valid_len is an int32 on the device (one for the batch).
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py:flash_decode
// (_decode_kernel).  The Pallas grid (B, KV, cache blocks) carries the
// online-softmax state across its sequential cache axis, so a direct copy
// would run B * KV blocks: 4 at gemma3-1b's B = 4, KV = 1, each SM
// streaming a 2 MB cache alone.  Here the cache length is split across
// blocks instead (split-K flash-decode):
//
//   decode_split_kernel    one block per (cache slice, b, kv head g): the
//                          slice's scores for the rep query heads of the
//                          group (one warp per position, lanes across hd,
//                          a shuffle reduction per head), their max and sum,
//                          and the unnormalised partial P V, written to
//                          scratch as (m, l, acc) per head;
//   decode_combine_kernel  one block per (b, query head): merges the slices
//                          in a fixed order, o = sum_s acc_s e^(m_s - M) /
//                          sum_s l_s e^(m_s - M).
//
// No float atomics, so results repeat bit for bit.  Each K / V row is read
// once for all rep heads (the GQA saving of the Pallas kernel).  The kernel
// reads valid_len itself: slices past it write (-1e30, 0, 0) and return, and
// no host synchronisation is needed, so a captured CUDA graph can replay a
// decode step whose length lives on the device.
//
// What bounds it on the card: the cache bytes, 2 * B * L * KV * hd * 4 read
// once (8.65 MB, 2.6 us at 3.35 TB/s for a gemma3-1b global layer at
// L = 1056); at such sizes two launches cost more than the transfer.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;
constexpr int kMaxSplit = 64;        // cache positions per slice, at most
constexpr float kNegInf = -1e30f;

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                    const float* __restrict__ vc,
                    const int* __restrict__ valid_len, float* __restrict__ pm,
                    float* __restrict__ pl, float* __restrict__ pacc, int L,
                    int H, int KV, int rep, int split, float scale) {
  __shared__ float ps[kMaxRep][kMaxSplit];
  __shared__ float sm_m[kMaxRep], sm_l[kMaxRep];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int s = blockIdx.x, n_split = gridDim.x;
  const int bg = blockIdx.y;            // b * KV + g
  const int b = bg / KV, g = bg % KV;
  const int l0 = s * split;
  const int l1 = min(min(l0 + split, L), min(*valid_len, L));
  const int n = l1 - l0;
  const size_t part = (size_t)bg * n_split + s;   // (b, g, slice)

  if (n <= 0) {                          // a slice past valid_len
    for (int e = tid; e < rep * HD; e += kThreads) pacc[part * rep * HD + e] = 0.f;
    if (tid < rep) {
      pm[part * rep + tid] = kNegInf;
      pl[part * rep + tid] = 0.f;
    }
    return;
  }

  // the group's rep query rows, lane-strided over hd
  constexpr int PER_LANE = HD / 32;
  float qr[kMaxRep][PER_LANE];
  const float* qg = q + ((size_t)b * H + g * rep) * HD;
#pragma unroll
  for (int j = 0; j < kMaxRep; ++j)
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      qr[j][i] = j < rep ? qg[j * HD + lane + 32 * i] : 0.f;

  // scores: one warp per cache position
  for (int t = warp; t < n; t += kWarps) {
    const float* krow = kc + (((size_t)b * L + l0 + t) * KV + g) * HD;
    float kr[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) kr[i] = krow[lane + 32 * i];
#pragma unroll
    for (int j = 0; j < kMaxRep; ++j) {
      if (j >= rep) break;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) dot = fmaf(qr[j][i], kr[i], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) ps[j][t] = dot * scale;
    }
  }
  __syncthreads();

  // per head: the slice's max, probabilities and sum (one warp per head)
  for (int j = warp; j < rep; j += kWarps) {
    float mx = kNegInf;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, ps[j][t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(ps[j][t] - mx);
      ps[j][t] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      sm_m[j] = mx;
      sm_l[j] = sum;
    }
  }
  __syncthreads();

  // partial P V: threads across hd
  for (int d = tid; d < HD; d += kThreads) {
    float acc[kMaxRep];
#pragma unroll
    for (int j = 0; j < kMaxRep; ++j) acc[j] = 0.f;
    const float* vcol = vc + ((size_t)b * L + l0) * KV * HD + (size_t)g * HD + d;
    for (int t = 0; t < n; ++t) {
      const float vv = vcol[(size_t)t * KV * HD];
#pragma unroll
      for (int j = 0; j < kMaxRep; ++j)
        if (j < rep) acc[j] = fmaf(ps[j][t], vv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxRep; ++j)
      if (j < rep) pacc[(part * rep + j) * HD + d] = acc[j];
  }
  if (tid < rep) {
    pm[part * rep + tid] = sm_m[tid];
    pl[part * rep + tid] = sm_l[tid];
  }
}

template <int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                      const float* __restrict__ pacc, float* __restrict__ o,
                      int KV, int rep, int n_split) {
  const int d = threadIdx.x;
  const int bh = blockIdx.x;            // b * H + g * rep + j
  const int H = KV * rep;
  const int b = bh / H, g = (bh % H) / rep, j = bh % rep;
  const size_t first = (size_t)(b * KV + g) * n_split;   // slice 0 of (b, g)
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, pm[(first + s) * rep + j]);
  float lsum = 0.f, acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t at = (first + s) * rep + j;
    const float w = expf(pm[at] - M);
    lsum = fmaf(pl[at], w, lsum);
    acc = fmaf(pacc[at * HD + d], w, acc);
  }
  o[(size_t)bh * HD + d] = acc / fmaxf(lsum, 1e-30f);
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const int* valid,
           float* o, float* pm, float* pl, float* pacc, int B, int L, int H,
           int KV, int split, float scale, cudaStream_t stream) {
  const int rep = H / KV;
  const int n_split = (L + split - 1) / split;
  decode_split_kernel<HD><<<dim3(n_split, B * KV), kThreads, 0, stream>>>(
      q, k, v, valid, pm, pl, pacc, L, H, KV, rep, split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<HD><<<B * H, HD, 0, stream>>>(pm, pl, pacc, o, KV, rep,
                                                      n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, 1, H, hd], k / v [B, L, KV, hd] and o [B, 1, H, hd] on the device,
// f32, contiguous; valid_len one int32 on the device; scratch pm, pl
// [B, KV, n_split, rep] and pacc [B, KV, n_split, rep, hd] f32, with
// n_split = ceil(L / split).  hd in {64, 128, 256}, 1 <= H / KV <= 8,
// 1 <= split <= 64.  Returns cudaGetLastError().
int flash_decode_f32(const float* q, const float* k, const float* v,
                     const int* valid_len, float* o, float* pm, float* pl,
                     float* pacc, int B, int L, int H, int KV, int hd,
                     int split, float scale, void* stream) {
  if (B < 1 || L < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxRep ||
      split < 1 || split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, valid_len, o, pm, pl, pacc, B, L, H, KV, split,
                        scale, st);
    case 128:
      return launch<128>(q, k, v, valid_len, o, pm, pl, pacc, B, L, H, KV,
                         split, scale, st);
    case 256:
      return launch<256>(q, k, v, valid_len, o, pm, pl, pacc, B, L, H, KV,
                         split, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
