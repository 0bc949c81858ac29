// GQA flash-decode, f32, for sm_90a: one query token against a KV cache,
//
//   o[b, 0, g*rep + j, :] = softmax_l(scale * q[b, 0, g*rep + j, :] . k[b, l, g, :],
//                                     l < valid_len) @ v[b, :, g, :]
//
// q [B, 1, H, hd], k / v caches [B, L, KV, hd], o like q, H = KV * rep (any
// rep), all contiguous and 16-byte aligned; valid_len is one int32 or int64
// on the device (one for the batch), or a value from the host.  Optionally
// each row's log-sum-exp, lse [B, H] = m + log l over the valid positions
// (the Pallas kernel's m_ref / l_ref), one store a row: a caller that cut
// the cache into slices over ranks merges their (o, lse) pairs.  With
// valid_len = 0 (a rank whose slice holds no valid position yet) o is 0
// and lse the finite -1e30, so the slice's merge weight e^(lse - max) is 0.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py:flash_decode
// (_decode_kernel).  The Pallas grid (B, KV, cache blocks) carries the
// online-softmax state across its sequential cache axis, so a direct copy
// would run B * KV blocks: 4 at gemma3-1b's B = 4, KV = 1, each SM
// streaming a 2 MB cache alone.  Here the cache length is cut into slices
// (split-K flash-decode), one block per (slice, b, kv head g), all in ONE
// launch:
//
//   1. the block stages its slice of K and V into shared memory with 16-byte
//      cp.async copies, all issued before the first wait (K, then V, two
//      groups), so every byte of the slice is in flight at once;
//   2. scores for the group's rep query heads, held in registers eight
//      heads at a time (one warp per cache position, lanes across hd, float4
//      loads; the eight heads' sums reduced together in 9 shuffles), then
//      each head's max, probabilities and sum;
//   3. the partial P V, one thread per (head, column);
//   4. a slice that is the only one below valid_len writes o itself.
//      Otherwise each writes (m, l, acc) to scratch and takes an integer
//      ticket; the last block to arrive merges the slices in order,
//      o = sum acc e^(m - M) / sum l e^(m - M), one thread per float4 of
//      the output.  Where the partials exceed 192 KB (gemma3-1b's global
//      layer: 66 slices of 4 KB) the merge takes two levels: the last block
//      of each chunk of about sqrt(n) consecutive slices merges the chunk,
//      and the last chunk merged merges the chunks.  Each last block writes
//      its ticket back to 0.
//
// No float atomics and a fixed merge order, so results repeat bit for bit.
// The tickets live in a buffer the caller zeroes once (each call leaves it
// zero), so no memset precedes a call and a captured CUDA graph replays with
// it.  Each K / V row is read once for all rep heads (the GQA saving of the
// Pallas kernel).  The kernel reads valid_len itself: slices past it return
// at once, and no host synchronisation is needed, so a captured graph can
// replay a decode step whose length lives on the device.
//
// What bounds it on the card: the cache bytes, 2 * B * L * KV * hd * 4 read
// once (8.65 MB, 2.6 us at 3.35 TB/s for a gemma3-1b global layer at
// L = 1056).  At such sizes latency decides: one launch instead of two, a
// slice length (kernels/decode_attn.py:decode_plan) that fills the card once
// with ~32 KB a block in flight, and a merge spread over many blocks (one
// block merging 66 slices of 4 KB alone took longer than the whole read).
//
// Head dims 80 and 120 (stablelm-3b, h2o-danube-3-4b): staging, P V and
// the merge take any hd that is a multiple of 4; a row's score is one
// float4 a lane over 20 or 30 lanes (Row below), the other lanes adding
// +0 * 0, so nothing is padded outside registers and the 12 or 2 idle
// lanes cost only the dot's FFMAs (a row of 80 costs what one of 128
// does).  Rows of 320 and 480 bytes are whole 32-byte sectors.  ptxas
// (nvcc 12.9): 64 registers at hd 80 and 120, no spills.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHeadGroup = 8;        // query heads held in registers at once
constexpr int kMinChunk = 8;         // slices a first-level merge takes, least
constexpr int kOneLevelFloats = 48 * 1024;  // partials one merge reads, most
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;     // an H100 block's shared memory opt-in
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups (the newest) are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Eight per-lane partial dots -> the whole dot of head (lane >> 2) & 7, held
// by the four lanes of each quad: each step halves the values a lane keeps
// (4, 2, 1) and sums its partner's, then the quad sums (9 shuffles, not 40).
__device__ __forceinline__ float reduce8(const float (&v)[8], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (h16 ? v[i + 4] : v[i]) +
           __shfl_xor_sync(kFull, h16 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (h8 ? a[i + 2] : a[i]) +
           __shfl_xor_sync(kFull, h8 ? a[i] : a[i + 2], 8);
  float c = (h4 ? b[1] : b[0]) + __shfl_xor_sync(kFull, h4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(kFull, c, 2);
  return c + __shfl_xor_sync(kFull, c, 1);
}

// A lane's share of one hd-row: NV loads of VEC floats, at (i * 32 + lane)
// * VEC, so a warp reads the row in contiguous pieces of up to 128 or 512
// bytes.  Where hd is not a multiple of 32 * VEC (80, 120: one float4 a
// lane, lanes 20 .. 31 or 30 .. 31 past the row) the lanes past the row
// hold zeros, and their +0 * 0 terms leave every dot product as it is.
template <int HD>
struct Row {
  static constexpr int VEC = HD > 64 ? 4 : 2;
  static constexpr int NV = (HD + 32 * VEC - 1) / (32 * VEC);
  static constexpr int PER_LANE = NV * VEC;
  static_assert(HD % VEC == 0, "a row is whole VEC pieces");

  __device__ __forceinline__ static void load(const float* row, int lane,
                                              float* r) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (HD % (32 * VEC) != 0 && (i * 32 + lane) * VEC >= HD) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) r[VEC * i + e] = 0.f;
        continue;
      }
      const float* p = row + (i * 32 + lane) * VEC;
      if constexpr (VEC == 4) {
        const float4 a = *reinterpret_cast<const float4*>(p);
        r[4 * i] = a.x; r[4 * i + 1] = a.y; r[4 * i + 2] = a.z;
        r[4 * i + 3] = a.w;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(p);
        r[2 * i] = a.x; r[2 * i + 1] = a.y;
      }
    }
  }
};

// valid_kind 0: the host's value_host; 1: an int32 on the device; 2: int64
__device__ __forceinline__ int read_valid(const void* ptr, int kind,
                                          int value_host, int L) {
  long long v = value_host;
  if (kind == 1) v = *static_cast<const int*>(ptr);
  else if (kind == 2) v = *static_cast<const long long*>(ptr);
  return (int)(v < 0 ? 0 : (v > L ? L : v));
}

// The first-level chunk: max(kMinChunk, ceil(sqrt(n))) slices, so both
// levels merge about sqrt(n) partials.
__device__ __forceinline__ int chunk_len(int n) {
  int r = (int)sqrtf((float)n);
  while (r * r < n) ++r;
  return max(kMinChunk, r);
}

// A row's log-sum-exp from its max and sum: finite -1e30 for a row with no
// valid position (sum 0), as the plain version's masked scores give.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : kNegInf;
}

// Merges `count` consecutive partials (m [rep], l [rep], acc [rep][HD] each)
// in order.  final: out = acc / max(l, 1e-30) and, where lse is not null,
// lse[j] = M + log L; otherwise the merged acc goes to out and (M, L) to
// (dm, dl).  red: 2 * rep floats of shared memory; w:
// wcap floats of shared memory for a window of weights e^(m - M).
template <int HD>
__device__ void merge_partials(const float* pm, const float* pl,
                               const float* pa, int count, int rep,
                               float* red, float* w, int wcap, bool final,
                               float* out, float* dm, float* dl,
                               float* lse) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = warp; j < rep; j += kWarps) {
    float mx = kNegInf;
    for (int t = lane; t < count; t += 32)
      mx = fmaxf(mx, __ldcg(pm + (size_t)t * rep + j));
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < count; t += 32)
      sum = fmaf(__ldcg(pl + (size_t)t * rep + j),
                 expf(__ldcg(pm + (size_t)t * rep + j) - mx), sum);
    sum = warp_sum(sum);
    if (lane == 0) {
      red[j] = mx;
      red[rep + j] = sum;
      if (!final) {
        dm[j] = mx;
        dl[j] = sum;
      } else if (lse != nullptr) {
        lse[j] = row_lse(mx, sum);
      }
    }
  }
  __syncthreads();
  // the running sums of a window after the first live in `out`
  const int window = max(1, wcap / rep);
  for (int s0 = 0; s0 < count; s0 += window) {
    const int ns = min(window, count - s0);
    for (int e = tid; e < ns * rep; e += kThreads)
      w[e] = expf(__ldcg(pm + (size_t)s0 * rep + e) - red[e % rep]);
    __syncthreads();
    const bool last_window = s0 + ns == count;
    for (int p4 = tid; p4 < rep * HD / 4; p4 += kThreads) {
      const int j = (p4 * 4) / HD;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0) acc = *reinterpret_cast<const float4*>(out + p4 * 4);
      const float* a = pa + (size_t)s0 * rep * HD + p4 * 4;
#pragma unroll 4
      for (int t = 0; t < ns; ++t) {
        const float wt = w[t * rep + j];
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            a + (size_t)t * rep * HD));
        acc.x = fmaf(v.x, wt, acc.x);
        acc.y = fmaf(v.y, wt, acc.y);
        acc.z = fmaf(v.z, wt, acc.z);
        acc.w = fmaf(v.w, wt, acc.w);
      }
      if (final && last_window) {
        const float l = fmaxf(red[rep + j], 1e-30f);
        acc = make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
      }
      *reinterpret_cast<float4*>(out + p4 * 4) = acc;
    }
    __syncthreads();
  }
}

// After a block's partial is written: one more arrival at *ticket, of
// `expected`.  True in the last block to arrive, which resets the ticket.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int expected) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == expected - 1;
    if (last) *ticket = 0;             // ready for the next call
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                    const float* __restrict__ vc, const void* valid_ptr,
                    int valid_kind, int valid_host, float* __restrict__ o,
                    float* __restrict__ lse, float* __restrict__ scratch,
                    int* __restrict__ tickets, int L, int KV, int rep,
                    int split, float scale) {
  extern __shared__ __align__(16) float smem[];
  using R = Row<HD>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, n_split = gridDim.x;
  const int bg = blockIdx.y, groups = gridDim.y;     // bg = b * KV + g
  const int b = bg / KV, g = bg % KV;
  const int l_end = read_valid(valid_ptr, valid_kind, valid_host, L);
  const int n_act = max(1, (l_end + split - 1) / split);  // slices below it
  if (s >= n_act) return;
  const int l0 = s * split;
  const int n = max(0, min(split, l_end - l0));

  float* Ks = smem;                                   // [split][HD]
  float* Vs = Ks + (size_t)split * HD;                // [split][HD]
  float* ps = Vs + (size_t)split * HD;                // [rep][split]
  float* red = ps + (size_t)rep * split;              // m [rep], l [rep]

  // 1. stage the slice: K rows, then V rows, every copy issued at once
  const size_t row_stride = (size_t)KV * HD;
  const size_t first = ((size_t)b * L + l0) * row_stride + (size_t)g * HD;
  constexpr int CH = HD / 4;                          // 16-byte pieces a row
  for (int c = tid; c < n * CH; c += kThreads) {
    const int t = c / CH, e = (c % CH) * 4;
    cp_async16(&Ks[t * HD + e], kc + first + t * row_stride + e);
  }
  cp_async_commit();
  for (int c = tid; c < n * CH; c += kThreads) {
    const int t = c / CH, e = (c % CH) * 4;
    cp_async16(&Vs[t * HD + e], vc + first + t * row_stride + e);
  }
  cp_async_commit();

  // 2. scores, eight query heads at a time (the first group's rows load
  // while the copies are in flight; missing heads are zero rows)
  const float* qg = q + ((size_t)bg * rep) * HD;
  for (int j0 = 0; j0 < rep; j0 += kHeadGroup) {
    float qr[kHeadGroup][R::PER_LANE];
#pragma unroll
    for (int jj = 0; jj < kHeadGroup; ++jj) {
      if (j0 + jj < rep) {
        R::load(qg + (size_t)(j0 + jj) * HD, lane, qr[jj]);
      } else {
#pragma unroll
        for (int i = 0; i < R::PER_LANE; ++i) qr[jj][i] = 0.f;
      }
    }
    if (j0 == 0) {
      cp_async_wait<1>();                             // K has landed
      __syncthreads();
    }
    const int nj = min(kHeadGroup, rep - j0);
    for (int t = warp; t < n; t += kWarps) {
      float kr[R::PER_LANE];
      R::load(&Ks[t * HD], lane, kr);
      float v[kHeadGroup];
#pragma unroll
      for (int jj = 0; jj < kHeadGroup; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < R::PER_LANE; ++i) dot = fmaf(qr[jj][i], kr[i], dot);
        v[jj] = dot;
      }
      const float dot = reduce8(v, lane);
      const int h = (lane >> 2) & 7;
      if ((lane & 3) == 0 && h < nj) ps[(j0 + h) * split + t] = dot * scale;
    }
  }
  __syncthreads();

  // each head's max, probabilities and sum over the slice (a warp a head)
  for (int j = warp; j < rep; j += kWarps) {
    float* pj = ps + (size_t)j * split;
    float mx = kNegInf;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pj[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(pj[t] - mx);
      pj[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      red[j] = mx;
      red[rep + j] = sum;
    }
  }
  cp_async_wait<0>();                                 // V has landed
  __syncthreads();

  // 3. partial P V, a thread per (head, column)
  const bool alone = n_act == 1;
  const size_t slices = (size_t)groups * n_split;
  float* pacc = scratch + ((size_t)bg * n_split + s) * rep * HD;
  for (int p = tid; p < rep * HD; p += kThreads) {
    const int j = p / HD, d = p % HD;
    const float* pj = ps + (size_t)j * split;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < n; ++t) acc = fmaf(pj[t], Vs[t * HD + d], acc);
    if (alone)
      o[(size_t)bg * rep * HD + p] = acc / fmaxf(red[rep + j], 1e-30f);
    else
      pacc[p] = acc;
  }
  if (alone) {
    if (lse != nullptr)
      for (int j = tid; j < rep; j += kThreads)
        lse[(size_t)bg * rep + j] = row_lse(red[j], red[rep + j]);
    return;
  }

  // 4. the slice's (m, l); then the two-level merge
  float* pm = scratch + slices * rep * HD;            // [bg][s][rep]
  float* pl = pm + slices * rep;
  const size_t at = ((size_t)bg * n_split + s) * rep;
  for (int j = tid; j < rep; j += kThreads) {
    pm[at + j] = red[j];
    pl[at + j] = red[rep + j];
  }
  const int max_chunks = (n_split + kMinChunk - 1) / kMinChunk;
  // two levels where one block would read more than kOneLevelFloats of
  // partials (at fewer, a second level's fence and ticket cost more)
  const int csz = (size_t)n_act * rep * HD > kOneLevelFloats
                      ? chunk_len(n_act) : n_act;
  const int n_chunks = (n_act + csz - 1) / csz;
  const int c = s / csz, c0 = c * csz, cn = min(csz, n_act - c0);
  int* tk = tickets + (size_t)bg * (max_chunks + 1);
  if (!last_to_arrive(&tk[c], cn)) return;
  float* w = Ks;                                      // staging is free now
  const int wcap = 2 * split * HD;
  const size_t first_slice = (size_t)bg * n_split + c0;
  float* og = o + (size_t)bg * rep * HD;
  float* lg = lse == nullptr ? nullptr : lse + (size_t)bg * rep;
  if (n_chunks == 1) {
    merge_partials<HD>(pm + first_slice * rep, pl + first_slice * rep,
                       scratch + first_slice * rep * HD, cn, rep, red, w,
                       wcap, true, og, nullptr, nullptr, lg);
    return;
  }
  const size_t chunks = (size_t)groups * max_chunks;
  float* ca = pl + slices * rep;                      // [bg][c][rep][HD]
  float* cm = ca + chunks * rep * HD;                 // [bg][c][rep]
  float* cl = cm + chunks * rep;
  const size_t mine = (size_t)bg * max_chunks + c;
  merge_partials<HD>(pm + first_slice * rep, pl + first_slice * rep,
                     scratch + first_slice * rep * HD, cn, rep, red, w, wcap,
                     false, ca + mine * rep * HD, cm + mine * rep,
                     cl + mine * rep, nullptr);
  if (!last_to_arrive(&tk[max_chunks], n_chunks)) return;
  const size_t first_chunk = (size_t)bg * max_chunks;
  merge_partials<HD>(cm + first_chunk * rep, cl + first_chunk * rep,
                     ca + first_chunk * rep * HD, n_chunks, rep, red, w,
                     wcap, true, og, nullptr, nullptr, lg);
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const void* valid,
           int valid_kind, int valid_host, float* o, float* lse,
           float* scratch, int* tickets, int B, int L, int H, int KV,
           int split, cudaStream_t stream) {
  const int rep = H / KV;
  const int n_split = (L + split - 1) / split;
  const size_t smem =
      sizeof(float) * ((size_t)2 * split * HD + (size_t)rep * split + 2 * rep);
  if (smem > (size_t)kMaxSmem - 1024) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the opt-in above 48 KB of dynamic shared memory, raised per device to
  // the largest a call has needed (the kernel's static bytes come on top)
  static size_t raised[64] = {};
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > raised[dev]) {
    err = cudaFuncSetAttribute(flash_decode_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = smem;
  }
  const float scale = (float)(1.0 / std::sqrt((double)HD));
  flash_decode_kernel<HD><<<dim3(n_split, B * KV), kThreads, smem, stream>>>(
      q, k, v, valid, valid_kind, valid_host, o, lse, scratch, tickets, L, KV,
      rep, split, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, 1, H, hd], k / v [B, L, KV, hd] and o [B, 1, H, hd] on the device,
// f32, contiguous, 16-byte aligned.  valid_len: valid_kind 0 takes
// valid_host, 1 an int32 and 2 an int64 at valid (on the device).  lse:
// null, or [B, H] f32 on the device for each row's log-sum-exp.  With
// n_split = ceil(L / split) and X = ceil(n_split / 8): scratch holds
// B * KV * (n_split + X) * rep * (hd + 2) floats (unused, and may be null,
// when n_split is 1); tickets B * KV * (X + 1) ints, zero before the first
// call (each call leaves them zero).  hd in {64, 80, 120, 128, 256} (the
// head dims of the repository's configs; any other returns
// cudaErrorInvalidValue), any rep = H / KV >= 1, 1 <= split,
// B * KV <= 65535.  Returns cudaGetLastError().
int flash_decode_f32(const float* q, const float* k, const float* v,
                     const void* valid, int valid_kind, int valid_host,
                     float* o, float* lse, float* scratch, int* tickets,
                     int B, int L, int H, int KV, int hd, int split,
                     void* stream) {
  if (B < 1 || L < 1 || KV < 1 || H % KV != 0 || split < 1 ||
      (long long)B * KV > 65535 || valid_kind < 0 || valid_kind > 2 ||
      (valid_kind != 0 && valid == nullptr) ||
      ((L + split - 1) / split > 1 && (scratch == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, valid, valid_kind, valid_host, o, lse,
                        scratch, tickets, B, L, H, KV, split, st);
    case 80:
      return launch<80>(q, k, v, valid, valid_kind, valid_host, o, lse,
                        scratch, tickets, B, L, H, KV, split, st);
    case 120:
      return launch<120>(q, k, v, valid, valid_kind, valid_host, o, lse,
                         scratch, tickets, B, L, H, KV, split, st);
    case 128:
      return launch<128>(q, k, v, valid, valid_kind, valid_host, o, lse,
                         scratch, tickets, B, L, H, KV, split, st);
    case 256:
      return launch<256>(q, k, v, valid, valid_kind, valid_host, o, lse,
                         scratch, tickets, B, L, H, KV, split, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
