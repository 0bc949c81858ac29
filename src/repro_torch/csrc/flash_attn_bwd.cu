// GQA flash attention backward, f32, for sm_90a: two kernels.
//
//   p[r, k]  = exp(scale * q_r . k_k - lse_r)       (0 where k is not visible)
//   ds[r, k] = p[r, k] * (do_r . v_k - D_r),  D_r = do_r . o_r
//   dq_r     = scale * sum_k ds[r, k] k_k                     (K8b)
//   dv_k     = sum_r p[r, k] do_r,  dk_k = scale * sum_r ds[r, k] q_r  (K8c)
//
// r runs over the (position, query head) rows of one KV group g: row r of
// a tile of positions starting at p0 is position p0 + r / rep, head
// g * rep + r % rep.  q, do, dq [B, S, H, hd]; k, v, dk, dv [B, S, KV, hd];
// lse and D [B, KV, rep, S]; H = KV * rep, all contiguous.  A key k is
// visible from query p when k < S, k <= p (causal) and p - k < window
// (window > 0), as in the forward (csrc/flash_attn.cu).
//
// Replaces the TPU kernels src/repro/kernels/flash_attn.py:_dq_kernel_real
// (K8b, the pallas_call at :302) and _dkv_kernel (K8c, :322).  The Pallas
// grids (B, KV, outer block, inner block) carry dq, or dk and dv, across
// their sequential innermost axis in VMEM scratch.  Here a block owns one
// outer tile and walks the inner tiles in a loop of its own, with the
// accumulators in registers; p is recomputed from the saved lse (no online
// softmax).  The two-kernel split is kept: K8c owns its keys, and summing
// over all rows of a query tile sums over the rep heads of the group, so
// no block writes another's output: no atomics, and the results are
// bitwise repeatable.
//
//   K8b  one block per (b, g, 64 rows = 64 / rep positions); walks the
//        32-key tiles visible to those rows.  Per tile: s = Q K^T and
//        dp = dO V^T (each thread 4 rows x 2 keys, float4 loads along hd),
//        ds into shared memory (transposed), then dq[64 x hd] += ds K.
//   K8c  one block per (b, g, 32 keys); walks the 64-row query tiles that
//        can see them (positions k0 .. k0 + 31 + window - 1, causal from
//        k0).  Per tile: s, dp as in K8b, p and ds into shared memory, then
//        dv[32 x hd] += p^T dO and dk[32 x hd] += ds^T Q.  Keys that no
//        query sees get zeros.
//
// Tiles wholly above the diagonal or outside the window are never visited
// (the Pallas kernels visit and mask all of them).  Q, dO, K and V tiles are
// kept row by row in shared memory with a stride of hd + 4 floats: a
// quarter warp's float4 loads of 8 neighbouring keys land on 32 distinct
// banks, and the same K tile serves s = Q K^T (along hd) and ds K (along
// keys), so no transposed copy is needed.  Products are FFMA in f32 (no
// TF32), exp is expf: the numbers follow the f32 reference up to summation
// order.
//
// What bounds it on the card: per visible (query head, key) pair, K8b does
// three products of hd (s, dp, dq) and K8c four (s, dp, dv, dk), 2 * hd
// FLOP each, against 67 TFLOP/s f32: 0.22 ms (K8b) and 0.29 ms (K8c) at
// smollm-135m's B = 8, S = 1024; ~70 MB of q, do, dq, k, v, lse and D
// take 21 us at 3.35 TB/s: operations.  Shared memory at hd = 256 is the
// constraint: K8b holds 209 KB (Q, dO: 64 x 260 floats each; K, V: 32 x
// 260; ds^T), K8c 219 KB (the same, with p and ds 64 x 36 each), one block
// per SM; at hd = 64 shared memory admits three (61 KB, 71 KB) and the
// registers two.  This first version loads each K / V (K8b) or Q / dO
// (K8c) tile synchronously after a barrier; prefetching the next tile,
// tensor cores (wgmma on TF32 or bf16) and TMA are later work.  ptxas
// (-Xptxas=-v, kernels/build.py, nvcc 12.9): K8b 116 / 124 / 164
// registers at hd 64 / 128 / 256, K8c 120 / 128 / 168, no spills and no
// stack frame.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;          // (position, head) rows per query tile
constexpr int kKT = 32;            // keys per tile
constexpr int kThreads = 256;

template <int HD>
struct Tile {
  static constexpr int RS = HD + 4;             // row stride of Q, dO, K, V
  // output register tiles: NCG groups of float4 columns, CM columns each
  static constexpr int NCG = HD / 4 < 32 ? HD / 4 : 32;
  static constexpr int CM = HD / NCG;
  static constexpr int NRG = kThreads / NCG;
  static constexpr int RM = kRows / NRG;        // K8b: dq rows a thread owns
  static constexpr int KM = kKT / NRG;          // K8c: dk / dv keys a thread owns
  static constexpr int TS = kRows + 4;          // K8b: row stride of ds^T
  static constexpr int PS = kKT + 4;            // K8c: row stride of p, ds
  static constexpr int DQ_FLOATS =
      2 * kRows * RS + 2 * kKT * RS + kKT * TS + 2 * kRows;
  static constexpr int DKV_FLOATS =
      2 * kRows * RS + 2 * kKT * RS + 2 * kRows * PS + 2 * kRows;
};

// Blocks per SM the register budget must allow (shared memory admits 3 /
// 2 / 1 of K8b at hd 64 / 128 / 256 and 3 / 1 / 1 of K8c).
template <int HD>
constexpr int kMinBlocks = HD == 256 ? 1 : 2;

// acc[i][j] += a_i . b_j over hd for the thread's rows tr * 4 + i of A and
// keys tc + 16 j of B (both [rows][RS] in shared memory): s = Q K^T or
// dp = dO V^T.  Within a quarter warp the 8 threads share tr (one A
// address, broadcast) and read 8 neighbouring keys (32 distinct banks).
template <int HD>
__device__ __forceinline__ void row_key_products(const float* A,
                                                 const float* Bk, int tr,
                                                 int tc, float (&acc)[4][2]) {
  constexpr int RS = Tile<HD>::RS;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(tr * 4 + i) * RS + d]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      b[j] = *reinterpret_cast<const float4*>(&Bk[(tc + 16 * j) * RS + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// n consecutive floats from shared memory (n a multiple of 2, 8-byte
// aligned; float4s where n is a multiple of 4)
template <int N>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(&src[i]);
      dst[i] = t.x; dst[i + 1] = t.y; dst[i + 2] = t.z; dst[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(&src[i]);
      dst[i] = t.x; dst[i + 1] = t.y;
    }
  }
}

// the thread's CM output columns, as float4 groups cg, cg + NCG, ...
template <int HD>
__device__ __forceinline__ void load_cols(const float* row, int cg,
                                          float (&dst)[Tile<HD>::CM]) {
  constexpr int NCG = Tile<HD>::NCG;
#pragma unroll
  for (int j = 0; j < Tile<HD>::CM; j += 4) {
    const float4 t =
        *reinterpret_cast<const float4*>(&row[(j / 4) * NCG * 4 + cg * 4]);
    dst[j] = t.x; dst[j + 1] = t.y; dst[j + 2] = t.z; dst[j + 3] = t.w;
  }
}

// Rows [0, 64) of the query tile at positions p0 .. p0 + n_pos - 1 of
// q and do into Qs / dOs ([64][RS], zeros past nrows), and their lse and
// D into lse_s / d_s.
template <int HD>
__device__ __forceinline__ void load_query_tile(
    const float* __restrict__ q, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dcap,
    float* Qs, float* dOs, float* lse_s, float* d_s, int b, int g, int p0,
    int nrows, int S, int H, int KV, int rep, int tid) {
  constexpr int RS = Tile<HD>::RS;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int e = tid; e < kRows * HD / 4; e += kThreads) {
    const int r = e / (HD / 4), d = 4 * (e % (HD / 4));
    float4 a = zero, c = zero;
    if (r < nrows) {
      const size_t off =
          ((size_t)(b * S + p0 + r / rep) * H + g * rep + r % rep) * HD + d;
      a = __ldg(reinterpret_cast<const float4*>(q + off));
      c = __ldg(reinterpret_cast<const float4*>(dout + off));
    }
    *reinterpret_cast<float4*>(&Qs[r * RS + d]) = a;
    *reinterpret_cast<float4*>(&dOs[r * RS + d]) = c;
  }
  if (tid < kRows) {
    float l = 0.f, dd = 0.f;
    if (tid < nrows) {
      const size_t i =
          ((size_t)(b * KV + g) * rep + tid % rep) * S + p0 + tid / rep;
      l = lse[i];
      dd = dcap[i];
    }
    lse_s[tid] = l;
    d_s[tid] = dd;
  }
}

// Keys k0 .. k0 + 31 of k and v into Ks / Vs ([32][RS], zeros past S).
template <int HD>
__device__ __forceinline__ void load_key_tile(const float* __restrict__ k,
                                              const float* __restrict__ v,
                                              float* Ks, float* Vs,
                                              size_t kv_base, int KV, int S,
                                              int k0, int tid) {
  constexpr int RS = Tile<HD>::RS;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int e = tid; e < kKT * HD / 4; e += kThreads) {
    const int kk = e / (HD / 4), d = 4 * (e % (HD / 4));
    float4 a = zero, c = zero;
    if (k0 + kk < S) {
      const size_t off = (kv_base + (size_t)(k0 + kk) * KV) * HD + d;
      a = __ldg(reinterpret_cast<const float4*>(k + off));
      c = __ldg(reinterpret_cast<const float4*>(v + off));
    }
    *reinterpret_cast<float4*>(&Ks[kk * RS + d]) = a;
    *reinterpret_cast<float4*>(&Vs[kk * RS + d]) = c;
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  return kp < S && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks<HD>)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dcap, float* __restrict__ dq,
                    int S, int H, int KV, int rep, int positions, int causal,
                    int window, float scale) {
  using T = Tile<HD>;
  constexpr int RS = T::RS, TS = T::TS;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kRows][RS]
  float* dOs = Qs + kRows * RS;                  // [kRows][RS]
  float* Ks = dOs + kRows * RS;                  // [kKT][RS]
  float* Vs = Ks + kKT * RS;                     // [kKT][RS]
  float* dSt = Vs + kKT * RS;                    // [kKT][TS]  ds^T
  float* lse_s = dSt + kKT * TS;                 // [kRows]
  float* d_s = lse_s + kRows;                    // [kRows]

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * positions;  // heavy first
  const int b = blockIdx.y / KV;
  const int g = blockIdx.y % KV;
  const int n_pos = min(positions, S - q0);
  const int nrows = n_pos * rep;
  load_query_tile<HD>(q, dout, lse, dcap, Qs, dOs, lse_s, d_s, b, g, q0,
                      nrows, S, H, KV, rep, tid);

  const int tr = tid / 16, tc = tid % 16;           // s / dp layout
  const int rg = tid / T::NCG, cg = tid % T::NCG;   // dq layout
  float acc[T::RM][T::CM];
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int j = 0; j < T::CM; ++j) acc[i][j] = 0.f;

  const int q_last = q0 + n_pos - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;
  const size_t kv_base = (size_t)b * S * KV + g;   // row (b, 0, g)
  for (int t = k_lo / kKT; t <= k_hi / kKT; ++t) {
    const int k0 = t * kKT;
    __syncthreads();   // the previous tile's K, V and ds^T are consumed
    load_key_tile<HD>(k, v, Ks, Vs, kv_base, KV, S, k0, tid);
    __syncthreads();

    float s[4][2], dp[4][2];
    row_key_products<HD>(Qs, Ks, tr, tc, s);
    row_key_products<HD>(dOs, Vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int qp = q0 + r / rep;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = tc + 16 * j;
        const bool ok = r < nrows && visible(qp, k0 + key, S, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSt[key * TS + r] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();

    // dq += ds K
#pragma unroll 4
    for (int kk = 0; kk < kKT; ++kk) {
      float a[T::RM], kb[T::CM];
      load_row<T::RM>(&dSt[kk * TS + rg * T::RM], a);
      load_cols<HD>(&Ks[kk * RS], cg, kb);
#pragma unroll
      for (int i = 0; i < T::RM; ++i)
#pragma unroll
        for (int j = 0; j < T::CM; ++j) acc[i][j] = fmaf(a[i], kb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < T::RM; ++i) {
    const int r = rg * T::RM + i;
    if (r >= nrows) continue;
    float* row =
        dq + ((size_t)(b * S + q0 + r / rep) * H + g * rep + r % rep) * HD;
#pragma unroll
    for (int j = 0; j < T::CM; j += 4)
      *reinterpret_cast<float4*>(&row[(j / 4) * T::NCG * 4 + cg * 4]) =
          make_float4(acc[i][j] * scale, acc[i][j + 1] * scale,
                      acc[i][j + 2] * scale, acc[i][j + 3] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks<HD>)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dcap, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, int KV, int rep,
                     int positions, int causal, int window, float scale) {
  using T = Tile<HD>;
  constexpr int RS = T::RS, PS = T::PS;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kRows][RS]
  float* dOs = Qs + kRows * RS;                  // [kRows][RS]
  float* Ks = dOs + kRows * RS;                  // [kKT][RS]
  float* Vs = Ks + kKT * RS;                     // [kKT][RS]
  float* Ps = Vs + kKT * RS;                     // [kRows][PS]  p
  float* dSs = Ps + kRows * PS;                  // [kRows][PS]  ds
  float* lse_s = dSs + kRows * PS;               // [kRows]
  float* d_s = lse_s + kRows;                    // [kRows]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kKT;   // the first key tiles see the most rows
  const int b = blockIdx.y / KV;
  const int g = blockIdx.y % KV;
  const size_t kv_base = (size_t)b * S * KV + g;
  load_key_tile<HD>(k, v, Ks, Vs, kv_base, KV, S, k0, tid);

  const int tr = tid / 16, tc = tid % 16;           // s / dp layout
  const int rg = tid / T::NCG, cg = tid % T::NCG;   // dk / dv layout
  float acc_k[T::KM][T::CM], acc_v[T::KM][T::CM];
#pragma unroll
  for (int i = 0; i < T::KM; ++i)
#pragma unroll
    for (int j = 0; j < T::CM; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // positions that can see keys k0 .. k0 + kKT - 1
  const int p_lo = causal ? k0 : 0;
  const int p_hi = window > 0 ? min(S - 1, k0 + kKT - 1 + window - 1) : S - 1;
  for (int t = p_lo / positions; t <= p_hi / positions; ++t) {
    const int q0 = t * positions;
    const int nrows = min(positions, S - q0) * rep;
    __syncthreads();   // the previous tile's Q, dO, p and ds are consumed
    load_query_tile<HD>(q, dout, lse, dcap, Qs, dOs, lse_s, d_s, b, g, q0,
                        nrows, S, H, KV, rep, tid);
    __syncthreads();

    float s[4][2], dp[4][2];
    row_key_products<HD>(Qs, Ks, tr, tc, s);
    row_key_products<HD>(dOs, Vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int qp = q0 + r / rep;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = tc + 16 * j;
        const bool ok = r < nrows && visible(qp, k0 + key, S, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        Ps[r * PS + key] = p;
        dSs[r * PS + key] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();

    // dv += p^T dO, dk += ds^T Q over the tile's rows (rows past nrows
    // hold zeros; the bound is the same for the whole block)
#pragma unroll 2
    for (int r = 0; r < nrows; ++r) {
      float pk[T::KM], sk[T::KM], o[T::CM], qq[T::CM];
      load_row<T::KM>(&Ps[r * PS + rg * T::KM], pk);
      load_row<T::KM>(&dSs[r * PS + rg * T::KM], sk);
      load_cols<HD>(&dOs[r * RS], cg, o);
      load_cols<HD>(&Qs[r * RS], cg, qq);
#pragma unroll
      for (int i = 0; i < T::KM; ++i)
#pragma unroll
        for (int j = 0; j < T::CM; ++j) {
          acc_v[i][j] = fmaf(pk[i], o[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(sk[i], qq[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < T::KM; ++i) {
    const int kp = k0 + rg * T::KM + i;
    if (kp >= S) continue;
    const size_t off = (kv_base + (size_t)kp * KV) * HD;
#pragma unroll
    for (int j = 0; j < T::CM; j += 4) {
      const int c = (j / 4) * T::NCG * 4 + cg * 4;
      *reinterpret_cast<float4*>(&dk[off + c]) =
          make_float4(acc_k[i][j] * scale, acc_k[i][j + 1] * scale,
                      acc_k[i][j + 2] * scale, acc_k[i][j + 3] * scale);
      *reinterpret_cast<float4*>(&dv[off + c]) = make_float4(
          acc_v[i][j], acc_v[i][j + 1], acc_v[i][j + 2], acc_v[i][j + 3]);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

template <int HD>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* dcap,
              float* dq, int B, int S, int H, int KV, int causal, int window,
              float scale, cudaStream_t stream) {
  const int rep = H / KV;
  const int positions = kRows / rep;
  const size_t smem = Tile<HD>::DQ_FLOATS * sizeof(float);
  static bool attr_set = false;
  if (const int err = set_smem(flash_bwd_dq_kernel<HD>, smem, attr_set))
    return err;
  dim3 grid((S + positions - 1) / positions, B * KV);
  flash_bwd_dq_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dcap, dq, S, H, KV, rep, positions, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* dcap,
               float* dk, float* dv, int B, int S, int H, int KV, int causal,
               int window, float scale, cudaStream_t stream) {
  const int rep = H / KV;
  const int positions = kRows / rep;
  const size_t smem = Tile<HD>::DKV_FLOATS * sizeof(float);
  static bool attr_set = false;
  if (const int err = set_smem(flash_bwd_dkv_kernel<HD>, smem, attr_set))
    return err;
  dim3 grid((S + kKT - 1) / kKT, B * KV);
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dcap, dk, dv, S, H, KV, rep, positions, causal,
      window, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KV) {
  return B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > kRows;
}

}  // namespace

extern "C" {

// q, do, dq [B, S, H, hd]; k, v [B, S, KV, hd]; lse, D [B, KV, H / KV, S];
// on the device, f32, contiguous.  hd in {64, 128, 256}, 1 <= H / KV <= 64,
// window <= 0 for none.  Returns cudaGetLastError().
int flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                     const float* dout, const float* lse, const float* dcap,
                     float* dq, int B, int S, int H, int KV, int hd,
                     int causal, int window, float scale, void* stream) {
  if (bad_shape(B, S, H, KV)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, dcap, dq, B, S, H, KV, causal,
                           window, scale, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, dcap, dq, B, S, H, KV,
                            causal, window, scale, st);
    case 256:
      return launch_dq<256>(q, k, v, dout, lse, dcap, dq, B, S, H, KV,
                            causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same inputs -> dk, dv [B, S, KV, hd].
int flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* dcap,
                      float* dk, float* dv, int B, int S, int H, int KV,
                      int hd, int causal, int window, float scale,
                      void* stream) {
  if (bad_shape(B, S, H, KV)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, dcap, dk, dv, B, S, H, KV,
                            causal, window, scale, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, dcap, dk, dv, B, S, H, KV,
                             causal, window, scale, st);
    case 256:
      return launch_dkv<256>(q, k, v, dout, lse, dcap, dk, dv, B, S, H, KV,
                             causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
