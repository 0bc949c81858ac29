// GQA flash attention forward, f32, for sm_90a:
//
//   o[b, p, g*rep + j, :] = softmax_k(scale * q[b, p, g*rep + j, :] . k[b, k, g, :]
//                                     masked) @ v[b, :, g, :]
//   lse[b, g, j, p]       = m + log(l)   (the row's log-sum-exp)
//
// q [B, S, H, hd], k / v [B, S, KV, hd], o like q, lse [B, KV, rep, S], with
// H = KV * rep, all contiguous.  A key k is visible from query p when
// k < S, k <= p (causal) and p - k < window (window > 0).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py:flash_fwd
// (_fwd_kernel).  The Pallas grid (B, KV, q blocks, kv blocks) carries the
// online-softmax state (m, l, acc) across its sequential innermost axis in
// VMEM scratch; here one block owns (b, kv head g, a tile of query
// positions) and walks the K / V tiles in a loop of its own, with the state
// in registers.  The tile's rows are (position, head) pairs: all rep query
// heads of the group are taken together, so each K / V tile is read from
// device memory once per group (the GQA saving of the Pallas block
// (1, qb, 1, rep, hd)).  64 rows a block (64 / rep positions), 32 keys a
// tile, 256 threads.
//
//   scores   S[64 x 32] = Q K^T: each thread a 4-row x 2-key register tile,
//            Q (transposed) and K (transposed) staged in shared memory;
//   softmax  masks by position arithmetic (causal, window, the ragged edge
//            k < S) with the finite -1e30 JAX uses; row max and sum over
//            the 16 lanes that share a row, by xor shuffles (every lane
//            gets the same value, so the state stays consistent);
//   P V      acc[64 x hd] += P[64 x 32] V[32 x hd]: each thread a register
//            tile of RM rows x CM columns, rescaled by the row's correction.
//
// Tiles wholly above the diagonal or wholly outside the window are never
// visited (the Pallas kernel visits and masks all of them): causal work is
// halved and a local layer costs O(S * window).  Blocks of the last query
// tiles, which have the most keys, are scheduled first.  Products are FFMA
// in f32 (no TF32), exp is expf: the numbers follow the f32 reference up to
// summation order.
//
// What bounds it on the card: 4 * B * H * hd FLOP per visible (query, key)
// pair against 67 TFLOP/s f32, ~6-9 GFLOP a gemma3-1b layer at B = 4,
// S = 1024, and ~42 MB of q, k, v, o (12 us at 3.35 TB/s): operations.
// This first version runs on the FMA units from shared memory, one block
// of 256 threads per SM at hd = 256 (148 KB of shared memory); the next
// K / V tile's float4 loads are issued into registers before the current
// tile's products, so device-memory latency hides behind them.  Tensor
// cores (wgmma on TF32 or bf16) and TMA are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;          // (position, head) rows per block
constexpr int kKT = 32;            // keys per tile
constexpr int kThreads = 256;
constexpr int kQS = kRows + 4;     // row stride of Q^T and P^T in shared
constexpr int kKS = kKT + 4;       // row stride of K^T in shared
constexpr float kNegInf = -1e30f;

template <int HD>
struct Tile {
  // P V register tile: NCG column groups of CM columns, NRG row groups of RM
  static constexpr int NCG = HD / 4 < 32 ? HD / 4 : 32;
  static constexpr int CM = HD / NCG;
  static constexpr int NRG = kThreads / NCG;
  static constexpr int RM = kRows / NRG;
  static constexpr int SMEM_FLOATS =
      HD * kQS + HD * kKS + kKT * HD + kKT * kQS + kRows;
};

// One K / V tile in registers: each thread's share as float4s, the loads
// of a whole tile in flight together.  V is read row by row (float4 e of
// the tile is row e / (HD/4)), so its stores into Vs[kk][d] are
// contiguous.  K is stored transposed, Ks[d][kk]: a warp takes 16 rows x
// 2 neighbouring float4s (whole 32-byte sectors), so that each of its four
// scalar stores lands on 32 distinct banks (kKS = 36: bank 16 d4 + 4 c + kk).
template <int HD>
struct KVRegs {
  static constexpr int N = kKT * HD / 4 / kThreads;
  float4 k[N], v[N];

  __device__ static void k_slot(int e, int& kk, int& d) {
    const int lane = e % 32, w = e / 32;
    kk = lane % 16 + 16 * (w % 2);
    d = 4 * (2 * (w / 2) + lane / 16);
  }

  __device__ static void v_slot(int e, int& kk, int& d) {
    kk = e / (HD / 4);
    d = 4 * (e % (HD / 4));
  }

  __device__ void load(const float* __restrict__ kg,
                       const float* __restrict__ vg, size_t kv_base, int KV,
                       int S, int k0, int tid) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * kThreads;          // float4 of the tile
      int kk, d;
      k_slot(e, kk, d);
      k[i] = k0 + kk < S ? __ldg(reinterpret_cast<const float4*>(
                               kg + (kv_base + (size_t)(k0 + kk) * KV) * HD
                               + d))
                         : zero;
      v_slot(e, kk, d);
      v[i] = k0 + kk < S ? __ldg(reinterpret_cast<const float4*>(
                               vg + (kv_base + (size_t)(k0 + kk) * KV) * HD
                               + d))
                         : zero;
    }
  }

  __device__ void store(float* Ks, float* Vs, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * kThreads;
      int kk, d;
      k_slot(e, kk, d);
      Ks[(d + 0) * kKS + kk] = k[i].x;
      Ks[(d + 1) * kKS + kk] = k[i].y;
      Ks[(d + 2) * kKS + kk] = k[i].z;
      Ks[(d + 3) * kKS + kk] = k[i].w;
      v_slot(e, kk, d);
      *reinterpret_cast<float4*>(&Vs[kk * HD + d]) = v[i];
    }
  }
};

// Blocks per SM the register budget must allow: shared memory admits one
// at hd = 256 (148 KB), two at 128 (79 KB), five at 64 (44 KB).
template <int HD>
constexpr int kMinBlocks = HD == 256 ? 1 : HD == 128 ? 2 : 3;

template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks<HD>)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KV, int rep,
                 int positions, int causal, int window, float scale) {
  using T = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [HD][kQS]  Q^T
  float* Ks = Qs + HD * kQS;                     // [HD][kKS]  K^T
  float* Vs = Ks + HD * kKS;                     // [kKT][HD]
  float* Ps = Vs + kKT * HD;                     // [kKT][kQS] P^T
  float* rowc = Ps + kKT * kQS;                  // [kRows]

  const int tid = threadIdx.x;
  const int n_qt = gridDim.x;
  const int q0 = (n_qt - 1 - blockIdx.x) * positions;  // heavy tiles first
  const int b = blockIdx.y / KV;
  const int g = blockIdx.y % KV;
  const int n_pos = min(positions, S - q0);
  const int nrows = n_pos * rep;

  // Q tile, transposed: row r is position q0 + r / rep, head g*rep + r % rep
  // (a warp takes 16 rows x 2 neighbouring float4s, as for K)
#pragma unroll 4
  for (int e = tid; e < kRows * HD / 4; e += kThreads) {
    const int lane = e % 32, w = e / 32;
    const int r = lane % 16 + 16 * (w % 4), d = 4 * (2 * (w / 4) + lane / 16);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows)
      val = __ldg(reinterpret_cast<const float4*>(
          q + ((size_t)(b * S + q0 + r / rep) * H + g * rep + r % rep) * HD
          + d));
    Qs[(d + 0) * kQS + r] = val.x;
    Qs[(d + 1) * kQS + r] = val.y;
    Qs[(d + 2) * kQS + r] = val.z;
    Qs[(d + 3) * kQS + r] = val.w;
  }

  // scores / softmax layout: 16 row groups x 16 key groups
  const int tr = tid / 16, tc = tid % 16;
  // P V layout
  const int rg = tid / T::NCG, cg = tid % T::NCG;

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = kNegInf; l[i] = 0.f; }
  float acc[T::RM][T::CM];
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int j = 0; j < T::CM; ++j) acc[i][j] = 0.f;

  const int q_last = q0 + n_pos - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;
  const size_t kv_base = (size_t)b * S * KV + g;   // row (b, 0, g)

  // the next K / V tile is loaded into registers while this one computes
  KVRegs<HD> next;
  const int t_lo = k_lo / kKT, t_hi = k_hi / kKT;
  next.load(k, v, kv_base, KV, S, t_lo * kKT, tid);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kKT;
    __syncthreads();   // the previous tile's K, V and P are consumed
    next.store(Ks, Vs, tid);
    __syncthreads();
    if (t < t_hi) next.load(k, v, kv_base, KV, S, k0 + kKT, tid);

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[d * kQS + tr * 4]);
      const float2 kb = *reinterpret_cast<const float2*>(&Ks[d * kKS + tc * 2]);
      s[0][0] = fmaf(qa.x, kb.x, s[0][0]); s[0][1] = fmaf(qa.x, kb.y, s[0][1]);
      s[1][0] = fmaf(qa.y, kb.x, s[1][0]); s[1][1] = fmaf(qa.y, kb.y, s[1][1]);
      s[2][0] = fmaf(qa.z, kb.x, s[2][0]); s[2][1] = fmaf(qa.z, kb.y, s[2][1]);
      s[3][0] = fmaf(qa.w, kb.x, s[3][0]); s[3][1] = fmaf(qa.w, kb.y, s[3][1]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int qp = q0 + r / rep;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tc * 2 + j;
        ok[j] = r < nrows && kp < S && (!causal || kp <= qp) &&
                (window <= 0 || qp - kp < window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(tc * 2 + j) * kQS + r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
      if (tc == 0) rowc[r] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < T::RM; ++i) {
      const float c = rowc[rg * T::RM + i];
#pragma unroll
      for (int j = 0; j < T::CM; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < kKT; ++kk) {
      float pr[T::RM], vv[T::CM];
#pragma unroll
      for (int i = 0; i < T::RM; i += 4) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(&Ps[kk * kQS + rg * T::RM + i]);
        pr[i] = t4.x; pr[i + 1] = t4.y; pr[i + 2] = t4.z; pr[i + 3] = t4.w;
      }
#pragma unroll
      for (int j = 0; j < T::CM; j += 4) {
        const float4 t4 = *reinterpret_cast<const float4*>(
            &Vs[kk * HD + (j / 4) * T::NCG * 4 + cg * 4]);
        vv[j] = t4.x; vv[j + 1] = t4.y; vv[j + 2] = t4.z; vv[j + 3] = t4.w;
      }
#pragma unroll
      for (int i = 0; i < T::RM; ++i)
#pragma unroll
        for (int j = 0; j < T::CM; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

  __syncthreads();
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const float lc = fmaxf(l[i], 1e-30f);
      rowc[r] = lc;
      if (r < nrows)
        lse[((size_t)(b * KV + g) * rep + r % rep) * S + q0 + r / rep] =
            m[i] + logf(lc);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::RM; ++i) {
    const int r = rg * T::RM + i;
    if (r >= nrows) continue;
    const float lc = rowc[r];
    float* orow =
        o + ((size_t)(b * S + q0 + r / rep) * H + g * rep + r % rep) * HD;
#pragma unroll
    for (int j = 0; j < T::CM; j += 4) {
      float4 out;
      out.x = acc[i][j] / lc;
      out.y = acc[i][j + 1] / lc;
      out.z = acc[i][j + 2] / lc;
      out.w = acc[i][j + 3] / lc;
      *reinterpret_cast<float4*>(&orow[(j / 4) * T::NCG * 4 + cg * 4]) = out;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int S, int H, int KV, int causal, int window,
           float scale, cudaStream_t stream) {
  const int rep = H / KV;
  const int positions = kRows / rep;
  const size_t smem = Tile<HD>::SMEM_FLOATS * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((S + positions - 1) / positions, B * KV);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, S, H, KV, rep, positions, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, S, H, hd], k / v [B, S, KV, hd], o [B, S, H, hd] and lse
// [B, KV, H / KV, S] on the device, f32, contiguous.  hd in {64, 128, 256},
// 1 <= H / KV <= 64, window <= 0 for none.  Returns cudaGetLastError().
int flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                  float* lse, int B, int S, int H, int KV, int hd, int causal,
                  int window, float scale, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > kRows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, st);
    case 256:
      return launch<256>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
