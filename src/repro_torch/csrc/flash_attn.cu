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
// (1, qb, 1, rep, hd)).  64 rows a block (64 / rep positions), KT keys a
// tile (FwdTile below), 256 threads.
//
//   scores   S[64 x KT] = Q K^T: each thread a 4-row x KT/16-key register
//            tile (rows tr * 4 + i, keys tc + 16 j), float4 loads along hd
//            from Q and K kept row by row with a stride of hd + 4 floats
//            (a quarter warp's 8 keys land on 32 distinct banks);
//   softmax  masks by position arithmetic (causal, window, the ragged edge
//            k < S) with the finite -1e30 JAX uses, only on tiles that
//            cross the diagonal, the window's edge or S; row max and sum
//            over the 16 lanes that share a row, by xor shuffles (every
//            lane gets the same value, so the state stays consistent); p
//            goes to shared memory transposed, 4 rows a float4;
//   P V      acc[64 x hd] += P[64 x KT] V[KT x hd]: each thread a register
//            tile of RM rows x CM columns, rescaled by the row's correction.
//
// Tiles wholly above the diagonal or wholly outside the window are never
// visited (the Pallas kernel visits and masks all of them): causal work is
// halved and a local layer costs O(S * window).  Products are FFMA in f32
// (no TF32), exp is expf: the numbers follow the f32 reference up to
// summation order, and every sum is taken in a fixed order, so the results
// are bitwise repeatable.
//
// What bounds it on the card: 4 * B * H * hd FLOP per visible (query, key)
// pair against 67 TFLOP/s f32, ~6-9 GFLOP a gemma3-1b layer at B = 4,
// S = 1024, and ~42 MB of q, k, v, o (12 us at 3.35 TB/s): operations.
// On the FMA units the shared-memory pipe is the nearer limit: counting one
// wavefront per quarter warp of a 128-bit load, a 4 x 2 score tile takes
// 24 wavefronts per 32 FFMA instructions a warp, 3:1 against the FMA pipe.
// Four changes against that and the dispatch (each timed alone, PERF.md):
// (1) dispatch order -- a 1-D grid, query tile slowest from the heaviest
// (the last, under a causal mask) and the (b, g) group fastest, so every
// group's longest tiles start in the first wave (a grid with the tile
// fastest starts two of gemma3-1b's four groups' longest tiles only in the
// second wave); (2) K / V arrive by cp.async in place, K during the
// tile's P V and V during the next tile's scores, one buffer each (a
// second one does not fit beside 64-key tiles at hd 256); (3) wider tiles
// -- 64 keys at hd 64 and 256 (a 4 x 4 score tile, 16 wavefronts per 32
// FFMAs; at hd 128 they would leave one block an SM), the P V tile 8 x 8
// at hd 256 and 8 x 4 at hd 128, and at hd 64, where 64 x 64 outputs
// give 256 threads only 4 x 4 each, two groups of 128 threads that take
// half the keys each with 8 x 4 tiles and add at the end (two blocks an
// SM: the register budget of three spills); (4) per-element masks only on
// the tiles that need them.  Tensor cores (wgmma on TF32 or bf16) and TMA
// are later work.
//
// Head dims 80 and 120 (stablelm-3b, h2o-danube-3-4b).  The P V register
// tile spreads hd over float4 column groups that must divide the threads;
// 20 and 30 groups do not.  So these two dims pad the tile's width in
// shared memory only, to 96 and 128 (FwdTile::HP): hd 80 takes hd 64's
// split P V (two groups of 128 threads, 8 column groups of 12 columns, 4
// rows a thread, 64-key tiles), hd 120 hd 128's tiles.  Nothing is padded
// in device memory: cp.async copies the hd real columns of each row; the
// scores run over hd only; the padding columns of V feed only accumulators
// that are never stored (they may read stale shared memory, which no
// stored value depends on).  Cost: P V, half the operations, does 96 / 80
// = 1.2x and 128 / 120 = 1.07x of its FFMAs, +10% and +3% of the kernel's;
// the bound counts the real hd.  Rows are 320 and 480 bytes: whole 32-byte
// sectors, so no sector holds two rows' bytes; where 64 bytes are fetched
// at once, a 480-byte row at an odd offset of 32 touches 8 such pieces for
// 7.5 (6.7% more, and the other half is the neighbouring head's row).  The
// row stride HP + 4 (100, 132 floats; both 4 mod 32) keeps a quarter warp's
// 8 neighbouring rows on 32 distinct banks, as 68 and 260 do.  At hd 80
// the score loop is not unrolled (FwdTile::SU): unrolled twice, beside the
// 48-float P V tile, it spilled 80 bytes (and ran 1% faster, PERF.md).
// ptxas (nvcc 12.9): 128 registers at hd 80, 125 at hd 120, no spills.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;          // (position, head) rows per block
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// K8a's tiles, one build per head dim: KT keys a tile; the P V step runs
// in KS groups of threads, group h taking keys h * KT / KS .. of each tile
// and adding its sums to group 0's at the end, each thread an RM x CM
// register tile (rows rg * RM + i, float4 column groups cg, cg + NCG,
// ...); blocks an SM as shared memory admits them, at most MAX_BLOCKS
// (the __launch_bounds__ asks the registers for the same).
template <int HD>
struct FwdTile {
  // the width the P V register tiles cover: hd where its float4 column
  // groups divide the threads, else the next width that does (80 -> 96,
  // 120 -> 128); columns hd .. HP - 1 are never stored
  static constexpr int HP = HD == 80 ? 96 : HD == 120 ? 128 : HD;
  static constexpr int KT = HP == 128 ? 32 : 64;
  static constexpr int KS = HP <= 96 ? 2 : 1;
  static constexpr int MAX_BLOCKS = 2;
  static constexpr int RS = HP + 4;             // row stride of Q, K, V
  static constexpr int PS = kRows + 4;          // row stride of P^T
  static constexpr int KJ = KT / 16;
  // the score loop's unroll along hd: at hd 80 the 4 x 12 P V tile
  // leaves no registers for two steps in flight (80 bytes spilled)
  static constexpr int SU = HD == 80 ? 1 : 2;
  static constexpr int NCG = HP == 96 ? 8 : HP / 4 < 32 ? HP / 4 : 32;
  static constexpr int CM = HP / NCG;
  static constexpr int NRG = kThreads / KS / NCG;
  static constexpr int RM = kRows / NRG;
  static constexpr int FLOATS = kRows * RS + 2 * KT * RS + KT * PS + kRows;
  static constexpr int FIT = 232448 / (FLOATS * 4 + 1024);
  static constexpr int MIN_BLOCKS = FIT < MAX_BLOCKS ? FIT : MAX_BLOCKS;
  static_assert(KT % (16 * KS) == 0 && RM % 4 == 0 && CM % 4 == 0 &&
                    NCG * NRG * KS == kThreads && MIN_BLOCKS >= 1,
                "tile shape");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups (the newest) are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 64 rows of the query tile at positions q0 .. into Qs ([kRows][RS]),
// as 16-byte cp.async copies; rows past nrows are zero-filled.
template <int HD>
__device__ __forceinline__ void issue_query(const float* __restrict__ q,
                                            float* Qs, int b, int g, int q0,
                                            int nrows, int S, int H, int rep,
                                            int tid) {
  constexpr int RS = FwdTile<HD>::RS;
#pragma unroll 4
  for (int e = tid; e < kRows * HD / 4; e += kThreads) {
    const int r = e / (HD / 4), d = 4 * (e % (HD / 4));
    const bool ok = r < nrows;
    const size_t off = ok ? ((size_t)(b * S + q0 + r / rep) * H + g * rep +
                             r % rep) * HD + d
                          : 0;
    cp_async16(&Qs[r * RS + d], q + off, ok);
  }
}

// Keys k0 .. k0 + KT - 1 of x (k or v, [B, S, KV, hd]) into Xs ([KT][RS])
// as 16-byte cp.async copies; keys past S are zero-filled.
template <int HD, int KT>
__device__ __forceinline__ void issue_keys(const float* __restrict__ x,
                                           float* Xs, size_t kv_base, int KV,
                                           int S, int k0, int tid) {
  constexpr int RS = FwdTile<HD>::RS;
#pragma unroll 4
  for (int e = tid; e < KT * HD / 4; e += kThreads) {
    const int kk = e / (HD / 4), d = 4 * (e % (HD / 4));
    const bool ok = k0 + kk < S;
    const size_t off = ok ? (kv_base + (size_t)(k0 + kk) * KV) * HD + d : 0;
    cp_async16(&Xs[kk * RS + d], x + off, ok);
  }
}

// s[i][j] = q_r . k_c over hd for the thread's rows r = tr * 4 + i and keys
// c = tc + 16 j.  Within a quarter warp the 8 threads share tr (one Q
// address, broadcast) and read 8 neighbouring keys (32 distinct banks);
// the loop along hd unrolled SU times.
template <int HD, int KJ, int SU>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       int tr, int tc, float (&s)[4][KJ]) {
  constexpr int RS = FwdTile<HD>::RS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll (SU)
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&Qs[(tr * 4 + i) * RS + d]);
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(&Ks[(tc + 16 * j) * RS + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// The online-softmax step of one tile: masks (MASKED: per element), the
// running max and sum of the thread's 4 rows, p into Ps (P^T, 4 rows a
// float4) and each row's correction into rowc.
template <int KJ, bool MASKED>
__device__ __forceinline__ void softmax_step(
    float (&s)[4][KJ], float (&m)[4], float (&l)[4], float* Ps, float* rowc,
    int tr, int tc, int q0, int k0, int nrows, int rep, int S, int causal,
    int window, float scale) {
  constexpr int PS = kRows + 4;
  float p[4][KJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int qp = q0 + r / rep;
    bool ok[KJ];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int kp = k0 + tc + 16 * j;
      ok[j] = !MASKED ||
              (r < nrows && kp < S && (!causal || kp <= qp) &&
               (window <= 0 || qp - kp < window));
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
    for (int j = 0; j < KJ; ++j) {
      p[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
      sum += p[i][j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = l[i] * corr + sum;
    m[i] = m_new;
    if (tc == 0) rowc[r] = corr;
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    *reinterpret_cast<float4*>(&Ps[(tc + 16 * j) * PS + tr * 4]) =
        make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
}

// Block u: query tile rank u / n_groups (0 the heaviest), group
// u % n_groups; tile t = n_qt - 1 - rank.  K arrives during the last
// tile's P V, V during this tile's scores (in place, one buffer each).
template <int HD>
__global__ void __launch_bounds__(kThreads, FwdTile<HD>::MIN_BLOCKS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KV, int rep,
                 int positions, int causal, int window, float scale,
                 int n_qt, int n_groups) {
  using T = FwdTile<HD>;
  constexpr int KT = T::KT, RS = T::RS, PS = T::PS, KJ = T::KJ;
  constexpr int RM = T::RM, CM = T::CM, NCG = T::NCG, HP = T::HP;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kRows][RS]
  float* Ks = Qs + kRows * RS;                   // [KT][RS]
  float* Vs = Ks + KT * RS;                      // [KT][RS]
  float* Ps = Vs + KT * RS;                      // [KT][PS]  P^T
  float* rowc = Ps + KT * PS;                    // [kRows]

  const int tid = threadIdx.x;
  const int u = blockIdx.x;
  const int q0 = (n_qt - 1 - u / n_groups) * positions;
  const int bg = u % n_groups;
  const int b = bg / KV, g = bg % KV;
  const int n_pos = min(positions, S - q0);
  const int nrows = n_pos * rep;
  const int q_last = q0 + n_pos - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;
  const int t_lo = k_lo / KT, t_hi = k_hi / KT;
  const size_t kv_base = (size_t)b * S * KV + g;   // row (b, 0, g)

  issue_query<HD>(q, Qs, b, g, q0, nrows, S, H, rep, tid);
  issue_keys<HD, KT>(k, Ks, kv_base, KV, S, t_lo * KT, tid);
  cp_async_commit();               // the query tile and K, then V
  issue_keys<HD, KT>(v, Vs, kv_base, KV, S, t_lo * KT, tid);
  cp_async_commit();

  const int tr = tid / 16, tc = tid % 16;        // score / softmax layout
  constexpr int KS = T::KS, GT = kThreads / KS;
  const int h = tid / GT;                        // P V layout
  const int rg = tid % GT / NCG, cg = tid % NCG;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = kNegInf; l[i] = 0.f; }
  float acc[RM][CM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j) acc[i][j] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * KT;
    cp_async_wait<1>();            // K (the first time: the query tile too)
    __syncthreads();
    float s[4][KJ];
    scores<HD, KJ, T::SU>(Qs, Ks, tr, tc, s);
    const bool inside = k0 + KT <= S && (!causal || k0 + KT - 1 <= q0) &&
                        (window <= 0 || q_last - k0 < window);
    if (inside)
      softmax_step<KJ, false>(s, m, l, Ps, rowc, tr, tc, q0, k0, nrows, rep,
                              S, causal, window, scale);
    else
      softmax_step<KJ, true>(s, m, l, Ps, rowc, tr, tc, q0, k0, nrows, rep,
                             S, causal, window, scale);
    cp_async_wait<0>();            // V
    __syncthreads();               // P visible; K consumed: refill it
    if (t < t_hi) issue_keys<HD, KT>(k, Ks, kv_base, KV, S, k0 + KT, tid);
    cp_async_commit();

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float c = rowc[rg * RM + i];
#pragma unroll
      for (int j = 0; j < CM; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = h * (KT / KS); kk < (h + 1) * (KT / KS); ++kk) {
      float pr[RM], vv[CM];
#pragma unroll
      for (int i = 0; i < RM; i += 4) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(&Ps[kk * PS + rg * RM + i]);
        pr[i] = t4.x; pr[i + 1] = t4.y; pr[i + 2] = t4.z; pr[i + 3] = t4.w;
      }
#pragma unroll
      for (int j = 0; j < CM; j += 4) {
        const float4 t4 = *reinterpret_cast<const float4*>(
            &Vs[kk * RS + (j / 4) * NCG * 4 + cg * 4]);
        vv[j] = t4.x; vv[j + 1] = t4.y; vv[j + 2] = t4.z; vv[j + 3] = t4.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
    __syncthreads();               // V and P consumed: refill V
    if (t < t_hi) issue_keys<HD, KT>(v, Vs, kv_base, KV, S, k0 + KT, tid);
    cp_async_commit();
  }

  __syncthreads();
  if (KS > 1 && h == 1) {          // group 1's sums, through Q's buffer
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; j += 4)
        *reinterpret_cast<float4*>(
            &Qs[(rg * RM + i) * HP + (j / 4) * NCG * 4 + cg * 4]) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                        acc[i][j + 3]);
  }
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
  if (h > 0) return;
  if (KS > 1) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; j += 4) {
        const float4 t4 = *reinterpret_cast<const float4*>(
            &Qs[(rg * RM + i) * HP + (j / 4) * NCG * 4 + cg * 4]);
        acc[i][j] += t4.x; acc[i][j + 1] += t4.y;
        acc[i][j + 2] += t4.z; acc[i][j + 3] += t4.w;
      }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = rg * RM + i;
    if (r >= nrows) continue;
    const float lc = rowc[r];
    float* orow =
        o + ((size_t)(b * S + q0 + r / rep) * H + g * rep + r % rep) * HD;
#pragma unroll
    for (int j = 0; j < CM; j += 4) {
      const int col = (j / 4) * NCG * 4 + cg * 4;
      if (HP != HD && col >= HD) continue;       // a padding column
      float4 out;
      out.x = acc[i][j] / lc;
      out.y = acc[i][j + 1] / lc;
      out.z = acc[i][j + 2] / lc;
      out.w = acc[i][j + 3] / lc;
      *reinterpret_cast<float4*>(&orow[col]) = out;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int S, int H, int KV, int causal, int window,
           float scale, cudaStream_t stream) {
  const int rep = H / KV;
  const int positions = kRows / rep;
  const size_t smem = FwdTile<HD>::FLOATS * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int n_qt = (S + positions - 1) / positions;
  flash_fwd_kernel<HD><<<n_qt * B * KV, kThreads, smem, stream>>>(
      q, k, v, o, lse, S, H, KV, rep, positions, causal, window, scale, n_qt,
      B * KV);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, S, H, hd], k / v [B, S, KV, hd], o [B, S, H, hd] and lse
// [B, KV, H / KV, S] on the device, f32, contiguous.  hd in {64, 80, 120,
// 128, 256} (the head dims of the repository's configs; any other returns
// cudaErrorInvalidValue), 1 <= H / KV <= 64, window <= 0 for none.
// Returns cudaGetLastError().
int flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                  float* lse, int B, int S, int H, int KV, int hd, int causal,
                  int window, float scale, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > kRows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, st);
    case 80:
      return launch<80>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, st);
    case 120:
      return launch<120>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, st);
    case 256:
      return launch<256>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
