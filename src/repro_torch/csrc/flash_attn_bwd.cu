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
// dq, dk and dv need no float atomics.
//
//   K8b  one work unit per (b, g, query tile of 64 rows = 64 / rep
//        positions, segment): walks the key tiles (64 keys at hd 64, 32 at
//        hd 128 and 256) visible to those rows, cut into segments where
//        the plan says so.  Per tile: dp = dO V^T and s = Q K^T (each
//        thread 4 rows x 4 or 2 keys, float4 loads along hd), ds into
//        shared memory (transposed), then dq[64 x hd] += ds K.  Split
//        query tiles add their partials as K8c's key tiles do.
//   K8c  one work unit per (b, g, key tile, segment): a key tile (32 or
//        64 keys) is seen by the query tiles at positions k0 .. k0 + KT - 1
//        + window - 1 (causal from k0), and those tiles are cut into
//        segments of at most seg tiles; every key tile's first segment is
//        scheduled before any second one.  Per
//        tile: s, dp as in K8b, p and ds into shared memory, then
//        dv[KT x hd] += p^T dO and dk[KT x hd] += ds^T Q.  A key tile with
//        one segment writes dk / dv; with several, each unit writes partial
//        sums to a float32 scratch and the last unit of the key tile (an
//        integer ticket; no float atomics) adds them in segment order.
//        Keys that no query sees get zeros.
//
// Tiles wholly above the diagonal or outside the window are never visited
// (the Pallas kernels visit and mask all of them).  Q, dO, K and V tiles are
// kept row by row in shared memory with a stride of hd + 4 floats: a
// quarter warp's float4 loads of 8 neighbouring keys land on 32 distinct
// banks, and the same K tile serves s = Q K^T (along hd) and ds K (along
// keys), so no transposed copy is needed.  Products are FFMA in f32 (no
// TF32), exp is expf: the numbers follow the f32 reference up to summation
// order, and every sum is taken in a fixed order, so the results are
// bitwise repeatable.
//
// What bounds it on the card: per visible (query head, key) pair, K8b does
// three products of hd (s, dp, dq) and K8c four (s, dp, dv, dk), 2 * hd
// FLOP each, against 67 TFLOP/s f32: 0.22 ms (K8b) and 0.29 ms (K8c) at
// smollm-135m's B = 8, S = 1024; ~70 MB of q, do, dq, k, v, lse and D
// take 21 us at 3.35 TB/s: operations.  Shared memory at hd = 256 is the
// constraint: K8b holds 209 KB (Q, dO: 64 x 260 floats each; K, V: 32 x
// 260; ds^T), K8c 219 KB (the same, with p and ds 64 x 36 each), one block
// per SM.  K8b and K8c each attack three limits, each timed alone
// before it was kept (PERF.md).  K8b: (1) dispatch order --
// the units go segment, then query tile from the last (longest) to the
// first, then group, so every group's longest tiles start in the first
// wave (at gemma3-1b's global layer, 256 units at one an SM, a grid with
// the query tile fastest starts two groups' longest tiles only in the
// second wave; this order takes 0.60x of its time); the
// plan (kernels/flash_attn.py dq_plan) cuts query tiles into segments
// only where a list-scheduling model of the card's block slots says the
// last wave would be ragged (gemma3-1b's local layer, 0.88x; at the
// global layer and smollm-135m segments cost 5-13%); (2) synchronous
// K / V loads -- they arrive by cp.async in place, V during s and the dq
// pass, K during the next tile's dp (0.98x at hd 256; a wash at hd 64 /
// 128, where a two-stage ring costs a block an SM and is slower); (3)
// shared-memory traffic -- 64-key tiles at hd 64 (0.91x; at hd 128 they
// leave one block an SM and are slower).  K8c: (1) causal load imbalance
// -- a
// causal layer's first key tile sees every query tile, its last only one,
// and gemma3-1b's 128 key tiles fill one wave of 132 SMs, so the longest
// sets the time: segments split the long key tiles (0.63x at gemma3-1b's
// global layer, 0.83x at smollm-135m); (2) synchronous tile loads -- with
// prefetch the next tile's dO and D, then Q and lse, arrive by 16- and
// 4-byte cp.async into the padded rows while the current tile's dk pass
// and the next tile's dp run, in the same buffers (two 64-row buffers do
// not fit beside K and V at hd 256; 32-row double-buffered tiles were
// slower); it pays at hd 128 and 256, not at hd 64; (3) shared-memory
// traffic -- 64-key units at hd 64 and 128 give each thread 16 s / dp
// outputs instead of 8 and double the FFMAs each dO / Q value read from
// shared memory feeds.  At hd 256 the units keep 32 keys (64 do not fit):
// counting one shared-memory wavefront per quarter warp of a 128-bit load,
// the s / dp products take 24 wavefronts per 32 FFMAs a warp, so shared
// memory, not the FMA units, bounds them (a count, not a profile).  Tensor
// cores (wgmma on TF32 or bf16) and TMA are later work.  ptxas
// (-Xptxas=-v, nvcc 12.9): K8b 128 registers at hd 64 and 128, 168 at
// hd 256, no spills; K8c 128 at hd 64 (12 bytes spilled), 208 at hd 128,
// 168 at hd 256.
//
// Head dims 80 and 120 (stablelm-3b, h2o-danube-3-4b): the output tiles'
// float4 column groups must divide the threads, and 20 or 30 do not, so
// the tiles cover a width padded in shared memory only (Tile::HP): 96 at
// hd 80 (8 column groups of 12 columns: dq a 2 x 12 register tile a
// thread, dk and dv 2 x 12 each), 128 at hd 120 (hd 128's tiles).  Rows
// are copied with their hd real columns; s and dp run over hd only; the
// padding columns feed only accumulators that are never stored, nor
// written to the partial sums.  Cost: the dq pass (a third of K8b's
// products) and the dv and dk passes (half of K8c's) do 1.2x (hd 80) and
// 1.07x (hd 120) of their FFMAs: +7% / +10% and +2% / +3%; the bound
// counts the real hd.  Key tiles: K8b 32 at both (two blocks an SM), K8c
// 64 (one block an SM, as at hd 128).  The row strides 100 and 132 floats
// (4 mod 32) keep a quarter warp on 32 distinct banks; rows of 320 and 480
// bytes are whole 32-byte sectors (csrc/flash_attn.cu).  ptxas: K8b 128
// registers at hd 80 and 120, K8c 168 and 214, no spills.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;          // (position, head) rows per query tile
constexpr int kThreads = 256;

template <int HD>
struct Tile {
  // the width the output register tiles cover: hd where its float4 column
  // groups divide the threads, else the next width that does (80 -> 96,
  // 120 -> 128); columns hd .. HP - 1 are never stored
  static constexpr int HP = HD == 80 ? 96 : HD == 120 ? 128 : HD;
  static constexpr int RS = HP + 4;             // row stride of Q, dO, K, V
  // output register tiles: NCG groups of float4 columns, CM columns each
  static constexpr int NCG = HP == 96 ? 8 : HP / 4 < 32 ? HP / 4 : 32;
  static constexpr int CM = HP / NCG;
  static_assert(CM % 4 == 0 && kThreads % NCG == 0, "column groups");

  // a padding column group (col >= hd): never stored
  static __device__ __forceinline__ bool pad(int col) {
    return HP != HD && col >= HD;
  }
};

// acc[i][j] += a_i . b_j over hd for the thread's rows tr * RI + i of A and
// keys tc + 16 j of B (both [rows][RS] in shared memory): s = Q K^T or
// dp = dO V^T.  Within a quarter warp the 8 threads share tr (one A
// address, broadcast) and read 8 neighbouring keys (32 distinct banks).
template <int HD, int RI, int KJ>
__device__ __forceinline__ void row_key_products(const float* A,
                                                 const float* Bk, int tr,
                                                 int tc, float (&acc)[RI][KJ]) {
  constexpr int RS = Tile<HD>::RS;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[RI], b[KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(tr * RI + i) * RS + d]);
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(&Bk[(tc + 16 * j) * RS + d]);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
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

// Rows [0, QR) of the query tile at positions p0 .. of q and do into Qs /
// dOs ([QR][RS], zeros past nrows), and their lse and D into lse_s / d_s.
template <int HD, int QR = kRows>
__device__ __forceinline__ void load_query_tile(
    const float* __restrict__ q, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dcap,
    float* Qs, float* dOs, float* lse_s, float* d_s, int b, int g, int p0,
    int nrows, int S, int H, int KV, int rep, int tid) {
  constexpr int RS = Tile<HD>::RS;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int e = tid; e < QR * HD / 4; e += kThreads) {
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
  if (tid < QR) {
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

// Keys k0 .. k0 + KT - 1 of k and v into Ks / Vs ([KT][RS], zeros past
// S).
template <int HD, int KT>
__device__ __forceinline__ void load_key_tile(const float* __restrict__ k,
                                              const float* __restrict__ v,
                                              float* Ks, float* Vs,
                                              size_t kv_base, int KV, int S,
                                              int k0, int tid) {
  constexpr int RS = Tile<HD>::RS;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int e = tid; e < KT * HD / 4; e += kThreads) {
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

// Rows [0, QR) of the query tile at positions p0 .. of x (q or do, [B, S,
// H, hd]) into Xs ([QR][RS]) and their y (lse or D, [B, KV, rep, S]) into
// ys, as 16- and 4-byte cp.async copies; rows past nrows are zero-filled
// (source size 0).
template <int HD, int QR>
__device__ __forceinline__ void issue_rows(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           float* Xs, float* ys, int b,
                                           int g, int p0, int nrows, int S,
                                           int H, int KV, int rep, int tid) {
  constexpr int RS = Tile<HD>::RS;
#pragma unroll 4
  for (int e = tid; e < QR * HD / 4; e += kThreads) {
    const int r = e / (HD / 4), d = 4 * (e % (HD / 4));
    const bool ok = r < nrows;
    const size_t off = ok ? ((size_t)(b * S + p0 + r / rep) * H + g * rep +
                             r % rep) * HD + d
                          : 0;
    cp_async16(&Xs[r * RS + d], x + off, ok);
  }
  if (tid < QR) {
    const bool ok = tid < nrows;
    const size_t i =
        ok ? ((size_t)(b * KV + g) * rep + tid % rep) * S + p0 + tid / rep
           : 0;
    cp_async4(&ys[tid], y + i, ok);
  }
}

// Keys k0 .. k0 + KT - 1 of x (k or v, [B, S, KV, hd]) into Xs ([KT][RS])
// as 16-byte cp.async copies; keys past S are zero-filled.
template <int HD, int KT>
__device__ __forceinline__ void issue_keys(const float* __restrict__ x,
                                           float* Xs, size_t kv_base, int KV,
                                           int S, int k0, int tid) {
  constexpr int RS = Tile<HD>::RS;
#pragma unroll 4
  for (int e = tid; e < KT * HD / 4; e += kThreads) {
    const int kk = e / (HD / 4), d = 4 * (e % (HD / 4));
    const bool ok = k0 + kk < S;
    const size_t off = ok ? (kv_base + (size_t)(k0 + kk) * KV) * HD + d : 0;
    cp_async16(&Xs[kk * RS + d], x + off, ok);
  }
}

// ---------------------------------------------------------------- K8b ----
//
// K8b's tiles, one build per head dim: 64 query rows a unit, KT keys a
// tile (64 at hd 64; 32 at hd 128, where 64 would leave one block an SM,
// and at hd 256, where 64 do not fit).  Per tile, s and dp are 4 x KJ
// register tiles a thread (rows tr * 4 + i, keys tc + 16 j); dq is an RM x
// CM register tile a thread (rows rg * RM + i, float4 column groups cg,
// cg + NCG, ...).
template <int HD>
struct DqTile {
  static constexpr int KT = HD == 64 ? 64 : 32;
  static constexpr int QR = kRows;
  static constexpr int RS = Tile<HD>::RS;       // row stride of Q, dO, K, V
  static constexpr int TS = QR + 4;             // row stride of ds^T
  static constexpr int KJ = KT / 16;
  static constexpr int NCG = Tile<HD>::NCG;
  static constexpr int CM = Tile<HD>::CM;
  static constexpr int NRG = kThreads / NCG;
  static constexpr int RM = QR / NRG;
  static constexpr int FLOATS = 2 * QR * RS + 2 * KT * RS + KT * TS
                                + 2 * QR;        // Q, dO, K, V, ds^T, lse, D
  // two blocks a SM where shared memory admits them (232,448 bytes, 1 KB
  // of it reserved per block), else one
  static constexpr int MIN_BLOCKS = 2 * (FLOATS * 4 + 1024) <= 232448 ? 2 : 1;
  static_assert(KT % 16 == 0 && RM % 2 == 0, "tile shape");
};

// K8b work unit u: segment sg (slowest), then the query tile t from the
// last (the longest under a causal mask) to the first, then the (b, g)
// group (fastest), so every group's longest tiles are dispatched before
// any group's shorter ones.  Query tile t sees key tiles j_lo .. j_hi; its
// segment sg walks j_lo + sg * seg .. (at most seg of them), and units
// past the tile's ns segments exit at once.  With one segment the unit
// writes dq; with more, each writes its partial sum to part, and the last
// of them to finish (an integer ticket a query tile) adds the partials in
// segment order, so the result does not depend on which unit finishes
// last.  Key tiles arrive in place by cp.async: a tile runs dp = dO V^T,
// then s = Q K^T, then dq += ds K, so V's buffer is refilled during s and
// the dq pass and K's during the next tile's dp, one buffer each (a second
// one does not fit at hd 256).
template <int HD>
__global__ void __launch_bounds__(kThreads, DqTile<HD>::MIN_BLOCKS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dcap, float* __restrict__ dq,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int S, int H, int KV, int rep, int positions, int causal,
                    int window, float scale, int n_groups, int n_qtiles,
                    int seg, int max_ns) {
  using T = DqTile<HD>;
  constexpr int KT = T::KT, QR = T::QR, RS = T::RS, TS = T::TS, KJ = T::KJ;
  constexpr int RM = T::RM, CM = T::CM, NCG = T::NCG;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [QR][RS]
  float* dOs = Qs + QR * RS;                     // [QR][RS]
  float* Ks = dOs + QR * RS;                     // [KT][RS]
  float* Vs = Ks + KT * RS;                      // [KT][RS]
  float* dSt = Vs + KT * RS;                     // [KT][TS]  ds^T
  float* lse_s = dSt + KT * TS;                  // [QR]
  float* d_s = lse_s + QR;                       // [QR]
  __shared__ int last_unit;

  const int tid = threadIdx.x;
  const int per_seg = n_groups * n_qtiles;
  const int sg = blockIdx.x / per_seg;
  const int rest = blockIdx.x % per_seg;
  const int t = n_qtiles - 1 - rest / n_groups;  // heavy first
  const int bg = rest % n_groups;
  const int b = bg / KV, g = bg % KV;
  const int q0 = t * positions;
  const int n_pos = min(positions, S - q0);
  const int nrows = n_pos * rep;
  // key tiles visible from positions q0 .. q0 + n_pos - 1
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q0 + n_pos - 1 : S - 1;
  const int j_lo = k_lo / KT, j_hi = k_hi / KT;
  const int ns = (j_hi - j_lo + seg) / seg;
  if (sg >= ns) return;
  const int j_begin = j_lo + sg * seg;
  const int j_end = min(j_hi + 1, j_begin + seg);

  const size_t kv_base = (size_t)b * S * KV + g;   // row (b, 0, g)
  auto issue_kv = [&](const float* x, float* Xs, int j) {
    issue_keys<HD, KT>(x, Xs, kv_base, KV, S, j * KT, tid);
  };
  issue_rows<HD, QR>(dout, dcap, dOs, d_s, b, g, q0, nrows, S, H, KV, rep,
                     tid);
  issue_rows<HD, QR>(q, lse, Qs, lse_s, b, g, q0, nrows, S, H, KV, rep, tid);
  issue_kv(v, Vs, j_begin);     // two groups: the query tile and V, then K
  cp_async_commit();
  issue_kv(k, Ks, j_begin);
  cp_async_commit();

  const int tr = tid / 16, tc = tid % 16;        // s / dp layout
  const int rg = tid / NCG, cg = tid % NCG;      // dq layout
  float acc[RM][CM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CM; ++c) acc[i][c] = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * KT;
    float dp[4][KJ], s[4][KJ];
    cp_async_wait<1>();          // V (the first time: the query tile too)
    __syncthreads();
    row_key_products<HD, 4, KJ>(dOs, Vs, tr, tc, dp);
    cp_async_wait<0>();          // K
    __syncthreads();             // (and V consumed: refill it)
    if (j + 1 < j_end) issue_kv(v, Vs, j + 1);
    cp_async_commit();
    row_key_products<HD, 4, KJ>(Qs, Ks, tr, tc, s);
    // ds^T: the thread's 4 rows of key tc + 16 jj as one float4
#pragma unroll
    for (int jj = 0; jj < KJ; ++jj) {
      const int key = tc + 16 * jj;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        const bool ok = r < nrows &&
                        visible(q0 + r / rep, k0 + key, S, causal, window);
        const float p = ok ? expf(s[i][jj] * scale - lse_s[r]) : 0.f;
        ds[i] = p * (dp[i][jj] - d_s[r]);
      }
      *reinterpret_cast<float4*>(&dSt[key * TS + tr * 4]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dq += ds K
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float a[RM], kb[CM];
      load_row<RM>(&dSt[kk * TS + rg * RM], a);
      load_cols<HD>(&Ks[kk * RS], cg, kb);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CM; ++c) acc[i][c] = fmaf(a[i], kb[c], acc[i][c]);
    }
    __syncthreads();             // K and ds^T consumed: refill K
    if (j + 1 < j_end) issue_kv(k, Ks, j + 1);
    cp_async_commit();
  }

  if (ns > 1) {
    // this unit's partial sum, then the query tile's ticket
    const int tile = bg * n_qtiles + t;
    float* mine = part + ((size_t)tile * max_ns + sg) * (QR * HD);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CM; c += 4) {
        const int col = (c / 4) * NCG * 4 + cg * 4;
        if (Tile<HD>::pad(col)) continue;
        *reinterpret_cast<float4*>(&mine[(rg * RM + i) * HD + col]) =
            make_float4(acc[i][c], acc[i][c + 1], acc[i][c + 2],
                        acc[i][c + 3]);
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_unit = atomicAdd(&tickets[tile], 1) == ns - 1;
    __syncthreads();
    if (!last_unit) return;
    __threadfence();
    // the last unit: sum the ns partials in segment order (read through
    // L2: other SMs wrote them)
    const float* first = part + (size_t)tile * max_ns * (QR * HD);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CM; c += 4) {
        const int col = (c / 4) * NCG * 4 + cg * 4;
        if (Tile<HD>::pad(col)) continue;
        const int off = (rg * RM + i) * HD + col;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int p = 0; p < ns; ++p) {
          const float4 a = __ldcg(reinterpret_cast<const float4*>(
              &first[(size_t)p * (QR * HD) + off]));
          sum.x += a.x; sum.y += a.y; sum.z += a.z; sum.w += a.w;
        }
        acc[i][c] = sum.x; acc[i][c + 1] = sum.y;
        acc[i][c + 2] = sum.z; acc[i][c + 3] = sum.w;
      }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = rg * RM + i;
    if (r >= nrows) continue;
    float* row =
        dq + ((size_t)(b * S + q0 + r / rep) * H + g * rep + r % rep) * HD;
#pragma unroll
    for (int c = 0; c < CM; c += 4) {
      const int col = (c / 4) * NCG * 4 + cg * 4;
      if (Tile<HD>::pad(col)) continue;
      *reinterpret_cast<float4*>(&row[col]) =
          make_float4(acc[i][c] * scale, acc[i][c + 1] * scale,
                      acc[i][c + 2] * scale, acc[i][c + 3] * scale);
    }
  }
}

// ---------------------------------------------------------------- K8c ----
//
// K8c's tiles, one build per head dim: KT keys a unit (64 at hd 64 and
// 128; 32 at hd 256, where 64 do not fit), 64 query rows a tile, and how
// the next query tile's Q, dO, lse and D arrive (PF):
//   0  synchronously, after a barrier (hd 64, where prefetch costs 5%);
//   1  in place by cp.async (hd 128 and 256): the tile's dv pass (p, dO)
//      runs before its dk pass (ds, Q), so dO's buffer is refilled during
//      the dk pass and Q's during the next tile's dp = dO V^T: one buffer
//      each, no more shared memory than PF 0 (a second 64-row buffer does
//      not fit at hd 256).
// Per tile, s and dp are 4 x KJ register tiles a thread (rows tr * 4 + i,
// keys tc + 16 j); dk and dv are KM x CM register tiles a thread (keys
// rg * KM + i, float4 column groups cg, cg + NCG, ...).
template <int HD>
struct DkvTile {
  static constexpr int KT = HD == 256 ? 32 : 64;
  static constexpr int PF = HD == 64 ? 0 : 1;
  static constexpr int QR = kRows;
  static constexpr int RS = Tile<HD>::RS;       // row stride of Q, dO, K, V
  static constexpr int PS = KT + 4;             // row stride of p, ds
  static constexpr int RI = QR / 16;
  static constexpr int KJ = KT / 16;
  static constexpr int NCG = Tile<HD>::NCG;
  static constexpr int CM = Tile<HD>::CM;
  static constexpr int NRG = kThreads / NCG;
  static constexpr int KM = KT / NRG;
  static constexpr int FLOATS = 2 * KT * RS + 2 * QR * RS + 2 * QR
                                + 2 * QR * PS;   // K, V, Q, dO, lse, D, p, ds
  // two blocks a SM where shared memory admits them (232,448 bytes, 1 KB
  // of it reserved per block), else one
  static constexpr int MIN_BLOCKS = 2 * (FLOATS * 4 + 1024) <= 232448 ? 2 : 1;
  static_assert(KM >= 1 && KT % 16 == 0, "tile shape");
};

// K8c work unit u: segment sg (slowest), then the (b, g) group, then the
// key tile j (fastest), so every group's first segments come before any
// group's later ones.  Key tile j is seen by query tiles t_lo .. t_hi;
// its segment sg walks tiles t_lo + sg * seg .. (at most seg of them), and
// units past the tile's ns segments exit at once.  With one segment the
// unit writes dk / dv; with more, each writes its partial sums to part,
// and the last of them to finish (an integer ticket a key tile) adds the
// partials in segment order, so the result does not depend on which unit
// finishes last.
template <int HD>
__global__ void __launch_bounds__(kThreads, DkvTile<HD>::MIN_BLOCKS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dcap, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ part,
                     int* __restrict__ tickets, int S, int H, int KV,
                     int rep, int positions, int causal, int window,
                     float scale, int n_groups, int n_key_tiles, int seg,
                     int max_ns) {
  using T = DkvTile<HD>;
  constexpr int KT = T::KT, QR = T::QR, RS = T::RS, PS = T::PS;
  constexpr int RI = T::RI, KJ = T::KJ;
  constexpr bool PREFETCH = T::PF == 1;
  constexpr int KM = T::KM, CM = T::CM, NCG = T::NCG;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [KT][RS]
  float* Vs = Ks + KT * RS;                      // [KT][RS]
  float* Ps = Vs + KT * RS;                      // [QR][PS]  p
  float* dSs = Ps + QR * PS;                     // [QR][PS]  ds
  float* Qs = dSs + QR * PS;                     // [QR][RS]
  float* dOs = Qs + QR * RS;                     // [QR][RS]
  float* lse_s = dOs + QR * RS;                  // [QR]
  float* d_s = lse_s + QR;                       // [QR]
  __shared__ int last_unit;

  const int tid = threadIdx.x;
  const int per_seg = n_groups * n_key_tiles;
  const int sg = blockIdx.x / per_seg;
  const int tile = blockIdx.x % per_seg;         // (b, g) * n_key_tiles + j
  const int bg = tile / n_key_tiles, j = tile % n_key_tiles;
  const int b = bg / KV, g = bg % KV;
  const int k0 = j * KT;
  // positions that can see keys k0 .. k0 + KT - 1
  const int p_lo = causal ? k0 : 0;
  const int p_hi = window > 0 ? min(S - 1, k0 + KT - 1 + window - 1) : S - 1;
  const int t_lo = p_lo / positions, t_hi = p_hi / positions;
  const int ns = (t_hi - t_lo + seg) / seg;
  if (sg >= ns) return;
  const int t_begin = t_lo + sg * seg;
  const int t_end = min(t_hi + 1, t_begin + seg);

  const size_t kv_base = (size_t)b * S * KV + g;
  load_key_tile<HD, KT>(k, v, Ks, Vs, kv_base, KV, S, k0, tid);

  const int tr = tid / 16, tc = tid % 16;        // s / dp layout
  const int rg = tid / NCG, cg = tid % NCG;      // dk / dv layout
  float acc_k[KM][CM], acc_v[KM][CM];
#pragma unroll
  for (int i = 0; i < KM; ++i)
#pragma unroll
    for (int c = 0; c < CM; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  auto rows_of = [&](int t) { return min(positions, S - t * positions) * rep; };
  auto issue_dout = [&](int t) {
    issue_rows<HD, QR>(dout, dcap, dOs, d_s, b, g, t * positions, rows_of(t),
                       S, H, KV, rep, tid);
  };
  auto issue_q = [&](int t) {
    issue_rows<HD, QR>(q, lse, Qs, lse_s, b, g, t * positions, rows_of(t), S,
                       H, KV, rep, tid);
  };
  if constexpr (PREFETCH) {    // two groups: dO and D, then Q and lse
    issue_dout(t_begin);
    cp_async_commit();
    issue_q(t_begin);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = t * positions;
    const int nrows = rows_of(t);

    float s[RI][KJ], dp[RI][KJ];
    if constexpr (PREFETCH) {
      cp_async_wait<1>();    // dO and D of this tile have landed
      __syncthreads();       // (the first time: K and V too)
      row_key_products<HD, RI, KJ>(dOs, Vs, tr, tc, dp);
      cp_async_wait<0>();    // Q and lse
      __syncthreads();
      row_key_products<HD, RI, KJ>(Qs, Ks, tr, tc, s);
    } else {
      __syncthreads();   // the previous tile's Q, dO, p and ds are consumed
      load_query_tile<HD, QR>(q, dout, lse, dcap, Qs, dOs, lse_s, d_s, b, g,
                              q0, nrows, S, H, KV, rep, tid);
      __syncthreads();
      row_key_products<HD, RI, KJ>(Qs, Ks, tr, tc, s);
      row_key_products<HD, RI, KJ>(dOs, Vs, tr, tc, dp);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = tr * RI + i;
      const int qp = q0 + r / rep;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const int key = tc + 16 * jj;
        const bool ok = r < nrows && visible(qp, k0 + key, S, causal, window);
        const float p = ok ? expf(s[i][jj] * scale - lse_s[r]) : 0.f;
        Ps[r * PS + key] = p;
        dSs[r * PS + key] = p * (dp[i][jj] - d_s[r]);
      }
    }
    __syncthreads();

    // dv += p^T dO, dk += ds^T Q over the tile's rows (the bound is the
    // same for the whole block): acc[i][c] += w[r][key i] * x[r][col c]
    auto accumulate = [&](const float* W, const float* X,
                          float (&acc)[KM][CM]) {
#pragma unroll 2
      for (int r = 0; r < nrows; ++r) {
        float w[KM], x[CM];
        load_row<KM>(&W[r * PS + rg * KM], w);
#pragma unroll
        for (int c = 0; c < CM; c += 4) {
          const float4 a = *reinterpret_cast<const float4*>(
              &X[r * RS + (c / 4) * NCG * 4 + cg * 4]);
          x[c] = a.x; x[c + 1] = a.y; x[c + 2] = a.z; x[c + 3] = a.w;
        }
#pragma unroll
        for (int i = 0; i < KM; ++i)
#pragma unroll
          for (int c = 0; c < CM; ++c) acc[i][c] = fmaf(w[i], x[c], acc[i][c]);
      }
    };
    if constexpr (PREFETCH) {
      accumulate(Ps, dOs, acc_v);
      __syncthreads();       // dO and D consumed: refill them
      if (t + 1 < t_end) issue_dout(t + 1);
      cp_async_commit();
      accumulate(dSs, Qs, acc_k);
      __syncthreads();       // Q, lse, p and ds consumed
      if (t + 1 < t_end) issue_q(t + 1);
      cp_async_commit();
    } else {
#pragma unroll 2
      for (int r = 0; r < nrows; ++r) {
        float pk[KM], sk[KM], o[CM], qq[CM];
        load_row<KM>(&Ps[r * PS + rg * KM], pk);
        load_row<KM>(&dSs[r * PS + rg * KM], sk);
#pragma unroll
        for (int c = 0; c < CM; c += 4) {
          const int col = (c / 4) * NCG * 4 + cg * 4;
          const float4 a =
              *reinterpret_cast<const float4*>(&dOs[r * RS + col]);
          const float4 e = *reinterpret_cast<const float4*>(&Qs[r * RS + col]);
          o[c] = a.x; o[c + 1] = a.y; o[c + 2] = a.z; o[c + 3] = a.w;
          qq[c] = e.x; qq[c + 1] = e.y; qq[c + 2] = e.z; qq[c + 3] = e.w;
        }
#pragma unroll
        for (int i = 0; i < KM; ++i)
#pragma unroll
          for (int c = 0; c < CM; ++c) {
            acc_v[i][c] = fmaf(pk[i], o[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(sk[i], qq[c], acc_k[i][c]);
          }
      }
    }
  }

  if (ns > 1) {
    // this unit's partial sums, then the key tile's ticket
    float* mine = part + ((size_t)tile * max_ns + sg) * (2 * KT * HD);
#pragma unroll
    for (int i = 0; i < KM; ++i)
#pragma unroll
      for (int c = 0; c < CM; c += 4) {
        const int col = (c / 4) * NCG * 4 + cg * 4;
        if (Tile<HD>::pad(col)) continue;
        const int off = (rg * KM + i) * HD + col;
        *reinterpret_cast<float4*>(&mine[off]) = make_float4(
            acc_k[i][c], acc_k[i][c + 1], acc_k[i][c + 2], acc_k[i][c + 3]);
        *reinterpret_cast<float4*>(&mine[KT * HD + off]) = make_float4(
            acc_v[i][c], acc_v[i][c + 1], acc_v[i][c + 2], acc_v[i][c + 3]);
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_unit = atomicAdd(&tickets[tile], 1) == ns - 1;
    __syncthreads();
    if (!last_unit) return;
    __threadfence();
    // the last unit: sum the ns partials in segment order (read through
    // L2: other SMs wrote them)
    const float* first = part + (size_t)tile * max_ns * (2 * KT * HD);
#pragma unroll
    for (int i = 0; i < KM; ++i)
#pragma unroll
      for (int c = 0; c < CM; c += 4) {
        const int col = (c / 4) * NCG * 4 + cg * 4;
        if (Tile<HD>::pad(col)) continue;
        const int off = (rg * KM + i) * HD + col;
        float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
        for (int p = 0; p < ns; ++p) {
          const float* src = first + (size_t)p * (2 * KT * HD);
          const float4 a = __ldcg(reinterpret_cast<const float4*>(&src[off]));
          const float4 e =
              __ldcg(reinterpret_cast<const float4*>(&src[KT * HD + off]));
          sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
          sv.x += e.x; sv.y += e.y; sv.z += e.z; sv.w += e.w;
        }
        acc_k[i][c] = sk.x; acc_k[i][c + 1] = sk.y;
        acc_k[i][c + 2] = sk.z; acc_k[i][c + 3] = sk.w;
        acc_v[i][c] = sv.x; acc_v[i][c + 1] = sv.y;
        acc_v[i][c + 2] = sv.z; acc_v[i][c + 3] = sv.w;
      }
  }

#pragma unroll
  for (int i = 0; i < KM; ++i) {
    const int kp = k0 + rg * KM + i;
    if (kp >= S) continue;
    const size_t off = (kv_base + (size_t)kp * KV) * HD;
#pragma unroll
    for (int c = 0; c < CM; c += 4) {
      const int col = (c / 4) * NCG * 4 + cg * 4;
      if (Tile<HD>::pad(col)) continue;
      *reinterpret_cast<float4*>(&dk[off + col]) =
          make_float4(acc_k[i][c] * scale, acc_k[i][c + 1] * scale,
                      acc_k[i][c + 2] * scale, acc_k[i][c + 3] * scale);
      *reinterpret_cast<float4*>(&dv[off + col]) = make_float4(
          acc_v[i][c], acc_v[i][c + 1], acc_v[i][c + 2], acc_v[i][c + 3]);
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
              float* dq, float* part, int* tickets, int B, int S, int H,
              int KV, int causal, int window, float scale, int seg,
              int max_ns, cudaStream_t stream) {
  const int rep = H / KV;
  const int positions = kRows / rep;
  const int n_qtiles = (S + positions - 1) / positions;
  const size_t smem = DqTile<HD>::FLOATS * sizeof(float);
  static bool attr_set = false;
  if (const int err = set_smem(flash_bwd_dq_kernel<HD>, smem, attr_set))
    return err;
  if (max_ns > 1) {
    const cudaError_t err = cudaMemsetAsync(
        tickets, 0, sizeof(int) * (size_t)B * KV * n_qtiles, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const long long units = (long long)max_ns * B * KV * n_qtiles;
  flash_bwd_dq_kernel<HD><<<(unsigned)units, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dcap, dq, part, tickets, S, H, KV, rep, positions,
      causal, window, scale, B * KV, n_qtiles, seg, max_ns);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* dcap,
               float* dk, float* dv, float* part, int* tickets, int B,
               int S, int H, int KV, int causal, int window, float scale,
               int seg, int max_ns, cudaStream_t stream) {
  const int rep = H / KV;
  const int positions = kRows / rep;
  constexpr int KT = DkvTile<HD>::KT;
  const int n_key_tiles = (S + KT - 1) / KT;
  const size_t smem = DkvTile<HD>::FLOATS * sizeof(float);
  static bool attr_set = false;
  if (const int err =
          set_smem(flash_bwd_dkv_kernel<HD>, smem, attr_set))
    return err;
  if (max_ns > 1) {
    const cudaError_t err = cudaMemsetAsync(
        tickets, 0, sizeof(int) * (size_t)B * KV * n_key_tiles, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const long long units = (long long)max_ns * B * KV * n_key_tiles;
  flash_bwd_dkv_kernel<HD><<<(unsigned)units, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dcap, dk, dv, part, tickets, S, H, KV, rep,
      positions, causal, window, scale, B * KV, n_key_tiles, seg, max_ns);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KV) {
  return B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > kRows;
}

}  // namespace

extern "C" {

// q, do, dq [B, S, H, hd]; k, v [B, S, KV, hd]; lse, D [B, KV, H / KV, S];
// on the device, f32, contiguous.  hd in {64, 80, 120, 128, 256} (the head
// dims of the repository's configs; any other returns
// cudaErrorInvalidValue), 1 <= H / KV <= 64, window <= 0 for none.  K8b
// (64 keys a tile at hd 64, 32 at hd 80 to 256) splits each query tile's
// visible key tiles into segments of at most seg tiles.  When some query
// tile has more than one (max_ns > 1), part holds B * KV * ceil(S /
// positions) * max_ns * 64 * hd floats of scratch and tickets B * KV *
// ceil(S / positions) ints (zeroed here, on the stream), positions = 64 /
// (H / KV); else both may be null.  Returns cudaGetLastError().
int flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                     const float* dout, const float* lse, const float* dcap,
                     float* dq, float* part, int* tickets, int B, int S,
                     int H, int KV, int hd, int causal, int window,
                     float scale, int seg, int max_ns, void* stream) {
  if (bad_shape(B, S, H, KV) || seg < 1 || max_ns < 1 ||
      (max_ns > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, dcap, dq, part, tickets, B, S,
                           H, KV, causal, window, scale, seg, max_ns, st);
    case 80:
      return launch_dq<80>(q, k, v, dout, lse, dcap, dq, part, tickets, B, S,
                           H, KV, causal, window, scale, seg, max_ns, st);
    case 120:
      return launch_dq<120>(q, k, v, dout, lse, dcap, dq, part, tickets, B,
                            S, H, KV, causal, window, scale, seg, max_ns, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, dcap, dq, part, tickets, B,
                            S, H, KV, causal, window, scale, seg, max_ns, st);
    case 256:
      return launch_dq<256>(q, k, v, dout, lse, dcap, dq, part, tickets, B,
                            S, H, KV, causal, window, scale, seg, max_ns, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same inputs -> dk, dv [B, S, KV, hd], by K8c (64 keys a unit at hd
// 64 to 128, 32 at hd 256).  Each key tile's visible query tiles are split
// into segments of at most seg tiles.  When some key tile has more than
// one (max_ns > 1), part holds B * KV * ceil(S / keys) * max_ns * 2 *
// keys * hd floats of scratch and tickets B * KV * ceil(S / keys) ints
// (zeroed here, on the stream); else both may be null.  Returns
// cudaGetLastError().
int flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* dcap,
                      float* dk, float* dv, float* part, int* tickets, int B,
                      int S, int H, int KV, int hd, int causal, int window,
                      float scale, int seg, int max_ns, void* stream) {
  if (bad_shape(B, S, H, KV) || seg < 1 || max_ns < 1 ||
      (max_ns > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, dcap, dk, dv, part, tickets,
                            B, S, H, KV, causal, window, scale, seg, max_ns,
                            st);
    case 80:
      return launch_dkv<80>(q, k, v, dout, lse, dcap, dk, dv, part, tickets,
                            B, S, H, KV, causal, window, scale, seg, max_ns,
                            st);
    case 120:
      return launch_dkv<120>(q, k, v, dout, lse, dcap, dk, dv, part,
                             tickets, B, S, H, KV, causal, window, scale, seg,
                             max_ns, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, dcap, dk, dv, part,
                             tickets, B, S, H, KV, causal, window, scale, seg,
                             max_ns, st);
    case 256:
      return launch_dkv<256>(q, k, v, dout, lse, dcap, dk, dv, part,
                             tickets, B, S, H, KV, causal, window, scale, seg,
                             max_ns, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
