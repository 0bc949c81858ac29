// The wire codecs' elementwise kernels, f32, for sm_90a:
//
//   K3 quant_pack    q = clip(floor(x / scale + u), -qmax, qmax)
//                    int8: one int8 code per element (qmax = 127);
//                    int4: code + 8 as a nibble, two per byte, element 2j
//                    in the low nibble and 2j + 1 in the high one (qmax 7);
//                    for up to 64 leaves of a message in two launches, the
//                    scales included: scale = max(max|x|, 1e-12) / qmax,
//                    qmax the capacity's or, with a level ladder, the
//                    ladder's qmax at a level the kernel reads on the device
//   K4 quant_unpack  codes -> f32 code * scale (nibble split for int4), for
//                    up to 64 leaves of a message in one launch (one leaf
//                    is a message of one)
//   K5 topk_select   out = |x| >= t ? x : 0
//
// Replace the TPU kernels src/repro/kernels/compress_pack.py:quant_pack
// (_quant_pack_kernel), quant_unpack (_quant_unpack_kernel) and
// topk_select (_topk_select_kernel).  The Pallas kernels view the flat
// tensor as [rows, 128] lanes padded to 8-row tiles; here K3 and K4 walk
// the flat [n] tensor with a grid-stride loop, K5 with one block a tile,
// and each masks the tail itself, so nothing is padded or sliced around
// the call.
//
// What bounds them on the card: one pass, no reuse, a handful of
// operations per element.  Bytes bound all three: K3 reads x and u and
// writes the codes (9 bytes an element for int8, 8.5 for int4), K4 reads
// the codes and writes f32 (5 and 4.5), K5 reads and writes f32 (8).  The
// design moves each byte once with 16-byte loads where the pointers allow
// (four elements a thread for int8, eight for int4) and keeps no
// intermediate in device memory.  scale and t are read from device memory
// by every thread, so the host never waits for them.  At a CNN leaf's size
// the device work is a few microseconds, less than the host's cost of a
// launch, so K4 decodes a whole message (every leaf of a client's update)
// in one launch: the wrapper is paid once per message, not once per leaf.
// K3 encodes a whole message in two launches from the same kind of leaf
// table: quant_amax_multi_kernel takes each leaf's max|x| (an integer
// atomicMax on the bits of |x|, exact and independent of order; the last
// block of a leaf, by an integer ticket, turns it into the scale), then
// quant_pack_multi_kernel packs every leaf with its scale.  The second pass
// reads x again, from L2 at a message's size (6.7 MB for CNN_MNIST).
//
// The adaptive compression controllers (repro_torch.control) pick a level
// of the quant ladder on the device, between replays of one captured
// graph, so the level never reaches the host.  The JAX codec computes the
// scale outside the Pallas kernel as max|x| / qmax_table[level]
// (src/repro/compress/quant.py:_encode_leaf_level); here the leaf table
// carries the ladder's qmax values and a device pointer to the level, and
// the leaf's last block of the first launch reads the level when it writes
// the scale, so a level costs no device op beside the two launches (a null
// pointer keeps the capacity's qmax).  The pack kernel still clips at the
// capacity's +-127 / +-7, as the Pallas kernel does: a code at a lower
// level's qmax already fits.
//
// K5 moves 8n + 4 bytes and does three operations an element, so bytes
// bound it: 3.83 us at CNN_MNIST's 1,605,632-element FC leaf, 67.6 us at
// smollm-135m's 28,311,552-element token embedding.  At the leaf a call
// is a few memory round trips plus the launch and the drain of the
// stores, so what costs is anything that adds a round trip: a grid capped
// below what the tensor needs (a second, ragged pass for half the
// threads), a thread with one load in flight at a time.  So each block
// owns one tile of kTopkThreads x kTopkUnroll float4 groups and each
// thread issues all its loads before its first store; the grid is one
// block a tile (784 at the leaf: one wave on 132 SMs, no second pass),
// with no grid-stride loop at any size (past one wave the hardware
// schedules the tiles, faster than a capped grid striding over them);
// indices are 32-bit where they fit; the threshold is read once a thread,
// beside the loads.  Both sizes then run at the speed of PyTorch's own
// elementwise kernel (hardshrink), about 85% and 89% of the bound.
//
// Bit-exactness with the plain PyTorch version and the JAX oracle: x /
// scale is an IEEE round-to-nearest division (__fdiv_rn, never a multiply
// by the reciprocal), u is added after it with __fadd_rn, then floorf and
// the clamp; each output byte is written by one thread.  K5 selects, as
// jnp.where does, and never multiplies by a 0/1 mask: NaN gives 0, -0.0
// stays -0.0 where |x| >= t, and ties at t are kept.  Build without
// --use_fast_math and without -prec-div=false.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // 8 blocks per SM of an H100

__device__ __forceinline__ float quantize(float x, float u, float s,
                                          float qmax) {
  const float q = floorf(__fadd_rn(__fdiv_rn(x, s), u));
  return fminf(fmaxf(q, -qmax), qmax);
}

__device__ __forceinline__ uint32_t nibble(float x, float u, float s) {
  return (uint32_t)(int)(quantize(x, u, s, 7.f) + 8.f);
}

// ---------------------------------------------------------------- K3 -----

__global__ void quant_pack_i8_kernel(const float* __restrict__ x,
                                     const float* __restrict__ u,
                                     const float* __restrict__ scale,
                                     int8_t* __restrict__ out, long long n,
                                     int vec) {
  const float s = *scale;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long groups = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* u4 = reinterpret_cast<const float4*>(u);
    char4* o4 = reinterpret_cast<char4*>(out);
    for (long long g = tid; g < groups; g += stride) {
      const float4 a = x4[g], b = u4[g];
      char4 c;
      c.x = (signed char)(int)quantize(a.x, b.x, s, 127.f);
      c.y = (signed char)(int)quantize(a.y, b.y, s, 127.f);
      c.z = (signed char)(int)quantize(a.z, b.z, s, 127.f);
      c.w = (signed char)(int)quantize(a.w, b.w, s, 127.f);
      o4[g] = c;
    }
    done = groups * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = (int8_t)(int)quantize(x[i], u[i], s, 127.f);
}

// n is even; thread-owned output bytes j hold elements 2j (low), 2j+1 (high)
__global__ void quant_pack_i4_kernel(const float* __restrict__ x,
                                     const float* __restrict__ u,
                                     const float* __restrict__ scale,
                                     uint8_t* __restrict__ out, long long n,
                                     int vec) {
  const float s = *scale;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long m = n / 2;
  long long done = 0;
  if (vec) {
    // eight elements -> four output bytes per thread and step
    const long long groups = n / 8;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* u4 = reinterpret_cast<const float4*>(u);
    uint32_t* o4 = reinterpret_cast<uint32_t*>(out);
    for (long long g = tid; g < groups; g += stride) {
      const float4 a0 = x4[2 * g], a1 = x4[2 * g + 1];
      const float4 b0 = u4[2 * g], b1 = u4[2 * g + 1];
      const uint32_t w =
          (nibble(a0.x, b0.x, s) | nibble(a0.y, b0.y, s) << 4) |
          (nibble(a0.z, b0.z, s) | nibble(a0.w, b0.w, s) << 4) << 8 |
          (nibble(a1.x, b1.x, s) | nibble(a1.y, b1.y, s) << 4) << 16 |
          (nibble(a1.z, b1.z, s) | nibble(a1.w, b1.w, s) << 4) << 24;
      o4[g] = w;   // little-endian: byte 0 holds elements 0 and 1
    }
    done = groups * 4;
  }
  for (long long j = done + tid; j < m; j += stride)
    out[j] = (uint8_t)(nibble(x[2 * j], u[2 * j], s) |
                       nibble(x[2 * j + 1], u[2 * j + 1], s) << 4);
}

// K3 over a whole message: each leaf's scale from its own x, then the
// codes.  The leaf table travels by value, as K4's does; leaf l owns blocks
// [block_start[l], block_start[l+1]) in both launches.  u may be null (the
// deterministic u = 0.5).  An odd int4 leaf's last byte packs element n as
// x = 0 with u[n] (its offsets have n + 1 entries), so nothing is padded.
constexpr int kMaxLeaves = 64;
constexpr int kMaxLadder = 8;        // levels of a quant ladder

struct PackLeaves {
  const float* x[kMaxLeaves];
  const float* u[kMaxLeaves];
  void* out[kMaxLeaves];
  float* scale[kMaxLeaves];
  long long n[kMaxLeaves];
  int block_start[kMaxLeaves + 1];
  unsigned char vec[kMaxLeaves];     // 16-byte aligned x and u, 4-byte out
  int count;
  int int4;
  unsigned* amax;                    // [kMaxLeaves] bits of max|x|, zero
  int* tickets;                      // [kMaxLeaves], zero
  const int* level;                  // device int32 ladder level, or null
  float ladder_qmax[kMaxLadder];     // qmax at each level of the ladder
  int n_levels;
};

// the leaf whose block range holds blk, and this thread's place in it
__device__ __forceinline__ int leaf_of(const int* block_start, int count,
                                       int blk) {
  int lo = 0, hi = count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (block_start[mid] <= blk) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void quant_amax_multi_kernel(const __grid_constant__ PackLeaves t) {
  const int lo = leaf_of(t.block_start, t.count, blockIdx.x);
  const int nb = t.block_start[lo + 1] - t.block_start[lo];
  const long long tid =
      (long long)(blockIdx.x - t.block_start[lo]) * blockDim.x + threadIdx.x;
  const long long stride = (long long)nb * blockDim.x;
  const float* x = t.x[lo];
  const long long n = t.n[lo];
  // |x| >= 0, so its bits order as unsigned ints (a NaN above every number)
  unsigned m = 0u;
  long long done = 0;
  if (t.vec[lo]) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long g = tid; g < n / 4; g += stride) {
      const float4 a = x4[g];
      m = max(m, max(max(__float_as_uint(fabsf(a.x)), __float_as_uint(fabsf(a.y))),
                     max(__float_as_uint(fabsf(a.z)), __float_as_uint(fabsf(a.w)))));
    }
    done = n / 4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    m = max(m, __float_as_uint(fabsf(x[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned warp_m[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_m[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_m[w]);
  atomicMax(&t.amax[lo], m);
  __threadfence();
  if (atomicAdd(&t.tickets[lo], 1) != nb - 1) return;
  // the leaf's last block: take the max (leaving 0 for the next message)
  // and write the scale, max(max|x|, 1e-12) / qmax as one IEEE division
  const float a = __uint_as_float(atomicExch(&t.amax[lo], 0u));
  t.tickets[lo] = 0;
  float qmax = t.int4 ? 7.f : 127.f;
  if (t.level) qmax = t.ladder_qmax[min(max(*t.level, 0), t.n_levels - 1)];
  *t.scale[lo] = __fdiv_rn(a != a ? a : fmaxf(a, 1e-12f), qmax);
}

__global__ void quant_pack_multi_kernel(const __grid_constant__ PackLeaves t) {
  const int lo = leaf_of(t.block_start, t.count, blockIdx.x);
  const long long tid =
      (long long)(blockIdx.x - t.block_start[lo]) * blockDim.x + threadIdx.x;
  const long long stride =
      (long long)(t.block_start[lo + 1] - t.block_start[lo]) * blockDim.x;
  const float* __restrict__ x = t.x[lo];
  const float* __restrict__ u = t.u[lo];
  const long long n = t.n[lo];
  const float s = *t.scale[lo];
  long long done = 0;                  // elements handled by the vector loop
  if (!t.int4) {
    int8_t* __restrict__ out = static_cast<int8_t*>(t.out[lo]);
    if (t.vec[lo]) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      const float4* u4 = reinterpret_cast<const float4*>(u);
      char4* o4 = reinterpret_cast<char4*>(out);
      for (long long g = tid; g < n / 4; g += stride) {
        const float4 a = x4[g];
        const float4 b = u ? u4[g] : make_float4(0.5f, 0.5f, 0.5f, 0.5f);
        char4 c;
        c.x = (signed char)(int)quantize(a.x, b.x, s, 127.f);
        c.y = (signed char)(int)quantize(a.y, b.y, s, 127.f);
        c.z = (signed char)(int)quantize(a.z, b.z, s, 127.f);
        c.w = (signed char)(int)quantize(a.w, b.w, s, 127.f);
        o4[g] = c;
      }
      done = n / 4 * 4;
    }
    for (long long i = done + tid; i < n; i += stride)
      out[i] = (int8_t)(int)quantize(x[i], u ? u[i] : 0.5f, s, 127.f);
    return;
  }
  uint8_t* __restrict__ out = static_cast<uint8_t*>(t.out[lo]);
  if (t.vec[lo]) {
    // eight elements -> four output bytes per thread and step
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* u4 = reinterpret_cast<const float4*>(u);
    uint32_t* o4 = reinterpret_cast<uint32_t*>(out);
    const float4 half = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
    for (long long g = tid; g < n / 8; g += stride) {
      const float4 a0 = x4[2 * g], a1 = x4[2 * g + 1];
      const float4 b0 = u ? u4[2 * g] : half, b1 = u ? u4[2 * g + 1] : half;
      o4[g] = (nibble(a0.x, b0.x, s) | nibble(a0.y, b0.y, s) << 4) |
              (nibble(a0.z, b0.z, s) | nibble(a0.w, b0.w, s) << 4) << 8 |
              (nibble(a1.x, b1.x, s) | nibble(a1.y, b1.y, s) << 4) << 16 |
              (nibble(a1.z, b1.z, s) | nibble(a1.w, b1.w, s) << 4) << 24;
    }
    done = n / 8 * 8;
  }
  for (long long j = done / 2 + tid; j < (n + 1) / 2; j += stride) {
    const long long e = 2 * j + 1;     // == n: the odd leaf's x = 0
    out[j] = (uint8_t)(nibble(x[2 * j], u ? u[2 * j] : 0.5f, s) |
                       nibble(e < n ? x[e] : 0.f, u ? u[e] : 0.5f, s) << 4);
  }
}

// ---------------------------------------------------------------- K4 -----

// One leaf's codes -> f32, walked by the threads tid, tid + stride, ...
// of the leaf's share of the grid
__device__ __forceinline__ void unpack_i8(const int8_t* __restrict__ q,
                                          float s, float* __restrict__ out,
                                          long long n, int vec,
                                          long long tid, long long stride) {
  long long done = 0;
  if (vec) {
    const long long groups = n / 4;
    const char4* q4 = reinterpret_cast<const char4*>(q);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long g = tid; g < groups; g += stride) {
      const char4 c = q4[g];
      o4[g] = make_float4(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s),
                          __fmul_rn((float)c.z, s), __fmul_rn((float)c.w, s));
    }
    done = groups * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = __fmul_rn((float)q[i], s);
}

// out has n elements, n <= 2 * (bytes of q); byte j feeds 2j and 2j + 1
__device__ __forceinline__ void unpack_i4(const uint8_t* __restrict__ q,
                                          float s, float* __restrict__ out,
                                          long long n, int vec,
                                          long long tid, long long stride) {
  long long done = 0;   // bytes handled by the vector loop
  if (vec) {
    // four bytes -> eight floats per thread and step
    const long long groups = n / 8;
    const uint32_t* q4 = reinterpret_cast<const uint32_t*>(q);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long g = tid; g < groups; g += stride) {
      const uint32_t w = q4[g];
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = __fmul_rn((float)((int)((w >> (4 * k)) & 0xFu) - 8), s);
      o4[2 * g] = make_float4(v[0], v[1], v[2], v[3]);
      o4[2 * g + 1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    done = groups * 4;
  }
  const long long m = (n + 1) / 2;
  for (long long j = done + tid; j < m; j += stride) {
    const uint32_t b = q[j];
    out[2 * j] = __fmul_rn((float)((int)(b & 0xFu) - 8), s);
    if (2 * j + 1 < n)
      out[2 * j + 1] = __fmul_rn((float)((int)(b >> 4) - 8), s);
  }
}

// K4 over many leaves in one launch.  The leaf table travels by value as
// the kernel's parameter (as PyTorch's multi_tensor_apply passes its
// tensor lists), so the launch needs no device copy of it and can be
// captured in a CUDA graph; 64 leaves take 2,376 bytes of the 4 KB
// parameter space.  Leaf l owns blocks [block_start[l], block_start[l+1])
// and walks its elements with those blocks alone, as a grid-stride loop
// over that range.

struct UnpackLeaves {
  const void* q[kMaxLeaves];
  const float* scale[kMaxLeaves];
  float* out[kMaxLeaves];
  long long n[kMaxLeaves];
  int block_start[kMaxLeaves + 1];
  unsigned char flags[kMaxLeaves];   // bit 0: int4 codes; bit 1: vec
  int count;
};

__global__ void quant_unpack_multi_kernel(
    const __grid_constant__ UnpackLeaves t) {
  const int blk = blockIdx.x;
  const int lo = leaf_of(t.block_start, t.count, blk);
  const long long nb = t.block_start[lo + 1] - t.block_start[lo];
  const long long tid =
      (long long)(blk - t.block_start[lo]) * blockDim.x + threadIdx.x;
  const long long stride = nb * blockDim.x;
  const float s = *t.scale[lo];
  const int vec = (t.flags[lo] >> 1) & 1;
  if (t.flags[lo] & 1)
    unpack_i4(static_cast<const uint8_t*>(t.q[lo]), s, t.out[lo], t.n[lo],
              vec, tid, stride);
  else
    unpack_i8(static_cast<const int8_t*>(t.q[lo]), s, t.out[lo], t.n[lo],
              vec, tid, stride);
}

// ---------------------------------------------------------------- K5 -----

// K5's schedule, each choice timed alone (kernel_ab.py, PERF.md): threads
// a block and float4 groups a thread, all loaded before any store.
// Evict-first cache hints, a grid capped at one wave that strides over
// the tiles, and the threshold loaded after the data were timed too and
// left out: none was faster at the FC leaf, and the hints and the cap were
// slower past the L2.
constexpr int kTopkThreads = 256;
constexpr int kTopkUnroll = 2;
constexpr long long kTopkTile = (long long)kTopkThreads * kTopkUnroll;

__device__ __forceinline__ float keep(float x, float t) {
  return fabsf(x) >= t ? x : 0.f;
}

__device__ __forceinline__ float4 keep(float4 a, float t) {
  return make_float4(keep(a.x, t), keep(a.y, t), keep(a.z, t), keep(a.w, t));
}

// V is float4 (16-byte aligned x and out: `groups` float4s, then `tail`
// < 4 floats that block 0 takes) or float (any alignment, no tail); I the
// index type (int when every index fits).  Block b owns the tile of groups
// [b * kTopkTile, (b + 1) * kTopkTile): its thread i loads groups i,
// i + kTopkThreads, ... (each of the kTopkUnroll loads coalesced across
// the block), all before its first store.
template <typename V, typename I>
__global__ void __launch_bounds__(kTopkThreads)
topk_select_kernel(const V* __restrict__ x, const float* __restrict__ thresh,
                   V* __restrict__ out, I groups, int tail) {
  const float t = *thresh;
  const I g0 = (I)blockIdx.x * (I)kTopkTile + (I)threadIdx.x;
  V a[kTopkUnroll] = {};
#pragma unroll
  for (int k = 0; k < kTopkUnroll; ++k)
    if (g0 + k * kTopkThreads < groups) a[k] = x[g0 + k * kTopkThreads];
#pragma unroll
  for (int k = 0; k < kTopkUnroll; ++k)
    if (g0 + k * kTopkThreads < groups)
      out[g0 + k * kTopkThreads] = keep(a[k], t);
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) {
    const float* xt = reinterpret_cast<const float*>(x + groups);
    float* ot = reinterpret_cast<float*>(out + groups);
    ot[threadIdx.x] = keep(xt[threadIdx.x], t);
  }
}

// one block a tile of K5's groups (n / 4 float4s when vec, else n floats)
long long topk_blocks(long long n, int vec) {
  const long long groups = vec ? n / 4 : n;
  const long long b = (groups + kTopkTile - 1) / kTopkTile;
  return b < 1 ? 1 : b;
}

template <typename I>
void topk_launch(const float* x, const float* thresh, float* out,
                 long long n, int vec, cudaStream_t s) {
  const int blocks = (int)topk_blocks(n, vec);
  if (vec)
    topk_select_kernel<float4, I><<<blocks, kTopkThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), thresh,
        reinterpret_cast<float4*>(out), (I)(n / 4), (int)(n % 4));
  else
    topk_select_kernel<float, I><<<blocks, kTopkThreads, 0, s>>>(
        x, thresh, out, (I)n, 0);
}

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// K3's and K4's grid for one leaf: one thread per 4 (int8) or 8 (int4)
// elements on the vector path, one per element (int8) or byte (int4)
// otherwise
int leaf_blocks(long long n, int bits, int vec) {
  if (bits == 8) return blocks_for(vec ? n / 4 + 3 : n);
  return blocks_for(vec ? n / 8 + 4 : (n + 1) / 2);
}

}  // namespace

extern "C" {

// x, u [n] f32, scale [1] f32, all on the device.  bits 8: out int8 [n];
// bits 4: n even, out uint8 [n / 2].  vec != 0 promises 16-byte aligned x
// and u and a 4-byte aligned out.  Returns cudaGetLastError().
int quant_pack_f32(const float* x, const float* u, const float* scale,
                   void* out, long long n, int bits, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || (bits != 8 && bits != 4) || (bits == 4 && n % 2))
    return (int)cudaErrorInvalidValue;
  if (bits == 8)
    quant_pack_i8_kernel<<<blocks_for(vec ? n / 4 + 3 : n), kThreads, 0,
                           s>>>(x, u, scale, static_cast<int8_t*>(out), n,
                                vec);
  else
    quant_pack_i4_kernel<<<blocks_for(vec ? n / 8 + 3 : n / 2), kThreads, 0,
                           s>>>(x, u, scale, static_cast<uint8_t*>(out), n,
                                vec);
  return (int)cudaGetLastError();
}

// K3 over count <= 64 leaves of a message in two launches (the scales, then
// the codes).  leaves holds six int64 per leaf: x's address (f32 [n]), u's
// (f32 [n], or [n + 1] for an odd int4 leaf; 0: u = 0.5), the codes'
// (int8 [n] at bits 8, uint8 [ceil(n / 2)] at bits 4), the scale's ([1]
// f32, written here), n, and vec (non-zero promises 16-byte aligned x and u
// and 4-byte aligned codes).  slots: 2 * 64 ints on the device, zero before
// the first call (each call leaves them zero).  leaves lies in host memory.
// level: null (the capacity's qmax) or a device int32, the level of a
// ladder of n_levels <= 8 whose qmax values ladder_qmax (host memory, each
// in (0, capacity]) lists; the kernel reads the level, clamped to the
// ladder.  Returns cudaGetLastError().
int quant_pack_multi_f32(const long long* leaves, int count, int bits,
                         int* slots, const int* level,
                         const float* ladder_qmax, int n_levels,
                         void* stream) {
  if (count < 1 || count > kMaxLeaves || (bits != 8 && bits != 4) || !slots)
    return (int)cudaErrorInvalidValue;
  PackLeaves t;
  t.level = level;
  t.n_levels = 0;
  if (level) {
    if (!ladder_qmax || n_levels < 1 || n_levels > kMaxLadder)
      return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n_levels; ++i) {
      const float q = ladder_qmax[i];
      if (!(q > 0.f && q <= (bits == 8 ? 127.f : 7.f)))
        return (int)cudaErrorInvalidValue;
      t.ladder_qmax[i] = q;
    }
    t.n_levels = n_levels;
  }
  int blocks = 0;
  for (int l = 0; l < count; ++l) {
    const long long* e = leaves + 6 * l;
    const long long n = e[4];
    const int vec = e[5] != 0;
    if (n < 1) return (int)cudaErrorInvalidValue;
    t.x[l] = reinterpret_cast<const float*>(e[0]);
    t.u[l] = reinterpret_cast<const float*>(e[1]);
    t.out[l] = reinterpret_cast<void*>(e[2]);
    t.scale[l] = reinterpret_cast<float*>(e[3]);
    t.n[l] = n;
    t.vec[l] = (unsigned char)vec;
    t.block_start[l] = blocks;
    blocks += leaf_blocks(n, bits, vec);
  }
  t.block_start[count] = blocks;
  t.count = count;
  t.int4 = bits == 4;
  t.amax = reinterpret_cast<unsigned*>(slots);
  t.tickets = slots + kMaxLeaves;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  quant_amax_multi_kernel<<<blocks, kThreads, 0, s>>>(t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quant_pack_multi_kernel<<<blocks, kThreads, 0, s>>>(t);
  return (int)cudaGetLastError();
}

// K4 over count <= 64 leaves in one launch.  leaves holds six int64 per
// leaf: the codes' address, the scale's address ([1] f32), the output's
// address (f32 [n]), n, bits (8: int8 [n]; 4: uint8 [(n + 1) / 2] or more)
// and vec (non-zero promises 4-byte aligned codes and a 16-byte aligned
// output).  leaves lies in host memory; the device addresses in it do not.
// Returns cudaGetLastError().
int quant_unpack_multi_f32(const long long* leaves, int count,
                           void* stream) {
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  UnpackLeaves t;
  int blocks = 0;
  for (int l = 0; l < count; ++l) {
    const long long* e = leaves + 6 * l;
    const long long n = e[3];
    const int bits = (int)e[4], vec = e[5] != 0;
    if (n < 1 || (bits != 8 && bits != 4)) return (int)cudaErrorInvalidValue;
    t.q[l] = reinterpret_cast<const void*>(e[0]);
    t.scale[l] = reinterpret_cast<const float*>(e[1]);
    t.out[l] = reinterpret_cast<float*>(e[2]);
    t.n[l] = n;
    t.flags[l] = (unsigned char)((bits == 4) | (vec << 1));
    t.block_start[l] = blocks;
    blocks += leaf_blocks(n, bits, vec);
  }
  t.block_start[count] = blocks;
  t.count = count;
  quant_unpack_multi_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}

// x, out [n] f32, thresh [1] f32, on the device.  vec != 0 promises
// 16-byte aligned x and out.  Returns cudaGetLastError().
int topk_select_f32(const float* x, const float* thresh, float* out,
                    long long n, int vec, void* stream) {
  if (n < 1 || n > (1LL << 38)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 32-bit indices where they fit (an index stays below n + two tiles)
  if (n < (1LL << 31) - 2 * kTopkTile)
    topk_launch<int>(x, thresh, out, n, vec, s);
  else
    topk_launch<long long>(x, thresh, out, n, vec, s);
  return (int)cudaGetLastError();
}

// K5's schedule for n elements on the current device, as topk_select_f32
// launches it: sched[0] threads a block, [1] groups a thread (float4s when
// vec, else floats), [2] blocks, [3] blocks of one full wave (SMs times
// the blocks an SM holds at once).  Returns cudaGetLastError().
int topk_select_schedule(long long n, int vec, int* sched) {
  if (n < 1 || n > (1LL << 38)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, topk_select_kernel<float4, int>, kTopkThreads, 0);
  sched[0] = kTopkThreads;
  sched[1] = kTopkUnroll;
  sched[2] = (int)topk_blocks(n, vec);
  sched[3] = sms * per_sm;
  return (int)cudaGetLastError();
}

}  // extern "C"
