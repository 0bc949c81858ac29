// The error-feedback table's row movers, f32, for sm_90a:
//
//   K6 ef_gather   out[j, :] = table[idx[j], :]          j < k
//   K7 ef_scatter  table[idx[j], :] = rows[j, :]         in place
//
// Replace the TPU kernels src/repro/kernels/compress_pack.py:ef_gather
// (_ef_gather_kernel) and ef_scatter (_ef_scatter_kernel).  The Pallas
// kernels scalar-prefetch idx and run one grid step per sampled row, so
// each step is one row DMA; the scatter aliases the table input to its
// output and never copies the untouched rows.  Here the table is a
// flattened [N, n] f32 tensor and the grid is (column tiles, k): block
// (x, j) reads idx[j] from device memory itself (the host never sees the
// ids) and copies its tiles of row j with a grid-stride loop.  K7 writes
// only the k selected rows of the table it is given; nothing else of the
// table is read or written.
//
// What bounds them on the card: pure data movement.  Each call reads and
// writes k rows of n floats, 8 k n bytes (plus the k ids), and does no
// arithmetic, so HBM bandwidth is the bound: at the fig. 7 setting (k =
// 10 clients, a CNN_MNIST row of 1,663,370 floats) 133 MB, about 40 us
// at 3.35 TB/s.  The design moves each byte once, with 16-byte vector
// loads and stores when the table, the rows and the row length allow it
// (both base pointers 16-byte aligned and n a multiple of 4), else with a
// scalar loop; enough column tiles per row (up to 1024) are in flight to
// fill the 132 SMs even for one row.
//
// Duplicate ids: K7's blocks for two equal ids write the same row in no
// set order.  Callers keep ids unique except for a scratch row whose
// contents are discarded (the sharded layout's write sink), so that race
// is harmless, as in the JAX package's contract.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxColBlocks = 1024;
constexpr long long kMaxRows = 65535;   // gridDim.y

__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ dst,
                                         long long n, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long groups = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long long g = tid; g < groups; g += stride) d4[g] = s4[g];
    done = groups * 4;
  }
  for (long long i = done + tid; i < n; i += stride) dst[i] = src[i];
}

template <typename I>
__global__ void ef_gather_kernel(const float* __restrict__ table,
                                 const I* __restrict__ idx,
                                 float* __restrict__ out, long long n,
                                 int vec) {
  const long long j = blockIdx.y;
  const long long row = (long long)idx[j];
  copy_row(table + row * n, out + j * n, n, vec);
}

template <typename I>
__global__ void ef_scatter_kernel(float* __restrict__ table,
                                  const I* __restrict__ idx,
                                  const float* __restrict__ rows, long long n,
                                  int vec) {
  const long long j = blockIdx.y;
  const long long row = (long long)idx[j];
  copy_row(rows + j * n, table + row * n, n, vec);
}

dim3 grid_for(long long k, long long n, int vec) {
  const long long work = vec ? n / 4 + 3 : n;
  long long b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxColBlocks) b = kMaxColBlocks;
  return dim3((unsigned)b, (unsigned)k);
}

}  // namespace

extern "C" {

// table [N, n] f32, idx [k] (int64 when idx64 != 0, else int32), out
// [k, n] f32, all on the device; 1 <= k <= 65535, n >= 1.  vec != 0
// promises 16-byte aligned table and out and n % 4 == 0.  Ids must lie in
// [0, N): the kernel does not check them.  Returns cudaGetLastError().
int ef_gather_f32(const float* table, const void* idx, int idx64, float* out,
                  long long k, long long n, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxRows || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(k, n, vec);
  if (idx64)
    ef_gather_kernel<long long><<<grid, kThreads, 0, s>>>(
        table, static_cast<const long long*>(idx), out, n, vec);
  else
    ef_gather_kernel<int><<<grid, kThreads, 0, s>>>(
        table, static_cast<const int*>(idx), out, n, vec);
  return (int)cudaGetLastError();
}

// table [N, n] f32 (written in place), idx [k] (int64 when idx64 != 0,
// else int32), rows [k, n] f32, all on the device; 1 <= k <= 65535,
// n >= 1.  vec != 0 promises 16-byte aligned table and rows and
// n % 4 == 0.  Returns cudaGetLastError().
int ef_scatter_f32(float* table, const void* idx, int idx64,
                   const float* rows, long long k, long long n, int vec,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxRows || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(k, n, vec);
  if (idx64)
    ef_scatter_kernel<long long><<<grid, kThreads, 0, s>>>(
        table, static_cast<const long long*>(idx), rows, n, vec);
  else
    ef_scatter_kernel<int><<<grid, kThreads, 0, s>>>(
        table, static_cast<const int*>(idx), rows, n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
