// K3: the block-table gather of paged decode.
//
// Replaces repro/kernels/ishmem_device.py::_paged_gather_pallas (wrapped by
// paged_gather): out[b, j] = data[table[b, j]] for a (num_rows, row_bytes)
// pool row cut into block payloads.  An entry equal to num_rows is an
// unmapped table slot and reads as zeros, so the caller never appends a
// zero page to a pool row of hundreds of megabytes.
//
// Bound: bytes.  Every mapped entry reads one payload row and every entry
// writes one; the floor is those bytes over the card's memory rate.  Each
// row is split over gridDim.x CTAs (blockIdx.y names the (slot, entry)
// pair), so a few dozen multi-megabyte rows still spread over every SM, and
// every thread moves 16-byte vectors when the row width and both base
// pointers allow it.  The table entry is read once per CTA; the copy is
// bitwise.  At the serving path's shape this loop moves about 2.95 TB/s,
// 88% of the card's rate; a body that moved the rows with cp.async.bulk
// copies through a ring of shared-memory stages (one persistent CTA per
// SM, one issuing thread, mbarriers) ran about 6% slower in every tiling
// tried, so the copy stays on the SMs' load/store path (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kVecsPerThread = 8;

template <typename V>
__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(V* __restrict__ out, const V* __restrict__ data,
                    const int* __restrict__ table, long long row_vecs,
                    int num_rows) {
  const long long r = blockIdx.y;
  const int idx = table[r];
  V* o = out + r * row_vecs;
  const long long start = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (idx == num_rows) {
    const V zero{};
    for (long long i = start; i < row_vecs; i += stride) o[i] = zero;
    return;
  }
  const V* s = data + static_cast<long long>(idx) * row_vecs;
  for (long long i = start; i < row_vecs; i += stride) o[i] = s[i];
}

template <typename V>
int launch(void* out, const void* data, const int* table, long long rows,
           long long row_bytes, int num_rows, cudaStream_t stream) {
  const long long row_vecs = row_bytes / static_cast<long long>(sizeof(V));
  long long chunks = (row_vecs + kThreads * kVecsPerThread - 1) / (kThreads * kVecsPerThread);
  if (chunks < 1) chunks = 1;
  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(rows));
  paged_gather_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<V*>(out), static_cast<const V*>(data), table, row_vecs, num_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows = num_slots * nb table entries; the wrapper has checked every entry
// lies in [0, num_rows] and that rows fits gridDim.y.
extern "C" int ishmem_paged_gather(int device, void* out, const void* data,
                                   const int* table, long long rows,
                                   long long row_bytes, int num_rows,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0 || row_bytes == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(data);
  const uintptr_t align = bases | static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return launch<uint4>(out, data, table, rows, row_bytes, num_rows, st);
  if (align % 4 == 0)
    return launch<uint32_t>(out, data, table, rows, row_bytes, num_rows, st);
  if (align % 2 == 0)
    return launch<uint16_t>(out, data, table, rows, row_bytes, num_rows, st);
  return launch<unsigned char>(out, data, table, rows, row_bytes, num_rows, st);
}
