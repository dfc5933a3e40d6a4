// K1: the work-group heap store.
//
// Replaces repro/kernels/rma_copy.py::wg_copy_local (the Pallas tiled VMEM
// copy behind every direct-path heap store).  Copies `n` elements of
// `itemsize` bytes from `src` into `dst_row` at element `offset`, in place;
// every other byte of the row keeps its value (the reference aliases the
// row to its output for the same effect).
//
// Bound: bytes.  The copy reads n*itemsize and writes n*itemsize bytes, so
// its floor is 2*n*itemsize over the card's memory rate.  The design keeps
// every thread on 16-byte loads and stores whenever source and destination
// share their alignment mod 16 (the heap's 128-element allocation grid makes
// that the common case), and drops to 4-, 2- or 1-byte units only when they
// do not.  A few head and tail bytes go byte by byte, so any `n` and any
// `offset` are taken and no caller needs an unaligned branch.  The copy is
// bitwise: it moves bytes and never converts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride beyond this

template <typename V>
__global__ void __launch_bounds__(kThreads)
copy_kernel(unsigned char* __restrict__ dst, const unsigned char* __restrict__ src,
            long long head, long long nvec, long long nbytes) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // bytes before the first V-aligned destination address, and after the
  // last whole V: fewer than sizeof(V) each, one byte per thread
  const long long tail0 = head + nvec * static_cast<long long>(sizeof(V));
  if (tid < head) dst[tid] = src[tid];
  if (tid < nbytes - tail0) dst[tail0 + tid] = src[tail0 + tid];
  V* d = reinterpret_cast<V*>(dst + head);
  const V* s = reinterpret_cast<const V*>(src + head);
  for (long long i = tid; i < nvec; i += stride) d[i] = s[i];
}

template <typename V>
int launch(unsigned char* dst, const unsigned char* src, long long nbytes,
           cudaStream_t stream) {
  const long long a = sizeof(V);
  long long head = (a - static_cast<long long>(reinterpret_cast<uintptr_t>(dst) % a)) % a;
  if (head > nbytes) head = nbytes;
  const long long nvec = (nbytes - head) / a;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  copy_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      dst, src, head, nvec, nbytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ishmem_copy_into(int device, void* dst_row, const void* src,
                                long long n, long long offset, int itemsize,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nbytes = n * itemsize;
  if (nbytes == 0) return 0;
  unsigned char* dst = static_cast<unsigned char*>(dst_row) + offset * itemsize;
  const unsigned char* s = static_cast<const unsigned char*>(src);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // after `head` bytes both pointers are V-aligned iff they agree mod sizeof(V)
  const uintptr_t mis = reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(s);
  if (mis % 16 == 0) return launch<uint4>(dst, s, nbytes, st);
  if (mis % 4 == 0) return launch<uint32_t>(dst, s, nbytes, st);
  if (mis % 2 == 0) return launch<uint16_t>(dst, s, nbytes, st);
  return launch<unsigned char>(dst, s, nbytes, st);
}

extern "C" const char* ishmem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
