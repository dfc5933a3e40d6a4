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
// do not.  Each thread issues up to four loads before its stores, from a
// grid of at most a few CTAs per SM (144 of 256 threads for one KV block),
// and loads and stores are streaming (evict-first): one request's 32 block
// stores move 75 MB, more than L2 holds, so normal caching keeps lines
// there that the next stores must evict first.  A few head and tail bytes
// go byte by byte, so any `n` and any `offset` are taken and no caller
// needs an unaligned branch.  The copy is bitwise: it moves bytes and never
// converts.
//
// Host cost: one store of a KV block moves 4.7 MB, about 3 us of device
// time, so back-to-back stores are bound by the host's work per call.  The
// wrapper therefore passes the row's address already offset and the byte
// count (five arguments for ctypes to convert, against seven), through an
// entry point bound once when the library loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;                 // vector loads per thread before its stores
constexpr long long kMaxBlocks = 132LL * 4;  // a few CTAs per SM; grid-stride beyond

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
  for (long long base = tid; base < nvec; base += stride * kInFlight) {
    V v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = base + u * stride;
      if (i < nvec) v[u] = __ldcs(s + i);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = base + u * stride;
      if (i < nvec) __stcs(d + i, v[u]);
    }
  }
}

template <typename V>
int launch(unsigned char* dst, const unsigned char* src, long long nbytes,
           cudaStream_t stream) {
  const long long a = sizeof(V);
  long long head = (a - static_cast<long long>(reinterpret_cast<uintptr_t>(dst) % a)) % a;
  if (head > nbytes) head = nbytes;
  const long long nvec = (nbytes - head) / a;
  const long long per_cta = static_cast<long long>(kThreads) * kInFlight;
  long long blocks = (nvec + per_cta - 1) / per_cta;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  copy_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      dst, src, head, nvec, nbytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dst: the row's address at the store's first element (the wrapper adds
// offset * itemsize); nbytes = n * itemsize.
extern "C" int ishmem_copy_into(int device, void* dst, const void* src, long long nbytes,
                                void* stream) {
  // kept: the wrapper does not make the tensor's device current
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbytes == 0) return 0;
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // after `head` bytes both pointers are V-aligned iff they agree mod sizeof(V)
  const uintptr_t mis = reinterpret_cast<uintptr_t>(d) ^ reinterpret_cast<uintptr_t>(s);
  if (mis % 16 == 0) return launch<uint4>(d, s, nbytes, st);
  if (mis % 4 == 0) return launch<uint32_t>(d, s, nbytes, st);
  if (mis % 2 == 0) return launch<uint16_t>(d, s, nbytes, st);
  return launch<unsigned char>(d, s, nbytes, st);
}

extern "C" const char* ishmem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
