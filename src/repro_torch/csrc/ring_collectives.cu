// K4-K8: device-initiated collectives over PE-stacked buffers.
//
// Replaces repro/kernels/rma_copy.py::remote_put (K4) and
// repro/kernels/ring_collectives.py::{ring_allgather, ring_reduce_scatter,
// push_broadcast, barrier_push} (K5-K8).  The reference runs each Pallas
// kernel once per PE under shard_map, with remote DMAs and DMA semaphores
// between chips.  On one card the PEs are the leading axis of stacked
// buffers, and one launch runs them all.
//
// K4 and K8 push, as the reference does, in one cooperative launch:
//
// - a PE is a group of G CTAs (blockIdx.x = g * P + pe: consecutive CTAs
//   belong to different PEs, so a PE's group spreads over the SMs instead
//   of filling a few of them);
// - CTA g of every PE owns the same column slice g of the chunk, so a
//   "remote DMA" is the group's stores into another PE's row, and a CTA
//   only ever waits on flags of its own slice, set by CTA g of another PE;
// - a DMA semaphore is an int32 flag in a global buffer indexed by
//   (PE, slice): K4's are zeroed on the stream before each launch, so no
//   flag of an earlier launch satisfies this one; K8's counters persist and
//   each barrier waits for its own epoch's count instead.
//
// Ordering: the writer stores its slice, __syncthreads(), then one thread
// runs __threadfence() and a release add on the flag.  The reader's thread
// 0 spins with an acquire load, fences, and __syncthreads() before any
// thread reads; data another CTA wrote is read through L2 (__ldcg), never
// from a possibly stale L1 line.  A CTA that spins on a flag set by a CTA
// that is not resident would hang the card, so every such kernel is
// launched with cudaLaunchCooperativeKernel on a grid sized from the
// occupancy query (asked once per kernel and device), which guarantees
// that all P * G CTAs are resident at once.  A flag that never rises is a protocol fault: every spin gives up
// after 10 s and traps, so the launch fails instead of holding the card.
//
// K5, K6 and K7 pull instead of pushing.  On one card every PE's rows are
// loadable by every CTA, which is the paper's direct load/store path: a PE
// reads its peers' symmetric buffers instead of waiting for them to push.
// On one stream the inputs are complete when the launch starts, so none of
// them needs flags, a landing buffer, an entry barrier, an occupancy query
// or a cooperative launch: each is one ordinary launch, every thread
// keeping up to kFold loads in flight before it stores.
//
// - K5 (fcollect, out[p][q] = x[q]) and K7 (broadcast, out[p] = x[root])
//   share one body, fan_out: each thread loads its vectors of one source
//   row, then streams them (__stcs: nothing reads out again here) to that
//   row's slot in every PE's output.  The source row is blockIdx.y for K5
//   (grid (vector blocks, P)) and root for K7 (grid (vector blocks, 1));
//   the stride between PEs' slots is P * c for K5 and c for K7.  Each
//   source byte is read once and each output byte written once: exactly
//   P (P + 1) c bytes for K5 and (P + 1) c for K7.
// - K5's TPU ring runs P - 1 flag-gated steps; from the second on, each PE
//   re-reads from out the slot its neighbour has just written, about
//   2 P^2 c bytes on one card against the function's P (P + 1) c.
// - K7 is a fan-out, not "each PE copies its own row".  On one card it
//   does not matter which CTA stores a row, and a copy per row would read
//   x[root] P times: 2 P c bytes against (P + 1) c, since a 49.8 MB leaf
//   does not stay in the 50 MB L2 beside the stores.  The TPU's push
//   design (the root's CTAs copy while every other PE's CTAs spin on their
//   flags) left P - 1 of P CTA groups idle.
// - K6 (reduce-scatter).  The TPU ring runs P - 1 flag-gated steps, each
//   reading a landing slot and an addend and writing the neighbour's
//   landing slot: (3P - 1) * P * c bytes on one card against the function's
//   P (P + 1) c (x read once, out written once), 2.6 times as many at
//   P = 8.  Here blockIdx.y is the chunk c: each thread issues the P loads
//   x[(c + 1 + j) mod P][c] (in groups of kFold) before it folds them in
//   that order, and stores out[c] once.  The fold order is the ring's:
//     out[c] = (...((x[c+1][c] + x[c+2][c]) + x[c+3][c]) + ...) + x[c][c]
//   (indices mod P), in the input's type (bf16 through f32 and
//   round-to-nearest-even, which equals a correctly rounded bf16 add), so
//   it equals its plain PyTorch version bitwise.
//
// Bound: bytes, for K4-K7 (each input read once, each output written once;
// chip_smoke.py states each kernel's count).  Copies move 16-byte vectors
// whenever the chunk and the base pointers allow it, and are bitwise.  K8
// moves no data: its floor is one empty cooperative launch, and a call is
// that launch alone (its counters persist across calls under an epoch, so
// no memset precedes it; see barrier_kernel).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFold = 8;                   // loads in flight per thread (K5-K7)
// K5's and K7's CTAs: each writes P times what it reads, so small CTAs
// (640 at K5's main shape on the collectives path) spread those stores
// evenly over the SMs; 256-thread CTAs (160 there) left some SMs two CTAs'
// stores to finish
constexpr int kPullThreads = 64;

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// After every thread of the CTA has stored its part: publish to `flag`.
__device__ __forceinline__ void raise_flag(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    red_release_add(flag, 1);
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin (one thread) until `flag` reaches `target`.  A flag that never comes
// is a protocol fault: after kSpinLimitNs the kernel traps, so the launch
// fails with an error instead of holding the card forever.
constexpr unsigned long long kSpinLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void spin_until(const int* flag, int target) {
  const unsigned long long t0 = global_ns();
  while (ld_acquire(flag) < target) {
    if (global_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// Block until `flag` reaches `target`; afterwards every thread of the CTA
// may read what the signalling CTA stored before its release.
__device__ __forceinline__ void wait_flag(const int* flag, int target) {
  if (threadIdx.x == 0) {
    spin_until(flag, target);
    __threadfence();
  }
  __syncthreads();
}

struct Slice {
  long long lo, hi;
};

__device__ __forceinline__ Slice slice_of(long long nvec, int g, int G) {
  return {nvec * g / G, nvec * (g + 1) / G};
}

// Each thread keeps kUnroll loads in flight before it stores: one load at
// a time leaves an SM too few bytes in flight to approach the memory rate.
constexpr int kUnroll = 4;

template <typename V>
__device__ __forceinline__ void load_units(V (&v)[kUnroll], const V* __restrict__ src,
                                           long long base, long long hi) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + static_cast<long long>(u) * kThreads;
    if (i < hi) v[u] = __ldcg(src + i);
  }
}

template <typename V>
__device__ __forceinline__ void store_units(V* __restrict__ dst, const V (&v)[kUnroll],
                                            long long base, long long hi) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + static_cast<long long>(u) * kThreads;
    if (i < hi) dst[i] = v[u];
  }
}

template <typename V>
__device__ __forceinline__ void copy_slice(V* __restrict__ dst, const V* __restrict__ src, Slice s) {
  for (long long base = s.lo + threadIdx.x; base < s.hi; base += kUnroll * kThreads) {
    V v[kUnroll];
    load_units(v, src, base, s.hi);
    store_units(dst, v, base, s.hi);
  }
}

// ---------------------------------------------------------------- K4
// out[(p + off) mod P] = x[p], all n elements (the reference's last
// n mod w elements are never written; here every element is).
template <typename V>
__global__ void __launch_bounds__(kThreads)
remote_put_kernel(V* out, const V* x, int* flags, int P, int G, long long nvec, int off) {
  const int p = blockIdx.x % P, g = blockIdx.x / P;
  const int tgt = (p + off) % P;
  const Slice s = slice_of(nvec, g, G);
  copy_slice(out + tgt * nvec, x + p * nvec, s);
  raise_flag(&flags[tgt * G + g]);
  wait_flag(&flags[p * G + g], 1);  // the put landing in my own buffer
}

// ---------------------------------------------------------------- K5, K7
// The fan-out shared by K5 and K7: each thread loads up to kFold vectors
// of `src` (one PE's row of nvec vectors) before it stores anything, then
// stores them to dst + p * pe_stride for every PE p.
template <typename V>
__device__ __forceinline__ void fan_out(V* __restrict__ dst, const V* __restrict__ src, int P,
                                        long long nvec, long long pe_stride) {
  const long long i0 = static_cast<long long>(blockIdx.x) * kPullThreads * kFold + threadIdx.x;
  V v[kFold];
#pragma unroll
  for (int u = 0; u < kFold; ++u) {
    const long long i = i0 + static_cast<long long>(u) * kPullThreads;
    if (i < nvec) v[u] = src[i];
  }
  for (int p = 0; p < P; ++p) {
    V* row = dst + p * pe_stride;
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
      const long long i = i0 + static_cast<long long>(u) * kPullThreads;
      if (i < nvec) __stcs(row + i, v[u]);
    }
  }
}

// K5: x (P, nvec) -> out (P, P, nvec).  blockIdx.y is the source PE q.
template <typename V>
__global__ void __launch_bounds__(kPullThreads)
allgather_pull(V* __restrict__ out, const V* __restrict__ x, int P, long long nvec) {
  const long long q = blockIdx.y;
  fan_out(out + q * nvec, x + q * nvec, P, nvec, P * nvec);
}

// K7: x (P, nvec) -> out (P, nvec), every row x[root].
template <typename V>
__global__ void __launch_bounds__(kPullThreads)
broadcast_pull(V* __restrict__ out, const V* __restrict__ x, int P, long long nvec, int root) {
  fan_out(out, x + static_cast<long long>(root) * nvec, P, nvec, nvec);
}

// ---------------------------------------------------------------- K6
struct AddF32 {
  using E = float;
  __device__ static E add(E a, E b) { return a + b; }
};

struct AddBF16 {  // bf16 as its bits
  using E = unsigned short;
  __device__ static E add(E a, E b) {
    const float fa = __uint_as_float(static_cast<unsigned>(a) << 16);
    const float fb = __uint_as_float(static_cast<unsigned>(b) << 16);
    return __bfloat16_as_ushort(__float2bfloat16_rn(fa + fb));
  }
};

template <typename Op, typename V>
__device__ __forceinline__ V vadd(V a, V b) {
  using E = typename Op::E;
  constexpr int N = sizeof(V) / sizeof(E);
  union U {
    V v;
    E e[N];
  } ua, ub, uc;
  ua.v = a;
  ub.v = b;
#pragma unroll
  for (int k = 0; k < N; ++k) uc.e[k] = Op::add(ua.e[k], ub.e[k]);
  return uc.v;
}

// x: (P, P, nvec) addend rows; out: (P, nvec).  blockIdx.y is the chunk c,
// and the thread's vector i of it is folded over the P PEs in ring order.

template <typename Op, typename V>
__global__ void __launch_bounds__(kThreads)
reduce_scatter_pull(V* __restrict__ out, const V* __restrict__ x, int P, long long nvec) {
  const int c = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nvec) return;
  const V* col = x + static_cast<long long>(c) * nvec + i;   // x[0][c][i]
  const long long pe_stride = static_cast<long long>(P) * nvec;
  V acc{};
  for (int j0 = 0; j0 < P; j0 += kFold) {
    V v[kFold];
#pragma unroll
    for (int u = 0; u < kFold; ++u)
      if (j0 + u < P) v[u] = col[((c + 1 + j0 + u) % P) * pe_stride];
#pragma unroll
    for (int u = 0; u < kFold; ++u)
      if (j0 + u < P) acc = j0 + u == 0 ? v[u] : vadd<Op>(acc, v[u]);
  }
  out[static_cast<long long>(c) * nvec + i] = acc;
}

// ---------------------------------------------------------------- K8
// One warp per PE: +1 to every other PE's counter (release), then wait for
// its own.  Lane i adds to PE p + 1 + i, so the P - 1 release adds are one
// warp instruction and order once, not P - 1 times in turn.  Lane 0 then
// spins with acquire loads, with no fence after, and reads the clock for
// its 10 s limit only every 256 polls.  The counters are never reset
// between barriers: barrier number `epoch` (counted by the wrapper from 1
// on each counter buffer) passes when counters[p] reaches epoch * (P - 1).
// The difference is taken in 32-bit two's complement, so the counters and
// the target may wrap; a counter is never more than P - 1 behind its
// target, since the launches on one stream run in turn.
__global__ void barrier_kernel(int* out, int* counters, int P, int epoch) {
  const int p = blockIdx.x;
  for (int i = threadIdx.x; i < P - 1; i += blockDim.x)
    red_release_add(&counters[(p + 1 + i) % P], 1);
  if (threadIdx.x == 0) {
    const unsigned target = static_cast<unsigned>(epoch) * static_cast<unsigned>(P - 1);
    unsigned long long t0 = 0;
    for (unsigned n = 0;
         static_cast<int>(static_cast<unsigned>(ld_acquire(&counters[p])) - target) < 0; ++n) {
      if (n % 256) continue;
      if (n == 0) t0 = global_ns();
      else if (global_ns() - t0 > kSpinLimitNs) __trap();
    }
    out[p] = 1;
  }
}

__global__ void noop_kernel() {}

// ---------------------------------------------------------------- launch

// CTAs of `kernel` (`threads` each) that the card keeps resident at once,
// the bound of a cooperative launch: the cooperative-launch attribute, the
// SM count and the occupancy query, asked once per kernel and device and
// cached (a kernel is always launched here with the same block size).
template <typename K>
cudaError_t resident_ctas(K kernel, int device, int threads, long long* ctas) {
  static long long cached[64] = {};
  if (device >= 0 && device < 64 && cached[device]) {
    *ctas = cached[device];
    return cudaSuccess;
  }
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  *ctas = static_cast<long long>(per_sm) * sms;
  if (device >= 0 && device < 64) cached[device] = *ctas;
  return cudaSuccess;
}

// CTAs per PE for a cooperative launch of `kernel`: as many as `want`, no
// more than keep P groups resident at once and fit the flag buffer.
template <typename K>
cudaError_t groups_for(K kernel, int device, int threads, int P, long long want,
                       long long flags_per_cta, long long flag_cap, int* G) {
  long long resident = 0;
  cudaError_t err = resident_ctas(kernel, device, threads, &resident);
  if (err != cudaSuccess) return err;
  long long g = resident / P;
  if (flags_per_cta > 0 && flag_cap / (P * flags_per_cta) < g) g = flag_cap / (P * flags_per_cta);
  if (g < 1) return cudaErrorCooperativeLaunchTooLarge;  // P groups cannot all be resident
  if (want < g) g = want < 1 ? 1 : want;
  *G = static_cast<int>(g);
  return cudaSuccess;
}

template <typename K>
int coop_launch(K kernel, int P, int G, void** args, int threads, cudaStream_t st) {
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                dim3(static_cast<unsigned>(P) * G), dim3(threads),
                                                args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// widest unit that the chunk and every base pointer are aligned to
int align_of(long long chunk_bytes, uintptr_t bases) {
  const uintptr_t a = bases | static_cast<uintptr_t>(chunk_bytes);
  if (a % 16 == 0) return 16;
  if (a % 8 == 0) return 8;
  if (a % 4 == 0) return 4;
  if (a % 2 == 0) return 2;
  return 1;
}

template <typename T>
struct Unit {
  using type = T;
};

// Call f(Unit<V>{}) with V the copy unit of `align` bytes.
template <typename F>
int by_unit(int align, F f) {
  switch (align) {
    case 16: return f(Unit<uint4>{});
    case 8: return f(Unit<uint2>{});
    case 4: return f(Unit<unsigned>{});
    case 2: return f(Unit<unsigned short>{});
    default: return f(Unit<unsigned char>{});
  }
}

template <typename V>
int remote_put_t(int device, void* out, const void* x, int* flags, long long cap, int P,
                 long long chunk_bytes, int off, int work_items, cudaStream_t st) {
  long long nvec = chunk_bytes / static_cast<long long>(sizeof(V));
  long long want = work_items < nvec ? work_items : nvec;
  int G = 0;
  cudaError_t err = groups_for(remote_put_kernel<V>, device, kThreads, P, want, 1, cap, &G);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(flags, 0, sizeof(int) * static_cast<size_t>(P) * G, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  V* o = static_cast<V*>(out);
  const V* xi = static_cast<const V*>(x);
  void* args[] = {&o, &xi, &flags, &P, &G, &nvec, &off};
  return coop_launch(remote_put_kernel<V>, P, G, args, kThreads, st);
}

// K5 (root < 0: every row a source, grid (vector blocks, P)) or K7 (the
// root's row the only source, grid (vector blocks, 1)).
template <typename V>
int pull_t(void* out, const void* x, int P, long long chunk_bytes, int root, cudaStream_t st) {
  const long long nvec = chunk_bytes / static_cast<long long>(sizeof(V));
  const long long per_cta = static_cast<long long>(kPullThreads) * kFold;
  const unsigned blocks = static_cast<unsigned>((nvec + per_cta - 1) / per_cta);
  V* o = static_cast<V*>(out);
  const V* xi = static_cast<const V*>(x);
  if (root < 0)
    allgather_pull<V><<<dim3(blocks, P), kPullThreads, 0, st>>>(o, xi, P, nvec);
  else
    broadcast_pull<V><<<blocks, kPullThreads, 0, st>>>(o, xi, P, nvec, root);
  return static_cast<int>(cudaGetLastError());
}

template <typename Op, typename V>
int reduce_scatter_t(void* out, const void* x, int P, long long chunk_bytes, cudaStream_t st) {
  const long long nvec = chunk_bytes / static_cast<long long>(sizeof(V));
  const dim3 grid(static_cast<unsigned>((nvec + kThreads - 1) / kThreads), P);
  reduce_scatter_pull<Op, V><<<grid, kThreads, 0, st>>>(static_cast<V*>(out),
                                                       static_cast<const V*>(x), P, nvec);
  return static_cast<int>(cudaGetLastError());
}

uintptr_t bits(const void* p) { return reinterpret_cast<uintptr_t>(p); }

}  // namespace

// Every entry point: `device` is the CUDA ordinal, `stream` PyTorch's
// current stream, `flags` (K4) an int32 scratch buffer of
// `flag_cap` words that the wrapper allocated (zeroed here, on the stream,
// before the launch); the wrapper has checked shapes, types and
// contiguity.  Returns a cudaError_t code (0 on success).

extern "C" int ishmem_remote_put(int device, void* out, const void* x, int* flags,
                                 long long flag_cap, int npes, long long chunk_bytes, int offset,
                                 int work_items, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk_bytes == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int off = ((offset % npes) + npes) % npes;
  return by_unit(align_of(chunk_bytes, bits(out) | bits(x)), [&](auto u) {
    using V = typename decltype(u)::type;
    return remote_put_t<V>(device, out, x, flags, flag_cap, npes, chunk_bytes, off, work_items, st);
  });
}

// K5 takes no flags: chunk_bytes bytes per PE.
extern "C" int ishmem_ring_allgather(int device, void* out, const void* x, int npes,
                                     long long chunk_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk_bytes == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_unit(align_of(chunk_bytes, bits(out) | bits(x)), [&](auto u) {
    using V = typename decltype(u)::type;
    return pull_t<V>(out, x, npes, chunk_bytes, -1, st);
  });
}

// K6 takes no flags: dtype 0 = float32, 1 = bfloat16; chunk_elems
// elements per (PE, chunk).
extern "C" int ishmem_ring_reduce_scatter(int device, void* out, const void* x, int npes,
                                          long long chunk_elems, int dtype, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk_elems == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nbytes = chunk_elems * (dtype == 0 ? 4 : 2);
  const bool vec = align_of(nbytes, bits(out) | bits(x)) == 16;
  if (dtype == 0)
    return vec ? reduce_scatter_t<AddF32, uint4>(out, x, npes, nbytes, st)
               : reduce_scatter_t<AddF32, float>(out, x, npes, nbytes, st);
  if (dtype == 1)
    return vec ? reduce_scatter_t<AddBF16, uint4>(out, x, npes, nbytes, st)
               : reduce_scatter_t<AddBF16, unsigned short>(out, x, npes, nbytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7 takes no flags: chunk_bytes bytes per PE, 0 <= root < npes.
extern "C" int ishmem_push_broadcast(int device, void* out, const void* x, int npes,
                                     long long chunk_bytes, int root, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk_bytes == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_unit(align_of(chunk_bytes, bits(out) | bits(x)), [&](auto u) {
    using V = typename decltype(u)::type;
    return pull_t<V>(out, x, npes, chunk_bytes, root, st);
  });
}

// out: (npes,) int32; counters: npes int32 words that the wrapper keeps
// for this (device, stream), zeroed when it made them or npes changed, and
// `epoch` the number of this barrier on them (see barrier_kernel).  One
// cooperative launch and nothing else: no memset, and the residency check
// is asked once per device.
extern "C" int ishmem_barrier_push(int device, int* out, int* counters, int npes, int epoch,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long resident = 0;
  err = resident_ctas(barrier_kernel, device, 32, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (npes > resident) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&out, &counters, &npes, &epoch};
  return coop_launch(barrier_kernel, npes, 1, args, 32, static_cast<cudaStream_t>(stream));
}

// An empty cooperative launch of npes CTAs: K8's floor, for timing only.
extern "C" int ishmem_coop_noop(int device, int npes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {nullptr};
  return coop_launch(noop_kernel, npes, 1, args, 32, static_cast<cudaStream_t>(stream));
}
