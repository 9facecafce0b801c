// Payload staging for the serverless chain hop on Hopper (sm_90a): one
// masked chunk gather serves both directions of a krcore hop.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/serverless_stage/stage.py:
//   chunk_gather  <- chunk_gather_pallas (_gather_kernel)
//
//   pack:    slab_chunk[j]    <- payload_chunk[src_row[j]]  (j over the slab)
//   unpack:  payload_chunk[j] <- slab_chunk[src_row[j]]     (j over the rows)
//
// Contract: out[j][e] = src[r(j)][e] for e < valid[j], else 0, over chunks
// of `chunk` int32 elements. valid[j] > chunk keeps the whole chunk and
// valid[j] <= 0 gives zeros without reading src at all (such rows may point
// anywhere). r(j) is src_row[j] made a row of src the way the JAX kernel
// resolves it in interpret mode: a negative id wraps once (+ NSRC), then the
// id is clamped to [0, NSRC-1]. The Python wrapper never launches with
// NSRC == 0 or NOUT == 0.
//
// What bounds it: HBM bytes. There is no arithmetic, only a copy of the live
// chunks, the zero fill and two int32 routing tables, so the card's
// 3.35 TB/s (and, at a hop's sizes of a few KiB to 1 MiB, the launch and
// the latency of one dependent load) is the limit. The design spends
// nothing that is not bytes: one warp per output chunk, which reads its
// routing entry once (a broadcast load) and then moves the chunk with
// 16-byte vectors, one per lane: 512 bytes, the default chunk of 128
// elements, is exactly one warp-wide vector access. The ragged tail is
// masked in registers; a vector wholly past valid[j] is never loaded.
// Chunks that are not a multiple of 4 elements, or pointers that are not
// 16-byte aligned, take a scalar path with the same contract. Offsets are
// 64-bit throughout.
//
// Two routes, each its own C entry point (the Python wrapper's
// `gather_route` picks one; neither falls back to the other):
//   chunk_gather_byval  the routing lies on the host and NOUT <= 2,048:
//                       the launcher copies src_row and valid into the
//                       kernel's parameter block, the counterpart of the
//                       TPU kernel's scalar prefetch (stage.py:59 takes
//                       both as scalar-prefetch operands, in SMEM before the
//                       grid starts). No host-to-device copy of the routing
//                       and no dependent device load before the source is
//                       addressed: a warp reads its entry from the constant
//                       bank. The block is declared __grid_constant__, so a
//                       dynamically indexed entry is read in place and never
//                       copied to local memory. Kernel parameters may take
//                       32,764 bytes since CUDA 12.1 (sm_70 and later); a
//                       ladder of capacities (64 / 512 / 2,048 entries)
//                       keeps a small slab from shipping 16 KiB. Every
//                       chain gather fits: 16 payloads x 128 chunks (64 KiB)
//                       = 2,048 entries. The kernel keeps the scalar path
//                       for odd chunk sizes and unaligned pointers.
//   chunk_gather        the routing is on the card, or longer than 2,048
//                       entries (the wrapper then copies it over once): the
//                       kernels above, unchanged.
// Each entry refuses the other's routing: the by-value one a device pointer
// or NOUT > 2,048, the device one a pointer that is not device memory.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;  // warps (= output chunks) per block

__device__ __forceinline__ int64_t source_row(int32_t r, int64_t nsrc) {
  const int64_t s = r < 0 ? static_cast<int64_t>(r) + nsrc : r;
  return s < 0 ? 0 : (s >= nsrc ? nsrc - 1 : s);
}

// Vector path: chunk % 4 == 0 and src/out 16-byte aligned.
__global__ void __launch_bounds__(kWarps * kWarp)
chunk_gather_vec_kernel(const int4* __restrict__ src,
                        const int32_t* __restrict__ src_row,
                        const int32_t* __restrict__ valid,
                        int4* __restrict__ out, int64_t nout, int64_t nsrc,
                        int chunk) {
  const int lane = threadIdx.x % kWarp;
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  if (j >= nout) return;
  const int nvec = chunk / 4;
  int4* dst = out + j * nvec;
  const int32_t v = valid[j];
  if (v <= 0) {
    for (int k = lane; k < nvec; k += kWarp) dst[k] = make_int4(0, 0, 0, 0);
    return;
  }
  const int4* s = src + source_row(src_row[j], nsrc) * nvec;
  for (int k = lane; k < nvec; k += kWarp) {
    const int e = 4 * k;  // first element of this vector
    int4 x = make_int4(0, 0, 0, 0);
    if (e < v) {
      x = s[k];
      if (e + 4 > v) {  // the ragged tail: e < v < e + 4 keeps x.x
        if (e + 1 >= v) x.y = 0;
        if (e + 2 >= v) x.z = 0;
        x.w = 0;
      }
    }
    dst[k] = x;
  }
}

// Scalar path: any chunk size and alignment.
__global__ void __launch_bounds__(kWarps * kWarp)
chunk_gather_scalar_kernel(const int32_t* __restrict__ src,
                           const int32_t* __restrict__ src_row,
                           const int32_t* __restrict__ valid,
                           int32_t* __restrict__ out, int64_t nout,
                           int64_t nsrc, int chunk) {
  const int lane = threadIdx.x % kWarp;
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  if (j >= nout) return;
  int32_t* dst = out + j * chunk;
  const int32_t v = valid[j];
  if (v <= 0) {
    for (int e = lane; e < chunk; e += kWarp) dst[e] = 0;
    return;
  }
  const int32_t* s = src + source_row(src_row[j], nsrc) * chunk;
  for (int e = lane; e < chunk; e += kWarp) dst[e] = e < v ? s[e] : 0;
}

// ---------------------------------------------------- the by-value route
// Most routing entries a by-value launch takes (the ladder's top rung).
constexpr int kByvalMax = 2048;
constexpr int kByvalWarps = 8;  // warps (= output chunks) per block

// src_row and valid of every output chunk, passed by value.
template <int CAP>
struct GatherRouting {
  int32_t src_row[CAP];
  int32_t valid[CAP];
};
static_assert(sizeof(GatherRouting<kByvalMax>) + 64 <= 32764,
              "the routing block must fit CUDA 12.1's 32,764 bytes of "
              "kernel parameters");

// Zero the elements of x at or past valid v (x holds elements e, e+1, ...).
__device__ __forceinline__ void mask_tail(int4& x, int e, int v) {
  if (e + 4 > v) {  // the ragged tail: e < v < e + 4 keeps x.x
    if (e + 1 >= v) x.y = 0;
    if (e + 2 >= v) x.z = 0;
    x.w = 0;
  }
}
__device__ __forceinline__ void mask_tail(int32_t&, int, int) {}

// One warp per output chunk, as above; V is int4 (the vector path) or
// int32_t (the scalar path), nvec the chunk's length in V.
template <typename V, int CAP>
__global__ void __launch_bounds__(kByvalWarps * kWarp)
chunk_gather_byval_kernel(const V* __restrict__ src, V* __restrict__ out,
                          int nout, int64_t nsrc, int nvec,
                          const __grid_constant__ GatherRouting<CAP> routing) {
  constexpr int kElems = sizeof(V) / sizeof(int32_t);
  const int lane = threadIdx.x % kWarp;
  const int j = blockIdx.x * kByvalWarps + threadIdx.x / kWarp;
  if (j >= nout) return;
  const int32_t v = routing.valid[j];  // v <= 0: no vector is loaded
  const V* s = src + source_row(routing.src_row[j], nsrc) * nvec;
  V* dst = out + static_cast<int64_t>(j) * nvec;
  for (int k = lane; k < nvec; k += kWarp) {
    const int e = kElems * k;  // first element of this vector
    V x{};
    if (e < v) {
      x = s[k];
      mask_tail(x, e, v);
    }
    dst[k] = x;
  }
}

template <int CAP>
void launch_byval(const void* src, const int32_t* src_row,
                  const int32_t* valid, void* out, int nout, int64_t nsrc,
                  int chunk, bool vec, cudaStream_t stream) {
  GatherRouting<CAP> routing;
  std::memcpy(routing.src_row, src_row, sizeof(int32_t) * nout);
  std::memcpy(routing.valid, valid, sizeof(int32_t) * nout);
  const unsigned blocks = (nout + kByvalWarps - 1) / kByvalWarps;
  if (vec) {
    chunk_gather_byval_kernel<int4, CAP><<<blocks, kByvalWarps * kWarp, 0,
                                           stream>>>(
        static_cast<const int4*>(src), static_cast<int4*>(out), nout, nsrc,
        chunk / 4, routing);
  } else {
    chunk_gather_byval_kernel<int32_t, CAP><<<blocks, kByvalWarps * kWarp,
                                              0, stream>>>(
        static_cast<const int32_t*>(src), static_cast<int32_t*>(out), nout,
        nsrc, chunk, routing);
  }
}

// Where `p` points: device (or managed) memory, or host memory (pageable or
// pinned). Clears the error of a failed query.
bool on_device(const void* p) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return a.type == cudaMemoryTypeDevice || a.type == cudaMemoryTypeManaged;
}

bool on_host(const void* p) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return a.type == cudaMemoryTypeUnregistered || a.type == cudaMemoryTypeHost;
}

bool vector_path(const void* src, const void* out, int chunk) {
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  return chunk % 4 == 0 && bits % 16 == 0;
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue,
// without a launch, for nout < 1, nsrc < 1, chunk < 1 or routing that
// belongs to the other route).
extern "C" {

// src_row and valid are host pointers; nout <= 2,048. The entries are
// copied into the launch's parameters, so they may change once this returns.
int chunk_gather_byval(const void* src, const void* src_row,
                       const void* valid, void* out, int64_t nout,
                       int64_t nsrc, int chunk, void* stream) {
  if (nout < 1 || nout > kByvalMax || nsrc < 1 || chunk < 1 ||
      !on_host(src_row) || !on_host(valid))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto rows = static_cast<const int32_t*>(src_row);
  const auto live = static_cast<const int32_t*>(valid);
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(nout);
  const bool vec = vector_path(src, out, chunk);
  if (n <= 64)
    launch_byval<64>(src, rows, live, out, n, nsrc, chunk, vec, s);
  else if (n <= 512)
    launch_byval<512>(src, rows, live, out, n, nsrc, chunk, vec, s);
  else
    launch_byval<kByvalMax>(src, rows, live, out, n, nsrc, chunk, vec, s);
  return static_cast<int>(cudaGetLastError());
}

// src_row and valid are device pointers.
int chunk_gather(const void* src, const void* src_row, const void* valid,
                 void* out, int64_t nout, int64_t nsrc, int chunk,
                 void* stream) {
  if (nout < 1 || nsrc < 1 || chunk < 1 || !on_device(src_row) ||
      !on_device(valid))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (nout + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  if (vector_path(src, out, chunk)) {
    chunk_gather_vec_kernel<<<static_cast<unsigned>(blocks), kWarps * kWarp,
                              0, s>>>(
        static_cast<const int4*>(src), static_cast<const int32_t*>(src_row),
        static_cast<const int32_t*>(valid), static_cast<int4*>(out), nout,
        nsrc, chunk);
  } else {
    chunk_gather_scalar_kernel<<<static_cast<unsigned>(blocks),
                                 kWarps * kWarp, 0, s>>>(
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(src_row),
        static_cast<const int32_t*>(valid), static_cast<int32_t*>(out), nout,
        nsrc, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
