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

#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue,
// without a launch, for nout < 1, nsrc < 1 or chunk < 1).
extern "C" {

int chunk_gather(const void* src, const void* src_row, const void* valid,
                 void* out, int64_t nout, int64_t nsrc, int chunk,
                 void* stream) {
  if (nout < 1 || nsrc < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (nout + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  if (chunk % 4 == 0 && bits % 16 == 0) {
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
