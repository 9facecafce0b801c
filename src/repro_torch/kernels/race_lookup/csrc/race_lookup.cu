// Batched RACE-hash lookup for Hopper (sm_90a): the device side of the
// paper's one-sided READ into the meta server / DrTM-KV.
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/race_lookup/race_lookup.py:
//   race_lookup_tiled    <- race_lookup_pallas_tiled   (_lookup_kernel_tiled)
//   race_lookup_scalar   <- race_lookup_pallas         (_lookup_kernel)
//   race_lookup_sharded  <- race_lookup_pallas_sharded (_lookup_kernel_sharded)
//
// Contract (all three): for query i, gather the NSLOT fingerprints of
// bucket bidx[i,0] then those of bucket bidx[i,1], take the first slot whose
// fingerprint equals queries[i] and is not 0 (0 marks an empty slot), and
// copy that slot's value row to out[i]; zeros and found[i] = 0 on a miss.
// Bucket ids are clamped to [0, NB-1], as the tiled TPU kernel's
// jnp.take(mode="clip") does. The sharded kernel offsets both tables by
// shard_idx[i] * NB (clamped to [0, NS-1]; the Python wrapper rejects ids
// outside that range before it launches).
//
// What bounds it: HBM bytes. Per query the work is 2*NSLOT 4-byte
// fingerprint loads from two random buckets and one value-row copy; there
// is no arithmetic to speak of, so the card's 3.35 TB/s (and the latency
// of dependent random loads) is the limit. The design spends nothing that
// is not bytes: one warp per query, the fingerprint compare is one
// __ballot_sync over 32 candidate slots at a time with __ffs picking the
// first hit (bucket 1 before bucket 2), and the selected row is copied
// directly with 16-byte vector loads/stores where row size and pointers
// allow it (the TPU's one-hot MXU product has no counterpart to feed here,
// so only the one row that hit is read). Values are copied as raw words,
// so every value dtype (float32, bfloat16, ...) keeps its bits.
// Overlapping one query's row copy with the next query's fingerprint loads
// (cp.async / TMA) is left for later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kTiledWarps = 8;  // warps per block of the tiled kernels

// Index of the first hit among the 2*nslot candidate slots (bucket b0's
// slots first), or -1. Uniform across the warp.
__device__ __forceinline__ int first_hit(const int32_t* __restrict__ f0,
                                         const int32_t* __restrict__ f1,
                                         int nslot, int32_t q, int lane) {
  const int total = 2 * nslot;
  for (int base = 0; base < total; base += kWarp) {
    const int j = base + lane;
    bool hit = false;
    if (j < total) {
      const int32_t f = j < nslot ? f0[j] : f1[j - nslot];
      hit = (f == q) && (f != 0);
    }
    const unsigned m = __ballot_sync(kFullMask, hit);
    if (m) return base + __ffs(m) - 1;
  }
  return -1;
}

// The warp copies one row of `row_bytes` bytes in units of T (or writes
// zeros when src is null). The caller guarantees T-alignment.
template <typename T>
__device__ __forceinline__ void copy_row(const char* __restrict__ src,
                                         char* __restrict__ dst,
                                         int64_t row_bytes, int lane) {
  const int64_t n = row_bytes / static_cast<int64_t>(sizeof(T));
  T* d = reinterpret_cast<T*>(dst);
  if (src != nullptr) {
    const T* s = reinterpret_cast<const T*>(src);
    for (int64_t k = lane; k < n; k += kWarp) d[k] = s[k];
  } else {
    const T zero{};
    for (int64_t k = lane; k < n; k += kWarp) d[k] = zero;
  }
}

__device__ __forceinline__ void copy_row_unit(const char* src, char* dst,
                                              int64_t row_bytes, int unit,
                                              int lane) {
  switch (unit) {
    case 16: copy_row<uint4>(src, dst, row_bytes, lane); break;
    case 8: copy_row<uint2>(src, dst, row_bytes, lane); break;
    case 4: copy_row<uint32_t>(src, dst, row_bytes, lane); break;
    case 2: copy_row<uint16_t>(src, dst, row_bytes, lane); break;
    default: copy_row<uint8_t>(src, dst, row_bytes, lane); break;
  }
}

__device__ __forceinline__ int64_t clamp_id(int32_t v, int64_t n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// One query, one warp. `table_base` is the first bucket of the query's
// shard (0 for an unsharded table).
__device__ __forceinline__ void lookup_one(
    const int32_t* __restrict__ fp, const char* __restrict__ val,
    const int32_t* __restrict__ queries, const int32_t* __restrict__ bidx,
    char* __restrict__ out, int32_t* __restrict__ found, int64_t i,
    int64_t table_base, int64_t nb, int nslot, int64_t row_bytes, int unit,
    int lane) {
  const int32_t q = queries[i];
  const int64_t b0 = table_base + clamp_id(bidx[2 * i], nb);
  const int64_t b1 = table_base + clamp_id(bidx[2 * i + 1], nb);
  const int h = first_hit(fp + b0 * nslot, fp + b1 * nslot, nslot, q, lane);
  const char* src = nullptr;
  if (h >= 0) {
    const int64_t slot = h < nslot ? b0 * nslot + h : b1 * nslot + (h - nslot);
    src = val + slot * row_bytes;
  }
  copy_row_unit(src, out + i * row_bytes, row_bytes, unit, lane);
  if (lane == 0) found[i] = h >= 0 ? 1 : 0;
}

// qblock queries per block; each of the block's warps takes every
// kTiledWarps-th query of the block's tile. shard_idx is null when unsharded.
__device__ __forceinline__ void lookup_tile(
    const int32_t* fp, const char* val, const int32_t* queries,
    const int32_t* bidx, const int32_t* shard_idx, char* out, int32_t* found,
    int64_t nq, int64_t ns, int64_t nb, int nslot, int64_t row_bytes,
    int unit, int qblock) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * qblock;
  const int64_t end = start + qblock < nq ? start + qblock : nq;
  for (int64_t i = start + warp; i < end; i += kTiledWarps) {
    const int64_t base = shard_idx ? clamp_id(shard_idx[i], ns) * nb : 0;
    lookup_one(fp, val, queries, bidx, out, found, i, base, nb, nslot,
               row_bytes, unit, lane);
  }
}

__global__ void __launch_bounds__(kTiledWarps * kWarp)
race_lookup_tiled_kernel(const int32_t* __restrict__ fp,
                         const char* __restrict__ val,
                         const int32_t* __restrict__ queries,
                         const int32_t* __restrict__ bidx,
                         char* __restrict__ out, int32_t* __restrict__ found,
                         int64_t nq, int64_t nb, int nslot, int64_t row_bytes,
                         int unit, int qblock) {
  lookup_tile(fp, val, queries, bidx, nullptr, out, found, nq, 1, nb, nslot,
              row_bytes, unit, qblock);
}

__global__ void __launch_bounds__(kTiledWarps * kWarp)
race_lookup_sharded_kernel(const int32_t* __restrict__ fp,
                           const char* __restrict__ val,
                           const int32_t* __restrict__ queries,
                           const int32_t* __restrict__ bidx,
                           const int32_t* __restrict__ shard_idx,
                           char* __restrict__ out,
                           int32_t* __restrict__ found, int64_t nq,
                           int64_t ns, int64_t nb, int nslot,
                           int64_t row_bytes, int unit, int qblock) {
  lookup_tile(fp, val, queries, bidx, shard_idx, out, found, nq, ns, nb,
              nslot, row_bytes, unit, qblock);
}

// One block of one warp per query (grid = NQ): the per-query layout of the
// TPU's scalar-prefetch baseline.
__global__ void __launch_bounds__(kWarp)
race_lookup_scalar_kernel(const int32_t* __restrict__ fp,
                          const char* __restrict__ val,
                          const int32_t* __restrict__ queries,
                          const int32_t* __restrict__ bidx,
                          char* __restrict__ out, int32_t* __restrict__ found,
                          int64_t nb, int nslot, int64_t row_bytes, int unit) {
  lookup_one(fp, val, queries, bidx, out, found, blockIdx.x, 0, nb, nslot,
             row_bytes, unit, threadIdx.x);
}

// Widest copy unit that divides the row size and both base addresses.
int copy_unit(const void* val, const void* out, int64_t row_bytes) {
  const uint64_t bits = reinterpret_cast<uintptr_t>(val) |
                        reinterpret_cast<uintptr_t>(out) |
                        static_cast<uint64_t>(row_bytes);
  for (int unit = 16; unit > 1; unit /= 2)
    if (bits % unit == 0) return unit;
  return 1;
}

}  // namespace

// C interface (bound with ctypes). Each call launches on `stream`, does
// not synchronise, and returns cudaGetLastError(). nq >= 1 and nb >= 1:
// the Python wrappers return empty outputs for nq == 0 without a launch.
extern "C" {

int race_lookup_tiled(const void* fp, const void* val, const void* queries,
                      const void* bidx, void* out, void* found, int64_t nq,
                      int64_t nb, int nslot, int64_t row_bytes, int qblock,
                      void* stream) {
  const int64_t blocks = (nq + qblock - 1) / qblock;
  race_lookup_tiled_kernel<<<static_cast<unsigned>(blocks),
                             kTiledWarps * kWarp, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fp), static_cast<const char*>(val),
      static_cast<const int32_t*>(queries), static_cast<const int32_t*>(bidx),
      static_cast<char*>(out), static_cast<int32_t*>(found), nq, nb, nslot,
      row_bytes, copy_unit(val, out, row_bytes), qblock);
  return static_cast<int>(cudaGetLastError());
}

int race_lookup_scalar(const void* fp, const void* val, const void* queries,
                       const void* bidx, void* out, void* found, int64_t nq,
                       int64_t nb, int nslot, int64_t row_bytes,
                       void* stream) {
  race_lookup_scalar_kernel<<<static_cast<unsigned>(nq), kWarp, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fp), static_cast<const char*>(val),
      static_cast<const int32_t*>(queries), static_cast<const int32_t*>(bidx),
      static_cast<char*>(out), static_cast<int32_t*>(found), nb, nslot,
      row_bytes, copy_unit(val, out, row_bytes));
  return static_cast<int>(cudaGetLastError());
}

int race_lookup_sharded(const void* fp, const void* val, const void* queries,
                        const void* bidx, const void* shard_idx, void* out,
                        void* found, int64_t nq, int64_t ns, int64_t nb,
                        int nslot, int64_t row_bytes, int qblock,
                        void* stream) {
  const int64_t blocks = (nq + qblock - 1) / qblock;
  race_lookup_sharded_kernel<<<static_cast<unsigned>(blocks),
                               kTiledWarps * kWarp, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fp), static_cast<const char*>(val),
      static_cast<const int32_t*>(queries), static_cast<const int32_t*>(bidx),
      static_cast<const int32_t*>(shard_idx), static_cast<char*>(out),
      static_cast<int32_t*>(found), nq, ns, nb, nslot, row_bytes,
      copy_unit(val, out, row_bytes), qblock);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
