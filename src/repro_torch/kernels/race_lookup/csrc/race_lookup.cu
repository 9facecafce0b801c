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
//
// The sharded lookup has its own kernels (the tiled and scalar ones above
// it are unchanged). At a lookup's batch sizes its time is the launch plus
// a chain of dependent loads (routing -> fingerprints -> row), not bytes,
// so it shortens the chain and keeps more loads in flight. Two routes, each
// its own C entry point (the Python wrapper's `sharded_route` picks one;
// neither falls back to the other):
//   race_lookup_sharded_byval  the routing lies on the host and NQ <= 2,032:
//       the launcher copies each query's (fingerprint, b0, b1, shard), 16
//       bytes, into the kernel's parameter block, the Hopper counterpart of
//       the TPU's scalar prefetch. No host-to-device copy, and the chain
//       starts at the fingerprints. The block is __grid_constant__, so a
//       dynamically indexed entry is read in place from the constant bank
//       and never copied to local memory. Kernel parameters may take
//       32,764 bytes since CUDA 12.1 (sm_70 and later); a ladder of
//       capacities (64 / 512 / 2,032 queries) keeps a small batch from
//       shipping 32 KiB.
//   race_lookup_sharded  the routing is on the card, packed (NQ, 4) int32
//       in the same order: one 16-byte load a query, from one host-to-device
//       copy instead of three.
// Both: two queries a warp when 2 * NSLOT <= 16 (a half-warp ballot per
// query; NSLOT 16 and 32 keep one query a warp), each lane issues all its
// 16-byte loads of the hit row before any store, and fingerprints are read
// with an L2 evict-last hint. Each entry refuses the
// other's routing: the by-value one a device pointer or NQ > 2,032, the
// device one a pointer that is not device memory.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

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

// ------------------------------------------------ the sharded lookup
constexpr int kShardWarps = 4;      // warps per block of the sharded kernels
constexpr int kByvalMax = 2032;     // most queries a by-value launch takes
constexpr int kRowBatch = 4;        // row loads a lane issues before a store

// Each query's (fingerprint, b0, b1, shard), passed by value.
template <int CAP>
struct LookupRouting {
  int4 q[CAP];
};
static_assert(sizeof(LookupRouting<kByvalMax>) + 128 <= 32764,
              "the routing block must fit CUDA 12.1's 32,764 bytes of "
              "kernel parameters");

// A group of kWidth lanes copies one row (or writes zeros when src is
// null); each lane loads up to kRowBatch units before it stores any.
template <typename T, int kWidth>
__device__ __forceinline__ void copy_row_batched(const char* __restrict__ src,
                                                 char* __restrict__ dst,
                                                 int64_t row_bytes, int sub) {
  const int64_t n = row_bytes / static_cast<int64_t>(sizeof(T));
  T* d = reinterpret_cast<T*>(dst);
  if (src == nullptr) {
    const T zero{};
    for (int64_t k = sub; k < n; k += kWidth) d[k] = zero;
    return;
  }
  const T* s = reinterpret_cast<const T*>(src);
  for (int64_t k0 = sub; k0 < n; k0 += kRowBatch * kWidth) {
    T x[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int64_t k = k0 + u * kWidth;
      if (k < n) x[u] = s[k];
    }
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int64_t k = k0 + u * kWidth;
      if (k < n) d[k] = x[u];
    }
  }
}

template <int kWidth>
__device__ __forceinline__ void copy_row_group(const char* src, char* dst,
                                               int64_t row_bytes, int unit,
                                               int sub) {
  switch (unit) {
    case 16: copy_row_batched<uint4, kWidth>(src, dst, row_bytes, sub); break;
    case 8: copy_row_batched<uint2, kWidth>(src, dst, row_bytes, sub); break;
    case 4: copy_row_batched<uint32_t, kWidth>(src, dst, row_bytes, sub); break;
    case 2: copy_row_batched<uint16_t, kWidth>(src, dst, row_bytes, sub); break;
    default: copy_row_batched<uint8_t, kWidth>(src, dst, row_bytes, sub); break;
  }
}

// An L2 cache policy that keeps lines resident ahead of others: the
// fingerprint table (16 MiB at the deployment's 4 x 131,071 x 8 slots)
// fits the card's 50 MB L2, the value rows (4 GiB) do not.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ int32_t load_evict_last(const int32_t* p,
                                                   uint64_t policy) {
  int32_t v;
  asm("ld.global.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
}

// Query i, routed by r = (fingerprint, b0, b1, shard), on a group of kWidth
// lanes: a half warp (kPair, 2 * nslot <= 16) or the whole warp. Every lane
// of the warp calls it together (the ballot); `active` is false for the
// idle half of a warp past the block's last query.
template <bool kPair>
__device__ __forceinline__ void lookup_routed(
    int4 r, bool active, int64_t i, const int32_t* __restrict__ fp,
    const char* __restrict__ val, char* __restrict__ out,
    int32_t* __restrict__ found, int64_t ns, int64_t nb, int nslot,
    int64_t row_bytes, int unit, int lane) {
  constexpr int kWidth = kPair ? kWarp / 2 : kWarp;
  const int sub = lane % kWidth;
  const int64_t base = clamp_id(r.w, ns) * nb;
  const int64_t b0 = base + clamp_id(r.y, nb);
  const int64_t b1 = base + clamp_id(r.z, nb);
  const int total = 2 * nslot;
  const uint64_t policy = evict_last_policy();
  int h = -1;
  for (int off = 0; off < total; off += kWidth) {
    const int j = off + sub;
    bool hit = false;
    if (active && j < total) {
      const int32_t f = load_evict_last(
          j < nslot ? fp + b0 * nslot + j : fp + b1 * nslot + (j - nslot),
          policy);
      hit = (f == r.x) && (f != 0);
    }
    unsigned m = __ballot_sync(kFullMask, hit);
    if (kPair) m = (m >> (lane & (kWarp / 2))) & 0xffffu;
    if (m) {
      h = off + __ffs(m) - 1;
      break;
    }
  }
  if (!active) return;
  const char* src = nullptr;
  if (h >= 0) {
    const int64_t slot = h < nslot ? b0 * nslot + h : b1 * nslot + (h - nslot);
    src = val + slot * row_bytes;
  }
  copy_row_group<kWidth>(src, out + i * row_bytes, row_bytes, unit, sub);
  if (sub == 0) found[i] = h >= 0 ? 1 : 0;
}

// qblock queries per block; group g of the block (a half warp or a warp)
// takes the block's queries g, g + groups, ... The loop steps a warp at a
// time, so both halves of a warp reach every ballot.
template <bool kPair>
__device__ __forceinline__ int64_t group_query(int64_t step, int lane) {
  return kPair ? step + lane / (kWarp / 2) : step;
}

template <bool kPair>
__global__ void __launch_bounds__(kShardWarps * kWarp)
race_lookup_sharded_kernel(const int32_t* __restrict__ fp,
                           const char* __restrict__ val,
                           const int4* __restrict__ routing,
                           char* __restrict__ out,
                           int32_t* __restrict__ found, int64_t nq,
                           int64_t ns, int64_t nb, int nslot,
                           int64_t row_bytes, int unit, int qblock) {
  constexpr int kPerWarp = kPair ? 2 : 1;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * qblock;
  const int64_t end = start + qblock < nq ? start + qblock : nq;
  for (int64_t step = start + kPerWarp * warp; step < end;
       step += kPerWarp * kShardWarps) {
    const int64_t i = group_query<kPair>(step, lane);
    const bool active = i < end;
    const int4 r = active ? routing[i] : make_int4(0, 0, 0, 0);
    lookup_routed<kPair>(r, active, i, fp, val, out, found, ns, nb, nslot,
                         row_bytes, unit, lane);
  }
}

template <bool kPair, int CAP>
__global__ void __launch_bounds__(kShardWarps * kWarp)
race_lookup_sharded_byval_kernel(
    const int32_t* __restrict__ fp, const char* __restrict__ val,
    char* __restrict__ out, int32_t* __restrict__ found, int64_t nq,
    int64_t ns, int64_t nb, int nslot, int64_t row_bytes, int unit,
    int qblock, const __grid_constant__ LookupRouting<CAP> routing) {
  constexpr int kPerWarp = kPair ? 2 : 1;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * qblock;
  const int64_t end = start + qblock < nq ? start + qblock : nq;
  for (int64_t step = start + kPerWarp * warp; step < end;
       step += kPerWarp * kShardWarps) {
    const int64_t i = group_query<kPair>(step, lane);
    const bool active = i < end;
    const int4 r = active ? routing.q[i] : make_int4(0, 0, 0, 0);
    lookup_routed<kPair>(r, active, i, fp, val, out, found, ns, nb, nslot,
                         row_bytes, unit, lane);
  }
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

// Two queries a warp when both buckets' slots fit a half warp.
bool paired(int nslot) { return 2 * nslot <= kWarp / 2; }

template <int CAP>
void launch_byval(const void* fp, const void* val, const int4* routing,
                  void* out, void* found, int64_t nq, int64_t ns, int64_t nb,
                  int nslot, int64_t row_bytes, int qblock,
                  cudaStream_t stream) {
  LookupRouting<CAP> r;
  std::memcpy(r.q, routing, sizeof(int4) * nq);
  const unsigned blocks = static_cast<unsigned>((nq + qblock - 1) / qblock);
  const int unit = copy_unit(val, out, row_bytes);
  if (paired(nslot)) {
    race_lookup_sharded_byval_kernel<true, CAP>
        <<<blocks, kShardWarps * kWarp, 0, stream>>>(
            static_cast<const int32_t*>(fp), static_cast<const char*>(val),
            static_cast<char*>(out), static_cast<int32_t*>(found), nq, ns, nb,
            nslot, row_bytes, unit, qblock, r);
  } else {
    race_lookup_sharded_byval_kernel<false, CAP>
        <<<blocks, kShardWarps * kWarp, 0, stream>>>(
            static_cast<const int32_t*>(fp), static_cast<const char*>(val),
            static_cast<char*>(out), static_cast<int32_t*>(found), nq, ns, nb,
            nslot, row_bytes, unit, qblock, r);
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

}  // namespace

// C interface (bound with ctypes). Each call launches on `stream`, does
// not synchronise, and returns cudaGetLastError(). nq >= 1 and nb >= 1:
// the Python wrappers return empty outputs for nq == 0 without a launch.
// The sharded entries return cudaErrorInvalidValue, without a launch, for
// nq < 1, qblock < 1 or routing that belongs to the other route.
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

// routing: (NQ, 4) int32 (fingerprint, b0, b1, shard) in device memory.
int race_lookup_sharded(const void* fp, const void* val, const void* routing,
                        void* out, void* found, int64_t nq, int64_t ns,
                        int64_t nb, int nslot, int64_t row_bytes, int qblock,
                        void* stream) {
  if (nq < 1 || qblock < 1 || !on_device(routing))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((nq + qblock - 1) / qblock);
  const auto s = static_cast<cudaStream_t>(stream);
  const int unit = copy_unit(val, out, row_bytes);
  if (paired(nslot)) {
    race_lookup_sharded_kernel<true><<<blocks, kShardWarps * kWarp, 0, s>>>(
        static_cast<const int32_t*>(fp), static_cast<const char*>(val),
        static_cast<const int4*>(routing), static_cast<char*>(out),
        static_cast<int32_t*>(found), nq, ns, nb, nslot, row_bytes, unit,
        qblock);
  } else {
    race_lookup_sharded_kernel<false><<<blocks, kShardWarps * kWarp, 0, s>>>(
        static_cast<const int32_t*>(fp), static_cast<const char*>(val),
        static_cast<const int4*>(routing), static_cast<char*>(out),
        static_cast<int32_t*>(found), nq, ns, nb, nslot, row_bytes, unit,
        qblock);
  }
  return static_cast<int>(cudaGetLastError());
}

// routing: the same (NQ, 4) int32 array in host memory, NQ <= 2,032. It is
// copied into the launch's parameters, so it may change once this returns.
int race_lookup_sharded_byval(const void* fp, const void* val,
                              const void* routing, void* out, void* found,
                              int64_t nq, int64_t ns, int64_t nb, int nslot,
                              int64_t row_bytes, int qblock, void* stream) {
  if (nq < 1 || nq > kByvalMax || qblock < 1 || !on_host(routing))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto r = static_cast<const int4*>(routing);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nq <= 64)
    launch_byval<64>(fp, val, r, out, found, nq, ns, nb, nslot, row_bytes,
                     qblock, s);
  else if (nq <= 512)
    launch_byval<512>(fp, val, r, out, found, nq, ns, nb, nslot, row_bytes,
                      qblock, s);
  else
    launch_byval<kByvalMax>(fp, val, r, out, found, nq, ns, nb, nslot,
                            row_bytes, qblock, s);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
