// Batched RACE-hash lookup for Hopper (sm_90a): the device side of the
// paper's one-sided READ into the meta server / DrTM-KV.
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/race_lookup/race_lookup.py:
//   race_lookup_tiled[_byval]    <- race_lookup_pallas_tiled   (_lookup_kernel_tiled)
//   race_lookup_scalar[_byval]   <- race_lookup_pallas         (_lookup_kernel)
//   race_lookup_sharded[_byval]  <- race_lookup_pallas_sharded (_lookup_kernel_sharded)
//
// Contract (all three): query i is routed by four int32 words (fingerprint,
// b0, b1, w). Gather the NSLOT fingerprints of bucket b0 then those of
// bucket b1, take the first slot whose fingerprint equals the query's and
// is not 0 (0 marks an empty slot), and copy that slot's value row to the
// output; zeros and found = 0 on a miss. Bucket ids are clamped to
// [0, NB-1], as the tiled TPU kernel's jnp.take(mode="clip") does. The
// sharded kernel reads w as the query's shard and offsets both tables by
// w * NB (w clamped to [0, NS-1]; the Python wrapper rejects ids outside
// that range before it launches) and writes output row i. The tiled kernel
// is the sharded one at NS = 1, where w is clamped to 0. The scalar kernel
// reads w as the output row (i for a whole batch; a shard's call writes
// its queries' rows of the batch's output) and skips rows outside [0, nout).
// Values are copied as raw words, so every value dtype (float32, bfloat16,
// ...) keeps its bits.
//
// What bounds it: at a lookup's batch sizes, the launch plus a chain of
// dependent loads (routing -> fingerprints -> row), not the bytes (the
// bound is 0.04-2.1 us at 3.35 TB/s; the TPU's one-hot MXU product has no
// counterpart to feed here, so only the one row that hit is read). One
// design shortens that chain and keeps more loads in flight:
//   - Routing by value. Where the routing lies on the host and NQ <= 2,032,
//     the launcher copies each query's 16 bytes into the kernel's parameter
//     block, the Hopper counterpart of the TPU's scalar prefetch: no
//     host-to-device copy, and the chain starts at the fingerprints. The
//     block is __grid_constant__, so a dynamically indexed entry is read in
//     place from the constant bank and never copied to local memory. Kernel
//     parameters may take 32,764 bytes since CUDA 12.1 (sm_70 and later); a
//     ladder of capacities (64 / 512 / 2,032 queries) keeps a small batch
//     from shipping 32 KiB. Otherwise the routing is one (NQ, 4) int32 array
//     on the card: one 16-byte load a query, from at most one copy.
//   - Each lane issues all its 16-byte loads of the hit row before any
//     store, and fingerprints are read with an L2 evict-last hint.
//   - The tiled and sharded kernels run qblock queries a block of 4 warps,
//     two queries a warp when 2 * NSLOT <= 16 (a half-warp ballot each;
//     NSLOT 16 and 32 keep one query a warp). The scalar kernel keeps the
//     TPU scalar kernel's layout, one query a block of one warp, which is
//     what sets it apart.
// Each kernel has two C entry points, one a route: *_byval (routing in host
// memory, NQ <= 2,032) and the plain name (routing in device memory, any
// NQ). Each refuses the other's routing: the by-value one a device pointer
// or NQ > 2,032, the device one a pointer that is not device memory. The
// Python wrapper's `route` picks one; neither falls back to the other.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

__device__ __forceinline__ int64_t clamp_id(int32_t v, int64_t n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
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

// ------------------------------------------------ the scalar lookup
// One query a block of one warp (grid = NQ): the layout of the TPU's
// scalar-prefetch kernel. r.w is the output row; the whole warp skips a
// row outside [0, nout).
__device__ __forceinline__ void scalar_query(
    int4 r, const int32_t* __restrict__ fp, const char* __restrict__ val,
    char* __restrict__ out, int32_t* __restrict__ found, int64_t nout,
    int64_t nb, int nslot, int64_t row_bytes, int unit) {
  if (r.w < 0 || r.w >= nout) return;
  lookup_routed<false>(r, true, r.w, fp, val, out, found, 1, nb, nslot,
                       row_bytes, unit, threadIdx.x);
}

__global__ void __launch_bounds__(kWarp)
race_lookup_scalar_kernel(const int32_t* __restrict__ fp,
                          const char* __restrict__ val,
                          const int4* __restrict__ routing,
                          char* __restrict__ out, int32_t* __restrict__ found,
                          int64_t nout, int64_t nb, int nslot,
                          int64_t row_bytes, int unit) {
  scalar_query(routing[blockIdx.x], fp, val, out, found, nout, nb, nslot,
               row_bytes, unit);
}

template <int CAP>
__global__ void __launch_bounds__(kWarp)
race_lookup_scalar_byval_kernel(
    const int32_t* __restrict__ fp, const char* __restrict__ val,
    char* __restrict__ out, int32_t* __restrict__ found, int64_t nout,
    int64_t nb, int nslot, int64_t row_bytes, int unit,
    const __grid_constant__ LookupRouting<CAP> routing) {
  scalar_query(routing.q[blockIdx.x], fp, val, out, found, nout, nb, nslot,
               row_bytes, unit);
}

// ------------------------------------------------ launchers (host)
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

// Calls launch(std::integral_constant<int, CAP>) with the smallest rung of
// the capacity ladder that holds nq queries.
template <typename Launch>
void by_capacity(int64_t nq, Launch launch) {
  if (nq <= 64)
    launch(std::integral_constant<int, 64>());
  else if (nq <= 512)
    launch(std::integral_constant<int, 512>());
  else
    launch(std::integral_constant<int, kByvalMax>());
}

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

void launch_device(const void* fp, const void* val, const void* routing,
                   void* out, void* found, int64_t nq, int64_t ns, int64_t nb,
                   int nslot, int64_t row_bytes, int qblock,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((nq + qblock - 1) / qblock);
  const int unit = copy_unit(val, out, row_bytes);
  if (paired(nslot)) {
    race_lookup_sharded_kernel<true><<<blocks, kShardWarps * kWarp, 0,
                                       stream>>>(
        static_cast<const int32_t*>(fp), static_cast<const char*>(val),
        static_cast<const int4*>(routing), static_cast<char*>(out),
        static_cast<int32_t*>(found), nq, ns, nb, nslot, row_bytes, unit,
        qblock);
  } else {
    race_lookup_sharded_kernel<false><<<blocks, kShardWarps * kWarp, 0,
                                        stream>>>(
        static_cast<const int32_t*>(fp), static_cast<const char*>(val),
        static_cast<const int4*>(routing), static_cast<char*>(out),
        static_cast<int32_t*>(found), nq, ns, nb, nslot, row_bytes, unit,
        qblock);
  }
}

template <int CAP>
void launch_scalar_byval(const void* fp, const void* val, const int4* routing,
                         void* out, void* found, int64_t nq, int64_t nout,
                         int64_t nb, int nslot, int64_t row_bytes,
                         cudaStream_t stream) {
  LookupRouting<CAP> r;
  std::memcpy(r.q, routing, sizeof(int4) * nq);
  race_lookup_scalar_byval_kernel<CAP>
      <<<static_cast<unsigned>(nq), kWarp, 0, stream>>>(
          static_cast<const int32_t*>(fp), static_cast<const char*>(val),
          static_cast<char*>(out), static_cast<int32_t*>(found), nout, nb,
          nslot, row_bytes, copy_unit(val, out, row_bytes), r);
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

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// C interface (bound with ctypes). Each call launches on `stream`, does
// not synchronise, and returns cudaGetLastError(). routing is (NQ, 4) int32,
// a query a row: in device memory for the plain names, in host memory with
// NQ <= 2,032 for the *_byval ones (copied into the launch's parameters, so
// it may change once the call returns). Each entry returns
// cudaErrorInvalidValue, without a launch, for nq < 1, qblock < 1 or
// routing that belongs to the other route. nb >= 1: the Python wrappers
// check the tables, and return empty outputs for nq == 0 without a launch.
extern "C" {

// routing rows (fingerprint, b0, b1, shard) over (NS, NB, NSLOT) tables.
int race_lookup_sharded(const void* fp, const void* val, const void* routing,
                        void* out, void* found, int64_t nq, int64_t ns,
                        int64_t nb, int nslot, int64_t row_bytes, int qblock,
                        void* stream) {
  if (nq < 1 || qblock < 1 || !on_device(routing)) return invalid();
  launch_device(fp, val, routing, out, found, nq, ns, nb, nslot, row_bytes,
                qblock, static_cast<cudaStream_t>(stream));
  return last_error();
}

int race_lookup_sharded_byval(const void* fp, const void* val,
                              const void* routing, void* out, void* found,
                              int64_t nq, int64_t ns, int64_t nb, int nslot,
                              int64_t row_bytes, int qblock, void* stream) {
  if (nq < 1 || nq > kByvalMax || qblock < 1 || !on_host(routing))
    return invalid();
  by_capacity(nq, [&](auto cap) {
    launch_byval<decltype(cap)::value>(
        fp, val, static_cast<const int4*>(routing), out, found, nq, ns, nb,
        nslot, row_bytes, qblock, static_cast<cudaStream_t>(stream));
  });
  return last_error();
}

// routing rows (fingerprint, b0, b1, 0) over one (NB, NSLOT) table: the
// sharded kernels at NS = 1.
int race_lookup_tiled(const void* fp, const void* val, const void* routing,
                      void* out, void* found, int64_t nq, int64_t nb,
                      int nslot, int64_t row_bytes, int qblock, void* stream) {
  return race_lookup_sharded(fp, val, routing, out, found, nq, 1, nb, nslot,
                             row_bytes, qblock, stream);
}

int race_lookup_tiled_byval(const void* fp, const void* val,
                            const void* routing, void* out, void* found,
                            int64_t nq, int64_t nb, int nslot,
                            int64_t row_bytes, int qblock, void* stream) {
  return race_lookup_sharded_byval(fp, val, routing, out, found, nq, 1, nb,
                                   nslot, row_bytes, qblock, stream);
}

// routing rows (fingerprint, b0, b1, output row) over one (NB, NSLOT) table;
// out has nout rows.
int race_lookup_scalar(const void* fp, const void* val, const void* routing,
                       void* out, void* found, int64_t nq, int64_t nout,
                       int64_t nb, int nslot, int64_t row_bytes,
                       void* stream) {
  if (nq < 1 || !on_device(routing)) return invalid();
  race_lookup_scalar_kernel<<<static_cast<unsigned>(nq), kWarp, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fp), static_cast<const char*>(val),
      static_cast<const int4*>(routing), static_cast<char*>(out),
      static_cast<int32_t*>(found), nout, nb, nslot, row_bytes,
      copy_unit(val, out, row_bytes));
  return last_error();
}

int race_lookup_scalar_byval(const void* fp, const void* val,
                             const void* routing, void* out, void* found,
                             int64_t nq, int64_t nout, int64_t nb, int nslot,
                             int64_t row_bytes, void* stream) {
  if (nq < 1 || nq > kByvalMax || !on_host(routing)) return invalid();
  by_capacity(nq, [&](auto cap) {
    launch_scalar_byval<decltype(cap)::value>(
        fp, val, static_cast<const int4*>(routing), out, found, nq, nout, nb,
        nslot, row_bytes, static_cast<cudaStream_t>(stream));
  });
  return last_error();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
