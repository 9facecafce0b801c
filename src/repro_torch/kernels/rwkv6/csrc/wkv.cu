// Chunked RWKV-6 WKV scan with data-dependent decay on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rwkv6/rwkv6.py:
//   wkv_split, wkv  <- wkv_pallas (_wkv_kernel)
//
// Contract: r, k, logw (B, H, S, dk); v (B, H, S, dv); u (H, dk) float32;
// an optional initial state (B, H, dk, dv) float32 (zero when absent, as in
// the Pallas kernel and the model's prefill). r, k and v share one dtype
// (float32 or bfloat16), logw has its own (the model's is float32: its
// float32 decay_base promotes the bfloat16 projection). Everything is
// computed in float32. Per chunk of C <= 16 tokens (models/rwkv6.py):
//   Lx  = inclusive cumulative sum of logw down each column, Lex = Lx - logw
//   o   = (r e^{Lex}) S  +  tril((r e^{Lex}) (k e^{-Lx})^T, -1) v
//         + (sum_j r u k) v
//   S   = S e^{L_C} + (k e^{L_C - Lx})^T v
// o is written in r's dtype; the final state in float32. S must be a
// multiple of C (the wrapper raises otherwise); dk, dv <= 64.
//
// The factorised decay reaches e^{+-68} with logw clamped at -4.25 and
// C = 16: that is only safe in float32 and with C <= 16, so the kernel keeps
// both.
//
// One design, two instantiations, each its own C entry point and kernel,
// chosen by shape; both read r, k, v and logw through their strides (the
// last dimension contiguous), so the model's head-transposed views go in
// without copies:
//
// wkv_split (wkv_split_kernel): dk = dv = 64, C = 16, rwkv6-7b's heads over
// any S that is a multiple of 16, with every shape known when compiled.
//
// wkv (wkv_kernel, the masked instantiation): every other shape, dk and dv
// from 1 to 64 and C = min(chunk, S) from 1 to 16 (rwkv6-7b's prompts of
// 1-15 tokens, a caller's chunk below 16, other heads). A head runs on the
// same 64 x 64 x 16 tile, padded with zeros, which is exact for this scan:
// zero columns of r, k and u add nothing to the scores, to r_dec S or to
// the bonus; zero rows of k and v with a zero logw (decay e^0 = 1) leave
// the state as it was and give rows of o that are never stored; zero
// columns of v give columns of o and of S that are never stored; rows of
// the state past dk start at zero and stay there. TMA writes the padding:
// 5-d tensor maps of (d, t, chunk, h, b) with sizes (dk or dv, C, S / C, H,
// B) and the views' strides fill whatever of a 64 x 16 box lies outside the
// tensor with zeros, and the plain loads write the same zeros. Chunk
// boundaries stay at multiples of C, as the reference scan puts them, and
// where C < 16 each step is a 16-row step with 16 - C rows of zeros. Only
// the dk x dv corner of the state and the C x dv rows of o are stored; the
// final state goes through shared memory and out as 16-byte vectors.
//
// What bounds it on this card: at rwkv6-7b's prefill shape (B = 4, H = 64,
// S = 512, bf16 r/k/v, float32 logw) the scan moves 104,873,984 bytes
// (0.0313 ms at 3.35 TB/s) and does 2,533,359,616 float32 operations. Of
// these the products, 2,399,141,888, take 0.0145 ms as three TF32 passes
// on the tensor cores' 495 TFLOP/s, and the rest 0.0020 ms on the CUDA
// cores' 67 TFLOP/s (all of them there: 0.0378 ms). With the products on
// the tensor cores the bytes bound it. The state (16 KB a head) outweighs
// a chunk's input (~10 KB), so it never leaves the chip: the recurrence
// walks S / 16 chunks in order inside one CTA a head, and what the design
// shortens is each chunk's step on that sequential path, and the
// instructions a chunk costs the SM. Measured on an NVIDIA H100 80GB HBM3
// at 700 W: 0.0638 ms at that shape by chip_smoke.py, 2.04x the bytes
// bound; the two-CTAs-a-head CUDA-core kernel this design replaced took
// 0.2326 ms there, in turns with it in tools/wkv_variants.py.
//
// The design: one CTA of three warpgroups a head (B * H CTAs, two an SM:
// 256 CTAs at B = 4 are one wave on 132 SMs; at B = 1, 64 SMs run one each,
// each several times faster than the two CTAs a head of the kernel it
// replaced, which repeated a head's prep in both). Joined by mbarrier rings
// in shared memory:
// - two prep warpgroups take turns by chunk and do everything that does
//   not depend on the state, for chunks ahead of the state warps. Thread 0
//   of each copies its group's next chunk of r, k, logw and v by TMA (4-d
//   tensor maps of (d, s, h, b) with the views' own strides, boxes of
//   64 x 16) into the group's raw stage as soon as the group has read it; a
//   view that TMA cannot describe (a stride or a base not a multiple of 16
//   bytes) is copied by the group's own loads into the same bytes. The
//   group then computes the cumulative log-decay (each thread one column,
//   summed down all 16 rows in base 2), r_dec = r e^{Lex}, k_inc =
//   k e^{-Lx}, k_fin = k_inc e^{L_C} and e^{L_C} (one ex2 a factor), the
//   bonus sum_j r u k (a reduce-scatter of shuffles), and the scores
//   r_dec k_inc^T (each warp a quarter, mma.sync.m16n8k8), into one of 3
//   prepared stages;
// - the state warpgroup holds S^T as the 64 x 64 accumulator of wgmma, 16
//   value columns a warp (32 registers a thread), and per chunk does only
//   o^T = S^T r_dec^T + v^T att^T (mma.sync.m16n8k8; the two halves of the
//   scores added, masked and given the bonus as they are read) and
//   S^T = S^T e^{L_C} + v^T k_fin (wgmma.m64n64k8, k_fin written by the
//   prep in the no-swizzle K-major layout that its descriptor names). The
//   state's accumulator fragment is the A operand of the output's product
//   as it is: every product permutes its depth (k-slot q holds depth 2q,
//   k-slot q + 4 depth 2q + 1) in A and B alike.
// setmaxnreg moves registers from the prep warps (64) to the state warps
// (112), so that two CTAs of 384 threads fit an SM.
// Every product (the scores, r_dec S, att v, k_fin^T v) runs in TF32 with
// each operand split into a high and a low TF32 part (hi hi + hi lo +
// lo hi, float32 accumulators): about float32's accuracy (each product
// within ~2^-20 of float32's); one TF32 pass would round each operand to
// 11 bits and misses the reference tolerance at the -4.25 decay clamp
// (tests/test_torch_wkv.py). A bfloat16 v is exact in TF32, so att v and
// k_fin^T v drop the pass of v's (zero) low part. Each thread's
// accumulators are summed in one fixed order and no atomics are used, so
// a view and its contiguous copy give the same bits. The arrays the
// fragments read are padded so that each load hits 32 distinct banks.
//
// At rwkv6-7b's heads over an 8-token prompt (B = 4, H = 64, C = 8) a call
// is one step a head: the bound is the bytes, 5,783,552 (0.0017 ms, mostly
// the 4 MiB final state), and the time is the launch, one load -> prep ->
// state step and the state's store. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W, in turns in tools/wkv_variants.py: 0.0065 ms, 3.8x the bound; the
// one-CTA-a-head scalar scan this instantiation replaced took 0.0156 ms.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ----------------------------- the tile: dk = dv = 64, chunk 16 at most
constexpr int kDK = 64;  // key width (dk)
constexpr int kDV = 64;  // value width (dv)
constexpr int kC = 16;   // chunk
constexpr int kPrepGroups = 2;  // warpgroups of prep, taking turns by chunk
constexpr int kPrepWarps = 4;   // a prep group's
constexpr int kStateWarps = 4;
constexpr int kPrepThreads = 32 * kPrepWarps;
// two prep warpgroups (thread 0 of each the producer of its chunks) and a
// state warpgroup
constexpr int kSplitThreads = 32 * (kPrepGroups * kPrepWarps + kStateWarps);
constexpr int kSplitCtas = 2;  // CTAs an SM
// registers a thread after setmaxnreg: at two CTAs an SM a CTA's 384
// threads start with 80, and 2 x 128 x 64 + 128 x 112 = 384 x 80
constexpr int kPrepRegs = 64;
constexpr int kStateRegs = 112;
// stages of raw chunks (one a prep group's) and of prepared chunks: as many
// as two CTAs an SM leave room for at float32 r/k/v
constexpr int kNS = kPrepGroups;
constexpr int kNP = 3;
// row strides (floats) of the prepared arrays, chosen so that every
// fragment load below hits 32 distinct banks: r_dec and k_inc are read as
// float2 (8 rows x 4 lanes a half-warp), v as one float (4 rows x 8 lanes a
// warp), att as float2
constexpr int kRS = kDK + 8;
constexpr int kKS = kDV + 4;
constexpr int kAS = kC + 8;
// row stride (floats) of the final state in shared memory (the masked
// instantiation's store): each fragment store hits 32 distinct banks
constexpr int kSS = kDV + 4;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kStateWarps * 16 == kDV && kPrepThreads == 2 * kDK &&
                  kDK == 64 && kC == 16 && kNS % kPrepGroups == 0 &&
                  kPrepRegs * kPrepGroups * kPrepThreads +
                          kStateRegs * 32 * kStateWarps <=
                      65536 / kSplitCtas,
              "the warp roles below assume these shapes");

struct SplitParams {
  const void* r;
  const void* k;
  const void* v;
  const void* logw;
  const float* u;
  const float* state_in;  // null: zero
  void* o;
  float* state_out;
  // element strides of b, h, s (the last dimension is contiguous)
  int64_t r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t w_sb, w_sh, w_ss;
  int H, S;
  int dk, dv, C;  // the masked instantiation's shape (split: 64, 64, 16)
};

// The tensor maps of r, k, logw and v, boxes of 64 columns x 16 rows (one
// chunk of one head): 4-d, (d, s, h, b) with the views' strides (split);
// 5-d, (d, t, chunk, h, b), zero-filled past dk or dv and past C (masked)
struct SplitMaps {
  CUtensorMap r, k, w, v;
};

// one chunk's inputs as they lie in HBM, dense rows (TMA's boxes)
template <typename T, typename TW>
struct RawStage {
  alignas(128) T r[kC * kDK];
  alignas(128) T k[kC * kDK];
  alignas(128) TW w[kC * kDK];
  alignas(128) T v[kC * kDV];
};

// one chunk after a prep group, float32: what the state warps read, and
// k_inc, which only the scores read
struct alignas(128) PrepStage {
  float rdec[kC][kRS];  // r e^{Lex}
  float kinc[kC][kRS];  // k e^{-Lx}
  // k e^{L_C - Lx}, wgmma's B operand of the state update, split into its
  // TF32 high and low parts: [part][k-step of 8 tokens][group of 8 columns]
  // [half of the k-step][column % 8][4 tokens], the no-swizzle K-major
  // layout of 8 x 16-byte core matrices, its tokens in the products' k-slot
  // order (half 0: tokens 0, 2, 4, 6; half 1: tokens 1, 3, 5, 7)
  alignas(128) float kfin[2][2][kDK / 8][2][8][4];
  float vf[kC][kKS];        // v
  float attp[2][kC][kAS];  // r_dec k_inc^T over each half of the columns
  float elc[kDK];          // e^{L_C}
  float bonus[2][kC];      // sum_j r u k of each half of the columns
};

template <typename T, typename TW>
struct SplitSmem {
  RawStage<T, TW> raw[kNS];
  PrepStage prep[kNP];
  // full: the chunk is in place; empty: its readers are done with it
  uint64_t raw_full[kNS], prep_full[kNP], prep_empty[kNP];
  // this CTA's head in r, k, logw and v, for the plain loads of views that
  // TMA cannot describe (read from here, and not held in registers)
  const unsigned char* head[4];
};
// with room to align the dynamic shared memory to 128 bytes (TMA's boxes);
// two CTAs, each with its 1 KB the system reserves, fit an SM's 228 KB
static_assert(sizeof(float) * kDK * kSS <= sizeof(PrepStage),
              "the masked instantiation's final state fits a prepared stage");
template <typename T, typename TW>
constexpr int split_smem_bytes() {
  static_assert(kSplitCtas * (sizeof(SplitSmem<T, TW>) + 128 + 1024) <=
                    233472,
                "two CTAs an SM");
  return static_cast<int>(sizeof(SplitSmem<T, TW>)) + 128;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// until the phase of `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}
// the same from a 5-d map (the masked instantiation's)
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// x = hi + lo in two TF32 values (the low 13 bits zero, so the tensor cores
// read them as they are): hi keeps x's top 11 significant bits, lo the next
// 11 of the exact remainder x - hi
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
// d += a b, one m16n8k8 TF32 product with float32 accumulators. Fragments
// (g = lane / 4, q = lane % 4): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4),
// a3 (g + 8, q + 4); b0 (q, g), b1 (q + 4, g); d0 (g, 2q), d1 (g, 2q + 1),
// d2 (g + 8, 2q), d3 (g + 8, 2q + 1). Every product below permutes its
// depth the same way in A and B, k-slot q holding depth 2q and k-slot q + 4
// depth 2q + 1, so that a thread's two depths are neighbours (float2
// loads) and the state's accumulator fragment is its A fragment as it is.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// A wgmma descriptor of one k-step of k_fin: no swizzle, the two halves of
// the k-step 128 bytes apart (leading byte offset), groups of 8 columns 256
// bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t kfin_desc(const float* b) {
  const uint32_t addr = smem_addr(b);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(128 >> 4) << 16 |
         static_cast<uint64_t>(256 >> 4) << 32;
}
// d (the warpgroup's 64 x 64 float32 accumulator, each warp's 16 rows as
// eight m16n8 fragments) += A B: A (64 x 8) TF32 in registers, each warp's
// m16n8k8 A fragment of its 16 rows; B (8 x 64) TF32 in shared memory,
// K-major, named by a descriptor
__device__ __forceinline__ void wgmma_tf32(float (&d)[kDK / 8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// Registers that an asynchronous wgmma reads or writes: the compiler keeps
// them in place and moves no access to them across this point
__device__ __forceinline__ void reg_fence(float (&r)[kDK / 8][4]) {
#pragma unroll
  for (int i = 0; i < kDK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}
__device__ __forceinline__ void split2(float2 x, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  split_tf32(x.x, hi[0], lo[0]);
  split_tf32(x.y, hi[1], lo[1]);
}

// One step of a reduce-scatter across the lanes that differ in `BIT`: the
// lane keeps the half of its W live values that its bit selects, adds its
// partner's copy of that half, and leaves the sums in part[0..W/2).
template <int W, int BIT>
__device__ __forceinline__ void reduce_scatter_step(float (&part)[8],
                                                    int lane_id) {
  const bool up = (lane_id & BIT) != 0;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float send = up ? part[i] : part[i + W / 2];
    const float keep = up ? part[i + W / 2] : part[i];
    part[i] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
}

// The scan of one head a CTA; kMasked: the masked instantiation (any
// dk, dv <= 64 and C <= 16 on the padded tile), else the split one
template <typename T, typename TW, bool kMasked>
__device__ __forceinline__ void wkv_scan(const SplitMaps& maps,
                                         const SplitParams& p, int tma) {
  // a bfloat16 v is exact in TF32: its low halves are 0, and the products
  // of v drop the pass that would multiply them
  constexpr bool kVExact = sizeof(T) == 2;
  constexpr uint32_t kRawBytes = kC * (kDK * (2 * sizeof(T) + sizeof(TW)) +
                                        kDV * sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<SplitSmem<T, TW>*>(
      smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t bh = blockIdx.x;
  const int b = static_cast<int>(bh / p.H), h = static_cast<int>(bh % p.H);
  const int nch = kMasked ? p.S / p.C : p.S / kC;

  if (tid == 0) {
    for (int st = 0; st < kNS; ++st) mbar_init(&sm.raw_full[st], 1);
    for (int st = 0; st < kNP; ++st) {
      mbar_init(&sm.prep_full[st], kPrepThreads);
      mbar_init(&sm.prep_empty[st], kStateWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int64_t es = sizeof(T), ws = sizeof(TW);
    sm.head[0] = static_cast<const unsigned char*>(p.r) +
                 (b * p.r_sb + h * p.r_sh) * es;
    sm.head[1] = static_cast<const unsigned char*>(p.k) +
                 (b * p.k_sb + h * p.k_sh) * es;
    sm.head[2] = static_cast<const unsigned char*>(p.logw) +
                 (b * p.w_sb + h * p.w_sh) * ws;
    sm.head[3] = static_cast<const unsigned char*>(p.v) +
                 (b * p.v_sb + h * p.v_sh) * es;
  }
  __syncthreads();

  const int g = lane / 4, q = lane % 4;  // fragment coordinates

  if (warp < kPrepGroups * kPrepWarps) {
    // ---- prep: everything that does not depend on the state, for chunks
    // ahead of the state warps; group grp takes chunks grp, grp + 2, ....
    // Thread (j, hf) owns column j of rows 8 hf..8 hf + 7: it sums the
    // column's log-decay down all 16 rows (the same sums in both halves),
    // and writes r_dec, k_inc, k_fin and v of its rows. Then each warp of
    // the group sums a quarter of the scores. Thread 0 of the group is its
    // producer: the group's next chunk, ci + kNS, goes by TMA into chunk
    // ci's raw stage as soon as the group has read it. A view that TMA
    // cannot describe is copied chunk by chunk by the group's own loads,
    // into the same bytes.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kPrepRegs));
    const int grp = warp / kPrepWarps, pt = tid % kPrepThreads;
    const int pw = pt / 32;
    const int j = lane + 32 * (pw & 1), hf = pw >> 1;
    auto issue = [&](int ci) {
      RawStage<T, TW>& rs = sm.raw[ci % kNS];
      uint64_t* full = &sm.raw_full[ci % kNS];
      // the masked maps' boxes are whole too: TMA writes (and counts) the
      // zeros that fill whatever of a box lies outside the tensor
      mbar_expect_tx(full, kRawBytes);
      if constexpr (kMasked) {
        tma_load5(rs.r, &maps.r, 0, 0, ci, h, b, full);
        tma_load5(rs.k, &maps.k, 0, 0, ci, h, b, full);
        tma_load5(rs.w, &maps.w, 0, 0, ci, h, b, full);
        tma_load5(rs.v, &maps.v, 0, 0, ci, h, b, full);
      } else {
        tma_load(rs.r, &maps.r, 0, ci * kC, h, b, full);
        tma_load(rs.k, &maps.k, 0, ci * kC, h, b, full);
        tma_load(rs.w, &maps.w, 0, ci * kC, h, b, full);
        tma_load(rs.v, &maps.v, 0, ci * kC, h, b, full);
      }
    };
    if (tma && pt == 0)
      for (int ci = grp; ci < kNS && ci < nch; ci += kPrepGroups) issue(ci);
    const float uj = !kMasked ? p.u[h * kDK + j]
                     : j < p.dk ? p.u[h * p.dk + j]
                                : 0.f;
    for (int ci = grp; ci < nch; ci += kPrepGroups) {
      const int st = ci % kNS, ps = ci % kNP;
      if (tma) {
        mbar_wait(&sm.raw_full[st], (ci / kNS) & 1);
      } else {
        RawStage<T, TW>& rs = sm.raw[st];
        const T* r = reinterpret_cast<const T*>(sm.head[0]);
        const T* k = reinterpret_cast<const T*>(sm.head[1]);
        const TW* w = reinterpret_cast<const TW*>(sm.head[2]);
        const T* v = reinterpret_cast<const T*>(sm.head[3]);
        if constexpr (kMasked) {
          // the chunk's C rows, zeros past them and past dk or dv
          const T zero = from_f32<T>(0.f);
          for (int i = pt; i < kC * kDK; i += kPrepThreads) {
            const int row = i / kDK, c = i % kDK;
            const int64_t t = static_cast<int64_t>(ci) * p.C + row;
            const bool in = row < p.C, ink = in && c < p.dk;
            rs.r[i] = ink ? r[t * p.r_ss + c] : zero;
            rs.k[i] = ink ? k[t * p.k_ss + c] : zero;
            rs.w[i] = ink ? w[t * p.w_ss + c] : from_f32<TW>(0.f);
            rs.v[i] = in && c < p.dv ? v[t * p.v_ss + c] : zero;
          }
        } else {
          for (int i = pt; i < kC * kDK; i += kPrepThreads) {
            const int64_t t = static_cast<int64_t>(ci) * kC + i / kDK;
            const int c = i % kDK;
            rs.r[i] = r[t * p.r_ss + c];
            rs.k[i] = k[t * p.k_ss + c];
            rs.w[i] = w[t * p.w_ss + c];
            rs.v[i] = v[t * p.v_ss + c];
          }
        }
        group_sync(1 + grp, kPrepThreads);
      }
      if (ci >= kNP) mbar_wait(&sm.prep_empty[ps], ((ci / kNP) & 1) ^ 1);
      const RawStage<T, TW>& rs = sm.raw[st];
      PrepStage& pp = sm.prep[ps];

      // the inclusive cumulative log-decay of column j, in base 2 (one ex2
      // a factor): L_C first, then the same sums again, row by row
      float lc = 0.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) lc += to_f32(rs.w[t * kDK + j]) * kLog2e;
      const float elc = exp2f(lc);  // e^{L_C} >= e^{-68}: a normal float
      float run = 0.f;
      if (hf)
#pragma unroll
        for (int t = 0; t < 8; ++t) run += to_f32(rs.w[t * kDK + j]) * kLog2e;
      // v first, then every row of r_dec and k_inc in registers before any
      // store, then the bonus's products from a second read of r and k:
      // the compiler cannot tell the raw stage from the prepared one, and
      // keeps each load behind every store before it
      float vv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) vv[i] = to_f32(rs.v[(8 * hf + i) * kDV + j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) pp.vf[8 * hf + i][j] = vv[i];
      float rdec[8], kinc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * hf + i;
        const float lw = to_f32(rs.w[t * kDK + j]) * kLog2e;
        run += lw;  // Lx
        kinc[i] = to_f32(rs.k[t * kDK + j]) * exp2f(-run);  // e^{-Lx} <= e^{68}
        rdec[i] = to_f32(rs.r[t * kDK + j]) * exp2f(run - lw);  // Lex = Lx - logw
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        pp.rdec[8 * hf + i][j] = rdec[i];
        pp.kinc[8 * hf + i][j] = kinc[i];
      }
      float bon[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * hf + i;
        bon[i] = to_f32(rs.r[t * kDK + j]) * uj * to_f32(rs.k[t * kDK + j]);
      }
      // this thread's 8 tokens of column j are k-step hf of k_fin: one
      // 16-byte row of a core matrix a half and a part
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(kinc[half + 2 * e] * elc, hi[e], lo[e]);
        *reinterpret_cast<uint4*>(&pp.kfin[0][hf][j / 8][half][j % 8][0]) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(&pp.kfin[1][hf][j / 8][half][j % 8][0]) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      if (hf == 0) pp.elc[j] = elc;
      // the bonus of each row over the warp's 32 columns: a reduce-scatter
      // leaves row lane / 4 in each lane, summed over lane bits 4, 3, 2;
      // two more shuffles add bits 1 and 0
      reduce_scatter_step<8, 16>(bon, lane);
      reduce_scatter_step<4, 8>(bon, lane);
      reduce_scatter_step<2, 4>(bon, lane);
      float bsum = bon[0];
      bsum += __shfl_xor_sync(0xffffffffu, bsum, 2);
      bsum += __shfl_xor_sync(0xffffffffu, bsum, 1);
      if (q == 0) pp.bonus[pw & 1][8 * hf + g] = bsum;
      group_sync(1 + grp, kPrepThreads);  // the chunk's arrays are in place
      if (tma && pt == 0 && ci + kNS < nch) issue(ci + kNS);

      {
        // scores: warp pw sums one half kh of the 64 columns (k-steps
        // 4 kh..4 kh + 3) of att = r_dec k_inc^T for the tokens s in
        // 8 nt..8 nt + 7 of all 16 rows t, in split TF32, each pass in its
        // own accumulator; the state warps add the two halves, mask them
        // and put the bonus on the diagonal as they read them
        const int nt = pw & 1, kh = pw >> 1;
        float hh[4] = {}, hl[4] = {}, lh[4] = {};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ks = 4 * kh + i;
          const float2 x0 =
              *reinterpret_cast<const float2*>(&pp.rdec[g][8 * ks + 2 * q]);
          const float2 x1 = *reinterpret_cast<const float2*>(
              &pp.rdec[g + 8][8 * ks + 2 * q]);
          const float2 y = *reinterpret_cast<const float2*>(
              &pp.kinc[8 * nt + g][8 * ks + 2 * q]);
          uint32_t ahi[4], alo[4], bhi[2], blo[2];
          split_tf32(x0.x, ahi[0], alo[0]);
          split_tf32(x1.x, ahi[1], alo[1]);
          split_tf32(x0.y, ahi[2], alo[2]);
          split_tf32(x1.y, ahi[3], alo[3]);
          split2(y, bhi, blo);
          mma_tf32(hl, ahi, blo);
          mma_tf32(lh, alo, bhi);
          mma_tf32(hh, ahi, bhi);
        }
        float part[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) part[e] = hh[e] + (hl[e] + lh[e]);
        *reinterpret_cast<float2*>(&pp.attp[kh][g][8 * nt + 2 * q]) =
            make_float2(part[0], part[1]);
        *reinterpret_cast<float2*>(&pp.attp[kh][g + 8][8 * nt + 2 * q]) =
            make_float2(part[2], part[3]);
      }
      // k_fin is read by wgmma, through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&sm.prep_full[ps]);
    }
    return;
  }

  // ---- state: warp sw holds the state's columns c0..c0 + 15 as S^T, a
  // 16 x 64 accumulator fragment of eight m16n8 tiles (the warpgroup's 64 x
  // 64 wgmma accumulator): s[n] holds S^T[c0 + g (+8)][8 n + 2 q (+1)],
  // i.e. S[j][c] at j = 8 n + 2 q (+1), c = c0 + g (+8). A chunk is
  // o^T = S^T r_dec^T + v^T att^T (the state fragment is the A operand as
  // it is), then S^T = S^T e^{L_C} + v^T k_fin
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kStateRegs));
  const int sw = warp - kPrepGroups * kPrepWarps;
  const int c0 = 16 * sw;
  float s[kDK / 8][4];
  if constexpr (kMasked) {
    // the dk x dv state in the 64 x 64 tile's corner, zeros around it
    const float* si = p.state_in + bh * p.dk * p.dv;
#pragma unroll
    for (int n = 0; n < kDK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * q + (e & 1), c = c0 + g + 8 * (e >> 1);
        s[n][e] = p.state_in && j < p.dk && c < p.dv ? si[j * p.dv + c] : 0.f;
      }
  } else {
    const float* si = p.state_in + bh * kDK * kDV;
#pragma unroll
    for (int n = 0; n < kDK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = p.state_in ? si[(8 * n + 2 * q + (e & 1)) * kDV + c0 + g +
                                  8 * (e >> 1)]
                             : 0.f;
  }
  T* o = static_cast<T*>(p.o) +
         bh * static_cast<int64_t>(p.S) * (kMasked ? p.dv : kDV);
  for (int ci = 0; ci < nch; ++ci) {
    const int ps = ci % kNP;
    mbar_wait(&sm.prep_full[ps], (ci / kNP) & 1);
    const PrepStage& pp = sm.prep[ps];

    // v^T's fragments for both k-steps (tokens 8 ks..8 ks + 7): the A
    // operand of att v and of the state update
    uint32_t vh[2][4], vl[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            pp.vf[8 * ks + 2 * q + (e >> 1)][c0 + g + 8 * (e & 1)];
        split_tf32(x, vh[ks][e], vl[ks][e]);
      }

    // o^T (columns c, tokens t): two n-tiles of 8 tokens, each pass of the
    // split products in its own accumulator, o = hh + (hl + lh)
    float ohh[2][4] = {}, ohl[2][4] = {}, olh[2][4] = {};
#pragma unroll
    for (int n = 0; n < kDK / 8; ++n) {
      uint32_t ahi[4], alo[4];
      split_tf32(s[n][0], ahi[0], alo[0]);
      split_tf32(s[n][2], ahi[1], alo[1]);
      split_tf32(s[n][1], ahi[2], alo[2]);
      split_tf32(s[n][3], ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bhi[2], blo[2];
        split2(*reinterpret_cast<const float2*>(
                   &pp.rdec[8 * nt + g][8 * n + 2 * q]),
               bhi, blo);
        mma_tf32(ohl[nt], ahi, blo);
        mma_tf32(olh[nt], alo, bhi);
        mma_tf32(ohh[nt], ahi, bhi);
      }
    }
    // att's B fragments: the two halves added, masked to s < t, the bonus
    // at s = t; tokens 8..15 of rows 0..7 are all above the diagonal
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int nt = ks; nt < 2; ++nt) {
        const int t = 8 * nt + g, s0 = 8 * ks + 2 * q;
        const float2 p0 =
            *reinterpret_cast<const float2*>(&pp.attp[0][t][s0]);
        const float2 p1 =
            *reinterpret_cast<const float2*>(&pp.attp[1][t][s0]);
        const float bonus = pp.bonus[0][t] + pp.bonus[1][t];
        const float2 a =
            make_float2(s0 < t ? p0.x + p1.x : (s0 == t ? bonus : 0.f),
                        s0 + 1 < t ? p0.y + p1.y : (s0 + 1 == t ? bonus : 0.f));
        uint32_t bhi[2], blo[2];
        split2(a, bhi, blo);
        if (!kVExact) mma_tf32(olh[nt], vl[ks], bhi);
        mma_tf32(ohl[nt], vh[ks], blo);
        mma_tf32(ohh[nt], vh[ks], bhi);
      }
    // S^T[c][j] = S^T[c][j] e^{L_C}[j] + sum_t v[t][c] k_fin[t][j]
#pragma unroll
    for (int n = 0; n < kDK / 8; ++n) {
      const float2 e = *reinterpret_cast<const float2*>(&pp.elc[8 * n + 2 * q]);
      s[n][0] *= e.x;
      s[n][1] *= e.y;
      s[n][2] *= e.x;
      s[n][3] *= e.y;
    }
    // the update as wgmma.m64n64k8 of the state warpgroup, the state its
    // accumulator: per k-step v_lo k_fin_hi, v_hi k_fin_lo, v_hi k_fin_hi
    reg_fence(s);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint64_t dhi = kfin_desc(&pp.kfin[0][ks][0][0][0][0]);
      const uint64_t dlo = kfin_desc(&pp.kfin[1][ks][0][0][0][0]);
      if (!kVExact) wgmma_tf32(s, vl[ks], dhi);
      wgmma_tf32(s, vh[ks], dlo);
      wgmma_tf32(s, vh[ks], dhi);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the chunk's output while the update runs
    if constexpr (kMasked) {
      // its C rows and dv columns
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * nt + 2 * q + (e & 1), c = c0 + g + 8 * (e >> 1);
          if (row < p.C && c < p.dv)
            o[(static_cast<int64_t>(ci) * p.C + row) * p.dv + c] =
                from_f32<T>(ohh[nt][e] + (ohl[nt][e] + olh[nt][e]));
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t t = static_cast<int64_t>(ci) * kC + 8 * nt + 2 * q +
                            (e & 1);
          o[t * kDV + c0 + g + 8 * (e >> 1)] =
              from_f32<T>(ohh[nt][e] + (ohl[nt][e] + olh[nt][e]));
        }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    reg_fence(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.prep_empty[ps]);
  }
  if constexpr (kMasked) {
    // the dk x dv corner, through shared memory (the prepared stages, which
    // every warp is done with once the state warps are past their last
    // chunk) and out as coalesced 16-byte vectors of whole rows where dv
    // is a multiple of 4 (each head then starts on 16 bytes), else as
    // coalesced floats
    constexpr int kStateThreads = 32 * kStateWarps;
    float(*st)[kSS] = reinterpret_cast<float(*)[kSS]>(&sm.prep[0]);
    group_sync(3, kStateThreads);
#pragma unroll
    for (int n = 0; n < kDK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[8 * n + 2 * q + (e & 1)][c0 + g + 8 * (e >> 1)] = s[n][e];
    group_sync(3, kStateThreads);
    const int dv = p.dv, count = p.dk * dv;
    const int tt = tid - kPrepGroups * kPrepThreads;
    float* so = p.state_out + bh * count;
    if (dv % 4 == 0) {
      // thread tt takes vectors tt, tt + 128, ... in row-major order: its
      // row and column advance by a fixed step, no division a vector
      const int per_row = dv / 4;
      const int drow = kStateThreads / per_row;
      const int dcol = kStateThreads % per_row;
      int row = tt / per_row, col = tt % per_row;
      for (int m = tt; m < count / 4; m += kStateThreads) {
        *reinterpret_cast<float4*>(so + 4 * m) =
            *reinterpret_cast<const float4*>(&st[row][4 * col]);
        row += drow;
        col += dcol;
        if (col >= per_row) col -= per_row, ++row;
      }
    } else {
      for (int i = tt; i < count; i += kStateThreads)
        so[i] = st[i / dv][i % dv];
    }
  } else {
    float* so = p.state_out + bh * kDK * kDV;
#pragma unroll
    for (int n = 0; n < kDK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        so[(8 * n + 2 * q + (e & 1)) * kDV + c0 + g + 8 * (e >> 1)] = s[n][e];
  }
}

// rwkv6-7b's heads in chunks of 16: every shape known when compiled
template <typename T, typename TW>
__global__ void __launch_bounds__(kSplitThreads, kSplitCtas)
wkv_split_kernel(const __grid_constant__ SplitMaps maps, const SplitParams p,
                 int tma) {
  wkv_scan<T, TW, false>(maps, p, tma);
}

// every other shape, on the padded tile
template <typename T, typename TW>
__global__ void __launch_bounds__(kSplitThreads, kSplitCtas)
wkv_kernel(const __grid_constant__ SplitMaps maps, const SplitParams p,
           int tma) {
  wkv_scan<T, TW, true>(maps, p, tma);
}

// cuTensorMapEncodeTiled, reached through the runtime (so that the library
// need not link libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor maps of one call; false where TMA cannot describe a view (the
// producer then copies by plain loads)
template <typename T, typename TW, bool kMasked>
bool encode_split_maps(SplitMaps* m, const SplitParams& p, int batch) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  auto one = [&](CUtensorMap* map, const void* ptr, int es, int d, int64_t ss,
                 int64_t sh, int64_t sb) {
    using U64 = cuuint64_t;
    // split: (d, s, h, b); masked: (d, t, chunk, h, b), t < C
    const U64 dims4[4] = {static_cast<U64>(kDK), static_cast<U64>(p.S),
                          static_cast<U64>(p.H), static_cast<U64>(batch)};
    const U64 strides4[3] = {static_cast<U64>(ss * es),
                             static_cast<U64>(sh * es),
                             static_cast<U64>(sb * es)};
    const U64 dims5[5] = {static_cast<U64>(d), static_cast<U64>(p.C),
                          static_cast<U64>(p.S / p.C), static_cast<U64>(p.H),
                          static_cast<U64>(batch)};
    const U64 strides5[4] = {
        static_cast<U64>(ss * es), static_cast<U64>(p.C * ss * es),
        static_cast<U64>(sh * es), static_cast<U64>(sb * es)};
    const cuuint32_t box[5] = {kDK, kC, 1, 1, 1};
    const cuuint32_t step[5] = {1, 1, 1, 1, 1};
    return encode(map,
                  es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  kMasked ? 5 : 4, const_cast<void*>(ptr),
                  kMasked ? dims5 : dims4, kMasked ? strides5 : strides4, box,
                  step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  // out of bounds: zeros, the masked tile's padding
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  constexpr int es = sizeof(T), ws = sizeof(TW);
  return one(&m->r, p.r, es, p.dk, p.r_ss, p.r_sh, p.r_sb) &&
         one(&m->k, p.k, es, p.dk, p.k_ss, p.k_sh, p.k_sb) &&
         one(&m->w, p.logw, ws, p.dk, p.w_ss, p.w_sh, p.w_sb) &&
         one(&m->v, p.v, es, p.dv, p.v_ss, p.v_sh, p.v_sb);
}

template <typename T, typename TW, bool kMasked>
int launch_split(const SplitParams& p, int batch, int vec,
                 cudaStream_t stream) {
  auto kernel = kMasked ? wkv_kernel<T, TW> : wkv_split_kernel<T, TW>;
  constexpr int bytes = split_smem_bytes<T, TW>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  SplitMaps maps;
  memset(&maps, 0, sizeof maps);
  const int tma =
      vec && encode_split_maps<T, TW, kMasked>(&maps, p, batch) ? 1 : 0;
  const int64_t bh = static_cast<int64_t>(batch) * p.H;
  kernel<<<static_cast<unsigned>(bh), kSplitThreads, bytes, stream>>>(
      maps, p, tma);
  return static_cast<int>(cudaGetLastError());
}

// Both entry points: the route's checks done, pick TMA or the plain loads
// and the instance of (dtype, wdtype)
template <bool kMasked>
int dispatch(const SplitParams& p, int B, int dtype, int wdtype,
             void* stream) {
  // 16-byte strides and bases: TMA; else the producer's plain loads
  const int es = dtype == 0 ? 4 : 2, ws = wdtype == 0 ? 4 : 2;
  bool vec = true;
  for (int64_t st : {p.r_sb, p.r_sh, p.r_ss, p.k_sb, p.k_sh, p.k_ss, p.v_sb,
                     p.v_sh, p.v_ss})
    vec = vec && (st * es) % 16 == 0;
  for (int64_t st : {p.w_sb, p.w_sh, p.w_ss}) vec = vec && (st * ws) % 16 == 0;
  for (const void* ptr : {p.r, p.k, p.v, p.logw})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  const int vi = vec ? 1 : 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0)
    return launch_split<float, float, kMasked>(p, B, vi, s);
  if (dtype == 1 && wdtype == 0)
    return launch_split<__nv_bfloat16, float, kMasked>(p, B, vi, s);
  if (dtype == 1 && wdtype == 1)
    return launch_split<__nv_bfloat16, __nv_bfloat16, kMasked>(p, B, vi, s);
  if (dtype == 0 && wdtype == 1)
    return launch_split<float, __nv_bfloat16, kMasked>(p, B, vi, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue,
// without a launch, for an unsupported shape). dtype / wdtype: 0 float32,
// 1 bfloat16, of r/k/v/o and of logw. state_in may be null (zero state).
// r, k, v and logw are read through their element strides of b, h and s
// (the last dimension contiguous); o and the states are contiguous.
extern "C" {

#define WKV_ARGS                                                            \
  const void *r, const void *k, const void *v, const void *logw,           \
      const void *u, const void *state_in, void *o, void *state_out,       \
      int64_t r_sb, int64_t r_sh, int64_t r_ss, int64_t k_sb, int64_t k_sh, \
      int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t w_sb, \
      int64_t w_sh, int64_t w_ss, int B, int H, int S, int dk, int dv,      \
      int C, int dtype, int wdtype, void *stream
#define WKV_PARAMS                                                          \
  SplitParams p {                                                          \
    r, k, v, logw, static_cast<const float*>(u),                           \
        static_cast<const float*>(state_in), o,                            \
        static_cast<float*>(state_out), r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, \
        v_sb, v_sh, v_ss, w_sb, w_sh, w_ss, H, S, dk, dv, C                \
  }

// The masked instantiation: every shape but the split route's own, dk and
// dv from 1 to 64, C = min(chunk, S) from 1 to 16, S a multiple of C.
int wkv(WKV_ARGS) {
  const int64_t bh = static_cast<int64_t>(B) * H;
  if (B < 1 || H < 1 || bh > 2147483647 || S < 1 || C < 1 || C > kC ||
      S % C != 0 || dk < 1 || dk > kDK || dv < 1 || dv > kDV ||
      (dk == kDK && dv == kDV && C == kC))
    return static_cast<int>(cudaErrorInvalidValue);
  WKV_PARAMS;
  return dispatch<true>(p, B, dtype, wdtype, stream);
}

// The split route: dk = dv = 64, C = 16, any S that is a multiple of 16.
int wkv_split(WKV_ARGS) {
  const int64_t bh = static_cast<int64_t>(B) * H;
  if (B < 1 || H < 1 || bh > 2147483647 || S < kC || S % kC != 0 ||
      dk != kDK || dv != kDV || C != kC)
    return static_cast<int>(cudaErrorInvalidValue);
  WKV_PARAMS;
  return dispatch<false>(p, B, dtype, wdtype, stream);
}

#undef WKV_PARAMS
#undef WKV_ARGS

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
