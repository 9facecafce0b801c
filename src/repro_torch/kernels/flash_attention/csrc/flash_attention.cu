// Blockwise GQA attention with an online softmax on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_mma, flash_attention
//                    <- flash_attention_pallas (_flash_kernel)
//
// Contract (the Pallas kernel's): q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D),
// float32 or bfloat16, all of one dtype; the kv head of q head h is
// h // (Hq / Hkv). Scores s = (q . k) * scale in float32 (a bfloat16 q and k
// are widened first, so every product is exact), then the softcap
// cap * tanh(s / cap), then the masks (causal kpos <= qpos, window
// kpos > qpos - window, kv_len kpos < kv_len) with NEG_INF = -1e30 exactly,
// never -inf: a row whose visited keys are all masked averages them
// uniformly, as the Pallas kernel does, instead of giving NaN. The running
// max m, the row sum l and the accumulator stay in float32; p = exp(s - m)
// is rounded to v's dtype before the P.V product, as `_flash_kernel` casts
// it, and l sums the unrounded p. Whole kv tiles strictly above the causal
// diagonal (k_start > q_start + BQ - 1) or wholly outside the window
// (k_start + BK - 1 <= q_start - window) are skipped and leave m and l
// untouched. Out = acc / max(l, 1e-30) in q's dtype, (B, Hq, Sq, D)
// contiguous. q0 shifts the query positions (0 on every full-sequence call
// of the model).
//
// Differences from the Pallas kernel, none of which changes the function:
// the kernel picks its own tiles (the caller's bq/bk only matter for rows
// whose visited keys are all masked), Sq and Skv need not be multiples of
// the tile (rows past Sq are not written, keys past Skv are not keys: their
// p is exactly 0), q, k and v may be strided views with a contiguous last
// dimension, and D is zero-padded inside shared memory. Causal q tiles (on
// the tensor-core route, pairs of them) are launched last first: the last
// tile of a head visits the most kv tiles, so the longest CTAs start first
// and the short ones fill the tail.
//
// Two routes, each its own C entry point, chosen by dtype alone:
//
// flash_attention_mma (bfloat16, D <= 256; D padded to 32/64/96/128/192/
// 256): the tensor-core route, built from what Hopper added. One CTA of
// three warpgroups per (b*Hq + h, pair of 64-row q tiles), two CTAs an SM
// at DP <= 64 and one above:
// - A producer warpgroup, of which one thread issues TMA copies
//   (cp.async.bulk.tensor over 4-d tensor maps of (d, s, h, b) with the
//   views' own strides; rows past Sq or Skv and columns past d arrive as
//   zeros, which pads D to DP): each consumer's Q tile once, then K and V
//   of the union of the two q tiles' kv ranges into a ring of stages
//   guarded by mbarriers (full: the bytes have landed; empty: every
//   consumer warp is done with the stage). As many stages as the CTA's
//   share of the SM's shared memory holds: 12 / 5 at DP = 32 / 64 (two
//   CTAs), 8 / 6 / 3 / 2 at DP = 96 / 128 / 192 / 256. It drops to 24 / 40
//   registers a thread (setmaxnreg.dec; two CTAs / one) and the consumers
//   take them (setmaxnreg.inc, 104 / 232).
// - Two consumer warpgroups, each owning one q tile and visiting exactly
//   the kv tiles of that tile's skip rule (a tile of the union that its q
//   tile does not visit is released unread; under causal and window masks
//   the two ranges differ by about one tile). S = Q K^T is
//   wgmma.m64n64k16 with both operands in shared memory, K-major. The
//   softmax runs on the accumulator fragment in registers: a thread holds
//   two rows' 16 scores, the rows reduce across a quad with shuffles, in
//   log2 units (scale * log2 e in one multiply, exp as ex2.approx); a tile
//   that a mask reaches compares each score's constant key offset with
//   bounds made once a row. p, rounded to bf16 in registers, is the A
//   operand of wgmma.m64nDPk16, whose B is the V tile read MN-major
//   (transposed). A consumer runs its tiles one product after the other;
//   the other consumer's (and the other CTA's) products fill the tensor
//   cores meanwhile. Issuing tile i's Q K^T beside tile i - 1's P.V, or
//   taking turns between the consumers on named barriers, measured slower
//   (ptxas serializes the latter's wgmma).
// - Shared tiles are boxes of 64 rows x 64 columns in the 128-byte swizzle
//   (x 32 columns in the 64-byte swizzle at DP = 32 and 96), the layouts
//   that TMA writes and wgmma's descriptors name. A view that TMA cannot
//   describe (d or a stride not a multiple of 8 elements, a base not
//   16-byte aligned) is copied by the producer warpgroup's own loads into
//   the same layout, fenced for the async proxy before it arrives on the
//   stage's barrier: the same kernel, no second route.
// - CTAs run pair by pair over all heads, the longest pairs first; where K
//   and V of all heads exceed half the L2 (deepseek-v2's MLA), head by
//   head, so that the pairs of a head read its K and V from L2.
// - The epilogue divides by max(l, 1e-30), rounds to bf16 and stores the
//   rows < Sq from the fragment.
//
// What bounds it on this card: at qwen2-0.5b's prefill shape (8 x 14/2
// heads, S = 512, D = 64) the causal work is ~3.8 GFLOP against ~17 MB of
// HBM traffic, 224 FLOP a byte; at deepseek-v2's MLA prefill (4 x 128
// heads, S = 512, D = 192, v zero-padded from 128 columns) ~51.6 GFLOP
// against ~403 MB, ~128 FLOP a byte. Both lie under the bf16 tensor-core
// ridge (~295 FLOP a byte), so at the card's peaks the bytes bound them
// (~5 us and ~0.12 ms). qwen2's training shape (4 x 14/2 heads, S = 4,096,
// D = 64) is ~120 GFLOP against ~59 MB: the operations bound it (~0.12
// ms), where the softmax's ex2 per score costs about as much as the
// products at D = 64.
//
// The 64 x 64 tile is kept at every DP: it is part of the function (a row
// whose visited keys are all masked averages the keys of the tiles it
// visits), so each consumer owns one 64-row q tile and steps 64 keys.
//
// flash_attention (float32, D <= 256; D padded to 32/64/96/128/192/256):
// the CUDA-core route. Float32 inputs are multiplied in full float32 (no
// TF32): every product is a float32 FMA (67 TFLOP/s peak, 128 FMAs a clock
// an SM).
//
// What bounds it on this card: FMAs, the shared memory that feeds them,
// and the latency that eight warps an SM cannot hide. At the float32
// shapes of the models (batch 1, S = 512-576, D = 64-192) the work is
// 68-112 FLOP a byte, far above the CUDA cores' ridge (67 TFLOP/s over
// 3.35 TB/s, 20 FLOP a byte): 0.47 GFLOP against 4.2 MB at qwen2-0.5b's
// (1, 14, 512, 64), 14.6 GFLOP against 214 MB at deepseek-v2's MLA (1,
// 128, 544, 192). An SM runs 128 FMAs a clock and its shared memory
// delivers 32 words a clock, a word a lane, broadcast or not: a thread
// has to do 4 FMAs for each word it reads, or shared memory sets the pace.
// At qwen2's shape the grid is 112 CTAs, under one wave of 132 SMs, so the
// last q tile's CTA sets the time: 8 kv tiles, 8.4 MFLOP, >= 16.5 us at
// one SM's share of the peak. The design:
// - Scores and softmax in registers. One CTA of eight warps per (b*Hq +
//   h, 64-row q tile). Its threads form G groups (4 at DP <= 64, 2 at 96
//   and 128, 1 at 192 and 256: as many as the registers allow), and group
//   g takes every G-th visited kv tile, with its own K and V buffers, P
//   tile, running max and sum and accumulator; the groups merge at the end
//   (m = max m_g, l = sum l_g 2^(m_g - m), out = sum acc_g 2^(m_g - m) / l,
//   in group order). A thread holds an RQ x CQ block of its group's 64 x
//   64 scores (8 x 8, 8 x 4, 4 x 4) and the RQ x DP / KG block of the
//   accumulator of the same rows; a row's KG threads are lanes of one
//   warp, and its max and sum reduce across them with shuffles. p goes
//   once to the group's P tile and is read back by the row's own warp; the
//   accumulator stays in registers. A tile takes two barriers of the
//   group's own threads (`bar.sync` by group), none of the whole CTA, so
//   the groups run apart and fill each other's stalls. The softmax runs
//   under branches uniform across the CTA (softcap, masks; a tile that no
//   mask reaches skips the tests), in log2 units (scale * log2 e folded
//   into one multiply; with a softcap, after the tanh), so exp(s - m) is
//   one ex2.approx.
// - Register-blocked products with 128-bit shared loads. Q, K and V stay
//   row-major in shared memory, so that 16-byte cp.async fills them; a Q
//   K^T step runs along d: RQ float4 of Q and CQ of K a thread for 4 RQ CQ
//   FMAs, RQ CQ / (RQ + CQ) FMAs a word: 4 at G = 4, 2.67 at G = 2, 2 at G
//   = 1. P.V reads RQ float4 of P and float4 (float2 at DP = 96) of V along
//   its columns, RQ CP / (RQ + CP) FMAs a word for CP = DP / KG columns: 4
//   at DP = 64 and 128, 3.4 at 96, 3 at 192, 3.2 at 256, 2.67 at 32. K
//   rows are padded by 16 bytes, so that the eight K rows a quarter of a
//   warp reads start in eight bank groups; a quarter of a warp reads one Q
//   or P row (a broadcast) and 128 contiguous bytes of a V row; P's rows
//   are padded too, and its 16-byte chunks XOR-swizzled by row group where
//   a warp stores rows 8 apart (RQ = 8), so that they fall in different
//   banks.
// - cp.async K and V, 16-byte copies: one stage a group, G kv tiles in
//   flight a CTA. A group copies V(kt) during its Q K^T of tile kt and
//   K(kt + G) during its P.V, while the other groups compute. The bytes
//   set the stages: Q + G (P + K + V) = 147,456 / 221,184 / 159,744 /
//   200,704 / 165,888 / 215,040 B at DP = 32 / 64 / 96 / 128 / 192 / 256,
//   one CTA an SM, at most the 227 KB a CTA may take; a second stage a
//   group fits at none of them. A view whose rows are not 16-byte aligned
//   (d % 4 != 0, odd strides) is copied by plain loads in the same kernel.
// - The 64 x 64 tile at every DP, as on the tensor-core route: D = 192
//   pads to 192, not 256, and a row whose visited keys are all masked
//   averages the same keys on both routes (the groups' sums merge to it).
// - A warp whose rows all lie past Sq (in the last, partial q tile) skips
//   the products and the softmax.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>


namespace {

constexpr float kNegInf = -1e30f;
struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;  // element strides of b, h, s (d is contiguous)
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int hq, hkv, sq, skv, d;
  int causal, has_window, window, has_cap, has_kv_len, kv_len, q0;
  float scale, cap;
};

// The q tile of this CTA. Causal tiles run last tile first, so the CTAs
// that visit the most kv tiles are launched first.
__device__ __forceinline__ int q_tile(int causal) {
  return causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                : static_cast<int>(blockIdx.y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte asynchronous copy; src_bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------- CUDA-core route (float32)
constexpr int kF32Threads = 256;  // eight warps
constexpr int kF32BQ = 64;
constexpr int kF32BK = 64;
constexpr float kLog2e = 1.4426950408889634f;
// The shared memory one CTA may take (227 KiB of the SM's 228)
constexpr size_t kSmemPerBlock = 227 * 1024;

// The CUDA-core route's layout at one padded head dim. The CTA's threads
// form G groups; group g takes the kv tiles kt_lo + g, kt_lo + g + G, ...
// with its own K and V buffers, P tile, running max, sum and accumulator,
// and the groups' results are merged at the end. Within a group, thread
// (rg, kg) holds rows rg * RQ + (0..RQ-1) of the q tile: the scores of
// keys kg + KG * i (i < CQ) and the output columns j * KG * VW + kg * VW +
// (0..VW-1) (j < CP / VW) of those rows; a row's KG threads are lanes of
// one warp. G is as large as the registers let it be (RQ x CQ scores and
// RQ x CP accumulators a thread under 255 registers).
template <int DP>
struct F32Tile {
  static constexpr int G = DP <= 64 ? 4 : (DP <= 128 ? 2 : 1);
  static constexpr int TG = kF32Threads / G;  // threads a group
  static constexpr int RQ = G == 1 ? 4 : 8;   // rows a thread
  static constexpr int RG = kF32BQ / RQ;      // row groups
  static constexpr int KG = TG / RG;          // threads a row
  static constexpr int CQ = kF32BK / KG;      // keys a thread
  static constexpr int CP = DP / KG;          // output columns a thread
  static constexpr int VW = CP % 4 == 0 ? 4 : 2;  // their vector width
  // Q K^T steps unrolled: one at G = 4, whose 8 x 8 scores and accumulator
  // leave no registers for a second step's operands
  static constexpr int QK_UNROLL = G == 4 ? 1 : 2;
  // P's 16-byte chunks are XOR-swizzled by row group, so that the RQ-row
  // apart rows a warp stores to fall in different banks
  static constexpr int SW = RQ == 8 ? KG / 4 : 0;
  // floats: row strides (K padded by 16 bytes, so that the eight K rows a
  // quarter of a warp reads start in eight bank groups; a quarter of a warp
  // reads one Q row, which needs no pad) and tiles
  static constexpr int QS = DP;
  static constexpr int KS = DP + 4;
  static constexpr int VS = DP;
  static constexpr int PS = kF32BK + 4;
  static constexpr int q_floats = kF32BQ * QS;
  static constexpr int p_floats = kF32BQ * PS;
  static constexpr int k_floats = kF32BK * KS;
  static constexpr int v_floats = kF32BK * VS;
  static constexpr size_t bytes =
      sizeof(float) * (q_floats + G * (p_floats + k_floats + v_floats));
  static_assert(DP % 32 == 0 && DP <= 256, "DP: a multiple of 32, <= 256");
  static_assert(RG * KG == TG && CQ * KG == kF32BK && CP * KG == DP &&
                    32 % KG == 0 && CP % VW == 0,
                "thread layout");
  static_assert(bytes <= kSmemPerBlock, "the tiles must fit a CTA");
  // the merge (G > 1): G scaled accumulators over the K/V buffers, the
  // groups' maxima and sums over the P tiles
  static_assert(G == 1 || (kF32BQ * DP <= k_floats + v_floats &&
                           2 * G * kF32BQ + kF32BQ <= G * p_floats),
                "merge buffers");
};

// Rows [row0, row0 + 64) of a (rows, d) float32 matrix with row stride
// `ss` into a DP-wide shared tile of row stride RS, by NT threads (t their
// index); rows >= `rows` and columns >= d are zero. vec: d, the strides and
// the base are 16-byte multiples, so the copy is asynchronous (cp.async,
// to be waited for); otherwise it is made by plain loads and stores.
template <int DP, int RS, int NT>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int64_t ss, int row0, int rows,
                                              int d, bool vec, int t) {
  if (vec) {
    // thread t copies chunk t % CW of rows t / CW + RI * it: one base
    // address a thread, whole rows an iteration (CW, the chunks a row
    // rounded up to a power of two, so that it divides NT)
    constexpr int CPR = DP / 4;  // 16-byte chunks a row
    constexpr int CW = CPR <= 8 ? 8 : (CPR <= 16 ? 16 : (CPR <= 32 ? 32 : 64));
    constexpr int RI = NT / CW;  // rows an iteration
    static_assert(NT % CW == 0 && kF32BK % RI == 0, "whole rows");
    const int c = (t % CW) * 4;
    if (c >= DP) return;
    const int r0 = t / CW;
    const bool col_in = c < d;
#pragma unroll
    for (int it = 0; it < kF32BK / RI; ++it) {
      const int r = r0 + it * RI;
      const int row = row0 + r;
      const bool in = col_in && row < rows;
      cp_async16(smem_addr(dst + r * RS + c), in ? src + row * ss + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = t; i < kF32BK * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      const int row = row0 + r;
      dst[r * RS + c] = (row < rows && c < d) ? src[row * ss + c] : 0.f;
    }
  }
}

// The kv tiles [lo, hi) that the 64-row q tile whose first row sits at
// position qlo visits (of nk): _flash_kernel's whole-tile skip rule
// (causal: k_start > qlo + BQ - 1; window: k_start + BK - 1 <= qlo -
// window) leaves one contiguous range
__device__ __forceinline__ void visited_range(const Params& p, int qlo,
                                              int nk, int& lo, int& hi) {
  lo = 0, hi = nk;
  if (p.causal) {
    const int64_t last = static_cast<int64_t>(qlo) + kF32BQ - 1;
    const int64_t end = last / kF32BK + 1;
    hi = last < 0 ? 0 : static_cast<int>(end < nk ? end : nk);
  }
  if (p.has_window) {
    const int64_t edge = static_cast<int64_t>(qlo) - p.window - kF32BK + 1;
    const int64_t first = edge / kF32BK + 1;
    lo = edge < 0 ? 0 : static_cast<int>(first < nk ? first : nk);
  }
}

// barrier `id` of the n threads of one group
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
template <int N>  // over lanes ^1, ^2, ... ^(N/2)
__device__ __forceinline__ float shfl_sum(float x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float f4_at(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}
// 2^x by the SFU (ex2.approx.ftz: a relative error under 2^-22, results
// below 2^-126 flushed to 0; 0 at -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
template <int VW>  // VW floats from shared memory, 8 or 16 bytes aligned
__device__ __forceinline__ void load_vec(const float* p, float (&out)[VW]) {
  if constexpr (VW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  }
}

// Scale, softcap and masks of the thread's RQ x CQ scores s of kv tile kt
// (rows row0 + e of the q tile whose first row sits at position qlo; keys
// kg + KG i), then the online softmax of each row across its KG threads:
// m_run, l_part and acc corrected, and p = exp(s - m) written to the P tile
// Pt (row stride PS, 16-byte chunks XOR-swizzled by sw).
template <int RQ, int CQ, int KG, int CP, int PS>
__device__ __forceinline__ void softmax_tile(
    const Params& p, float (&s)[RQ][CQ], float (&m_run)[RQ],
    float (&l_part)[RQ], float (&acc)[RQ][CP], float* Pt, int kt, int qlo,
    int row0, int kg, int sw, float scale2) {
  // scale, softcap, masks, in log2 units (exp(x) = exp2(x log2 e)), each
  // under a branch that is uniform across the CTA; a tile that no mask
  // and no key past Skv reaches skips the tests. Then the online softmax
  // of each row across its KG threads, all RQ rows' shuffles interleaved.
  if (p.has_cap) {
#pragma unroll
    for (int e = 0; e < RQ; ++e)
#pragma unroll
      for (int i = 0; i < CQ; ++i) {
        const float x = s[e][i] * p.scale;
        s[e][i] = p.cap * tanhf(x / p.cap) * kLog2e;
      }
  } else {
#pragma unroll
    for (int e = 0; e < RQ; ++e)
#pragma unroll
      for (int i = 0; i < CQ; ++i) s[e][i] *= scale2;
  }
  const int k_start = kt * kF32BK;
  const int k_last = k_start + kF32BK - 1;
  if (k_last >= p.skv || (p.causal && k_last > qlo) ||
      (p.has_window && k_start <= qlo + kF32BQ - 1 - p.window) ||
      (p.has_kv_len && k_last >= p.kv_len)) {
#pragma unroll
    for (int e = 0; e < RQ; ++e)
#pragma unroll
      for (int i = 0; i < CQ; ++i) {
        const int kpos = k_start + kg + KG * i;
        const int qpos = qlo + row0 + e;
        bool keep = true;
        if (p.causal) keep = keep && kpos <= qpos;
        if (p.has_window) keep = keep && kpos > qpos - p.window;
        if (p.has_kv_len) keep = keep && kpos < p.kv_len;
        if (!keep) s[e][i] = kNegInf;
        if (kpos >= p.skv) s[e][i] = -INFINITY;  // past the last key
      }
  }
  float mx[RQ];
#pragma unroll
  for (int e = 0; e < RQ; ++e) {
    mx[e] = s[e][0];
#pragma unroll
    for (int i = 1; i < CQ; ++i) mx[e] = fmaxf(mx[e], s[e][i]);
  }
#pragma unroll
  for (int o = 1; o < KG; o <<= 1)
#pragma unroll
    for (int e = 0; e < RQ; ++e)
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], o));
#pragma unroll
  for (int e = 0; e < RQ; ++e) {
    const float m_new = fmaxf(m_run[e], mx[e]);
    const float corr = ex2(m_run[e] - m_new);
    m_run[e] = m_new;
    l_part[e] *= corr;
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[e][c] *= corr;
    // p = exp(s - m) to the P tile, read back by the row's warp
    float* const prow = Pt + (row0 + e) * PS;
#pragma unroll
    for (int i = 0; i < CQ; ++i) {
      const float pe = ex2(s[e][i] - m_new);
      l_part[e] += pe;
      const int key = kg + KG * i;
      prow[(((key / 4) ^ sw) * 4) + key % 4] = pe;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_kernel(Params p, int vec) {
  using L = F32Tile<DP>;
  constexpr int G = L::G, TG = L::TG, RQ = L::RQ, KG = L::KG, CQ = L::CQ;
  constexpr int CP = L::CP, VW = L::VW;
  constexpr int QS = L::QS, KS = L::KS, VS = L::VS, PS = L::PS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const Qs = reinterpret_cast<float*>(smem_raw);
  float* const Ps = Qs + L::q_floats;          // G P tiles
  float* const kv0 = Ps + G * L::p_floats;     // G (K, V) pairs

  const int tid = threadIdx.x;
  const int g = tid / TG, t = tid % TG;
  const int rg = t / KG, kg = t % KG;
  const int row0 = rg * RQ;
  const int sw = (rg % (32 / KG)) * L::SW;  // P's chunk swizzle, these rows
  float* const Pg = Ps + g * L::p_floats;
  float* const Kg = kv0 + g * (L::k_floats + L::v_floats);
  float* const Vg = Kg + L::k_floats;

  const int64_t bh = blockIdx.x;  // b * Hq + h
  const int b = static_cast<int>(bh / p.hq);
  const int h = static_cast<int>(bh % p.hq);
  const int kvh = h / (p.hq / p.hkv);
  const int q_start = q_tile(p.causal) * kF32BQ;
  const int qlo = p.q0 + q_start;  // position of the tile's first row

  const auto* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const auto* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const auto* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the kv tiles this q tile visits
  const int nk = (p.skv + kF32BK - 1) / kF32BK;
  int kt_lo, kt_hi;
  visited_range(p, qlo, nk, kt_lo, kt_hi);

  // Copies: Q by the whole CTA, with each group's first K tile. Then, in
  // each of its tiles, a group copies V(kt) after the tile's first barrier
  // (once it is done with V(kt - G)), which overlaps Q K^T, and K(kt + G)
  // after the second (once it is done with K(kt)), which overlaps P.V.
  const bool vec_load = vec != 0;
  load_tile_f32<DP, QS, kF32Threads>(Qs, q, p.q_ss, q_start, p.sq, p.d,
                                     vec_load, tid);
  const int kt0 = kt_lo + g;
  if (kt0 < kt_hi)
    load_tile_f32<DP, KS, TG>(Kg, k, p.k_ss, kt0 * kF32BK, p.skv, p.d,
                              vec_load, t);
  cp_async_commit();

  float acc[RQ][CP];
#pragma unroll
  for (int e = 0; e < RQ; ++e)
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[e][c] = 0.f;
  // this thread's rows: the running max (in log2 units) and this thread's
  // part of the running sum (the row's KG parts are added at the end)
  float m_run[RQ], l_part[RQ];
#pragma unroll
  for (int e = 0; e < RQ; ++e) m_run[e] = kNegInf, l_part[e] = 0.f;
  const float scale2 = p.scale * kLog2e;
  // a warp whose rows all lie past Sq (the last q tile's) skips the products
  // and the softmax: its rows are not written
  const bool live = __any_sync(0xffffffffu, q_start + row0 < p.sq);

  cp_async_wait<0>();
  __syncthreads();  // Q and each group's first K tile are in place
  for (int kt = kt0; kt < kt_hi; kt += G) {
    if (kt != kt0) {
      cp_async_wait<0>();
      group_sync(1 + g, TG);  // K(kt); the group is done with V(kt - G), P
    }
    load_tile_f32<DP, VS, TG>(Vg, v, p.v_ss, kt * kF32BK, p.skv, p.d,
                              vec_load, t);
    cp_async_commit();

    if (live) {
      // S = Q K^T for this thread's RQ rows and CQ keys, in registers: each
      // step of four d reads RQ float4 of Q and CQ of K for 4 RQ CQ FMAs
      float s[RQ][CQ];
#pragma unroll
      for (int e = 0; e < RQ; ++e)
#pragma unroll
        for (int i = 0; i < CQ; ++i) s[e][i] = 0.f;
#pragma unroll (L::QK_UNROLL)
      for (int dd = 0; dd < DP; dd += 4) {
        float4 qa[RQ];
#pragma unroll
        for (int e = 0; e < RQ; ++e)
          qa[e] = *reinterpret_cast<const float4*>(Qs + (row0 + e) * QS + dd);
#pragma unroll
        for (int i = 0; i < CQ; ++i) {
          const float4 kb =
              *reinterpret_cast<const float4*>(Kg + (kg + KG * i) * KS + dd);
#pragma unroll
          for (int e = 0; e < RQ; ++e) {
            s[e][i] = fmaf(qa[e].x, kb.x, s[e][i]);
            s[e][i] = fmaf(qa[e].y, kb.y, s[e][i]);
            s[e][i] = fmaf(qa[e].z, kb.z, s[e][i]);
            s[e][i] = fmaf(qa[e].w, kb.w, s[e][i]);
          }
        }
      }

      softmax_tile<RQ, CQ, KG, CP, PS>(p, s, m_run, l_part, acc, Pg, kt, qlo,
                                       row0, kg, sw, scale2);
    }

    cp_async_wait<0>();
    group_sync(1 + g, TG);  // V(kt) and P; the group is done with K(kt)
    if (kt + G < kt_hi)
      load_tile_f32<DP, KS, TG>(Kg, k, p.k_ss, (kt + G) * kF32BK, p.skv,
                                p.d, vec_load, t);
    cp_async_commit();

    if (live) {
      // acc += P V: each step of four keys reads RQ float4 of P and 4 CP / VW
      // vectors of V for 4 RQ CP FMAs
#pragma unroll 2
      for (int c0 = 0; c0 < kF32BK; c0 += 4) {
        float4 pa[RQ];
#pragma unroll
        for (int e = 0; e < RQ; ++e)
          pa[e] = *reinterpret_cast<const float4*>(
              Pg + (row0 + e) * PS + (((c0 / 4) ^ sw) * 4));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* const vrow = Vg + (c0 + kk) * VS + kg * VW;
#pragma unroll
          for (int j = 0; j < CP / VW; ++j) {
            float vb[VW];
            load_vec<VW>(vrow + j * KG * VW, vb);
#pragma unroll
            for (int e = 0; e < RQ; ++e) {
              const float pk = f4_at(pa[e], kk);
#pragma unroll
              for (int u = 0; u < VW; ++u)
                acc[e][j * VW + u] = fmaf(pk, vb[u], acc[e][j * VW + u]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  auto* o = static_cast<float*>(p.o) + bh * static_cast<int64_t>(p.sq) * p.d;
  const bool quads = (p.d % 4) == 0;
  // one group writes from its registers: the merge below gives the same
  // bits at G = 1 (f = 1, one buffer) but took 1.2% longer at MLA's
  // (1, 128, 512, 192) on an H100 (tools/flash_variants.py)
  if constexpr (G == 1) {
#pragma unroll
    for (int e = 0; e < RQ; ++e) {
      const float inv = 1.f / fmaxf(shfl_sum<KG>(l_part[e]), 1e-30f);
      const int row = q_start + row0 + e;
      if (row >= p.sq) continue;
      float* const orow = o + static_cast<int64_t>(row) * p.d;
#pragma unroll
      for (int j = 0; j < CP / VW; ++j) {
        const int c = j * KG * VW + kg * VW;
        if (VW == 4 && quads && c < p.d) {
          *reinterpret_cast<float4*>(orow + c) = make_float4(
              acc[e][j * 4] * inv, acc[e][j * 4 + 1] * inv,
              acc[e][j * 4 + 2] * inv, acc[e][j * 4 + 3] * inv);
        } else {
#pragma unroll
          for (int u = 0; u < VW; ++u)
            if (c + u < p.d) orow[c + u] = acc[e][j * VW + u] * inv;
        }
      }
    }
  } else {
    // merge the groups: m = max m_g, L = sum l_g 2^(m_g - m), out =
    // (sum acc_g 2^(m_g - m)) / max(L, 1e-30), summed in group order (the
    // division as a product with 1 / max(L, 1e-30))
    __syncthreads();  // every group is done with its K, V and P
    float* const ms = Ps;               // G x 64 maxima
    float* const ls = ms + G * kF32BQ;  // G x 64 sums
    float* const Ls = ls + G * kF32BQ;  // 64 merged 1 / max(L, 1e-30)
#pragma unroll
    for (int e = 0; e < RQ; ++e) {
      const float l = shfl_sum<KG>(l_part[e]);
      if (kg == 0) {
        ms[g * kF32BQ + row0 + e] = m_run[e];
        ls[g * kF32BQ + row0 + e] = l;
      }
    }
    __syncthreads();
    float* const buf = kv0 + g * kF32BQ * DP;  // this group's scaled acc
#pragma unroll
    for (int e = 0; e < RQ; ++e) {
      const int r = row0 + e;
      float m = ms[r];
#pragma unroll
      for (int g2 = 1; g2 < G; ++g2) m = fmaxf(m, ms[g2 * kF32BQ + r]);
      if (g == 0 && kg == 0) {
        float sum = 0.f;
#pragma unroll
        for (int g2 = 0; g2 < G; ++g2)
          sum += ls[g2 * kF32BQ + r] * ex2(ms[g2 * kF32BQ + r] - m);
        Ls[r] = 1.f / fmaxf(sum, 1e-30f);
      }
      const float f = ex2(m_run[e] - m);
#pragma unroll
      for (int j = 0; j < CP / VW; ++j) {
        float* const dst = buf + r * DP + j * KG * VW + kg * VW;
        if constexpr (VW == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              acc[e][j * 4] * f, acc[e][j * 4 + 1] * f,
              acc[e][j * 4 + 2] * f, acc[e][j * 4 + 3] * f);
        } else {
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[e][j * 2] * f, acc[e][j * 2 + 1] * f);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kF32BQ * DP / 4; i += kF32Threads) {
      const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
      const int row = q_start + r;
      if (row >= p.sq || c >= p.d) continue;
      float4 x = *reinterpret_cast<const float4*>(kv0 + r * DP + c);
#pragma unroll
      for (int g2 = 1; g2 < G; ++g2) {
        const float4 y = *reinterpret_cast<const float4*>(
            kv0 + g2 * kF32BQ * DP + r * DP + c);
        x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
      }
      const float inv = Ls[r];
      x = make_float4(x.x * inv, x.y * inv, x.z * inv, x.w * inv);
      float* const orow = o + static_cast<int64_t>(row) * p.d;
      if (quads) {
        *reinterpret_cast<float4*>(orow + c) = x;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < p.d) orow[c + u] = f4_at(x, u);
      }
    }
  }
}

template <int DP>
int launch_f32(const Params& p, int batch, int vec, cudaStream_t stream) {
  using L = F32Tile<DP>;
  auto kernel = flash_kernel<DP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(batch) * p.hq),
                  static_cast<unsigned>((p.sq + kF32BQ - 1) / kF32BQ));
  kernel<<<grid, kF32Threads, L::bytes, stream>>>(p, vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const Params& p, int batch, int vec, cudaStream_t stream) {
  if (p.d <= 32) return launch_f32<32>(p, batch, vec, stream);
  if (p.d <= 64) return launch_f32<64>(p, batch, vec, stream);
  if (p.d <= 96) return launch_f32<96>(p, batch, vec, stream);
  if (p.d <= 128) return launch_f32<128>(p, batch, vec, stream);
  if (p.d <= 192) return launch_f32<192>(p, batch, vec, stream);
  if (p.d <= 256) return launch_f32<256>(p, batch, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------ tensor-core route (bf16)
constexpr int kMmaThreads = 384;  // a producer warpgroup, two consumer ones
constexpr int kMmaBQ = 64;        // rows of a consumer's q tile
constexpr int kMmaBK = 64;        // keys of a kv tile
// The SM's shared memory (228 KiB), of which the runtime keeps 1 KiB for
// each CTA
constexpr size_t kSmemPerSM = 228 * 1024;
constexpr size_t kSmemPerCTA = 1024;
static_assert(kMmaBQ == kF32BQ && kMmaBK == kF32BK,
              "visited_range's tiles are the route's");

// CTAs an SM at a padded head dim, and the registers a thread of each role
// holds after setmaxnreg. Two CTAs an SM where a consumer's fragments (the
// 32 scores, DP / 2 of the accumulator, 16 of P) fit 104 registers: at DP
// <= 64. The producer's release pays for the consumers' raise out of the
// CTA's pool: 384 threads x 168 registers at launch (one CTA an SM) or x 80
// (two).
template <int DP>
struct MmaRegs {
  static constexpr int ctas = DP <= 64 ? 2 : 1;
  static constexpr int launch = ctas == 1 ? 168 : 80;
  static constexpr int producer = ctas == 1 ? 40 : 24;
  static constexpr int consumer = ctas == 1 ? 232 : 104;
  static_assert(128 * producer + 256 * consumer <= kMmaThreads * launch &&
                    kMmaThreads * launch * ctas <= 65536,
                "registers of a CTA");
};

// Shared memory of the tensor-core route at one padded head dim: the
// barriers, then two Q tiles (one a consumer), then `stages` pairs of K
// and V tiles, as many as the CTA's share of the SM holds. A tile is DP / W
// boxes of 64 rows x W columns, each as TMA writes it: rows of 2 W bytes,
// their 16-byte chunks swizzled within 8-row groups (128-byte swizzle at W =
// 64, 64-byte at W = 32, the widest that divides DP).
template <int DP>
struct MmaTile {
  static constexpr int W = DP % 64 == 0 ? 64 : 32;  // columns of a box
  static constexpr int NB = DP / W;                 // boxes of a tile
  static constexpr uint32_t row = 2 * W;            // bytes of a box row
  static constexpr uint32_t group = 8 * row;        // bytes of 8 rows
  static constexpr uint32_t box = kMmaBK * row;
  static constexpr uint32_t tile = NB * box;
  // wgmma's descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t layout = W == 64 ? 1 : 2;
  // 1 KiB to align the tiles to the swizzle's 1,024-byte period, 1 KiB of
  // barriers
  static constexpr size_t head = 2048;
  static constexpr size_t budget = MmaRegs<DP>::ctas == 1
                                       ? kSmemPerBlock
                                       : kSmemPerSM / MmaRegs<DP>::ctas -
                                             kSmemPerCTA;
  static constexpr int stages =
      static_cast<int>((budget - head - 2 * size_t(tile)) / (2 * tile));
  static constexpr size_t bytes = head + (2 + 2 * stages) * size_t(tile);
  static_assert(DP % 32 == 0 && DP <= 256, "DP: a multiple of 32, <= 256");
  static_assert(stages >= 2 && bytes <= budget, "two stages at least");
  static_assert(8 * (2 + 3 * stages) <= 1024, "the barriers' room");
};

// The tensor maps of q, k and v: 4-d, (d, s, h, b) with the views' strides,
// boxes of W columns x 64 rows
struct MmaMaps {
  CUtensorMap q, k, v;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the phase of `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers that an asynchronous wgmma reads or writes: the compiler keeps
// them in place, and moves no access to them across this point
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets, swizzle layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}
// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 64, float32) = A B^T (+ d where scale_d != 0): A (64 x 16) and
// B (64 x 16) bf16 in shared memory, both K-major, named by descriptors
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (64 x N, float32) += A B: A (64 x 16) bf16 in registers (the
// m16n8k16 A fragment of each warp's 16 rows), B (16 x N) bf16 in shared
// memory, MN-major (transposed), named by a descriptor
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// S (64 x 64) = Q K^T: both tiles K-major (d along a row). A step of 16
// columns lies inside one box, at 32 bytes a step within its rows.
template <int DP>
__device__ __forceinline__ void qk_product(float (&s)[32], uint32_t q,
                                           uint32_t k) {
  using L = MmaTile<DP>;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t off = (ks * 16 / L::W) * L::box + (ks * 16 % L::W) * 2;
    wgmma_ss_n64(s, smem_desc(q + off, 16, L::group, L::layout),
                 smem_desc(k + off, 16, L::group, L::layout), ks > 0);
  }
}
// O (64 x DP) += P V: P in registers, V MN-major (d along a row); the
// descriptor steps 8 keys by `group` bytes and W columns by a box
template <int DP>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&pa)[4][4],
                                           uint32_t v) {
  using L = MmaTile<DP>;
#pragma unroll
  for (int kk = 0; kk < kMmaBK / 16; ++kk)
    wgmma_rs<DP>(o, pa[kk],
                 smem_desc(v + kk * 2 * L::group, L::box, L::group,
                           L::layout));
}

// Scale, softcap and masks of a warp's 16 x 64 scores of kv tile kt (rows
// row and row + 8 of the q tile whose first row sits at position qlo; keys
// 8 j + 2 t4 + {0, 1}), in log2 units, then the online softmax of its two
// rows across their quad: m_run and l_part updated, corr the factor of the
// accumulator, and s replaced by p = exp(s - m), unrounded.
__device__ __forceinline__ void softmax_mma(const Params& p, float (&s)[32],
                                            float (&m_run)[2],
                                            float (&l_part)[2],
                                            float (&corr)[2], int kt,
                                            int qlo, int row, int t4,
                                            float scale2) {
  const int k_start = kt * kMmaBK;
  const int k_last = k_start + kMmaBK - 1;
  const bool masked = k_last >= p.skv || (p.causal && k_last > qlo) ||
                      (p.has_window && k_start <= qlo + kMmaBQ - 1 -
                                           p.window) ||
                      (p.has_kv_len && k_last >= p.kv_len);
  // sc: the scale s still needs. A tile that no softcap and no mask
  // reaches keeps its raw scores: its max scales exactly (scale2 > 0),
  // and exp takes the scale in one FMA with the max
  float sc = 1.f;
  if (p.has_cap) {
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = p.cap * tanhf(s[e] * p.scale / p.cap) * kLog2e;
  } else if (masked) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= scale2;
  } else {
    sc = scale2;
  }
  if (masked) {
    // score e is key k0 + off(e), off = 8 (e / 4) + (e & 1) a constant;
    // it is kept where lo_r < off <= hi_r for its row r, and is no key
    // from off >= past on
    const int k0 = k_start + 2 * t4;
    const int past = p.skv - k0;
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qlo + row + 8 * r;
      hi[r] = p.causal ? qpos - k0 : INT_MAX;
      if (p.has_kv_len) hi[r] = min(hi[r], p.kv_len - 1 - k0);
      lo[r] = p.has_window ? qpos - p.window - k0 : INT_MIN;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int off = 8 * (e / 4) + (e & 1), r = (e >> 1) & 1;
      if (off <= lo[r] || off > hi[r]) s[e] = kNegInf;
      if (off >= past) s[e] = -INFINITY;  // past the last key: no key
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < 32; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i] * sc);
    corr[i] = ex2(m_run[i] - m_new);
    m_run[i] = m_new;
    l_part[i] *= corr[i];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = ex2(fmaf(s[e], sc, -m_run[(e >> 1) & 1]));
    l_part[(e >> 1) & 1] += s[e];
  }
}
// p rounded to bf16: the score fragment of keys 16 kk .. 16 kk + 15 is the
// A fragment of P.V's step kk (rows row and row + 8, keys + 0 and + 8)
__device__ __forceinline__ void p_fragment(const float (&s)[32],
                                           uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}
// the accumulator's rows row and row + 8 times corr
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// Rows [row0, row0 + 64) of a (rows, d) bf16 matrix with row stride `ss`
// into a tile at `dst` in the layout TMA writes (rows >= `rows` and
// columns >= d zero), by the producer warpgroup's 128 threads with plain
// loads: the path of views that TMA cannot describe.
template <int DP>
__device__ __forceinline__ void fill_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t ss, int row0, int rows,
                                          int d, int t) {
  using L = MmaTile<DP>;
  constexpr int CPR = DP / 8;  // 16-byte chunks a row
  for (int i = t; i < kMmaBK * CPR; i += 128) {
    const int r = i / CPR, col0 = (i % CPR) * 8;
    const int row = row0 + r;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = col0 + 2 * e;
      uint32_t lo = 0, hi = 0;
      if (row < rows) {
        const __nv_bfloat16* x = src + row * ss + c;
        if (c < d) lo = __bfloat16_as_ushort(x[0]);
        if (c + 1 < d) hi = __bfloat16_as_ushort(x[1]);
      }
      w[e] = lo | hi << 16;
    }
    uint32_t off = (col0 / L::W) * L::box + r * L::row + (col0 % L::W) * 2;
    off ^= ((off >> 7) & (L::row / 16 - 1)) << 4;  // the swizzle
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + off),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// Every thread of the producer warpgroup has written its share of a tile
// with plain stores: make them visible to wgmma (the async proxy), then
// one thread arrives on `bar`
__device__ __forceinline__ void fill_done(uint32_t bar, int t) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  group_sync(1, 128);
  if (t == 0) mbar_arrive(bar);
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, MmaRegs<DP>::ctas)
flash_mma_kernel(const __grid_constant__ MmaMaps maps, const Params p,
                 int tma, int head_major) {
  using L = MmaTile<DP>;
  using R = MmaRegs<DP>;
  constexpr int NS = L::stages;
  constexpr int W = L::W;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  // barriers: Q (one a consumer), K full, V full and empty (one a stage)
  const uint32_t bar_q = base, bar_k = base + 16, bar_v = bar_k + 8 * NS,
                 bar_e = bar_v + 8 * NS;
  const uint32_t tiles = base + 1024;  // Q0, Q1, then K and V a stage
  auto q_smem = [&](int c) { return tiles + c * L::tile; };
  auto k_smem = [&](int st) { return tiles + (2 + 2 * st) * L::tile; };
  auto v_smem = [&](int st) { return tiles + (3 + 2 * st) * L::tile; };

  const int tid = threadIdx.x;
  // the CTA's (b * Hq + h, pair of q tiles 2 pair and 2 pair + 1): pair
  // by pair over all heads, or head by head (the pairs of one head in a
  // row, so that its K and V are read from L2); causal pairs last first
  const unsigned pairs = (p.sq + 2 * kMmaBQ - 1) / (2 * kMmaBQ);
  const unsigned heads = gridDim.x / pairs;
  const unsigned bh = head_major ? blockIdx.x / pairs : blockIdx.x % heads;
  const unsigned slot = head_major ? blockIdx.x % pairs : blockIdx.x / heads;
  const int pair = static_cast<int>(p.causal ? pairs - 1 - slot : slot);
  const int b = static_cast<int>(bh / p.hq);
  const int h = static_cast<int>(bh % p.hq);
  const int kvh = h / (p.hq / p.hkv);

  // the kv tiles each consumer's q tile visits, and their union, which the
  // producer loads; an empty range sits at the union's start
  const int nk = (p.skv + kMmaBK - 1) / kMmaBK;
  int lo[2], hi[2];
  int ulo = nk, uhi = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int q_start = (2 * pair + c) * kMmaBQ;
    lo[c] = hi[c] = 0;
    if (q_start < p.sq) visited_range(p, p.q0 + q_start, nk, lo[c], hi[c]);
    if (lo[c] < hi[c]) {
      ulo = min(ulo, lo[c]);
      uhi = max(uhi, hi[c]);
    }
  }
  if (ulo >= uhi) ulo = uhi = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (lo[c] >= hi[c]) lo[c] = hi[c] = ulo;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, 8);  // a warp of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: Q once, then K and V of the union's kv tiles into the
    // ring, each stage once both consumers have released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R::producer));
    const auto* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                    h * p.q_sh;
    const auto* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                    kvh * p.k_sh;
    const auto* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                    kvh * p.v_sh;
    if (tma && tid != 0) return;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (lo[c] >= hi[c]) continue;  // no consumer waits for it
      const int q_start = (2 * pair + c) * kMmaBQ;
      if (tma) {
        mbar_expect_tx(bar_q + 8 * c, L::tile);
        for (int bx = 0; bx < L::NB; ++bx)
          tma_load(q_smem(c) + bx * L::box, &maps.q, bx * W, q_start, h, b,
                   bar_q + 8 * c);
      } else {
        fill_tile<DP>(q_smem(c), q, p.q_ss, q_start, p.sq, p.d, tid);
        fill_done(bar_q + 8 * c, tid);
      }
    }
    int st = 0;
    uint32_t ph = 0;
    for (int i = ulo; i < uhi; ++i) {
      if (i - ulo >= NS) mbar_wait(bar_e + 8 * st, ph ^ 1);
      if (tma) {
        mbar_expect_tx(bar_k + 8 * st, L::tile);
        for (int bx = 0; bx < L::NB; ++bx)
          tma_load(k_smem(st) + bx * L::box, &maps.k, bx * W, i * kMmaBK,
                   kvh, b, bar_k + 8 * st);
        mbar_expect_tx(bar_v + 8 * st, L::tile);
        for (int bx = 0; bx < L::NB; ++bx)
          tma_load(v_smem(st) + bx * L::box, &maps.v, bx * W, i * kMmaBK,
                   kvh, b, bar_v + 8 * st);
      } else {
        fill_tile<DP>(k_smem(st), k, p.k_ss, i * kMmaBK, p.skv, p.d, tid);
        fill_done(bar_k + 8 * st, tid);
        fill_tile<DP>(v_smem(st), v, p.v_ss, i * kMmaBK, p.skv, p.d, tid);
        fill_done(bar_v + 8 * st, tid);
      }
      if (++st == NS) st = 0, ph ^= 1;
    }
    return;
  }

  // ---- consumers: warpgroup c + 1 owns q tile 2 pair + c
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R::consumer));
  const int c = tid / 128 - 1;
  const int lane = tid % 32;
  const int row = (tid % 128) / 32 * 16 + lane / 4;  // the thread's first row
  const int t4 = lane % 4;
  const int my_lo = c ? lo[1] : lo[0], my_hi = c ? hi[1] : hi[0];
  const int q_start = (2 * pair + c) * kMmaBQ;
  const int qlo = p.q0 + q_start;  // position of the tile's first row
  const float scale2 = p.scale * kLog2e;

  float o[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
  // rows row and row + 8: the running max (log2 units) and this thread's
  // part of the running sum (the quad's four parts are added at the end)
  float m_run[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};
  float s[32];
  uint32_t pa[4][4];
  float corr[2];

  // the ring's read position: stage and the parity of its fill
  int st = 0;
  uint32_t ph = 0;
  auto release = [&](int stage) {
    if (lane == 0) mbar_arrive(bar_e + 8 * stage);
  };
  auto advance = [&]() {
    if (++st == NS) st = 0, ph ^= 1;
  };
  // a kv tile the union loads and this tile does not visit: released once
  // it has arrived, so that the ring's phases stay in step
  auto skip = [&]() {
    mbar_wait(bar_k + 8 * st, ph);
    mbar_wait(bar_v + 8 * st, ph);
    release(st);
    advance();
  };
  for (int i = ulo; i < my_lo; ++i) skip();
  if (my_lo < my_hi) {
    const uint32_t qs = q_smem(c);
    mbar_wait(bar_q + 8 * c, 0);
    // a tile: S = Q K^T, its softmax, then O = O corr + P V; the other
    // consumer's products run while this one's softmax does
    for (int i = my_lo; i < my_hi; ++i) {
      mbar_wait(bar_k + 8 * st, ph);
      reg_fence(s);
      wg_fence();
      qk_product<DP>(s, qs, k_smem(st));
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      softmax_mma(p, s, m_run, l_part, corr, i, qlo, row, t4, scale2);
      p_fragment(s, pa);
      rescale(o, corr);
      mbar_wait(bar_v + 8 * st, ph);
      reg_fence(o);
      reg_fence(pa);
      wg_fence();
      pv_product<DP>(o, pa, v_smem(st));
      wg_commit();
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      release(st);
      advance();
    }
  }
  // tiles past this q tile's range whose stages a later load reuses
  for (int i = my_hi; i + NS < uhi; ++i) skip();

  // out = O / max(l, 1e-30), rows < Sq, columns < d
  auto* out = static_cast<__nv_bfloat16*>(p.o) +
              static_cast<int64_t>(bh) * p.sq * p.d;
  const bool even = (p.d % 2) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int r = q_start + row + 8 * i;
    if (r >= p.sq) continue;
    __nv_bfloat16* orow = out + static_cast<int64_t>(r) * p.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t4;
      const float x0 = o[4 * j + 2 * i] * inv;
      const float x1 = o[4 * j + 2 * i + 1] * inv;
      if (even && col + 1 < p.d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < p.d) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < p.d) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
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
// kernel then loads by plain loads)
template <int DP>
bool encode_maps(MmaMaps* m, const Params& p, int batch) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  auto one = [&](CUtensorMap* map, const void* ptr, int s, int h,
                 int64_t ss, int64_t sh, int64_t sb) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.d),
                                static_cast<cuuint64_t>(s),
                                static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                   static_cast<cuuint64_t>(sh) * 2,
                                   static_cast<cuuint64_t>(sb) * 2};
    const cuuint32_t box[4] = {MmaTile<DP>::W, kMmaBK, 1, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  MmaTile<DP>::W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  return one(&m->q, p.q, p.sq, p.hq, p.q_ss, p.q_sh, p.q_sb) &&
         one(&m->k, p.k, p.skv, p.hkv, p.k_ss, p.k_sh, p.k_sb) &&
         one(&m->v, p.v, p.skv, p.hkv, p.v_ss, p.v_sh, p.v_sb);
}

template <int DP>
int launch_mma(const Params& p, int batch, int vec, cudaStream_t stream) {
  using L = MmaTile<DP>;
  auto kernel = flash_mma_kernel<DP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int64_t ctas = static_cast<int64_t>(batch) * p.hq *
                       ((p.sq + 2 * kMmaBQ - 1) / (2 * kMmaBQ));
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  MmaMaps maps;
  memset(&maps, 0, sizeof maps);
  const int tma = vec && encode_maps<DP>(&maps, p, batch) ? 1 : 0;
  // head by head where K and V of all heads would not stay in half the L2
  // (deepseek-v2's MLA: 201 MB), else pair by pair, the longest first
  static const int l2_bytes = [] {
    int dev = 0, bytes = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, dev);
    return bytes;
  }();
  const int64_t kv_bytes = 4LL * batch * p.hkv * p.skv * p.d;
  const int head_major = 2 * kv_bytes > l2_bytes ? 1 : 0;
  kernel<<<static_cast<unsigned>(ctas), kMmaThreads, L::bytes, stream>>>(
      maps, p, tma, head_major);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(const Params& p, int batch, int vec, cudaStream_t stream) {
  if (p.d <= 32) return launch_mma<32>(p, batch, vec, stream);
  if (p.d <= 64) return launch_mma<64>(p, batch, vec, stream);
  if (p.d <= 96) return launch_mma<96>(p, batch, vec, stream);
  if (p.d <= 128) return launch_mma<128>(p, batch, vec, stream);
  if (p.d <= 192) return launch_mma<192>(p, batch, vec, stream);
  if (p.d <= 256) return launch_mma<256>(p, batch, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface (bound with ctypes), one entry point a route. Each launches
// on `stream`, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue, without a launch, for an empty shape or one its
// route does not take). dtype: 0 float32, 1 bfloat16. has_* = 0 means the
// option is off (None in Python).
extern "C" {

#define FLASH_ARGS                                                          \
  const void *q, const void *k, const void *v, void *o, int64_t q_sb,       \
      int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, \
      int64_t v_sb, int64_t v_sh, int64_t v_ss, int batch, int hq, int hkv, \
      int sq, int skv, int d, int dtype, int causal, int has_window,        \
      int window, int has_cap, float cap, int has_kv_len, int kv_len,       \
      int q0, float scale, void *stream

static bool make_params(Params* p, FLASH_ARGS) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 ||
      skv < 1 || d < 1 || d > 256 || (sq + 31) / 32 > 65535)
    return false;
  *p = Params{q,    k,    v,    o,    q_sb, q_sh,       q_ss,   k_sb,
              k_sh, k_ss, v_sb, v_sh, v_ss, hq,         hkv,    sq,
              skv,  d,    causal, has_window, window,   has_cap,
              has_kv_len, kv_len, q0, scale, cap};
  return true;
}

// the CUDA-core route: float32, D <= 256
int flash_attention(FLASH_ARGS) {
  Params p;
  if (dtype != 0 ||
      !make_params(&p, q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                   v_sh, v_ss, batch, hq, hkv, sq, skv, d, dtype, causal,
                   has_window, window, has_cap, cap, has_kv_len, kv_len, q0,
                   scale, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte rows and bases: the asynchronous copy; else plain loads
  const int64_t strides[] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                             v_sb, v_sh, v_ss};
  bool vec = d % 4 == 0;
  for (int64_t st : strides) vec = vec && st % 4 == 0;
  const void* bases[] = {q, k, v};
  for (const void* ptr : bases)
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  return dispatch_f32(p, batch, vec ? 1 : 0,
                      static_cast<cudaStream_t>(stream));
}

// the tensor-core route: bfloat16, D <= 256
int flash_attention_mma(FLASH_ARGS) {
  Params p;
  if (dtype != 1 ||
      !make_params(&p, q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                   v_sh, v_ss, batch, hq, hkv, sq, skv, d, dtype, causal,
                   has_window, window, has_cap, cap, has_kv_len, kv_len, q0,
                   scale, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte rows and bases: TMA, where cuTensorMapEncodeTiled takes the
  // views; else the producer's plain loads
  const int64_t strides[] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                             v_sb, v_sh, v_ss};
  bool vec = d % 8 == 0;
  for (int64_t st : strides) vec = vec && st % 8 == 0;
  const void* bases[] = {q, k, v};
  for (const void* ptr : bases)
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  return dispatch_mma(p, batch, vec ? 1 : 0,
                      static_cast<cudaStream_t>(stream));
}

#undef FLASH_ARGS

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
