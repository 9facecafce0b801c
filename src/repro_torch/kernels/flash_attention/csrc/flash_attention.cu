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
// dimension, and D is zero-padded inside shared memory. Causal q tiles are
// launched last tile first: the last tile of a head visits the most kv
// tiles, so the longest CTAs start first and the short ones fill the tail.
//
// Two routes, each its own C entry point, chosen by dtype alone:
//
// flash_attention_mma (bfloat16, D <= 256; D padded to 32/64/96/128/192/
// 256): the tensor-core route. Design: one CTA of four warps per
// (b*Hq + h, 64-row q tile); each warp owns 16 query rows. QK^T and P.V
// run as bf16 mma.sync.m16n8k16 with float32 accumulators (bf16 x bf16
// products are exact in float32, as the Pallas kernel's widened product
// is). The score fragment stays in registers: the softmax's row max and
// row sum reduce across the four threads of a quad with shuffles, and the
// score accumulator, rounded to bf16, is in registers the A operand of
// P.V. Q, K and V tiles stay bf16 in shared memory with rows padded by 16
// bytes (an odd number of 16-byte units a row: ldmatrix's eight row
// addresses fall in eight different bank groups, no conflicts) and are
// read with ldmatrix (.trans for V); Q's fragments are reread from shared
// memory at each kv tile rather than held, so that registers stay under
// the cap that lets 4 / 3 / 2 CTAs share an SM (D <= 64 / 96 / 128). K
// tiles are double-buffered with 16-byte cp.async, so the next tile's copy
// overlaps this tile's products, and so are V tiles, except where one V
// stage lets two CTAs share an SM (DP = 192, below); a view whose rows are
// not 16-byte aligned is copied by plain loads instead. A tile that no
// mask and no key past Skv reaches skips the per-element mask tests. Each
// q head of a GQA group reads its K/V tiles itself (they stay in the 50 MB
// L2); sharing them across the group in one CTA is not done.
//
// What bounds it on this card: at qwen2-0.5b's prefill shape (8 x 14/2
// heads, S = 512, D = 64) the causal work is ~3.8 GFLOP against ~17 MB of
// HBM traffic, 224 FLOP a byte; at deepseek-v2's MLA prefill (4 x 128
// heads, S = 512, D = 192, v zero-padded from 128 columns) ~51.6 GFLOP
// against ~403 MB, ~128 FLOP a byte. Both lie under the bf16 tensor-core
// ridge (~295 FLOP a byte), so at the card's peaks the bytes bound them
// (~5 us and ~0.12 ms).
//
// Wide heads (DP = 192, 256) keep the 64 x 64 tile. The tile is part of
// the function: a row whose visited keys are all masked averages the keys
// of the tiles it visits, so another BQ or BK would change such rows.
// The price is registers and shared memory: a warp's 16 x DP float32
// accumulator takes DP / 2 registers a thread (96 at 192, 128 at 256)
// beside the 32 of its 16 x 64 score fragment, so one or two CTAs fit an
// SM at 255 registers a thread. Q and two stages of K and V take 128,000
// B at DP = 192 and 168,960 B at DP = 256, one CTA an SM; at DP = 192 a
// single V stage (102,400 B) lets two CTAs share an SM, and its V copy
// overlaps the tile's Q K^T and softmax instead of the previous tile's
// products. With four warps an SM the kernel stalls on its own
// latencies, so a second CTA is worth more than a second V stage: at the
// MLA shape it runs in ~0.6 of the two-stage time (an H100,
// tools/flash_variants.py).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

// ------------------------------------------------ tensor-core route (bf16)
constexpr int kMmaThreads = 128;  // four warps, 16 query rows each
constexpr int kMmaBQ = 64;
constexpr int kMmaBK = 64;

// The shared memory of an H100 SM (228 KiB), of which the runtime keeps
// 1 KiB for each CTA
constexpr size_t kSmemPerSM = 228 * 1024;
constexpr size_t kSmemPerCTA = 1024;

// CTAs that one SM holds at `bytes` of dynamic shared memory each
constexpr int smem_ctas(size_t bytes) {
  return static_cast<int>(kSmemPerSM / (bytes + kSmemPerCTA));
}

// Shared memory of the tensor-core route: Q, two stages of K, and two
// stages of V, or one (SV) where that lets two CTAs share an SM.
template <int DP>
struct MmaTile {
  static constexpr int RS = DP + 8;  // row stride in bf16: 16 bytes of pad
  static constexpr int elems = kMmaBQ * RS;  // one Q, K or V tile
  static constexpr size_t tile = sizeof(__nv_bfloat16) * elems;
  static constexpr bool SV =
      smem_ctas(5 * tile) < 2 && smem_ctas(4 * tile) >= 2;
  static constexpr int tiles = SV ? 4 : 5;
  static constexpr size_t bytes = tiles * tile;
  static_assert(kMmaBQ == kMmaBK, "one tile shape for Q, K and V");
  static_assert(DP % 16 == 0 && DP <= 256, "DP: a multiple of 16, <= 256");
};

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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a (rows, d) bf16 matrix with row stride `ss`
// into a padded DP-wide shared tile; rows >= `rows` and columns >= d are
// zero. vec: d, the strides and the base are 16-byte multiples, so the
// copy is asynchronous (cp.async, to be waited for); otherwise it is made
// by plain loads and stores.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t ss, int row0, int rows,
                                          int d, bool vec, int tid) {
  constexpr int RS = MmaTile<DP>::RS;
  if (vec) {
    constexpr int CPR = DP / 8;  // 16-byte chunks a row
#pragma unroll
    for (int i = tid; i < kMmaBQ * CPR; i += kMmaThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int row = row0 + r;
      const bool in = row < rows && c < d;
      cp_async16(smem_addr(dst + r * RS + c), in ? src + row * ss + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kMmaBQ * DP; i += kMmaThreads) {
      const int r = i / DP, c = i % DP;
      const int row = row0 + r;
      dst[r * RS + c] = (row < rows && c < d) ? src[row * ss + c]
                                              : __float2bfloat16_rn(0.f);
    }
  }
}

// CTAs an SM should hold: registers are capped at 65,536 / (128 x this),
// 255 a thread from two CTAs down. No more than the shared tiles let in.
template <int DP>
constexpr int mma_min_blocks() {
  constexpr int by_regs = DP <= 64 ? 4 : (DP <= 96 ? 3 : 2);
  constexpr int by_smem = smem_ctas(MmaTile<DP>::bytes);
  return by_regs < by_smem ? by_regs : by_smem;
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<DP>())
flash_mma_kernel(Params p, int vec) {
  using L = MmaTile<DP>;
  constexpr int RS = L::RS;
  constexpr int KS = DP / 16;      // k-steps of Q K^T
  constexpr int NT = kMmaBK / 8;   // 8-key column tiles of the scores
  constexpr int OT = DP / 8;       // 8-wide column tiles of the output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  auto Ks = [&](int st) { return Qs + (1 + st) * L::elems; };
  auto Vs = [&](int st) { return Qs + (3 + (L::SV ? 0 : st)) * L::elems; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row / column pair

  const int64_t bh = blockIdx.x;  // b * Hq + h
  const int b = static_cast<int>(bh / p.hq);
  const int h = static_cast<int>(bh % p.hq);
  const int kvh = h / (p.hq / p.hkv);
  const int q_start = q_tile(p.causal) * kMmaBQ;
  const int qlo = p.q0 + q_start;  // position of the tile's first row

  const auto* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                  h * p.q_sh;
  const auto* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                  kvh * p.k_sh;
  const auto* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                  kvh * p.v_sh;

  // the kv tiles this q tile visits: the whole-tile skip rule of
  // _flash_kernel leaves one contiguous range
  const int nk = (p.skv + kMmaBK - 1) / kMmaBK;
  int kt_lo = 0, kt_hi = nk;
  if (p.causal) {  // skip k_start > qlo + BQ - 1
    const int64_t last = static_cast<int64_t>(qlo) + kMmaBQ - 1;
    const int64_t end = last / kMmaBK + 1;
    kt_hi = last < 0 ? 0 : static_cast<int>(end < nk ? end : nk);
  }
  if (p.has_window) {  // skip k_start + BK - 1 <= qlo - window
    const int64_t edge = static_cast<int64_t>(qlo) - p.window - kMmaBK + 1;
    const int64_t first = edge / kMmaBK + 1;
    kt_lo = edge < 0 ? 0 : static_cast<int>(first < nk ? first : nk);
  }

  // Copy groups, oldest first: Q and the first K tile (and V tile, with
  // two V stages); the first V tile (with one V stage; else empty); then
  // each kv tile commits one group at its start, the next K (and V) tile,
  // and one at its end, the next V tile (with one V stage; else empty).
  // So at the start of tile kt only the newest two groups may still be in
  // flight, and K(kt) is in place; with one V stage, V(kt) is in place
  // once only the newest one is.
  const bool vec_load = vec != 0;
  load_tile<DP>(Qs, q, p.q_ss, q_start, p.sq, p.d, vec_load, tid);
  if (kt_lo < kt_hi) {
    load_tile<DP>(Ks(0), k, p.k_ss, kt_lo * kMmaBK, p.skv, p.d, vec_load,
                  tid);
    if (!L::SV)
      load_tile<DP>(Vs(0), v, p.v_ss, kt_lo * kMmaBK, p.skv, p.d, vec_load,
                    tid);
  }
  cp_async_commit();
  if (L::SV && kt_lo < kt_hi)
    load_tile<DP>(Vs(0), v, p.v_ss, kt_lo * kMmaBK, p.skv, p.d, vec_load,
                  tid);
  cp_async_commit();

  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows g and g + 8 of the warp's 16: the running max, and this thread's
  // part of the running sum (the quad's four parts are added at the end)
  float m_run[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};

  const int row_base = warp * 16;
  const int qpos0 = qlo + row_base + g;  // position of row g
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {  // prefetch the next tile into the other stage
      load_tile<DP>(Ks(st ^ 1), k, p.k_ss, (kt + 1) * kMmaBK, p.skv, p.d,
                    vec_load, tid);
      if (!L::SV)
        load_tile<DP>(Vs(st ^ 1), v, p.v_ss, (kt + 1) * kMmaBK, p.skv, p.d,
                      vec_load, tid);
    }
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();  // K(kt) (and, the first time, Q) is in place

    // S = Q K^T for the warp's 16 rows x 64 keys, in registers
    const __nv_bfloat16* ks_tile = Ks(st);
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];  // Q's A fragment, reread: registers are scarcer
      ldsm_x4(qa, smem_addr(Qs + (row_base + lane % 16) * RS + ks * 16 +
                            8 * (lane / 16)));
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_addr(ks_tile +
                              (j2 * 16 + lane % 8 + 8 * (lane / 16)) * RS +
                              ks * 16 + 8 * ((lane / 8) % 2)));
        mma_bf16(s[2 * j2], qa, bk[0], bk[1]);
        mma_bf16(s[2 * j2 + 1], qa, bk[2], bk[3]);
      }
    }

    // scale, softcap, masks; then the online softmax of rows g and g + 8.
    // A tile that no mask and no key past Skv reaches skips the tests.
    const int k_start = kt * kMmaBK;
    const int k_last = k_start + kMmaBK - 1;
    const bool masked = k_last >= p.skv ||
                        (p.causal && k_last > qlo) ||
                        (p.has_window && k_start <= qlo + kMmaBQ - 1 -
                                                        p.window) ||
                        (p.has_kv_len && k_last >= p.kv_len);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (p.has_cap) x = p.cap * tanhf(x / p.cap);
        if (masked) {
          const int kpos = k_start + j * 8 + 2 * t4 + (e & 1);
          const int qpos = qpos0 + 8 * (e >> 1);
          bool keep = true;
          if (p.causal) keep = keep && kpos <= qpos;
          if (p.has_window) keep = keep && kpos > qpos - p.window;
          if (p.has_kv_len) keep = keep && kpos < p.kv_len;
          if (!keep) x = kNegInf;
          if (kpos >= p.skv) x = -INFINITY;  // past the last key: no key
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      corr[i] = __expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_part[i] *= corr[i];
    }
    // p = exp(s - m): l sums it unrounded, P.V takes it rounded to bf16;
    // the score fragment of keys 16kk..16kk+15 is the A fragment of P.V
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float e4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        e4[e] = __expf(s[j][e] - m_run[e >> 1]);
        l_part[e >> 1] += e4[e];
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(e4[0], e4[1]);      // row g
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(e4[2], e4[3]);  // row g + 8
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    if (L::SV) {
      cp_async_wait<1>();
      __syncthreads();  // V(kt) is in place
    }

    // acc += P V
    const __nv_bfloat16* vs_tile = Vs(st);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < OT / 2; ++j2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, smem_addr(vs_tile +
                                    (kk * 16 + lane % 8 +
                                     8 * ((lane / 8) % 2)) * RS +
                                    j2 * 16 + 8 * (lane / 16)));
        mma_bf16(acc[2 * j2], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * j2 + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage st is consumed before it is loaded again
    if (L::SV && kt + 1 < kt_hi)
      load_tile<DP>(Vs(0), v, p.v_ss, (kt + 1) * kMmaBK, p.skv, p.d,
                    vec_load, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[i] = fmaxf(l, 1e-30f);
  }
  auto* o = static_cast<__nv_bfloat16*>(p.o) +
            bh * static_cast<int64_t>(p.sq) * p.d;
  const bool pairs = (p.d % 2) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q_start + row_base + g + 8 * i;
    if (row >= p.sq) continue;
    __nv_bfloat16* orow = o + static_cast<int64_t>(row) * p.d;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int c = j * 8 + 2 * t4;
      const float x0 = acc[j][2 * i] / l_row[i];
      const float x1 = acc[j][2 * i + 1] / l_row[i];
      if (pairs && c + 1 < p.d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < p.d) orow[c] = __float2bfloat16_rn(x0);
        if (c + 1 < p.d) orow[c + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DP>
int launch_mma(const Params& p, int batch, int vec, cudaStream_t stream) {
  using L = MmaTile<DP>;
  auto kernel = flash_mma_kernel<DP>;
  static bool configured = false;
  if (!configured) {
    // all of the SM's unified memory as shared memory: room for
    // mma_min_blocks CTAs' tiles
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
                  static_cast<unsigned>((p.sq + kMmaBQ - 1) / kMmaBQ));
  kernel<<<grid, kMmaThreads, L::bytes, stream>>>(p, vec);
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
  // 16-byte rows and bases: the asynchronous copy; else plain loads
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
