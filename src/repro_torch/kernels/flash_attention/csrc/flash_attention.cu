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
// Two routes, each its own C entry point, chosen by dtype and D:
//
// flash_attention_mma (bfloat16, D <= 128; D padded to 32/64/96/128): the
// tensor-core route. What bounds it on this card: at qwen2-0.5b's prefill
// shape (8 x 14/2 heads, S = 512, D = 64) the causal work is ~3.8 GFLOP
// against ~17 MB of HBM traffic, 224 FLOP a byte, just under the bf16
// tensor-core ridge (~295), so at the card's peaks the bytes bound it
// (~5 us). Design: one CTA of four warps per (b*Hq + h, 64-row q tile);
// each warp owns 16 query rows. QK^T and P.V run as bf16
// mma.sync.m16n8k16 with float32 accumulators (bf16 x bf16 products are
// exact in float32, as the Pallas kernel's widened product is). The score
// fragment stays in registers: the softmax's row max and row sum reduce
// across the four threads of a quad with shuffles, and the score
// accumulator, rounded to bf16, is in registers the A operand of P.V.
// Q, K and V tiles stay bf16 in shared memory with rows padded by 16 bytes
// (an odd number of 16-byte units a row: ldmatrix's eight row addresses
// fall in eight different bank groups, no conflicts) and are read with
// ldmatrix (.trans for V); Q's fragments are reread from shared memory at
// each kv tile rather than held, so that registers stay under the cap
// that lets 4 / 3 / 2 CTAs share an SM (D <= 64 / 96 / 128). K/V tiles
// are double-buffered with 16-byte cp.async, so the next tile's copy
// overlaps this tile's products; a view whose rows are not 16-byte
// aligned is copied by plain loads instead. A tile that no mask and no
// key past Skv reaches skips the per-element mask tests.
// Each q head of a GQA group reads its K/V tiles itself (they stay in the
// 50 MB L2); sharing them across the group in one CTA is not done.
//
// flash_attention (float32 at any D <= 256, bfloat16 at 128 < D <= 256):
// the CUDA-core route. Float32 inputs are multiplied in full float32 (no
// TF32), and bf16 at D = 256 keeps it too: its 16 x 256 float32
// accumulator a warp would need 128 registers a thread beside the scores.
// Every product is a float32 FMA (67 TFLOP/s peak). One CTA per
// (b*Hq + h, q tile); the Q tile, one K and one V tile and the score tile
// live in shared memory as float32 (rows padded by one float against bank
// conflicts); the accumulator lives in registers, 128 threads each owning
// a (BQ/16) x (DP/8) block of it; each warp runs the softmax of a quarter
// of the rows with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kRowGroups = 16;  // threads along the rows of a tile
constexpr int kColGroups = 8;   // threads along its columns
constexpr int kWarps = kThreads / 32;

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
// p as the P.V product sees it: rounded to v's dtype
template <typename T>
__device__ __forceinline__ float as_v_dtype(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The q tile of this CTA. Causal tiles run last tile first, so the CTAs
// that visit the most kv tiles are launched first.
__device__ __forceinline__ int q_tile(int causal) {
  return causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                : static_cast<int>(blockIdx.y);
}

template <int DP, int BQ, int BK>
struct Tile {
  static constexpr int QS = DP + 1;  // row stride of the Q and K tiles
  static constexpr int SS = BK + 1;  // row stride of the score tile
  static constexpr int floats =
      BQ * QS + BK * QS + BK * DP + BQ * SS + 3 * BQ;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  using L = Tile<DP, BQ, BK>;
  constexpr int QS = L::QS, SS = L::SS;
  constexpr int RPT = BQ / kRowGroups;  // accumulator rows per thread
  constexpr int SPT = BK / kColGroups;  // score columns per thread
  constexpr int OPT = DP / kColGroups;  // accumulator columns per thread
  constexpr int CPL = BK / 32;          // score columns per lane (softmax)
  static_assert(BQ % kRowGroups == 0 && BK % 32 == 0 && DP % kColGroups == 0,
                "tile shape");

  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x QS
  float* Ks = Qs + BQ * QS;     // BK x QS
  float* Vs = Ks + BK * QS;     // BK x DP
  float* Ss = Vs + BK * DP;     // BQ x SS: scores, then p
  float* m_s = Ss + BQ * SS;    // BQ running max
  float* l_s = m_s + BQ;        // BQ running sum
  float* c_s = l_s + BQ;        // BQ correction of this tile

  const int tid = threadIdx.x;
  const int tr = tid / kColGroups;
  const int tc = tid % kColGroups;
  const int warp = tid / 32, lane = tid % 32;

  const int64_t bh = blockIdx.x;  // b * Hq + h
  const int b = static_cast<int>(bh / p.hq);
  const int h = static_cast<int>(bh % p.hq);
  const int kvh = h / (p.hq / p.hkv);
  const int q_start = q_tile(p.causal) * BQ;
  const int qlo = p.q0 + q_start;  // position of the tile's first row

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < BQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int row = q_start + r;
    Qs[r * QS + c] =
        (row < p.sq && c < p.d) ? to_f32(q[row * p.q_ss + c]) : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  float acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;

  const int nk = (p.skv + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * BK;
    // the whole-tile skip rule of _flash_kernel (uniform over the block)
    if (p.causal && k_start > qlo + BQ - 1) break;
    if (p.has_window && !(k_start + BK - 1 > qlo - p.window)) continue;

    __syncthreads();  // the previous tile's K, V and p are consumed
    for (int i = tid; i < BK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const int key = k_start + r;
      const bool in = key < p.skv && c < p.d;
      Ks[r * QS + c] = in ? to_f32(k[key * p.k_ss + c]) : 0.f;
      Vs[r * DP + c] = in ? to_f32(v[key * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T: thread (tr, tc) owns rows tr + 16 i and columns tc + 8 j
    float sc[RPT][SPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float qa[RPT], kb[SPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = Qs[(tr + kRowGroups * i) * QS + dd];
#pragma unroll
      for (int j = 0; j < SPT; ++j) kb[j] = Ks[(tc + kColGroups * j) * QS + dd];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < SPT; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        Ss[(tr + kRowGroups * i) * SS + tc + kColGroups * j] = sc[i][j];
    __syncthreads();

    // online softmax, one warp per row at a time
    for (int r = warp; r < BQ; r += kWarps) {
      const int qpos = qlo + r;
      float sv[CPL];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        const int kpos = k_start + c;
        float s;
        if (kpos >= p.skv) {
          s = -INFINITY;  // past the last key: not a key at all
        } else {
          s = Ss[r * SS + c] * p.scale;
          if (p.has_cap) s = p.cap * tanhf(s / p.cap);
          bool keep = true;
          if (p.causal) keep = keep && kpos <= qpos;
          if (p.has_window) keep = keep && kpos > qpos - p.window;
          if (p.has_kv_len) keep = keep && kpos < p.kv_len;
          if (!keep) s = kNegInf;
        }
        sv[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float e = expf(sv[j] - m_new);
        sum += e;
        Ss[r * SS + lane + 32 * j] = as_v_dtype<T>(e);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = c_s[tr + kRowGroups * i];
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[RPT], vb[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pa[i] = Ss[(tr + kRowGroups * i) * SS + c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) vb[j] = Vs[c * DP + tc + kColGroups * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* o = static_cast<T*>(p.o) + bh * static_cast<int64_t>(p.sq) * p.d;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tr + kRowGroups * i;
    const int row = q_start + r;
    if (row >= p.sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int c = tc + kColGroups * j;
      if (c < p.d)
        o[static_cast<int64_t>(row) * p.d + c] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int DP, int BQ, int BK>
int launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Tile<DP, BQ, BK>;
  auto kernel = flash_kernel<T, DP, BQ, BK>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(batch) * p.hq),
                  static_cast<unsigned>((p.sq + BQ - 1) / BQ));
  kernel<<<grid, kThreads, L::bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const Params& p, int batch, cudaStream_t stream) {
  if (p.d <= 16) return launch<float, 16, 64, 64>(p, batch, stream);
  if (p.d <= 32) return launch<float, 32, 64, 64>(p, batch, stream);
  if (p.d <= 64) return launch<float, 64, 64, 64>(p, batch, stream);
  if (p.d <= 128) return launch<float, 128, 64, 32>(p, batch, stream);
  return launch<float, 256, 32, 32>(p, batch, stream);
}


// ------------------------------------------------ tensor-core route (bf16)
constexpr int kMmaThreads = 128;  // four warps, 16 query rows each
constexpr int kMmaBQ = 64;
constexpr int kMmaBK = 64;

template <int DP>
struct MmaTile {
  static constexpr int RS = DP + 8;  // row stride in bf16: 16 bytes of pad
  static constexpr int elems = kMmaBQ * RS;  // one Q, K or V tile
  // Q, then two stages of (K, V)
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * 5 * elems;
  static_assert(kMmaBQ == kMmaBK, "one tile shape for Q, K and V");
  static_assert(DP % 16 == 0 && DP <= 128, "DP: a multiple of 16, <= 128");
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

// CTAs an SM should hold: registers are capped at 65,536 / (128 x this)
template <int DP>
constexpr int mma_min_blocks() {
  return DP <= 64 ? 4 : (DP <= 96 ? 3 : 2);
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
  auto Ks = [&](int st) { return Qs + (1 + 2 * st) * L::elems; };
  auto Vs = [&](int st) { return Qs + (2 + 2 * st) * L::elems; };

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

  const bool vec_load = vec != 0;
  load_tile<DP>(Qs, q, p.q_ss, q_start, p.sq, p.d, vec_load, tid);
  if (kt_lo < kt_hi) {
    load_tile<DP>(Ks(0), k, p.k_ss, kt_lo * kMmaBK, p.skv, p.d, vec_load,
                  tid);
    load_tile<DP>(Vs(0), v, p.v_ss, kt_lo * kMmaBK, p.skv, p.d, vec_load,
                  tid);
  }
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
      load_tile<DP>(Vs(st ^ 1), v, p.v_ss, (kt + 1) * kMmaBK, p.skv, p.d,
                    vec_load, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and, the first time, Q) is in place

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
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes));
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

// the CUDA-core route: float32 at any D <= 256, bfloat16 at 128 < D <= 256
int flash_attention(FLASH_ARGS) {
  Params p;
  if (!(dtype == 0 || (dtype == 1 && d > 128)) ||
      !make_params(&p, q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                   v_sh, v_ss, batch, hq, hkv, sq, skv, d, dtype, causal,
                   has_window, window, has_cap, cap, has_kv_len, kv_len, q0,
                   scale, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16, 256, 32, 32>(p, batch, s);
  return dispatch_f32(p, batch, s);
}

// the tensor-core route: bfloat16, D <= 128
int flash_attention_mma(FLASH_ARGS) {
  Params p;
  if (dtype != 1 || d > 128 ||
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
