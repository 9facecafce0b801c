// Blockwise GQA attention with an online softmax on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention  <- flash_attention_pallas (_flash_kernel)
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
// the kernel picks its own tiles (BQ x BK below; the caller's bq/bk only
// matter for rows whose visited keys are all masked), Sq and Skv need not
// be multiples of the tile (rows past Sq are not written, keys past Skv are
// not keys: their p is exactly 0), q, k and v may be strided views with a
// contiguous last dimension, and D up to 256 is zero-padded to a power of
// two (DP) inside shared memory. Float32 inputs are multiplied in full
// float32 on the CUDA cores: no TF32.
//
// What bounds it on this card: at qwen2-0.5b's prefill shape (8 x 14/2
// heads, S = 512, D = 64, bf16) the causal work is ~3.8 GFLOP against
// ~17 MB of HBM traffic, 224 FLOP a byte, just under the bf16 tensor-core
// ridge (~295), so at the card's peaks the bytes bound it (~5 us). This
// first kernel does every product as a float32 FMA on the CUDA cores
// (67 TFLOP/s peak, ~56 us for that work), not on the tensor cores, so it
// sits far above that bound.
//
// The design keeps what the TPU kernel kept out of HBM out of HBM: one CTA
// per (b*Hq + h, q tile); the Q tile, one K and one V tile and the score
// tile live in shared memory (rows padded by one float against bank
// conflicts); the accumulator lives in registers, 128 threads each owning a
// (BQ/16) x (DP/8) block of it; each warp runs the softmax of a quarter of
// the rows with shuffles. Moving the two products to mma.sync/wgmma on bf16
// is a later change.

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
  const int q_start = blockIdx.y * BQ;
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

template <typename T>
int dispatch(const Params& p, int batch, cudaStream_t stream) {
  if (p.d <= 16) return launch<T, 16, 64, 64>(p, batch, stream);
  if (p.d <= 32) return launch<T, 32, 64, 64>(p, batch, stream);
  if (p.d <= 64) return launch<T, 64, 64, 64>(p, batch, stream);
  if (p.d <= 128) return launch<T, 128, 64, 32>(p, batch, stream);
  if (p.d <= 256) return launch<T, 256, 32, 32>(p, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue,
// without a launch, for an empty or unsupported shape). dtype: 0 float32,
// 1 bfloat16. has_* = 0 means the option is off (None in Python).
extern "C" {

int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                    int64_t v_ss, int batch, int hq, int hkv, int sq, int skv,
                    int d, int dtype, int causal, int has_window, int window,
                    int has_cap, float cap, int has_kv_len, int kv_len,
                    int q0, float scale, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 ||
      skv < 1 || d < 1 || d > 256 || (sq + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_ss = v_ss;
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.has_cap = has_cap;
  p.cap = cap;
  p.has_kv_len = has_kv_len;
  p.kv_len = kv_len;
  p.q0 = q0;
  p.scale = scale;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, batch, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
