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
// What bounds it on this card: at rwkv6-7b's prefill shape (B = 4, H = 64,
// S = 512, 64 x 64 heads) the scan does ~2.5 GFLOP in float32 and moves
// ~105 MB, so the bound is the float32 CUDA-core peak (~38 us at
// 67 TFLOP/s) with the bytes (~31 us at 3.35 TB/s) close behind. The
// recurrence is sequential over S / C chunks, so what holds a kernel back
// in practice is parallelism and the latency of each chunk's steps. Both
// routes keep the state out of HBM for the whole scan (the TPU kernel:
// VMEM across a sequential grid axis) and write it once, at the end.
//
// Two routes, each its own C entry point, chosen by shape:
//
// wkv_split (dk = dv = 64, C = 16: rwkv6-7b's heads). The state's dv
// columns are independent, so a grid of (B*H, dv / 32) CTAs (512 at B = 4:
// one wave of four CTAs an SM) each owns 32 columns of one head's state,
// in registers (sixteen values a thread), and recomputes the chunk's decay
// factors and scores. That work is repeated in each CTA of a head, so the
// split is as coarse as fills the card: 16 columns (1,024 CTAs, two waves)
// measured slower. Shapes are compile-time constants, so every loop
// unrolls. Each chunk is three block barriers: (1) the chunk's r, k, logw
// and v columns are in shared memory (16-byte cp.async, issued one chunk
// ahead so the copy overlaps the previous chunk's work); the cumulative
// log-decay of a column is two neighbouring lanes' running sums joined by
// one shuffle; (2) the strictly-lower scores, with the bonus sum_j r u k
// on the diagonal, eight lanes a row joined by a reduce-scatter of
// shuffles; (3) the output (four independent accumulators a value against
// a transposed copy of the state in shared memory) and the state update
// (sixteen independent accumulators a thread). Rows of the shared arrays
// are padded or assigned to lanes so that the vector loads of a warp hit
// distinct banks; the decay factors are exponentials in base 2 (exp2f,
// 2 ulp), with k e^{L_C - Lx} taken as (k e^{-Lx}) e^{L_C}, both factors
// inside float32's range since L_C >= -68. r, k, v and logw are read
// through their strides, so the model's head-transposed views go in
// without copies.
//
// wkv (dk, dv <= 64 and C <= 16, every shape but wkv_split's): one CTA per
// (b, h) walks the chunks with the (dk, dv) state and the chunk's tiles in
// shared memory (~38 KB), every loop bound known only at run time, on
// contiguous inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 16;
constexpr int kMaxD = 64;

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

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const TW* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ state_in,
           T* __restrict__ o, float* __restrict__ state_out, int H, int S,
           int dk, int dv, int C) {
  __shared__ float St[kMaxD * kMaxD];   // state (dk, dv), row-major
  __shared__ float rs[kMaxC * kMaxD];   // r, then r e^{Lex}
  __shared__ float ks[kMaxC * kMaxD];   // k, then k e^{L_C - Lx}
  __shared__ float ws[kMaxC * kMaxD];   // logw, then Lex, then k e^{-Lx}
  __shared__ float Ls[kMaxC * kMaxD];   // Lx
  __shared__ float vs[kMaxC * kMaxD];   // v
  __shared__ float att[kMaxC * kMaxC];  // strictly lower (C, C)
  __shared__ float bonus[kMaxC];        // sum_j r u k per row
  __shared__ float us[kMaxD];

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int h = static_cast<int>(bh % H);
  const int64_t base_k = bh * S * dk;  // (b, h) offset of r, k, logw
  const int64_t base_v = bh * S * dv;  // (b, h) offset of v, o

  for (int i = tid; i < dk * dv; i += kThreads)
    St[i] = state_in ? state_in[bh * dk * dv + i] : 0.f;
  for (int j = tid; j < dk; j += kThreads) us[j] = u[h * dk + j];

  const int nchunks = S / C;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int64_t ok = base_k + static_cast<int64_t>(ci) * C * dk;
    const int64_t ov = base_v + static_cast<int64_t>(ci) * C * dv;
    for (int i = tid; i < C * dk; i += kThreads) {
      rs[i] = to_f32(r[ok + i]);
      ks[i] = to_f32(k[ok + i]);
      ws[i] = to_f32(logw[ok + i]);
    }
    for (int i = tid; i < C * dv; i += kThreads) vs[i] = to_f32(v[ov + i]);
    __syncthreads();

    // inclusive cumulative log-decay down each column; the bonus per row
    if (tid < dk) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = ws[t * dk + tid];
        run += lw;
        Ls[t * dk + tid] = run;
        ws[t * dk + tid] = run - lw;  // Lex
      }
    }
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int t = warp; t < C; t += kThreads / 32) {
        float s = 0.f;
        for (int j = lane; j < dk; j += 32)
          s += rs[t * dk + j] * us[j] * ks[t * dk + j];
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) bonus[t] = s;
      }
    }
    __syncthreads();

    // r e^{Lex}, k e^{-Lx} and k e^{L_C - Lx}, in place
    for (int i = tid; i < C * dk; i += kThreads) {
      const int j = i % dk;
      const float lx = Ls[i];
      const float kk = ks[i];
      rs[i] = rs[i] * expf(ws[i]);
      ws[i] = kk * expf(-lx);
      ks[i] = kk * expf(Ls[(C - 1) * dk + j] - lx);
    }
    __syncthreads();

    // intra-chunk scores, strictly lower triangular
    for (int i = tid; i < C * C; i += kThreads) {
      const int t = i / C, s = i % C;
      float a = 0.f;
      if (s < t)
        for (int j = 0; j < dk; ++j)
          a = fmaf(rs[t * dk + j], ws[s * dk + j], a);
      att[i] = a;
    }
    __syncthreads();

    // o = r_dec S + att v + bonus v
    for (int i = tid; i < C * dv; i += kThreads) {
      const int t = i / dv, c = i % dv;
      float inter = 0.f;
      for (int j = 0; j < dk; ++j)
        inter = fmaf(rs[t * dk + j], St[j * dv + c], inter);
      float intra = 0.f;
      for (int s = 0; s < C; ++s)
        intra = fmaf(att[t * C + s], vs[s * dv + c], intra);
      o[ov + i] = from_f32<T>(inter + intra + bonus[t] * vs[i]);
    }
    __syncthreads();

    // S = S e^{L_C} + (k e^{L_C - Lx})^T v
    for (int i = tid; i < dk * dv; i += kThreads) {
      const int j = i / dv, c = i % dv;
      float add = 0.f;
      for (int s = 0; s < C; ++s)
        add = fmaf(ks[s * dk + j], vs[s * dv + c], add);
      St[i] = St[i] * expf(Ls[(C - 1) * dk + j]) + add;
    }
    __syncthreads();
  }
  for (int i = tid; i < dk * dv; i += kThreads)
    state_out[bh * dk * dv + i] = St[i];
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* state_in, void* o, void* state_out,
           int64_t bh, int H, int S, int dk, int dv, int C,
           cudaStream_t stream) {
  wkv_kernel<T, TW><<<static_cast<unsigned>(bh), kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(state_in),
      static_cast<T*>(o), static_cast<float*>(state_out), H, S, dk, dv, C);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------ the split route: dk = dv = 64, chunk 16
constexpr int kSplitThreads = 128;
constexpr int kDK = 64;   // key width (dk)
constexpr int kDV = 64;   // value width (dv)
constexpr int kC = 16;    // chunk
constexpr int kDVB = 32;  // state columns a CTA owns: dv / kDVB CTAs a head
constexpr int kSplitMinBlocks = 4;  // CTAs an SM holds: <= 128 registers
constexpr int kSP = kDK + 4;  // padded row stride (r_dec, the state copy)
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSplitThreads == 2 * kDK && kSplitThreads == 8 * kC &&
                  kDVB % 8 == 0 && (kDVB / 2) % 4 == 0,
              "the thread roles below assume these shapes");

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
};

// one chunk's inputs as they lie in HBM (the CTA's 16 columns of v)
template <typename T, typename TW>
struct SplitStage {
  alignas(16) T r[kC * kDK];
  alignas(16) T k[kC * kDK];
  alignas(16) TW w[kC * kDK];
  alignas(16) T v[kC * kDVB];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kC rows of W elements, row stride ss, into a dense shared array: 16-byte
// cp.async when vec (to be waited for), else plain loads and stores
template <int W, typename E>
__device__ __forceinline__ void load_rows(E* dst, const E* src, int64_t ss,
                                          bool vec, int tid) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(E);  // elements a 16-byte chunk
    constexpr int CPR = W / EPC;         // chunks a row
#pragma unroll
    for (int i = tid; i < kC * CPR; i += kSplitThreads) {
      const int r = i / CPR, c = (i % CPR) * EPC;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst + r * W + c)),
                   "l"(src + r * ss + c));
    }
  } else {
    for (int i = tid; i < kC * W; i += kSplitThreads)
      dst[i] = src[(i / W) * ss + i % W];
  }
}

// the i-th (i < 8) of the dk columns that score lane ag sums
__device__ __forceinline__ int score_col(int ag, int i) {
  return (i < 4 ? 4 * ag : 32 + 4 * ag - 4) + i;
}
// row[score_col(ag, 0..7)] as float32: two aligned runs of four
__device__ __forceinline__ void load4x2(const float* row, int ag,
                                        float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * ag);
  const float4 b = *reinterpret_cast<const float4*>(row + 32 + 4 * ag);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load4x2(const __nv_bfloat16* row, int ag,
                                        float (&x)[8]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint2 a = *reinterpret_cast<const uint2*>(row + 32 * half + 4 * ag);
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[4 * half + 2 * i] = f.x;
      x[4 * half + 2 * i + 1] = f.y;
    }
  }
}

// One step of a reduce-scatter across the lanes that differ in `BIT`: the
// lane keeps the half of its W live values that its bit selects, adds its
// partner's copy of that half, and leaves the sums in part[0..W/2).
template <int W, int BIT>
__device__ __forceinline__ void reduce_scatter_step(float (&part)[kC],
                                                    int lane_id) {
  const bool up = (lane_id & BIT) != 0;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float send = up ? part[i] : part[i + W / 2];
    const float keep = up ? part[i + W / 2] : part[i];
    part[i] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
}

// shared memory of one CTA of the split route
template <typename T, typename TW>
struct SplitSmem {
  SplitStage<T, TW> stage[2];       // chunk ci and the prefetched ci + 1
  alignas(16) float rdec[kC][kSP];  // r e^{Lex}, rows padded
  alignas(16) float kinc[kC][kDK];  // k e^{-Lx}
  alignas(16) float att[kC][kC];    // strictly lower, the bonus diagonal
  alignas(16) float vf[kC][kDVB];   // v, float32
  alignas(16) float vT[kDVB][kC + 4];  // v transposed, rows padded
  // the state at the chunk's start, transposed (S[j][c] at Sm[c][j]) for
  // the output's reads; rows padded so that eight lanes' float4 reads of
  // eight rows fall in distinct banks
  alignas(16) float Sm[kDVB][kSP];
};

template <typename T, typename TW>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
wkv_split_kernel(SplitParams p, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<SplitSmem<T, TW>*>(smem_raw);
  constexpr int kCPT = kDVB / 2;  // state columns a thread updates
  constexpr int kOPT = kDVB / 8;  // output columns a thread computes
  constexpr int kVPT = kDVB / 8;  // v columns a thread converts

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int b = static_cast<int>(bh / p.H), h = static_cast<int>(bh % p.H);
  const int col0 = blockIdx.y * kDVB;  // this CTA's state columns
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + col0;
  const TW* w = static_cast<const TW*>(p.logw) + b * p.w_sb + h * p.w_sh;
  T* o = static_cast<T*>(p.o) + bh * static_cast<int64_t>(p.S) * kDV + col0;

  // roles: decay and state update: dk row j, half `hf` of the chunk's rows
  // and of the CTA's columns (the two halves are neighbouring lanes);
  // scores and output: chunk row `ar`; dk columns 4 ag..4 ag + 3 and
  // 32 + 4 ag..32 + 4 ag + 3 of the scores (eight lanes read 128
  // contiguous bytes); value columns ag + 8 m of the output
  const int j = tid / 2, hf = tid % 2;
  const int ar = tid / 8, ag = tid % 8;
  const int last_row = (tid / 32) * 4 + 3;  // the warp's last chunk row

  float st[kCPT];  // S[j][col0 + kCPT hf + c]: the state, in registers
#pragma unroll
  for (int c = 0; c < kCPT; ++c)
    st[c] = p.state_in
                ? p.state_in[(bh * kDK + j) * kDV + col0 + kCPT * hf + c]
                : 0.f;
  float uu[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) uu[i] = p.u[h * kDK + score_col(ag, i)];

  const bool vec_load = vec != 0;
  auto load_chunk = [&](SplitStage<T, TW>& sg, int ci) {
    const int64_t t0 = static_cast<int64_t>(ci) * kC;
    load_rows<kDK>(sg.r, r + t0 * p.r_ss, p.r_ss, vec_load, tid);
    load_rows<kDK>(sg.k, k + t0 * p.k_ss, p.k_ss, vec_load, tid);
    load_rows<kDK>(sg.w, w + t0 * p.w_ss, p.w_ss, vec_load, tid);
    load_rows<kDVB>(sg.v, v + t0 * p.v_ss, p.v_ss, vec_load, tid);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int nch = p.S / kC;
  load_chunk(sm.stage[0], 0);
  for (int ci = 0; ci < nch; ++ci) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // chunk ci is in place; chunk ci - 1 is consumed
    if (ci + 1 < nch) load_chunk(sm.stage[(ci + 1) & 1], ci + 1);
    const SplitStage<T, TW>& sg = sm.stage[ci & 1];

    // the state at the chunk's start, for the output
#pragma unroll
    for (int c = 0; c < kCPT; ++c) sm.Sm[kCPT * hf + c][j] = st[c];

    // decay factors of column j, rows 8 hf..8 hf + 7, in base 2 (one
    // ex2 each): the cumulative log-decay is a running sum here plus the
    // other half's total
    float lw[8], lx[8], run = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lw[i] = to_f32(sg.w[(8 * hf + i) * kDK + j]) * kLog2e;
      run += lw[i];
      lx[i] = run;
    }
    const float other = __shfl_xor_sync(0xffffffffu, run, 1);
    const float off = hf ? other : 0.f;
    const float lc = hf ? other + run : run + other;  // L_C, both lanes
    const float elc = exp2f(lc);  // e^{L_C} >= e^{-68}: a normal float
    float kfin[8];  // k e^{L_C - Lx} of rows 8 hf + i
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * hf + i;
      const float x = lx[i] + off;  // Lx (inclusive)
      const float rr = to_f32(sg.r[t * kDK + j]);
      const float kinc = to_f32(sg.k[t * kDK + j]) * exp2f(-x);
      sm.rdec[t][j] = rr * exp2f(x - lw[i]);  // Lex = Lx - logw
      sm.kinc[t][j] = kinc;
      kfin[i] = kinc * elc;  // e^{-Lx} <= e^{68} and e^{L_C}: in range
    }
#pragma unroll
    for (int e = 0; e < kVPT; ++e) {
      const int c = kVPT * ag + e;
      const float x = to_f32(sg.v[ar * kDVB + c]);
      sm.vf[ar][c] = x;
      sm.vT[c][ar] = x;
    }
    __syncthreads();

    // scores of row ar: att[ar][s] = r_dec[ar] . k_inc[s] for s < ar, the
    // bonus sum_j r u k on the diagonal, 0 above; each lane sums 8 of the
    // 64 columns, eight lanes add up
    {
      float rd[8], rr[8], kk[8], diag = 0.f;
      load4x2(&sm.rdec[ar][0], ag, rd);
      load4x2(sg.r + ar * kDK, ag, rr);
      load4x2(sg.k + ar * kDK, ag, kk);
#pragma unroll
      for (int i = 0; i < 8; ++i) diag = fmaf(rr[i] * uu[i], kk[i], diag);
      float part[kC];
#pragma unroll
      for (int s = 0; s < kC; ++s) {
        if (s > last_row) {  // above the diagonal of every row of the warp
          part[s] = 0.f;
          continue;
        }
        const float4 k0 =
            *reinterpret_cast<const float4*>(&sm.kinc[s][4 * ag]);
        const float4 k1 =
            *reinterpret_cast<const float4*>(&sm.kinc[s][32 + 4 * ag]);
        float a0 = rd[0] * k0.x, a1 = rd[1] * k0.y;
        a0 = fmaf(rd[2], k0.z, a0);
        a1 = fmaf(rd[3], k0.w, a1);
        a0 = fmaf(rd[4], k1.x, a0);
        a1 = fmaf(rd[5], k1.y, a1);
        a0 = fmaf(rd[6], k1.z, a0);
        a1 = fmaf(rd[7], k1.w, a1);
        part[s] = s < ar ? a0 + a1 : (s == ar ? diag : 0.f);
      }
      // reduce-scatter over the eight lanes: each step halves the values
      // a lane keeps, so lane ag ends with the sums of columns 2 ag, 2 ag + 1
      reduce_scatter_step<16, 4>(part, ag);
      reduce_scatter_step<8, 2>(part, ag);
      reduce_scatter_step<4, 1>(part, ag);
      *reinterpret_cast<float2*>(&sm.att[ar][2 * ag]) =
          make_float2(part[0], part[1]);
    }
    __syncthreads();

    // o[ar][c] = r_dec[ar] . S[:, c] + sum_s att[ar][s] v[s][c] for the
    // columns c = ag + 8 m, four independent accumulators each
    {
      float acc[kOPT][4];
#pragma unroll
      for (int m = 0; m < kOPT; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
#pragma unroll
      for (int jj = 0; jj < kDK; jj += 4) {
        const float4 rd = *reinterpret_cast<const float4*>(&sm.rdec[ar][jj]);
#pragma unroll
        for (int m = 0; m < kOPT; ++m) {
          const float4 x =
              *reinterpret_cast<const float4*>(&sm.Sm[ag + 8 * m][jj]);
          acc[m][0] = fmaf(rd.x, x.x, acc[m][0]);
          acc[m][1] = fmaf(rd.y, x.y, acc[m][1]);
          acc[m][2] = fmaf(rd.z, x.z, acc[m][2]);
          acc[m][3] = fmaf(rd.w, x.w, acc[m][3]);
        }
      }
      float out[kOPT];
#pragma unroll
      for (int m = 0; m < kOPT; ++m)
        out[m] = (acc[m][0] + acc[m][1]) + (acc[m][2] + acc[m][3]);
#pragma unroll
      for (int s = 0; s < kC; s += 4) {
        if (s > last_row) break;  // att is 0 above the warp's last row
        const float4 a = *reinterpret_cast<const float4*>(&sm.att[ar][s]);
#pragma unroll
        for (int m = 0; m < kOPT; ++m) {
          const float4 x =
              *reinterpret_cast<const float4*>(&sm.vT[ag + 8 * m][s]);
          out[m] = fmaf(a.x, x.x, out[m]);
          out[m] = fmaf(a.y, x.y, out[m]);
          out[m] = fmaf(a.z, x.z, out[m]);
          out[m] = fmaf(a.w, x.w, out[m]);
        }
      }
      T* orow = o + (static_cast<int64_t>(ci) * kC + ar) * kDV;
#pragma unroll
      for (int m = 0; m < kOPT; ++m) orow[ag + 8 * m] = from_f32<T>(out[m]);
    }

    // S[j][c] = S e^{L_C} + sum_s k e^{L_C - Lx}[s][j] v[s][c] for this
    // thread's columns c = kCPT hf + c', in registers
    {
      float kf[kC];  // all 16 rows: this lane's 8 and its neighbour's
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float nb = __shfl_xor_sync(0xffffffffu, kfin[i], 1);
        kf[i] = hf ? nb : kfin[i];
        kf[8 + i] = hf ? kfin[i] : nb;
      }
      float add[kCPT];
#pragma unroll
      for (int c = 0; c < kCPT; ++c) add[c] = 0.f;
#pragma unroll
      for (int s = 0; s < kC; ++s) {
#pragma unroll
        for (int c = 0; c < kCPT; c += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(&sm.vf[s][kCPT * hf + c]);
          add[c] = fmaf(kf[s], x.x, add[c]);
          add[c + 1] = fmaf(kf[s], x.y, add[c + 1]);
          add[c + 2] = fmaf(kf[s], x.z, add[c + 2]);
          add[c + 3] = fmaf(kf[s], x.w, add[c + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < kCPT; ++c) st[c] = st[c] * elc + add[c];
    }
  }
  float* so = p.state_out + (bh * kDK + j) * kDV + col0 + kCPT * hf;
#pragma unroll
  for (int c = 0; c < kCPT; ++c) so[c] = st[c];
}

template <typename T, typename TW>
int launch_split(const SplitParams& p, int64_t bh, int vec,
                 cudaStream_t stream) {
  auto kernel = wkv_split_kernel<T, TW>;
  constexpr int bytes = sizeof(SplitSmem<T, TW>);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(bh), kDV / kDVB);
  kernel<<<grid, kSplitThreads, bytes, stream>>>(p, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue,
// without a launch, for an unsupported shape). dtype / wdtype: 0 float32,
// 1 bfloat16, of r/k/v/o and of logw. state_in may be null (zero state).
extern "C" {

// The one-CTA-a-head route: every shape but the split route's own.
int wkv(const void* r, const void* k, const void* v, const void* logw,
        const void* u, const void* state_in, void* o, void* state_out,
        int64_t bh, int H, int S, int dk, int dv, int C, int dtype,
        int wdtype, void* stream) {
  if (bh < 1 || bh > 2147483647 || H < 1 || S < 1 || C < 1 || C > kMaxC ||
      S % C != 0 || dk < 1 || dk > kMaxD || dv < 1 || dv > kMaxD ||
      (dk == kDK && dv == kDV && C == kC))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0)
    return launch<float, float>(r, k, v, logw, u, state_in, o, state_out, bh,
                                H, S, dk, dv, C, s);
  if (dtype == 1 && wdtype == 0)
    return launch<__nv_bfloat16, float>(r, k, v, logw, u, state_in, o,
                                         state_out, bh, H, S, dk, dv, C, s);
  if (dtype == 1 && wdtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, logw, u, state_in, o,
                                                 state_out, bh, H, S, dk, dv,
                                                 C, s);
  if (dtype == 0 && wdtype == 1)
    return launch<float, __nv_bfloat16>(r, k, v, logw, u, state_in, o,
                                        state_out, bh, H, S, dk, dv, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split route: dk = dv = 64, C = 16, any S that is a multiple of 16.
// r, k, v and logw are read through their element strides of b, h and s
// (the last dimension contiguous); o and the states are contiguous.
int wkv_split(const void* r, const void* k, const void* v, const void* logw,
              const void* u, const void* state_in, void* o, void* state_out,
              int64_t r_sb, int64_t r_sh, int64_t r_ss, int64_t k_sb,
              int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
              int64_t v_ss, int64_t w_sb, int64_t w_sh, int64_t w_ss, int B,
              int H, int S, int dk, int dv, int C, int dtype, int wdtype,
              void* stream) {
  const int64_t bh = static_cast<int64_t>(B) * H;
  if (B < 1 || H < 1 || bh > 2147483647 || S < kC || S % kC != 0 ||
      dk != kDK || dv != kDV || C != kC)
    return static_cast<int>(cudaErrorInvalidValue);
  SplitParams p{r,    k,    v,    logw, static_cast<const float*>(u),
                static_cast<const float*>(state_in),       o,
                static_cast<float*>(state_out),            r_sb,
                r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                w_sb, w_sh, w_ss, H,    S};
  // 16-byte rows and bases: the asynchronous copy; else plain loads
  const int es = dtype == 0 ? 4 : 2, ws = wdtype == 0 ? 4 : 2;
  bool vec = true;
  for (int64_t st : {r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss})
    vec = vec && (st * es) % 16 == 0;
  for (int64_t st : {w_sb, w_sh, w_ss}) vec = vec && (st * ws) % 16 == 0;
  for (const void* ptr : {r, k, v, logw})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  const int vi = vec ? 1 : 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0)
    return launch_split<float, float>(p, bh, vi, s);
  if (dtype == 1 && wdtype == 0)
    return launch_split<__nv_bfloat16, float>(p, bh, vi, s);
  if (dtype == 1 && wdtype == 1)
    return launch_split<__nv_bfloat16, __nv_bfloat16>(p, bh, vi, s);
  if (dtype == 0 && wdtype == 1)
    return launch_split<float, __nv_bfloat16>(p, bh, vi, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
