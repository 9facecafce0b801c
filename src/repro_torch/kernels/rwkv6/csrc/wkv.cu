// Chunked RWKV-6 WKV scan with data-dependent decay on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rwkv6/rwkv6.py:
//   wkv  <- wkv_pallas (_wkv_kernel)
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
// 67 TFLOP/s) with the bytes (~31 us at 3.35 TB/s) close behind. What
// actually bounds this first kernel is parallelism and latency: the
// recurrence is sequential over S / C chunks, so there is one CTA per
// (b, h), 256 CTAs on 132 SMs at B = 4, each walking 32 chunks with five
// block barriers apiece.
// The design keeps the state out of HBM for the whole scan: the (dk, dv)
// float32 state (16 KB at 64 x 64) and the chunk's r, k, v, log-decay
// tiles live in shared memory (~38 KB in all), every product is a float32
// FMA on the CUDA cores, and the state goes to HBM once, at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue,
// without a launch, for an unsupported shape). dtype / wdtype: 0 float32,
// 1 bfloat16, of r/k/v/o and of logw. state_in may be null (zero state).
extern "C" {

int wkv(const void* r, const void* k, const void* v, const void* logw,
        const void* u, const void* state_in, void* o, void* state_out,
        int64_t bh, int H, int S, int dk, int dv, int C, int dtype,
        int wdtype, void* stream) {
  if (bh < 1 || bh > 2147483647 || H < 1 || S < 1 || C < 1 || C > kMaxC ||
      S % C != 0 || dk < 1 || dk > kMaxD || dv < 1 || dv > kMaxD)
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

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
