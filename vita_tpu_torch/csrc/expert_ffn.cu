// Selected-expert SwiGLU FFN for MoE decode.
//
// Replaces both TPU schedules of the same function:
//   vita_tpu/ops/moe_decode.py::_gather_ffn_kernel (gather_expert_ffn: one
//     grid row per (token, k) pair), and
//   vita_tpu/ops/moe_decode.py::_masked_ffn_kernel (masked_expert_ffn: one
//     grid row per unique active expert, all tokens of the batch).
//
// What bounds it on the H100: bytes. At decode the expert weights are read
// for a handful of tokens (1 to 16), about 2 * T FLOP per weight byte, so
// the time is the selected experts' weights streamed from HBM
// (3 * 4096 * 14336 * 2 bytes = 352 MB per expert in bf16).
//
// Design: a "row" is one expert id (flat layer * E + e into the stacked
// [L * E, ...] weights) with up to NT token slots (token index, or -1 for
// an empty slot). The gather schedule passes one row per (token, k) pair
// with NT = 1; the masked schedule passes one row per unique active expert
// with all T tokens, so each active expert's weights are read once for the
// whole batch. Two kernels, so no block needs another's partial sums:
//   up:   one block per (row, 64 columns of F): h = silu(x Wg) * (x Wu) for
//         the row's tokens, float32 accumulation, rounded to the weight dtype
//         (as the TPU kernel rounds h before the down projection);
//   down: one block per (row, 64 columns of D): y = h Wd, looping over F,
//         float32 accumulation, rounded to the activation dtype.
// In both, each of the 8 warps takes every 8th row of the weight matrix and
// each lane reads two adjacent columns (one 128-byte line per warp and row);
// the warps' partial sums meet in shared memory. The routing-weight combine
// stays in PyTorch, as the einsum does on the TPU. Tensor cores and deeper
// load pipelining are later work.
#include "common.cuh"

namespace vita {
namespace {

constexpr int kCols = 64;     // output columns per block (32 lanes x 2)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;   // reduction rows staged in shared memory per pass

// shared scratch: the staged activations [NT][kChunk] during the main loop,
// then the warps' partial sums [kWarps][NT][kCols] for the reduction
template <int NT>
struct Scratch {
  static constexpr int kFloats =
      NT * kChunk > kWarps * NT * kCols ? NT * kChunk : kWarps * NT * kCols;
};

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
expert_up_kernel(const T* __restrict__ x, const int* __restrict__ eids,
                 const int* __restrict__ toks, const T* __restrict__ w_gate,
                 const T* __restrict__ w_up, T* __restrict__ h, int D, int F) {
  __shared__ float buf[Scratch<NT>::kFloats];
  const int row = blockIdx.y;
  const int f0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int fcol = f0 + 2 * lane;
  const bool col_ok = fcol < F;  // F is even, so fcol + 1 < F as well
  const int64_t e = eids[row];
  const int* tok = toks + (int64_t)row * NT;
  const T* wg = w_gate + e * D * F + fcol;
  const T* wu = w_up + e * D * F + fcol;

  float ga[NT][2], ua[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) ga[t][0] = ga[t][1] = ua[t][0] = ua[t][1] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int n = min(kChunk, D - d0);
    for (int i = tid; i < NT * kChunk; i += kThreads) {
      const int t = i / kChunk, j = i % kChunk;
      const int ti = tok[t];
      buf[i] = (j < n && ti >= 0) ? to_f32(x[(int64_t)ti * D + d0 + j]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll 4
      for (int j = warp; j < n; j += kWarps) {
        const float2 g = load2(wg + (int64_t)(d0 + j) * F);
        const float2 u = load2(wu + (int64_t)(d0 + j) * F);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float xv = buf[t * kChunk + j];
          ga[t][0] += xv * g.x;
          ga[t][1] += xv * g.y;
          ua[t][0] += xv * u.x;
          ua[t][1] += xv * u.y;
        }
      }
    }
    __syncthreads();
  }

  // reduce the gate sums across warps, keep them, then the up sums
  constexpr int kOut = NT * kCols;
  constexpr int kPer = (kOut + kThreads - 1) / kThreads;
  float gate[kPer];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    buf[(warp * NT + t) * kCols + 2 * lane] = ga[t][0];
    buf[(warp * NT + t) * kCols + 2 * lane + 1] = ga[t][1];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = tid + p * kThreads;
    float s = 0.f;
    if (idx < kOut)
      for (int w = 0; w < kWarps; ++w) s += buf[w * kOut + idx];
    gate[p] = s;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    buf[(warp * NT + t) * kCols + 2 * lane] = ua[t][0];
    buf[(warp * NT + t) * kCols + 2 * lane + 1] = ua[t][1];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = tid + p * kThreads;
    if (idx >= kOut) continue;
    float up = 0.f;
    for (int w = 0; w < kWarps; ++w) up += buf[w * kOut + idx];
    const int t = idx / kCols, c = idx % kCols;
    if (f0 + c < F)
      h[((int64_t)row * NT + t) * F + f0 + c] = from_f32<T>(silu(gate[p]) * up);
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
expert_down_kernel(const T* __restrict__ h, const int* __restrict__ eids,
                   const T* __restrict__ w_down, T* __restrict__ y, int D,
                   int F) {
  __shared__ float buf[Scratch<NT>::kFloats];
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int dcol = c0 + 2 * lane;
  const bool col_ok = dcol < D;  // D is even
  const int64_t e = eids[row];
  const T* wd = w_down + e * F * D + dcol;
  const T* hr = h + (int64_t)row * NT * F;

  float acc[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int n = min(kChunk, F - f0);
    for (int i = tid; i < NT * kChunk; i += kThreads) {
      const int t = i / kChunk, j = i % kChunk;
      buf[i] = j < n ? to_f32(hr[(int64_t)t * F + f0 + j]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll 4
      for (int j = warp; j < n; j += kWarps) {
        const float2 w = load2(wd + (int64_t)(f0 + j) * D);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float hv = buf[t * kChunk + j];
          acc[t][0] += hv * w.x;
          acc[t][1] += hv * w.y;
        }
      }
    }
    __syncthreads();
  }

  constexpr int kOut = NT * kCols;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    buf[(warp * NT + t) * kCols + 2 * lane] = acc[t][0];
    buf[(warp * NT + t) * kCols + 2 * lane + 1] = acc[t][1];
  }
  __syncthreads();
  for (int idx = tid; idx < kOut; idx += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += buf[w * kOut + idx];
    const int t = idx / kCols, c = idx % kCols;
    if (c0 + c < D) y[((int64_t)row * NT + t) * D + c0 + c] = from_f32<T>(s);
  }
}

template <typename T, int NT>
int launch_nt(const void* x, const int* eids, const int* toks, const void* wg,
              const void* wu, const void* wd, void* h, void* y, int R, int D,
              int F, cudaStream_t stream) {
  dim3 up_grid((F + kCols - 1) / kCols, R);
  expert_up_kernel<T, NT><<<up_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), eids, toks, static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<T*>(h), D, F);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 down_grid((D + kCols - 1) / kCols, R);
  expert_down_kernel<T, NT><<<down_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), eids, static_cast<const T*>(wd),
      static_cast<T*>(y), D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int nt, const void* x, const int* eids, const int* toks,
           const void* wg, const void* wu, const void* wd, void* h, void* y,
           int R, int D, int F, cudaStream_t stream) {
  switch (nt) {
    case 1: return launch_nt<T, 1>(x, eids, toks, wg, wu, wd, h, y, R, D, F, stream);
    case 2: return launch_nt<T, 2>(x, eids, toks, wg, wu, wd, h, y, R, D, F, stream);
    case 4: return launch_nt<T, 4>(x, eids, toks, wg, wu, wd, h, y, R, D, F, stream);
    case 8: return launch_nt<T, 8>(x, eids, toks, wg, wu, wd, h, y, R, D, F, stream);
    case 16: return launch_nt<T, 16>(x, eids, toks, wg, wu, wd, h, y, R, D, F, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vita

// x [T, D]; eids [R] int32 flat expert ids; toks [R, nt] int32 token index
// per slot (-1 = empty); w_gate/w_up [E_rows, D, F]; w_down [E_rows, F, D];
// scratch h [R, nt, F] and output y [R, nt, D]. nt is 1, 2, 4, 8 or 16; D
// and F are even. x and the weights share one dtype. Returns the CUDA error
// code of the launches.
extern "C" int vita_expert_ffn(const void* x, const int* eids, const int* toks,
                               const void* w_gate, const void* w_up,
                               const void* w_down, void* h, void* y, int R,
                               int nt, int D, int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vita::kBFloat16)
    return vita::launch<__nv_bfloat16>(nt, x, eids, toks, w_gate, w_up,
                                       w_down, h, y, R, D, F, s);
  return vita::launch<float>(nt, x, eids, toks, w_gate, w_up, w_down, h, y, R,
                             D, F, s);
}
