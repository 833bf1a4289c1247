// Selected-expert SwiGLU FFN for MoE decode, over float32, int8 or int4
// expert weights.
//
// Replaces every TPU schedule of the same function (bf16 activations over
// bf16 experts run csrc/expert_ffn_bf16.cu instead, and over int8 or
// per-channel int4 experts csrc/expert_ffn_q.cu):
//   vita_tpu/ops/moe_decode.py::_gather_ffn_kernel (gather_expert_ffn: one
//     grid row per (token, k) pair), ::_masked_ffn_kernel (masked_expert_ffn:
//     one grid row per unique active expert, all tokens of the batch), and
//     their weight-only quantized twins ::_gather_ffn_kernel_q,
//     ::_masked_ffn_kernel_q (int8) and ::_gather_ffn_kernel_q4,
//     ::_masked_ffn_kernel_q4 (int4).
//
// What bounds it on the H100: bytes. At decode the expert weights are read
// for a handful of tokens (1 to 16), about 2 * T FLOP per weight element,
// so the time is the selected experts' weights streamed from HBM
// (3 * 4096 * 14336 elements per expert: 352 MB in bf16, 176 MB in int8,
// 88 MB in int4).
//
// Design: a "row" is one expert id (flat layer * E + e into the stacked
// [L * E, ...] weights) with up to NT token slots (token index, or -1 for
// an empty slot). The gather schedule passes one row per (token, k) pair
// with NT = 1; the masked schedule passes one row per unique active expert
// with all T tokens, so each active expert's weights are read once for the
// whole batch. Two kernels, so no block needs another's partial sums:
//   up:   one block per (row, 32 * V columns of F): h = silu(x Wg) * (x Wu)
//         for the row's tokens, float32 accumulation;
//   down: one block per (row, 64 output columns of D): y = h Wd, looping
//         over F, float32 accumulation, rounded to the activation dtype.
// In both, each of the W warps takes every W-th row of the weight matrix
// and each lane reads V adjacent columns of it; the warps' partial sums
// meet in shared memory. The routing-weight combine stays in PyTorch, as the einsum
// does on the TPU. Tensor cores and deeper load pipelining are later work.
//
// Weight formats (the Fmt template parameter):
//   kPlain: float32 weights for float32 x, h in float32.
//   kInt8:  int8 values with one f32 scale per output column ([rows, 1, F]
//           for gate/up, [rows, 1, D] for down). The dot runs over the exact
//           integers and the scale multiplies the sum once; h is rounded to
//           bf16, as the TPU kernels round it, whatever x's dtype.
//   kInt4:  two values per byte, packed by halves: gate/up [rows, D/2, F]
//           hold row r in the low nibble and row r + D/2 in the high one, so
//           each byte feeds two reduction rows, x[r] and x[r + D/2]; down
//           [rows, F, D/2] is packed along its output axis, so the byte at
//           column c holds outputs c and c + D/2, and a down block takes 32
//           packed columns and writes both halves. Low nibbles sign-extend as
//           ((u ^ 8) - 8), high nibbles by an arithmetic shift. Scales are
//           per output column and fold after the dot (one group), or, with
//           n_s > 1 groups along the reduction axis, multiply each unpacked
//           value before the dot, the product rounded to bf16 as the TPU's
//           _apply_group_scale rounds it. h is rounded to bf16.
// Quantized weights load V = 4 bytes per lane in the up kernel (2 with 16
// token slots, to keep the accumulators and shared memory in bounds).
#include <type_traits>

#include "common.cuh"

namespace vita {
namespace {

// weight formats, shared with the Python wrappers (vita_tpu_torch/kernels.py)
enum WFmt : int { kPlain = 0, kInt8 = 1, kInt4 = 2 };

constexpr int kChunk = 256;   // reduction rows staged in shared memory per pass
constexpr int kDownCols = 64; // output columns per down block

template <typename T, int Fmt> struct Types {
  using W = int8_t;          // quantized weights
  using H = __nv_bfloat16;   // h rounded to bf16, as the TPU kernels do
};
template <typename T> struct Types<T, kPlain> {
  using W = T;
  using H = T;
};

// columns per lane in the up kernel
template <int Fmt, int NT>
__host__ __device__ constexpr int up_vec() { return Fmt != kPlain && NT <= 8 ? 4 : 2; }
// stored columns per lane in the down kernel: an int4 lane reads one byte
// (two outputs), the others two elements
template <int Fmt>
__host__ __device__ constexpr int down_vec() { return Fmt == kInt4 ? 1 : 2; }
// warps per block of the up and down kernels: with 1-2 token slots a
// gather launch has few blocks (2 rows x F/128 up, 2 x D/64 down), so more
// warps per block shorten each thread's walk down the weight rows
// (measured on an H100: T=1 gather 0.73 -> 0.43 ms in bf16, 0.87 -> 0.39
// in int8; more warps did not help the masked schedule's 4-16 slots)
template <int Fmt, int NT>
__host__ __device__ constexpr int up_warps() { return NT <= 2 ? 16 : 8; }
template <int Fmt, int NT>
__host__ __device__ constexpr int down_warps() { return NT <= 2 ? 32 : 8; }

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }
__device__ __forceinline__ int lo_nibble(int b) { return ((b & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int hi_nibble(int b) { return b >> 4; }

// V consecutive signed bytes
template <int V> __device__ __forceinline__ void load_bytes(const int8_t* p, int (&b)[V]);
template <> __device__ __forceinline__ void load_bytes<1>(const int8_t* p, int (&b)[1]) {
  b[0] = p[0];
}
template <> __device__ __forceinline__ void load_bytes<2>(const int8_t* p, int (&b)[2]) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  b[0] = v.x;
  b[1] = v.y;
}
template <> __device__ __forceinline__ void load_bytes<4>(const int8_t* p, int (&b)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  b[0] = v.x;
  b[1] = v.y;
  b[2] = v.z;
  b[3] = v.w;
}

// One weight row's V columns as floats: lo[] (and hi[], the second packed
// row or column half, for int4). s_lo/s_hi point at the group scales of
// the two halves when the int4 weights are grouped, else are null.
template <typename W, int Fmt, int V>
__device__ __forceinline__ void decode(const W* p, const float* s_lo,
                                       const float* s_hi, float (&lo)[V],
                                       float (&hi)[V]) {
  if constexpr (Fmt == kPlain) {
    static_assert(V == 2, "plain weights load element pairs");
    const float2 w = load2(p);
    lo[0] = w.x;
    lo[1] = w.y;
  } else {
    int b[V];
    load_bytes<V>(p, b);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      if constexpr (Fmt == kInt8) {
        lo[c] = static_cast<float>(b[c]);
      } else {
        lo[c] = static_cast<float>(lo_nibble(b[c]));
        hi[c] = static_cast<float>(hi_nibble(b[c]));
        if (s_lo != nullptr) {
          lo[c] = bf16_round(lo[c] * bf16_round(s_lo[c]));
          hi[c] = bf16_round(hi[c] * bf16_round(s_hi[c]));
        }
      }
    }
  }
}

template <typename T, int Fmt, int NT>
__global__ void __launch_bounds__(32 * up_warps<Fmt, NT>())
expert_up_kernel(const T* __restrict__ x, const int* __restrict__ eids,
                 const int* __restrict__ toks,
                 const typename Types<T, Fmt>::W* __restrict__ w_gate,
                 const typename Types<T, Fmt>::W* __restrict__ w_up,
                 const float* __restrict__ s_gate,
                 const float* __restrict__ s_up, int n_s,
                 typename Types<T, Fmt>::H* __restrict__ h, int D, int F) {
  using W = typename Types<T, Fmt>::W;
  using H = typename Types<T, Fmt>::H;
  constexpr int V = up_vec<Fmt, NT>();
  constexpr int kCols = 32 * V;
  constexpr int kXs = Fmt == kInt4 ? 2 : 1;  // x values per weight row
  constexpr int kWarps = up_warps<Fmt, NT>();
  constexpr int kThreads = 32 * kWarps;
  __shared__ float buf[cmax(NT * kXs * kChunk, kWarps * NT * kCols)];
  const int row = blockIdx.y;
  const int f0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int fcol = f0 + V * lane;
  const bool col_ok = fcol < F;  // F % V == 0, so the lane's V columns fit
  const int n_rows = Fmt == kInt4 ? D / 2 : D;  // packed row pairs for int4
  const int64_t e = eids[row];
  const int* tok = toks + (int64_t)row * NT;
  const W* wg = w_gate + e * n_rows * F + fcol;
  const W* wu = w_up + e * n_rows * F + fcol;
  const bool grouped = Fmt == kInt4 && n_s > 1;
  const int group = grouped ? D / n_s : D;
  const float* sg = grouped ? s_gate + e * n_s * F + fcol : nullptr;
  const float* su = grouped ? s_up + e * n_s * F + fcol : nullptr;

  float ga[NT][V], ua[NT][V];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < V; ++c) ga[t][c] = ua[t][c] = 0.f;

  for (int r0 = 0; r0 < n_rows; r0 += kChunk) {
    const int n = min(kChunk, n_rows - r0);
    for (int i = tid; i < NT * kXs * kChunk; i += kThreads) {
      const int t = i / (kXs * kChunk), s = (i / kChunk) % kXs, j = i % kChunk;
      const int ti = tok[t];
      buf[i] = (j < n && ti >= 0)
                   ? to_f32(x[(int64_t)ti * D + s * n_rows + r0 + j])
                   : 0.f;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll 4
      for (int j = warp; j < n; j += kWarps) {
        const int r = r0 + j;
        float g0[V], g1[V], u0[V], u1[V];
        const int glo = r / group, ghi = (r + n_rows) / group;
        decode<W, Fmt, V>(wg + (int64_t)r * F,
                          grouped ? sg + (int64_t)glo * F : nullptr,
                          grouped ? sg + (int64_t)ghi * F : nullptr, g0, g1);
        decode<W, Fmt, V>(wu + (int64_t)r * F,
                          grouped ? su + (int64_t)glo * F : nullptr,
                          grouped ? su + (int64_t)ghi * F : nullptr, u0, u1);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float xa = buf[t * kXs * kChunk + j];
#pragma unroll
          for (int c = 0; c < V; ++c) {
            ga[t][c] += xa * g0[c];
            ua[t][c] += xa * u0[c];
          }
          if constexpr (Fmt == kInt4) {
            const float xb = buf[(t * kXs + 1) * kChunk + j];
#pragma unroll
            for (int c = 0; c < V; ++c) {
              ga[t][c] += xb * g1[c];
              ua[t][c] += xb * u1[c];
            }
          }
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
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < V; ++c) buf[(warp * NT + t) * kCols + V * lane + c] = ga[t][c];
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
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < V; ++c) buf[(warp * NT + t) * kCols + V * lane + c] = ua[t][c];
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = tid + p * kThreads;
    if (idx >= kOut) continue;
    float up = 0.f;
    for (int w = 0; w < kWarps; ++w) up += buf[w * kOut + idx];
    const int t = idx / kCols, f = f0 + idx % kCols;
    if (f >= F) continue;
    float g = gate[p];
    if (Fmt != kPlain && !grouped) {  // per-column scales fold after the dot
      g *= s_gate[e * F + f];
      up *= s_up[e * F + f];
    }
    h[((int64_t)row * NT + t) * F + f] = from_f32<H>(silu(g) * up);
  }
}

template <typename T, int Fmt, int NT>
__global__ void __launch_bounds__(32 * down_warps<Fmt, NT>())
expert_down_kernel(const typename Types<T, Fmt>::H* __restrict__ h,
                   const int* __restrict__ eids,
                   const typename Types<T, Fmt>::W* __restrict__ w_down,
                   const float* __restrict__ s_down, int n_s,
                   T* __restrict__ y, int D, int F) {
  using W = typename Types<T, Fmt>::W;
  constexpr int V = down_vec<Fmt>();
  constexpr int kCols = kDownCols;
  constexpr int kWarps = down_warps<Fmt, NT>();
  constexpr int kThreads = 32 * kWarps;
  __shared__ float buf[cmax(NT * kChunk, kWarps * NT * kCols)];
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int width = Fmt == kInt4 ? D / 2 : D;  // stored columns per row
  const int c0 = blockIdx.x * 32 * V;          // first stored column
  const int wcol = c0 + V * lane;
  const bool col_ok = wcol < width;  // D is even (int4: D / 2 is the width)
  const int64_t e = eids[row];
  const W* wd = w_down + e * F * width + wcol;
  const auto* hr = h + (int64_t)row * NT * F;
  const bool grouped = Fmt == kInt4 && n_s > 1;
  const int group = grouped ? F / n_s : F;
  const float* sd = grouped ? s_down + e * n_s * D + wcol : nullptr;

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
        const int f = f0 + j;
        float w[2];
        if constexpr (Fmt == kInt4) {
          float lo[1], hi[1];
          const float* s = grouped ? sd + (int64_t)(f / group) * D : nullptr;
          decode<W, Fmt, 1>(wd + (int64_t)f * width, s,
                            grouped ? s + D / 2 : nullptr, lo, hi);
          w[0] = lo[0];
          w[1] = hi[0];
        } else {
          float lo[2], unused[2];
          decode<W, Fmt, 2>(wd + (int64_t)f * width, nullptr, nullptr, lo, unused);
          w[0] = lo[0];
          w[1] = lo[1];
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float hv = buf[t * kChunk + j];
          acc[t][0] += hv * w[0];
          acc[t][1] += hv * w[1];
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
    const int t = idx / kCols, slot = idx % kCols;
    // slot 2 * l + i of lane l: stored column c0 + V * l + i, or for int4
    // the packed column c0 + l and output half i
    int col;
    bool ok;
    if constexpr (Fmt == kInt4) {
      ok = c0 + slot / 2 < width;
      col = c0 + slot / 2 + (slot % 2) * width;
    } else {
      col = c0 + slot;
      ok = col < D;
    }
    if (!ok) continue;
    if (Fmt != kPlain && !grouped) s *= s_down[e * D + col];
    y[((int64_t)row * NT + t) * D + col] = from_f32<T>(s);
  }
}

template <typename T, int Fmt, int NT>
int launch_nt(const void* x, const int* eids, const int* toks, const void* wg,
              const void* wu, const void* wd, const float* sg,
              const float* su, const float* sd, int n_sg, int n_sd, void* h,
              void* y, int R, int D, int F, cudaStream_t stream) {
  using W = typename Types<T, Fmt>::W;
  using H = typename Types<T, Fmt>::H;
  constexpr int up_cols = 32 * up_vec<Fmt, NT>();
  dim3 up_grid((F + up_cols - 1) / up_cols, R);
  expert_up_kernel<T, Fmt, NT><<<up_grid, 32 * up_warps<Fmt, NT>(), 0, stream>>>(
      static_cast<const T*>(x), eids, toks, static_cast<const W*>(wg),
      static_cast<const W*>(wu), sg, su, n_sg, static_cast<H*>(h), D, F);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int width = Fmt == kInt4 ? D / 2 : D;
  constexpr int down_cols = 32 * down_vec<Fmt>();  // stored columns per block
  dim3 down_grid((width + down_cols - 1) / down_cols, R);
  expert_down_kernel<T, Fmt, NT><<<down_grid, 32 * down_warps<Fmt, NT>(), 0, stream>>>(
      static_cast<const H*>(h), eids, static_cast<const W*>(wd), sd, n_sd,
      static_cast<T*>(y), D, F);
  return (int)cudaGetLastError();
}

template <typename T, int Fmt>
int launch(int nt, const void* x, const int* eids, const int* toks,
           const void* wg, const void* wu, const void* wd, const float* sg,
           const float* su, const float* sd, int n_sg, int n_sd, void* h,
           void* y, int R, int D, int F, cudaStream_t stream) {
#define VITA_NT(N)                                                          \
  case N:                                                                   \
    return launch_nt<T, Fmt, N>(x, eids, toks, wg, wu, wd, sg, su, sd,      \
                                n_sg, n_sd, h, y, R, D, F, stream);
  switch (nt) {
    VITA_NT(1)
    VITA_NT(2)
    VITA_NT(4)
    VITA_NT(8)
    VITA_NT(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VITA_NT
}

template <typename T>
int launch_fmt(int wfmt, int nt, const void* x, const int* eids,
               const int* toks, const void* wg, const void* wu,
               const void* wd, const float* sg, const float* su,
               const float* sd, int n_sg, int n_sd, void* h, void* y, int R,
               int D, int F, cudaStream_t stream) {
  switch (wfmt) {
    case kPlain:
      if constexpr (std::is_same<T, float>::value)
        return launch<T, kPlain>(nt, x, eids, toks, wg, wu, wd, sg, su, sd,
                                 n_sg, n_sd, h, y, R, D, F, stream);
      return (int)cudaErrorInvalidValue;
    case kInt8:
      return launch<T, kInt8>(nt, x, eids, toks, wg, wu, wd, sg, su, sd,
                              n_sg, n_sd, h, y, R, D, F, stream);
    case kInt4:
      return launch<T, kInt4>(nt, x, eids, toks, wg, wu, wd, sg, su, sd,
                              n_sg, n_sd, h, y, R, D, F, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vita

// x [T, D]; eids [R] int32 flat expert ids; toks [R, nt] int32 token index
// per slot (-1 = empty); scratch h [R, nt, F] and output y [R, nt, D].
// wfmt 0 (plain, float32 x only): w_gate/w_up [E_rows, D, F] and w_down
// [E_rows, F, D] float32, no scales, h float32. wfmt 1 (int8): the same shapes in
// int8 with f32 scales s_gate/s_up [E_rows, 1, F] and s_down [E_rows, 1, D].
// wfmt 2 (int4): w_gate/w_up [E_rows, D/2, F], w_down [E_rows, F, D/2],
// scales s_gate/s_up [E_rows, n_sg, F] and s_down [E_rows, n_sd, D] (one
// group folds after the dot). h is bf16 for wfmt 1 and 2. nt is 1, 2, 4,
// 8 or 16; D is even (int4: D / 2 even too) and F a multiple of 4 for the
// quantized formats. Returns the CUDA error code of the launches.
extern "C" int vita_expert_ffn(const void* x, const int* eids, const int* toks,
                               const void* w_gate, const void* w_up,
                               const void* w_down, const float* s_gate,
                               const float* s_up, const float* s_down,
                               int n_sg, int n_sd, void* h, void* y, int R,
                               int nt, int D, int F, int dtype, int wfmt,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vita::kBFloat16)
    return vita::launch_fmt<__nv_bfloat16>(wfmt, nt, x, eids, toks, w_gate,
                                           w_up, w_down, s_gate, s_up, s_down,
                                           n_sg, n_sd, h, y, R, D, F, s);
  return vita::launch_fmt<float>(wfmt, nt, x, eids, toks, w_gate, w_up,
                                 w_down, s_gate, s_up, s_down, n_sg, n_sd, h,
                                 y, R, D, F, s);
}
