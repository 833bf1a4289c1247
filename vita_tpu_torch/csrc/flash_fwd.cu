// Flash attention forward for prefill.
//
// Replaces: vita_tpu/ops/flash_attention.py::_fwd_kernel (the pallas_call in
// _flash_fwd), reached from Mixtral's chunked prefill through flash_mha.
//
// What bounds it on the H100: at the serving shapes (one prefill chunk of
// 256 rows against a bucket of at most a few thousand keys, 32 q heads of
// 128) the work is a few GFLOP per layer and the q/k/v bytes are a few MB,
// so it is compute-bound in principle; this first version runs its two
// products as float32 FMA loops from shared memory, far below the tensor
// cores' rate, and is bound by shared-memory bandwidth.
//
// Design: one block per (batch * q head, 64-row q tile). The q tile stays in
// shared memory (pre-scaled, float32) while the block walks 64-row key tiles
// up to the causal limit of its last row: S = Q K^T, mask (key index past
// kv_len, or past q_offset + row when causal), online softmax with running
// max and sum per row, then O += P V with P rounded to V's type (the sum
// keeps P unrounded), as the Pallas kernel rounds it. GQA reads kv head h / (Hq / Hkv)
// directly from the [B, S, H, D] layout, so repeat_kv is never built.
// Rows that see no valid key write zeros. Each row's log-sum-exp of its
// scaled scores (m + log l, -inf for a row that sees no key) goes to lse
// [B, Hq, Sq], which the backward kernels (flash_bwd.cu) read. Tensor cores
// (wgmma) and TMA pipelining are later work.
#include "common.cuh"

namespace vita {
namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kD = 128;        // head dim
constexpr int kKPad = kD + 1;  // padded K row: conflict-free column reads
constexpr int kThreads = 256;

constexpr size_t kSmemFloats =
    kBQ * kD + kBK * kKPad + kBK * kD + kBQ * kBK + 3 * kBQ;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ kv_len, const int* __restrict__ q_off,
                 int Sq, int Skv, int Hq, int Hkv, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [kBQ][kD]
  float* Ks = Qs + kBQ * kD;       // [kBK][kKPad]
  float* Vs = Ks + kBK * kKPad;    // [kBK][kD]
  float* Ps = Vs + kBK * kD;       // [kBQ][kBK]
  float* row_m = Ps + kBQ * kBK;   // running max per row
  float* row_l = row_m + kBQ;      // running sum per row
  float* row_a = row_l + kBQ;      // this tile's rescale factor per row

  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx + 16 * j
  const int ty = tid / 16;  // row group: rows ty * 4 + i
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int klen = min(kv_len[b], Skv);
  const int qoff = q_off[b];
  const int64_t q_stride = (int64_t)Hq * kD;   // between sequence rows
  const int64_t kv_stride = (int64_t)Hkv * kD;
  const T* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * kD;
  const T* kb = k + (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;
  const T* vb = v + (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;
  T* ob = o + (int64_t)b * Sq * q_stride + (int64_t)h * kD;

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    Qs[i] = (q0 + r < Sq) ? to_f32(qb[(int64_t)(q0 + r) * q_stride + c]) * scale : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // keys this tile can see: below kv_len and, when causal, at or before
  // the absolute position of the tile's last real row
  int kend = klen;
  if (causal) kend = min(kend, qoff + min(q0 + kBQ, Sq));

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    for (int i = tid; i < kBK * kD; i += kThreads) {
      const int r = i / kD, c = i % kD;
      const bool ok = k0 + r < klen;
      Ks[r * kKPad + c] = ok ? to_f32(kb[(int64_t)(k0 + r) * kv_stride + c]) : 0.f;
      Vs[i] = ok ? to_f32(vb[(int64_t)(k0 + r) * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * kD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * kKPad + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = qoff + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool ok = kpos < klen && (!causal || kpos <= qpos);
        Ps[r * kBK + c] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, one lane per two keys
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float a0 = Ps[r * kBK + lane];
      const float a1 = Ps[r * kBK + lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a0, a1)));
      const float p0 = masked_exp(a0, m_new);
      const float p1 = masked_exp(a1, m_new);
      const float sum = warp_sum(p0 + p1);
      // PV reads p rounded to V's type, as the Pallas kernel's
      // p.astype(v.dtype); the row sum keeps the unrounded p
      Ps[r * kBK + lane] = to_f32(from_f32<T>(p0));
      Ps[r * kBK + lane + 32] = to_f32(from_f32<T>(p1));
      if (lane == 0) {
        const float alpha = rescale(m_old, m_new);
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
        row_a[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_a[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kBK + j];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float vv = Vs[j * kD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
    __syncthreads();
  }

  if (tid < kBQ && q0 + tid < Sq) {
    const float l = row_l[tid];
    lse[(int64_t)bh * Sq + q0 + tid] = l > 0.f ? row_m[tid] + logf(l) : -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const float l = row_l[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      ob[(int64_t)(q0 + r) * q_stride + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* kv_len, const int* q_off, int B, int Sq, int Skv,
           int Hq, int Hkv, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kSmemBytes);
  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, kv_len, q_off, Sq, Skv,
      Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vita

// q [B, Sq, Hq, 128], k/v [B, Skv, Hkv, 128], o like q; lse [B, Hq, Sq]
// float32; kv_len/q_off [B] int32 on the device. Returns the CUDA error code
// of the launch.
extern "C" int vita_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, const int* kv_len, const int* q_off,
                              int B, int Sq, int Skv, int Hq, int Hkv,
                              float scale, int causal, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vita::kBFloat16)
    return vita::launch<__nv_bfloat16>(q, k, v, o, lse, kv_len, q_off, B, Sq,
                                       Skv, Hq, Hkv, scale, causal, s);
  return vita::launch<float>(q, k, v, o, lse, kv_len, q_off, B, Sq, Skv, Hq,
                             Hkv, scale, causal, s);
}
