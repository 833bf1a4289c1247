// Flash attention backward for training: dQ (B10) and dK/dV (B11).
//
// Replaces: vita_tpu/ops/flash_attention.py::_bwd_dq_kernel (B10) and
// ::_bwd_dkv_kernel (B11), the two pallas_calls of _flash_bwd, reached from
// flash_mha's custom VJP when the LLM trains with attn_backend="flash".
//
// Both recompute the scores of a (q tile, kv tile) pair from q, k and the
// forward's per-row log-sum-exp (csrc/flash_fwd.cu), with the forward's
// masks (key index past kv_len; past q_offset + row when causal):
//   s = q k^T scale,  p = exp(s - lse)  (0 where masked or lse = -inf),
//   dp = dO v^T,      ds = p (dp - delta) scale,  delta = rowsum(dO o),
//   dq = ds k,        dk = ds^T q,                dv = p^T dO.
// delta is computed outside the kernels, as the JAX package computes it
// outside Pallas.
//
// What bounds them on the H100. At the training shapes (a causal sequence
// of 4096-9216 tokens, 32 q / 8 kv heads of 128) dq takes three products per
// (q, k) pair and dk/dv four, about 3.5 times the forward's work; at this
// size that is compute, far above the card's balance point. This first
// version runs every product as float32 FMA loops from shared memory, like
// the forward: it is bound by the CUDA cores' FMA rate and shared-memory
// bandwidth, far below the tensor cores. wgmma and TMA are later work.
//
// Design.
//   - B10: one block per (b * q head, 64-row q tile). q, dO, lse and delta of
//     the tile stay in shared memory while the block walks 64-row kv tiles up
//     to the tile's causal limit (the TPU's sequential kv grid axis becomes
//     this loop); dq accumulates in registers in float32 and is written once
//     in q's dtype.
//   - B11: one block per (b * kv head, 64-row kv tile). k and v stay in
//     shared memory while the block loops over the rep q heads of its GQA
//     group and over their q tiles from the causal start, so a kv tile sums
//     its whole group before one write of dk and dv, with no atomics: the
//     TPU kernel's grid (b * hkv, kv block, rep * nq) with its last axis
//     moved inside the block.
//   - Both read the [B, S, H, 128] layout directly (kv head = q head / rep)
//     and lse/delta as [B, Hq, Sq] float32. Rows past Sq or kv_len load as
//     zeros and contribute nothing.
#include "common.cuh"

namespace vita {
namespace {

constexpr int kB = 64;         // rows per q tile and per kv tile
constexpr int kD = 128;        // head dim
constexpr int kPad = kD + 1;   // padded row: conflict-free column reads
constexpr int kThreads = 256;  // thread (tx, ty): rows ty*4+i, columns tx+16j

constexpr size_t kDqSmem = (2 * kB * kD + 2 * kB * kPad + kB * kB + 2 * kB) * sizeof(float);
constexpr size_t kDkvSmem =
    (2 * kB * kD + 2 * kB * kPad + 2 * kB * kB + 2 * kB) * sizeof(float);

// Rows [row0, row0 + kB) of one head of a [*, S, H, kD] tensor (row stride
// `stride`, `base` at the head's first element) into dst [kB][ld] as
// floats; rows at or past `rows` load as zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ base,
                                          int64_t stride, int row0, int rows) {
  for (int i = threadIdx.x; i < kB * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    dst[r * ld + c] = row0 + r < rows ? to_f32(base[(int64_t)(row0 + r) * stride + c]) : 0.f;
  }
}

// lse and delta of rows [q0, q0 + kB) of head row `bh`; rows past Sq get
// lse -inf (p = 0).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta, int64_t bh,
                                               int q0, int Sq) {
  const int r = threadIdx.x;
  if (r < kB) {
    const bool ok = q0 + r < Sq;
    lse_s[r] = ok ? lse[bh * Sq + q0 + r] : -INFINITY;
    dl_s[r] = ok ? delta[bh * Sq + q0 + r] : 0.f;
  }
}

// p and ds of one score: 0 where masked or where the row saw no key.
__device__ __forceinline__ float grad_score(float s, float dp, float lse, float delta,
                                            bool ok, float scale) {
  const float p = (ok && lse != -INFINITY) ? expf(s * scale - lse) : 0.f;
  return p * (dp - delta) * scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const int* __restrict__ kv_len, const int* __restrict__ q_off, int Sq,
                    int Skv, int Hq, int Hkv, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;               // [kB][kD]
  float* Os = Qs + kB * kD;       // dO [kB][kD]
  float* Ks = Os + kB * kD;       // [kB][kPad]
  float* Vs = Ks + kB * kPad;     // [kB][kPad]
  float* Ss = Vs + kB * kPad;     // ds [kB][kB]
  float* lse_s = Ss + kB * kB;
  float* dl_s = lse_s + kB;

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int klen = min(kv_len[b], Skv);
  const int qoff = q_off[b];
  const int64_t q_stride = (int64_t)Hq * kD, kv_stride = (int64_t)Hkv * kD;
  const int64_t qbase = (int64_t)b * Sq * q_stride + (int64_t)h * kD;
  const T* kb = k + (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;
  const T* vb = v + (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;

  load_tile(Qs, kD, q + qbase, q_stride, q0, Sq);
  load_tile(Os, kD, dout + qbase, q_stride, q0, Sq);
  load_row_stats(lse_s, dl_s, lse, delta, bh, q0, Sq);
  int kend = klen;
  if (causal) kend = min(kend, qoff + min(q0 + kB, Sq));

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < kend; k0 += kB) {
    load_tile(Ks, kPad, kb, kv_stride, k0, klen);
    load_tile(Vs, kPad, vb, kv_stride, k0, klen);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * kD + d];
        ov[i] = Os[(ty * 4 + i) * kD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * kPad + d];
        vv[j] = Vs[(tx + 16 * j) * kPad + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
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
        Ss[r * kB + c] = grad_score(s[i][j], dp[i][j], lse_s[r], dl_s[r], ok, scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ss[(ty * 4 + i) * kB + j];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float kk = Ks[j * kPad + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += dsv[i] * kk;
      }
    }
    __syncthreads();
  }

  T* dqb = dq + qbase;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      dqb[(int64_t)(q0 + r) * q_stride + tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const int* __restrict__ kv_len, const int* __restrict__ q_off, int Sq,
                     int Skv, int Hq, int Hkv, float scale, int causal) {
  extern __shared__ float smem[];
  float* Ks = smem;               // [kB][kD]
  float* Vs = Ks + kB * kD;       // [kB][kD]
  float* Qs = Vs + kB * kD;       // [kB][kPad]
  float* Os = Qs + kB * kPad;     // dO [kB][kPad]
  float* Ps = Os + kB * kPad;     // p^T [kv][q]
  float* Ds = Ps + kB * kB;       // ds^T [kv][q]
  float* lse_s = Ds + kB * kB;
  float* dl_s = lse_s + kB;

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv % Hkv, rep = Hq / Hkv;
  const int k0 = blockIdx.x * kB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int klen = min(kv_len[b], Skv);
  const int qoff = q_off[b];
  const int64_t q_stride = (int64_t)Hq * kD, kv_stride = (int64_t)Hkv * kD;
  const int64_t kvbase = (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;

  load_tile(Ks, kD, k + kvbase, kv_stride, k0, klen);
  load_tile(Vs, kD, v + kvbase, kv_stride, k0, klen);

  float adk[4][8], adv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) adk[i][c] = adv[i][c] = 0.f;

  // keys of this tile at or past kv_len see nothing; every q tile whose last
  // row lies before the tile's first key is skipped when causal
  const int nq = k0 < klen ? (Sq + kB - 1) / kB : 0;
  for (int t = 0; t < rep * nq; ++t) {
    const int h = hk * rep + t / nq;
    const int q0 = (t % nq) * kB;
    if (causal && qoff + min(q0 + kB, Sq) - 1 < k0) continue;
    const int64_t bh = (int64_t)b * Hq + h;
    const int64_t qbase = (int64_t)b * Sq * q_stride + (int64_t)h * kD;
    __syncthreads();  // the previous q tile's reads are done
    load_tile(Qs, kPad, q + qbase, q_stride, q0, Sq);
    load_tile(Os, kPad, dout + qbase, q_stride, q0, Sq);
    load_row_stats(lse_s, dl_s, lse, delta, bh, q0, Sq);
    __syncthreads();

    // s^T and dp^T: kv rows ty*4+i, q columns tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kD; ++d) {
      float kk[4], vv[4], qq[4], oo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = Ks[(ty * 4 + i) * kD + d];
        vv[i] = Vs[(ty * 4 + i) * kD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qq[j] = Qs[(tx + 16 * j) * kPad + d];
        oo[j] = Os[(tx + 16 * j) * kPad + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += kk[i] * qq[j];
          dp[i][j] += vv[i] * oo[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int kpos = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = kpos < klen && (!causal || kpos <= qoff + q0 + c);
        const float l = lse_s[c];
        const float p = (ok && l != -INFINITY) ? expf(s[i][j] * scale - l) : 0.f;
        Ps[r * kB + c] = p;
        Ds[r * kB + c] = p * (dp[i][j] - dl_s[c]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty * 4 + i) * kB + j];
        dsv[i] = Ds[(ty * 4 + i) * kB + j];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float oo = Os[j * kPad + tx + 16 * c];
        const float qq = Qs[j * kPad + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          adv[i][c] += pv[i] * oo;
          adk[i][c] += dsv[i] * qq;
        }
      }
    }
  }

  T* dkb = dk + kvbase;
  T* dvb = dv + kvbase;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (k0 + r >= Skv) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int64_t off = (int64_t)(k0 + r) * kv_stride + tx + 16 * c;
      dkb[off] = from_f32<T>(adk[i][c]);
      dvb[off] = from_f32<T>(adv[i][c]);
    }
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, const int* kv_len, const int* q_off, int B, int Sq,
              int Skv, int Hq, int Hkv, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  dim3 grid((Sq + kB - 1) / kB, B * Hq);
  kernel<<<grid, kThreads, kDqSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), kv_len, q_off, Sq, Skv,
      Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, const int* kv_len, const int* q_off,
               int B, int Sq, int Skv, int Hq, int Hkv, float scale, int causal,
               cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkvSmem);
  dim3 grid((Skv + kB - 1) / kB, B * Hkv);
  kernel<<<grid, kThreads, kDkvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      kv_len, q_off, Sq, Skv, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vita

// q/dout/dq [B, Sq, Hq, 128], k/v [B, Skv, Hkv, 128] in one dtype; lse and
// delta [B, Hq, Sq] float32; kv_len/q_off [B] int32 on the device. Return
// the CUDA error code of the launch.
extern "C" int vita_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq,
                                 const int* kv_len, const int* q_off, int B, int Sq, int Skv,
                                 int Hq, int Hkv, float scale, int causal, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vita::kBFloat16)
    return vita::launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, kv_len, q_off, B, Sq,
                                          Skv, Hq, Hkv, scale, causal, s);
  return vita::launch_dq<float>(q, k, v, dout, lse, delta, dq, kv_len, q_off, B, Sq, Skv, Hq,
                                Hkv, scale, causal, s);
}

// dk/dv [B, Skv, Hkv, 128] in k's dtype; the rest as vita_flash_bwd_dq.
extern "C" int vita_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dk, void* dv,
                                  const int* kv_len, const int* q_off, int B, int Sq, int Skv,
                                  int Hq, int Hkv, float scale, int causal, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vita::kBFloat16)
    return vita::launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, kv_len, q_off, B,
                                           Sq, Skv, Hq, Hkv, scale, causal, s);
  return vita::launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, kv_len, q_off, B, Sq, Skv,
                                 Hq, Hkv, scale, causal, s);
}
