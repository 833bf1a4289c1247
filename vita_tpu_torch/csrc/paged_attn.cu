// Paged decode attention over the block-pool KV cache, bf16/f32 or int8
// pages.
//
// Replaces: vita_tpu/ops/paged_attention.py::_paged_attn_kernel (the
// bf16/f32 pallas_call in paged_attention) and ::_paged_attn_kernel_q (its
// int8 twin, kv_int8), reached from every Mixtral decode step through
// mixtral._attention_block_paged.
//
// What bounds it on the H100: bytes. One decode token per slot does about
// 2 FLOP per byte of K/V it reads, far below the ~295 FLOP/byte at which the
// tensor cores would become the limit, so the kernel's time is the slot's
// true K/V length streamed from HBM.
//
// Design: one block per (slot, kv head), 128 threads, one thread per head
// dim column. The block walks the slot's page table in order, clamping the
// page count to the table width and each page id into the pool exactly as
// the TPU kernel does (unused table entries hold an out-of-range sentinel).
// Each 32-row piece of a page is staged in shared memory once and serves
// every q head of the GQA group (group <= 8), so each K/V byte crosses HBM
// once per group. Scores are masked at rows >= length; an online softmax
// keeps a running max and sum per q head; length == 0 writes zeros. Pages
// are visited one after another inside the block; a split-K variant for
// long contexts with few slots, and cp.async/TMA double buffering, are
// later work.
//
// int8 pages (KV = int8_t) carry one f32 scale per (row, kv head), stored
// [L, Hkv, P, 1, page]. The rows are staged as their exact integers beside
// their scales, and the pages are never dequantized in memory: a k scale
// multiplies its score column, (q * scale) . k_int8 * k_scale[row]; a v
// scale folds into p before the PV sum, while the softmax sum l adds the
// unscaled p. Half of the bf16 pages' bytes cross HBM.
#include <type_traits>

#include "common.cuh"

namespace vita {
namespace {

constexpr int kD = 128;
constexpr int kMaxGroup = 8;
constexpr int kRows = 32;  // page rows staged per step
constexpr int kThreads = kD;

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                  const KV* __restrict__ v_pages,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, T* __restrict__ o,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths, int layer, int Hq, int Hkv,
                  int n_pool, int page, int max_pages, float scale) {
  __shared__ float Qs[kMaxGroup][kD];
  __shared__ float Ks[kRows][kD + 1];
  __shared__ float Vs[kRows][kD];
  __shared__ float Ps[kMaxGroup][kRows];
  __shared__ float Ksc[kRows], Vsc[kRows];  // int8 pages' row scales
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  __shared__ float st_m[kMaxGroup], st_l[kMaxGroup], st_a[kMaxGroup];

  const int slot = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = Hq / Hkv;
  const int length = lengths[slot];
  const int n_pages =
      length <= 0 ? 0 : min((length + page - 1) / page, max_pages);

  const T* qs = q + ((int64_t)slot * Hq + (int64_t)kvh * group) * kD;
  for (int i = tid; i < group * kD; i += kThreads)
    Qs[i / kD][i % kD] = to_f32(qs[i]) * scale;
  if (tid < kMaxGroup) {
    st_m[tid] = -INFINITY;
    st_l[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  __syncthreads();

  const int64_t page_elems = (int64_t)page * kD;
  const int64_t head_off = ((int64_t)layer * Hkv + kvh) * n_pool * page_elems;
  const int* table = tables + (int64_t)slot * max_pages;

  // scales of this (layer, kv head): [n_pool, page]
  const int64_t scale_off = ((int64_t)layer * Hkv + kvh) * n_pool * page;

  for (int pi = 0; pi < n_pages; ++pi) {
    const int pid = min(max(table[pi], 0), n_pool - 1);
    const KV* kpg = k_pages + head_off + pid * page_elems;
    const KV* vpg = v_pages + head_off + pid * page_elems;
    for (int r0 = 0; r0 < page; r0 += kRows) {
      const int nrows = min(kRows, page - r0);
      for (int i = tid; i < kRows * kD; i += kThreads) {
        const int r = i / kD, c = i % kD;
        const bool ok = r < nrows;
        Ks[r][c] = ok ? to_f32(kpg[(int64_t)(r0 + r) * kD + c]) : 0.f;
        Vs[r][c] = ok ? to_f32(vpg[(int64_t)(r0 + r) * kD + c]) : 0.f;
      }
      if (kQuant && tid < kRows) {
        const int64_t si = scale_off + (int64_t)pid * page + r0 + tid;
        Ksc[tid] = tid < nrows ? k_scale[si] : 0.f;
        Vsc[tid] = tid < nrows ? v_scale[si] : 0.f;
      }
      __syncthreads();

      for (int i = tid; i < group * kRows; i += kThreads) {
        const int g = i / kRows, r = i % kRows;
        const int kpos = pi * page + r0 + r;
        float s = -INFINITY;
        if (r < nrows && kpos < length) {
          s = 0.f;
#pragma unroll 8
          for (int d = 0; d < kD; ++d) s += Qs[g][d] * Ks[r][d];
          if (kQuant) s *= Ksc[r];
        }
        Ps[g][r] = s;
      }
      __syncthreads();

      for (int g = warp; g < group; g += kThreads / 32) {
        const float s = Ps[g][lane];
        const float m_old = st_m[g];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = masked_exp(s, m_new);
        const float sum = warp_sum(p);
        Ps[g][lane] = kQuant ? p * Vsc[lane] : p;
        if (lane == 0) {
          const float a = rescale(m_old, m_new);
          st_l[g] = st_l[g] * a + sum;
          st_m[g] = m_new;
          st_a[g] = a;
        }
      }
      __syncthreads();

#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          float sum = 0.f;
#pragma unroll 8
          for (int r = 0; r < kRows; ++r) sum += Ps[g][r] * Vs[r][tid];
          acc[g] = acc[g] * st_a[g] + sum;
        }
      }
      __syncthreads();
    }
  }

  T* os = o + ((int64_t)slot * Hq + (int64_t)kvh * group) * kD;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      const float l = st_l[g];
      os[(int64_t)g * kD + tid] = from_f32<T>(l > 0.f ? acc[g] / l : 0.f);
    }
  }
}

template <typename T, typename KV>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, void* o, const int* tables, const int* lengths,
           int B, int layer, int Hq, int Hkv, int n_pool, int page,
           int max_pages, float scale, cudaStream_t stream) {
  dim3 grid(B, Hkv);
  paged_attn_kernel<T, KV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, vs, static_cast<T*>(o), tables,
      lengths, layer, Hq, Hkv, n_pool, page, max_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vita

// q [B, Hq, 128]; pools [L, Hkv, n_pool, page, 128]; tables [B, max_pages]
// and lengths [B] int32 on the device; o [B, Hq, 128]. Hq / Hkv <= 8.
// Returns the CUDA error code of the launch.
extern "C" int vita_paged_attn(const void* q, const void* k_pages,
                               const void* v_pages, void* o,
                               const int* tables, const int* lengths, int B,
                               int layer, int Hq, int Hkv, int n_pool,
                               int page, int max_pages, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vita::kBFloat16)
    return vita::launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, o, tables, lengths, B, layer,
        Hq, Hkv, n_pool, page, max_pages, scale, s);
  return vita::launch<float, float>(q, k_pages, v_pages, nullptr, nullptr, o,
                                    tables, lengths, B, layer, Hq, Hkv,
                                    n_pool, page, max_pages, scale, s);
}

// As vita_paged_attn over int8 pools [L, Hkv, n_pool, page, 128] with f32
// row scales k_scale/v_scale [L, Hkv, n_pool, 1, page]; q and o are
// float32 or bfloat16 (dtype). Returns the CUDA error code of the launch.
extern "C" int vita_paged_attn_q(const void* q, const void* k_pages,
                                 const void* v_pages, const float* k_scale,
                                 const float* v_scale, void* o,
                                 const int* tables, const int* lengths,
                                 int B, int layer, int Hq, int Hkv,
                                 int n_pool, int page, int max_pages,
                                 float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vita::kBFloat16)
    return vita::launch<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, o, tables, lengths, B, layer,
        Hq, Hkv, n_pool, page, max_pages, scale, s);
  return vita::launch<float, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                     o, tables, lengths, B, layer, Hq, Hkv,
                                     n_pool, page, max_pages, scale, s);
}
