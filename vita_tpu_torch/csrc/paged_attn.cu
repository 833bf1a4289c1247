// Paged decode attention over the block-pool KV cache, bf16/f32 or int8
// pages: split-K ("flash-decoding"), the splits of a (slot, kv head)
// combined in the same launch across a thread-block cluster.
//
// Replaces: vita_tpu/ops/paged_attention.py::_paged_attn_kernel (the
// bf16/f32 pallas_call in paged_attention) and ::_paged_attn_kernel_q (its
// int8 twin, kv_int8), reached from every Mixtral decode step through
// mixtral._attention_block_paged.
//
// What bounds it on the H100: bytes. One decode token per slot does about
// 2 * group FLOP per K/V element (4 per byte of bf16 pages at group 4, 8 per
// byte of int8), far below the ~295 FLOP/byte at which the tensor cores
// would become the limit. The kernel's time is the slots' true K/V bytes
// streamed from HBM, if the keys are spread over enough SMs, 16-byte loads
// are kept in flight, and few instructions are spent per byte: about 25 GB/s
// a SM, which a float32 FMA loop over a GQA group cannot issue for int8
// pages and barely for bf16 ones, so bf16 q runs the products on tensor cores.
//
// What it computes (as the TPU kernels): a slot visits n_pages =
// min(ceil(length / page), max_pages) pages of its table (the clamp matters:
// a speculative chunk can push length past the allocation); each page id is
// clamped into the pool (unused entries hold the pool size as a sentinel);
// s = (q * scale) . k in float32, masked at rows >= length; an online
// softmax in float32, p kept in float32 into PV; length 0 gives zeros; o is
// cast to q's dtype. int8 pages carry one f32 scale per (row, kv head),
// stored [L, Hkv, P, 1, page], and are never dequantized in memory: the k
// scale multiplies its score, the v scale multiplies p before PV while l
// sums the unscaled p.
//
// Design:
// - Split: the grid is (B, Hkv, S), S chosen on the host from B, Hkv and
//   the table width only (two blocks a SM, at most 8 and one per table
//   entry). Split s of a slot takes pages [s n / S, (s + 1) n / S) of its
//   n_pages, computed in the kernel from the device length, so short and
//   long slots both spread over their splits and no length is read on the
//   host. An empty split (or a slot of length 0) leaves an empty partial:
//   m = -inf, l = 0, acc = 0.
// - Ring: a split walks its key rows in tiles (64 rows with bf16 q, 32 with
//   float32 q), whatever the page size (each row finds its page through the
//   table), staged in their stored type by 16-byte cp.async from every
//   thread into a ring (bf16 q: 2 stages, so that 3 blocks fit a SM; deeper
//   rings cost a block a SM and measured slower; float32 q: about 48 KB);
//   rows are padded by 16 bytes against bank conflicts. Rows past the
//   split's end are zero-filled and not read.
// - Math, bf16 q (bf16 or int8 pages; attend_mma): mma.sync m16n8k16, a
//   warp on 16 keys of a tile, the group's q rows as A, K and V from
//   ldmatrix, scores (q . k) * scale, p into PV as its rounding plus the
//   remainder, so it is not rounded. int8 pages run the f16 product: a byte
//   becomes an exact f16 by one byte permute and one half subtract a pair
//   (integer-to-float conversions issue at a quarter of the rate), q is
//   taken to f16 once.
//   float32 q (float32 or int8 pages; attend_simt): CUDA-core FMAs,
//   half-warps on 4 rows each (float32 pages keep float32 products).
// - Combine: the warps' partials meet in a fixed order in shared memory,
//   leaving one partial per block (m, l, acc[128] per q head). The S blocks
//   of a (slot, kv head) form one cluster; after a cluster barrier, rank 0
//   reads the peers' partials through distributed shared memory in rank
//   order, rescales each by exp(m_s - m), divides by l and writes o; a
//   second cluster barrier keeps the peers resident until then. No global
//   scratch, no second launch, no atomics: two launches give the same bits.
//
// VITA_PAGED_FAULT (0 in the shipped kernel) builds a deliberately wrong
// kernel for chip_smoke.py's check that its tolerance catches a broken
// split: 1 drops the last split's partial from the combine, 2 drops the
// last 16 rows of every split's range.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

#ifndef VITA_PAGED_FAULT
#define VITA_PAGED_FAULT 0
#endif

namespace vita {
namespace {

namespace cg = cooperative_groups;

constexpr int kD = 128;
constexpr int kMaxGroup = 8;
constexpr int kThreads = 128;   // 4 warps
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMmaRows = 64;      // key rows a tile, tensor-core path (16 a warp)
constexpr int kMmaStages = 2;     // its ring: bf16 pages (70 KB, 3 blocks a SM)
constexpr int kMmaStagesQ = 2;    // int8 pages (38 KB, 3 blocks a SM)
constexpr int kSimtRows = 32;     // key rows a tile, float32 path (4 a half-warp)
constexpr int kSimtRing = 48 * 1024;  // its ring's bytes (at least 2 stages)

// The tile ring of one page type: rows padded by 16 bytes, so that the 8
// row addresses of an ldmatrix fall on distinct banks.
template <typename T, typename KV>
struct Tiles {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRows = kMma ? kMmaRows : kSimtRows;
  static constexpr int kRowBytes = kD * (int)sizeof(KV);
  static constexpr int kRowStride = kRowBytes + 16;
  static constexpr int kTileBytes = kRows * kRowStride;
  // K tile, V tile, and for int8 pages the tile's k and v row scales
  static constexpr int kStageBytes = 2 * kTileBytes + (kQuant ? 2 * kRows * 4 : 0);
  static constexpr int kStages = kMma ? (kQuant ? kMmaStagesQ : kMmaStages)
                                : kSimtRing / kStageBytes < 2 ? 2 : kSimtRing / kStageBytes;
  static constexpr int kSmem = kStages * kStageBytes;
};

// The ring's pipeline: tiles 0 .. n_tiles - 1 loaded kStages - 1 ahead
// (load(j, stage) issues cp.async into a stage), consume(j, stage) once
// tile j has landed; two block barriers a tile.
template <int kStages, typename Load, typename Consume>
__device__ __forceinline__ void walk_tiles(int n_tiles, Load& load, Consume&& consume) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int next = j + kStages - 1;
    if (next < n_tiles) load(next, next % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    consume(j, j % kStages);
    __syncthreads();  // the stage is read before a later load refills it
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16 q; bf16 or int8 pages). Warp w takes keys 16w ..
// 16w + 15 of each 64-row tile. Scores S = Q K^T by mma.sync m16n8k16: A is
// the group's q rows (rows g < group of 16; k the head dims), B a K tile of
// 8 keys from ldmatrix; C gives lane (g, t) = (lane / 4, lane % 4) head g's
// scores at keys 2t, 2t + 1 of each 8-key tile. Then O += P V with A = p:
// rows g hold p rounded to the operand type and rows g + 8 the remainder
// (so p enters PV unrounded to about 2^-16), B = V by ldmatrix.trans; O is
// C rows g plus rows g + 8. bf16 pages take bf16 operands. int8 pages take
// f16 ones (q converted once; an int8 byte is exact in either): they are
// read as pairs of bytes (16-bit elements); in S the head dims of a k-step
// are taken in the order ldmatrix gives them (dims 4t .. 4t + 3 for k 2t,
// 2t + 1, 2t + 8, 2t + 9), q's A fragment in the same order; in PV a trans
// matrix of 8 keys x 16 dims gives two 8-column tiles, the even and the odd
// dims.

// Two bytes (lo, hi) of the int8 word r as an f16 pair, exactly: rx = r ^
// 0x80808080 holds b + 128; with 0x64 above it that is the half 1152 + b.
__device__ __forceinline__ uint32_t i8_f16x2(uint32_t rx, int lo, int hi) {
  uint32_t w = __byte_perm(rx, 0x64646464u, lo | 0x40 | (hi << 8) | 0x4000);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&w), __float2half2_rn(1152.f));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The head dim of column c (0-7) of 8-column output tile n (0-15).
template <bool kQuant>
__device__ __forceinline__ int mma_dim(int n, int c) {
  if (!kQuant) return 8 * n + c;
  return 32 * (n / 4) + 16 * ((n / 2) % 2) + 2 * c + n % 2;
}

template <typename KV, int G, typename Load>
__device__ __forceinline__ void attend_mma(const __nv_bfloat16* qs, int group, float scale,
                                           const unsigned char* ring, int row0, int row_end,
                                           int n_tiles, Load& load, float* red_acc,
                                           float* red_ml) {
  using P = Tiles<__nv_bfloat16, KV>;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, t = lane % 4;

  // q's A fragments (a0, a2 of each k-step; rows g + 8 are zero)
  uint32_t qa[8][2];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dim = P::kQuant ? 16 * kk + 4 * t + 2 * h : 16 * kk + 2 * t + 8 * h;
      uint32_t v = g < group ? *reinterpret_cast<const uint32_t*>(qs + g * kD + dim) : 0u;
      if (P::kQuant) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
        v = pack_f16(f.x, f.y);
      }
      qa[kk][h] = v;
    }
  float m = -INFINITY, l = 0.f;  // head g's running max and this lane's sum
  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  walk_tiles<P::kStages>(n_tiles, load, [&](int j, int stage) {
    const unsigned char* kb = ring + stage * P::kStageBytes;
    const unsigned char* vb = kb + P::kTileBytes;
    const float* sc = reinterpret_cast<const float*>(kb + 2 * P::kTileBytes);
    const int i = lane / 8;  // the matrix whose row address this lane gives

    float s[2][4] = {};
    if (P::kQuant) {
      const unsigned char* row = kb + (16 * w + (i / 2) * 8 + lane % 8) * P::kRowStride;
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {  // k-steps 2 k2, 2 k2 + 1
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(row + 32 * k2 + (i % 2) * 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] ^= 0x80808080u;
        const uint32_t a0[4] = {qa[2 * k2][0], 0u, qa[2 * k2][1], 0u};
        const uint32_t a1[4] = {qa[2 * k2 + 1][0], 0u, qa[2 * k2 + 1][1], 0u};
        mma_f16(s[0], a0, i8_f16x2(r[0], 0, 1), i8_f16x2(r[0], 2, 3));
        mma_f16(s[0], a1, i8_f16x2(r[1], 0, 1), i8_f16x2(r[1], 2, 3));
        mma_f16(s[1], a0, i8_f16x2(r[2], 0, 1), i8_f16x2(r[2], 2, 3));
        mma_f16(s[1], a1, i8_f16x2(r[3], 0, 1), i8_f16x2(r[3], 2, 3));
      }
    } else {
      const unsigned char* row = kb + (16 * w + (i / 2) * 8 + lane % 8) * P::kRowStride;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(row + (16 * kk + (i % 2) * 8) * 2));
        const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        mma_bf16(s[0], a, r[0], r[1]);
        mma_bf16(s[1], a, r[2], r[3]);
      }
    }

    // online softmax of head g over this warp's 16 keys
    float p[2][2], mt = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = 16 * w + 8 * n + 2 * t + c;
        float v = s[n][c] * scale;
        if (P::kQuant) v *= sc[key];
        p[n][c] = row0 + j * P::kRows + key < row_end ? v : -INFINITY;
        mt = fmaxf(mt, p[n][c]);
      }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float a = rescale(m, m_new);
    float sum = 0.f;
    uint32_t pa[4];  // rows g: p v_scale rounded, rows g + 8: the remainder
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float hi[2], lo[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = masked_exp(p[n][c], m_new);
        sum += e;
        const float pv = P::kQuant ? e * sc[P::kRows + 16 * w + 8 * n + 2 * t + c] : e;
        hi[c] = P::kQuant ? __half2float(__float2half_rn(pv)) : bf16_round(pv);
        lo[c] = pv - hi[c];
      }
      pa[2 * n] = P::kQuant ? pack_f16(hi[0], hi[1]) : pack_bf16(hi[0], hi[1]);
      pa[2 * n + 1] = P::kQuant ? pack_f16(lo[0], lo[1]) : pack_bf16(lo[0], lo[1]);
    }
    l = l * a + sum;
    m = m_new;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= a;

    const unsigned char* vrow = vb + (16 * w + (i % 2) * 8 + lane % 8) * P::kRowStride;
    if (P::kQuant) {
#pragma unroll
      for (int nq = 0; nq < 4; ++nq) {  // head dims 32 nq .. 32 nq + 31
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(vrow + 32 * nq + (i / 2) * 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] ^= 0x80808080u;
        mma_f16(acc[4 * nq], pa, i8_f16x2(r[0], 0, 2), i8_f16x2(r[1], 0, 2));
        mma_f16(acc[4 * nq + 1], pa, i8_f16x2(r[0], 1, 3), i8_f16x2(r[1], 1, 3));
        mma_f16(acc[4 * nq + 2], pa, i8_f16x2(r[2], 0, 2), i8_f16x2(r[3], 0, 2));
        mma_f16(acc[4 * nq + 3], pa, i8_f16x2(r[2], 1, 3), i8_f16x2(r[3], 1, 3));
      }
    } else {
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {  // head dims 16 nn .. 16 nn + 15
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(vrow + (16 * nn + (i / 2) * 8) * 2));
        mma_bf16(acc[2 * nn], pa, r[0], r[1]);
        mma_bf16(acc[2 * nn + 1], pa, r[2], r[3]);
      }
    }
  });

  // this warp's partial of head g: m, the quad's sum l, o = rows g + g + 8
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (g < G) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        red_acc[(w * G + g) * kD + mma_dim<P::kQuant>(n, 2 * t + c)] = acc[n][c] + acc[n][c + 2];
    if (t == 0) {
      red_ml[(w * G + g) * 2] = m;
      red_ml[(w * G + g) * 2 + 1] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// float32 path (float32 q; float32 or int8 pages). 8 half-warps, each on 4
// rows of a 32-row tile, a row's 128 dims spread over its 16 lanes (lane li
// holds dims 4 li .. 4 li + 3 and 64 + 4 li .. 64 + 4 li + 3); q * scale in
// registers; a score is 8 FMAs and 4 shuffles per q head; each half-warp
// keeps its own running max, sum and accumulator, rescaled once per tile.

__device__ __forceinline__ int simt_dim(int li, int e) { return (e / 4) * 64 + li * 4 + e % 4; }

__device__ __forceinline__ void load8(const float* row, int li, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + li * 4);
  const float4 b = *reinterpret_cast<const float4*>(row + 64 + li * 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const int8_t* row, int li, float (&x)[8]) {
  const uint32_t a = *reinterpret_cast<const uint32_t*>(row + li * 4);
  const uint32_t b = *reinterpret_cast<const uint32_t*>(row + 64 + li * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = (float)(int8_t)(a >> (8 * i));
    x[4 + i] = (float)(int8_t)(b >> (8 * i));
  }
}

template <typename KV, int G, typename Load>
__device__ __forceinline__ void attend_simt(const float* qs, int group, float scale,
                                            const unsigned char* ring, int row0, int row_end,
                                            int n_tiles, Load& load, float* red_acc,
                                            float* red_ml) {
  using P = Tiles<float, KV>;
  constexpr int kRowsPerHalf = P::kRows / 8;
  const int tid = threadIdx.x, warp = tid / 32, half = tid / 16, li = tid % 16;

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] = g < group ? qs[g * kD + simt_dim(li, e)] * scale : 0.f;
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  walk_tiles<P::kStages>(n_tiles, load, [&](int j, int stage) {
    const unsigned char* kb = ring + stage * P::kStageBytes;
    const unsigned char* vb = kb + P::kTileBytes;
    const float* sc = reinterpret_cast<const float*>(kb + 2 * P::kTileBytes);
    const int r0 = half * kRowsPerHalf;

    float s[kRowsPerHalf][G];
#pragma unroll
    for (int k = 0; k < kRowsPerHalf; ++k) {
      float x[8];
      load8(reinterpret_cast<const KV*>(kb + (r0 + k) * P::kRowStride), li, x);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[g][e], x[e], d);
        s[k][g] = d;
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerHalf; ++k) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)  // the 16 lanes of the half-warp
          s[k][g] += __shfl_xor_sync(0xffffffffu, s[k][g], off);
      }
      const bool valid = row0 + j * P::kRows + r0 + k < row_end;
#pragma unroll
      for (int g = 0; g < G; ++g)
        s[k][g] = valid ? (P::kQuant ? s[k][g] * sc[r0 + k] : s[k][g]) : -INFINITY;
    }

    // online softmax, once per tile; s becomes p
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = s[0][g];
#pragma unroll
      for (int k = 1; k < kRowsPerHalf; ++k) mt = fmaxf(mt, s[k][g]);
      const float m_new = fmaxf(m[g], mt);
      const float a = rescale(m[g], m_new);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kRowsPerHalf; ++k) {
        s[k][g] = masked_exp(s[k][g], m_new);
        sum += s[k][g];
      }
      l[g] = l[g] * a + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= a;
    }
#pragma unroll
    for (int k = 0; k < kRowsPerHalf; ++k) {
      float x[8];
      load8(reinterpret_cast<const KV*>(vb + (r0 + k) * P::kRowStride), li, x);
      const float vs = P::kQuant ? sc[P::kRows + r0 + k] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pv = s[k][g] * vs;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pv, x[e], acc[g][e]);
      }
    }
  });

  // the two half-warps of a warp (the upper one's values into the lower)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float mo = __shfl_xor_sync(0xffffffffu, m[g], 16);
    const float lo = __shfl_xor_sync(0xffffffffu, l[g], 16);
    const float mx = fmaxf(m[g], mo);
    const float wa = rescale(m[g], mx), wb = rescale(mo, mx);
    l[g] = l[g] * wa + lo * wb;
    m[g] = mx;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
      acc[g][e] = acc[g][e] * wa + ao * wb;
    }
  }
  if (tid % 32 < 16) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red_acc[(warp * G + g) * kD + simt_dim(li, e)] = acc[g][e];
      if (li == 0) {
        red_ml[(warp * G + g) * 2] = m[g];
        red_ml[(warp * G + g) * 2 + 1] = l[g];
      }
    }
  }
}

// ---------------------------------------------------------------------------
template <typename T, typename KV, int G>
__global__ void __launch_bounds__(kThreads)
paged_attn_split_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                        const KV* __restrict__ v_pages, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, T* __restrict__ o,
                        const int* __restrict__ tables, const int* __restrict__ lengths,
                        int layer, int Hq, int Hkv, int n_pool, int page, int max_pages,
                        float scale) {
  using P = Tiles<T, KV>;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float part_m[kMaxGroup], part_l[kMaxGroup];
  __shared__ float part_acc[kMaxGroup][kD];

  cg::cluster_group cluster = cg::this_cluster();
  const int slot = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int group = Hq / Hkv;

  // this split's key rows [row0, row_end)
  const int length = lengths[slot];
  const int n_pages = length <= 0 ? 0 : min((length + page - 1) / page, max_pages);
  const int p0 = split * n_pages / n_split, p1 = (split + 1) * n_pages / n_split;
  const int row0 = p0 * page;
  int row_end = min(p1 * page, length);
  if (VITA_PAGED_FAULT == 2) row_end -= 16;
  const int n_rows = max(row_end - row0, 0);
  const int n_tiles = (n_rows + P::kRows - 1) / P::kRows;

  const int64_t page_elems = (int64_t)page * kD;
  const int64_t head_off = ((int64_t)layer * Hkv + kvh) * n_pool * page_elems;
  const int64_t scale_off = ((int64_t)layer * Hkv + kvh) * n_pool * page;
  const int* table = tables + (int64_t)slot * max_pages;

  // where key row pos of this slot lies in the pool (its page id clamped)
  auto row_offset = [&](int pos) -> int64_t {
    const int pid = min(max(table[pos / page], 0), n_pool - 1);
    return (int64_t)pid * page + pos % page;
  };
  // tile j's K and V rows (zeros past row_end) and int8 row scales
  auto load_tile = [&](int j, int stage) {
    unsigned char* base = ring + stage * P::kStageBytes;
    constexpr int kChunksPerRow = P::kRowBytes / 16;
    constexpr int kChunks = P::kRows * kChunksPerRow;
    static_assert(kChunks % kThreads == 0, "chunks of a tile per thread");
#pragma unroll
    for (int i = 0; i < kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunksPerRow, col = c % kChunksPerRow;
      const int pos = row0 + j * P::kRows + r;
      const bool ok = pos < row_end;
      const int64_t off = ok ? (head_off + row_offset(pos) * kD) * (int64_t)sizeof(KV) : 0;
      const int dst = r * P::kRowStride + col * 16;
      cp_async16(smem_addr(base + dst), reinterpret_cast<const char*>(k_pages) + off + col * 16,
                 ok ? 16 : 0);
      cp_async16(smem_addr(base + P::kTileBytes + dst),
                 reinterpret_cast<const char*>(v_pages) + off + col * 16, ok ? 16 : 0);
    }
    if (P::kQuant && tid < 2 * P::kRows) {  // k scales, then v scales
      const int pos = row0 + j * P::kRows + tid % P::kRows;
      const bool ok = pos < row_end;
      const float* src =
          (tid < P::kRows ? k_scale : v_scale) + (ok ? scale_off + row_offset(pos) : 0);
      cp_async4(smem_addr(base + 2 * P::kTileBytes + tid * 4), src, ok ? 4 : 0);
    }
  };

  // each warp's partial (m, l, acc per q head) lands in the ring once it is
  // free: walk_tiles ends on a barrier with every copy landed
  float* red_acc = reinterpret_cast<float*>(ring);  // [4][G][kD]
  float* red_ml = red_acc + 4 * G * kD;              // [4][G][2]
  const T* qs = q + ((int64_t)slot * Hq + (int64_t)kvh * group) * kD;
  if constexpr (P::kMma)
    attend_mma<KV, G>(qs, group, scale, ring, row0, row_end, n_tiles, load_tile, red_acc,
                      red_ml);
  else
    attend_simt<KV, G>(qs, group, scale, ring, row0, row_end, n_tiles, load_tile, red_acc,
                       red_ml);
  __syncthreads();

  // the four warps, in order: this block's partial, thread d on head dim d
  const int d = tid;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, red_ml[(w * G + g) * 2]);
    float sl = 0.f, sa = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = rescale(red_ml[(w * G + g) * 2], mx);
      sl += red_ml[(w * G + g) * 2 + 1] * wt;
      sa += red_acc[(w * G + g) * kD + d] * wt;
    }
    part_acc[g][d] = sa;
    if (d == 0) {
      part_m[g] = mx;
      part_l[g] = sl;
    }
  }

  // the splits, in rank order, by rank 0 of the cluster: every split's
  // partial at this thread's dim is read at once, then summed
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int n_used = VITA_PAGED_FAULT == 1 ? n_split - 1 : n_split;
    float sm[kMaxSplits][G], sl[kMaxSplits][G], sa[kMaxSplits][G];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      const bool used = r < n_used;
      const float* rm = cluster.map_shared_rank(part_m, used ? r : 0);
      const float* rl = cluster.map_shared_rank(part_l, used ? r : 0);
      const float* ra = cluster.map_shared_rank(&part_acc[0][0], used ? r : 0);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sm[r][g] = used ? rm[g] : -INFINITY;
        sl[r][g] = used ? rl[g] : 0.f;
        sa[r][g] = used ? ra[g * kD + d] : 0.f;
      }
    }
    T* os = o + ((int64_t)slot * Hq + (int64_t)kvh * group) * kD;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) mx = fmaxf(mx, sm[r][g]);
      float l_sum = 0.f, a_sum = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        const float wt = rescale(sm[r][g], mx);
        l_sum += sl[r][g] * wt;
        a_sum += sa[r][g] * wt;
      }
      if (g < group) os[(int64_t)g * kD + d] = from_f32<T>(l_sum > 0.f ? a_sum / l_sum : 0.f);
    }
  }
  cluster.sync();  // the peers' partials stay resident until rank 0 has read them
}

// Splits of a slot's keys: enough blocks for two on every SM, at most one
// per table entry and the portable cluster size.
int n_splits(int B, int Hkv, int max_pages) {
  const int pairs = B * Hkv > 0 ? B * Hkv : 1;
  int n = (2 * sm_count() + pairs - 1) / pairs;
  n = n < kMaxSplits ? n : kMaxSplits;
  n = n < max_pages ? n : max_pages;
  return n < 1 ? 1 : n;
}

template <typename T, typename KV, int G>
int launch_group(const void* q, const void* kp, const void* vp, const float* ks,
                 const float* vs, void* o, const int* tables, const int* lengths, int B,
                 int layer, int Hq, int Hkv, int n_pool, int page, int max_pages, float scale,
                 cudaStream_t stream) {
  auto kernel = paged_attn_split_kernel<T, KV, G>;
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<T, KV>::kSmem);
  if (set != cudaSuccess) return (int)set;
  const int n_split = n_splits(B, Hkv, max_pages);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, Hkv, n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tiles<T, KV>::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                                 static_cast<const KV*>(kp), static_cast<const KV*>(vp), ks, vs,
                                 static_cast<T*>(o), tables, lengths, layer, Hq, Hkv, n_pool,
                                 page, max_pages, scale);
}

// G: the GQA group rounded up to a power of two (heads past it are idle)
template <typename T, typename KV>
int launch(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
           void* o, const int* tables, const int* lengths, int B, int layer, int Hq, int Hkv,
           int n_pool, int page, int max_pages, float scale, cudaStream_t stream) {
  const int group = Hq / Hkv;
  auto run = group <= 1   ? launch_group<T, KV, 1>
             : group <= 2 ? launch_group<T, KV, 2>
             : group <= 4 ? launch_group<T, KV, 4>
                          : launch_group<T, KV, 8>;
  return run(q, kp, vp, ks, vs, o, tables, lengths, B, layer, Hq, Hkv, n_pool, page, max_pages,
             scale, stream);
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

// Splits (blocks of a cluster) a launch over B slots of Hkv kv heads with
// this table width takes.
extern "C" int vita_paged_attn_splits(int B, int Hkv, int max_pages) {
  return vita::n_splits(B, Hkv, max_pages);
}

// Resources of the kernel at group 4 (the served model's 32 / 8 heads) with
// bf16 q, which = 0: bf16 pages, 1: int8 pages; out as kernel_info.
extern "C" int vita_paged_attn_info(int which, int* out) {
  using vita::Tiles;
  using bf16 = __nv_bfloat16;
  if (which == 0)
    return vita::kernel_info((const void*)vita::paged_attn_split_kernel<bf16, bf16, 4>,
                             vita::kThreads, Tiles<bf16, bf16>::kSmem, out);
  return vita::kernel_info((const void*)vita::paged_attn_split_kernel<bf16, int8_t, 4>,
                           vita::kThreads, Tiles<bf16, int8_t>::kSmem, out);
}
