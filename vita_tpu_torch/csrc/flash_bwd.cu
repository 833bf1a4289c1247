// Flash attention backward for training: dQ (B10) and dK/dV (B11).
//
// Replaces: vita_tpu/ops/flash_attention.py::_bwd_dq_kernel (B10) and
// ::_bwd_dkv_kernel (B11), the two pallas_calls of _flash_bwd, reached from
// flash_mha's custom VJP when the LLM trains with attn_backend="flash".
//
// Both recompute the scores of a (q tile, kv tile) pair from q, k and the
// forward's per-row log-sum-exp (csrc/flash_fwd.cu), with the forward's
// masks (key index past kv_len; past q_offset + row when causal, q_offset
// possibly negative):
//   s = q k^T scale,  p = exp(s - lse)  (0 where masked or lse = -inf),
//   dp = dO v^T,      ds = p (dp - delta) scale,  delta = rowsum(dO o),
//   dq = ds k,        dk = ds^T q,                dv = p^T dO.
// delta is computed outside the kernels, as the JAX package computes it
// outside Pallas. Layout [B, S, H, 128], kv head = q head / rep, lse and
// delta [B, Hq, Sq] float32. Every output element is written once by one
// block, with no atomics, so two launches give the same bits.
//
// Two kernels per gradient, chosen by dtype before the launch:
//
// bfloat16 (the training path): tensor cores. At the training shapes (a
// causal sequence of 4096-9216 tokens, 32 q / 8 kv heads of 128) dq takes
// three products per (q, k) pair and dk/dv four, far above the card's
// balance point: operations bound them, so the design keeps the tensor
// cores fed. Tiles sit in shared memory in bf16, rows padded by 16 bytes
// (272-byte stride: the 8 row addresses of an ldmatrix fall in 8 different
// bank groups); the streamed tiles arrive by cp.async (16 bytes a thread,
// zero-filled past Sq or kv_len) into a ring of 3 stages, so the next tile
// loads while the current one computes and one barrier per tile suffices.
// All seven products are mma.sync m16n8k16 with float32 accumulation and
// ldmatrix-fed operands, as in FlashAttention-2. p and ds are computed in
// the accumulator registers (exp2 with log2(e) folded into the scale and
// the lse) and rounded to bf16 before the second products, as the Pallas
// kernels round them; a C tile pair is then the next product's A fragment
// without a trip through shared memory. Element masks run only on tiles
// that cross kv_len or the causal diagonal; whole tiles past either are
// skipped. 4 warps of 16 rows; about 86 KB of shared memory a block, so
// two blocks share an SM (flash_bwd_mma_info reports registers, spills and
// blocks per SM). wgmma and TMA are later work.
//   - B10: one block per (b * q head, 64-row q tile), the longest causal
//     walks dispatched first. The warp's q and dO fragments stay in
//     registers for the whole kv walk over 32-key tiles up to the tile's
//     causal limit (the TPU's sequential kv grid axis); s = q k^T and dp =
//     dO v^T, ds in registers, dq += ds k with k read through
//     ldmatrix.trans; dq accumulates in float32 and is written once.
//   - B11: one block per (b * kv head, 64-key kv tile), heads fastest so
//     that the longest walks start first. k and v stay in shared memory
//     while the block walks the rep q heads of its GQA group and their
//     32-row q tiles from the causal start; s^T = k q^T and dp^T = v dO^T,
//     p^T and ds^T in registers, dv += p^T dO and dk += ds^T q with dO and
//     q read through ldmatrix.trans. dk and dv sum the whole group before
//     one write: the TPU kernel's grid (b * hkv, kv block, rep * nq) with
//     its last axis moved inside the block.
//   q rows past Sq load as zeros with lse and delta 0, so their p^T dO and
//   ds^T q terms are exactly 0.
//
// float32: FMA kernels, every product a float32 FMA loop from
// shared memory (so the float32 comparison with the plain version stays
// tight): bound by the CUDA cores' FMA rate, far below the tensor cores.
// Same blocks as the bf16 kernels with 64-row tiles on both sides, 256
// threads, one block per SM (148-161 KB of shared memory).
#include "common.cuh"

namespace vita {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;  // head dim
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- float32
constexpr int kB = 64;         // rows per q tile and per kv tile
constexpr int kPad = kD + 1;   // padded row: conflict-free column reads
constexpr int kThreads = 256;  // thread (tx, ty): rows ty*4+i, columns tx+16j

constexpr size_t kDqSmem = (2 * kB * kD + 2 * kB * kPad + kB * kB + 2 * kB) * sizeof(float);
constexpr size_t kDkvSmem =
    (2 * kB * kD + 2 * kB * kPad + 2 * kB * kB + 2 * kB) * sizeof(float);

// Rows [row0, row0 + kB) of one head of a [*, S, H, kD] tensor (row stride
// `stride`, `base` at the head's first element) into dst [kB][ld]; rows at
// or past `rows` load as zeros.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ base,
                                          int64_t stride, int row0, int rows) {
  for (int i = threadIdx.x; i < kB * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    dst[r * ld + c] = row0 + r < rows ? base[(int64_t)(row0 + r) * stride + c] : 0.f;
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

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, const int* __restrict__ kv_len,
                    const int* __restrict__ q_off, int Sq, int Skv, int Hq, int Hkv, float scale,
                    int causal) {
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
  const float* kb = k + (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;
  const float* vb = v + (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;

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

  float* dqb = dq + qbase;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) dqb[(int64_t)(q0 + r) * q_stride + tx + 16 * c] = acc[i][c];
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
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

  float* dkb = dk + kvbase;
  float* dvb = dv + kvbase;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (k0 + r >= Skv) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int64_t off = (int64_t)(k0 + r) * kv_stride + tx + 16 * c;
      dkb[off] = adk[i][c];
      dvb[off] = adv[i][c];
    }
  }
}

// --------------------------------------------------------------- bfloat16
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows each
constexpr int kLd = kD + 8;       // bf16 row stride in shared memory: 272 bytes
constexpr int kStages = 3;        // ring of streamed tiles
constexpr int kDqRows = 64;       // B10: q rows per block
constexpr int kDqKeys = 32;       // B10: keys per streamed tile
constexpr int kDkvKeys = 64;      // B11: keys per block
constexpr int kDkvRows = 32;      // B11: q rows per streamed tile

constexpr size_t kDqMmaSmem = (2 * kDqRows + 2 * kStages * kDqKeys) * kLd * sizeof(bf16);
constexpr size_t kDkvMmaSmem = (2 * kDkvKeys + 2 * kStages * kDkvRows) * kLd * sizeof(bf16) +
                               2 * kStages * kDkvRows * sizeof(float);

// Rows [row0, row0 + R) of one head (row stride `stride`, `base` at the
// head's first element) into dst [R][kLd] by cp.async, 16 bytes a thread;
// rows at or past `rows` are zero-filled.
template <int R>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* __restrict__ base,
                                                int64_t stride, int row0, int rows) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks per row
  static_assert(R * kChunks % kMmaThreads == 0, "tile must split evenly into chunks");
#pragma unroll
  for (int i = 0; i < R * kChunks / kMmaThreads; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < rows;
    const bf16* src = ok ? base + (int64_t)(row0 + r) * stride + col : base;
    cp_async16(smem_addr(dst + r * kLd + col), src, ok ? 16 : 0);
  }
}

// ldmatrix row addresses of `lane` into a [rows][kLd] tile:
// the A fragment of rows m0..m0+15 at k0..k0+15 of a [m][k] tile;
__device__ __forceinline__ uint32_t a_addr(const bf16* tile, int m0, int k0, int lane) {
  return smem_addr(tile + (m0 + (lane & 15)) * kLd + k0 + (lane >> 4) * 8);
}
// the B fragments of columns n0..n0+7 (r0, r1) and n0+8..n0+15 (r2, r3) at
// k0..k0+15 of a [n][k] tile;
__device__ __forceinline__ uint32_t bt_addr(const bf16* tile, int n0, int k0, int lane) {
  return smem_addr(tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * kLd + k0 + ((lane >> 3) & 1) * 8);
}
// the same from a [k][n] tile, for ldmatrix.trans.
__device__ __forceinline__ uint32_t b_addr_trans(const bf16* tile, int k0, int n0, int lane) {
  return smem_addr(tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd + n0 + (lane >> 4) * 8);
}

__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, const int* __restrict__ kv_len,
                        const int* __restrict__ q_off, int Sq, int Skv, int Hq, int Hkv,
                        float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kDqRows][kLd]
  bf16* Os = Qs + kDqRows * kLd;                 // dO
  bf16* Ks = Os + kDqRows * kLd;                 // [kStages][kDqKeys][kLd]
  bf16* Vs = Ks + kStages * kDqKeys * kLd;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // the longest causal walks first
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int klen = min(kv_len[b], Skv);
  const int qoff = q_off[b];
  const int64_t q_stride = (int64_t)Hq * kD, kv_stride = (int64_t)Hkv * kD;
  const int64_t qbase = (int64_t)b * Sq * q_stride + (int64_t)h * kD;
  const int64_t kvbase = (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;

  // key tiles up to the block's causal limit
  int kend = klen;
  if (causal) kend = min(kend, qoff + min(q0 + kDqRows, Sq));
  const int ntiles = kend > 0 ? (kend + kDqKeys - 1) / kDqKeys : 0;
  auto load_kv = [&](int j) {
    if (j < ntiles) {
      const int off = (j % kStages) * kDqKeys * kLd;
      load_rows_async<kDqKeys>(Ks + off, k + kvbase, kv_stride, j * kDqKeys, klen);
      load_rows_async<kDqKeys>(Vs + off, v + kvbase, kv_stride, j * kDqKeys, klen);
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };
  load_rows_async<kDqRows>(Qs, q + qbase, q_stride, q0, Sq);
  load_rows_async<kDqRows>(Os, dout + qbase, q_stride, q0, Sq);
  cp_async_commit();
  load_kv(0);
  load_kv(1);

  // this thread's rows r0 and r1 = r0 + 8 of the warp's 16; lse in log2
  // units; rows past Sq compute garbage that is never stored
  const int wq = q0 + warp * 16;
  const int r0 = wq + g, r1 = r0 + 8;
  const int64_t srow = (int64_t)bh * Sq;
  const float l0 = r0 < Sq ? lse[srow + r0] * kLog2e : 0.f;
  const float l1 = r1 < Sq ? lse[srow + r1] * kLog2e : 0.f;
  const float d0 = r0 < Sq ? delta[srow + r0] : 0.f;
  const float d1 = r1 < Sq ? delta[srow + r1] : 0.f;
  const float scale_log2 = scale * kLog2e;

  cp_async_wait<2>();  // q and dO have landed
  __syncthreads();
  uint32_t qf[kD / 16][4], of[kD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    ldmatrix_x4(qf[ks], a_addr(Qs, warp * 16, ks * 16, lane));
    ldmatrix_x4(of[ks], a_addr(Os, warp * 16, ks * 16, lane));
  }
  float acc[kD / 8][4] = {};

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();     // for every thread, and tile j - 1's stage is free
    load_kv(j + 2);
    const bf16* Kt = Ks + (j % kStages) * kDqKeys * kLd;
    const bf16* Vt = Vs + (j % kStages) * kDqKeys * kLd;
    const int k0 = j * kDqKeys;

    // s = q k^T and dp = dO v^T: k and v [key][d] are [n][k] tiles
    float s[kDqKeys / 8][4] = {}, dp[kDqKeys / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
#pragma unroll
      for (int n = 0; n < kDqKeys; n += 16) {
        uint32_t f[4];
        ldmatrix_x4(f, bt_addr(Kt, n, ks * 16, lane));
        mma_bf16(s[n / 8], qf[ks], f[0], f[1]);
        mma_bf16(s[n / 8 + 1], qf[ks], f[2], f[3]);
        ldmatrix_x4(f, bt_addr(Vt, n, ks * 16, lane));
        mma_bf16(dp[n / 8], of[ks], f[0], f[1]);
        mma_bf16(dp[n / 8 + 1], of[ks], f[2], f[3]);
      }

    // ds = p (dp - delta) scale in bf16 A fragments; element masks only
    // where the tile crosses kv_len or the warp's causal diagonal (a row
    // without keys always does, so its lse of -inf never reaches a p)
    const bool edge = k0 + kDqKeys > klen || (causal && k0 + kDqKeys - 1 > qoff + wq);
    uint32_t dsf[kDqKeys / 16][4];
#pragma unroll
    for (int nt = 0; nt < kDqKeys / 8; ++nt) {
      float x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool hi = c >= 2;
        float p = exp2f(s[nt][c] * scale_log2 - (hi ? l1 : l0));
        if (edge) {
          const int key = k0 + nt * 8 + 2 * t + (c & 1);
          if (key >= klen || (causal && key > qoff + (hi ? r1 : r0))) p = 0.f;
        }
        x[c] = p * (dp[nt][c] - (hi ? d1 : d0)) * scale;
      }
      dsf[nt / 2][(nt & 1) * 2] = pack_bf16(x[0], x[1]);
      dsf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
    }

    // dq += ds k: k [key][d] is a [k][n] tile
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk)
#pragma unroll
      for (int n = 0; n < kD; n += 16) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, b_addr_trans(Kt, kk * 16, n, lane));
        mma_bf16(acc[n / 8], dsf[kk], f[0], f[1]);
        mma_bf16(acc[n / 8 + 1], dsf[kk], f[2], f[3]);
      }
  }
  cp_async_wait<0>();

  bf16* dqb = dq + qbase;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + (int64_t)r0 * q_stride + col) =
          pack_bf16(acc[nt][0], acc[nt][1]);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + (int64_t)r1 * q_stride + col) =
          pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         const int* __restrict__ kv_len, const int* __restrict__ q_off, int Sq,
                         int Skv, int Hq, int Hkv, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kDkvKeys][kLd]
  bf16* Vs = Ks + kDkvKeys * kLd;
  bf16* Qs = Vs + kDkvKeys * kLd;                // [kStages][kDkvRows][kLd]
  bf16* Os = Qs + kStages * kDkvRows * kLd;      // dO
  float* Ls = reinterpret_cast<float*>(Os + kStages * kDkvRows * kLd);  // lse [kStages][kDkvRows]
  float* Ds = Ls + kStages * kDkvRows;                                  // delta

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kDkvKeys;
  const int b = bkv / Hkv, hk = bkv % Hkv, rep = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int klen = min(kv_len[b], Skv);
  const int qoff = q_off[b];
  const int64_t q_stride = (int64_t)Hq * kD, kv_stride = (int64_t)Hkv * kD;
  const int64_t kvbase = (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;

  // the walk: for each of the rep q heads, the q tiles from the first one
  // with a row that sees key k0 (row k0 - q_offset on, when causal); none
  // when the whole tile lies at or past kv_len
  const int nq = (Sq + kDkvRows - 1) / kDkvRows;
  int qstart = 0;
  if (causal) {
    const int first = k0 - qoff;
    qstart = first >= Sq ? nq : max(first, 0) / kDkvRows;
  }
  const int per_head = k0 < klen ? nq - qstart : 0;
  const int nwalk = rep * per_head;
  auto load_q = [&](int it) {
    if (it < nwalk) {
      const int h = hk * rep + it / per_head;
      const int qr = (qstart + it % per_head) * kDkvRows;
      const int st = it % kStages;
      const int64_t qbase = (int64_t)b * Sq * q_stride + (int64_t)h * kD;
      load_rows_async<kDkvRows>(Qs + st * kDkvRows * kLd, q + qbase, q_stride, qr, Sq);
      load_rows_async<kDkvRows>(Os + st * kDkvRows * kLd, dout + qbase, q_stride, qr, Sq);
      if (threadIdx.x < 2 * kDkvRows) {
        const int i = threadIdx.x % kDkvRows;
        const bool is_lse = threadIdx.x < kDkvRows, ok = qr + i < Sq;
        const float* src = (is_lse ? lse : delta) + ((int64_t)b * Hq + h) * Sq;
        float* dst = (is_lse ? Ls : Ds) + st * kDkvRows + i;
        cp_async4(smem_addr(dst), ok ? src + qr + i : src, ok ? 4 : 0);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };
  if (nwalk > 0) {
    load_rows_async<kDkvKeys>(Ks, k + kvbase, kv_stride, k0, klen);
    load_rows_async<kDkvKeys>(Vs, v + kvbase, kv_stride, k0, klen);
  }
  cp_async_commit();
  load_q(0);
  load_q(1);

  const int kw = k0 + warp * 16;  // the warp's first key
  const float scale_log2 = scale * kLog2e;
  float adk[kD / 8][4] = {}, adv[kD / 8][4] = {};

  for (int it = 0; it < nwalk; ++it) {
    cp_async_wait<1>();  // k, v and q tile `it` have landed
    __syncthreads();     // for every thread, and tile it - 1's stage is free
    load_q(it + 2);
    const int st = it % kStages;
    const bf16* Qt = Qs + st * kDkvRows * kLd;
    const bf16* Ot = Os + st * kDkvRows * kLd;
    const float* Lt = Ls + st * kDkvRows;
    const float* Dt = Ds + st * kDkvRows;
    const int q0 = (qstart + it % per_head) * kDkvRows;

    // s^T = k q^T and dp^T = v dO^T: the warp's 16 keys against the tile's
    // q rows; q and dO [q][d] are [n][k] tiles
    float s[kDkvRows / 8][4] = {}, dp[kDkvRows / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      uint32_t kf[4], vf[4];
      ldmatrix_x4(kf, a_addr(Ks, warp * 16, ks * 16, lane));
      ldmatrix_x4(vf, a_addr(Vs, warp * 16, ks * 16, lane));
#pragma unroll
      for (int n = 0; n < kDkvRows; n += 16) {
        uint32_t f[4];
        ldmatrix_x4(f, bt_addr(Qt, n, ks * 16, lane));
        mma_bf16(s[n / 8], kf, f[0], f[1]);
        mma_bf16(s[n / 8 + 1], kf, f[2], f[3]);
        ldmatrix_x4(f, bt_addr(Ot, n, ks * 16, lane));
        mma_bf16(dp[n / 8], vf, f[0], f[1]);
        mma_bf16(dp[n / 8 + 1], vf, f[2], f[3]);
      }
    }

    // p^T and ds^T in bf16 A fragments; element masks only where the tile
    // crosses kv_len or the causal diagonal
    const bool edge = kw + 16 > klen || (causal && kw + 15 > qoff + q0);
    uint32_t pf[kDkvRows / 16][4], dsf[kDkvRows / 16][4];
#pragma unroll
    for (int nt = 0; nt < kDkvRows / 8; ++nt) {
      float p[4], x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = nt * 8 + 2 * t + (c & 1);
        p[c] = exp2f(s[nt][c] * scale_log2 - Lt[col] * kLog2e);
        if (edge) {
          const int key = kw + g + (c >> 1) * 8;
          if (key >= klen || (causal && key > qoff + q0 + col)) p[c] = 0.f;
        }
        x[c] = p[c] * (dp[nt][c] - Dt[col]) * scale;
      }
      pf[nt / 2][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsf[nt / 2][(nt & 1) * 2] = pack_bf16(x[0], x[1]);
      dsf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
    }

    // dv += p^T dO and dk += ds^T q: dO and q [q][d] are [k][n] tiles
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk)
#pragma unroll
      for (int n = 0; n < kD; n += 16) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, b_addr_trans(Ot, kk * 16, n, lane));
        mma_bf16(adv[n / 8], pf[kk], f[0], f[1]);
        mma_bf16(adv[n / 8 + 1], pf[kk], f[2], f[3]);
        ldmatrix_x4_trans(f, b_addr_trans(Qt, kk * 16, n, lane));
        mma_bf16(adk[n / 8], dsf[kk], f[0], f[1]);
        mma_bf16(adk[n / 8 + 1], dsf[kk], f[2], f[3]);
      }
  }
  cp_async_wait<0>();

  bf16* dkb = dk + kvbase;
  bf16* dvb = dv + kvbase;
  const int kr0 = kw + g, kr1 = kr0 + 8;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (kr0 < Skv) {
      const int64_t off = (int64_t)kr0 * kv_stride + col;
      *reinterpret_cast<uint32_t*>(dkb + off) = pack_bf16(adk[nt][0], adk[nt][1]);
      *reinterpret_cast<uint32_t*>(dvb + off) = pack_bf16(adv[nt][0], adv[nt][1]);
    }
    if (kr1 < Skv) {
      const int64_t off = (int64_t)kr1 * kv_stride + col;
      *reinterpret_cast<uint32_t*>(dkb + off) = pack_bf16(adk[nt][2], adk[nt][3]);
      *reinterpret_cast<uint32_t*>(dvb + off) = pack_bf16(adv[nt][2], adv[nt][3]);
    }
  }
}

int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, const int* kv_len, const int* q_off, int B, int Sq,
              int Skv, int Hq, int Hkv, float scale, int causal, int dtype,
              cudaStream_t stream) {
  if (dtype == kBFloat16) {  // cp.async moves 16-byte chunks, outputs go as bf16 pairs
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dq)))
      return (int)cudaErrorMisalignedAddress;
    cudaFuncSetAttribute(flash_bwd_dq_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)kDqMmaSmem);
    dim3 grid(B * Hq, (Sq + kDqRows - 1) / kDqRows);
    flash_bwd_dq_mma_kernel<<<grid, kMmaThreads, kDqMmaSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), kv_len, q_off, Sq,
        Skv, Hq, Hkv, scale, causal);
  } else {
    cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)kDqSmem);
    dim3 grid((Sq + kB - 1) / kB, B * Hq);
    flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dq), kv_len, q_off, Sq, Skv, Hq, Hkv, scale, causal);
  }
  return (int)cudaGetLastError();
}

int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, const int* kv_len, const int* q_off,
               int B, int Sq, int Skv, int Hq, int Hkv, float scale, int causal, int dtype,
               cudaStream_t stream) {
  if (dtype == kBFloat16) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dk) &&
          aligned16(dv)))
      return (int)cudaErrorMisalignedAddress;
    cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)kDkvMmaSmem);
    dim3 grid(B * Hkv, (Skv + kDkvKeys - 1) / kDkvKeys);
    flash_bwd_dkv_mma_kernel<<<grid, kMmaThreads, kDkvMmaSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), kv_len, q_off, Sq, Skv, Hq, Hkv, scale, causal);
  } else {
    cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)kDkvSmem);
    dim3 grid((Skv + kB - 1) / kB, B * Hkv);
    flash_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), kv_len, q_off, Sq, Skv, Hq, Hkv,
        scale, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vita

// q/dout/dq [B, Sq, Hq, 128], k/v [B, Skv, Hkv, 128] in one dtype (bf16:
// tensor-core kernel, float32: FMA kernel); lse and delta [B, Hq, Sq]
// float32; kv_len/q_off [B] int32 on the device. Return the CUDA error code
// of the launch.
extern "C" int vita_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq,
                                 const int* kv_len, const int* q_off, int B, int Sq, int Skv,
                                 int Hq, int Hkv, float scale, int causal, int dtype,
                                 void* stream) {
  return vita::launch_dq(q, k, v, dout, lse, delta, dq, kv_len, q_off, B, Sq, Skv, Hq, Hkv,
                         scale, causal, dtype, static_cast<cudaStream_t>(stream));
}

// dk/dv [B, Skv, Hkv, 128] in k's dtype; the rest as vita_flash_bwd_dq.
extern "C" int vita_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dk, void* dv,
                                  const int* kv_len, const int* q_off, int B, int Sq, int Skv,
                                  int Hq, int Hkv, float scale, int causal, int dtype,
                                  void* stream) {
  return vita::launch_dkv(q, k, v, dout, lse, delta, dk, dv, kv_len, q_off, B, Sq, Skv, Hq, Hkv,
                          scale, causal, dtype, static_cast<cudaStream_t>(stream));
}

// Resources of the bf16 tensor-core kernel `which` (0: B10, 1: B11) on the
// current device: out = {registers a thread, local (spill) bytes a thread,
// shared bytes a block, resident blocks per SM}. Returns a CUDA error code.
extern "C" int vita_flash_bwd_mma_info(int which, int* out) {
  const void* fn = which == 0 ? reinterpret_cast<const void*>(vita::flash_bwd_dq_mma_kernel)
                              : reinterpret_cast<const void*>(vita::flash_bwd_dkv_mma_kernel);
  return vita::kernel_info(fn, vita::kMmaThreads,
                           (int)(which == 0 ? vita::kDqMmaSmem : vita::kDkvMmaSmem), out);
}
