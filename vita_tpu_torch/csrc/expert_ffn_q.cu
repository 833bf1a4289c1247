// The quantized selected-expert FFN of MoE decode on tensor cores, bf16
// activations over int4 or int8 expert weights with per-channel scales.
//
// Replaces vita_tpu/ops/moe_decode.py::_gather_ffn_kernel_q (B6: one row
// per (token, k) pair over int8 experts), ::_gather_ffn_kernel_q4 (B7: the
// same over int4), ::_masked_ffn_kernel_q (B8a: one row per unique active
// expert with all T tokens, int8) and ::_masked_ffn_kernel_q4 (B8b: the
// same over int4):
//   gate = (x @ w_gate) * s_gate,  up = (x @ w_up) * s_up,
//   h = bf16(silu(gate) * up),  y = bf16((h @ w_down) * s_down),
// over the exact integer weights, with float32 sums and one float32 scale
// per output column multiplying after the dot. float32 activations and
// grouped int4 scales keep the SIMT kernel of expert_ffn.cu.
//
// What bounds it on the H100: bytes. An expert is 3 x 4096 x 14336 weights,
// 88 MB in int4 and 176 MB in int8; 1-16 tokens make at most 32-64 FLOP per
// weight byte, far under the card's ~295, so the kernel has to stream each
// distinct expert's weights once at a good share of 3.35 TB/s, with few
// instructions per byte.
//
// Design (one template, the weight format Bits = 4 or 8 its parameter):
//  - A row is one expert id (flat layer * E + e into the stacked weights)
//    with nt token slots (a token index, or -1 for an empty slot). The
//    gather schedule passes one row per (token, k) pair with one slot; the
//    masked schedule one row per entry of the active-expert plan with all
//    T tokens.
//  - mma.sync m16n8k16 bf16 with float32 sums, the WEIGHTS as the A operand
//    (16 output columns x 16 k) and the token slots as B (one n8 tile for
//    up to 8 slots, two for 16). Thread (g, t) of a warp reads 32-bit
//    words (4 adjacent byte columns) at the k rows 2t, 2t+1, 2t+8, 2t+9 it
//    owns; in m-tile p the fragment's row g is byte column 4g + 2p and row
//    g + 8 column 4g + 2p + 1, a free permutation that only the epilogue's
//    column map has to undo. One word load feeds two m-tiles.
//  - Dequantization in registers, exact for every value: a byte permute
//    pairs two k rows' bytes. An int4 nibble n becomes the bf16 128 + (n ^
//    8) by one logic op, minus 136 as bf16x2. An int8 byte b (two's
//    complement, sign s, low bits l) becomes the bf16 128 + l (l set into
//    the mantissa of 128) minus the bf16 128 + 128 s (s set into the lowest
//    exponent bit: 128 or 256): l - 128 s = b, every operand exact in bf16.
//  - int4 packs two values a byte. gate/up [rows, D/2, F] pack the
//    reduction axis: the low nibble is row r, the high one row r + D/2, so
//    one word serves the k-steps at r and r + D/2 against two B fragments
//    of x. down [rows, F, D/2] packs the output axis: the low nibble is
//    output c, the high one c + D/2, so one word serves two sets of
//    accumulators. int8 gate/up [rows, D, F] and down [rows, F, D] hold one
//    value a byte with the same word addressing; a down word serves one set
//    of accumulators.
//  - Bytes in flight: each block streams its weight tile, with x's (or h's)
//    k-slices beside it, through a cp.async ring of kUpStages/kDownStages
//    stages of 64 k rows in shared memory; 144-byte rows put the four rows a
//    thread reads in different banks. Two blocks fit on an SM.
//  - Enough blocks: up takes one block per (128 F columns, row): 112 per
//    row at F 14336. Down has only 16 (int4) or 32 (int8) tiles of 128 byte
//    columns per row, so F is split in pieces of kDownSplitRows rows (7 at F
//    14336); each block writes float32 partial sums and a small kernel adds
//    them in a fixed order, scales by s_down and rounds to bf16: no atomics,
//    so two launches give the same bits.
//  - Padding rows of the masked schedule's plan (padded, and eids[r] ==
//    eids[r - 1]: the plan repeats its last id) read no weights; the
//    finishing kernel writes zeros for them. Gather rows may repeat an
//    expert on adjacent rows (pairs sorted by expert) and are all computed.
//  - Ragged edges (k past the range, columns past the width, empty token
//    slots) are zero-filled in shared memory; rows whose stride is no
//    multiple of 16 bytes (narrow widths only) are staged by plain loads
//    instead of cp.async.
#include "common.cuh"

// 1: gate/up's last k-step of 16 (packed) rows dropped; 2: the last F
// split's partial of down skipped. Faults planted on purpose, for the check
// that the tolerance of chip_smoke.py catches them; 0 in every real build.
#ifndef VITA_EXPERT_Q_FAULT
#define VITA_EXPERT_Q_FAULT 0
#endif

namespace vita {
namespace {

constexpr int kUpStages = 3;          // ring stages of the up kernel
constexpr int kDownStages = 4;        // ring stages of the down kernel
constexpr int kDownSplitRows = 2048;  // F rows per down block
constexpr int kRows = 64;             // k rows per stage
constexpr int kCols = 128;            // byte columns per block
constexpr int kStride = 144;          // bytes per staged row (128 + 16 pad)
constexpr int kWarps = 8;             // 4 column groups x 2 k-step parities
constexpr int kThreads = 32 * kWarps;

// Values a weight byte holds: 2 for int4, 1 for int8.
template <int Bits>
__host__ __device__ constexpr int per_byte() { return Bits == 4 ? 2 : 1; }

// Shared bytes of one stage: M weight matrices of kRows x kCols bytes and
// XS slices of NT8 * 8 token rows of kRows bf16 values.
template <int M, int XS, int NT8>
__host__ __device__ constexpr int stage_bytes() {
  return (M * kRows + XS * NT8 * 8) * kStride;
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two nibbles (bits 0-3 of each 16-bit half of u) as a bf16 pair of their
// signed values: 128 + (n ^ 8) by setting the exponent of 128, minus 136.
__device__ __forceinline__ uint32_t dq4(uint32_t u) {
  uint32_t v;  // (u & 0x000F000F) ^ 0x43084308 as one instruction
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(v) : "r"(u), "n"(0x000F000F), "r"(0x43084308));
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Two bytes (bits 0-7 of each 16-bit half of u) as a bf16 pair of their
// signed values: 128 + (b & 0x7F) minus 128 + (b & 0x80), i.e. 128 or 256.
__device__ __forceinline__ uint32_t dq8(uint32_t u) {
  const uint32_t v = (u & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (u & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&r);
}

// The A fragments of m-tile p from the words at k rows 2t, 2t+1 (w0, w1)
// and 2t+8, 2t+9 (w2, w3). int4: lo[] from the low nibbles, hi[] the high
// ones; int8: lo[] only.
template <int Bits>
__device__ __forceinline__ void a_frags(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                        int p, uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  const uint32_t sel = p == 0 ? 0x5410u : 0x7632u;  // bytes 2p, 2p+1 of each row
  const uint32_t v01 = __byte_perm(w0, w1, sel);
  const uint32_t v23 = __byte_perm(w2, w3, sel);
  if constexpr (Bits == 4) {
    lo[0] = dq4(v01);  // row g (column 4g + 2p), k 2t, 2t+1
    lo[1] = dq4(v01 >> 8);  // row g + 8 (column 4g + 2p + 1)
    lo[2] = dq4(v23);
    lo[3] = dq4(v23 >> 8);
    hi[0] = dq4(v01 >> 4);
    hi[1] = dq4(v01 >> 12);
    hi[2] = dq4(v23 >> 4);
    hi[3] = dq4(v23 >> 12);
  } else {
    lo[0] = dq8(v01);
    lo[1] = dq8(v01 >> 8);
    lo[2] = dq8(v23);
    lo[3] = dq8(v23 >> 8);
  }
}

__device__ __forceinline__ bool padding_row(const int* eids, int r, int padded) {
  return padded && r > 0 && eids[r] == eids[r - 1];
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// Stage one k-slice [k, k + kRows) of the block into shared memory at dst:
// M weight matrices (row stride `ld` bytes, columns c0 .. c0 + kCols of
// width `width`) and XS activation slices of the rows arow[s] (bf16; null:
// a zero row), slice i starting at column i * act_half + k. Rows past k_end
// are zero. vec: every row start and column offset is 16-byte aligned, so
// whole 16-byte chunks go by cp.async.
template <int M, int XS, int NT8>
__device__ __forceinline__ void load_stage(uint8_t* dst, const int8_t* const (&w)[M], int ld,
                                           int width, int c0,
                                           const __nv_bfloat16* const* arow, int act_half,
                                           int k, int k_end, bool vec) {
  constexpr int kW = M * kRows * (kCols / 16);        // weight chunks
  constexpr int kX = XS * NT8 * 8 * (kRows * 2 / 16);  // activation chunks
  constexpr int kMat = kRows * (kCols / 16);             // chunks of one matrix
  static_assert(kMat % kThreads == 0, "whole weight chunks per thread");
  const int tid = threadIdx.x;
  if (vec) {
    // Each thread's chunks sit at places fixed by tid and the unrolled j, so
    // they are computed once, not once per stage.
#pragma unroll
    for (int j = 0; j < kW / kThreads; ++j) {
      const int m = j * kThreads / kMat, q = j * kThreads % kMat + tid;
      const int r = q / (kCols / 16), c = q % (kCols / 16) * 16;
      const bool ok = k + r < k_end && c0 + c < width;
      cp_async16(smem_addr(dst + (m * kRows + r) * kStride + c),
                 ok ? static_cast<const void*>(w[m] + (int64_t)(k + r) * ld + c0 + c) : w[0],
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < (kX + kThreads - 1) / kThreads; ++j) {
      const int q = j * kThreads + tid, per = kRows * 2 / 16;
      if (kX % kThreads != 0 && q >= kX) break;
      const int s = q / (NT8 * 8 * per), tok = q / per % (NT8 * 8), e = q % per * 8;
      // a chunk is 8 values; k_end is a multiple of 8 on this path
      const __nv_bfloat16* src = arow[tok];
      const bool ok = src != nullptr && k + e < k_end;
      cp_async16(smem_addr(dst + (M * kRows + s * NT8 * 8 + tok) * kStride + 2 * e),
                 ok ? static_cast<const void*>(src + s * act_half + k + e) : w[0],
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m)
      for (int i = tid; i < kRows * kCols; i += kThreads) {
        const int r = i / kCols, c = i % kCols;
        const bool ok = k + r < k_end && c0 + c < width;
        dst[(m * kRows + r) * kStride + c] = ok ? w[m][(int64_t)(k + r) * ld + c0 + c] : 0;
      }
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dst + M * kRows * kStride);
    for (int i = tid; i < XS * NT8 * 8 * kRows; i += kThreads) {
      const int s = i / (NT8 * 8 * kRows), tok = (i / kRows) % (NT8 * 8), e = i % kRows;
      const bool ok = arow[tok] != nullptr && k + e < k_end;
      xs[(s * NT8 * 8 + tok) * (kStride / 2) + e] =
          ok ? arow[tok][s * act_half + k + e] : __float2bfloat16(0.f);
    }
  }
}

// The ring walk shared by both kernels: stages of kRows k rows from k_begin
// to k_end, each consumed by step(stage pointer, kk) for the warp's two
// k16-steps kk of it.
template <int M, int XS, int NT8, int S, typename Step>
__device__ __forceinline__ void ring(uint8_t* smem, const int8_t* const (&w)[M], int ld,
                                     int width, int c0, const __nv_bfloat16* const* arow,
                                     int act_half, int k_begin, int k_end, bool vec, Step step) {
  constexpr int kStage = stage_bytes<M, XS, NT8>();
  const int n = (k_end - k_begin + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n)
      load_stage<M, XS, NT8>(smem + s * kStage, w, ld, width, c0, arow, act_half,
                             k_begin + s * kRows, k_end, vec);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int next = s + S - 1;
    if (next < n)
      load_stage<M, XS, NT8>(smem + (next % S) * kStage, w, ld, width, c0, arow, act_half,
                             k_begin + next * kRows, k_end, vec);
    cp_async_commit();
    const uint8_t* st = smem + (s % S) * kStage;
    step(st, warp >> 2);
    step(st, (warp >> 2) + 2);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The B fragments of NT8 token tiles at k16-step kk of an activation slice
// (bf16 rows of kStride bytes).
template <int NT8>
__device__ __forceinline__ void b_frags(const uint8_t* xs, int kk, uint32_t (&b)[NT8][2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
    const uint8_t* p = xs + (n * 8 + g) * kStride + (kk * 16 + 2 * t) * 2;
    b[n][0] = lds32(p);
    b[n][1] = lds32(p + 16);
  }
}

// The four words of thread (g, t) at k16-step kk of a staged weight matrix,
// in column group cg.
__device__ __forceinline__ void w_words(const uint8_t* wm, int kk, int cg, uint32_t (&w)[4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint8_t* p = wm + (kk * 16 + 2 * t) * kStride + cg * 32 + 4 * g;
  w[0] = lds32(p);
  w[1] = lds32(p + kStride);
  w[2] = lds32(p + 8 * kStride);
  w[3] = lds32(p + 9 * kStride);
}

// Sums of the warps of parity 1 into those of parity 0 (same column group),
// through shared memory, in a fixed order.
template <int H, int NT8>
__device__ __forceinline__ void pair_reduce(float* buf, float (&acc)[H][2][NT8][4]) {
  constexpr int kPer = H * 2 * NT8 * 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* mine = buf + ((warp & 3) * 32 + lane) * kPer;
#pragma unroll
  for (int m = 0; m < H; ++m)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (warp >= 4) mine[((m * 2 + p) * NT8 + n) * 4 + i] = acc[m][p][n][i];
  __syncthreads();
#pragma unroll
  for (int m = 0; m < H; ++m)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (warp < 4) acc[m][p][n][i] += mine[((m * 2 + p) * NT8 + n) * 4 + i];
}

// h [R, nt, F] = bf16(silu(x Wg * sg) * (x Wu * su)) for one row
// (blockIdx.y) and kCols columns of F (blockIdx.x).
template <int Bits, int NT8>
__global__ void __launch_bounds__(kThreads, 2)
q_up_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ eids,
            const int* __restrict__ toks, const int8_t* __restrict__ w_gate,
            const int8_t* __restrict__ w_up, const float* __restrict__ s_gate,
            const float* __restrict__ s_up, __nv_bfloat16* __restrict__ h, int nt, int D, int F,
            int padded, int vec) {
  constexpr int kPb = per_byte<Bits>();
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ const __nv_bfloat16* arow[NT8 * 8];
  const int r = blockIdx.y;
  if (padding_row(eids, r, padded)) return;
  const int64_t e = eids[r];
  const int K = D / kPb, c0 = blockIdx.x * kCols;  // K: staged (packed) k rows
  if (threadIdx.x < NT8 * 8) {
    const int s = threadIdx.x;
    const int tok = s < nt ? toks[(int64_t)r * nt + s] : -1;
    arow[s] = tok >= 0 ? x + (int64_t)tok * D : nullptr;
  }
  __syncthreads();
  const int8_t* const w[2] = {w_gate + e * K * F, w_up + e * K * F};
  const int warp = threadIdx.x / 32, cg = warp & 3;

  float acc[2][2][NT8][4] = {};  // [gate/up][m-tile][token tile][C fragment]
  ring<2, kPb, NT8, kUpStages>(
      smem, w, F, F, c0, arow, K, 0, VITA_EXPERT_Q_FAULT == 1 ? K - 16 : K, vec,
      [&](const uint8_t* st, int kk) {
        uint32_t xb[kPb][NT8][2];  // int4: x at rows r (low nibbles) and r + D/2 (high)
#pragma unroll
        for (int i = 0; i < kPb; ++i)
          b_frags<NT8>(st + (2 * kRows + i * NT8 * 8) * kStride, kk, xb[i]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t wd[4];
          w_words(st + m * kRows * kStride, kk, cg, wd);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            uint32_t lo[4], hi[4];
            a_frags<Bits>(wd[0], wd[1], wd[2], wd[3], p, lo, hi);
#pragma unroll
            for (int n = 0; n < NT8; ++n) {
              mma_bf16(acc[m][p][n], lo, xb[0][n][0], xb[0][n][1]);
              if constexpr (Bits == 4)
                mma_bf16(acc[m][p][n], hi, xb[kPb - 1][n][0], xb[kPb - 1][n][1]);
            }
          }
        }
      });
  pair_reduce<2, NT8>(reinterpret_cast<float*>(smem), acc);
  if (warp >= 4) return;

  // C fragment: c0, c1 = (row g, slots 2t, 2t+1), c2, c3 = (row g + 8, the
  // same); m-tile p's row g is column 4g + 2p, row g + 8 column 4g + 2p + 1
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int f = c0 + cg * 32 + 4 * g;
  if (f >= F) return;  // F % 4 == 0: the four columns are all in or all out
  float sg[4], su[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sg[j] = s_gate[e * F + f + j];
    su[j] = s_up[e * F + f + j];
  }
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // slot 2t + i of tile n
      const int s = n * 8 + 2 * t + i;
      if (s >= nt) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = j / 2, c = (j % 2) * 2 + i;
        v[j] = silu(acc[0][p][n][c] * sg[j]) * (acc[1][p][n][c] * su[j]);
      }
      uint2 out = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      *reinterpret_cast<uint2*>(h + ((int64_t)r * nt + s) * F + f) = out;
    }
}

// Partial sums part [splits, R, nt, D] of h Wd over F rows
// [blockIdx.y * kDownSplitRows, +kDownSplitRows) for one row (blockIdx.z)
// and kCols byte columns (blockIdx.x): outputs c (and, int4, c + D/2).
template <int Bits, int NT8>
__global__ void __launch_bounds__(kThreads, 2)
q_down_kernel(const __nv_bfloat16* __restrict__ h, const int* __restrict__ eids,
              const int8_t* __restrict__ w_down, float* __restrict__ part, int nt, int D, int F,
              int padded, int vec) {
  constexpr int kPb = per_byte<Bits>();
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ const __nv_bfloat16* arow[NT8 * 8];
  const int r = blockIdx.z, R = gridDim.z;
  if (padding_row(eids, r, padded)) return;
  const int64_t e = eids[r];
  const int W = D / kPb, c0 = blockIdx.x * kCols;  // W: bytes of a down row
  const int k0 = blockIdx.y * kDownSplitRows, k1 = min(F, k0 + kDownSplitRows);
  if (threadIdx.x < NT8 * 8) {
    const int s = threadIdx.x;
    arow[s] = s < nt ? h + ((int64_t)r * nt + s) * F : nullptr;
  }
  __syncthreads();
  const int8_t* const w[1] = {w_down + e * F * W};
  const int warp = threadIdx.x / 32, cg = warp & 3;

  float acc[kPb][2][NT8][4] = {};  // [output half][m-tile][token tile][C fragment]
  ring<1, 1, NT8, kDownStages>(
      smem, w, W, W, c0, arow, 0, k0, k1, vec, [&](const uint8_t* st, int kk) {
        uint32_t hb[NT8][2];
        b_frags<NT8>(st + kRows * kStride, kk, hb);
        uint32_t wd[4];
        w_words(st, kk, cg, wd);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t lo[4], hi[4];
          a_frags<Bits>(wd[0], wd[1], wd[2], wd[3], p, lo, hi);
#pragma unroll
          for (int n = 0; n < NT8; ++n) {
            mma_bf16(acc[0][p][n], lo, hb[n][0], hb[n][1]);
            if constexpr (Bits == 4) mma_bf16(acc[kPb - 1][p][n], hi, hb[n][0], hb[n][1]);
          }
        }
      });
  pair_reduce<kPb, NT8>(reinterpret_cast<float*>(smem), acc);
  if (warp >= 4) return;

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int c = c0 + cg * 32 + 4 * g;  // byte column; W is even
  float* out = part + ((int64_t)blockIdx.y * R + r) * nt * D;
#pragma unroll
  for (int half = 0; half < kPb; ++half)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = n * 8 + 2 * t + i;
        if (s >= nt) continue;
        float* row = out + (int64_t)s * D + half * W;
        // columns c + j: j = 2p (row g of m-tile p) and 2p + 1 (row g + 8)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (c + 2 * p < W)
            *reinterpret_cast<float2*>(row + c + 2 * p) =
                make_float2(acc[half][p][n][i], acc[half][p][n][2 + i]);
      }
}

// y [R, nt, D] = bf16(s_down * sum over splits of part), in split order;
// zeros on padding rows.
__global__ void q_finish_kernel(const float* __restrict__ part, const int* __restrict__ eids,
                                const float* __restrict__ s_down, __nv_bfloat16* __restrict__ y,
                                int64_t n, int nt, int D, int splits, int padded) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / ((int64_t)nt * D)), d = (int)(i % D);
    float s = 0.f;
    if (!padding_row(eids, r, padded)) {
      for (int k = 0; k < splits - (VITA_EXPERT_Q_FAULT == 2); ++k) s += part[k * n + i];
      s *= s_down[(int64_t)eids[r] * D + d];
    }
    y[i] = __float2bfloat16(s);
  }
}

int down_splits(int F) { return (F + kDownSplitRows - 1) / kDownSplitRows; }

template <int Bits, int NT8>
int up_smem() { return kUpStages * stage_bytes<2, per_byte<Bits>(), NT8>(); }
template <int NT8>
int down_smem() { return kDownStages * stage_bytes<1, 1, NT8>(); }

template <int Bits, int NT8>
int launch(const void* x, const int* eids, const int* toks, const void* wg, const void* wu,
           const void* wd, const float* sg, const float* su, const float* sd, void* h,
           float* part, void* y, int R, int nt, int D, int F, int padded, cudaStream_t stream) {
  const int W = D / per_byte<Bits>();
  // 16-byte chunks need 16-byte aligned rows and column offsets everywhere
  // (W % 16 == 0 also aligns x's int4 half at D/2 and its int8 rows)
  const int vec = F % 16 == 0 && W % 16 == 0 && aligned16(x) && aligned16(wg) &&
                  aligned16(wu) && aligned16(wd) && aligned16(h);
  static bool attrs = false;
  if (!attrs) {
    cudaFuncSetAttribute(q_up_kernel<Bits, NT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         up_smem<Bits, NT8>());
    cudaFuncSetAttribute(q_down_kernel<Bits, NT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         down_smem<NT8>());
    attrs = true;
  }
  auto* hb = static_cast<__nv_bfloat16*>(h);
  q_up_kernel<Bits, NT8><<<dim3((F + kCols - 1) / kCols, R), kThreads, up_smem<Bits, NT8>(),
                           stream>>>(
      static_cast<const __nv_bfloat16*>(x), eids, toks, static_cast<const int8_t*>(wg),
      static_cast<const int8_t*>(wu), sg, su, hb, nt, D, F, padded, vec);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int splits = down_splits(F);
  q_down_kernel<Bits, NT8><<<dim3((W + kCols - 1) / kCols, splits, R), kThreads,
                             down_smem<NT8>(), stream>>>(
      hb, eids, static_cast<const int8_t*>(wd), part, nt, D, F, padded, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t n = (int64_t)R * nt * D;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  q_finish_kernel<<<blocks, 256, 0, stream>>>(part, eids, sd, static_cast<__nv_bfloat16*>(y), n,
                                              nt, D, splits, padded);
  return (int)cudaGetLastError();
}

template <int Bits>
int launch_bits(const void* x, const int* eids, const int* toks, const void* wg, const void* wu,
                const void* wd, const float* sg, const float* su, const float* sd, void* h,
                float* part, void* y, int R, int nt, int D, int F, int padded,
                cudaStream_t stream) {
  if (nt <= 8)
    return launch<Bits, 1>(x, eids, toks, wg, wu, wd, sg, su, sd, h, part, y, R, nt, D, F,
                           padded, stream);
  return launch<Bits, 2>(x, eids, toks, wg, wu, wd, sg, su, sd, h, part, y, R, nt, D, F, padded,
                         stream);
}

}  // namespace
}  // namespace vita

// Pieces of F a down block takes: the first dimension of the partial sums.
extern "C" int vita_expert_ffn_q_splits(int F) { return vita::down_splits(F); }

// x [T, D] bf16; eids [R] int32 flat expert ids; toks [R, nt] int32 token
// index per slot (-1: an empty slot, whose outputs are zero). bits 4:
// w_gate/w_up [E_rows, D/2, F] and w_down [E_rows, F, D/2] int4 packed by
// halves; bits 8: [E_rows, D, F] and [E_rows, F, D] int8. s_gate/s_up
// [E_rows, 1, F] and s_down [E_rows, 1, D] float32. Scratch h [R, nt, F]
// bf16 and part [splits, R, nt, D] float32; output y [R, nt, D] bf16. nt is
// 1, 2, 4, 8 or 16; D % 4 == 0 and F % 4 == 0. padded: a row whose id
// repeats the previous row's is a padding row (the masked schedule's plan):
// no weights are read and its outputs are zero. Returns the CUDA error code
// of the launches.
extern "C" int vita_expert_ffn_q(const void* x, const int* eids, const int* toks,
                                 const void* w_gate, const void* w_up, const void* w_down,
                                 const float* s_gate, const float* s_up, const float* s_down,
                                 void* h, float* part, void* y, int R, int nt, int D, int F,
                                 int bits, int padded, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((nt != 1 && nt != 2 && nt != 4 && nt != 8 && nt != 16) || D % 4 || F % 4)
    return (int)cudaErrorInvalidValue;
  if (bits == 4)
    return vita::launch_bits<4>(x, eids, toks, w_gate, w_up, w_down, s_gate, s_up, s_down, h,
                                part, y, R, nt, D, F, padded, s);
  if (bits == 8)
    return vita::launch_bits<8>(x, eids, toks, w_gate, w_up, w_down, s_gate, s_up, s_down, h,
                                part, y, R, nt, D, F, padded, s);
  return (int)cudaErrorInvalidValue;
}

// Resources of int4 (which 0-3) and int8 (4-7) kernels: up at up to 8 and
// 16 token slots, then down at 8 and 16; out as kernel_info.
extern "C" int vita_expert_ffn_q_info(int which, int* out) {
  using namespace vita;
  switch (which) {
    case 0: return kernel_info((const void*)q_up_kernel<4, 1>, kThreads, up_smem<4, 1>(), out);
    case 1: return kernel_info((const void*)q_up_kernel<4, 2>, kThreads, up_smem<4, 2>(), out);
    case 2: return kernel_info((const void*)q_down_kernel<4, 1>, kThreads, down_smem<1>(), out);
    case 3: return kernel_info((const void*)q_down_kernel<4, 2>, kThreads, down_smem<2>(), out);
    case 4: return kernel_info((const void*)q_up_kernel<8, 1>, kThreads, up_smem<8, 1>(), out);
    case 5: return kernel_info((const void*)q_up_kernel<8, 2>, kThreads, up_smem<8, 2>(), out);
    case 6: return kernel_info((const void*)q_down_kernel<8, 1>, kThreads, down_smem<1>(), out);
    case 7: return kernel_info((const void*)q_down_kernel<8, 2>, kThreads, down_smem<2>(), out);
    default: return (int)cudaErrorInvalidValue;
  }
}
