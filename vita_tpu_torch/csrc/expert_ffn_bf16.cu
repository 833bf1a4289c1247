// The bf16 selected-expert FFN of MoE decode on tensor cores.
//
// Replaces vita_tpu/ops/moe_decode.py::_gather_ffn_kernel (B3: one row per
// (token, k) pair) and ::_masked_ffn_kernel (B4: one row per unique active
// expert with all T tokens of the batch) for bf16 activations over bf16
// expert weights:
//   gate = x Wg, up = x Wu (float32 sums), h = bf16(silu(gate) * up),
//   y = bf16(h Wd) (float32 sums, rounded once).
// float32 activations keep the SIMT kernel of expert_ffn.cu.
//
// What bounds it on the H100: bytes. An expert is 3 x 4096 x 14336 bf16
// values, 352 MB; 1-16 tokens make 1-16 FLOP per weight byte, far under
// the card's ~295, so the kernel has to stream each distinct expert's
// weights once at a good share of 3.35 TB/s.
//
// Design (expert_ffn_q.cu's, without the dequantization):
//  - A row is one expert id (flat layer * E + e into the stacked weights)
//    with nt token slots (a token index, or -1 for an empty slot). The
//    gather schedule passes one row per (token, k) pair with one slot; the
//    masked schedule one row per entry of the active-expert plan with all
//    T tokens.
//  - mma.sync m16n8k16 bf16 with float32 sums, the WEIGHTS as the A
//    operand (16 output columns x 16 k) and the token slots as B (one n8
//    tile for up to 8 slots, two for 16), so at 1-8 slots no product runs
//    on a weight tile twice. The weights are k-major with output columns
//    contiguous ([rows, D, F], [rows, F, D]), so ldmatrix.trans of a staged
//    16 x 16 tile is the A fragment as it is.
//  - Each of the 8 warps of a block owns 16 of its 128 output columns and
//    walks the whole k range, so no partial sums meet inside a block.
//  - Bytes in flight: each block streams its weight tile, with the matching
//    k-slices of x (or h) beside it, through a cp.async ring of
//    kUpStages/kDownStages stages of kRows k rows in shared memory; rows of
//    272 bytes put the 8 rows an ldmatrix reads in different banks. The
//    weight copies ask L2 to prefetch 256 bytes (kL2Prefetch): with 3
//    stages of 64 rows that measured 2-4% faster at T 4-16 on an H100 than
//    4 stages of 32 rows without the hint, and the same at T 1
//    (chip_probe.py expert-ring).
//  - Enough blocks: up takes one block per (128 F columns, row): 112 per
//    row at F 14336. Down has only 32 tiles of 128 columns per row at D
//    4096 (64 blocks for B3 at T 1), so F is split in pieces of
//    kDownSplitRows rows; each block writes float32 partial sums and a small
//    kernel adds them in a fixed order and rounds to bf16: no atomics, so
//    two launches give the same bits.
//  - Padding rows of the masked schedule's plan (act[a] == act[a - 1]: the
//    plan repeats its last id) read no weights; the finishing kernel writes
//    zeros for them. Gather rows may repeat an expert on adjacent rows
//    (pairs sorted by expert) and are all computed.
//  - Ragged edges (k past the range, columns past the width, empty token
//    slots) are zero-filled in shared memory; rows whose stride is no
//    multiple of 16 bytes (narrow widths only) are staged by plain loads
//    instead of cp.async.
#include "common.cuh"

// 1: gate/up's last k-step of 16 rows dropped; 2: the last F split's
// partial of down skipped. Faults planted on purpose, for the check that
// the tolerance of chip_smoke.py catches them; 0 in every real build.
#ifndef VITA_EXPERT_FAULT
#define VITA_EXPERT_FAULT 0
#endif

namespace vita {
namespace {

constexpr int kUpStages = 3;          // ring stages of the up kernel
constexpr int kDownStages = 3;        // ring stages of the down kernel
constexpr int kRows = 64;             // k rows per stage
constexpr int kDownSplitRows = 2048;  // F rows per down block
constexpr int kCols = 128;            // output columns per block, 16 a warp
constexpr int kWarps = kCols / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kWStride = 2 * kCols + 16;  // bytes per staged weight row
constexpr int kXStride = 2 * kRows + 16;  // bytes per staged activation row
constexpr int kL2Prefetch = 256;  // L2 prefetch hint of the weight copies: 0, 128 or 256 bytes

// Shared bytes of one stage: M weight matrices of kRows x kCols values and
// NT8 * 8 activation rows of kRows values.
template <int M, int NT8>
__host__ __device__ constexpr int stage_bytes() {
  return M * kRows * kWStride + NT8 * 8 * kXStride;
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// cp_async16 with the L2 prefetch hint kL2Prefetch
__device__ __forceinline__ void cp_async16_w(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (kL2Prefetch == 256)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else if constexpr (kL2Prefetch == 128)
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    cp_async16(dst, src, src_bytes);
}

__device__ __forceinline__ bool padding_row(const int* eids, int r, int padded) {
  return padded && r > 0 && eids[r] == eids[r - 1];
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// Stage the k-slice [k, k + kRows) of the block into dst: M weight
// matrices (rows of `width` values, columns c0 .. c0 + kCols) and the
// activation rows arow[s] (k-indexed; null: a zero row). Rows past k_end
// and columns past the width are zero. vec: every row start and chunk is
// 16-byte aligned (width and k_end multiples of 8), so whole 16-byte chunks
// go by cp.async.
template <int M, int NT8>
__device__ __forceinline__ void load_stage(uint8_t* dst, const __nv_bfloat16* const (&w)[M],
                                           int width, int c0,
                                           const __nv_bfloat16* const* arow, int k, int k_end,
                                           bool vec) {
  constexpr int kRowChunks = kCols * 2 / 16;  // 16-byte chunks of a weight row
  constexpr int kMat = kRows * kRowChunks;
  constexpr int kXChunks = kRows * 2 / 16;  // of an activation row
  constexpr int kX = NT8 * 8 * kXChunks;
  static_assert(kMat % kThreads == 0 && kX <= kThreads, "whole chunks per thread");
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int j = 0; j < M * kMat / kThreads; ++j) {
      const int m = j * kThreads / kMat, q = j * kThreads % kMat + tid;
      const int r = q / kRowChunks, c = q % kRowChunks * 8;
      const bool ok = k + r < k_end && c0 + c < width;
      cp_async16_w(smem_addr(dst + (m * kRows + r) * kWStride + 2 * c),
                   ok ? static_cast<const void*>(w[m] + (int64_t)(k + r) * width + c0 + c)
                      : w[0],
                   ok ? 16 : 0);
    }
    if (tid < kX) {
      const int s = tid / kXChunks, e = tid % kXChunks * 8;
      const bool ok = arow[s] != nullptr && k + e < k_end;
      cp_async16(smem_addr(dst + M * kRows * kWStride + s * kXStride + 2 * e),
                 ok ? static_cast<const void*>(arow[s] + k + e) : w[0], ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(dst + m * kRows * kWStride);
      for (int i = tid; i < kRows * kCols; i += kThreads) {
        const int r = i / kCols, c = i % kCols;
        const bool ok = k + r < k_end && c0 + c < width;
        ws[r * (kWStride / 2) + c] = ok ? w[m][(int64_t)(k + r) * width + c0 + c] : zero;
      }
    }
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dst + M * kRows * kWStride);
    for (int i = tid; i < NT8 * 8 * kRows; i += kThreads) {
      const int s = i / kRows, e = i % kRows;
      const bool ok = arow[s] != nullptr && k + e < k_end;
      xs[s * (kXStride / 2) + e] = ok ? arow[s][k + e] : zero;
    }
  }
}

// acc[m][n] += the warp's 16 columns of matrix m times token tile n, over
// the k range [k_begin, k_end), streamed through an S-stage ring. C
// fragment: acc[m][n][0, 1] = (column 16 warp + g, slots 8n + 2t, +1),
// [2, 3] the same at column + 8 (g = lane / 4, t = lane % 4).
template <int M, int NT8, int S>
__device__ __forceinline__ void stream(uint8_t* smem, const __nv_bfloat16* const (&w)[M],
                                       int width, int c0, const __nv_bfloat16* const* arow,
                                       int k_begin, int k_end, bool vec,
                                       float (&acc)[M][NT8][4]) {
  constexpr int kStage = stage_bytes<M, NT8>();
  const int n = (k_end - k_begin + kRows - 1) / kRows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  // ldmatrix.trans x4: lanes 8i .. 8i + 7 give the rows of matrix i, the
  // 8 x 8 block at k + 8 (i / 2), column + 8 (i % 2): a[0..3] is then the
  // A fragment (columns g, g + 8 at k 2t, 2t + 1 and 2t + 8, 2t + 9)
  const int a_off = ((lane / 16) * 8 + lane % 8) * kWStride + (warp * 16 + (lane / 8) % 2 * 8) * 2;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n)
      load_stage<M, NT8>(smem + s * kStage, w, width, c0, arow, k_begin + s * kRows, k_end, vec);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int next = s + S - 1;
    if (next < n)
      load_stage<M, NT8>(smem + (next % S) * kStage, w, width, c0, arow,
                         k_begin + next * kRows, k_end, vec);
    cp_async_commit();
    const uint8_t* st = smem + (s % S) * kStage;
    const uint8_t* xs = st + M * kRows * kWStride;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t b[NT8][2];
#pragma unroll
      for (int nn = 0; nn < NT8; ++nn) {
        const uint8_t* p = xs + (nn * 8 + g) * kXStride + (kk * 16 + 2 * t) * 2;
        b[nn][0] = lds32(p);
        b[nn][1] = lds32(p + 16);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, smem_addr(st + (m * kRows + kk * 16) * kWStride + a_off));
#pragma unroll
        for (int nn = 0; nn < NT8; ++nn) mma_bf16(acc[m][nn], a, b[nn][0], b[nn][1]);
      }
    }
  }
  cp_async_wait<0>();
}

// h [R, nt, F] = bf16(silu(x Wg) * (x Wu)) for one row (blockIdx.y) and
// kCols columns of F (blockIdx.x).
template <int NT8>
__global__ void __launch_bounds__(kThreads)
bf16_up_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ eids,
               const int* __restrict__ toks, const __nv_bfloat16* __restrict__ w_gate,
               const __nv_bfloat16* __restrict__ w_up, __nv_bfloat16* __restrict__ h, int nt,
               int D, int F, int padded, int vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ const __nv_bfloat16* arow[NT8 * 8];
  const int r = blockIdx.y;
  if (padding_row(eids, r, padded)) return;
  const int64_t e = eids[r];
  const int c0 = blockIdx.x * kCols;
  if (threadIdx.x < NT8 * 8) {
    const int s = threadIdx.x;
    const int tok = s < nt ? toks[(int64_t)r * nt + s] : -1;
    arow[s] = tok >= 0 ? x + (int64_t)tok * D : nullptr;
  }
  __syncthreads();
  const __nv_bfloat16* const w[2] = {w_gate + e * D * F, w_up + e * D * F};
  float acc[2][NT8][4] = {};
  stream<2, NT8, kUpStages>(smem, w, F, c0, arow, 0, VITA_EXPERT_FAULT == 1 ? D - 16 : D, vec,
                            acc);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int f = c0 + warp * 16 + g + 8 * half;
    if (f >= F) continue;
#pragma unroll
    for (int nn = 0; nn < NT8; ++nn)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = nn * 8 + 2 * t + i;
        if (s >= nt) continue;
        const int c = 2 * half + i;
        h[((int64_t)r * nt + s) * F + f] = __float2bfloat16(silu(acc[0][nn][c]) * acc[1][nn][c]);
      }
  }
}

// Partial sums part [splits, R, nt, D] of h Wd over F rows [blockIdx.y *
// kDownSplitRows, + kDownSplitRows) for one row (blockIdx.z) and kCols
// columns of D (blockIdx.x).
template <int NT8>
__global__ void __launch_bounds__(kThreads)
bf16_down_kernel(const __nv_bfloat16* __restrict__ h, const int* __restrict__ eids,
                 const __nv_bfloat16* __restrict__ w_down, float* __restrict__ part, int nt,
                 int D, int F, int padded, int vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ const __nv_bfloat16* arow[NT8 * 8];
  const int r = blockIdx.z, R = gridDim.z;
  if (padding_row(eids, r, padded)) return;
  const int64_t e = eids[r];
  const int c0 = blockIdx.x * kCols;
  const int k0 = blockIdx.y * kDownSplitRows, k1 = min(F, k0 + kDownSplitRows);
  if (threadIdx.x < NT8 * 8) {
    const int s = threadIdx.x;
    arow[s] = s < nt ? h + ((int64_t)r * nt + s) * F : nullptr;
  }
  __syncthreads();
  const __nv_bfloat16* const w[1] = {w_down + e * F * D};
  float acc[1][NT8][4] = {};
  stream<1, NT8, kDownStages>(smem, w, D, c0, arow, k0, k1, vec, acc);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  float* out = part + ((int64_t)blockIdx.y * R + r) * nt * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int d = c0 + warp * 16 + g + 8 * half;
    if (d >= D) continue;
#pragma unroll
    for (int nn = 0; nn < NT8; ++nn)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = nn * 8 + 2 * t + i;
        if (s < nt) out[(int64_t)s * D + d] = acc[0][nn][2 * half + i];
      }
  }
}

// y [R, nt, D] = bf16(sum over splits of part), in split order; zeros on
// padding rows.
__global__ void bf16_finish_kernel(const float* __restrict__ part, const int* __restrict__ eids,
                                   __nv_bfloat16* __restrict__ y, int64_t n, int per_row,
                                   int splits, int padded) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (!padding_row(eids, (int)(i / per_row), padded))
      for (int k = 0; k < splits - (VITA_EXPERT_FAULT == 2); ++k) s += part[k * n + i];
    y[i] = __float2bfloat16(s);
  }
}

int down_splits(int F) { return (F + kDownSplitRows - 1) / kDownSplitRows; }

template <int NT8>
int up_smem() { return kUpStages * stage_bytes<2, NT8>(); }
template <int NT8>
int down_smem() { return kDownStages * stage_bytes<1, NT8>(); }

template <int NT8>
int launch_nt(const void* x, const int* eids, const int* toks, const void* wg, const void* wu,
              const void* wd, void* h, float* part, void* y, int R, int nt, int D, int F,
              int padded, cudaStream_t stream) {
  const int vec = D % 8 == 0 && F % 8 == 0 && aligned16(x) && aligned16(wg) && aligned16(wu) &&
                  aligned16(wd) && aligned16(h);
  static bool attrs = false;
  if (!attrs) {
    cudaFuncSetAttribute(bf16_up_kernel<NT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         up_smem<NT8>());
    cudaFuncSetAttribute(bf16_down_kernel<NT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         down_smem<NT8>());
    attrs = true;
  }
  auto* hb = static_cast<__nv_bfloat16*>(h);
  bf16_up_kernel<NT8><<<dim3((F + kCols - 1) / kCols, R), kThreads, up_smem<NT8>(), stream>>>(
      static_cast<const __nv_bfloat16*>(x), eids, toks, static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu), hb, nt, D, F, padded, vec);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int splits = down_splits(F);
  bf16_down_kernel<NT8><<<dim3((D + kCols - 1) / kCols, splits, R), kThreads, down_smem<NT8>(),
                          stream>>>(hb, eids, static_cast<const __nv_bfloat16*>(wd), part, nt, D,
                                    F, padded, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t n = (int64_t)R * nt * D;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  bf16_finish_kernel<<<blocks, 256, 0, stream>>>(part, eids, static_cast<__nv_bfloat16*>(y), n,
                                                 nt * D, splits, padded);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vita

// Pieces of F a down block takes: the first dimension of the partial sums.
extern "C" int vita_expert_ffn_bf16_splits(int F) { return vita::down_splits(F); }

// x [T, D] bf16; eids [R] int32 flat expert ids; toks [R, nt] int32 token
// index per slot (-1: an empty slot, whose outputs are zero); w_gate/w_up
// [E_rows, D, F] and w_down [E_rows, F, D] bf16. Scratch h [R, nt, F] bf16
// and part [splits, R, nt, D] float32; output y [R, nt, D] bf16. nt is 1,
// 2, 4, 8 or 16. padded: a row whose id repeats the previous row's is a
// padding row (the masked schedule's plan): no weights are read and its
// outputs are zero. Returns the CUDA error code of the launches.
extern "C" int vita_expert_ffn_bf16(const void* x, const int* eids, const int* toks,
                                    const void* w_gate, const void* w_up, const void* w_down,
                                    void* h, float* part, void* y, int R, int nt, int D, int F,
                                    int padded, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt != 1 && nt != 2 && nt != 4 && nt != 8 && nt != 16) return (int)cudaErrorInvalidValue;
  if (nt <= 8)
    return vita::launch_nt<1>(x, eids, toks, w_gate, w_up, w_down, h, part, y, R, nt, D, F,
                              padded, s);
  return vita::launch_nt<2>(x, eids, toks, w_gate, w_up, w_down, h, part, y, R, nt, D, F,
                            padded, s);
}

// Resources of the up (which 0, 1: up to 8, 16 token slots) and down (2, 3)
// kernels; out as kernel_info.
extern "C" int vita_expert_ffn_bf16_info(int which, int* out) {
  using namespace vita;
  switch (which) {
    case 0: return kernel_info((const void*)bf16_up_kernel<1>, kThreads, up_smem<1>(), out);
    case 1: return kernel_info((const void*)bf16_up_kernel<2>, kThreads, up_smem<2>(), out);
    case 2: return kernel_info((const void*)bf16_down_kernel<1>, kThreads, down_smem<1>(), out);
    case 3: return kernel_info((const void*)bf16_down_kernel<2>, kThreads, down_smem<2>(), out);
    default: return (int)cudaErrorInvalidValue;
  }
}
