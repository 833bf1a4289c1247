// Grouped matmul of the prefill MoE and of its backward, over rows sorted by
// expert and padded per expert to a tile_m multiple
// (vita_tpu_torch/ops/moe_gmm.py::sorted_layout):
//   forward / dx:  out[r, :] = x[r, :] @ w[g],  g = gids[r / tile_m];
//   weight grad:   dw[e] = a[rows of e]^T b[rows of e].
//
// Replaces the three TPU kernels of vita_tpu/ops/moe_gmm.py:
//   _gmm_kernel (B5a, through _gmm_raw: R > SMALL_R_MAX and tile_m >
//     SMALL_TILE_M): k-blocked, the f32 accumulator carried in VMEM scratch
//     across the sequential k axis of the grid;
//   _small_gmm_kernel (B5b, through _gmm_small: every other R): "weights-
//     once", grid (n, m) with m fastest, so consecutive row tiles of one
//     expert reuse the fetched weight block;
//   _wgrad_kernel (B12, _gmm_wgrad): grid (k, n, m) with m fastest, so each
//     (e, k, n) output block accumulates over e's row tiles in VMEM.
//
// What bounds them on the H100. At the main paths' shapes (D 4096, F 14336,
// 8 experts) B5a at R 28672 (a 12288-token prompt bucket, top-2) is 2 * R *
// 4096 * 14336 = 3.4 TFLOP per projection against 2.0 GB (x, w, out), and
// B12 at R 22528 (a 9216-token training step) 2.6 TFLOP against 1.8 GB
// (a, b, dw in bf16): about 1700 FLOP per byte, far above the card's
// balance point (~295 in bf16), so the tensor cores' rate: 3.4 and 2.7 ms
// at 989 TFLOP/s. B5b at R 1536 (a 256-token prefill chunk) is 180 GFLOP
// against the same 996 MB of weights, which must be read at least once:
// under the balance point, so the weight bytes (0.30 ms at 3.35 TB/s).
//
// bf16 B5a, B5b and B12: Hopper's warp-specialised wgmma + TMA design.
//   - A persistent grid of one block per SM walks 128 x 256 output tiles
//     (tile t, t + gridDim, ...) in groups of kWgGroupM (16) M tiles, M
//     fastest within a group: the resident blocks share ~16 row panels and
//     ~8 weight strips (about 32 MB at K 4096), which L2 (50 MB) keeps, so
//     neither is read from HBM much more than once. Up to 16 M tiles (R <=
//     2048, the serving chunk's 1536 included) that is B5b's weights-once
//     order, M fastest over all of R; at the training steps' R 3072 and
//     9216 the weights-once order measured no faster (chip_probe.py
//     gmm-small-order), so B5b walks B5a's order. B12's tiles are (expert,
//     128 rows of dw's K, 256 columns), expert outermost.
//   - Warpgroup 0 produces: one thread issues TMA loads (128-byte swizzle,
//     out-of-bounds boxes zero-filled) of 64-deep contraction stages into a
//     192 KB ring (kWgStages stages of 48 KB) with full/empty mbarriers;
//     setmaxnreg gives its registers to the consumers. Warpgroups 1 and 2
//     consume: each runs wgmma m64n256k16
//     (bf16 -> f32 in registers, both operands read from the swizzled ring)
//     on its 64 rows of the tile, four per stage, and releases the stage.
//     The producer runs ahead into the next tile while the consumers store
//     this one.
//   - Operand majors are taken by wgmma's transpose bits, never by a copy:
//     x is K-major; w [E, K, N] is N-major (transpose-B), w [E, N, K] (dx)
//     K-major. B12's A is a^T read from the staged [r][k] rows (M-major,
//     transpose-A), its B the staged [r][n] rows (transpose-B).
//   - A 128-row tile never crosses a group (tile_m is a multiple of 128), so
//     the forward block reads its group id from gids. A B12 block first
//     finds every expert's run of rows by binary search over the sorted gids
//     (into shared memory), and a tile walks its expert's run 64 rows a
//     stage; rows past e's end inside the last stage are zeroed in shared
//     memory before the product, an expert without rows gets exact zeros.
//     One block owns each output tile and there are no atomics, so two
//     launches give the same bits.
//   - Ragged edges: TMA fills zeros past R, K and N; stores are clipped.
//     A row stride that is not a multiple of 16 bytes (K or N not a multiple
//     of 8), or an operand not 16-byte aligned, cannot be a TMA tensor: then
//     all 128 producer threads fill the same swizzled ring with plain loads,
//     for the same consumers.
//   - The epilogue rounds to bf16 (nearest even, as torch's .to()), so B12
//     writes dw in a's dtype with no float32 temporary.
//
// float32 B5a and B5b: one 128 x 128 tile routine; x and w tiles of BK
// along K staged through two register-staged shared-memory buffers, an FMA
// loop of 8 x 8 outputs per thread, a 1-D grid in groups of kGroupM M tiles.
// float32 B12: the same staging and FMA loop, one block per (e, 128 K rows,
// 128 columns). They carry the narrow float32 paths, whose comparisons with
// the CPU stay at float32 tolerance.
#include "common.cuh"

namespace vita {
namespace {

using bf16 = __nv_bfloat16;

// The output tile t of an nm x nn grid walked in groups of g M tiles, M
// fastest within a group, then N, then the next group.
__device__ __forceinline__ void grouped_tile(int t, int nm, int nn, int g, int& mb, int& nb) {
  const int per_group = g * nn;
  const int first = (t / per_group) * g;
  const int rows = min(nm - first, g);
  mb = first + (t % per_group) % rows;
  nb = (t % per_group) / rows;
}

// First index of sorted gids[0, n) that is >= e.
__device__ __forceinline__ int lower_bound(const int* __restrict__ gids, int n, int e) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (gids[mid] < e) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// bf16 B5a, B5b and B12: wgmma + TMA.

enum WgMode : int { kFwd = 0, kFwdT = 1, kWgrad = 2 };

constexpr int kWgBM = 128;          // output rows of a tile: two consumers of 64
constexpr int kWgBN = 256;          // output columns of a tile: one m64n256 wgmma
constexpr int kWgBK = 64;           // contraction depth of a stage: one 128-byte bf16 row
// Chosen on the H100 by chip_probe.py gmm-tiles: ring stages (4 x 48 KB is
// the most that fits), wgmma groups a consumer keeps in flight when
// it waits (0: it releases each stage as soon as its products are done), M
// tiles per group of the tile order.
constexpr int kWgStages = 4;
constexpr int kWgInFlight = 0;
constexpr int kWgGroupM = 16;
constexpr int kWgThreads = 384;     // warpgroup 0 produces, 1 and 2 consume
constexpr int kChunk = 64 * 128;    // a [64 rows][128 bytes] swizzled box: 8 KB
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 64K

// A stage is 6 chunks: A (2: [128][64] x rows, or B12's [64 r][64 k] x 2)
// then B (4: [64 k][64 n] each, or dx's [256 n][64 k]).
constexpr int kWgStageBytes = (2 + kWgBN / 64) * kChunk;

// The ring, its alignment slack and its barriers; B12 adds E + 1 row bounds.
int wg_smem(int mode, int E) {
  return kWgStages * kWgStageBytes + 1024 + 2 * kWgStages * 8 + (mode == kWgrad ? 4 * (E + 1) : 0);
}

struct WgTile {
  int e, m0, n0;  // expert, first output row (B12: of dw's K), first output column
  int c0, c_end;  // contraction range: [0, K), or B12's rows of e
  int stages;
};

// Tile t's expert, corner and contraction walk; producer and consumers
// compute the same sequence. bounds: B12's row bounds of the experts.
template <int Mode>
__device__ __forceinline__ WgTile wg_tile(int t, const int* __restrict__ gids,
                                          const int* bounds, int R, int K, int N, int E,
                                          int tile_m) {
  WgTile w;
  const int nm = ((Mode == kWgrad ? K : R) + kWgBM - 1) / kWgBM;
  const int nn = (N + kWgBN - 1) / kWgBN;
  int mb, nb;
  if (Mode == kWgrad) {
    w.e = t / (nm * nn);
    grouped_tile(t % (nm * nn), nm, nn, kWgGroupM, mb, nb);
    w.c0 = bounds[w.e];
    w.c_end = bounds[w.e + 1];
  } else {
    grouped_tile(t, nm, nn, kWgGroupM, mb, nb);
    w.e = min(max(gids[mb * kWgBM / tile_m], 0), E - 1);
    w.c0 = 0;
    w.c_end = K;
  }
  w.m0 = mb * kWgBM;
  w.n0 = nb * kWgBN;
  w.stages = w.c_end > w.c0 ? (w.c_end - w.c0 + kWgBK - 1) / kWgBK : 0;
  return w;
}

// The plain-load producer: the box [row0, row0 + nrows) x [col0, col0 + 64)
// of a row-major [rows, cols] matrix (zeros outside it) into dst as TMA's
// 128-byte swizzle lays it out (the 16-byte chunk j of row i at j ^ (i % 8)).
__device__ __forceinline__ void fill_box(uint8_t* dst, const bf16* __restrict__ src, int64_t ld,
                                         int rows, int cols, int row0, int col0, int nrows,
                                         int ptid) {
  for (int idx = ptid; idx < nrows * 8; idx += 128) {
    const int i = idx >> 3, j = idx & 7;
    const int r = row0 + i, c = col0 + 8 * j;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      bf16* e = reinterpret_cast<bf16*>(&v);
      const bf16* p = src + (int64_t)r * ld;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (c + q < cols) e[q] = p[c + q];
    }
    *reinterpret_cast<uint4*>(dst + i * 128 + ((j ^ (i & 7)) << 4)) = v;
  }
}

// Stage `st` of tile w at contraction index c: TMA boxes (one thread), or
// plain loads by the producer warpgroup's 128 threads.
template <int Mode, bool Tma>
__device__ __forceinline__ void wg_load(const CUtensorMap& ma, const CUtensorMap& mb,
                                        const bf16* __restrict__ a, const bf16* __restrict__ b,
                                        int R, int K, int N, const WgTile& w, int c, uint8_t* st,
                                        uint64_t* full, int ptid) {
  uint8_t* sa = st;
  uint8_t* sb = st + 2 * kChunk;
  if constexpr (Tma) {
    mbar_arrive_expect_tx(full, kWgStageBytes);
    if constexpr (Mode == kWgrad) {
#pragma unroll
      for (int j = 0; j < 2; ++j) tma_load_2d(sa + j * kChunk, &ma, full, w.m0 + 64 * j, c);
#pragma unroll
      for (int j = 0; j < kWgBN / 64; ++j)
        tma_load_2d(sb + j * kChunk, &mb, full, w.n0 + 64 * j, c);
    } else {
      tma_load_2d(sa, &ma, full, c, w.m0);  // x [R, K]: a 64 x 128 box
      if constexpr (Mode == kFwd) {
#pragma unroll
        for (int j = 0; j < kWgBN / 64; ++j)  // w [E, K, N]: 64 x 64 boxes
          tma_load_3d(sb + j * kChunk, &mb, full, w.n0 + 64 * j, c, w.e);
      } else {
        tma_load_3d(sb, &mb, full, c, w.n0, w.e);  // w [E, N, K]: a 64 x 256 box
      }
    }
  } else {
    if constexpr (Mode == kWgrad) {  // rows past e's end load as zeros
#pragma unroll
      for (int j = 0; j < 2; ++j)
        fill_box(sa + j * kChunk, a, K, w.c_end, K, c, w.m0 + 64 * j, 64, ptid);
#pragma unroll
      for (int j = 0; j < kWgBN / 64; ++j)
        fill_box(sb + j * kChunk, b, N, w.c_end, N, c, w.n0 + 64 * j, 64, ptid);
    } else {
      fill_box(sa, a, K, R, K, w.m0, c, 128, ptid);
      const bf16* we = b + (int64_t)w.e * K * N;
      if constexpr (Mode == kFwd) {
#pragma unroll
        for (int j = 0; j < kWgBN / 64; ++j)
          fill_box(sb + j * kChunk, we, N, K, N, c, w.n0 + 64 * j, 64, ptid);
      } else {
        fill_box(sb, we, K, N, K, w.n0, c, kWgBN, ptid);
      }
    }
    fence_proxy_async();
    named_bar_sync(1, 128);
    if (ptid == 0) mbar_arrive(full);
  }
}

// The consumer's 64 x 256 accumulator (wgmma fragment layout) to rows
// [r0, r0 + 64) and columns [c0, c0 + 256) of a row-major bf16 matrix,
// clipped at rows x cols.
__device__ __forceinline__ void wg_store(bf16* __restrict__ out, int64_t ld, int rows, int cols,
                                         int r0, int c0, const float (&d)[kWgBN / 2], int ctid) {
  const int lane = ctid & 31;
  const int r = r0 + (ctid >> 5) * 16 + (lane >> 2);
  const int cb = c0 + 2 * (lane & 3);
  const bool pairs = (cols & 1) == 0;  // then (row, even column) is 4-byte aligned
#pragma unroll
  for (int j = 0; j < kWgBN / 8; ++j) {
    const int c = cb + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      if (rr >= rows || c >= cols) continue;
      bf16* p = out + (int64_t)rr * ld + c;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        p[0] = __float2bfloat16(v0);
        if (c + 1 < cols) p[1] = __float2bfloat16(v1);
      }
    }
  }
}

// kFwd: a = x [R, K], b = w [E, K, N], out [R, N]; kFwdT: b = w [E, N, K];
// kWgrad: a [R, K], b [R, N], out = dw [E, K, N]. The maps are the TMA
// tensors of a and b (unused without Tma).
template <int Mode, bool Tma>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ a,
                 const bf16* __restrict__ b, const int* __restrict__ gids, bf16* __restrict__ out,
                 int R, int K, int N, int E, int tile_m) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  int* bounds = reinterpret_cast<int*>(empty + kWgStages);  // B12: e's rows [bounds[e], bounds[e + 1])
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  if constexpr (Mode == kWgrad) {
    const int ng = R >= tile_m ? R / tile_m : 1;
    for (int e = threadIdx.x; e <= E; e += kWgThreads)
      bounds[e] = min(lower_bound(gids, ng, e) * tile_m, R);
  }
  __syncthreads();

  const int nm = ((Mode == kWgrad ? K : R) + kWgBM - 1) / kWgBM;
  const int n_tiles = (Mode == kWgrad ? E : 1) * nm * ((N + kWgBN - 1) / kWgBN);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    const int ptid = threadIdx.x;
    if (Tma && ptid != 0) return;
    int stage = 0, phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const WgTile w = wg_tile<Mode>(t, gids, bounds, R, K, N, E, tile_m);
      for (int i = 0; i < w.stages; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);
        wg_load<Mode, Tma>(map_a, map_b, a, b, R, K, N, w, w.c0 + i * kWgBK,
                           ring + stage * kWgStageBytes, &full[stage], ptid);
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1, ctid = threadIdx.x - 128 * wg;
    float d[kWgBN / 2];
    int stage = 0, phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const WgTile w = wg_tile<Mode>(t, gids, bounds, R, K, N, E, tile_m);
#pragma unroll
      for (int i = 0; i < kWgBN / 2; ++i) d[i] = 0.f;
      wgmma_fence_regs(d);
      int held = -1;  // kWgInFlight: a stage whose products may still be in flight
      for (int i = 0; i < w.stages; ++i) {
        uint8_t* st = ring + stage * kWgStageBytes;
        mbar_wait(&full[stage], phase);
        if constexpr (Mode == kWgrad) {
          // rows past e's end (the next expert's) out of all the stage's chunks
          const int valid = w.c_end - (w.c0 + i * kWgBK);
          if (valid < kWgBK) {
            const int n = (2 + kWgBN / 64) * (kWgBK - valid) * 8;
            for (int idx = c * 128 + ctid; idx < n; idx += 256) {
              const int q = idx / ((kWgBK - valid) * 8), rem = idx % ((kWgBK - valid) * 8);
              *reinterpret_cast<uint4*>(st + q * kChunk + (valid + rem / 8) * 128 +
                                        (rem % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
            }
            fence_proxy_async();
            named_bar_sync(2, 256);
          }
        }
        const uint32_t sa = smem_addr(st) + c * kChunk, sb = smem_addr(st + 2 * kChunk);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kWgBK / 16; ++s) {
          // K-major steps 16 elements (32 bytes) along the swizzled row;
          // MN-major 16 rows of 128 bytes
          const uint64_t da = Mode == kWgrad ? wgmma_desc(sa + 2048 * s, 8192, 1024)
                                             : wgmma_desc(sa + 32 * s, 16, 1024);
          const uint64_t db = Mode == kFwdT ? wgmma_desc(sb + 32 * s, 16, 1024)
                                            : wgmma_desc(sb + 2048 * s, 8192, 1024);
          wgmma_m64n256k16<Mode == kWgrad, Mode != kFwdT>(d, da, db);
        }
        wgmma_commit();
        wgmma_wait<kWgInFlight>();
        if constexpr (kWgInFlight == 0) {
          if ((ctid & 31) == 0) mbar_arrive(&empty[stage]);
        } else {  // the stage before this one is done
          if (held >= 0 && (ctid & 31) == 0) mbar_arrive(&empty[held]);
          held = stage;
        }
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      wgmma_fence_regs(d);
      if (held >= 0 && (ctid & 31) == 0) mbar_arrive(&empty[held]);
      if constexpr (Mode == kWgrad)
        wg_store(out + (int64_t)w.e * K * N, N, K, N, w.m0 + 64 * c, w.n0, d, ctid);
      else
        wg_store(out, N, R, N, w.m0 + 64 * c, w.n0, d, ctid);
    }
  }
}

template <int Mode, bool Tma>
const void* wgmma_fn() {
  return reinterpret_cast<const void*>(gmm_wgmma_kernel<Mode, Tma>);
}

template <int Mode, bool Tma>
int launch_wgmma(const CUtensorMap& ma, const CUtensorMap& mb, const void* a, const void* b,
                 const int* gids, void* out, int R, int K, int N, int E, int tile_m,
                 cudaStream_t stream) {
  static int sized = 0;  // the dynamic shared memory the kernel may use so far
  const int smem = wg_smem(Mode, E);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_fn<Mode, Tma>(), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
  }
  const int64_t tiles = (int64_t)(Mode == kWgrad ? E : 1) *
                        (((Mode == kWgrad ? K : R) + kWgBM - 1) / kWgBM) *
                        ((N + kWgBN - 1) / kWgBN);
  if (tiles == 0) return 0;
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  gmm_wgmma_kernel<Mode, Tma><<<grid, kWgThreads, smem, stream>>>(
      ma, mb, static_cast<const bf16*>(a), static_cast<const bf16*>(b), gids,
      static_cast<bf16*>(out), R, K, N, E, tile_m);
  return (int)cudaGetLastError();
}

template <int Mode>
int launch_wgmma_any(bool tma, const CUtensorMap& ma, const CUtensorMap& mb, const void* a,
                     const void* b, const int* gids, void* out, int R, int K, int N, int E,
                     int tile_m, cudaStream_t stream) {
  return tma ? launch_wgmma<Mode, true>(ma, mb, a, b, gids, out, R, K, N, E, tile_m, stream)
             : launch_wgmma<Mode, false>(ma, mb, a, b, gids, out, R, K, N, E, tile_m, stream);
}

// The forward (B5a, B5b): TMA maps of x and w (boxes of 64 x 128 and 64 x
// 64 or, with trans, 64 x 256) unless a row stride or an operand's
// alignment rules TMA out.
int launch_fwd(const void* x, const void* w, const int* gids, void* out, int R, int K, int N,
               int E, int tile_m, int trans, cudaStream_t s) {
  const bool tma =
      R > 0 && K > 0 && K % 8 == 0 && (trans || N % 8 == 0) && aligned16(x) && aligned16(w);
  CUtensorMap mx{}, mw{};
  if (tma) {
    const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)R};
    const cuuint32_t bx[2] = {64, 128};
    const cuuint64_t dw[3] = {(cuuint64_t)(trans ? K : N), (cuuint64_t)(trans ? N : K),
                              (cuuint64_t)E};
    const cuuint32_t bw[3] = {64, trans ? (cuuint32_t)kWgBN : 64u, 1};
    if (!make_map(&mx, x, 2, dx, bx) || !make_map(&mw, w, 3, dw, bw))
      return (int)cudaErrorInvalidValue;
  }
  return trans ? launch_wgmma_any<kFwdT>(tma, mx, mw, x, w, gids, out, R, K, N, E, tile_m, s)
               : launch_wgmma_any<kFwd>(tma, mx, mw, x, w, gids, out, R, K, N, E, tile_m, s);
}

// ---------------------------------------------------------------------------
// float32 B5a and B5b: the 128 x 128 tile routine.

constexpr int kBM = 128;     // rows per block
constexpr int kBN = 128;     // columns per block
constexpr int kThreads = 256;
constexpr int kGroupM = 16;  // M tiles per group of the block order
constexpr int kV = 4;        // floats per 16-byte chunk
constexpr int kBK = 16;      // a K tile row is 64 bytes
constexpr int kLdA = kBK + kV;  // x tile [kBM][kLdA], padded

// w tile: [kBK][kBN + kV] (n contiguous), or [kBN][kBK + kV] with trans
template <bool Trans>
__host__ __device__ constexpr int ldb() {
  return Trans ? kBK + kV : kBN + kV;
}
template <bool Trans>
__host__ __device__ constexpr int b_elems() {
  return Trans ? kBN * (kBK + kV) : kBK * (kBN + kV);
}
template <bool Trans>
__host__ __device__ constexpr int smem_floats() {
  return 2 * (kBM * kLdA + b_elems<Trans>());
}

// kV consecutive floats of row `row` of a row-major [rows, cols] matrix
// from column `col`, zero past its edges.
__device__ __forceinline__ uint4 load_chunk(const float* __restrict__ src, int64_t ld, int rows,
                                            int cols, int row, int col) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= cols) return v;
  const float* p = src + (int64_t)row * ld + col;
  if (col + kV <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(p));
  float* e = reinterpret_cast<float*>(&v);
  for (int i = 0; i < kV && col + i < cols; ++i) e[i] = p[i];
  return v;
}

// The tile [r0, r0 + RT) x [c0, c0 + CT) of a row-major matrix in 16-byte
// chunks, NCH per thread, held in registers between the global load and
// the shared-memory store.
template <int RT, int CT>
struct Stage {
  static constexpr int PER_ROW = CT / kV;
  static constexpr int NCH = RT * PER_ROW / kThreads;
  static_assert(NCH * kThreads == RT * PER_ROW, "tile must split evenly into chunks");
  uint4 r[NCH];

  __device__ __forceinline__ void load(const float* __restrict__ src, int64_t ld, int rows,
                                       int cols, int r0, int c0) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      r[i] = load_chunk(src, ld, rows, cols, r0 + c / PER_ROW, c0 + (c % PER_ROW) * kV);
    }
  }
  __device__ __forceinline__ void store(float* dst, int ldd) const {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(dst + (c / PER_ROW) * ldd + (c % PER_ROW) * kV) = r[i];
    }
  }
};

// Products of one staged K tile: thread (tx, ty) owns rows ty + 16 i and
// columns tx + 16 j of the block.
template <bool Trans>
__device__ __forceinline__ void fma_tile(const float* sA, const float* sB, float (&acc)[8][8],
                                         int tx, int ty) {
  constexpr int LDB = ldb<Trans>();
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = sA[(ty + 16 * i) * kLdA + k];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = Trans ? sB[(tx + 16 * j) * LDB + k] : sB[k * LDB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The output tile (mb, nb) of a 1-D grid in groups of kGroupM M tiles: its
// group's weight, the K loop over staged tiles, then the store of the rows
// below R and the columns below N.
template <bool Trans>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ gids,
           float* __restrict__ out, int R, int K, int N, int E, int tile_m) {
  __shared__ __align__(16) float smem[smem_floats<Trans>()];
  constexpr int LDB = ldb<Trans>(), B_ELEMS = b_elems<Trans>();
  float* sA[2] = {smem, smem + kBM * kLdA};
  float* sB[2] = {smem + 2 * kBM * kLdA, smem + 2 * kBM * kLdA + B_ELEMS};
  int mb, nb;
  grouped_tile(blockIdx.x, (R + kBM - 1) / kBM, (N + kBN - 1) / kBN, kGroupM, mb, nb);
  const int m0 = mb * kBM, n0 = nb * kBN;
  const int grp = min(max(gids[m0 / tile_m], 0), E - 1);
  const float* we = w + (int64_t)grp * K * N;

  Stage<kBM, kBK> ga;
  Stage<Trans ? kBN : kBK, Trans ? kBK : kBN> gb;
  auto load = [&](int k0) {
    ga.load(x, K, R, K, m0, k0);
    if constexpr (Trans)
      gb.load(we, K, N, K, n0, k0);  // w[g] is [N, K]
    else
      gb.load(we, N, K, N, k0, n0);  // w[g] is [K, N]
  };

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load(0);
  ga.store(sA[0], kLdA);
  gb.store(sB[0], LDB);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load((kt + 1) * kBK);
    fma_tile<Trans>(sA[cur], sB[cur], acc, tx, ty);
    if (more) {
      ga.store(sA[cur ^ 1], kLdA);
      gb.store(sB[cur ^ 1], LDB);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < R && col < N) out[(int64_t)row * N + col] = acc[i][j];
    }
}

template <bool Trans>
int launch(const void* x, const void* w, const int* gids, void* out, int R, int K, int N, int E,
           int tile_m, cudaStream_t stream) {
  const int nm = (R + kBM - 1) / kBM, nn = (N + kBN - 1) / kBN;
  gmm_kernel<Trans><<<nm * nn, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), gids, static_cast<float*>(out),
      R, K, N, E, tile_m);
  return (int)cudaGetLastError();
}

// float32 B12: one block per (expert e, 128-row K tile, 128-column N tile)
// walks e's rows kBK at a time; thread (tx, ty) owns k rows ty + 16 i and n
// columns tx + 16 j. Grid: expert, then K tile, then N tile fastest.
__global__ void __launch_bounds__(kThreads)
gmm_wgrad_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const int* __restrict__ gids, float* __restrict__ out, int R, int K, int N,
                     int n_tiles, int tile_m) {
  constexpr int LD = kBN + kV, ELEMS = kBK * LD;
  __shared__ __align__(16) float smem[4 * ELEMS];
  float* sA[2] = {smem, smem + ELEMS};
  float* sB[2] = {smem + 2 * ELEMS, smem + 3 * ELEMS};

  const int nk = (K + kBM - 1) / kBM, nn = (N + kBN - 1) / kBN;
  const int e = blockIdx.x / (nk * nn);
  const int k0 = (blockIdx.x / nn) % nk * kBM, n0 = blockIdx.x % nn * kBN;
  const int r_begin = lower_bound(gids, n_tiles, e) * tile_m;
  const int r_end = min(lower_bound(gids, n_tiles, e + 1) * tile_m, R);

  Stage<kBK, kBM> ga;
  Stage<kBK, kBN> gb;
  auto load = [&](int r0) {
    ga.load(a, K, r_end, K, r0, k0);
    gb.load(b, N, r_end, N, r0, n0);
  };
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (r_begin < r_end) {
    load(r_begin);
    ga.store(sA[0], LD);
    gb.store(sB[0], LD);
    __syncthreads();
    int cur = 0;
    for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
      const bool more = r0 + kBK < r_end;
      if (more) load(r0 + kBK);
#pragma unroll 4
      for (int r = 0; r < kBK; ++r) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = sA[cur][r * LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = sB[cur][r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (more) {
        ga.store(sA[cur ^ 1], LD);
        gb.store(sB[cur ^ 1], LD);
      }
      __syncthreads();
      cur ^= 1;
    }
  }

  float* oe = out + (int64_t)e * K * N;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = k0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < K && col < N) oe[(int64_t)row * N + col] = acc[i][j];
    }
}

}  // namespace
}  // namespace vita

// a [R, K], b [R, N] in one dtype, rows sorted by group as gids [ceil(R /
// tile_m)] int32 (non-decreasing) says; out [E, K, N] in that dtype, every
// element written. float32: tile_m is a multiple of 16 unless R < tile_m.
// Returns the CUDA error code of the launch.
extern "C" int vita_gmm_wgrad(const void* a, const void* b, const int* gids, void* out, int R,
                              int K, int N, int E, int tile_m, int dtype, void* stream) {
  using namespace vita;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const bool tma = R > 0 && K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(b);
    CUtensorMap ma{}, mb{};
    if (tma) {
      const cuuint64_t da[2] = {(cuuint64_t)K, (cuuint64_t)R}, db[2] = {(cuuint64_t)N, (cuuint64_t)R};
      const cuuint32_t box[2] = {64, 64};
      if (!make_map(&ma, a, 2, da, box) || !make_map(&mb, b, 2, db, box))
        return (int)cudaErrorInvalidValue;
    }
    return launch_wgmma_any<kWgrad>(tma, ma, mb, a, b, gids, out, R, K, N, E, tile_m, s);
  }
  const int n_tiles = R >= tile_m ? R / tile_m : 1;
  gmm_wgrad_f32_kernel<<<E * ((K + kBM - 1) / kBM) * ((N + kBN - 1) / kBN), kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), gids, static_cast<float*>(out),
      R, K, N, n_tiles, tile_m);
  return (int)cudaGetLastError();
}

// x [R, K]; w [E, K, N], or [E, N, K] with trans; gids [ceil(R / tile_m)]
// int32 group per row tile; out [R, N] in x's dtype. tile_m is a multiple
// of 128 unless R < tile_m (one group). vita_gmm is the float32 tile
// routine (B5a and B5b), vita_gmm_wgmma the bf16 wgmma + TMA kernel (B5a
// and B5b). Each returns the CUDA error code of the launch.
extern "C" int vita_gmm(const void* x, const void* w, const int* gids, void* out, int R, int K,
                        int N, int E, int tile_m, int trans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return trans ? vita::launch<true>(x, w, gids, out, R, K, N, E, tile_m, s)
               : vita::launch<false>(x, w, gids, out, R, K, N, E, tile_m, s);
}

extern "C" int vita_gmm_wgmma(const void* x, const void* w, const int* gids, void* out, int R,
                              int K, int N, int E, int tile_m, int trans, void* stream) {
  return vita::launch_fwd(x, w, gids, out, R, K, N, E, tile_m, trans,
                          static_cast<cudaStream_t>(stream));
}

// Resources of a wgmma kernel on the current card (which: 0 the forward of
// B5a and B5b, 1 with trans (dx), 2 B12; the TMA instantiations): out =
// registers and local (spilled) bytes a thread, shared bytes a block,
// resident blocks per SM.
extern "C" int vita_gmm_wgmma_info(int which, int* out) {
  using namespace vita;
  const void* fn = which == 0   ? wgmma_fn<kFwd, true>()
                   : which == 1 ? wgmma_fn<kFwdT, true>()
                                : wgmma_fn<kWgrad, true>();
  // B12 at the model's 8 experts
  return kernel_info(fn, kWgThreads, wg_smem(which == 2 ? kWgrad : kFwd, 8), out);
}
