// Grouped matmul forward of the prefill MoE: out[r, :] = x[r, :] @ w[g],
// g = gids[r / tile_m], over rows sorted by expert and padded per expert to
// a tile_m multiple (vita_tpu_torch/ops/moe_gmm.py::sorted_layout).
//
// Replaces the two TPU schedules of vita_tpu/ops/moe_gmm.py:
//   _gmm_kernel (B5a, through _gmm_raw: R > SMALL_R_MAX, tile_m 512): k-
//     blocked, the f32 accumulator carried in VMEM scratch across the
//     sequential k axis of the grid;
//   _small_gmm_kernel (B5b, through _gmm_small: every other R, tile_m 128):
//     "weights-once", grid (n, m) with m fastest, so consecutive row tiles of
//     one expert reuse the fetched weight block.
//
// What bounds it on the H100. At B5a's R (28672 rows: a 12288-token prompt
// bucket, top-2, 8 experts) each of gate/up/down is 2 * 28672 * 4096 * 14336
// = 3.4 TFLOP against 235 MB of x and 940 MB of weights: FLOPs. At B5b's R
// (1536 rows: a 256-token prefill chunk) it is 180 GFLOP against the same
// 940 MB of weights, which must be read at least once: about 190 FLOP per
// weight byte, under the card's balance point (~295 in bf16), so the weight
// bytes.
//
// Design: one kernel for both schedules.
//   - A block computes a 128 x 128 output tile. 128 divides tile_m, so a block
//     never crosses a group boundary and reads its one group id from gids
//     itself. The TPU's sequential k axis becomes a loop inside the block:
//     x and w tiles of BK along K are staged through two shared-memory
//     buffers (the next tile's global loads go to registers before the
//     current tile's products, and to shared memory after them), and the
//     accumulator stays in registers.
//   - bf16: tensor-core mma.sync m16n8k16 with f32 accumulation, 8 warps of
//     64 x 32 outputs. f32: an FMA loop, 8 x 8 outputs per thread, so the f32
//     comparison with the plain version stays tight.
//   - A 1-D grid in groups of kGroupM M tiles, M fastest within a group,
//     then N, then the next group. At B5b's R (16 M tiles or fewer) that is
//     the TPU's weights-once order: the blocks resident at one time read the
//     same [K, 128] weight strips (1 MB at K 4096 in bf16, against 50 MB of
//     L2), which therefore stream from HBM about once. At larger R the
//     resident blocks share about 16 x panels and 16 weight strips, so
//     neither is read from HBM much more than once. (An M-fastest order over
//     all of R was up to 5% slower from R 9216 up on the H100, and no faster
//     below.)
//   - Ragged edges: rows past R, columns past N and K past its end load as
//     zeros and are not stored. A thread loads 16 bytes at once where the
//     chunk lies inside the matrix and is aligned, element by element
//     otherwise.
// wgmma, TMA and a deeper pipeline are later work.
//
// The same file holds B12, the weight gradient of the grouped matmul:
// dw[e] = a[rows of e]^T b[rows of e], out [E, K, N] in float32.
//
// Replaces vita_tpu/ops/moe_gmm.py::_wgrad_kernel (_gmm_wgrad), the TPU's
// grid (k, n, m) with m fastest, so each (e, k, n) output block accumulates
// over e's consecutive row tiles in VMEM.
//
// What bounds it on the H100. At a training step of 9216 tokens (R 22528,
// tile 512) each of the three projections' dw is 2 * 22528 * 4096 * 14336 =
// 2.6 TFLOP against 0.7 GB of a and b and 1.9 GB of float32 dw: operations,
// far above the balance point.
//
// Design: one block per (expert e, 128-row K tile, 128-column N tile). The
// block finds e's run of row tiles by binary search over the sorted gids
// (no host sync, no offsets array) and walks it BK rows at a time, staging
// the a and b rows through the same two register-staged shared-memory
// buffers as the forward; the accumulator stays in registers, so no block
// ever adds into another's output and there are no atomics. bf16 uses
// mma.sync with a's tile read transposed (a K-row of the product is a
// column of the staged a tile: each A fragment packs two 16-bit loads, as
// the forward's B fragment does); f32 an FMA loop. An expert with no rows
// writes exact zeros.
#include "common.cuh"

namespace vita {
namespace {

constexpr int kBM = 128;     // rows per block
constexpr int kBN = 128;     // columns per block
constexpr int kThreads = 256;
constexpr int kGroupM = 16;  // M tiles per group of the block order

template <typename T>
struct Cfg {
  static constexpr int V = 16 / sizeof(T);   // elements per 16-byte chunk
  static constexpr int BK = 64 / sizeof(T);  // a K tile row is 64 bytes
  static constexpr int LDA = BK + V;         // x tile [kBM][LDA], padded
  static constexpr int A_ELEMS = kBM * LDA;
  // w tile: [BK][kBN + V] (n contiguous), or [kBN][BK + V] with trans
  template <bool Trans>
  __host__ __device__ static constexpr int ldb() {
    return Trans ? BK + V : kBN + V;
  }
  template <bool Trans>
  __host__ __device__ static constexpr int b_elems() {
    return Trans ? kBN * (BK + V) : BK * (kBN + V);
  }
  template <bool Trans>
  __host__ __device__ static constexpr int smem_bytes() {
    return 2 * (A_ELEMS + b_elems<Trans>()) * sizeof(T);
  }
};

// V consecutive elements of row `row` of a row-major [rows, cols] matrix
// from column `col`, zero past its edges.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ src, int64_t ld,
                                            int rows, int cols, int row, int col) {
  constexpr int V = Cfg<T>::V;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= cols) return v;
  const T* p = src + (int64_t)row * ld + col;
  if (col + V <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(p));
  T* e = reinterpret_cast<T*>(&v);
  for (int i = 0; i < V && col + i < cols; ++i) e[i] = p[i];
  return v;
}

// The tile [r0, r0 + RT) x [c0, c0 + CT) of a row-major matrix in 16-byte
// chunks, NCH per thread, held in registers between the global load and
// the shared-memory store.
template <typename T, int RT, int CT>
struct Stage {
  static constexpr int V = Cfg<T>::V;
  static constexpr int PER_ROW = CT / V;
  static constexpr int NCH = RT * PER_ROW / kThreads;
  static_assert(NCH * kThreads == RT * PER_ROW, "tile must split evenly into chunks");
  uint4 r[NCH];

  __device__ __forceinline__ void load(const T* __restrict__ src, int64_t ld, int rows,
                                       int cols, int r0, int c0) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      r[i] = load_chunk(src, ld, rows, cols, r0 + c / PER_ROW, c0 + (c % PER_ROW) * V);
    }
  }
  __device__ __forceinline__ void store(T* dst, int ldd) const {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(dst + (c / PER_ROW) * ldd + (c % PER_ROW) * V) = r[i];
    }
  }
};

// bf16 products of one staged K tile: warp (wm, wn) owns rows wm..wm+63 and
// columns wn..wn+31 of the block, as 4 x 4 m16n8 accumulator fragments
// (mma_bf16 in common.cuh gives the fragment layouts).
template <bool Trans>
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* sA, const __nv_bfloat16* sB,
                                         float (&acc)[4][4][4], int wm, int wn, int lane) {
  using C = Cfg<__nv_bfloat16>;
  constexpr int LDA = C::LDA, LDB = C::ldb<Trans>();
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* a16 = reinterpret_cast<const uint16_t*>(sA);
  const uint16_t* b16 = reinterpret_cast<const uint16_t*>(sB);
#pragma unroll
  for (int ks = 0; ks < C::BK; ks += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const uint16_t* p = a16 + (wm + mi * 16 + g) * LDA + ks + 2 * t;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDA);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDA + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn + ni * 8 + g;
      if constexpr (Trans) {  // [n][k]: k pairs are adjacent
        const uint16_t* p = b16 + n * LDB + ks + 2 * t;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      } else {  // [k][n]: pack the two k rows of column n
        const uint16_t* p = b16 + (ks + 2 * t) * LDB + n;
        b[ni][0] = (uint32_t)p[0] | ((uint32_t)p[LDB] << 16);
        b[ni][1] = (uint32_t)p[8 * LDB] | ((uint32_t)p[9 * LDB] << 16);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// f32 products of one staged K tile: thread (tx, ty) owns rows ty + 16 i
// and columns tx + 16 j of the block.
template <bool Trans>
__device__ __forceinline__ void fma_tile(const float* sA, const float* sB, float (&acc)[8][8],
                                         int tx, int ty) {
  using C = Cfg<float>;
  constexpr int LDA = C::LDA, LDB = C::ldb<Trans>();
#pragma unroll 4
  for (int k = 0; k < C::BK; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = sA[(ty + 16 * i) * LDA + k];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = Trans ? sB[(tx + 16 * j) * LDB + k] : sB[k * LDB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The output tile (mb, nb): its group's weight, the K loop over staged
// tiles, then the store of the rows below R and the columns below N.
template <typename T, bool Trans>
__device__ __forceinline__ void gmm_tile(const T* __restrict__ x, const T* __restrict__ w,
                                         const int* __restrict__ gids, T* __restrict__ out,
                                         int R, int K, int N, int E, int tile_m, int mb,
                                         int nb, T* smem) {
  using C = Cfg<T>;
  constexpr int BK = C::BK, LDA = C::LDA, LDB = C::template ldb<Trans>();
  constexpr int B_ELEMS = C::template b_elems<Trans>();
  constexpr bool kMma = sizeof(T) == 2;
  T* sA[2] = {smem, smem + C::A_ELEMS};
  T* sB[2] = {smem + 2 * C::A_ELEMS, smem + 2 * C::A_ELEMS + B_ELEMS};
  const int m0 = mb * kBM, n0 = nb * kBN;
  const int grp = min(max(gids[m0 / tile_m], 0), E - 1);
  const T* we = w + (int64_t)grp * K * N;

  Stage<T, kBM, BK> ga;
  Stage<T, Trans ? kBN : BK, Trans ? BK : kBN> gb;
  auto load = [&](int k0) {
    ga.load(x, K, R, K, m0, k0);
    if constexpr (Trans)
      gb.load(we, K, N, K, n0, k0);  // w[g] is [N, K]
    else
      gb.load(we, N, K, N, k0, n0);  // w[g] is [K, N]
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc_m[kMma ? 4 : 1][4][4];
  float acc_f[kMma ? 1 : 8][8];
  if constexpr (kMma) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_m[mi][ni][c] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_f[i][j] = 0.f;
  }

  const int nk = (K + BK - 1) / BK;
  load(0);
  ga.store(sA[0], LDA);
  gb.store(sB[0], LDB);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load((kt + 1) * BK);
    if constexpr (kMma)
      mma_tile<Trans>(sA[cur], sB[cur], acc_m, wm, wn, lane);
    else
      fma_tile<Trans>(sA[cur], sB[cur], acc_f, tx, ty);
    if (more) {
      ga.store(sA[cur ^ 1], LDA);
      gb.store(sB[cur ^ 1], LDB);
    }
    __syncthreads();
  }

  if constexpr (kMma) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = m0 + wm + mi * 16 + g + (c >> 1) * 8;
          const int col = n0 + wn + ni * 8 + 2 * t + (c & 1);
          if (row < R && col < N) out[(int64_t)row * N + col] = from_f32<T>(acc_m[mi][ni][c]);
        }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
        if (row < R && col < N) out[(int64_t)row * N + col] = from_f32<T>(acc_f[i][j]);
      }
  }
}

// 1-D grid: groups of kGroupM M tiles, M fastest within a group, then N,
// then the next group.
template <typename T, bool Trans>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ gids,
           T* __restrict__ out, int R, int K, int N, int E, int tile_m) {
  __shared__ __align__(16) unsigned char smem[Cfg<T>::template smem_bytes<Trans>()];
  const int nm = (R + kBM - 1) / kBM, nn = (N + kBN - 1) / kBN;
  const int per_group = kGroupM * nn;
  const int pid = blockIdx.x;
  const int first = (pid / per_group) * kGroupM;
  const int rows = min(nm - first, kGroupM);
  const int mb = first + (pid % per_group) % rows;
  const int nb = (pid % per_group) / rows;
  gmm_tile<T, Trans>(x, w, gids, out, R, K, N, E, tile_m, mb, nb, reinterpret_cast<T*>(smem));
}

template <typename T, bool Trans>
int launch(const void* x, const void* w, const int* gids, void* out, int R, int K, int N,
           int E, int tile_m, cudaStream_t stream) {
  const int nm = (R + kBM - 1) / kBM, nn = (N + kBN - 1) / kBN;
  gmm_kernel<T, Trans><<<nm * nn, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), gids, static_cast<T*>(out), R, K, N, E,
      tile_m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(int trans, const void* x, const void* w, const int* gids, void* out, int R, int K,
             int N, int E, int tile_m, cudaStream_t stream) {
  return trans ? launch<T, true>(x, w, gids, out, R, K, N, E, tile_m, stream)
               : launch<T, false>(x, w, gids, out, R, K, N, E, tile_m, stream);
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

// bf16 products of one staged R tile of dw: sA holds a's rows [BK][kBM + V]
// (r, k), sB b's rows [BK][kBN + V] (r, n); the product's M index is k, so
// an A fragment packs the two r-adjacent 16-bit values of column m, as the
// B fragment does for column n.
__device__ __forceinline__ void wgrad_mma_tile(const __nv_bfloat16* sA, const __nv_bfloat16* sB,
                                               float (&acc)[4][4][4], int wm, int wn, int lane) {
  using C = Cfg<__nv_bfloat16>;
  constexpr int LD = kBN + C::V;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* a16 = reinterpret_cast<const uint16_t*>(sA);
  const uint16_t* b16 = reinterpret_cast<const uint16_t*>(sB);
  auto pair = [](const uint16_t* p) { return (uint32_t)p[0] | ((uint32_t)p[LD] << 16); };
#pragma unroll
  for (int ks = 0; ks < C::BK; ks += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const uint16_t* p = a16 + (ks + 2 * t) * LD + wm + mi * 16 + g;
      a[mi][0] = pair(p);
      a[mi][1] = pair(p + 8);
      a[mi][2] = pair(p + 8 * LD);
      a[mi][3] = pair(p + 8 * LD + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint16_t* p = b16 + (ks + 2 * t) * LD + wn + ni * 8 + g;
      b[ni][0] = pair(p);
      b[ni][1] = pair(p + 8 * LD);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// f32 products of one staged R tile: thread (tx, ty) owns k rows ty + 16 i
// and n columns tx + 16 j.
__device__ __forceinline__ void wgrad_fma_tile(const float* sA, const float* sB,
                                               float (&acc)[8][8], int tx, int ty) {
  using C = Cfg<float>;
  constexpr int LD = kBN + C::V;
#pragma unroll 4
  for (int r = 0; r < C::BK; ++r) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = sA[r * LD + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = sB[r * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Grid: expert, then K tile, then N tile fastest.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_wgrad_kernel(const T* __restrict__ a, const T* __restrict__ b, const int* __restrict__ gids,
                 float* __restrict__ out, int R, int K, int N, int n_tiles, int tile_m) {
  using C = Cfg<T>;
  constexpr int BK = C::BK, LD = kBN + C::V, ELEMS = BK * LD;
  static_assert(kBM == kBN, "a and b tiles share one layout");
  constexpr bool kMma = sizeof(T) == 2;
  __shared__ __align__(16) T smem[4 * ELEMS];
  T* sA[2] = {smem, smem + ELEMS};
  T* sB[2] = {smem + 2 * ELEMS, smem + 3 * ELEMS};

  const int nk = (K + kBM - 1) / kBM, nn = (N + kBN - 1) / kBN;
  const int e = blockIdx.x / (nk * nn);
  const int k0 = (blockIdx.x / nn) % nk * kBM, n0 = blockIdx.x % nn * kBN;
  // e's consecutive row tiles [lo, hi) of the sorted gids
  const int r_begin = lower_bound(gids, n_tiles, e) * tile_m;
  const int r_end = min(lower_bound(gids, n_tiles, e + 1) * tile_m, R);

  Stage<T, BK, kBM> ga;
  Stage<T, BK, kBN> gb;
  auto load = [&](int r0) {
    ga.load(a, K, r_end, K, r0, k0);
    gb.load(b, N, r_end, N, r0, n0);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc_m[kMma ? 4 : 1][4][4];
  float acc_f[kMma ? 1 : 8][8];
  if constexpr (kMma) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_m[mi][ni][c] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_f[i][j] = 0.f;
  }

  if (r_begin < r_end) {
    load(r_begin);
    ga.store(sA[0], LD);
    gb.store(sB[0], LD);
    __syncthreads();
    int cur = 0;
    for (int r0 = r_begin; r0 < r_end; r0 += BK) {
      const bool more = r0 + BK < r_end;
      if (more) load(r0 + BK);
      if constexpr (kMma)
        wgrad_mma_tile(sA[cur], sB[cur], acc_m, wm, wn, lane);
      else
        wgrad_fma_tile(sA[cur], sB[cur], acc_f, tx, ty);
      if (more) {
        ga.store(sA[cur ^ 1], LD);
        gb.store(sB[cur ^ 1], LD);
      }
      __syncthreads();
      cur ^= 1;
    }
  }

  float* oe = out + (int64_t)e * K * N;
  if constexpr (kMma) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = k0 + wm + mi * 16 + g + (c >> 1) * 8;
          const int col = n0 + wn + ni * 8 + 2 * t + (c & 1);
          if (row < K && col < N) oe[(int64_t)row * N + col] = acc_m[mi][ni][c];
        }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = k0 + ty + 16 * i, col = n0 + tx + 16 * j;
        if (row < K && col < N) oe[(int64_t)row * N + col] = acc_f[i][j];
      }
  }
}

template <typename T>
int launch_wgrad(const void* a, const void* b, const int* gids, float* out, int R, int K, int N,
                 int E, int tile_m, cudaStream_t stream) {
  const int nk = (K + kBM - 1) / kBM, nn = (N + kBN - 1) / kBN;
  const int n_tiles = R >= tile_m ? R / tile_m : 1;
  gmm_wgrad_kernel<T><<<E * nk * nn, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), gids, out, R, K, N, n_tiles, tile_m);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vita

// a [R, K], b [R, N] in one dtype, rows sorted by group as gids [ceil(R /
// tile_m)] int32 (non-decreasing) says; out [E, K, N] float32, every element
// written. tile_m is a multiple of the R tile (32 rows in bf16, 16 in f32)
// unless R < tile_m. Returns the CUDA error code of the launch.
extern "C" int vita_gmm_wgrad(const void* a, const void* b, const int* gids, float* out, int R,
                              int K, int N, int E, int tile_m, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vita::kBFloat16)
    return vita::launch_wgrad<__nv_bfloat16>(a, b, gids, out, R, K, N, E, tile_m, s);
  return vita::launch_wgrad<float>(a, b, gids, out, R, K, N, E, tile_m, s);
}

// x [R, K]; w [E, K, N], or [E, N, K] with trans; gids [ceil(R / tile_m)]
// int32 group per row tile; out [R, N] in x's dtype. tile_m is a multiple
// of 128 unless R < tile_m (one group). Returns the CUDA error code of the
// launch.
extern "C" int vita_gmm(const void* x, const void* w, const int* gids, void* out, int R, int K,
                        int N, int E, int tile_m, int trans, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vita::kBFloat16)
    return vita::launch_t<__nv_bfloat16>(trans, x, w, gids, out, R, K, N, E, tile_m, s);
  return vita::launch_t<float>(trans, x, w, gids, out, R, K, N, E, tile_m, s);
}
