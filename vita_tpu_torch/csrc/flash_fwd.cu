// Flash attention forward (B1).
//
// Replaces: vita_tpu/ops/flash_attention.py::_fwd_kernel (the pallas_call in
// _flash_fwd), reached from Mixtral's prefill and the Generator's decode on
// the linear cache through flash_mha, and from the training forward.
//
// Both kernels compute, per q row, the online softmax over the keys below
// kv_len and (causal) at or before q_offset + row, scores scaled after the
// product as the Pallas kernel scales them; PV reads p rounded to V's type
// (the Pallas kernel's p.astype(v.dtype)) while the row sum keeps the
// unrounded p. GQA reads kv head h / (Hq / Hkv) directly from the [B, S, H,
// D] layout, so repeat_kv is never built. Rows that see no valid key write
// zeros. Each row's log-sum-exp of its scaled scores (m + log l, -inf for a
// row that sees no key) goes to lse [B, Hq, Sq], which the backward kernels
// (flash_bwd.cu) read. Two kernels, chosen by dtype before the launch:
//
// bfloat16: wgmma + TMA. At the long shapes (a 9216-token training bucket
// with 5735 real tokens, a 12288-row prefill over 8500 keys; 32 q / 8 kv
// heads of 128) there are 4 x 128 FLOP per (q row, key) pair against a few
// hundred MB of q/k/v/o: far above the card's balance point, so the tensor
// cores' rate bounds it (0.60 and 1.13 ms at 989 TFLOP/s). The design is
// FlashAttention-3's, simplified:
//   - A block owns 64 q rows of NC q heads of one GQA group (NC 2, or 1
//     when a grid of pairs would not fill the card's SMs), the longest causal
//     walks launched first. Warpgroup 0 produces: one thread loads the q
//     tiles once and then the K and V tiles of 128 keys by TMA into a ring
//     of kKvStages stages with full (K and V apart) and empty mbarriers;
//     with a pair of consumers setmaxnreg gives its registers to them.
//     Consumer warpgroup c (one per q head) keeps its q tile in shared
//     memory for the whole walk, and both consumers read each K/V tile:
//     the TPU kernel's GQA reuse.
//   - S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory
//     (d contiguous, 128-byte swizzle, two 64-wide d chunks). The scale is
//     applied to the float32 scores, with log2(e) folded into one FMA
//     before exp2; bf16 q is never pre-scaled (that would round it).
//   - Online softmax in the accumulator registers: a thread holds two rows'
//     32 columns each, the row max and sum reduce over the 4 threads of a
//     quad. Element masks run only on tiles that cross kv_len or the warp's
//     causal diagonal; whole tiles past either are never loaded.
//   - A consumer waits for each product before it reads its result: S,
//     then softmax, then P V. Issuing the next tile's S before this tile's
//     P V (FlashAttention-3's intra-warpgroup overlap) made ptxas serialize
//     the wgmma pipeline (its warning C7514) and spill, and ran slower; the
//     two consumers of a block overlap each other's softmax instead.
//   - p is rounded to bf16 in registers: the S fragment of two neighbouring
//     8-key column tiles is the A fragment of O += P V (wgmma with A from
//     registers), with no trip through shared memory. V [keys][d] is
//     N-major: the transpose-B bit. O is rescaled by alpha in registers.
//   - Maps are 4-D {128, H, S, B}, boxes {64, 1, rows, 1}: rows past S
//     zero-fill per batch row instead of reading the next batch row's. V
//     rows between kv_len and S in the last tile are zeroed in shared memory
//     (fence, named barrier) before PV, so stale cache rows cannot turn a
//     p of 0 into NaN.
//   - Each output element is written once by one block, with no atomics, so
//     two launches give the same bits.
//
// float32: an FMA kernel, both products as float32 loops from shared memory
// (one block per (batch * q head, 64-row q tile), q pre-scaled in float32),
// so the float32 comparison with the plain version stays tight; bound by
// the CUDA cores' FMA rate.
#include "common.cuh"

namespace vita {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;  // head dim
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- float32
constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kKPad = kD + 1;  // padded K row: conflict-free column reads
constexpr int kThreads = 256;

constexpr size_t kSmemFloats =
    kBQ * kD + kBK * kKPad + kBK * kD + kBQ * kBK + 3 * kBQ;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
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
  const float* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * kD;
  const float* kb = k + (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;
  const float* vb = v + (int64_t)b * Skv * kv_stride + (int64_t)hk * kD;
  float* ob = o + (int64_t)b * Sq * q_stride + (int64_t)h * kD;

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    Qs[i] = (q0 + r < Sq) ? qb[(int64_t)(q0 + r) * q_stride + c] * scale : 0.f;
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
      Ks[r * kKPad + c] = ok ? kb[(int64_t)(k0 + r) * kv_stride + c] : 0.f;
      Vs[i] = ok ? vb[(int64_t)(k0 + r) * kv_stride + c] : 0.f;
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
      Ps[r * kBK + lane] = p0;
      Ps[r * kBK + lane + 32] = p1;
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
    for (int c = 0; c < 8; ++c) ob[(int64_t)(q0 + r) * q_stride + tx + 16 * c] = acc[i][c] * inv;
  }
}

// --------------------------------------------------------------- bfloat16
constexpr int kRows = 64;                     // q rows of a block: one wgmma M
constexpr int kKeys = 128;                    // keys per K/V tile: one wgmma N
constexpr int kQChunk = kRows * 128;          // [64 rows][64 d] swizzled: 8 KB
constexpr int kKvChunk = kKeys * 128;         // [128 keys][64 d]: 16 KB
constexpr int kKvTile = 2 * kKvChunk;         // d 0-63 and 64-127: 32 KB
// Chosen on the H100 by chip_probe.py flash-fwd-tiles: K/V ring stages.
constexpr int kKvStages = 2;
// With a pair of consumers (384 threads, 168 registers each at entry),
// setmaxnreg moves registers to them: 128 x 24 + 256 x 240 <= 64K. With
// one consumer (256 threads) every thread may hold 255 and none is moved.
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

template <int NC>
struct FwdSmem {
  static constexpr int kQ = NC * 2 * kQChunk;          // q tiles of the NC heads
  static constexpr int kRing = kKvStages * 2 * kKvTile;  // K then V per stage
  // tiles, alignment slack, barriers (q, K full, V full, empty per stage)
  static constexpr int kBytes = kQ + kRing + 1024 + 8 * (1 + 3 * kKvStages);
};

template <int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                       float* __restrict__ lse, const int* __restrict__ kv_len,
                       const int* __restrict__ q_off, int Sq, int Skv, int Hq, int Hkv,
                       float scale, int causal) {
  using Sm = FwdSmem<NC>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = qs + Sm::kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + Sm::kRing);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kKvStages;
  uint64_t* empty = v_full + kKvStages;

  // block: (b, NC q heads of one kv head's group) fastest, then the q tile,
  // last rows first
  const int b = blockIdx.x / (Hq / NC);
  const int h0 = blockIdx.x % (Hq / NC) * NC;
  const int hk = h0 / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int klen = min(kv_len[b], Skv);
  const int qoff = q_off[b];
  int kend = klen;  // keys the block's rows can see
  if (causal) kend = min(kend, qoff + min(q0 + kRows, Sq));
  const int ntiles = kend > 0 ? (kend + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (NC == 2) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0 || ntiles == 0) return;
    mbar_arrive_expect_tx(q_full, Sm::kQ);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tma_load_4d(qs + (2 * c + j) * kQChunk, &map_q, q_full, 64 * j, h0 + c, q0, b);
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kKvStages;
      mbar_wait(&empty[st], ((i / kKvStages) & 1) ^ 1);
      uint8_t* kt = ring + st * 2 * kKvTile;
      mbar_arrive_expect_tx(&k_full[st], kKvTile);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tma_load_4d(kt + j * kKvChunk, &map_k, &k_full[st], 64 * j, hk, i * kKeys, b);
      mbar_arrive_expect_tx(&v_full[st], kKvTile);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tma_load_4d(kt + kKvTile + j * kKvChunk, &map_v, &v_full[st], 64 * j, hk, i * kKeys, b);
    }
  } else {
    if constexpr (NC == 2) setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1, ctid = threadIdx.x - 128 * wg;
    const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
    const int h = h0 + c;
    const int wq = q0 + warp * 16;  // the warp's first row
    const int r0 = wq + g, r1 = r0 + 8;  // this thread's rows
    const float scale_log2 = scale * kLog2e;
    float acc[64], s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = s[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw scores
    float l0 = 0.f, l1 = 0.f;              // this thread's part of the running sums
    const uint32_t qa = smem_addr(qs + 2 * c * kQChunk);
    if (ntiles > 0) mbar_wait(q_full, 0);

    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kKvStages, ph = (i / kKvStages) & 1;
      const int k0 = i * kKeys;
      uint8_t* kt = ring + st * 2 * kKvTile;
      const uint32_t ka = smem_addr(kt), va = ka + kKvTile;

      // S = Q K^T: 8 steps of 16 along d, 32 bytes along the swizzled rows
      mbar_wait(&k_full[st], ph);
      wgmma_fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = 32 * (kk & 3);
        wgmma_m64n128k16<0, 0>(s, wgmma_desc(qa + (kk >> 2) * kQChunk + off, 16, 1024),
                               wgmma_desc(ka + (kk >> 2) * kKvChunk + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(s);

      // masks where the tile crosses kv_len or the warp's causal diagonal
      if (k0 + kKeys > klen || (causal && k0 + kKeys - 1 > qoff + wq)) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= klen || (causal && key > qoff + (e < 2 ? r0 : r1))) s[4 * j + e] = -INFINITY;
          }
      }
      // online softmax over the quad's 128 columns of rows r0 and r1
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
      // a row without a valid key so far keeps max -inf: subtract 0 instead
      const float b0 = x0 == -INFINITY ? 0.f : x0 * scale_log2;
      const float b1 = x1 == -INFINITY ? 0.f : x1 * scale_log2;
      const float alpha0 = exp2f(m0 * scale_log2 - b0), alpha1 = exp2f(m1 * scale_log2 - b1);
      m0 = x0;
      m1 = x1;
      l0 *= alpha0;
      l1 *= alpha1;
      uint32_t p[8][4];  // A fragments of O += P V, 16 keys each
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = exp2f(fmaf(s[4 * j], scale_log2, -b0));
        const float p1 = exp2f(fmaf(s[4 * j + 1], scale_log2, -b0));
        const float p2 = exp2f(fmaf(s[4 * j + 2], scale_log2, -b1));
        const float p3 = exp2f(fmaf(s[4 * j + 3], scale_log2, -b1));
        l0 += p0 + p1;
        l1 += p2 + p3;
        p[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        p[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }

      // O += P V: 8 steps of 16 keys, 16 rows of 128 bytes each
      mbar_wait(&v_full[st], ph);
      const int stale = min(Skv, k0 + kKeys) - klen;  // rows of V past kv_len
      if (stale > 0) {
        uint8_t* vt = kt + kKvTile;
        const int first = klen - k0, n = 2 * stale * 8;  // 16-byte pieces
        for (int idx = ctid + 128 * c; idx < n; idx += 128 * NC) {
          const int chunk = idx / (stale * 8), rem = idx % (stale * 8);
          *reinterpret_cast<uint4*>(vt + chunk * kKvChunk + (first + rem / 8) * 128 +
                                    (rem % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        named_bar_sync(1, 128 * NC);
      }
      wgmma_fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_m64n128k16_rs<1>(acc, p[kk], wgmma_desc(va + 2048 * kk, kKvChunk, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) wgmma_fence_regs(p[kk]);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const int64_t row_stride = (int64_t)Hq * kD;
    bf16* ob = o + (int64_t)b * Sq * row_stride + (int64_t)h * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * row_stride + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * row_stride + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    if (t == 0) {
      float* lb = lse + ((int64_t)b * Hq + h) * Sq;
      if (r0 < Sq) lb[r0] = l0 > 0.f ? m0 * scale + logf(l0) : -INFINITY;
      if (r1 < Sq) lb[r1] = l1 > 0.f ? m1 * scale + logf(l1) : -INFINITY;
    }
  }
}

template <int NC>
const void* wgmma_fn() {
  return reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<NC>);
}

template <int NC>
int launch_wgmma(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
                 float* lse, const int* kv_len, const int* q_off, int B, int Sq, int Skv, int Hq,
                 int Hkv, float scale, int causal, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_fn<NC>(), cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem<NC>::kBytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  dim3 grid(B * Hq / NC, (Sq + kRows - 1) / kRows);
  flash_fwd_wgmma_kernel<NC><<<grid, 128 * (NC + 1), FwdSmem<NC>::kBytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, kv_len, q_off, Sq, Skv, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                const int* kv_len, const int* q_off, int B, int Sq, int Skv, int Hq, int Hkv,
                float scale, int causal, cudaStream_t stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mq{}, mk{}, mv{};
  const cuuint64_t dq[4] = {kD, (cuuint64_t)Hq, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t dkv[4] = {kD, (cuuint64_t)Hkv, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint32_t bq[4] = {64, 1, kRows, 1}, bkv[4] = {64, 1, kKeys, 1};
  if (!make_map(&mq, q, 4, dq, bq) || !make_map(&mk, k, 4, dkv, bkv) ||
      !make_map(&mv, v, 4, dkv, bkv))
    return (int)cudaErrorInvalidValue;
  // a pair of q heads a block when that grid fills the card, else one
  // head a block (twice the blocks)
  const int q_tiles = (Sq + kRows - 1) / kRows;
  if ((Hq / Hkv) % 2 == 0 && (int64_t)B * Hq / 2 * q_tiles >= sm_count())
    return launch_wgmma<2>(mq, mk, mv, o, lse, kv_len, q_off, B, Sq, Skv, Hq, Hkv, scale, causal,
                           stream);
  return launch_wgmma<1>(mq, mk, mv, o, lse, kv_len, q_off, B, Sq, Skv, Hq, Hkv, scale, causal,
                         stream);
}

int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
               const int* kv_len, const int* q_off, int B, int Sq, int Skv, int Hq, int Hkv,
               float scale, int causal, cudaStream_t stream) {
  cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kSmemBytes);
  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, kv_len, q_off, Sq, Skv, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vita

// q [B, Sq, Hq, 128], k/v [B, Skv, Hkv, 128], o like q, in one dtype (bf16:
// wgmma + TMA kernel, float32: FMA kernel); lse [B, Hq, Sq] float32;
// kv_len/q_off [B] int32 on the device. Returns the CUDA error code of the
// launch.
extern "C" int vita_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, const int* kv_len, const int* q_off,
                              int B, int Sq, int Skv, int Hq, int Hkv,
                              float scale, int causal, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vita::kBFloat16)
    return vita::launch_bf16(q, k, v, o, lse, kv_len, q_off, B, Sq, Skv, Hq, Hkv, scale, causal,
                             s);
  return vita::launch_f32(q, k, v, o, lse, kv_len, q_off, B, Sq, Skv, Hq, Hkv, scale, causal, s);
}

// Resources of the bf16 wgmma kernel on the current card (which: 0 with a
// pair of q heads a block, 1 with one): out = registers and local
// (spilled) bytes a thread, shared bytes a block, resident blocks per SM.
// Returns a CUDA error code.
extern "C" int vita_flash_fwd_info(int which, int* out) {
  using namespace vita;
  return which == 0 ? kernel_info(wgmma_fn<2>(), 384, FwdSmem<2>::kBytes, out)
                    : kernel_info(wgmma_fn<1>(), 256, FwdSmem<1>::kBytes, out);
}
