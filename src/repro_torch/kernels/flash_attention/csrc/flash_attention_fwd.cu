// Flash-attention forward for Hopper (sm_90a): causal or sliding-window GQA
// attention with an online softmax, hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::_fa_kernel
// (launched by flash_attention_bhsd, wrapped by ops.flash_attention) and
// computes the same function: scores of q against k scaled by 1/sqrt(hd),
// columns masked past sq_valid/skv_valid, above the diagonal when causal
// (j <= i, top-left) and at or beyond `window` behind the diagonal when
// window > 0; the running (m, l, acc) kept in float32; output
// acc / max(l, 1e-30) in q's dtype.  The KV head of query head h is
// h / group: K/V are never repeated.
//
// Layout: q/o (B, Sq, H, hd), k/v (B, Skv, Hkv, hd), contiguous, the
// layout of the JAX package's public function; the kernel computes its own
// offsets, so the wrapper makes no transposed or padded copy.  Ragged Sq/Skv
// (not a tile multiple) are masked here.
//
// Two instances, chosen by dtype in flash_attention_fwd (an explicit
// dispatch, not a fallback):
//   * bfloat16, the serving path: products on the tensor cores
//     (fa_fwd_bf16_kernel);
//   * float32, which only the float32 checks use: plain float32 FMAs on the
//     CUDA cores (fa_fwd_f32_kernel), because TF32 products would not hold
//     the 2e-5 float32 tolerance.
//
// Bound.  At the served shapes (granite-3-8b prefill: B 8, H 32, Hkv 8,
// hd 128, Sq = Skv = 1024, causal; recurrentgemma-2b prefill: B 1, H 10,
// Hkv 1, hd 256, window 2048, S ~2900) the live pairs need ~68.7 and ~40
// GFLOP against ~168 and ~34 MB of q/k/v/o, so tensor-core FLOPs bound it
// (about 0.07 and 0.04 ms at 989 TFLOP/s bf16).
//
// bfloat16 design (FlashAttention-2 style on mma.sync; wgmma is the next
// step), tuned with tools/flash_tiles.py on the card:
//   * one block per (b*h, 64-row q tile) up to hd 256 (4 warps, each owning
//     16 q rows); hd <= 64 takes 128-row tiles (8 warps).  kv tiles of 32
//     rows.  hd <= 128: 168 registers and 48 KB of shared memory, 3 blocks
//     an SM.  hd 256: 96 KB, 2 blocks an SM, and 255 registers with no
//     spill, the float32 O accumulator alone 128 of them; each swizzled
//     ldmatrix address is a constant plus one of four lane offsets, which
//     keeps the address registers few.  Wider tiles or more warps a block
//     leave fewer warps an SM or spill.  Head dims between the instances
//     (multiples of 8) are zero-padded in shared memory and the padded
//     output columns are never written;
//   * S = Q K^T and O += P V run as mma.sync.m16n8k16 bf16 x bf16 -> f32.
//     Q and K reach the tensor cores through ldmatrix, V through
//     ldmatrix.trans; P goes from the S accumulator straight into A
//     fragments in registers (the C layout of m16n8 is the A layout of
//     m16n8k16 two tiles at a time), with l summed from the float32 p;
//   * P enters the PV product as two bf16 parts, hi = bf16(p) and lo =
//     bf16(p - hi) (two mma each), not one: at the models' scale (V rows of
//     std ~23-50, near one-hot rows) the 2^-9 rounding of one part puts
//     outputs that cancel to near 0 outside the bf16 tolerance;
//   * the tensor cores sum each 16-deep step of Q K^T exactly and truncate
//     it to float32.  Up to hd 128 the steps are chained in the tensor
//     core's accumulator; at hd 256 each step starts from zero and the
//     steps are added in float32 (round to nearest): recurrentgemma's
//     scores reach ~40000 before scaling, where on 24 layers' inputs the
//     chained truncations put one output outside the bf16 tolerance of the
//     exact (float64) answer and the float32 adds none;
//   * Q, and K and V in separate two-stage rings, are loaded with cp.async,
//     16 bytes a thread, so tile j+1 is in flight while tile j is
//     multiplied.  Rows at or past sq_valid/skv_valid and columns at or past
//     hd are zero-filled by the copy (src-size 0): nothing is read past a
//     tensor, and 0 * V never meets garbage.  Shared rows are XOR-swizzled
//     by 16-byte chunk (chunk ^ (row & 7)), so every ldmatrix phase reads 8
//     distinct bank groups;
//   * the loop visits only the kv tiles the causal mask and the window
//     leave live for the block, heaviest (latest) q tiles first; a warp
//     skips a tile no row of its 16 can see, and applies the per-element
//     mask only on tiles that cross its diagonal, its window edge or
//     skv_valid;
//   * softmax in base 2, p = 2^((s - m) * scale * log2 e); row max and sum
//     reduced with quad shuffles in the mma C layout.

// Trap handled in both instances: in a tile where every column of a row is
// masked, exp(NEG_INF - NEG_INF) = 1.  The reference relies on its alpha
// guard to wipe that; these kernels keep p = 0 wherever the mask is false
// instead (the float32 one by a select, the bf16 one by a masked score of
// -inf against a finite running max: 2^-inf = 0), so windowed rows and
// padding rows never depend on the cancellation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: plain FMAs on the CUDA cores (the float32 checks only)
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;        // query rows per block
constexpr int F32_BK = 64;        // kv rows per tile
constexpr int F32_THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows ty*4..ty*4+3

// Rows [row0, row0 + rows) of head `head` of a (B, S, n_heads, hd) tensor
// into shared memory with row stride `ld`.  Rows at or past `valid` are
// written as zeros, so a masked column never multiplies garbage.
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* __restrict__ src,
                                              int64_t batch_row0, int row0, int valid,
                                              int n_heads, int head, int hd, int rows) {
  for (int idx = threadIdx.x; idx < rows * hd; idx += F32_THREADS) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int s = row0 + r;
    float val = 0.f;
    if (s < valid) val = src[((batch_row0 + s) * n_heads + head) * (int64_t)hd + d];
    dst[r * ld + d] = val;
  }
}

// NC = ceil(hd / 16): output columns a thread owns (d = tx + 16 * c).
// Up to hd 128 two blocks share an SM (83 KB of shared memory each), which
// caps a thread at 128 registers; above it one block has the SM (148 KB at
// hd 256) and its threads may use up to 255 for the 4 x NC accumulator.
template <int NC>
__global__ void __launch_bounds__(F32_THREADS, NC > 8 ? 1 : 2)
    fa_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int H,
                      int group, int hd, int causal, int window, int sq_valid, int skv_valid,
                      float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;  // odd stride: the 16 K rows a warp reads sit in 16 banks
  float* sQ = smem;              // BQ x ld
  float* sKV = sQ + F32_BQ * ld;  // BK x ld: the K tile, then the V tile
  float* sP = sKV + F32_BK * ld;  // BQ x (BK + 1)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hkv = H / group;
  const int kh = h / group;
  // heaviest (latest) causal q tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F32_BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_tile_f32(sQ, ld, q, (int64_t)b * Sq, q0, sq_valid, H, h, hd, F32_BQ);

  // kv columns any row of this tile can see
  const int q_last = min(q0 + F32_BQ, sq_valid) - 1;
  int k_end = skv_valid;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  __syncthreads();

  for (int k0 = (k_begin / F32_BK) * F32_BK; k0 < k_end; k0 += F32_BK) {
    load_tile_f32(sKV, ld, k, (int64_t)b * Skv, k0, skv_valid, hkv, kh, hd, F32_BK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sQ[(ty * 4 + r) * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bk[c] = sKV[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }

    // mask + online softmax; a row's 64 columns live in the 16 lanes of
    // one half-warp, reduced with xor shuffles that stay inside it
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      bool live[4];
      float rmax = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        live[c] = i < sq_valid && j < skv_valid && (!causal || j <= i) &&
                  (window <= 0 || i - j < window);
        s[r][c] = live[c] ? s[r][c] * scale : NEG_INF;
        rmax = fmaxf(rmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[r], rmax);
      // m[r] == m_new == NEG_INF gives alpha 1 over an acc and l still 0
      const float alpha = expf(m[r] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = live[c] ? expf(s[r][c] - m_new) : 0.f;
        rsum += p;
        sP[(ty * 4 + r) * (F32_BK + 1) + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[r] = l[r] * alpha + rsum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // every read of the K tile is done

    load_tile_f32(sKV, hd, v, (int64_t)b * Skv, k0, skv_valid, hkv, kh, hd, F32_BK);
    __syncthreads();

    for (int j = 0; j < F32_BK; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = sP[(ty * 4 + r) * (F32_BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < hd ? sKV[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
    __syncthreads();  // before the next K tile overwrites the V tile and P
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= sq_valid) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* row = o + (((int64_t)b * Sq + i) * H + h) * (int64_t)hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) row[d] = acc[r][c] / denom;
    }
  }
}

template <int NC>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int H, int group, int hd, int causal, int window, int sq_valid,
                       int skv_valid, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)((F32_BQ + F32_BK) * (hd + 1) + F32_BQ * (F32_BK + 1));
  auto kern = fa_fwd_f32_kernel<NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (sq_valid + F32_BQ - 1) / F32_BQ);
  kern<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Skv, H, group, hd, causal, window, sq_valid, skv_valid,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Skv, int H, int group, int hd, int causal, int window, int sq_valid,
                         int skv_valid, cudaStream_t stream) {
#define FA_CASE(NC)                                                                           \
  case NC:                                                                                    \
    return launch_f32<NC>(q, k, v, o, B, Sq, Skv, H, group, hd, causal, window, sq_valid, \
                          skv_valid, stream);
  switch ((hd + 15) / 16) {
    FA_CASE(1)
    FA_CASE(2)
    FA_CASE(3)
    FA_CASE(4)
    FA_CASE(5)
    FA_CASE(6)
    FA_CASE(7)
    FA_CASE(8)
    FA_CASE(9)
    FA_CASE(10)
    FA_CASE(11)
    FA_CASE(12)
    FA_CASE(13)
    FA_CASE(14)
    FA_CASE(15)
    FA_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores (the serving path)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats x0, x1 -> two registers of two bf16 each (x0 in the low
// halves): hi = bf16(x), lo = bf16(x - hi), so hi + lo carries x to ~2^-17
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of rows of HDP bf16:
// the chunk index is XORed with the row's low three bits.
template <int HDP>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * HDP * 2 + ((c ^ (r & 7)) << 4));
}

// Rows [row0, row0 + ROWS) of one head into a swizzled shared tile, 16
// bytes a thread with cp.async.  `g` points at row 0 of the head, rows are
// `rs` elements apart.  Rows at or past `valid` and chunks at or past hd
// are zero-filled without a read.
template <int ROWS, int HDP, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ g,
                                                int64_t rs, int row0, int valid, int hd) {
  constexpr int CH = HDP / 8;
  static_assert((ROWS * CH) % THREADS == 0, "tile chunks must divide among the threads");
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int idx = it * THREADS + (int)threadIdx.x;
    const int r = idx / CH;
    const int c = idx % CH;
    const int s = row0 + r;
    const bool ok = s < valid && c * 8 < hd;
    const bf16* src = ok ? g + (int64_t)s * rs + c * 8 : g;
    cp_async16(dst + swz<HDP>(r, c), src, ok ? 16 : 0);
  }
}

// Byte offset, within a swizzled row, of 16-deep step j (a compile-time
// constant) read through the lane offsets o (see oa/ob in the kernel)
__device__ __forceinline__ uint32_t step_off(int j, const uint32_t (&o)[4]) {
  return (uint32_t)(((2 * j) & ~7) << 4) + o[j & 3];
}

template <int HDP, int NWARPS, int BK, int MINB>
__global__ void __launch_bounds__(NWARPS * 32, MINB)
    fa_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv, int H,
                       int group, int hd, int causal, int window, int sq_valid, int skv_valid,
                       float scale_log2) {
  constexpr int THREADS = NWARPS * 32;
  constexpr int BQ = NWARPS * 16;
  constexpr int NT = BK / 8;   // n8 tiles of S
  constexpr int DT = HDP / 8;  // n8 tiles of O
  constexpr uint32_t STAGE = BK * HDP * 2;  // bytes of one K or V tile
  // hd steps of Q K^T unrolled at once: fully up to hd 128; 4 at hd 256,
  // where full unrolling keeps too many fragments live and spills
  constexpr int KS_UNROLL = HDP > 128 ? 4 : HDP / 16;
  // the 16-deep steps of Q K^T each from a zeroed accumulator and added in
  // float32 (hd 256), or chained in the tensor core's accumulator (see the
  // note at the top)
  constexpr bool S_STEP_SUMS = HDP > 128;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);  // BQ x HDP
  const uint32_t sK = sQ + BQ * HDP * 2;   // 2 stages of BK x HDP
  const uint32_t sV = sK + 2 * STAGE;      // 2 stages of BK x HDP

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hkv = H / group;
  const int kh = h / group;
  // heaviest (latest) causal q tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row of the mma C layout (and + 8)
  const int t = lane & 3;   // column pair of the mma C layout

  const bf16* qg = q + ((int64_t)b * Sq * H + h) * hd;
  const int64_t kv_off = ((int64_t)b * Skv * hkv + kh) * hd;
  const int64_t q_rs = (int64_t)H * hd;
  const int64_t kv_rs = (int64_t)hkv * hd;

  // kv tiles any row of this block can see
  const int q_last = min(q0 + BQ, sq_valid) - 1;
  int k_end = skv_valid;
  if (causal) k_end = min(k_end, q_last + 1);
  const int t0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_tiles = k_end > t0 * BK ? (k_end - t0 * BK + BK - 1) / BK : 0;

  load_tile_async<BQ, HDP, THREADS>(sQ, qg, q_rs, q0, sq_valid, hd);
  if (n_tiles > 0) {
    load_tile_async<BK, HDP, THREADS>(sK, k + kv_off, kv_rs, t0 * BK, skv_valid, hd);
    load_tile_async<BK, HDP, THREADS>(sV, v + kv_off, kv_rs, t0 * BK, skv_valid, hd);
  }
  cp_async_commit();

  // this warp's rows
  const int qw0 = q0 + warp * 16;
  const int qw_last = min(qw0 + 15, sq_valid - 1);
  const bool warp_live = qw0 < sq_valid;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // raw-score row max, rows g and g + 8
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums

  // ldmatrix row addresses: lane -> (row, chunk half) of its 8x8 matrix
  const int a_row = lane & 15;                        // Q and V: rows 0-15
  const int a_half = lane >> 4;                       // Q and V: chunk 0 or 1
  const int b_row = ((lane >> 4) << 3) + (lane & 7);  // K: n rows 0-15
  const int b_half = (lane >> 3) & 1;                 // K: chunk 0 or 1
  // A row r (r & 7 fixed per lane, as every row offset is a multiple of 8)
  // reads 16-deep step j at chunk 2j + half, stored at (2j + half) ^ (r & 7)
  // = (2j & ~7) + ((2j & 7) ^ x) with x = half ^ (r & 7): a constant plus
  // one of four lane offsets, so the unrolled loops keep 4 registers per
  // pattern.  Steps go in fours (j = 4i + c: (2j & ~7) << 4 = 32 * 4i).
  uint32_t oa[4], ob[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    oa[j] = (uint32_t)(((2 * j) ^ a_half ^ (a_row & 7)) << 4);
    ob[j] = (uint32_t)(((2 * j) ^ b_half ^ (b_row & 7)) << 4);
  }
  const uint32_t q_row = sQ + (uint32_t)((warp * 16 + a_row) * HDP * 2);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (t0 + it) * BK;
    const uint32_t kbuf = sK + (it & 1) * STAGE;
    const uint32_t vbuf = sV + (it & 1) * STAGE;
    if (it + 1 < n_tiles) {  // the next tile into the other stage
      load_tile_async<BK, HDP, THREADS>(sK + ((it + 1) & 1) * STAGE, k + kv_off, kv_rs,
                                        k0 + BK, skv_valid, hd);
      load_tile_async<BK, HDP, THREADS>(sV + ((it + 1) & 1) * STAGE, v + kv_off, kv_rs,
                                        k0 + BK, skv_valid, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: Q and this tile have landed
    __syncthreads();

    // a tile no row of this warp can see is skipped whole
    if (warp_live && !(causal && k0 > qw_last) &&
        !(window > 0 && qw0 - (k0 + BK - 1) >= window)) {
      // S = Q K^T
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll (KS_UNROLL / 4)
      for (int k4 = 0; k4 < HDP / 16; k4 += 4) {  // steps k4 .. k4 + 3
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint32_t a[4];
          ldsm_x4(a, q_row + (k4 << 5) + oa[c]);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bk[4];
            ldsm_x4(bk, kbuf + (np * 16 + b_row) * HDP * 2 + (k4 << 5) + ob[c]);
            if constexpr (S_STEP_SUMS) {
              float d[2][4] = {};
              mma_bf16(d[0], a, bk[0], bk[1]);
              mma_bf16(d[1], a, bk[2], bk[3]);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                s[2 * np][e] += d[0][e];
                s[2 * np + 1][e] += d[1][e];
              }
            } else {
              mma_bf16(s[2 * np], a, bk[0], bk[1]);
              mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
            }
          }
        }
      }

      // the per-element mask only where a row of the warp crosses the
      // diagonal, the window edge or skv_valid.  A masked score becomes
      // -inf while m stays finite (it starts at NEG_INF), so its p is
      // 2^-inf = 0 exactly, with no cancellation of two NEG_INFs.
      if (k0 + BK > skv_valid || (causal && k0 + BK - 1 > qw0) ||
          (window > 0 && qw_last - k0 >= window)) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = qw0 + g + 8 * (e >> 1);
            const int j = k0 + n * 8 + 2 * t + (e & 1);
            if (!(j < skv_valid && (!causal || j <= i) && (window <= 0 || i - j < window)))
              s[n][e] = -INFINITY;
          }
      }

      // online softmax in base 2: p = 2^((s - m) * scale_log2)
      float pr[NT][4], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // m[r] == mx == NEG_INF gives alpha 1 over an acc and l still 0
        alpha[r] = exp2f((m[r] - mx) * scale_log2);
        m[r] = mx;
        l[r] *= alpha[r];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f((s[n][2 * r + c] - mx) * scale_log2);
            l[r] += p;
            pr[n][2 * r + c] = p;
          }
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }

      // O += P V with P from registers as the A operand, split into bf16
      // hi + lo parts: P rounded once to bf16 (2^-9 a weight) misses the
      // bf16 tolerance where large V rows cancel to a small output
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16(pr[2 * kk][0], pr[2 * kk][1], hi[0], lo[0]);
        split_bf16(pr[2 * kk][2], pr[2 * kk][3], hi[1], lo[1]);
        split_bf16(pr[2 * kk + 1][0], pr[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(pr[2 * kk + 1][2], pr[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int nd = 0; nd < DT / 2; ++nd) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vbuf + (kk * 16 + a_row) * HDP * 2 + step_off(nd, oa));
          mma_bf16(acc[2 * nd], hi, bv[0], bv[1]);
          mma_bf16(acc[2 * nd + 1], hi, bv[2], bv[3]);
          mma_bf16(acc[2 * nd], lo, bv[0], bv[1]);
          mma_bf16(acc[2 * nd + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every read of this stage is done before it is refilled
  }
  cp_async_wait<0>();

  // epilogue: full row sums across the quad, O / max(l, 1e-30) in bf16;
  // rows at or past sq_valid and columns at or past hd are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int i = qw0 + g + 8 * r;
    if (i >= sq_valid) continue;
    const float denom = fmaxf(lr, 1e-30f);
    bf16* row = o + (((int64_t)b * Sq + i) * H + h) * (int64_t)hd;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int col = d * 8 + 2 * t;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[d][2 * r] / denom, acc[d][2 * r + 1] / denom);
    }
  }
}

template <int HDP, int NWARPS, int BK, int MINB>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Skv, int H, int group, int hd, int causal, int window, int sq_valid,
                        int skv_valid, cudaStream_t stream) {
  constexpr int BQ = NWARPS * 16;
  const size_t smem = (size_t)(BQ + 4 * BK) * HDP * 2;
  auto kern = fa_fwd_bf16_kernel<HDP, NWARPS, BK, MINB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (sq_valid + BQ - 1) / BQ);
  kern<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Skv, H, group, hd, causal, window, sq_valid, skv_valid,
      LOG2E / sqrtf((float)hd));
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                          int Skv, int H, int group, int hd, int causal, int window,
                          int sq_valid, int skv_valid, cudaStream_t stream) {
  // cp.async moves 16 bytes: every row start must be 16-byte aligned
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (bits & 15) return cudaErrorMisalignedAddress;
  if (hd <= 64)
    return launch_bf16<64, 8, 64, 1>(q, k, v, o, B, Sq, Skv, H, group, hd, causal, window,
                                     sq_valid, skv_valid, stream);
  if (hd <= 128)
    return launch_bf16<128, 4, 32, 3>(q, k, v, o, B, Sq, Skv, H, group, hd, causal, window,
                                      sq_valid, skv_valid, stream);
  return launch_bf16<256, 4, 32, 2>(q, k, v, o, B, Sq, Skv, H, group, hd, causal, window,
                                    sq_valid, skv_valid, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() of the
// launch (0 on success); the caller raises on anything else.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Skv, int H, int group, int hd,
                                   int causal, int window, int sq_valid, int skv_valid,
                                   void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || group <= 0 || H % group != 0 || sq_valid > Sq ||
      skv_valid > Skv || sq_valid < 0 || skv_valid < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || sq_valid == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, o, B, Sq, Skv, H, group, hd, causal, window, sq_valid,
                             skv_valid, s);
  if (dtype == 1)
    return (int)dispatch_bf16(q, k, v, o, B, Sq, Skv, H, group, hd, causal, window, sq_valid,
                              skv_valid, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
