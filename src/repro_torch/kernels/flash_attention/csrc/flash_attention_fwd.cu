// Flash-attention forward for Hopper (sm_90a): causal or sliding-window GQA
// attention with an online softmax, hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::_fa_kernel
// (launched by flash_attention_bhsd, wrapped by ops.flash_attention) and
// computes the same function: scores of q against k scaled by 1/sqrt(hd),
// columns masked (NEG_INF) past sq_valid/skv_valid, above the diagonal when
// causal and at or beyond `window` behind the diagonal when window > 0; the
// running (m, l, acc) kept in float32; output acc / max(l, 1e-30) in q's
// dtype.  The KV head of query head h is h / group: K/V are never repeated.
//
// Layout: q/o (B, Sq, H, hd), k/v (B, Skv, Hkv, hd), contiguous, the
// layout of the JAX package's public function; the kernel computes its own
// offsets, so the wrapper makes no transposed or padded copy.  Ragged Sq/Skv
// (not a tile multiple) are masked here.
//
// Design, against what bounds it on this card.  At the main path's largest
// shape (granite-3-8b prefill: B 8, H 32, Hkv 8, hd 128, Sq = Skv = 1024)
// the causal work is ~68.7 GFLOP against ~168 MB of q/k/v/o, so
// tensor-core FLOPs bound it (about 0.07 ms at 989 TFLOP/s against 0.05 ms
// of bytes at 3.35 TB/s); at the small prompt buckets (S <= 128) the bytes
// and the launch bound it.  This first version is the simple one: plain
// float32 FMAs on the CUDA cores, so it runs far from the tensor-core bound.
// What it does about the bound is to not waste work and bytes:
//   * one block per (b*h, 64-row q tile); the TPU's sequential kv grid axis
//     is a loop inside the block;
//   * the loop visits only the kv tiles the causal mask and the window leave
//     live (the reference visits every tile under pl.when), which halves the
//     causal work and makes windowed work O(S * window);
//   * K and V tiles are staged in shared memory one at a time (the V tile
//     reuses the K tile's buffer), so two blocks fit on one SM;
//   * each K/V byte is read once per q tile; q/o once.
// wgmma, TMA and a producer/consumer pipeline are the next step.
//
// Trap handled here: in a tile where every column of a row is masked,
// exp(NEG_INF - NEG_INF) = 1.  The reference relies on its alpha guard to
// wipe that; this kernel sets p = 0 wherever the mask is false instead, so
// windowed rows and block-padding rows never depend on the cancellation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows ty*4..ty*4+3
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + rows) of head `head` of a (B, S, n_heads, hd) tensor
// into shared memory as float32 with row stride `ld`.  Rows at or past
// `valid` are written as zeros, so a masked column never multiplies garbage.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int64_t batch_row0, int row0, int valid, int n_heads,
                                          int head, int hd, int rows) {
  for (int idx = threadIdx.x; idx < rows * hd; idx += THREADS) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int s = row0 + r;
    float val = 0.f;
    if (s < valid) val = to_f32(src[((batch_row0 + s) * n_heads + head) * (int64_t)hd + d]);
    dst[r * ld + d] = val;
  }
}

// NC = ceil(hd / 16): output columns a thread owns (d = tx + 16 * c).
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 2)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int Sq, int Skv, int H, int group, int hd, int causal,
                  int window, int sq_valid, int skv_valid, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;  // odd stride: the 16 K rows a warp reads sit in 16 banks
  float* sQ = smem;              // BQ x ld
  float* sKV = sQ + BQ * ld;     // BK x ld: the K tile, then the V tile
  float* sP = sKV + BK * ld;     // BQ x (BK + 1)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hkv = H / group;
  const int kh = h / group;
  // heaviest (latest) causal q tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_tile(sQ, ld, q, (int64_t)b * Sq, q0, sq_valid, H, h, hd, BQ);

  // kv columns any row of this tile can see
  const int q_last = min(q0 + BQ, sq_valid) - 1;
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

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    load_tile(sKV, ld, k, (int64_t)b * Skv, k0, skv_valid, hkv, kh, hd, BK);
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
        sP[(ty * 4 + r) * (BK + 1) + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[r] = l[r] * alpha + rsum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // every read of the K tile is done

    load_tile(sKV, hd, v, (int64_t)b * Skv, k0, skv_valid, hkv, kh, hd, BK);
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = sP[(ty * 4 + r) * (BK + 1) + j];
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
    T* row = o + (((int64_t)b * Sq + i) * H + h) * (int64_t)hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) row[d] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                   int H, int group, int hd, int causal, int window, int sq_valid, int skv_valid,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)((BQ + BK) * (hd + 1) + BQ * (BK + 1));
  auto kern = fa_fwd_kernel<T, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (sq_valid + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H,
                                        group, hd, causal, window, sq_valid, skv_valid,
                                        1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                     int H, int group, int hd, int causal, int window, int sq_valid,
                     int skv_valid, cudaStream_t stream) {
#define FA_CASE(NC)                                                                         \
  case NC:                                                                                  \
    return launch<T, NC>(q, k, v, o, B, Sq, Skv, H, group, hd, causal, window, sq_valid, \
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
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() of the
// launch (0 on success); the caller raises on anything else.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Skv, int H, int group, int hd,
                                   int causal, int window, int sq_valid, int skv_valid,
                                   void* stream) {
  if (hd <= 0 || hd > 128 || hd % 8 != 0 || group <= 0 || H % group != 0 || sq_valid > Sq ||
      skv_valid > Skv || sq_valid < 0 || skv_valid < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || sq_valid == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, B, Sq, Skv, H, group, hd, causal, window, sq_valid,
                                skv_valid, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, group, hd, causal, window,
                                        sq_valid, skv_valid, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
