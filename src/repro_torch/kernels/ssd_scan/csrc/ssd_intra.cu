// SSD intra-chunk term (the Mamba-2 diagonal blocks) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py::_ssd_kernel
// (launched by ssd_intra_bchlpn, wrapped by ops.ssd_intra) and computes the
// same function.  For each (b, chunk c, head h):
//     cum      = cumsum(dA)                                  (L,)
//     decay    = exp(cum_l - cum_s) where l >= s, else 0     (L, L)
//     Y        = ((C B^T) * decay) X                         (L, P)
// with xc (B, nc, L, H, P), dac (B, H, nc, L), bc/cc (B, nc, L, N) and out
// (B, nc, L, H, P), all float32.  L <= 128 is an argument: a prompt under
// one chunk is one chunk of L = S, and rows and columns at or past L are
// masked here.  Every input is read through strides (the innermost axis, P
// or N, contiguous), so the permuted dA view and the sliced B/C views of the
// model go in without a copy; out is contiguous.
//
// What bounds it on this card: bytes.  At the main path's largest shape
// (mamba2-130m prefill of 2000 tokens padded to 2048: nc 16, L 128, H 24,
// P 64, N 128) the call reads xc, dac, bc, cc once and writes out once,
// 27.5 MB, 0.0082 ms at 3.35 TB/s; the live (l >= s) pairs, with C B^T
// formed once per chunk, are 2 * 8256 * (128 + 24 * 64) * 16 = 0.44 GFLOP,
// 0.0066 ms at the 67 TFLOP/s of float32 on the CUDA cores.
//
// Design.  The TPU kernel runs one grid cell per (b, chunk, head) and forms
// C B^T again in every cell, though B and C have no head axis (one group,
// models/ssm.py).  Here a block owns (b, chunk, group of HG heads): it forms
// G = C B^T once in shared memory (C and B staged NK columns of N at a time
// through the buffer the scores use later), then for each of its heads
// builds the masked scores S = G * decay in shared memory and computes
// Y = S X, PK columns of P per pass, each thread holding an 8 x 4 tile of Y
// in registers.  HG is chosen on the host so that B * nc * (H / HG) blocks
// cover the SMs: at nc 16 that is 3 heads a block and 128 blocks; a short
// prompt (nc 1) gets one head a block and 24 blocks.  Shared memory: G and
// S (L x (L + 1) floats each, the padded stride keeps the two rows a warp
// reads on two banks), X (L x PK) and cum: 162 KB, above the 48 KB default,
// hence cudaFuncSetAttribute; one block per SM.  It computes in float32 on
// the CUDA cores, as the reference does (preferred_element_type f32).
//
// Why it stays off the bound, for now: it does about three times the live
// work (G over the full L x L, S X over the upper triangle's zeros too), and
// every FMA operand comes from shared memory through one 8-warp block per
// SM, so the inner loops wait on shared memory rather than on device
// memory.  Tensor cores (TF32 or split bf16 wgmma) on register-resident
// tiles, with only the live triangle, are the next step.
//
// Traps handled here:
//   * the mask is a select, never a multiply: above the diagonal
//     cum_l - cum_s > 0 and exp can overflow to inf, and inf * 0 is NaN.
//     exp is evaluated only where s <= l < L;
//   * exp(cum_l - cum_s) is never factored into exp(cum_l) * exp(-cum_s):
//     dA = dt * A <= 0 with A in [-16, -1], so cum falls to about -200 over
//     a chunk and exp(200) overflows float32;
//   * cum is summed, and cum_l - cum_s taken, in float64: near the diagonal
//     the difference is small while cum_l and cum_s are about -100, and in
//     float32 their ulps (~1e-5) would move each decay factor by ~1e-5
//     relative.  The reference's float32 segment sum carries that error; this
//     kernel does not (16K float64 subtractions a head, a small cost).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // 16 x 16 threads
constexpr int LMAX = 128;        // chunk length held in shared memory
constexpr int LS = LMAX + 1;     // padded row stride of the (L, L) tiles
constexpr int NK = 32;           // columns of N staged per step while forming G
constexpr int KS = NK + 1;       // padded row stride of the staged C and B
constexpr int PK = 64;           // columns of P per pass of Y = S X
constexpr int RT = LMAX / 16;    // rows of G, S and Y per thread
constexpr int CT = PK / 16;      // columns of Y per thread and pass
constexpr int SMEM_BYTES =
    (2 * LMAX * LS + LMAX * PK) * (int)sizeof(float) + LMAX * (int)sizeof(double);
static_assert(2 * LMAX * KS <= LMAX * LS, "C and B staging must fit in the scores buffer");

// element strides of the inputs, innermost axis excluded (it is 1)
struct Strides {
  long long xb, xc, xl, xh;  // xc (B, nc, L, H, P)
  long long db, dh, dc, dl;  // dac (B, H, nc, L): every axis
  long long bb, bc, bl;      // bc (B, nc, L, N)
  long long cb, cc, cl;      // cc (B, nc, L, N)
};

__device__ __forceinline__ void load_x(float* sX, const float* __restrict__ x, long long xl, int L,
                                       int P, int p0) {
  for (int i = threadIdx.x; i < LMAX * PK; i += THREADS) {
    const int s = i / PK, pp = i % PK;
    sX[i] = (s < L && p0 + pp < P) ? x[s * xl + p0 + pp] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
    ssd_intra_kernel(const float* __restrict__ xc, const float* __restrict__ dac,
                     const float* __restrict__ bc, const float* __restrict__ cc,
                     float* __restrict__ out, int NC, int L, int H, int P, int N, int HG,
                     Strides st) {
  extern __shared__ float smem[];
  float* sG = smem;                 // (LMAX, LS): G = C B^T of the chunk
  float* sS = sG + LMAX * LS;       // (LMAX, LS): one head's masked scores
  float* sX = sS + LMAX * LS;       // (LMAX, PK): one head's X, PK columns
  double* sCum = reinterpret_cast<double*>(sX + LMAX * PK);  // (LMAX): one head's cumsum of dA
  float* sC = sS;                   // (LMAX, KS) staging while G is formed
  float* sB = sS + LMAX * KS;       // (LMAX, KS)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.y, b = blockIdx.z;
  const int h_begin = blockIdx.x * HG, h_end = min(h_begin + HG, H);
  const float* cbase = cc + b * st.cb + c * st.cc;
  const float* bbase = bc + b * st.bb + c * st.bc;

  // 1) G = C B^T, once for every head of the group
  float g[RT][RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) g[i][j] = 0.f;
  for (int k0 = 0; k0 < N; k0 += NK) {
    __syncthreads();  // the previous step's reads are done
    for (int i = tid; i < LMAX * NK; i += THREADS) {
      const int l = i / NK, k = i % NK;
      const bool ok = l < L && k0 + k < N;
      sC[l * KS + k] = ok ? cbase[l * st.cl + k0 + k] : 0.f;
      sB[l * KS + k] = ok ? bbase[l * st.bl + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < NK; ++k) {
      float cr[RT], br[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        cr[i] = sC[(ty + 16 * i) * KS + k];
        br[i] = sB[(tx + 16 * i) * KS + k];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) g[i][j] = fmaf(cr[i], br[j], g[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) sG[(ty + 16 * i) * LS + tx + 16 * j] = g[i][j];

  for (int h = h_begin; h < h_end; ++h) {
    __syncthreads();  // G is complete; the previous head is done with S, X and cum
    const float* xbase = xc + b * st.xb + c * st.xc + h * st.xh;
    if (tid < 32) {
      // inclusive cumsum of dA in float64: 4 consecutive steps per lane,
      // then a warp scan of the lane totals
      const float* dbase = dac + b * st.db + h * st.dh + c * st.dc;
      double v[4], run = 0.0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int l = 4 * tid + u;
        run += l < L ? (double)dbase[l * st.dl] : 0.0;
        v[u] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double n = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += n;
      }
      const double up = __shfl_up_sync(0xffffffffu, incl, 1);
      const double excl = tid == 0 ? 0.0 : up;
#pragma unroll
      for (int u = 0; u < 4; ++u) sCum[4 * tid + u] = excl + v[u];
    }
    load_x(sX, xbase, st.xl, L, P, 0);
    __syncthreads();

    // 2) S = G * decay: exp only where s <= l < L (a select), 0 elsewhere
    for (int i = tid; i < LMAX * LMAX; i += THREADS) {
      const int l = i / LMAX, s = i % LMAX;
      float v = 0.f;
      if (s <= l && l < L) v = sG[l * LS + s] * expf((float)(sCum[l] - sCum[s]));
      sS[l * LS + s] = v;
    }
    __syncthreads();

    // 3) Y = S X, PK columns of P per pass
    float* obase = out + (((long long)b * NC + c) * L * H + h) * (long long)P;
    const long long orow = (long long)H * P;
    for (int p0 = 0; p0 < P; p0 += PK) {
      if (p0 > 0) {
        __syncthreads();
        load_x(sX, xbase, st.xl, L, P, p0);
        __syncthreads();
      }
      float y[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) y[i][j] = 0.f;
      for (int s = 0; s < L; ++s) {
        float sr[RT], xr[CT];
#pragma unroll
        for (int i = 0; i < RT; ++i) sr[i] = sS[(ty + 16 * i) * LS + s];
#pragma unroll
        for (int j = 0; j < CT; ++j) xr[j] = sX[s * PK + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) y[i][j] = fmaf(sr[i], xr[j], y[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int l = ty + 16 * i;
        if (l >= L) continue;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int p = p0 + tx + 16 * j;
          if (p < P) obase[l * orow + p] = y[i][j];
        }
      }
    }
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success); the caller raises on
// anything else.
extern "C" int ssd_intra_fwd(const void* xc, const void* dac, const void* bc, const void* cc,
                             void* out, int B, int NC, int L, int H, int P, int N,
                             long long xs_b, long long xs_c, long long xs_l, long long xs_h,
                             long long ds_b, long long ds_h, long long ds_c, long long ds_l,
                             long long bs_b, long long bs_c, long long bs_l, long long cs_b,
                             long long cs_c, long long cs_l, void* stream) {
  if (B < 0 || NC < 0 || L < 0 || H < 0 || P < 0 || N < 0 || L > LMAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || NC == 0 || L == 0 || H == 0 || P == 0) return (int)cudaSuccess;
  if (B > 65535 || NC > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  // heads per block: enough head groups that the blocks cover the SMs, and
  // no more, since each block forms G once for all of its heads
  const long long tiles = (long long)B * NC;
  const long long want = (sms + tiles - 1) / tiles;
  const int groups = (int)(want < 1 ? 1 : (want > H ? H : want));
  const int HG = (H + groups - 1) / groups;
  const Strides st{xs_b, xs_c, xs_l, xs_h, ds_b, ds_h, ds_c, ds_l,
                   bs_b, bs_c, bs_l, cs_b, cs_c, cs_l};
  dim3 grid((H + HG - 1) / HG, NC, B);
  ssd_intra_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xc), static_cast<const float*>(dac), static_cast<const float*>(bc),
      static_cast<const float*>(cc), static_cast<float*>(out), NC, L, H, P, N, HG, st);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
