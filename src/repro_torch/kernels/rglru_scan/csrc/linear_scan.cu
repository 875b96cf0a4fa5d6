// RG-LRU linear scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan/kernel.py::_scan_kernel
// (launched by linear_scan_bsw, wrapped by ops.linear_scan) and computes the
// same function: h_t = a_t * h_{t-1} + b_t in float32 over (B, S, W),
// starting from h0 (B, W), with every h_t written to out (B, S, W).  All
// four tensors are float32 and contiguous.  Ragged S and W (not a multiple
// of any block) are masked here, so the wrapper makes no padded copy (the
// reference pads with a = 1, b = 0).
//
// What bounds it on this card: bytes.  Each step reads a_t and b_t and
// writes h_t (12 bytes per element, plus h0 once) for one FMA, so at the
// main path's shape (recurrentgemma-2b prefill: B 1, S 2915, W 2560) the
// floor is 89.6 MB over 3.35 TB/s, 0.0267 ms.
//
// Design: a single-pass chunked scan along S with decoupled look-back.
// The TPU kernel carries the state across a sequential grid axis; one
// thread per channel walking all of S would leave 2560 threads for 132
// SMs, too few to keep the ~2 MB in flight that the memory rate needs.  Here a block owns a tile of CW channels x T steps (a
// "chunk"), and there are B * ceil(W / CW) * ceil(S / T) blocks:
//   1. The block takes the next chunk from an atomic ticket (not from
//      blockIdx), tiles of one chunk index before those of the next, so it
//      only ever waits on chunks that earlier-started, resident blocks own.
//   2. Each thread holds R steps of one channel (a and b in registers,
//      loads coalesced along W, all issued before the first use) and forms
//      its sub-chunk's aggregate (prod a, h from 0); NSUB sub-chunks make a
//      chunk.  The chunk's aggregate is published with flag AGGREGATE.
//   3. Warp 0 looks back along S over the same channel tile, 32 chunks at a
//      time, to the nearest chunk whose inclusive carry is published (flag
//      INCLUSIVE; chunk -1 stands for h0) with every chunk between it and
//      this one at least AGGREGATE.
//   4. Each channel folds h from that carry through the aggregates between,
//      in chunk order: h = fmaf(A_j, h, H_j).  It publishes this chunk's
//      inclusive carry fmaf(A, h_in, H), the same fold one chunk further, so
//      a carry is bitwise the same whichever chunk the look-back stopped at
//      and repeated calls give identical bits.
//   5. The held values are walked again from the carry, h = fmaf(a, h, b),
//      streaming h out.
// a and b are read once and h written once: the bound's 12 bytes a step.
// Within a sub-chunk the arithmetic is the plain version's FMA order; only
// the carry into it is associated differently (aggregates of 32 and 256
// steps).  A flag is published as CUTLASS's semaphores are: the block's
// writes, a barrier, then one thread's st.release.gpu; a reader's
// ld.acquire.gpu, then a barrier.  The wrapper allocates the ticket, the
// flags and the aggregates as one zeroed buffer; the kernel allocates
// nothing.
//
// Tile shape: a block's life is mostly latency (its loads, the look-back's
// wait for a predecessor's aggregate, the fold's reads from L2), so the
// bytes an SM holds in flight set the rate: 32 steps a thread (about 110
// registers, two blocks an SM) hold 128 KB of a and b an SM, where 16 steps
// (three blocks) held 96 KB and ran slower.  That latency, and the zeroing
// of the flags (a memset launched by the wrapper), keep it off the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CW = 32;              // channels per block: one warp a row
constexpr int NSUB = 8;             // sub-chunks per chunk, one per warp
constexpr int R = 32;               // steps per sub-chunk, held in registers
constexpr int T = NSUB * R;         // steps per chunk (256)
constexpr int THREADS = CW * NSUB;  // 256

enum : int { EMPTY = 0, AGGREGATE = 1, INCLUSIVE = 2 };

__device__ __forceinline__ int load_flag(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// flags: [ticket, n_chunks x n_tiles chunk flags], zeroed by the caller.
// agg: A, H and I (inclusive carry), each (n_chunks, B * W).
__global__ void __launch_bounds__(THREADS, 2)
    linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ out, int* flags,
                       float* agg, int S, int W, int n_wt, int n_tiles, long long BW,
                       long long n_chunks) {
  __shared__ int s_ticket, s_from;
  __shared__ float sA[NSUB][CW], sH[NSUB][CW], sIn[NSUB][CW];
  const int tx = threadIdx.x % CW, ty = threadIdx.x / CW;
  if (threadIdx.x == 0) s_ticket = atomicAdd(flags, 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int tile = ticket % n_tiles, k = ticket / n_tiles;  // k: chunk index along S
  const int bi = tile / n_wt, w = (tile % n_wt) * CW + tx;
  const bool live = w < W;
  int* chunk_flags = flags + 1 + tile;  // chunk j's flag at [j * n_tiles]
  const long long c = (long long)bi * W + w;
  float* gA = agg;
  float* gH = agg + n_chunks * BW;
  float* gI = agg + 2 * n_chunks * BW;

  // 2) hold R steps of one channel; the sub-chunk's aggregate
  const int t0 = k * T + ty * R;
  const long long off0 = ((long long)bi * S + t0) * W + w;
  float av[R], bv[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const bool ok = live && t0 + u < S;  // padding a = 1, b = 0 leaves h as it is
    av[u] = ok ? __ldcs(a + off0 + (long long)u * W) : 1.f;
    bv[u] = ok ? __ldcs(b + off0 + (long long)u * W) : 0.f;
  }
  float sa = av[0], sh = bv[0];  // h from 0: fmaf(a_0, 0, b_0) = b_0
#pragma unroll
  for (int u = 1; u < R; ++u) {
    sh = fmaf(av[u], sh, bv[u]);
    sa = av[u] * sa;
  }
  sA[ty][tx] = sa;
  sH[ty][tx] = sh;
  __syncthreads();

  // the chunk's aggregate, published
  float ca = 0.f, ch = 0.f;
  if (ty == 0) {
    ca = sA[0][tx];
    ch = sH[0][tx];
#pragma unroll
    for (int q = 1; q < NSUB; ++q) {
      ch = fmaf(sA[q][tx], ch, sH[q][tx]);
      ca = sA[q][tx] * ca;
    }
    if (live) {
      gA[k * BW + c] = ca;
      gH[k * BW + c] = ch;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) store_flag(chunk_flags + (long long)k * n_tiles, AGGREGATE);

  // 3) look back to the nearest published carry (chunk -1: h0)
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = k - 1, from = -1;
    while (base >= 0) {
      const int j = base - lane;
      const int f = j >= 0 ? load_flag(chunk_flags + (long long)j * n_tiles) : INCLUSIVE;
      const unsigned inc = __ballot_sync(0xffffffffu, f == INCLUSIVE);
      const unsigned empty = __ballot_sync(0xffffffffu, f == EMPTY);
      const int s = inc ? __ffs(inc) - 1 : 32;
      const unsigned nearer = s == 32 ? 0xffffffffu : (1u << s) - 1u;
      if (empty & nearer) continue;  // a nearer chunk has not published yet: poll again
      if (s < 32) {
        from = base - s;
        break;
      }
      base -= 32;
    }
    if (lane == 0) s_from = from;
  }
  __syncthreads();

  // 4) fold the carry in chunk order; publish this chunk's inclusive carry
  if (ty == 0) {
    const int from = s_from;
    float h = 0.f;
    if (live) {
      h = from < 0 ? h0[c] : __ldcg(gI + from * BW + c);
#pragma unroll 4
      for (int j = from + 1; j < k; ++j) h = fmaf(__ldcg(gA + j * BW + c), h, __ldcg(gH + j * BW + c));
      gI[k * BW + c] = fmaf(ca, h, ch);
    }
    sIn[0][tx] = h;
#pragma unroll
    for (int q = 1; q < NSUB; ++q) {
      h = fmaf(sA[q - 1][tx], h, sH[q - 1][tx]);
      sIn[q][tx] = h;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) store_flag(chunk_flags + (long long)k * n_tiles, INCLUSIVE);

  // 5) walk the held steps again from the carry, streaming h out
  if (!live) return;
  float h = sIn[ty][tx];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    h = fmaf(av[u], h, bv[u]);
    if (t0 + u < S) __stcs(out + off0 + (long long)u * W, h);
  }
}

void geometry(int B, int S, int W, long long* n_wt, long long* n_tiles, long long* n_chunks) {
  *n_wt = (W + CW - 1) / CW;
  *n_tiles = (long long)B * *n_wt;
  *n_chunks = (S + T - 1) / T;
}

}  // namespace

// Scratch the caller allocates for one call: *n_ints int32 (zeroed: the
// ticket and the chunk flags) and *n_floats float32 (the aggregates, any
// contents).
extern "C" void linear_scan_scratch(int B, int S, int W, long long* n_ints, long long* n_floats) {
  long long n_wt, n_tiles, n_chunks;
  geometry(B, S, W, &n_wt, &n_tiles, &n_chunks);
  *n_ints = 1 + n_chunks * n_tiles;
  *n_floats = 3 * n_chunks * (long long)B * W;
}

// Returns cudaGetLastError() of the launch (0 on success); the caller raises
// on anything else.
extern "C" int linear_scan_fwd(const void* a, const void* b, const void* h0, void* out,
                               void* flags, void* agg, int B, int S, int W, void* stream) {
  if (B < 0 || S < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || W == 0) return (int)cudaSuccess;
  long long n_wt, n_tiles, n_chunks;
  geometry(B, S, W, &n_wt, &n_tiles, &n_chunks);
  const long long blocks = n_tiles * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  linear_scan_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(h0),
      static_cast<float*>(out), static_cast<int*>(flags), static_cast<float*>(agg), S, W,
      (int)n_wt, (int)n_tiles, (long long)B * W, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
