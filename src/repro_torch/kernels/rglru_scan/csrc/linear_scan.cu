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
// main path's shape (recurrentgemma-2b prefill: B 1, W 2560, S up to ~3000)
// the floor is 12 * B * S * W bytes over 3.35 TB/s, about 0.027 ms at S 3000.
//
// Design.  The TPU kernel carries the state across a sequential grid axis
// in VMEM scratch.  Here one thread owns one (b, channel) and walks the
// whole sequence itself, with h in a register, so nothing carries between
// blocks.  Neighbouring threads own neighbouring channels, so each step's
// loads and store are coalesced across the warp.  The walk goes in chunks
// of UNROLL steps: all of a chunk's a and b loads are issued before its
// first FMA, so a chunk waits out one memory latency instead of one per
// step.
//
// Why it stays off the bound, for now: at B 1, W 2560 this is 2560 threads,
// far too few for 132 SMs to keep enough bytes in flight (Little's law wants
// about 2 MB in flight at 3.35 TB/s; this has ~0.7 MB).  A chunked two-pass
// scan fixes it: the first pass computes per-chunk (prod a, local h) pairs
// over many more threads, a carry pass combines them along S, and a third
// streaming pass applies the carries.  That is a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;  // channels per block
constexpr int UNROLL = 32;   // steps whose loads are in flight together

__global__ void __launch_bounds__(THREADS)
    linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ out, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const int64_t base = (int64_t)bi * S * W + w;
  float h = h0[(int64_t)bi * W + w];
  for (int t0 = 0; t0 < S; t0 += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < S) {
        const int64_t off = base + (int64_t)t * W;
        av[u] = __ldcs(a + off);  // read once: stream past the caches
        bv[u] = __ldcs(b + off);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < S) {
        h = fmaf(av[u], h, bv[u]);
        __stcs(out + base + (int64_t)t * W, h);
      }
    }
  }
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success); the caller raises
// on anything else.
extern "C" int linear_scan_fwd(const void* a, const void* b, const void* h0, void* out, int B,
                               int S, int W, void* stream) {
  if (B < 0 || S < 0 || W < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || W == 0) return (int)cudaSuccess;
  dim3 grid((W + THREADS - 1) / THREADS, B);
  linear_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(h0),
      static_cast<float*>(out), S, W);
  return (int)cudaGetLastError();
}

extern "C" const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
