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
// formed once per chunk, are 0.44 GFLOP, 0.0066 ms even at the 67 TFLOP/s
// of float32 on the CUDA cores.
//
// Design.  The products run on the tensor cores (mma.sync m16n8k8 TF32) in
// 3xTF32: every float32 operand x is split into hi = tf32(x) and lo =
// x - hi (the tensor core truncates lo to TF32), and each product is
// lo*hi + hi*lo + hi*hi,
// accumulated in float32, which keeps float32 accuracy (one TF32 pass
// lands more than ten times outside the kernel's 1e-3 + 1e-4 |want|
// tolerance at the served widths; tests/test_torch_scan_numerics.py
// emulates both).
//
// The (L, L) scores are cut into 16-row strips and 8-column tiles; strips
// r and 7 - r (a "pair") hold 18 of the 72 tiles on or below the diagonal
// whichever r, so the four pairs are equal work.  A block of 4 warps owns
// (b, chunk, pair r, group of HG <= 6 heads):
//   1. G = C B^T over the pair's live tiles only (their count fixed at
//      compile time for each r).  C's 32 rows and B's rows are staged for
//      all of N (N <= 128; more in batches of 128) in one cp.async batch
//      over the X buffers, so G waits out one load latency.  The warps
//      split N (warp w takes the k steps 8w, 8w + 32, ...), and the four
//      partial sums are added in a fixed order through shared memory.  B
//      and C have no head axis, so G serves all of the block's heads.  The
//      same batch brings dA of the block's heads; their float64 cumsums stay
//      in shared memory.
//   2. For each head (and each 64 columns of P), X arrives by cp.async into
//      one of three buffers, two heads ahead of the one multiplied.  The
//      warps split the k tiles of Y = S X (warp w takes tiles w, w + 4, ...)
//      for both strips and all of P, so each score is computed once.  S = G
//      * decay is built in registers from G's fragments and fed straight to
//      the product as its A operand: the accumulator holds columns 2t and
//      2t + 1 of each 8-column tile where the A operand wants t and t + 4,
//      so the k index of S X is relabelled (X's rows read in the same order)
//      instead of moving S through shuffles.  X is stored with an XOR
//      swizzle, so these reads hit 32 banks without padding.  The partial Y
//      of the four warps are added in a fixed order through shared memory
//      (over the X just consumed) and stored.
// Why this shape: forming G whole in every block, for a few heads at a
// time, made G more than half of the tensor-core work; fully unrolled, the
// products ran once per head through tens of KB of straight-line code and
// waited on instruction fetch, so the k loop is rolled; and a staging ring
// for G, X one head ahead and a per-head cumsum by one warp each waited
// out a load latency.  The sums run
// in a fixed order, so the result does not depend on timing.
// Shared memory is 113,664 bytes, so two blocks share an SM.  HG is chosen
// on the host so that the blocks fill two per SM.
//
// Why it is still off the bound: all blocks run as one wave, and each
// waits for its first batch of C and B, waits for X, and adds and stores
// the partial Y, none of it overlapped with the products; 3xTF32 is three tensor-core
// passes where the bound counts one float32 pass, and mma.sync peaks below
// the card's TF32 rate; each head's X is read by the four pair blocks
// (from L2 after the first).  Sharing X and B across a cluster of the four
// pair blocks, and wgmma, are the next steps.
//
// Traps handled here:
//   * the mask is a select, never a multiply: above the diagonal
//     cum_l - cum_s > 0 and exp can overflow to inf, and inf * 0 is NaN.
//     Only entries with s <= l < L are kept; rows and columns at or past
//     L, P and N are zero-filled in shared memory, so no stale value (a NaN
//     times a zero weight) reaches a live output;
//   * exp(cum_l - cum_s) is never factored into exp(cum_l) * exp(-cum_s):
//     dA = dt * A <= 0 with A in [-16, -1], so cum falls to about -200 over
//     a chunk and exp(200) overflows float32;
//   * cum is summed, and cum_l - cum_s taken, in float64: near the diagonal
//     the difference is small while cum_l and cum_s are about -100, and in
//     float32 their ulps (~1e-5) would move each decay factor by ~1e-5
//     relative (float32 put this kernel's first version at 1.42e-3 against
//     the 1e-3 tolerance).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int LMAX = 128;     // chunk length held in shared memory
constexpr int PK = 64;        // columns of P per item
constexpr int NB = 128;       // columns of N staged at once while G is formed
constexpr int KS = NB + 4;    // row stride of the staged C and B (conflict-free fragments)
constexpr int LIVE = 18;      // live tiles of a pair of strips at L 128
constexpr int CROWS = 32;     // rows of C a block stages: its two strips
constexpr int HGMAX = 6;      // heads a block at most (their cumsums stay in shared memory)
constexpr int NBUF = 3;       // X buffers: two items load while one is multiplied

// X of one item, (LMAX, PK) with an XOR swizzle: element (s, p) at
// s * PK + (p ^ swz(s)), so the B fragments' reads (rows 2t and 2t + 1 of a
// k tile, columns 8n + g) hit 32 banks
constexpr int X_BYTES = LMAX * PK * 4;                         // 32,768
constexpr int G_BYTES = LIVE * 32 * 16;                        // G's live tiles: 9,216
constexpr int CUM_BYTES = HGMAX * LMAX * 8;                    // 6,144
constexpr int SMEM_BYTES = NBUF * X_BYTES + G_BYTES + CUM_BYTES;  // 113,664
// over the X buffers while G is formed: C's 32 rows and B's 128, NB columns
constexpr int STAGE_BYTES = (CROWS + LMAX) * KS * 4;           // 84,480
// then the warps' partial G, over buffer 2 and G's room
constexpr int PART_BYTES = 4 * LIVE * 32 * 16;                 // 36,864
static_assert(STAGE_BYTES <= NBUF * X_BYTES, "C and B fit over the X buffers");
static_assert(2 * X_BYTES + PART_BYTES <= NBUF * X_BYTES + G_BYTES, "the partial G fit");
static_assert(HGMAX * LMAX * 4 <= G_BYTES, "dA of a block's heads fits in G's room");
static_assert(4 * 16 * 32 * 16 <= X_BYTES, "the partial Y fit over an X buffer");

__device__ __forceinline__ int swz(int s) { return ((s >> 1) & 3) << 3; }

// element strides of the inputs, innermost axis excluded (it is 1)
struct Strides {
  long long xb, xc, xl, xh;  // xc (B, nc, L, H, P)
  long long db, dh, dc, dl;  // dac (B, H, nc, L): every axis
  long long bb, bc, bl;      // bc (B, nc, L, N)
  long long cb, cc, cl;      // cc (B, nc, L, N)
};

// cp.async with zero fill: src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna, which the compiler expands into more instructions than these
// two), lo = x - hi exactly, passed as it is: the tensor core reads only a
// TF32 operand's top 19 bits, so lo enters truncated to TF32.  The operands
// here are finite (S is selected before it is split).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct AFrag {
  uint32_t hi[4], lo[4];
};
struct BFrag {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ AFrag split_a(float a0, float a1, float a2, float a3) {
  AFrag f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ BFrag split_b(float b0, float b1) {
  BFrag f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i] += a * b[i] in 3xTF32 for M independent accumulators, the small
// terms first.  Pass by pass over all of them, so that M products separate
// two that share an accumulator (an mma's latency is ~4 of its issue slots;
// called one accumulator at a time, these ran at a third of the rate)
template <int M>
__device__ __forceinline__ void mma3(float (&d)[M][4], const AFrag& a, const BFrag (&b)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) mma(d[i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < M; ++i) mma(d[i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < M; ++i) mma(d[i], a.hi, b[i].hi);
}

// the same for two A operands against one set of B fragments
template <int M>
__device__ __forceinline__ void mma3x2(float (&d1)[M][4], const AFrag& a1, float (&d0)[M][4],
                                       const AFrag& a0, const BFrag (&b)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    mma(d1[i], a1.lo, b[i].hi);
    mma(d0[i], a0.lo, b[i].hi);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    mma(d1[i], a1.hi, b[i].lo);
    mma(d0[i], a0.hi, b[i].lo);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    mma(d1[i], a1.hi, b[i].hi);
    mma(d0[i], a0.hi, b[i].hi);
  }
}

// live 8-column tiles of 16-row strip i: columns s <= l < L
__device__ __forceinline__ int live_tiles(int i, int L) {
  return 16 * i < L ? min(2 * i + 2, (L + 7) / 8) : 0;
}

// what a block stages for G: the C rows of its strips, the B rows its tiles read
struct Stage {
  const float* cbase;
  const float* bbase;
  long long cl, bl;
  int L, N, i0, i1, b_rows;
  bool vec;
};

// columns [n0, n0 + NB) of the block's C rows (strip i0's at rows 0..15,
// strip i1's at 16..31) and of B's first b_rows rows (from row CROWS), zero
// past L and N
__device__ __forceinline__ void load_stage(float* st, const Stage& sg, int n0) {
  const int rows = CROWS + sg.b_rows;
  auto source = [&](int q, int& l, long long& ld) {
    if (q < CROWS) {
      l = q < 16 ? 16 * sg.i0 + q : 16 * sg.i1 + q - 16;
      ld = sg.cl;
      return sg.cbase;
    }
    l = q - CROWS;
    ld = sg.bl;
    return sg.bbase;
  };
  if (sg.vec) {
    for (int i = threadIdx.x; i < rows * (NB / 4); i += THREADS) {
      const int q = i / (NB / 4), v = 4 * (i % (NB / 4)), n = n0 + v;
      int l;
      long long ld;
      const float* src = source(q, l, ld);
      const bool ok = l < sg.L && n < sg.N;
      cp_async16(st + q * KS + v, ok ? src + l * ld + n : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * NB; i += THREADS) {
      const int q = i / NB, v = i % NB, n = n0 + v;
      int l;
      long long ld;
      const float* src = source(q, l, ld);
      const bool ok = l < sg.L && n < sg.N;
      cp_async4(st + q * KS + v, ok ? src + l * ld + n : src, ok ? 4 : 0);
    }
  }
}

// one head's X (its first `rows` rows, columns [p0, p0 + PK)) into a
// swizzled buffer, zero past L and P
__device__ __forceinline__ void load_x(float* x, const float* xbase, long long xl, int L, int P,
                                       int p0, int rows, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * (PK / 4); i += THREADS) {
      const int s = i / (PK / 4), v = 4 * (i % (PK / 4)), p = p0 + v;
      const bool ok = s < L && p < P;
      cp_async16(x + s * PK + (v ^ swz(s)), ok ? xbase + s * xl + p : xbase, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * PK; i += THREADS) {
      const int s = i / PK, v = i % PK, p = p0 + v;
      const bool ok = s < L && p < P;
      cp_async4(x + s * PK + (v ^ swz(s)), ok ? xbase + s * xl + p : xbase, ok ? 4 : 0);
    }
  }
}

// inclusive cumsum of one head's dA (zero past L) in float64, by one warp:
// 4 consecutive steps per lane, then a warp scan of the lane totals
__device__ __forceinline__ void cumsum64(const float* da, double* cum, int lane) {
  double v[4], run = 0.0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    run += (double)da[4 * lane + u];
    v[u] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  const double up = __shfl_up_sync(0xffffffffu, incl, 1);
  const double excl = lane == 0 ? 0.0 : up;
#pragma unroll
  for (int u = 0; u < 4; ++u) cum[4 * lane + u] = excl + v[u];
}

// 1) this warp's partial G over the live tiles of pair RP (strip i1 = 7 - RP
// has 16 - 2 RP of them at L 128, strip i0 = RP has 2 RP + 2): the k steps
// 8 (warp + 4m) of each staged batch of N, accumulated into p1 and p0
template <int RP>
struct PartialG {
  static constexpr int N1 = 16 - 2 * RP, N0 = 2 * RP + 2;
  float p1[N1][4], p0[N0][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < N1; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p1[j][r] = 0.f;
        if (j < N0) p0[j][r] = 0.f;
      }
  }

  __device__ __forceinline__ void add(const float* stage, int warp, int g, int t) {
#pragma unroll 1
    for (int m = 0; m < NB / 32; ++m) {
      const float* st = stage + 8 * (warp + 4 * m) + t;
      const AFrag a0 = split_a(st[g * KS], st[(g + 8) * KS], st[g * KS + 4], st[(g + 8) * KS + 4]);
      const AFrag a1 = split_a(st[(16 + g) * KS], st[(24 + g) * KS], st[(16 + g) * KS + 4],
                               st[(24 + g) * KS + 4]);
      BFrag bf[N1];
#pragma unroll
      for (int j = 0; j < N1; ++j) {
        const float* bj = st + (CROWS + 8 * j + g) * KS;
        bf[j] = split_b(bj[0], bj[4]);
      }
      mma3x2<N0>(reinterpret_cast<float(&)[N0][4]>(p1), a1, p0, a0,
                 reinterpret_cast<const BFrag(&)[N0]>(bf));
      if constexpr (N1 > N0)
        mma3<N1 - N0>(reinterpret_cast<float(&)[N1 - N0][4]>(p1[N0]), a1,
                      reinterpret_cast<const BFrag(&)[N1 - N0]>(bf[N0]));
    }
  }

  // the live tiles in accumulator-fragment order: strip i1's tile j at slot
  // j, strip i0's after them
  __device__ __forceinline__ void write(float4* pw, int n0, int n1) const {
#pragma unroll
    for (int j = 0; j < N1; ++j)
      if (j < n1) pw[j * 32] = make_float4(p1[j][0], p1[j][1], p1[j][2], p1[j][3]);
#pragma unroll
    for (int j = 0; j < N0; ++j)
      if (j < n0) pw[(n1 + j) * 32] = make_float4(p0[j][0], p0[j][1], p0[j][2], p0[j][3]);
  }
};

// S = G * exp(cum_l - cum_s) where s <= l < L (a select), else 0, from one
// G accumulator tile (x (la, s), y (la, s+1), z (lb, s), w (lb, s+1)), as
// the A operand of Y = S X with the k index relabelled: slot t <-> s, slot
// t + 4 <-> s + 1.
__device__ __forceinline__ AFrag scores(float4 g, int la, int s, double cla, double clb,
                                        double cs0, double cs1, int L) {
  const int lb = la + 8;
  // exp of every entry, then the select: an entry above the diagonal may be
  // inf, and is never multiplied
  const float e0 = expf((float)(cla - cs0)), e1 = expf((float)(cla - cs1));
  const float e2 = expf((float)(clb - cs0)), e3 = expf((float)(clb - cs1));
  const float v0 = (s <= la && la < L) ? g.x * e0 : 0.f;
  const float v1 = (s + 1 <= la && la < L) ? g.y * e1 : 0.f;
  const float v2 = (s <= lb && lb < L) ? g.z * e2 : 0.f;
  const float v3 = (s + 1 <= lb && lb < L) ? g.w * e3 : 0.f;
  return split_a(v0, v2, v1, v3);
}

// the B fragments of one 8-column tile n of a k tile: X rows s, s + 1 (s =
// 8 kk + 2t, whose swizzle is 8t), column 8n + g
__device__ __forceinline__ BFrag x_frag(const float* xs, int n, int t) {
  const int col = 8 * (n ^ t);
  return split_b(xs[col], xs[PK + col]);
}

// the B fragments of the 8 column tiles of one 64-column pass, one k tile
__device__ __forceinline__ void x_frags(BFrag (&bf)[8], const float* xs, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) bf[n] = x_frag(xs, n, t);
}

__global__ void __launch_bounds__(THREADS, 2)
    ssd_intra_kernel(const float* __restrict__ xc, const float* __restrict__ dac,
                     const float* __restrict__ bc, const float* __restrict__ cc,
                     float* __restrict__ out, int NC, int L, int H, int P, int N, int HG,
                     int vec_x, int vec_bc, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xbuf = reinterpret_cast<float*>(smem);                              // NBUF x (LMAX, PK)
  float4* sG = reinterpret_cast<float4*>(smem + NBUF * X_BYTES);             // G's live tiles
  double* sCum = reinterpret_cast<double*>(smem + NBUF * X_BYTES + G_BYTES);  // (HG, LMAX)
  float* stage = xbuf;                                                       // C and B, first
  float* sDA = reinterpret_cast<float*>(sG);                                 // dA, first
  float4* part = reinterpret_cast<float4*>(smem + 2 * X_BYTES);              // partial G, then

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rp = blockIdx.x & 3, c = blockIdx.y, b = blockIdx.z;
  // the block's strips: i1 = 7 - rp (the longer at L 128) and i0 = rp
  const int i0 = rp, i1 = 7 - rp;
  const int n0 = live_tiles(i0, L), n1 = live_tiles(i1, L), nmax = max(n0, n1);
  if (nmax == 0) return;  // both strips past L
  // rows of X and of B that the live tiles read; those at or past L are
  // zero-filled, since S is 0 there and 0 times a stale NaN is NaN
  const int rows = 8 * nmax;
  const int h_begin = (blockIdx.x >> 2) * HG, n_heads = min(HG, H - h_begin);
  const int n_pc = (P + PK - 1) / PK, n_items = n_heads * n_pc;
  const float* xc0 = xc + b * st.xb + c * st.xc + h_begin * st.xh;

  auto issue_item = [&](int it) {
    const int hh = it / n_pc, p0 = (it % n_pc) * PK;
    load_x(xbuf + (it % NBUF) * (X_BYTES / 4), xc0 + hh * st.xh, st.xl, L, P, p0, rows, vec_x);
    cp_commit();
  };

  // 1) G over the pair's live tiles, staged NB columns of N at a time over
  // the X buffers; with the first batch, dA of the block's heads (into G's
  // room), whose float64 cumsums the warps take (warp w: heads w, w + 4)
  const Stage sg{cc + b * st.cb + c * st.cc, bc + b * st.bb + c * st.bc, st.cl, st.bl, L, N,
                 i0, i1, rows, (bool)vec_bc};
  for (int i = threadIdx.x; i < n_heads * LMAX; i += THREADS) {
    const int hh = i / LMAX, l = i % LMAX;
    const float* d = dac + b * st.db + (h_begin + hh) * st.dh + c * st.dc;
    cp_async4(sDA + i, l < L ? d + l * st.dl : d, l < L ? 4 : 0);
  }
  const int n_st = (N + NB - 1) / NB;
  float4 gsum[(LIVE * 32 + THREADS - 1) / THREADS];
  auto run = [&](auto pg) {
    pg.zero();
    for (int s = 0; s < max(n_st, 1); ++s) {
      if (s < n_st) load_stage(stage, sg, s * NB);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (s == 0)
        for (int hh = warp; hh < n_heads; hh += 4) cumsum64(sDA + hh * LMAX, sCum + hh * LMAX, lane);
      if (s < n_st) pg.add(stage, warp, g, t);
      __syncthreads();  // the batch (and dA) is consumed
    }
    // the first two items load while the partial G are added
    issue_item(0);
    if (n_items > 1) issue_item(1);
    pg.write(part + warp * LIVE * 32 + lane, n0, n1);
  };
  switch (rp) {
    case 0: run(PartialG<0>{}); break;
    case 1: run(PartialG<1>{}); break;
    case 2: run(PartialG<2>{}); break;
    default: run(PartialG<3>{}); break;
  }
  __syncthreads();
  // the four partial sums, in a fixed order, through registers (the partial
  // G lie partly in G's room)
#pragma unroll
  for (int k = 0; k < (LIVE * 32 + THREADS - 1) / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < (n0 + n1) * 32) {
      const float4 q0 = part[i], q1 = part[LIVE * 32 + i], q2 = part[2 * LIVE * 32 + i],
                   q3 = part[3 * LIVE * 32 + i];
      gsum[k] = make_float4(((q0.x + q1.x) + q2.x) + q3.x, ((q0.y + q1.y) + q2.y) + q3.y,
                            ((q0.z + q1.z) + q2.z) + q3.z, ((q0.w + q1.w) + q2.w) + q3.w);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < (LIVE * 32 + THREADS - 1) / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < (n0 + n1) * 32) sG[i] = gsum[k];
  }
  __syncthreads();  // G is whole

  // 2) per head and 64 columns of P: Y = (G * decay) X, the warps splitting k
  const int la1 = 16 * i1 + g, la0 = 16 * i0 + g;
  const long long orow = (long long)H * P;
  const float4* g1 = sG + lane;            // strip i1's tile kk at [kk * 32]
  const float4* g0 = sG + n1 * 32 + lane;  // strip i0's
#pragma unroll 1
  for (int it = 0; it < n_items; ++it) {
    float* x = xbuf + (it % NBUF) * (X_BYTES / 4);
    if (it + 2 < n_items) issue_item(it + 2);  // into the buffer item it - 1 left
    if (it + 2 < n_items) cp_wait<2>();
    else if (it + 1 < n_items) cp_wait<1>();
    else cp_wait<0>();
    __syncthreads();

    const int hh = it / n_pc, p0 = (it % n_pc) * PK;
    const double* cum = sCum + hh * LMAX;
    const double c1a = cum[la1], c1b = cum[la1 + 8];
    const double c0a = cum[la0], c0b = cum[la0 + 8];
    float y0[8][4], y1[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) y0[n][r] = y1[n][r] = 0.f;
    // this warp's k tiles of both strips: a rolled loop (its body is reused
    // from tile to tile), one warp-uniform branch a tile
#pragma unroll 1
    for (int kk = warp; kk < nmax; kk += 4) {
      const int s = 8 * kk + 2 * t;
      const float* xs = x + s * PK + g;
      const double2 cs = *reinterpret_cast<const double2*>(cum + s);
      BFrag bf[8];
      x_frags(bf, xs, t);
      if (kk < n1 && kk < n0) {
        mma3x2<8>(y1, scores(g1[kk * 32], la1, s, c1a, c1b, cs.x, cs.y, L), y0,
                  scores(g0[kk * 32], la0, s, c0a, c0b, cs.x, cs.y, L), bf);
      } else if (kk < n1) {
        mma3<8>(y1, scores(g1[kk * 32], la1, s, c1a, c1b, cs.x, cs.y, L), bf);
      } else {
        mma3<8>(y0, scores(g0[kk * 32], la0, s, c0a, c0b, cs.x, cs.y, L), bf);
      }
    }
    __syncthreads();  // X is consumed: the warps' partial Y take its place
    float4* yp = reinterpret_cast<float4*>(x) + lane;  // [warp][fragment][lane]
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      yp[(warp * 16 + n) * 32] = make_float4(y1[n][0], y1[n][1], y1[n][2], y1[n][3]);
      yp[(warp * 16 + 8 + n) * 32] = make_float4(y0[n][0], y0[n][1], y0[n][2], y0[n][3]);
    }
    __syncthreads();
    // warp w adds fragments w, w + 4, w + 8, w + 12 over the four warps, in
    // order, and stores rows la, la + 8 (< L), columns p0 + 8n + 2t, + 1 (< P)
    float* obase =
        out + ((long long)b * NC + c) * L * H * (long long)P + (long long)(h_begin + hh) * P;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int f = warp + 4 * m, n = f & 7;
      const bool first = f < 8;  // strip i1's fragments, then strip i0's
      if ((first ? n1 : n0) == 0) continue;
      const float4 q0 = yp[f * 32], q1 = yp[(16 + f) * 32], q2 = yp[(32 + f) * 32],
                   q3 = yp[(48 + f) * 32];
      const float v[4] = {((q0.x + q1.x) + q2.x) + q3.x, ((q0.y + q1.y) + q2.y) + q3.y,
                          ((q0.z + q1.z) + q2.z) + q3.z, ((q0.w + q1.w) + q2.w) + q3.w};
      const int la = first ? la1 : la0, p = p0 + 8 * n + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = la + 8 * half;
        if (l >= L) continue;
        float* o = obase + l * orow + p;
        if ((P & 1) == 0 && p + 1 < P) {
          *reinterpret_cast<float2*>(o) = make_float2(v[2 * half], v[2 * half + 1]);
        } else {
          if (p < P) o[0] = v[2 * half];
          if (p + 1 < P) o[1] = v[2 * half + 1];
        }
      }
    }
    __syncthreads();  // the buffer is consumed before item it + 3 is issued into it
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
  // heads per block: as many head groups as fill two blocks an SM with the
  // four strip pairs of every (b, chunk), and no more, since each block
  // forms its part of G once for all of its heads
  // (at most HGMAX, whose cumsums the block keeps)
  const long long pairs = 4LL * B * NC;
  const long long fit = 2LL * sms / pairs;
  const long long least = (H + HGMAX - 1) / HGMAX;
  const int groups = (int)(fit < least ? least : (fit > H ? H : fit));
  const int HG = (H + groups - 1) / groups;
  const long long gx = 4LL * ((H + HG - 1) / HG);
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 16-byte copies where every row start is 16-byte aligned
  const int vec_x = aligned16(xc) && P % 4 == 0 && xs_b % 4 == 0 && xs_c % 4 == 0 &&
                    xs_l % 4 == 0 && xs_h % 4 == 0;
  const int vec_bc = aligned16(bc) && aligned16(cc) && N % 4 == 0 && bs_b % 4 == 0 &&
                     bs_c % 4 == 0 && bs_l % 4 == 0 && cs_b % 4 == 0 && cs_c % 4 == 0 &&
                     cs_l % 4 == 0;
  const Strides st{xs_b, xs_c, xs_l, xs_h, ds_b, ds_h, ds_c, ds_l,
                   bs_b, bs_c, bs_l, cs_b, cs_c, cs_l};
  dim3 grid((unsigned)gx, NC, B);
  ssd_intra_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xc), static_cast<const float*>(dac), static_cast<const float*>(bc),
      static_cast<const float*>(cc), static_cast<float*>(out), NC, L, H, P, N, HG, vec_x, vec_bc,
      st);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
