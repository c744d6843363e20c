// Block-Jacobi preconditioned CG over the ELLPACK Gauss-Newton operator of
// the large-N pair solve, for an NVIDIA Hopper card (sm_90a): one damped
// trial of the LM loop,
//
//     x = (H + lam I)^-1 b   (approximately: PCG from x0 = 0)
//
// with H in block form (models/block_system.py): D [N,6,6], Bt [N,K,6,6]
// aligned with nbr [N,K] (-1 padded; padded slots carry zero blocks),
// C [N,6,8] and Hg [8,8]; b and x in the flat tangent layout
// [p1 (3N), p2 (3N), s1, s2, xi (6)].
//
// Replaces the TPU kernel triangulation_in_deformable_scenes_tpu/ops/
// pallas_pcg.py::pcg_block_system (pallas_call at :181). Its contract here is
// the one the JAX package's large-N path runs, block_system.py::pcg_flex over
// block_matvec and block_jacobi_apply (block_system.py:393-443, 464-473):
//
//   r = b, z = M r, p = z, tol2 = rtol^2 (b.b), k = 0
//   while k < iters and r.r > tol2:
//     Ap = (H + lam I) p; rz = r.z; alpha = rz / (p.Ap + TINY)
//     x += alpha p; r -= alpha Ap; z = M r
//     beta = r.z / (rz + TINY); p = z + beta p; k += 1
//
// M is the block-Jacobi preconditioner: the inverse of D_i + lam I per point
// by the equilibrated unrolled Cholesky of block_system.inv6_spd, and the
// inverse of Hg + lam I by the same scheme at size 8 (block_jacobi_apply
// takes an LU inverse there; both invert an SPD block, and they agree to
// rounding).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32). Each iteration reads
// Bt (N K 36 floats: 4.0 MB at N = 861, 12 MB at N = 2600, K = 32) and the
// other blocks once, for ~2 flops per 4 bytes: the matvec is bandwidth-
// shaped. The least time for the whole solve (inputs read once) is a few
// microseconds, far below the latency of the iteration chain, which is what
// this kernel's time measures: every iteration needs two grid-wide sums
// (p.Ap, then r.z and r.r), each a grid barrier and a round trip through L2.
//
// Design: ONE cooperative persistent launch for the whole solve. A warp owns
// a point (grid-stride when the grid holds fewer warps than points); lanes
// 0..5 hold its six components, lane k its neighbour slot k.
//   * Two grid barriers per iteration, one for each sum (grid_barrier, the
//     counting of cooperative_groups' grid.sync() with a release reduction
//     to arrive and acquire loads to wait): every block writes its partial
//     sums (its warps summed in order) to a column-major workspace, and
//     after the barrier warp 0 of every block sums all blocks' partials in
//     block order (float4 loads, then a butterfly) and does the 8-wide work
//     of the global rows on its lanes (lane g: row g of Hg and of Hginv from
//     shared memory, Hg p_g and Hginv r_g by shuffles, each computed before
//     the barrier that needs it), keeping p_g, x_g, r_g, z_g in registers.
//     Every block computes the same alpha, beta and exit test from the same
//     bits in the same order, so all blocks leave the loop at the same
//     iteration; no float atomics, so the result does not depend on
//     scheduling and the LM accept decisions repeat run to run. The
//     prologue's sums are read with the first iteration's.
//   * No p pass: p = z + beta p is formed where it is read. In the matvec
//     each lane forms its neighbour's p_j from z_j and the p_j of the last
//     iteration with the same __fmaf_rn as the owner, and the owner writes
//     its p_i to the other half of a ping-pong pair for the next iteration.
//   * Where the grid holds a warp for every point and K <= 32 (N <= 8 x the
//     co-resident blocks: 2112 points on 132 SMs at 2 blocks each, 3168 at
//     3), the resident kernel keeps a point's r, z, x, Ap, p and its row of
//     Dinv in the owner's registers, its Bt blocks, D and C in shared memory
//     (copied with cp.async while the inverses run) and its neighbours'
//     indices in registers for the whole solve, and fetches the neighbours'
//     z_j and p_j while warp 0 reads the partial sums; beyond that the
//     strided kernel runs the same steps from global memory.
//   * The 6x6 and 8x8 inverses run row-parallel on lanes (inv_spd_rows): the
//     Cholesky by rows, L^-1 by columns, Li^T Li by rows, with the serial
//     code's operations in its order; each warp inverts its point's block
//     and Hg + lam I at once.
// The grid is one block per 8 points, at most the co-resident maximum
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs); a refused
// cooperative launch returns its error code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps per block
constexpr int THREADS = WARPS * 32;
// Blocks per SM that the launch bounds ask registers for: the resident
// kernel takes 2 (no spills) where that holds a warp per point, else 3 (2600
// points on 132 SMs).
constexpr int FEW_BLOCKS = 2, MANY_BLOCKS = 3;
constexpr int VS = 8;          // stride of a packed per-point vector (6 used)
constexpr int NA = 9;          // partial sums after the matvec: C^T p (8), p.Ap
constexpr int NB = 2;          // after the r/z pass: r.z, r.r
constexpr float TINY = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned FLIP = 0x80000000u;     // the grid barrier's generation bit
constexpr unsigned SPIN_LIMIT = 1u << 26;  // polls of the barrier (seconds) before a trap
// Dynamic shared memory of the resident kernel: each thread's Bt block (9
// float4, [9][THREADS] so that a warp's loads are contiguous), then each
// warp's D (36) and C (48).
constexpr int SMEM_BT = 9 * THREADS;                     // float4
constexpr int SMEM_RES = SMEM_BT * 16 + WARPS * 84 * 4;  // bytes

struct Args {
  const float* D;          // [N, 36]
  const float* Bt;         // [N, K, 36]
  const float* C;          // [N, 48]
  const float* Hg;         // [64]
  const long long* nbr;    // [N, K]
  const float* b;          // [6N + 8]
  const float* lam;        // [1]
  float* x;                // [6N + 8] out
  float* Dinv;             // [N, 36] (strided kernel)
  float* r;                // [N, VS] (strided kernel)
  float* Ap;               // [N, VS] (strided kernel)
  float* z;                // [N, VS] z of the last r/z pass, read by neighbours
  float* p0;               // [N, VS] ping-pong: p of the last iteration
  float* p1;
  float* partA;            // [NA, gp] block partials, column-major
  float* partB;            // [NB, gp]
  float* partP;            // [NB, gp] the prologue's r.z, r.r; columns NA, NA + 1 of partA
  unsigned* bar;           // grid barrier counter (zero before the first launch)
  int* iters_out;          // [1]
  long long* iters_total;  // [1]
  long long* stamps;       // [16] phase clocks (timed entry), or null
  int n, K, iters, gp;
  float rtol2;
};

// Phases that thread 0 of block 0 times in the timed entry: SM clock cycles
// spent in each, summed over the solve (stamps[0..5]); stamps[8..11] hold
// the globaltimer (ns) and clock64 at its start and end, so the caller turns
// cycles into ns.
enum { PH_PROLOGUE, PH_MATVEC, PH_PARTIALS, PH_SYNC, PH_SERIAL, PH_RZ, PH_COUNT };

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Clock {
  bool on;
  long long prev;
  long long acc[PH_COUNT];
  __device__ void start(long long* stamps) {
    if (!on) return;
    for (int c = 0; c < PH_COUNT; ++c) acc[c] = 0;
    stamps[8] = (long long)now_ns();
    prev = clock64();
    stamps[10] = prev;
  }
  __device__ __forceinline__ void lap(int c) {
    if (!on) return;
    const long long t = clock64();
    acc[c] += t - prev;
    prev = t;
  }
  __device__ void finish(long long* stamps) {
    if (!on) return;
    const long long t = clock64();
    stamps[9] = (long long)now_ns();
    stamps[11] = t;
    for (int c = 0; c < PH_COUNT; ++c) stamps[c] = acc[c];
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same sum (addition commutes).
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Sum over each group of 8 lanes; every lane of a group ends with the same
// sum. Where it is used, lanes 8..31 hold copies of lanes 0..7.
__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 2);
  v += __shfl_xor_sync(FULL, v, 1);
  return v;
}

template <int M>
__device__ __forceinline__ float pick(const float (&v)[M], int i) {
  float out = v[0];
#pragma unroll
  for (int c = 1; c < M; ++c)
    if (c == i) out = v[c];
  return out;
}

// Row l of (A + lam I)^-1 for SPD 8 x 8 blocks, four at once on one warp:
// lane base + l (base = 0, 8, 16, 24) holds row l of its group's block. The
// steps of inv_spd (block_system.py:335-390): Jacobi equilibration, unrolled
// Cholesky, L^-1 by forward substitution, Li^T Li, spread over the group's
// lanes (the Cholesky by rows, L^-1 by columns, the product by rows) with
// the serial code's operations in its order. A 6 x 6 block padded with two
// unit rows and columns gives its 6 x 6 inverse to the bit: the padding
// adds only zero terms to the first six rows' sums.
__device__ __forceinline__ void inv_spd_rows(const float (&A)[8], float lam, int l, int base, float (&out)[8]) {
  const float sl = rsqrtf(fmaxf(pick(A, l) + lam, TINY));
  float s[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) s[c] = __shfl_sync(FULL, sl, base + c);
  float L[8];  // row l of L: L[c] for c <= l, zero beyond
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float acc = ((A[j] + (j == l ? lam : 0.0f)) * sl) * s[j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc -= L[k] * __shfl_sync(FULL, L[k], base + j);
    const float Ljj = __shfl_sync(FULL, sqrtf(fmaxf(acc, TINY)), base + j);
    L[j] = l < j ? 0.0f : (l == j ? Ljj : acc / Ljj);
  }
  // Column l of Li = L^-1 (Li[i] = Li[i][l], zero above the diagonal): the
  // zero terms k < l leave the serial sum's first product and order as they
  // are.
  const float inv_ll = 1.0f / pick(L, l);
  float Li[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float inv_ii = __shfl_sync(FULL, inv_ll, base + i);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < i; ++k) acc += __shfl_sync(FULL, L[k], base + i) * Li[k];
    Li[i] = i < l ? 0.0f : (i == l ? inv_ii : -acc * inv_ii);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += Li[k] * __shfl_sync(FULL, Li[k], base + c);
    out[c] = (acc * sl) * s[c];
  }
}

// Asynchronous copies global -> shared (cp.async), 16 bytes (zero-filled
// when `full` is false) and 4 bytes; cp_wait() waits for the thread's own.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Position of packed component a (0..5) of point i in the flat layout.
__device__ __forceinline__ size_t flat_index(int i, int a, int n) {
  return a < 3 ? (size_t)3 * i + a : (size_t)3 * n + 3 * i + (a - 3);
}

// The block's partial sums: sh[w][c] (c < nc, one row per warp) summed over
// warps in order into part[c * gp + blockIdx.x].
__device__ __forceinline__ void write_partials(float (*sh)[NA], int nc, float* part, int gp) {
  __syncthreads();
  if (threadIdx.x < nc) {
    float acc = 0.0f;
    for (int w = 0; w < WARPS; ++w) acc += sh[w][threadIdx.x];
    part[(size_t)threadIdx.x * gp + blockIdx.x] = acc;
  }
}

// Every block's partials of NC columns (part[c * gp + b], zero beyond the
// grid) summed on one warp: float4 loads from L2 (all issued before the
// first add), each lane's in order, then the xor butterfly, so every lane
// holds the same totals.
template <int NC>
__device__ __forceinline__ void column_sums(const float* part, int gp, int lane, float (&tot)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) tot[c] = 0.0f;
  for (int b4 = 4 * lane; b4 < gp; b4 += 128) {
    float4 v[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = __ldcg(reinterpret_cast<const float4*>(part + (size_t)c * gp + b4));
#pragma unroll
    for (int c = 0; c < NC; ++c) tot[c] += ((v[c].x + v[c].y) + v[c].z) + v[c].w;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) tot[c] = warp_sum(tot[c]);
}

// Grid-wide barrier of the cooperative launch (all blocks co-resident), as
// cooperative_groups' grid.sync() counts it: block 0 adds 2^31 - (G - 1),
// every other block 1, so the last arrival flips bit 31 and leaves the low
// bits as they were, for the next barrier and the next launch. Thread 0
// arrives with a release reduction, which it need not wait for, and polls
// with acquire loads until the bit differs from the one it saw when it
// passed the last barrier (`bit`); the block's threads follow it through
// __syncthreads. A lost arrival traps instead of hanging the card.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned& bit) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? FLIP - (gridDim.x - 1) : 1u;
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(bar), "r"(add) : "memory");
    unsigned v, spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
      if (++spins == SPIN_LIMIT) __trap();
    } while (((v ^ bit) & FLIP) == 0);
    bit = v & FLIP;
  }
  __syncthreads();
}

// A neighbour's z_j and last p_j (6 each), from L2.
struct Nbr {
  float4 z03, q03;
  float2 z45, q45;
};

__device__ __forceinline__ Nbr load_nbr(const float* z, const float* q, int j) {
  Nbr v;
  v.z03 = __ldcg(reinterpret_cast<const float4*>(z + (size_t)j * VS));
  v.z45 = __ldcg(reinterpret_cast<const float2*>(z + (size_t)j * VS + 4));
  v.q03 = __ldcg(reinterpret_cast<const float4*>(q + (size_t)j * VS));
  v.q45 = __ldcg(reinterpret_cast<const float2*>(q + (size_t)j * VS + 4));
  return v;
}

// acc[r] += sum_c B[r][c] p_j[c] for one neighbour slot, p_j = z_j + beta q_j
// rounded as its owner rounds it; B from 9 float4 (row-major 6 x 6).
template <typename LoadB>
__device__ __forceinline__ void slot_product(const Nbr& nb, float beta, LoadB loadB, float (&acc)[6]) {
  const float v[6] = {__fmaf_rn(beta, nb.q03.x, nb.z03.x), __fmaf_rn(beta, nb.q03.y, nb.z03.y),
                      __fmaf_rn(beta, nb.q03.z, nb.z03.z), __fmaf_rn(beta, nb.q03.w, nb.z03.w),
                      __fmaf_rn(beta, nb.q45.x, nb.z45.x), __fmaf_rn(beta, nb.q45.y, nb.z45.y)};
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const float4 t = loadB(q);
    const float e[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[(4 * q + u) / 6] += e[u] * v[(4 * q + u) % 6];
  }
}

template <bool RES, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) pcg_kernel(Args a) {
  extern __shared__ float4 smem[];  // resident kernel only
  __shared__ float sh[WARPS][NA];
  __shared__ float s_hg[64], s_hgi[64];
  __shared__ float s_pg[8];
  __shared__ float s_alpha, s_beta;
  __shared__ int s_done;

  const int n = a.n, K = a.K, gp = a.gp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * WARPS + warp;
  const int nwarps = gridDim.x * WARPS;
  const float lam = __ldg(a.lam);
  const int la = lane < 6 ? lane : 0;  // component of lanes 0..5; others copy lane 0
  const int lg = lane & 7;             // global row of each group of 8 lanes
  float4* s_bt = smem;                                          // [9][THREADS]
  float* s_dc = reinterpret_cast<float*>(smem + SMEM_BT) + warp * 84;  // D [36], C [48]
  Clock clk;
  clk.on = a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  clk.start(a.stamps);
  // The barrier's generation bit, read before this block arrives anywhere.
  unsigned bit = threadIdx.x == 0 ? *reinterpret_cast<volatile unsigned*>(a.bar) & FLIP : 0u;

  // ---- prologue: preconditioner, r = b, z = M r, p = z -------------------
  if (blockIdx.x == 0) {  // the partial columns' padding beyond the grid
    for (int e = gridDim.x + threadIdx.x; e < gp; e += THREADS) {
      for (int c = 0; c < NA; ++c) a.partA[(size_t)c * gp + e] = 0.0f;
      for (int c = 0; c < NB; ++c) {
        a.partB[(size_t)c * gp + e] = 0.0f;
        a.partP[(size_t)c * gp + e] = 0.0f;
      }
    }
  }
  // Warp 0 keeps the global rows (lane g: row g & 7) for the whole solve.
  float pg = 0.0f, xg = 0.0f, rg = 0.0f, zg = 0.0f, rzg = 0.0f, rrg = 0.0f, hgp = 0.0f, rz = 0.0f, tol2 = 0.0f;
  // The warp's point, lane la's component, and lane k's neighbour slot
  // (resident kernel).
  float m_res[6], r_res = 0.0f, z_res = 0.0f, x_res = 0.0f, p_res = 0.0f, y_res = 0.0f;
  int j_res = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c) m_res[c] = 0.0f;
  float wrz = 0.0f, wrr = 0.0f;
  const int lr = lane & 7, grp = lane >> 3;  // row and group of inv_spd_rows
  for (int i = gwarp; i < n; i += nwarps) {
    // Lanes 8..15 invert Hg + lam I, the other lanes (three copies) the
    // point's D + lam I padded to 8 x 8, all at once. Every load is issued
    // first.
    float arow[8], mrow[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (grp == 1)
        arow[c] = __ldg(a.Hg + lr * 8 + c);
      else
        arow[c] = lr < 6 ? (c < 6 ? __ldg(a.D + (size_t)i * 36 + lr * 6 + c) : 0.0f) : (c == lr ? 1.0f : 0.0f);
    }
    const float ra = __ldg(a.b + flat_index(i, la, n));
    const float bg = __ldg(a.b + (size_t)6 * n + lg);
    const long long jj = RES && lane < K ? __ldg(a.nbr + (size_t)i * K + lane) : -1;
    if (RES) {
      // The copies of the point's Bt blocks, D and C into shared memory land
      // while the inverses run.
      const bool slot = lane < K;
      const float4* B = reinterpret_cast<const float4*>(a.Bt + ((size_t)i * K + (slot ? lane : 0)) * 36);
#pragma unroll
      for (int q = 0; q < 9; ++q) cp16(s_bt + q * THREADS + threadIdx.x, B + q, slot);
      for (int e = lane; e < 84; e += 32)
        cp4(s_dc + e, e < 36 ? a.D + (size_t)i * 36 + e : a.C + (size_t)i * 48 + e - 36);
    }
    inv_spd_rows(arow, lam, lr, lane & 24, mrow);
    if (warp == 0 && i == gwarp) {
      if (grp == 1) {
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          s_hg[lr * 8 + h] = arow[h];
          s_hgi[lr * 8 + h] = mrow[h];
        }
      }
      __syncwarp();
      rg = bg;
#pragma unroll
      for (int h = 0; h < 8; ++h) zg += s_hgi[lg * 8 + h] * __shfl_sync(FULL, rg, h);
      rzg = sum8(rg * zg);
      rrg = sum8(rg * rg);
      pg = zg;
#pragma unroll
      for (int h = 0; h < 8; ++h) hgp += s_hg[lg * 8 + h] * __shfl_sync(FULL, pg, h);
      if (lane < 8) s_pg[lane] = pg;
    }
    float za = 0.0f;
#pragma unroll
    for (int c = 0; c < 6; ++c) za += mrow[c] * __shfl_sync(FULL, ra, c);
    if (lane < 6) {
      a.z[(size_t)i * VS + la] = za;
      a.p0[(size_t)i * VS + la] = 0.0f;
      wrz += ra * za;
      wrr += ra * ra;
    }
    if (RES) {
#pragma unroll
      for (int c = 0; c < 6; ++c) m_res[c] = mrow[c];
      r_res = ra;
      z_res = za;
      j_res = jj < 0 ? 0 : (int)jj;
    } else if (lane < 6) {
#pragma unroll
      for (int c = 0; c < 6; ++c) a.Dinv[(size_t)i * 36 + la * 6 + c] = mrow[c];
      a.r[(size_t)i * VS + la] = ra;
      a.x[flat_index(i, la, n)] = 0.0f;
    }
  }
  if (RES) cp_wait();
  wrz = warp_sum(wrz);
  wrr = warp_sum(wrr);
  if (lane == 0) {
    sh[warp][0] = wrz;
    sh[warp][1] = wrr;
  }
  // The prologue's sums go to their own columns and are read with the first
  // iteration's: the first matvec needs only z and p_g = z_g.
  if (threadIdx.x == 0) s_done = 0;
  write_partials(sh, NB, a.partP, gp);
  clk.lap(PH_PROLOGUE);
  grid_barrier(a.bar, bit);
  clk.lap(PH_SYNC);
  Nbr nb;
  if (RES) nb = load_nbr(a.z, a.p0, j_res);
  float beta = 0.0f;
  int k = 0, cur = 0;

  while (true) {
    const float* pprev = cur ? a.p1 : a.p0;
    float* pnext = cur ? a.p0 : a.p1;
    // ---- Ap = (H + lam I) p; partials of C^T p and p_p . Ap_p ------------
    float wctp = 0.0f, wpap = 0.0f;
    for (int i = gwarp; i < n; i += nwarps) {
      const float zi = RES ? z_res : __ldcg(a.z + (size_t)i * VS + la);
      const float qi = RES ? p_res : __ldcg(pprev + (size_t)i * VS + la);
      const float pa = __fmaf_rn(beta, qi, zi);  // p_i, lane la
      if (lane < 6) pnext[(size_t)i * VS + la] = pa;
      float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (RES) {
        slot_product(nb, beta, [&](int q) { return s_bt[q * THREADS + threadIdx.x]; }, acc);
      } else {
        for (int kk = lane; kk < K; kk += 32) {
          const long long jj = __ldg(a.nbr + (size_t)i * K + kk);
          const float4* B = reinterpret_cast<const float4*>(a.Bt + ((size_t)i * K + kk) * 36);
          slot_product(load_nbr(a.z, pprev, jj < 0 ? 0 : (int)jj), beta, [&](int q) { return __ldg(B + q); },
                       acc);
        }
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[r] = warp_sum(acc[r]);
      float y = pick(acc, la);
      float pv[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) pv[c] = __shfl_sync(FULL, pa, c);
      const float* Dr = RES ? s_dc + la * 6 : a.D + (size_t)i * 36 + la * 6;
      const float* Cm = RES ? s_dc + 36 : a.C + (size_t)i * 48;
#pragma unroll
      for (int c = 0; c < 6; ++c) y += Dr[c] * pv[c];
#pragma unroll
      for (int g = 0; g < 8; ++g) y += Cm[la * 8 + g] * s_pg[g];
      y += lam * pa;
      if (lane < 6) wpap += pa * y;
      if (lane < 8) {
        float ct = 0.0f;
#pragma unroll
        for (int c = 0; c < 6; ++c) ct += Cm[c * 8 + lane] * pv[c];
        wctp += ct;
      }
      if (RES) {
        p_res = pa;
        y_res = y;
      } else if (lane < 6) {
        a.Ap[(size_t)i * VS + la] = y;
      }
    }
    wpap = warp_sum(wpap);
    clk.lap(PH_MATVEC);
    if (lane < 8) sh[warp][lane] = wctp;
    if (lane == 0) sh[warp][8] = wpap;
    write_partials(sh, NA, a.partA, gp);
    clk.lap(PH_PARTIALS);
    grid_barrier(a.bar, bit);
    clk.lap(PH_SYNC);

    // ---- warp 0: Ap_g = C^T p + Hg p_g + lam p_g, alpha, x_g, r_g --------
    // (in the first iteration also rz, tol2 and the exit test from the
    // prologue's sums)
    if (warp == 0) {
      float t[NA + NB];
      bool stop = false;
      if (k == 0) {  // partA and partP in one round of loads
        column_sums<NA + NB>(a.partA, gp, lane, t);
        rz = t[NA] + rzg;
        const float rr = t[NA + 1] + rrg;
        tol2 = a.rtol2 * rr;
        stop = !(0 < a.iters && rr > tol2);
      } else {
        column_sums<NA>(a.partA, gp, lane, reinterpret_cast<float(&)[NA]>(t));
      }
      clk.lap(PH_PARTIALS);
      const float apg = (pick(reinterpret_cast<const float(&)[8]>(t), lg) + hgp) + lam * pg;
      const float pap = t[NA - 1] + sum8(pg * apg);
      const float alpha = rz / (pap + TINY);
      if (!stop) {
        xg = xg + alpha * pg;
        rg = rg - alpha * apg;
      }
      if (lane == 0) {
        s_alpha = alpha;
        s_done = stop;
      }
    }
    __syncthreads();
    clk.lap(PH_SERIAL);
    if (s_done) break;  // only at k = 0, when b is within the tolerance: x = 0
    const float alpha = s_alpha;

    // ---- x += alpha p; r -= alpha Ap; z = M r; partials of r.z, r.r ------
    wrz = 0.0f;
    wrr = 0.0f;
    for (int i = gwarp; i < n; i += nwarps) {
      float pa, ya, rold, mrow[6];
      if (RES) {
        pa = p_res;
        ya = y_res;
        rold = r_res;
#pragma unroll
        for (int c = 0; c < 6; ++c) mrow[c] = m_res[c];
      } else {
        pa = __ldcg(pnext + (size_t)i * VS + la);
        ya = __ldcg(a.Ap + (size_t)i * VS + la);
        rold = __ldcg(a.r + (size_t)i * VS + la);
#pragma unroll
        for (int c = 0; c < 6; ++c) mrow[c] = __ldcg(a.Dinv + (size_t)i * 36 + la * 6 + c);
      }
      const float ra = rold - alpha * ya;
      float za = 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) za += mrow[c] * __shfl_sync(FULL, ra, c);
      if (lane < 6) {
        a.z[(size_t)i * VS + la] = za;
        wrz += ra * za;
        wrr += ra * ra;
      }
      if (RES) {
        x_res = x_res + alpha * pa;
        r_res = ra;
        z_res = za;
      } else if (lane < 6) {
        const size_t f = flat_index(i, la, n);
        a.x[f] = a.x[f] + alpha * pa;
        a.r[(size_t)i * VS + la] = ra;
      }
    }
    wrz = warp_sum(wrz);
    wrr = warp_sum(wrr);
    if (warp == 0) {  // z_g = Hginv r_g and its dots, before the sync
      zg = 0.0f;
#pragma unroll
      for (int h = 0; h < 8; ++h) zg += s_hgi[lg * 8 + h] * __shfl_sync(FULL, rg, h);
      rzg = sum8(rg * zg);
      rrg = sum8(rg * rg);
    }
    clk.lap(PH_RZ);
    if (lane == 0) {
      sh[warp][0] = wrz;
      sh[warp][1] = wrr;
    }
    write_partials(sh, NB, a.partB, gp);
    clk.lap(PH_PARTIALS);
    grid_barrier(a.bar, bit);
    clk.lap(PH_SYNC);

    // ---- warp 0: rz, beta, the exit test, the next p_g and Hg p_g --------
    if (RES) nb = load_nbr(a.z, pnext, j_res);  // the next iteration's z_j and last p_j
    ++k;
    if (warp == 0) {
      float t[NB];
      column_sums<NB>(a.partB, gp, lane, t);
      clk.lap(PH_PARTIALS);
      const float rz_new = t[0] + rzg;
      const float rr = t[1] + rrg;
      const float b_ = rz_new / (rz + TINY);
      rz = rz_new;
      pg = __fmaf_rn(b_, pg, zg);
      if (lane < 8) s_pg[lane] = pg;
      if (lane == 0) {
        s_beta = b_;
        s_done = !(k < a.iters && rr > tol2);
      }
    }
    __syncthreads();
    clk.lap(PH_SERIAL);
    if (s_done) break;
    beta = s_beta;
    cur ^= 1;
    if (warp == 0) {  // Hg p_g of the next iteration, off the path after its sync
      hgp = 0.0f;
#pragma unroll
      for (int h = 0; h < 8; ++h) hgp += s_hg[lg * 8 + h] * __shfl_sync(FULL, pg, h);
    }
  }

  if (RES && gwarp < n && lane < 6) a.x[flat_index(gwarp, la, n)] = x_res;
  if (blockIdx.x == 0 && warp == 0) {
    if (lane < 8) a.x[(size_t)6 * n + lane] = xg;
    if (lane == 0) {
      a.iters_out[0] = k;
      a.iters_total[0] += k;
    }
  }
  clk.finish(a.stamps);
}

struct Grid {
  int blocks;
  bool resident;
  const void* kernel;
};

// The launch's grid: one block per 8 points when that many are co-resident
// and K <= 32 (the resident kernel, at 2 blocks an SM where they suffice),
// else the co-resident maximum (the strided kernel).
Grid grid_for(int n, int K, int* err) {
  static int cached_dev = -1, cap_few = 0, cap_many = 0, cap_str = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != cached_dev) {
    int sms = 0, per_few = 0, per_many = 0, per_str = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_few, pcg_kernel<true, FEW_BLOCKS>, THREADS, SMEM_RES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_many, pcg_kernel<true, MANY_BLOCKS>, THREADS, SMEM_RES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_str, pcg_kernel<false, MANY_BLOCKS>, THREADS, 0);
    if (e == cudaSuccess) {
      cached_dev = dev;
      cap_few = sms * per_few;
      cap_many = sms * per_many;
      cap_str = sms * per_str;
    }
  }
  *err = (int)e;
  const int want = (n + WARPS - 1) / WARPS;
  if (K <= 32 && want <= cap_few) return Grid{want, true, (const void*)pcg_kernel<true, FEW_BLOCKS>};
  if (K <= 32 && want <= cap_many) return Grid{want, true, (const void*)pcg_kernel<true, MANY_BLOCKS>};
  return Grid{want < cap_str ? want : cap_str, false, (const void*)pcg_kernel<false, MANY_BLOCKS>};
}

int padded(int blocks) { return (blocks + 3) / 4 * 4; }

// Workspace layout (floats) for N points on a grid of `blocks`.
struct Layout {
  size_t dinv, r, ap, z, p0, p1, partA, partB, partP, bar, total;
};

Layout layout(int n, int blocks) {
  Layout L;
  const size_t nv = (size_t)n * VS;
  const int gp = padded(blocks);
  L.dinv = 0;
  L.r = L.dinv + (size_t)n * 36;
  L.ap = L.r + nv;
  L.z = L.ap + nv;
  L.p0 = L.z + nv;
  L.p1 = L.p0 + nv;
  L.partA = L.p1 + nv;
  L.partP = L.partA + (size_t)NA * gp;  // right after partA: read with it at k = 0
  L.partB = L.partP + (size_t)NB * gp;
  L.bar = (L.partB + (size_t)NB * gp + 31) / 32 * 32;  // a 128-byte line of its own
  L.total = L.bar + 32;
  return L;
}

int launch(const float* D, const float* Bt, const float* C, const float* Hg, const long long* nbr,
           const float* b, const float* lam, float* x, int n, int K, int iters, float rtol2, float* ws,
           int* iters_out, long long* iters_total, long long* stamps, void* stream_ptr) {
  int err = 0;
  const Grid g = grid_for(n, K, &err);
  if (err != 0) return err;
  if (g.blocks <= 0) return (int)cudaErrorInvalidValue;
  const Layout L = layout(n, g.blocks);
  Args a;
  a.D = D;
  a.Bt = Bt;
  a.C = C;
  a.Hg = Hg;
  a.nbr = nbr;
  a.b = b;
  a.lam = lam;
  a.x = x;
  a.Dinv = ws + L.dinv;
  a.r = ws + L.r;
  a.Ap = ws + L.ap;
  a.z = ws + L.z;
  a.p0 = ws + L.p0;
  a.p1 = ws + L.p1;
  a.partA = ws + L.partA;
  a.partB = ws + L.partB;
  a.partP = ws + L.partP;
  a.bar = reinterpret_cast<unsigned*>(ws + L.bar);
  a.iters_out = iters_out;
  a.iters_total = iters_total;
  a.stamps = stamps;
  a.n = n;
  a.K = K;
  a.iters = iters;
  a.gp = padded(g.blocks);
  a.rtol2 = rtol2;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(g.kernel, dim3(g.blocks), dim3(THREADS), args,
                                              g.resident ? SMEM_RES : 0, static_cast<cudaStream_t>(stream_ptr));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Workspace floats for N points and K neighbour slots (negative: a CUDA
// error). The caller zeroes it before its first use (it holds the grid
// barrier's counter); any solve of that size on the same device may then
// reuse it, one at a time.
long long tids_pcg_workspace_floats(int n, int K) {
  int err = 0;
  const Grid g = grid_for(n, K, &err);
  if (err != 0) return -(long long)err;
  return (long long)layout(n, g.blocks).total;
}

// Blocks of the cooperative grid for N points and K slots (negative: a CUDA
// error).
int tids_pcg_grid(int n, int K) {
  int err = 0;
  const Grid g = grid_for(n, K, &err);
  return err != 0 ? -err : g.blocks;
}

// 1 if N points with K slots run on the resident kernel (a warp per point,
// its state in registers and shared memory), 0 on the strided one,
// negative on a CUDA error.
int tids_pcg_resident(int n, int K) {
  int err = 0;
  const Grid g = grid_for(n, K, &err);
  return err != 0 ? -err : (int)g.resident;
}

// x [6N + 8] = PCG solve of (H + lam I) x = b on `stream`; iters_out [1]
// receives the iterations taken and iters_total [1] is increased by them.
// All pointers are device pointers (nbr int64, lam one float, ws as
// tids_pcg_workspace_floats says). Returns the cudaError_t of the launch
// (0 on success).
int tids_pcg_solve(const float* D, const float* Bt, const float* C, const float* Hg,
                   const long long* nbr, const float* b, const float* lam, float* x, int n, int K,
                   int iters, float rtol2, float* ws, int* iters_out, long long* iters_total,
                   void* stream_ptr) {
  return launch(D, Bt, C, Hg, nbr, b, lam, x, n, K, iters, rtol2, ws, iters_out, iters_total, nullptr,
                stream_ptr);
}

// The same launch, with thread 0 of block 0 writing its phase clocks into
// stamps [16] (see Clock).
int tids_pcg_solve_timed(const float* D, const float* Bt, const float* C, const float* Hg,
                         const long long* nbr, const float* b, const float* lam, float* x, int n, int K,
                         int iters, float rtol2, float* ws, int* iters_out, long long* iters_total,
                         long long* stamps, void* stream_ptr) {
  return launch(D, Bt, C, Hg, nbr, b, lam, x, n, K, iters, rtol2, ws, iters_out, iters_total, stamps,
                stream_ptr);
}

}  // extern "C"
