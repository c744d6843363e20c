// Damped, Jacobi-equilibrated Cholesky solve with one refinement step, for
// one dense system on an NVIDIA Hopper card (sm_90a):
//
//     x = -(H + lam I)^-1 g
//
// Replaces the TPU kernel triangulation_in_deformable_scenes_tpu/ops/
// pallas_cholesky.py::damped_solve_pallas (pallas_call at :265). The contract
// is ops/lm.py::solve_damped_cholesky (lm.py:43-60) of that package:
//
//   1. A = H + lam I,  s = rsqrt(max(diag A, 1e-30))
//   2. As = s A s
//   3. blocked right-looking Cholesky As = L L^T
//   4. x0 = s * solve(-g * s)
//   5. x  = x0 + s * solve((-g - A x0) * s)   -- against the UNFACTORED A
//
// Unlike the Pallas kernel, which factored in place to fit 16 MB of VMEM and
// rebuilt A x0 from the factor, the factor goes into a separate workspace
// and step 5 reads H itself. A non-positive pivot is not clamped: sqrtf of a
// non-positive number gives NaN or 0 and the division by it spreads
// non-finite values to the output, so the LM loop rejects the trial as it
// does after jax.scipy cho_factor.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s):
// the factorization is dim^3/3 FMA-counted flops -- at dim 1448 about
// 1.0 GFLOP against 8.4 MB of H read, so the solve is compute-bound at about
// 15 us; at 4096 about 23 GFLOP, 0.34 ms; at 728 about 0.13 GFLOP, 2 us.
// What decides the time instead is the chain of dim/32 dependent panels and
// the three triangular solves left after the factorization, each a chain of
// dim/32 dependent steps in one block.
//
// Design: ONE cooperative persistent launch per solve (grid = the
// co-resident maximum, two blocks of 256 threads per SM, or one block per
// lower tile if that is fewer), phases separated by grid.sync(). The dim is
// padded to a multiple of T = 32 (identity on the padded diagonal, zero
// right-hand side, so padded solution rows are exactly 0).
//   * set-up: s and b = -g s; the lower tiles of s A s into the workspace
//     (each tile recomputes its own 64 scales, which saves a sync). H is
//     read with an evict-first hint here and in the residual, so that at
//     dim 2591 it does not push the factor out of the 50 MB L2.
//   * phase c = 0..NB-1, ONE grid.sync() each (lookahead): the blocks of
//     column c (one per tile (i, c), i >= c) apply panel c-1 to their tile
//     and to the diagonal tile (c, c), each factor and invert that diagonal
//     tile in ONE WARP, in registers (lane r holds row r; the pivot by
//     __shfl_sync, the column by shared-memory broadcasts; lane q then forms
//     column q of Linv_c), so no block waits for another; then L_ic =
//     A_ic Linv_c^T, written to the lower tile and transposed into the upper
//     tile (c, i), which the factor does not otherwise use. The forward solve
//     of the first right-hand side rides along: y_c = Linv_c b_c, and the
//     block of row i does b_i -= L_ic y_c. Meanwhile the other blocks apply
//     panel c-1 to the trailing tiles A_ij -= L_i,c-1 L_j,c-1^T (c < j <= i):
//     both panel tiles staged in padded shared memory by cp.async, the next
//     job's while this one computes, each thread a 2x2 register micro-tile
//     from 16-byte shared-memory reads.
//   * the triangular solves in one block (block 0; the others wait at the
//     next sync),
//     right-looking over 32-row blocks with the right-hand side in shared
//     memory: row block k of the workspace holds L[k, 0:k] left of the
//     diagonal and L[k+1:, k]^T right of it, so the forward solve reads the
//     right part and the backward solve the left part, both as coalesced
//     columns. The diagonal blocks go through the stored inverses (as the
//     Pallas kernel does); the next inverse comes by cp.async and the first
//     two rows' strips into registers before each step's barrier.
//   * x0 = s L^-T y (block 0); the refinement residual (-g - A x0) s, one
//     warp per row over all blocks, between two grid.sync(); then the second
//     forward and backward solves.
//   * a batch of B systems of one dim (tids_damped_solve_batched; the JAX
//     package vmaps the contract over the serving path's pairs,
//     models/deformable.py:884 there) is ONE launch of the same phases: the
//     batch is the outer index of every job (rows, tiles, column and
//     trailing jobs are numbered over (system, tile)), the grid is one block
//     per lower tile of the batch up to the co-resident maximum, the
//     triangular solves of system k run in block k mod G, and each system
//     has its own workspace. No job overwrites a tile that another job of
//     its phase reads (the diagonal tile keeps A_cc), so a batch whose
//     column jobs outnumber the blocks runs them in rounds safely. Each
//     tile job rounds as in the single launch,
//     which is B = 1, so every member's x is the single launch's bit for
//     bit. Single launches of B systems queue one behind another (each
//     takes the whole co-resident grid from dim 728 up); the batch fills
//     one panel chain with B times the work instead.
// Every block reaches every grid.sync(): there is no data-dependent exit, so
// a NaN pivot gives NaN output and no hang. No atomics, every sum in a fixed
// order: repeated calls give bit-identical output. f32 FMA only, no tensor
// cores (TF32 would break the accuracy held on the main path's systems).
// Every operation rounds as in the multi-launch version of this kernel
// (two launches per panel), so the results are the same bit for bit and
// the LM loops take the same accept decisions.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W; CUDA events around
// one solve, median of 30): 0.169 / 0.327 / 0.347 / 0.712 / 1.708 / 5.255 ms
// at dims 377 / 728 / 746 / 1448 / 2591 / 4096, against 0.518 / 0.990 /
// 1.038 / 2.240 / 5.107 / 11.631 ms for the multi-launch version and 0.220 /
// 0.397 / 0.405 / 0.726 / 1.426 / 2.499 ms for torch's cholesky_ex +
// cholesky_solve. At 2591 (chip_diagnostics.py chol_profile) the
// factorization takes 0.99 ms (12.2 us per panel) and the three solves in
// one block 0.61 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int T = 32;                  // tile edge
constexpr int THREADS = 256;           // threads per block
constexpr int TS = T + 4;              // shared row stride of a staged tile: 16-byte rows, no conflicts
constexpr int TILE = T * TS;           // floats of one staged tile
constexpr int FACTOR_FLOATS = 7 * TILE + T * T;  // P0 Q0 P1 Q1 Tb Lr Inv, LsT
constexpr float TINY = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;

// B systems of one dim n; system k's arrays start at k times the stride of
// each (the vectors s, b, y, x0 at k * vstride).
struct Args {
  const float* H;   // [B, n, n]
  const float* g;   // [B, n]
  const float* lam; // [B]
  float* x;         // [B, n] out
  float* L;         // [B, npad, npad] workspace: lower tiles L, upper tiles L^T (not the diagonal tiles)
  float* Linv;      // [B, NB, T, T] inverses of the diagonal tiles
  float* s;         // [npad] scales
  float* b;         // [npad] right-hand side
  float* y;         // [npad] last forward solve
  float* x0;        // [npad] unrefined solution
  unsigned long long* stamps;  // [6] phase ends (globaltimer ns), or null
  int n, npad, NB, B;
  long long vstride;
};

// System k of the batch: its arrays and its damping.
struct Sys {
  const float* H;
  const float* g;
  float lam;
  float* x;
  float* L;
  float* Linv;
  float* s;
  float* b;
  float* y;
  float* x0;
};

__device__ __forceinline__ Sys system_of(const Args& a, int k) {
  const size_t nn = (size_t)a.n * a.n, pp = (size_t)a.npad * a.npad, v = (size_t)k * (size_t)a.vstride;
  return Sys{a.H + k * nn, a.g + (size_t)k * a.n, a.lam[k], a.x + (size_t)k * a.n, a.L + k * pp,
             a.Linv + (size_t)k * a.npad * T, a.s + v, a.b + v, a.y + v, a.x0 + v};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Row `row` of system a's refinement residual b = (-g - (H + lam I) x0) s,
// by one warp (lane: the thread's lane).
__device__ __forceinline__ void residual_row(const Sys& a, int n, int row, int lane) {
  if (row >= n) {
    if (lane == 0) a.b[row] = 0.0f;
    return;
  }
  const float lam = a.lam;
  const float* h = a.H + (size_t)row * n;
  float acc = 0.0f;
  for (int j = lane; j < n; j += 32) acc += __ldcs(h + j) * __ldcg(a.x0 + j);
  acc = warp_sum(acc);
  if (lane == 0) a.b[row] = (-a.g[row] - (acc + lam * __ldcg(a.x0 + row))) * __ldcg(a.s + row);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// t -> (i, j), j <= i, in row order of a lower triangle.
__device__ __forceinline__ void tri_index(int t, int& i, int& j) {
  int r = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  i = r;
  j = t - r * (r + 1) / 2;
}

// Start the copy of a 32x32 tile (row stride `stride` floats) into shared
// memory at stride TS: one 16-byte piece per thread.
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int stride) {
  const int r = threadIdx.x >> 3, q = threadIdx.x & 7;
  cp_async16(dst + r * TS + 4 * q, src + (size_t)r * stride + 4 * q);
}

// This thread's 2x2 micro-tile: rows ty, ty+16 and columns tx, tx+16.
__device__ __forceinline__ int thread_row() { return threadIdx.x >> 4; }
__device__ __forceinline__ int thread_col() { return threadIdx.x & 15; }

// acc[a][b] = sum_m P[ty + 16a][m] Q[tx + 16b][m], summed in m order.
__device__ __forceinline__ void tile_dot(const float* P, const float* Q, float acc[2][2]) {
  const int ty = thread_row(), tx = thread_col();
  acc[0][0] = acc[0][1] = acc[1][0] = acc[1][1] = 0.0f;
#pragma unroll
  for (int q = 0; q < T / 4; ++q) {
    const float4 p[2] = {*reinterpret_cast<const float4*>(P + ty * TS + 4 * q),
                         *reinterpret_cast<const float4*>(P + (ty + 16) * TS + 4 * q)};
    const float4 w[2] = {*reinterpret_cast<const float4*>(Q + tx * TS + 4 * q),
                         *reinterpret_cast<const float4*>(Q + (tx + 16) * TS + 4 * q)};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        acc[u][v] = fmaf(p[u].x, w[v].x, acc[u][v]);
        acc[u][v] = fmaf(p[u].y, w[v].y, acc[u][v]);
        acc[u][v] = fmaf(p[u].z, w[v].z, acc[u][v]);
        acc[u][v] = fmaf(p[u].w, w[v].w, acc[u][v]);
      }
    }
  }
}

// a / b rounded as IEEE division rounds it, from y = the correctly rounded
// 1 / b: one correction step (Markstein) is exact for operands away from
// overflow and underflow, and has no slow-path branch, unlike division.
__device__ __forceinline__ float div_by(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

// One warp: Cholesky factor of the 32x32 tile whose row `lane` is in a[]
// (lower triangle read only), then its inverse. Leaves L_kk row-major in Lr
// (zeros above the diagonal) and Linv_k row-major in Inv (both stride TS).
// Step j broadcasts the pivot by shuffle and column j of L through LsT
// (row j of L^T), read as 16-byte broadcasts. Every index is a compile-time
// constant after unrolling, so a[] and x[] stay in registers. Each step
// rounds as the multi-launch version of this kernel did (l = a / l_jj and
// Linv's quotients rounded as by IEEE division, the product l_r l_c rounded
// before it is subtracted), so that the LM paths take the same accept
// decisions as with it. ldiag/lrcp receive l_jj and its reciprocal.
__device__ __forceinline__ void factor_diag(float (&a)[T], float* Lr, float* LsT, float* ldiag, float* lrcp,
                                            float* Inv) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float ljj = sqrtf(__shfl_sync(FULL, a[j], j));
    const float rj = __frcp_rn(ljj);
    const float l = lane < j ? 0.0f : (lane == j ? ljj : div_by(a[j], ljj, rj));
    a[j] = l;
    LsT[j * T + lane] = l;
    if (lane == 0) {
      ldiag[j] = ljj;
      lrcp[j] = rj;
    }
    __syncwarp();
#pragma unroll
    for (int q = (j + 1) / 4; q < T / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(LsT + j * T + 4 * q);
      if (4 * q + 0 > j) a[4 * q + 0] -= __fmul_rn(l, v.x);
      if (4 * q + 1 > j) a[4 * q + 1] -= __fmul_rn(l, v.y);
      if (4 * q + 2 > j) a[4 * q + 2] -= __fmul_rn(l, v.z);
      if (4 * q + 3 > j) a[4 * q + 3] -= __fmul_rn(l, v.w);
    }
  }
#pragma unroll
  for (int q = 0; q < T / 4; ++q)
    *reinterpret_cast<float4*>(Lr + lane * TS + 4 * q) = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  __syncwarp();
  // Column `lane` of L^-1 by forward substitution: x[r] = (e_r - L[r, :r] x[:r]) / L[r][r].
  float x[T];
#pragma unroll
  for (int r = 0; r < T; ++r) {
    float acc = lane == r ? 1.0f : 0.0f;
#pragma unroll
    for (int q = 0; q < (r + 3) / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(Lr + r * TS + 4 * q);
      if (4 * q + 0 < r) acc = fmaf(-v.x, x[4 * q + 0], acc);
      if (4 * q + 1 < r) acc = fmaf(-v.y, x[4 * q + 1], acc);
      if (4 * q + 2 < r) acc = fmaf(-v.z, x[4 * q + 2], acc);
      if (4 * q + 3 < r) acc = fmaf(-v.w, x[4 * q + 3], acc);
    }
    x[r] = div_by(acc, ldiag[r], lrcp[r]);
  }
#pragma unroll
  for (int r = 0; r < T; ++r) Inv[r * TS + lane] = x[r];
}

// 32 values of column `r` of row block k: M[(kT + c) * npad + r], c = 0..31.
__device__ __forceinline__ void load_strip(float (&v)[T], const float* col, int npad) {
#pragma unroll
  for (int c = 0; c < T; ++c) v[c] = __ldcg(col + (size_t)c * npad);
}

__device__ __forceinline__ float dot_strip(const float (&v)[T], const float* vk) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < T; ++c) acc = fmaf(v[c], vk[c], acc);
  return acc;
}

// The same dot product summed in groups of four, as the multi-launch
// version of this kernel summed its forward solve (the same rounding).
__device__ __forceinline__ float dot_strip4(const float (&v)[T], const float* vk) {
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < T / 4; ++q)
    acc += v[4 * q] * vk[4 * q] + v[4 * q + 1] * vk[4 * q + 1] + v[4 * q + 2] * vk[4 * q + 2] +
           v[4 * q + 3] * vk[4 * q + 3];
  return acc;
}

// ys <- L^-1 ys (FWD) or L^-T ys, in place in shared memory, by this block
// alone. Step k: v_k = Linv_k ys_k (or Linv_k^T ys_k); then every row r
// still to come subtracts sum_c W[kT + c][r] v_k[c], W the workspace, whose
// row block k holds L[k+1:, k]^T right of the diagonal (forward) and
// L[k, 0:k] left of it (backward).
template <bool FWD>
__device__ void substitute(const Sys& a, int npad, int NB, float* ys, float* lbuf, float* vk) {
  const int tid = threadIdx.x;
  const int first = FWD ? 0 : NB - 1;
  stage_tile(lbuf + (first & 1) * TILE, a.Linv + (size_t)first * T * T, T);
  cp_async_commit();
  for (int step = 0; step < NB; ++step) {
    const int k = FWD ? step : NB - 1 - step;
    const int kn = FWD ? k + 1 : k - 1;
    if (step + 1 < NB) stage_tile(lbuf + (kn & 1) * TILE, a.Linv + (size_t)kn * T * T, T);
    cp_async_commit();
    const int lo = FWD ? (k + 1) * T : 0, hi = FWD ? npad : k * T;
    const float* blk = a.L + (size_t)k * T * npad;
    const int r0 = lo + tid, r1 = r0 + THREADS;
    float v0[T], v1[T];
    if (r0 < hi) load_strip(v0, blk + r0, npad);
    if (r1 < hi) load_strip(v1, blk + r1, npad);
    cp_async_wait<1>();
    __syncthreads();  // Linv_k staged; the previous step's rows done
    if (tid < T) {
      const float* li = lbuf + (k & 1) * TILE;
      float acc = 0.0f;
      if (FWD) {
#pragma unroll
        for (int q = 0; q < T / 4; ++q) {
          const float4 w = *reinterpret_cast<const float4*>(li + tid * TS + 4 * q);
          const float4 z = *reinterpret_cast<const float4*>(ys + k * T + 4 * q);
          acc = fmaf(w.x, z.x, acc);
          acc = fmaf(w.y, z.y, acc);
          acc = fmaf(w.z, z.z, acc);
          acc = fmaf(w.w, z.w, acc);
        }
      } else {
#pragma unroll
        for (int m = 0; m < T; ++m) acc = fmaf(li[m * TS + tid], ys[k * T + m], acc);
      }
      vk[tid] = acc;
    }
    __syncthreads();
    if (tid < T) ys[k * T + tid] = vk[tid];
    if (r0 < hi) ys[r0] -= FWD ? dot_strip4(v0, vk) : dot_strip(v0, vk);
    if (r1 < hi) ys[r1] -= FWD ? dot_strip4(v1, vk) : dot_strip(v1, vk);
    for (int r = r1 + THREADS; r < hi; r += 2 * THREADS) {
      const int r2 = r + THREADS;
      load_strip(v0, blk + r, npad);
      if (r2 < hi) load_strip(v1, blk + r2, npad);
      ys[r] -= FWD ? dot_strip4(v0, vk) : dot_strip(v0, vk);
      if (r2 < hi) ys[r2] -= FWD ? dot_strip4(v1, vk) : dot_strip(v1, vk);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2) damped_solve_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  __shared__ float sc[2 * T];
  __shared__ float ldiag[T], lrcp[T];
  __shared__ __align__(16) float vk[T];
  __shared__ float bc[T], yc[T];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x, n = a.n, npad = a.npad, NB = a.NB, B = a.B;
  const int ntri = NB * (NB + 1) / 2;
  const bool stamp = a.stamps != nullptr && blockIdx.x == 0 && tid == 0;
  if (stamp) a.stamps[0] = now_ns();

  // ---- set-up: s, b = -g s, lower tiles of s (H + lam I) s ------------------
  // Jobs run over (system, row) and (system, tile) of the whole batch.
  for (int e = blockIdx.x * THREADS + tid; e < B * npad; e += G * THREADS) {
    const int k = e / npad, i = e - k * npad;
    const Sys S = system_of(a, k);
    if (i < n) {
      const float si = rsqrtf(fmaxf(__ldcs(S.H + (size_t)i * n + i) + S.lam, TINY));
      S.s[i] = si;
      S.b[i] = -S.g[i] * si;
    } else {
      S.s[i] = 1.0f;
      S.b[i] = 0.0f;
    }
  }
  for (int t = blockIdx.x; t < B * ntri; t += G) {
    const int k = t / ntri;
    const Sys S = system_of(a, k);
    int bi, bj;
    tri_index(t - k * ntri, bi, bj);
    if (tid < 2 * T) {
      const int idx = (tid < T ? bi : bj) * T + (tid & (T - 1));
      sc[tid] = idx < n ? rsqrtf(fmaxf(__ldcs(S.H + (size_t)idx * n + idx) + S.lam, TINY)) : 1.0f;
    }
    __syncthreads();
    for (int e = tid; e < T * T; e += THREADS) {
      const int r = e / T, c = e % T, i = bi * T + r, j = bj * T + c;
      float v;
      if (i < n && j < n) {
        v = ((__ldcs(S.H + (size_t)i * n + j) + (i == j ? S.lam : 0.0f)) * sc[r]) * sc[T + c];
      } else {
        v = (i == j) ? 1.0f : 0.0f;
      }
      S.L[(size_t)i * npad + j] = v;
    }
    __syncthreads();
  }
  grid.sync();
  if (stamp) a.stamps[1] = now_ns();

  // ---- blocked Cholesky with lookahead, and y = L^-1 b alongside -----------
  // Phase c (one grid.sync each, for the whole batch): the blocks of column
  // c of every system apply panel c-1 to their tile and to the diagonal
  // tile (c, c), factor and invert that, and form their panel tile L_ic and
  // b_i -= L_ic y_c; the other blocks apply panel c-1 to the trailing tiles
  // (i, j), c < j <= i, of every system.
  float* const P0 = smem;
  float* const Q0 = smem + TILE;
  float* const P1 = smem + 2 * TILE;
  float* const Q1 = smem + 3 * TILE;
  float* const Tb = smem + 4 * TILE;
  float* const Lr = smem + 5 * TILE;
  float* const Inv = smem + 6 * TILE;
  float* const LsT = smem + 7 * TILE;
  const int ty = thread_row(), tx = thread_col();
  for (int c = 0; c < NB; ++c) {
    const size_t cc = (size_t)c * T, kk = cc - T;  // kk: column of panel c-1
    const int ncol = NB - c;                       // column jobs of a system: tiles (c + t, c)
    const int ncols = B * ncol;
    for (int job = blockIdx.x; job < ncols; job += G) {
      const int k = job / ncol, t = job - k * ncol;
      const Sys S = system_of(a, k);
      const size_t i0 = cc + (size_t)t * T;
      // P0 = L_{c,c-1}, Q0 = L_{i,c-1}, Q1 = A_cc, P1 = A_ic
      if (c > 0) {
        stage_tile(P0, S.L + cc * npad + kk, npad);
        if (t > 0) stage_tile(Q0, S.L + i0 * npad + kk, npad);
      }
      stage_tile(Q1, S.L + cc * npad + cc, npad);
      if (t > 0) stage_tile(P1, S.L + i0 * npad + cc, npad);
      cp_async_commit();
      if (tid < T) bc[tid] = __ldcg(S.b + cc + tid);
      cp_async_wait<0>();
      __syncthreads();
      if (c > 0) {
        float acc[2][2];
        tile_dot(P0, P0, acc);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) Q1[(ty + 16 * u) * TS + tx + 16 * v] -= acc[u][v];
        if (t > 0) {
          tile_dot(Q0, P0, acc);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 2; ++v) P1[(ty + 16 * u) * TS + tx + 16 * v] -= acc[u][v];
        }
        __syncthreads();
      }
      if (warp == 0) {
        float r[T];
#pragma unroll
        for (int q = 0; q < T / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(Q1 + lane * TS + 4 * q);
          r[4 * q] = v.x;
          r[4 * q + 1] = v.y;
          r[4 * q + 2] = v.z;
          r[4 * q + 3] = v.w;
        }
        factor_diag(r, Lr, LsT, ldiag, lrcp, Inv);
        __syncwarp();
        float acc = 0.0f;  // y_c = Linv_c b_c
#pragma unroll
        for (int q = 0; q < T / 4; ++q) {
          const float4 w = *reinterpret_cast<const float4*>(Inv + lane * TS + 4 * q);
          acc = fmaf(w.x, bc[4 * q], acc);
          acc = fmaf(w.y, bc[4 * q + 1], acc);
          acc = fmaf(w.z, bc[4 * q + 2], acc);
          acc = fmaf(w.w, bc[4 * q + 3], acc);
        }
        yc[lane] = acc;
      }
      __syncthreads();
      if (t == 0) {
        // Only Linv_c leaves the block: the diagonal tile keeps A_cc, which
        // the other column jobs of this system read in this phase (in a
        // batch with more column jobs than blocks, some of them after this
        // one); no later phase and no solve reads L_cc.
        for (int e = tid; e < T * T; e += THREADS) S.Linv[cc * T + e] = Inv[(e / T) * TS + e % T];
        if (tid < T) S.y[cc + tid] = yc[tid];
      } else {
        float acc[2][2];
        tile_dot(P1, Inv, acc);  // L_ic[r][q] = sum_m A_ic[r][m] Linv_c[q][m]
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            S.L[(i0 + ty + 16 * u) * npad + cc + tx + 16 * v] = acc[u][v];
            Tb[(tx + 16 * v) * TS + ty + 16 * u] = acc[u][v];
          }
        }
        __syncthreads();
        // L_ic^T into the upper tile (c, i), 16 bytes per thread.
        const int r = tid >> 3, q = tid & 7;
        *reinterpret_cast<float4*>(S.L + (cc + r) * npad + i0 + 4 * q) =
            *reinterpret_cast<const float4*>(Tb + r * TS + 4 * q);
        if (tid < T) {  // b_i -= L_ic y_c
          float li[T];
#pragma unroll
          for (int m = 0; m < T; ++m) li[m] = Tb[m * TS + tid];
          S.b[i0 + tid] = __ldcg(S.b + i0 + tid) - dot_strip4(li, yc);
        }
      }
      __syncthreads();
    }

    // Trailing tiles (c+1+i, c+1+j), j <= i, of every system, by the blocks
    // without a column job (all blocks if the grid is smaller than the
    // batch's column jobs).
    const int mm = NB - 1 - c;
    const int nu = c > 0 ? mm * (mm + 1) / 2 : 0;
    const int njobs = B * nu;
    const int stride = G > ncols ? G - ncols : G;
    int t = G > ncols ? (int)blockIdx.x - ncols : (int)blockIdx.x;
    if (t >= 0 && t < njobs) {
      auto stage_job = [&](int job, float* P, float* Q) {
        if (job < njobs) {
          const int k = job / nu;
          const float* Lk = a.L + (size_t)k * npad * npad;
          int i, j;
          tri_index(job - k * nu, i, j);
          stage_tile(P, Lk + (cc + (size_t)(i + 1) * T) * npad + kk, npad);
          if (i != j) stage_tile(Q, Lk + (cc + (size_t)(j + 1) * T) * npad + kk, npad);
        }
        cp_async_commit();
      };
      stage_job(t, P0, Q0);
      for (int st = 0; t < njobs; t += stride, st ^= 1) {
        float* const P = st ? P1 : P0;
        float* const Q = st ? Q1 : Q0;
        stage_job(t + stride, st ? P0 : P1, st ? Q0 : Q1);
        const int k = t / nu;
        int i, j;
        tri_index(t - k * nu, i, j);
        float* const out =
            a.L + (size_t)k * npad * npad + (cc + (size_t)(i + 1) * T) * npad + cc + (size_t)(j + 1) * T;
        float o[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) o[u][v] = __ldcg(out + (size_t)(ty + 16 * u) * npad + tx + 16 * v);
        cp_async_wait<1>();
        __syncthreads();
        float acc[2][2];
        tile_dot(P, i == j ? P : Q, acc);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) out[(size_t)(ty + 16 * u) * npad + tx + 16 * v] = o[u][v] - acc[u][v];
        __syncthreads();
      }
      cp_async_wait<0>();
    }
    grid.sync();
  }
  if (stamp) a.stamps[2] = now_ns();

  // ---- x0 = s L^-T y (system k in block k mod G) ----------------------------
  float* const ys = smem;
  float* const lbuf = smem + npad;
  for (int k = blockIdx.x; k < B; k += G) {
    const Sys S = system_of(a, k);
    for (int i = tid; i < npad; i += THREADS) ys[i] = __ldcg(S.y + i);
    __syncthreads();
    substitute<false>(S, npad, NB, ys, lbuf, vk);
    for (int i = tid; i < npad; i += THREADS) S.x0[i] = __ldcg(S.s + i) * ys[i];
    __syncthreads();
  }
  grid.sync();
  if (stamp) a.stamps[3] = now_ns();

  // ---- b = (-g - (H + lam I) x0) s, one warp per row of the batch ------------
  for (int e = blockIdx.x * (THREADS / 32) + warp; e < B * npad; e += G * (THREADS / 32)) {
    const int k = e / npad;
    residual_row(system_of(a, k), n, e - k * npad, lane);
  }
  grid.sync();
  if (stamp) a.stamps[4] = now_ns();

  // ---- x = x0 + s L^-T L^-1 b (system k in block k mod G) --------------------
  for (int k = blockIdx.x; k < B; k += G) {
    const Sys S = system_of(a, k);
    for (int i = tid; i < npad; i += THREADS) ys[i] = __ldcg(S.b + i);
    __syncthreads();
    substitute<true>(S, npad, NB, ys, lbuf, vk);
    for (int i = tid; i < npad; i += THREADS) S.y[i] = ys[i];
    substitute<false>(S, npad, NB, ys, lbuf, vk);
    for (int i = tid; i < n; i += THREADS) S.x[i] = __ldcg(S.x0 + i) + __ldcg(S.s + i) * ys[i];
    __syncthreads();
  }
  if (stamp) a.stamps[5] = now_ns();
}

size_t smem_bytes(int npad) {
  const int floats = npad + 2 * TILE;
  return sizeof(float) * (size_t)(floats > FACTOR_FLOATS ? floats : FACTOR_FLOATS);
}

// Blocks of the cooperative grid for B systems padded to npad: one block per
// lower tile of the batch, at most the co-resident maximum; or a negative
// cudaError_t.
int grid_size(int B, int npad) {
  static int cached_dev = -1, cached_max = 0;
  static size_t cached_smem = 0;
  const size_t smem = smem_bytes(npad);
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    err = cudaFuncSetAttribute((const void*)damped_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, damped_solve_kernel, THREADS, smem);
    if (err != cudaSuccess) return -(int)err;
    if (per_sm <= 0) return -(int)cudaErrorCooperativeLaunchTooLarge;
    cached_dev = dev;
    cached_smem = smem;
    cached_max = sms * per_sm;
  }
  const int NB = npad / T;
  const long long want = (long long)B * (NB * (NB + 1) / 2);
  return want < cached_max ? (int)want : cached_max;
}

int launch(const float* H, const float* g, const float* lam, float* x, int B, int n, float* L, float* Linv,
           float* s, float* b, float* y, float* x0, long long vstride, unsigned long long* stamps,
           void* stream_ptr) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int npad = (n + T - 1) / T * T;
  const int G = grid_size(B, npad);
  if (G <= 0) return G < 0 ? -G : (int)cudaErrorInvalidValue;
  Args a{H, g, lam, x, L, Linv, s, b, y, x0, stamps, n, npad, npad / T, B, vstride};
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)damped_solve_kernel, dim3(G), dim3(THREADS), args,
                                                smem_bytes(npad), static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Workspace sizes in floats, for dim n: L npad*npad, Linv npad*T, s/b/y/x0
// npad each, with npad = n rounded up to a multiple of 32.
int tids_damped_solve_pad(int n) { return (n + T - 1) / T * T; }

// Blocks of the cooperative grid for dim n (negative: a CUDA error).
int tids_damped_solve_grid(int n) { return grid_size(1, tids_damped_solve_pad(n)); }

// Blocks of the cooperative grid for a batch of B systems of dim n.
int tids_damped_solve_batched_grid(int B, int n) { return grid_size(B, tids_damped_solve_pad(n)); }

// x[n] = -(H + lam I)^-1 g on `stream`, one cooperative launch; returns the
// cudaError_t of the launch (0 on success; a refused launch returns its
// error and nothing runs). All pointers are device pointers; lam is one
// float.
int tids_damped_solve(const float* H, const float* g, const float* lam, float* x, int n, float* L, float* Linv,
                      float* s, float* b, float* y, float* x0, void* stream) {
  return launch(H, g, lam, x, 1, n, L, Linv, s, b, y, x0, 0, nullptr, stream);
}

// x[k] = -(H[k] + lam[k] I)^-1 g[k] for k < B, one cooperative launch for
// the batch: H [B, n, n], g [B, n], lam [B], x [B, n]; workspaces L [B,
// npad, npad], Linv [B, npad, T] and vecs [B, 4, npad] (s, b, y, x0 of each
// system). Every system is solved as the single entry solves it, bit for bit.
int tids_damped_solve_batched(const float* H, const float* g, const float* lam, float* x, int B, int n, float* L,
                              float* Linv, float* vecs, void* stream) {
  const int npad = tids_damped_solve_pad(n);
  return launch(H, g, lam, x, B, n, L, Linv, vecs, vecs + npad, vecs + 2 * npad, vecs + 3 * npad, 4LL * npad,
                nullptr, stream);
}

// The single launch, with block 0 writing the globaltimer (ns) at the start
// and at the end of each phase into stamps[6]: start, set-up, factorization
// (with the first forward solve), first backward solve, residual, second
// solve pair.
int tids_damped_solve_timed(const float* H, const float* g, const float* lam, float* x, int n, float* L,
                            float* Linv, float* s, float* b, float* y, float* x0, unsigned long long* stamps,
                            void* stream) {
  return launch(H, g, lam, x, 1, n, L, Linv, s, b, y, x0, 0, stamps, stream);
}

}  // extern "C"
