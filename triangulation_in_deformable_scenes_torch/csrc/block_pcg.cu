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
// shaped. On the TPU the design goal was to keep Bt resident in VMEM across
// iterations; on Hopper the 50 MB L2 keeps it resident instead, so after the
// first iteration the blocks come from L2, not HBM. The least time for the
// whole solve (inputs read once) is a few microseconds, far below the
// latency of the iteration chain, which is what this kernel's time measures.
//
// Design: ONE cooperative persistent launch for the whole solve, the
// counterpart of the TPU's "whole solve in one call". A warp owns a point
// (grid-stride when the grid holds fewer warps than points):
//   * prologue: lane 0 forms the 6x6 inverse of its point's D_i + lam I into
//     a workspace; thread 0 of every block forms the 8x8 inverse of
//     Hg + lam I in shared memory (every block the same, so no exchange).
//   * matvec: lane k takes neighbour slot k (Bt block in 16-byte loads, the
//     neighbour's packed p_j from L2), the 6 sums are reduced across the
//     warp by xor shuffles; lanes 0..5 add the D, lam and C rows.
//   * the global rows y_g = sum_i C_i^T p_i + (Hg + lam) p_g and every dot
//     product are grid-wide sums: each block writes its partial sums (warps
//     summed in order) to a workspace, and after grid.sync() every block
//     sums all blocks' partials in the same fixed order. No float atomics:
//     the result does not depend on scheduling, so the LM accept decisions
//     repeat run to run; every block computes the same alpha, beta and r.r,
//     so all blocks leave the loop at the same iteration.
//   * the 8 global entries of x, r, z, p live in each block's shared memory.
// Three grid.sync() per iteration. The grid is the co-resident maximum
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs) or one warp per
// point, whichever is smaller; a refused cooperative launch returns its
// error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;  // warps per block
constexpr int THREADS = WARPS * 32;
constexpr int VS = 8;     // stride of a packed per-point vector (6 used)
constexpr int PS = 16;    // stride of one block's partial sums
constexpr float TINY = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* D;          // [N, 36]
  const float* Bt;         // [N, K, 36]
  const float* C;          // [N, 48]
  const float* Hg;         // [64]
  const long long* nbr;    // [N, K]
  const float* b;          // [6N + 8]
  const float* lam;        // [1]
  float* x;                // [6N + 8] out
  float* Dinv;             // [N, 36] workspace
  float* r;                // [N, VS]
  float* z;
  float* p;
  float* Ap;
  float* partA;            // [G, PS]
  float* partB;            // [G, PS]
  int* iters_out;          // [1]
  long long* iters_total;  // [1]
  int n, K, iters;
  float rtol2;
};

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same sum (addition commutes).
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// out = (A + lam I)^-1 for an SPD M x M block A (row-major): Jacobi
// equilibration, unrolled Cholesky, L^-1 by forward substitution, Li^T Li
// (block_system.py:335-390 at M = 6).
template <int M>
__device__ __forceinline__ void inv_spd(const float* __restrict__ A, float lam, float* out) {
  float s[M], L[M][M], Li[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) s[i] = rsqrtf(fmaxf(A[i * M + i] + lam, TINY));
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float acc = ((A[i * M + j] + (i == j ? lam : 0.0f)) * s[i]) * s[j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc -= L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(fmaxf(acc, TINY)) : acc / L[j][j];
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    Li[i][i] = 1.0f / L[i][i];
#pragma unroll
    for (int j = i - 1; j >= 0; --j) {
      float acc = L[i][j] * Li[j][j];
#pragma unroll
      for (int k = j + 1; k < i; ++k) acc += L[i][k] * Li[k][j];
      Li[i][j] = -acc * Li[i][i];
    }
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int k = (a > c ? a : c); k < M; ++k) acc += Li[k][a] * Li[k][c];
      out[a * M + c] = (acc * s[a]) * s[c];
    }
  }
}

// Position of packed component a (0..5) of point i in the flat layout.
__device__ __forceinline__ size_t flat_index(int i, int a, int n) {
  return a < 3 ? (size_t)3 * i + a : (size_t)3 * n + 3 * i + (a - 3);
}

// Block's per-warp partial sums sh[w][c] (c < nc) -> part[blockIdx.x][c],
// warps summed in order.
__device__ __forceinline__ void write_partials(float (*sh)[PS], int nc, float* part) {
  __syncthreads();
  if (threadIdx.x < nc) {
    float acc = 0.0f;
    for (int w = 0; w < WARPS; ++w) acc += sh[w][threadIdx.x];
    part[(size_t)blockIdx.x * PS + threadIdx.x] = acc;
  }
}

// Sum of every block's partials part[b][c] over b, for c < nc, in a fixed
// order (lane-strided, then the xor butterfly) into tot[c]. Runs after
// grid.sync(); loads bypass L1 (the partials come from other SMs).
__device__ __forceinline__ void sum_partials(const float* part, int nc, float* tot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < nc; c += WARPS) {
    float acc = 0.0f;
    for (int b = lane; b < (int)gridDim.x; b += 32) acc += __ldcg(part + (size_t)b * PS + c);
    acc = warp_sum(acc);
    if (lane == 0) tot[c] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) pcg_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float Hginv[64];
  __shared__ float xg[8], rg[8], zg[8], pg[8], Apg[8];
  __shared__ float sh[WARPS][PS];
  __shared__ float tot[PS];
  __shared__ float s_alpha, s_beta, s_rz, s_tol2;
  __shared__ int s_done, s_k;

  const int n = a.n, K = a.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * WARPS + warp;
  const int nwarps = gridDim.x * WARPS;
  const float lam = a.lam[0];
  const int la = lane < 6 ? lane : 0;  // component of lanes 0..5; others idle

  // ---- prologue: preconditioner, r = b, z = M r, p = z -------------------
  if (threadIdx.x == 0) {
    inv_spd<8>(a.Hg, lam, Hginv);
    for (int g = 0; g < 8; ++g) rg[g] = a.b[(size_t)6 * n + g];
    float rz = 0.0f, rr = 0.0f;
    for (int g = 0; g < 8; ++g) {
      float acc = 0.0f;
      for (int h = 0; h < 8; ++h) acc += Hginv[g * 8 + h] * rg[h];
      zg[g] = acc;
      pg[g] = acc;
      xg[g] = 0.0f;
    }
    for (int g = 0; g < 8; ++g) {
      rz += rg[g] * zg[g];
      rr += rg[g] * rg[g];
    }
    tot[8] = rz;
    tot[9] = rr;
  }
  float wrz = 0.0f, wrr = 0.0f;
  for (int i = gwarp; i < n; i += nwarps) {
    if (lane == 0) inv_spd<6>(a.D + (size_t)i * 36, lam, a.Dinv + (size_t)i * 36);
    __syncwarp();
    const float ra = a.b[flat_index(i, la, n)];
    float rb[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) rb[c] = __shfl_sync(FULL, ra, c);
    const float* Mi = a.Dinv + (size_t)i * 36 + la * 6;
    float za = 0.0f;
#pragma unroll
    for (int c = 0; c < 6; ++c) za += Mi[c] * rb[c];
    if (lane < 6) {
      a.x[flat_index(i, la, n)] = 0.0f;
      a.r[(size_t)i * VS + la] = ra;
      a.z[(size_t)i * VS + la] = za;
      a.p[(size_t)i * VS + la] = za;
      wrz += ra * za;
      wrr += ra * ra;
    }
  }
  wrz = warp_sum(wrz);
  wrr = warp_sum(wrr);
  if (lane == 0) {
    sh[warp][0] = wrz;
    sh[warp][1] = wrr;
  }
  write_partials(sh, 2, a.partB);
  grid.sync();
  {
    const float rz_g = tot[8], rr_g = tot[9];
    __syncthreads();
    sum_partials(a.partB, 2, tot);
    if (threadIdx.x == 0) {
      s_rz = tot[0] + rz_g;
      const float rr = tot[1] + rr_g;
      s_tol2 = a.rtol2 * rr;
      s_k = 0;
      s_done = !(0 < a.iters && rr > s_tol2);
    }
    __syncthreads();
  }

  while (!s_done) {
    // ---- Ap = (H + lam I) p; partials of C^T p and p_p . Ap_p ------------
    float wctp = 0.0f, wpap = 0.0f;
    for (int i = gwarp; i < n; i += nwarps) {
      float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = lane; k < K; k += 32) {
        const long long jj = a.nbr[(size_t)i * K + k];
        const int j = jj < 0 ? 0 : (int)jj;
        const float4 v03 = __ldcg(reinterpret_cast<const float4*>(a.p + (size_t)j * VS));
        const float2 v45 = __ldcg(reinterpret_cast<const float2*>(a.p + (size_t)j * VS + 4));
        const float v[6] = {v03.x, v03.y, v03.z, v03.w, v45.x, v45.y};
        const float4* B = reinterpret_cast<const float4*>(a.Bt + ((size_t)i * K + k) * 36);
        float blk[36];
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          const float4 t = __ldg(B + q);
          blk[4 * q] = t.x;
          blk[4 * q + 1] = t.y;
          blk[4 * q + 2] = t.z;
          blk[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int c = 0; c < 6; ++c) acc[r] += blk[r * 6 + c] * v[c];
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[r] = warp_sum(acc[r]);
      float y = acc[0];
#pragma unroll
      for (int r = 1; r < 6; ++r)
        if (la == r) y = acc[r];
      const float* pi = a.p + (size_t)i * VS;
      float pv[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) pv[c] = pi[c];
      const float* Dr = a.D + (size_t)i * 36 + la * 6;
      const float* Cr = a.C + (size_t)i * 48 + la * 8;
#pragma unroll
      for (int c = 0; c < 6; ++c) y += Dr[c] * pv[c];
#pragma unroll
      for (int g = 0; g < 8; ++g) y += Cr[g] * pg[g];
      y += lam * pv[la];
      if (lane < 6) {
        a.Ap[(size_t)i * VS + la] = y;
        wpap += pv[la] * y;
      }
      if (lane < 8) {
        const float* Cc = a.C + (size_t)i * 48 + lane;
        float ct = 0.0f;
#pragma unroll
        for (int c = 0; c < 6; ++c) ct += Cc[c * 8] * pv[c];
        wctp += ct;
      }
    }
    wpap = warp_sum(wpap);
    if (lane < 8) sh[warp][lane] = wctp;
    if (lane == 0) sh[warp][8] = wpap;
    write_partials(sh, 9, a.partA);
    grid.sync();
    sum_partials(a.partA, 9, tot);
    if (threadIdx.x == 0) {
      float pap = tot[8];
      for (int g = 0; g < 8; ++g) {
        float acc = tot[g];
        for (int h = 0; h < 8; ++h) acc += a.Hg[g * 8 + h] * pg[h];
        Apg[g] = acc + lam * pg[g];
      }
      for (int g = 0; g < 8; ++g) pap += pg[g] * Apg[g];
      const float alpha = s_rz / (pap + TINY);
      s_alpha = alpha;
      float rz = 0.0f, rr = 0.0f;
      for (int g = 0; g < 8; ++g) {
        xg[g] += alpha * pg[g];
        rg[g] -= alpha * Apg[g];
      }
      for (int g = 0; g < 8; ++g) {
        float acc = 0.0f;
        for (int h = 0; h < 8; ++h) acc += Hginv[g * 8 + h] * rg[h];
        zg[g] = acc;
      }
      for (int g = 0; g < 8; ++g) {
        rz += rg[g] * zg[g];
        rr += rg[g] * rg[g];
      }
      tot[10] = rz;
      tot[11] = rr;
    }
    __syncthreads();

    // ---- x += alpha p; r -= alpha Ap; z = M r; partials of r.z, r.r ------
    const float alpha = s_alpha;
    wrz = 0.0f;
    wrr = 0.0f;
    for (int i = gwarp; i < n; i += nwarps) {
      const size_t o = (size_t)i * VS + la;
      const float ra = a.r[o] - alpha * a.Ap[o];
      float rb[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) rb[c] = __shfl_sync(FULL, ra, c);
      const float* Mi = a.Dinv + (size_t)i * 36 + la * 6;
      float za = 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) za += Mi[c] * rb[c];
      if (lane < 6) {
        const size_t f = flat_index(i, la, n);
        a.x[f] = a.x[f] + alpha * a.p[o];
        a.r[o] = ra;
        a.z[o] = za;
        wrz += ra * za;
        wrr += ra * ra;
      }
    }
    wrz = warp_sum(wrz);
    wrr = warp_sum(wrr);
    if (lane == 0) {
      sh[warp][0] = wrz;
      sh[warp][1] = wrr;
    }
    write_partials(sh, 2, a.partB);
    grid.sync();
    {
      const float rz_g = tot[10], rr_g = tot[11];
      __syncthreads();
      sum_partials(a.partB, 2, tot);
      if (threadIdx.x == 0) {
        const float rz = tot[0] + rz_g;
        const float rr = tot[1] + rr_g;
        const float beta = rz / (s_rz + TINY);
        s_beta = beta;
        s_rz = rz;
        for (int g = 0; g < 8; ++g) pg[g] = zg[g] + beta * pg[g];
        s_k += 1;
        s_done = !(s_k < a.iters && rr > s_tol2);
      }
      __syncthreads();
    }

    // ---- p = z + beta p ---------------------------------------------------
    const float beta = s_beta;
    for (int i = gwarp; i < n; i += nwarps) {
      if (lane < 6) {
        const size_t o = (size_t)i * VS + lane;
        a.p[o] = a.z[o] + beta * a.p[o];
      }
    }
    if (!s_done) grid.sync();
  }

  if (blockIdx.x == 0) {
    if (threadIdx.x < 8) a.x[(size_t)6 * n + threadIdx.x] = xg[threadIdx.x];
    if (threadIdx.x == 0) {
      a.iters_out[0] = s_k;
      a.iters_total[0] += s_k;
    }
  }
}

int grid_size(int n) {
  static int cached_dev = -1, cached_max = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev != cached_dev) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_kernel, THREADS, 0);
    if (err != cudaSuccess) return -(int)err;
    cached_dev = dev;
    cached_max = sms * per_sm;
  }
  const int want = (n + WARPS - 1) / WARPS;
  return want < cached_max ? want : cached_max;
}

}  // namespace

extern "C" {

// Workspace floats for N points: Dinv N*36, r/z/p/Ap N*8 each, two partial
// buffers of (one block per 8 points) * 16.
long long tids_pcg_workspace_floats(int n) {
  const long long blocks = (n + WARPS - 1) / WARPS;
  return (long long)n * 36 + 4LL * n * VS + 2 * blocks * PS;
}

// Blocks of the cooperative grid for N points (negative: a CUDA error).
int tids_pcg_grid(int n) { return grid_size(n); }

// x [6N + 8] = PCG solve of (H + lam I) x = b on `stream`; iters_out [1]
// receives the iterations taken and iters_total [1] is increased by them.
// All pointers are device pointers (nbr int64, lam one float). Returns the
// cudaError_t of the launch (0 on success).
int tids_pcg_solve(const float* D, const float* Bt, const float* C, const float* Hg,
                   const long long* nbr, const float* b, const float* lam, float* x, int n, int K,
                   int iters, float rtol2, float* ws, int* iters_out, long long* iters_total,
                   void* stream_ptr) {
  const int G = grid_size(n);
  if (G <= 0) return G < 0 ? -G : (int)cudaErrorInvalidValue;
  Args a;
  a.D = D;
  a.Bt = Bt;
  a.C = C;
  a.Hg = Hg;
  a.nbr = nbr;
  a.b = b;
  a.lam = lam;
  a.x = x;
  a.Dinv = ws;
  a.r = ws + (size_t)n * 36;
  a.z = a.r + (size_t)n * VS;
  a.p = a.z + (size_t)n * VS;
  a.Ap = a.p + (size_t)n * VS;
  a.partA = a.Ap + (size_t)n * VS;
  a.partB = a.partA + (size_t)((n + WARPS - 1) / WARPS) * PS;
  a.iters_out = iters_out;
  a.iters_total = iters_total;
  a.n = n;
  a.K = K;
  a.iters = iters;
  a.rtol2 = rtol2;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)pcg_kernel, dim3(G), dim3(THREADS), args,
                                                0, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
