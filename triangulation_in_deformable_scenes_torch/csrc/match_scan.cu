// Windowed Hamming top-2 scan of the initial matcher, for an NVIDIA Hopper
// card (sm_90a). For each reference row i, over every current column j:
//
//     D = popcount(desc_i XOR desc_j)                (256-bit ORB descriptors)
//     allowed = dx^2 + dy^2 <= r2_i  and  oct_i - 1 <= oct_j <= oct_i + 1
//               and row_ok_i and valid_j
//     Dm = allowed ? D : BIG                         (BIG = 1e6)
//     best_d = min_j Dm, best = first j attaining it,
//     second_d = min of Dm over j != best
//
// so two columns tied at the best give second_d == best_d, and a row with
// no allowed column gives (BIG, 0, BIG).
//
// Replaces the TPU kernel triangulation_in_deformable_scenes_tpu/ops/
// pallas_kernels.py::fused_search_for_initialization (scan _match_scan :105,
// pallas_call :115, body _match_kernel :45). The TPU kernel computed D on the
// matrix unit as |a| + |b| - 2 a.b over int8 bits and merged 128 x 128 tiles
// across a sequential grid; here D is eight XOR + popc over packed words and
// no tile state crosses blocks.
//
// Bound on an H100 SXM: the inputs are ~48 bytes a key (32 of packed bits,
// position, r2 or validity, octave) and the outputs 12 bytes a row, so the
// bytes take well under a microsecond at the path's sizes; the work is a
// window test per pair (8 operations) and, per allowed pair, 8 XOR + 8 popc
// + 7 adds + the top-2 update, at most ~3e9 32-bit operations at 8192 x
// 8192, a few tens of microseconds against the 67 T/s f32 peak rate (the
// card's INT32 rate is half that). At 1000 x 1000 the kernel is latency-
// bound, so the design spreads each row over a warp.
//
// Design: two launches per scan.
//   * match_scan_pack_kernel: a warp per descriptor row (reference rows,
//     then current rows) packs its [256] 0/1 bytes into 8 words with
//     __ballot_sync (bit b of word w is column 32 w + b, the layout of
//     ops/match_scan.py::pack_bits) into the caller's workspace.
//   * match_scan_kernel: a warp per reference row, 8 rows a block; the
//     block stages the columns (packed words, position, octave, validity)
//     through shared memory in tiles of 256, one column a thread; lane l
//     scans the tile's columns t = l, l + 32, ... in ascending order, with
//     best, argmin and second in registers updated with a strict "<", a
//     displaced best becoming the second (pallas_kernels.py:92-101 applied
//     one column at a time): its own columns' top 2, first occurrence
//     winning. The lanes' results are then merged by an xor butterfly: the
//     best is the lexicographic minimum of (distance, column) and the second
//     the minimum of both seconds and the losing best, so ties go to the
//     first column wherever they lie and second == best on ties, exactly as
//     the plain version.
//   * no atomics and a fixed order: results repeat to the bit;
//   * the window test rounds each operation (__fsub_rn, __fmul_rn,
//     __fadd_rn): nvcc would otherwise contract dx*dx + dy*dy into an FMA and
//     move keys that lie on the circle; r2 comes from the wrapper, squared in
//     f32 as the plain version squares it.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;             // reference rows a block, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kThreads;       // columns staged per shared-memory tile
constexpr float kBig = 1.0e6f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
match_scan_pack_kernel(const unsigned char* __restrict__ desc_ref, const unsigned char* __restrict__ desc_cur,
                       int n1, int n2, unsigned* __restrict__ bits_ref, unsigned* __restrict__ bits_cur) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n1 + n2) return;  // whole warps leave together
  const bool ref = row < n1;
  const int r = ref ? row : row - n1;
  const unsigned char* d = (ref ? desc_ref : desc_cur) + (size_t)r * 256;
  unsigned* out = (ref ? bits_ref : bits_cur) + (size_t)r * 8;
  unsigned mine = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const unsigned word = __ballot_sync(kFull, d[32 * w + lane] != 0);
    if (lane == w) mine = word;
  }
  if (lane < 8) out[lane] = mine;
}

__global__ void __launch_bounds__(kThreads)
match_scan_kernel(const float2* __restrict__ kp_ref, const float* __restrict__ r2,
                  const int* __restrict__ oct_ref, const unsigned char* __restrict__ row_ok,
                  const uint4* __restrict__ bits_ref, const float2* __restrict__ kp_cur,
                  const int* __restrict__ oct_cur, const unsigned char* __restrict__ valid_cur,
                  const uint4* __restrict__ bits_cur, int n1, int n2, float* __restrict__ best_d,
                  int* __restrict__ best_i, float* __restrict__ second_d) {
  __shared__ uint4 s_b0[kTile], s_b1[kTile];  // words 0..3 and 4..7 of each column
  __shared__ float2 s_xy[kTile];
  __shared__ int s_oct[kTile];
  __shared__ unsigned char s_valid[kTile];

  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = i < n1;
  uint4 a0 = make_uint4(0, 0, 0, 0), a1 = make_uint4(0, 0, 0, 0);
  float xr = 0.f, yr = 0.f, rr = 0.f;
  int o = 0;
  bool ok = false;
  if (live) {
    a0 = bits_ref[2 * i];
    a1 = bits_ref[2 * i + 1];
    const float2 p = kp_ref[i];
    xr = p.x;
    yr = p.y;
    rr = r2[i];
    o = oct_ref[i];
    ok = row_ok[i] != 0;
  }

  float best = kBig, second = kBig;
  int bi = 0;
  for (int base = 0; base < n2; base += kTile) {
    __syncthreads();  // the previous tile is no longer read
    const int j = base + threadIdx.x;
    if (j < n2) {
      s_b0[threadIdx.x] = bits_cur[2 * j];
      s_b1[threadIdx.x] = bits_cur[2 * j + 1];
      s_xy[threadIdx.x] = kp_cur[j];
      s_oct[threadIdx.x] = oct_cur[j];
      s_valid[threadIdx.x] = valid_cur[j];
    }
    __syncthreads();
    if (!ok) continue;  // every column of this row is BIG: (BIG, 0, BIG)
    const int m = min(kTile, n2 - base);
    for (int t = lane; t < m; t += 32) {
      const float2 c = s_xy[t];
      const float dx = __fsub_rn(xr, c.x);
      const float dy = __fsub_rn(yr, c.y);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const int oc = s_oct[t];
      float D = kBig;
      if (s_valid[t] && d2 <= rr && oc >= o - 1 && oc <= o + 1) {
        const uint4 b0 = s_b0[t];
        const uint4 b1 = s_b1[t];
        const int h = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
                      __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                      __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
        D = (float)h;
      }
      if (D < best) {
        second = best;
        best = D;
        bi = base + t;
      } else {
        second = fminf(second, D);
      }
    }
  }
  // Ordered merge of the lanes' (best, column, second): the lexicographic
  // minimum of (distance, column) wins; the second is the minimum of both
  // seconds and the losing best.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    const float os = __shfl_xor_sync(kFull, second, off);
    const bool other_wins = ob < best || (ob == best && oi < bi);
    second = fminf(fminf(second, os), other_wins ? best : ob);
    if (other_wins) {
      best = ob;
      bi = oi;
    }
  }
  if (live && lane == 0) {
    best_d[i] = best;
    best_i[i] = bi;
    second_d[i] = second;
  }
}

}  // namespace

extern "C" {

// (best_d, best_i, second_d) [n1] of the scan on `stream`: the pack launch
// into bits_ref [n1, 8] and bits_cur [n2, 8] (uint32, 16-byte aligned rows;
// the caller's workspace), then the scan. Device pointers: kp_ref [n1, 2]
// f32, r2 [n1] f32, oct_ref [n1] int32, row_ok [n1] bool, desc_ref [n1, 256]
// uint8 0/1, kp_cur [n2, 2] f32, oct_cur [n2] int32, valid_cur [n2] bool,
// desc_cur [n2, 256] uint8 0/1. Returns the cudaError_t of the launches (0
// on success).
int tids_match_scan(const float* kp_ref, const float* r2, const int* oct_ref,
                    const unsigned char* row_ok, const unsigned char* desc_ref, const float* kp_cur,
                    const int* oct_cur, const unsigned char* valid_cur, const unsigned char* desc_cur,
                    int n1, int n2, unsigned* bits_ref, unsigned* bits_cur, float* best_d, int* best_i,
                    float* second_d, void* stream_ptr) {
  if (n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  match_scan_pack_kernel<<<(n1 + n2 + kWarps - 1) / kWarps, kThreads, 0, stream>>>(desc_ref, desc_cur, n1, n2,
                                                                                   bits_ref, bits_cur);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  match_scan_kernel<<<(n1 + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      reinterpret_cast<const float2*>(kp_ref), r2, oct_ref, row_ok, reinterpret_cast<const uint4*>(bits_ref),
      reinterpret_cast<const float2*>(kp_cur), oct_cur, valid_cur, reinterpret_cast<const uint4*>(bits_cur), n1,
      n2, best_d, best_i, second_d);
  return (int)cudaGetLastError();
}

}  // extern "C"
