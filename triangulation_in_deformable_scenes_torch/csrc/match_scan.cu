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
// bound.
//
// Design (simple first):
//   * one thread per reference row; its 8 descriptor words, position, r2,
//     octave and row flag live in registers; 64 rows a block;
//   * columns are staged through shared memory in tiles of 64 (every thread
//     loads one column's words and metadata); all threads of a warp then read
//     the same column, a broadcast;
//   * best, argmin and second live in registers and are updated in column
//     order with a strict "<" for the best, so the first occurrence wins, and
//     a displaced best becomes the second: exactly the merge of
//     pallas_kernels.py:92-101 applied one column at a time;
//   * no atomics and a fixed order: results repeat to the bit;
//   * the window test rounds each operation (__fsub_rn, __fmul_rn,
//     __fadd_rn): nvcc would otherwise contract dx*dx + dy*dy into an FMA and
//     move keys that lie on the circle; r2 comes from the wrapper, squared in
//     f32 as the plain version squares it.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;  // threads per block, one reference row each
constexpr int kTile = 64;  // columns staged per shared-memory tile
constexpr float kBig = 1.0e6f;

__global__ void __launch_bounds__(kRows)
match_scan_kernel(const float2* __restrict__ kp_ref, const float* __restrict__ r2,
                  const int* __restrict__ oct_ref, const unsigned char* __restrict__ row_ok,
                  const uint4* __restrict__ bits_ref, const float2* __restrict__ kp_cur,
                  const int* __restrict__ oct_cur, const unsigned char* __restrict__ valid_cur,
                  const uint4* __restrict__ bits_cur, int n1, int n2, float* __restrict__ best_d,
                  int* __restrict__ best_i, float* __restrict__ second_d) {
  __shared__ uint4 s_bits[kTile][2];
  __shared__ float2 s_xy[kTile];
  __shared__ int s_oct[kTile];
  __shared__ unsigned char s_valid[kTile];

  const int i = blockIdx.x * kRows + threadIdx.x;
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
      s_bits[threadIdx.x][0] = bits_cur[2 * j];
      s_bits[threadIdx.x][1] = bits_cur[2 * j + 1];
      s_xy[threadIdx.x] = kp_cur[j];
      s_oct[threadIdx.x] = oct_cur[j];
      s_valid[threadIdx.x] = valid_cur[j];
    }
    __syncthreads();
    if (!ok) continue;  // every column of this row is BIG: (BIG, 0, BIG)
    const int m = min(kTile, n2 - base);
    for (int t = 0; t < m; ++t) {
      const float2 c = s_xy[t];
      const float dx = __fsub_rn(xr, c.x);
      const float dy = __fsub_rn(yr, c.y);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const int oc = s_oct[t];
      float D = kBig;
      if (s_valid[t] && d2 <= rr && oc >= o - 1 && oc <= o + 1) {
        const uint4 b0 = s_bits[t][0];
        const uint4 b1 = s_bits[t][1];
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
  if (live) {
    best_d[i] = best;
    best_i[i] = bi;
    second_d[i] = second;
  }
}

}  // namespace

extern "C" {

// (best_d, best_i, second_d) [n1] of the scan on `stream`. Device pointers:
// kp_ref [n1, 2] f32, r2 [n1] f32, oct_ref [n1] int32, row_ok [n1] bool,
// bits_ref [n1, 8] uint32 (16-byte aligned rows), kp_cur [n2, 2] f32,
// oct_cur [n2] int32, valid_cur [n2] bool, bits_cur [n2, 8] uint32. Returns
// the cudaError_t of the launch (0 on success).
int tids_match_scan(const float* kp_ref, const float* r2, const int* oct_ref,
                    const unsigned char* row_ok, const unsigned* bits_ref, const float* kp_cur,
                    const int* oct_cur, const unsigned char* valid_cur, const unsigned* bits_cur,
                    int n1, int n2, float* best_d, int* best_i, float* second_d,
                    void* stream_ptr) {
  if (n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n1 + kRows - 1) / kRows);
  match_scan_kernel<<<grid, kRows, 0, (cudaStream_t)stream_ptr>>>(
      reinterpret_cast<const float2*>(kp_ref), r2, oct_ref, row_ok,
      reinterpret_cast<const uint4*>(bits_ref), reinterpret_cast<const float2*>(kp_cur), oct_cur,
      valid_cur, reinterpret_cast<const uint4*>(bits_cur), n1, n2, best_d, best_i, second_d);
  return (int)cudaGetLastError();
}

}  // extern "C"
