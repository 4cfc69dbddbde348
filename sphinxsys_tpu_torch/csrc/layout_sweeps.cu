// Two alternative parallel layouts of the 2D inner first-half acoustic
// sweep (B5a's function: cap 16, a mask channel, the self pair dropped)
// for Hopper (sm_90a).
//
// Counterparts of the Pallas layout experiments of the JAX package:
//   ac1_flat_kernel <- benchmarks/exp_layout.py:_ac1_flat_kernel  (ac1_flat_pallas)
//   ac1_t_kernel    <- benchmarks/exp_layout2.py:_ac1_t_kernel    (ac1_t_pallas)
// ported for their meaning, not their TPU tiling.  The plain PyTorch
// versions in sphinxsys_tpu_torch/ops/layout_sweeps.py compute the same sums.
//
// Both compute, per real slot i of a cell,
//   fx_i = -sum (p_i + p_j) dW V_j (1/r) dx,   fy_i likewise with dy,
//   rd_i =  sum (p_i - p_j) inv_rho0c0 dW V_j,
// over the 16 slots j of the 9 window rows, every pair multiplied by
// mask_i mask_j and the (i == j) pair of the centre window (4) dropped.
// dW/dr = (q < 2) ? S (qc-2)^3 qc : 0 with qc = min(q, 2), q = r / h and
// S = factor_w/h * 0.625 formed in double by the launcher's caller.
// Padding may carry any finite volume (the mask alone keeps it inert), so
// never build with --use_fast_math.
//
// ac1_flat_kernel (B6, the TPU's "pairs flattened onto the lane axis").
//   Input: packed (C+1, 16, 8) [x, y, vx, vy, p, vol, mask, 0], last row the
//   all-padding sentinel, and the (C, 9) int32 window map nbr (sentinel C).
//   Output (3, C, 16) = [fx, fy, rd].  Arithmetic as exp_layout.py:104-119:
//   r = sqrt(dx^2 + dy^2 + 1e-15), psum = (p_i + p_j) dWV (1/r), f -= psum d.
//   Design: one block per cell, one thread per (i, j) slot pair (256
//   threads); each thread loops over the 9 windows, reading its j slot of
//   the window row through nbr (the 16 lanes of an i-row read 16
//   consecutive 32-byte slots, 512 B contiguous), so JAX's pre-gathered
//   packed[nbr] (295 MB at the 2D dambreak's bench width) is never made.
//   A sentinel window (the same for the whole block) is skipped.  After the
//   window loop the 16 j-lanes of each i are summed with a width-16
//   __shfl_xor_sync tree; every lane of every warp takes part, since no
//   thread leaves the block early.
//
// ac1_t_kernel (B7, the TPU's "cell axis on the lanes").
//   Input: the pre-gathered, channel-major xi_t (8, 16, C) = packed[:C]
//   transposed and xj_t (9, 8, 16, C) = packed[nbr] transposed (exp_layout2's
//   contract, kept: it is the point of the experiment).  Output (3, 16, C).
//   Arithmetic as exp_layout2.py:96-109: r2 = dx^2 + dy^2 + 1e-15,
//   inv_r = rsqrt(r2), r = r2 inv_r, and each window's sum over j is
//   formed before it is added in.
//   Design: one thread per (i-slot, cell), the cell on threadIdx.x; a
//   block is 32 cells x 16 i-slots.  For each window the block stages the
//   five channels it reads (x, y, p, vol, mask) of the 16 j-slots of its
//   32 cells in shared memory (10 KB), each warp loading one j-row per
//   channel as one coalesced 128-byte read, no read indirect; then all 16
//   i-warps read them from there (consecutive cells on consecutive banks).
//   A first version that left the sharing to L1 ran 4x slower on an H100
//   (its 16 i-warps re-read every j value from L2).  Nothing can be skipped: a
//   padding window arrives pre-gathered (mask 0, adding exactly zero).
//
// What bounds them: counting each byte once and only the real pairs'
// flops, B6 moves what B5a moves (the packed rows its map reaches, the map,
// the output) and B7 reads 4 of xi_t's 8 channel planes and 5 of xj_t's
// (vx, vy and the zero channel are never loaded), about 213 MB with its
// output at bench width.
// Both evaluate all 16 x 16 slot pairs of each window they visit, about
// 17x (B6) and 23x (B7) the real pairs, ~31 flops each, far above what the
// bytes allow: both are bound by that arithmetic and its latency.  B6
// skips sentinel windows as B5a does; B7 evaluates every window, padding
// cells included.  At the 2D dambreak's bench width on an H100 (700 W)
// B7 takes 0.22 ms and B6 0.29 ms, 1.8x and 2.4x the time of B5a's lane
// groups (0.124 ms), which stage each window once in shared memory and
// sum only its real j-slots (chip_smoke.py's layout phase).
//
// Every launcher returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCap = 16;
constexpr int kCh = 8;
constexpr int kWindows = 9;
constexpr int kCentre = 4;
constexpr int kPairs = kCap * kCap;   // B6: threads per block, one cell
constexpr int kTileC = 32;            // B7: cells per block (one warp per i)
// channels of the inner layout
constexpr int kX = 0, kY = 1, kP = 4, kVol = 5, kMask = 6;

struct Slot {
  float c[kCh];
};

__device__ __forceinline__ Slot load_slot(const float* __restrict__ base) {
  const float4* p = reinterpret_cast<const float4*>(base);
  const float4 a = __ldg(p);
  const float4 b = __ldg(p + 1);
  return Slot{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// Wendland C2 dW/dr at r, clamped q, as the TPU kernels form it.
__device__ __forceinline__ float wendland_dw(float r, float inv_h,
                                             float dw_scale) {
  const float q = r * inv_h;
  const float qc = fminf(q, 2.0f);
  const float t = qc - 2.0f;
  return q < 2.0f ? dw_scale * (t * t * t) * qc : 0.0f;
}

// ---------------------------------------------------------------------------
// B6: one block per cell, one thread per (i, j) slot pair.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kPairs)
ac1_flat_kernel(const float* __restrict__ packed, const int* __restrict__ nbr,
                int C, float inv_h, float dw_scale, float inv_rho0c0,
                float* __restrict__ out) {
  const int64_t cell = blockIdx.x;
  const int i = threadIdx.x / kCap;
  const int j = threadIdx.x % kCap;
  const Slot si = load_slot(packed + (cell * kCap + i) * kCh);
  const float p_i = si.c[kP];
  float fx = 0.0f, fy = 0.0f, rd = 0.0f;
  for (int w = 0; w < kWindows; ++w) {
    const int row = nbr[cell * kWindows + w];
    if (row >= C) continue;   // the same row for every thread of the block
    const Slot sj = load_slot(packed + ((int64_t)row * kCap + j) * kCh);
    const float dx = si.c[kX] - sj.c[kX];
    const float dy = si.c[kY] - sj.c[kY];
    const float r = sqrtf(dx * dx + dy * dy + 1e-15f);
    const float inv_r = 1.0f / r;
    const float m = (w == kCentre && i == j) ? 0.0f
                                             : si.c[kMask] * sj.c[kMask];
    const float dwv = wendland_dw(r, inv_h, dw_scale) * m * sj.c[kVol];
    const float p_j = sj.c[kP];
    const float psum = (p_i + p_j) * dwv * inv_r;
    fx -= psum * dx;
    fy -= psum * dy;
    rd += (p_i - p_j) * inv_rho0c0 * dwv;
  }
  // sum the 16 j-lanes of each i (two i-rows per warp)
  for (int off = kCap / 2; off > 0; off >>= 1) {
    fx += __shfl_xor_sync(0xffffffffu, fx, off, kCap);
    fy += __shfl_xor_sync(0xffffffffu, fy, off, kCap);
    rd += __shfl_xor_sync(0xffffffffu, rd, off, kCap);
  }
  if (j == 0) {
    const int64_t plane = (int64_t)C * kCap;
    const int64_t o = cell * kCap + i;
    out[o] = fx;
    out[plane + o] = fy;
    out[2 * plane + o] = rd;
  }
}

// ---------------------------------------------------------------------------
// B7: one thread per (i-slot, cell) on the channel-major pre-gathered input.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kTileC * kCap)
ac1_t_kernel(const float* __restrict__ xi_t, const float* __restrict__ xj_t,
             int C, float inv_h, float dw_scale, float inv_rho0c0,
             float* __restrict__ out) {
  __shared__ float sj[5][kCap][kTileC];   // [x, y, p, vol, mask][j][cell]
  const int t = threadIdx.x;
  const int i = threadIdx.y;              // also the j-row this warp stages
  const int64_t c = (int64_t)blockIdx.x * kTileC + t;
  const bool live = c < C;   // a ragged last tile: stage zeros, store nothing
  const int64_t plane = (int64_t)kCap * C;   // one channel, (16, C)
  const int64_t ci = live ? c : 0;
  const float* xi = xi_t + (int64_t)i * C + ci;
  const float x_i = __ldg(xi + kX * plane);
  const float y_i = __ldg(xi + kY * plane);
  const float p_i = __ldg(xi + kP * plane);
  const float m_i = __ldg(xi + kMask * plane);
  float fx = 0.0f, fy = 0.0f, rd = 0.0f;
  for (int w = 0; w < kWindows; ++w) {
    const float* xw = xj_t + (int64_t)w * kCh * plane + (int64_t)i * C + ci;
    sj[0][i][t] = live ? __ldg(xw + kX * plane) : 0.0f;
    sj[1][i][t] = live ? __ldg(xw + kY * plane) : 0.0f;
    sj[2][i][t] = live ? __ldg(xw + kP * plane) : 0.0f;
    sj[3][i][t] = live ? __ldg(xw + kVol * plane) : 0.0f;
    sj[4][i][t] = live ? __ldg(xw + kMask * plane) : 0.0f;
    __syncthreads();
    float sx = 0.0f, sy = 0.0f, sr = 0.0f;
    for (int j = 0; j < kCap; ++j) {
      const float dx = x_i - sj[0][j][t];
      const float dy = y_i - sj[1][j][t];
      const float r2 = dx * dx + dy * dy + 1e-15f;
      const float inv_r = rsqrtf(r2);
      const float r = r2 * inv_r;
      const float m = (w == kCentre && i == j) ? 0.0f : m_i * sj[4][j][t];
      const float dwv = wendland_dw(r, inv_h, dw_scale) * m * sj[3][j][t];
      const float p_j = sj[2][j][t];
      const float psum = (p_i + p_j) * dwv * inv_r;
      sx += psum * dx;
      sy += psum * dy;
      sr += (p_i - p_j) * inv_rho0c0 * dwv;
    }
    fx -= sx;
    fy -= sy;
    rd += sr;
    __syncthreads();   // before the next window overwrites sj
  }
  if (!live) return;
  const int64_t o = (int64_t)i * C + c;
  out[o] = fx;
  out[plane + o] = fy;
  out[2 * plane + o] = rd;
}

}  // namespace

extern "C" {

int ac1_flat_launch(const float* packed, const int* nbr, int C, float inv_h,
                    float dw_scale, float inv_rho0c0, float* out,
                    void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  ac1_flat_kernel<<<(unsigned)C, kPairs, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      packed, nbr, C, inv_h, dw_scale, inv_rho0c0, out);
  return (int)cudaGetLastError();
}

int ac1_t_launch(const float* xi_t, const float* xj_t, int C, float inv_h,
                 float dw_scale, float inv_rho0c0, float* out, void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  const unsigned nb = (unsigned)((C + kTileC - 1) / kTileC);
  ac1_t_kernel<<<nb, dim3(kTileC, kCap), 0,
                 static_cast<cudaStream_t>(stream)>>>(
      xi_t, xj_t, C, inv_h, dw_scale, inv_rho0c0, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
