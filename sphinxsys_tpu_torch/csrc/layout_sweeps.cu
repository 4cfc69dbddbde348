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
// never build with --use_fast_math.  A slot of mask 0 adds exactly +-0 to
// every sum, which is what lets both kernels skip padding.
//
// What bounds them: counting each byte once and only the real pairs'
// flops (PERF.md section 2), both are bound by bytes.  B6 moves what B5a
// moves (the packed rows its map reaches, the map, the output).  B7 moves
// its output, 4 of xi_t's 8 channel planes (x, y, p, mask), the 9 mask
// planes of xj_t, which its tiles vote on, and xj_t's x, y, p and vol
// only on the j-rows its tiles keep (vx, vy and the zero channel are never
// loaded); its first design read those 4 planes whole.  What held the
// first designs far above the bound was pair issue: each evaluated every
// 16 x 16 slot pair of each window it visited, padding included, 17x (B6)
// and 23x (B7) the real pairs, ~31 flops and, in B6, two global float4
// loads each.  The designs below evaluate 5.7x (B6) and 5.3x (B7) fewer
// pairs at the 2D dambreak's bench width and take 0.38x and 0.42x their
// first designs' time on an H100; both still run above their bound, B6
// issuing 3x the real pairs and B7 its 32-cell tiles' row pairs (times,
// bounds and pair counts: PERF.md, section 6).
//
// ac1_flat_kernel (B6, the TPU's "pairs flattened onto the lane axis").
//   Input: packed (C+1, 16, 8) [x, y, vx, vy, p, vol, mask, 0], last row the
//   all-padding sentinel, and the (C, 9) int32 window map nbr (sentinel C).
//   Output (3, C, 16) = [fx, fy, rd].  Arithmetic as exp_layout.py:104-119,
//   psum = (p_i + p_j) dWV (1/r), f -= psum d, but with B7's r2 =
//   dx^2 + dy^2 + 1e-15, 1/r = rsqrt(r2), r = r2 (1/r) where JAX takes sqrt
//   and a division (IEEE subroutines; the build with them ran 1.12x
//   slower, PERF.md, section 6): real slots agree with the plain version to f32
//   roundoff, r2 > 0 always.
//   Design: one 32-lane warp per cell, the pairs of its real slots spread
//   over the lanes.
//   * The warp reads the cell's window map once (live_windows) and
//     compacts its real i-slots (n_i of them) into shared memory, each with
//     its global slot index; a cell with no real slot or no live window
//     writes zeros and stops.
//   * The live windows are staged a segment (up to 3 consecutive block
//     rows) at a time by 16-byte cp.async, double-buffered, and their real
//     j-slots compacted (walk_rows, compact_real<PackedSlots> of
//     lane_groups.cuh, with Group<32>): JAX's pre-gathered packed[nbr]
//     (295 MB at bench width) is never made, and no slot is read twice
//     from device memory.
//   * The n_i x n_j real pairs of a segment are flattened onto the 32
//     lanes, i fastest: pair q = j P + i, the i axis padded to P = n_i
//     rounded up to a power of 2, goes to lane q % 32.  So lane l keeps
//     one i-slot (l % P) in registers and sums every (32 / P)-th real j
//     from l / P; lanes with i >= n_i idle (at most P - n_i of P).  A
//     butterfly over the 32 / P lanes of each i ends the cell: a fixed
//     order, no atomics.  (Two builds that spread the pair index over the
//     lanes without fixing a lane's i, one summing the terms per i through
//     a tile in shared memory, one by a segmented shuffle, ran 1.36x and
//     1.43x slower than this design with the same sqrt arithmetic;
//     PERF.md, section 6.)
//   * The self pair is dropped by slot index (JAX's (window 4, j == i)
//     where window 4 is the cell's own row and no other window repeats it,
//     as in B5a); padding i-slots get zeros.
//
// ac1_t_kernel (B7, the TPU's "cell axis on the lanes").
//   Input: the pre-gathered, channel-major xi_t (8, 16, C) = packed[:C]
//   transposed and xj_t (9, 8, 16, C) = packed[nbr] transposed (exp_layout2's
//   contract, kept: it is the point of the experiment).  Output (3, 16, C).
//   Arithmetic as exp_layout2.py:96-109: r2 = dx^2 + dy^2 + 1e-15,
//   inv_r = rsqrt(r2), r = r2 inv_r, and each window's sum over j is
//   formed before it is added in.
//   Design: one thread per (i-slot, cell), the cell on threadIdx.x; a
//   block is a tile of 32 cells x 16 i-slots, warp y also the stager of
//   j-row y.
//   * The tile votes on its masks: each warp loads row y of every window's
//     mask plane (kept in shared memory) and of xi_t's, and ballots; the
//     block then holds one 16-bit set of i-rows with a real slot among its
//     32 cells and, per window, one of j-rows with a real slot.  Sets, not
//     counts: rows may hold padding mid-row.  A tile with no real i-slot
//     writes zeros and stops; an i-warp with none writes zeros but still
//     stages its row and reaches every barrier.
//   * Only live j-rows of live windows are staged (x, y, p, vol; the mask
//     plane is already there) and summed; a window whose mask plane holds
//     no real slot is skipped.  A skipped row adds exactly +-0 to a sum
//     that starts at +0, so real slots equal the first design's (one
//     thread over every row) bit for bit.
//   * Staging is a ring of three window buffers: windows w + 1 and w + 2
//     are in flight by cp.async while window w is summed, one barrier a
//     window.  16-byte copies where C % 4 == 0 (a plane row starts at
//     j C floats) and xj_t is 16-byte aligned, 4-byte ones otherwise, a
//     template flag chosen by the launcher.  A ragged last tile stages
//     zeros and stores nothing.
//
// Every launcher returns cudaGetLastError() after the launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_groups.cuh"

namespace {

constexpr int kCap = 16;
constexpr int kCh = 8;
constexpr int kWindows = 9;
constexpr int kCentre = 4;
// channels of the inner layout
constexpr int kX = 0, kY = 1, kP = 4, kVol = 5, kMask = 6;

// Wendland C2 dW/dr at r, clamped q, as the TPU kernels form it.
__device__ __forceinline__ float wendland_dw(float r, float inv_h,
                                             float dw_scale) {
  const float q = r * inv_h;
  const float qc = fminf(q, 2.0f);
  const float t = qc - 2.0f;
  return q < 2.0f ? dw_scale * (t * t * t) * qc : 0.0f;
}

// One pair's terms, B6's and B7's arithmetic: r2 = dx^2 + dy^2 + 1e-15,
// 1/r = rsqrt(r2), r = r2 (1/r), dWV = dW(r) m V_j and
// psum = (p_i + p_j) dWV (1/r); returns (psum dx, psum dy,
// (p_i - p_j) inv_rho0c0 dWV), which the caller adds in its own order.
__device__ __forceinline__ float3 ac1_pair(float dx, float dy, float p_i,
                                           float p_j, float m, float vol_j,
                                           float inv_h, float dw_scale,
                                           float inv_rho0c0) {
  const float r2 = dx * dx + dy * dy + 1e-15f;
  const float inv_r = rsqrtf(r2);
  const float dwv = wendland_dw(r2 * inv_r, inv_h, dw_scale) * m * vol_j;
  const float psum = (p_i + p_j) * dwv * inv_r;
  return make_float3(psum * dx, psum * dy, (p_i - p_j) * inv_rho0c0 * dwv);
}

// ---------------------------------------------------------------------------
// B6: one warp per cell, its real slot pairs spread over the lanes.
// ---------------------------------------------------------------------------
constexpr int kWarp = 32;
constexpr int kNarr = 2;                                 // float4 parts a slot
constexpr int kSegSlots6 = seg_rows(kCap) * kCap;        // slots a buffer
// A warp's slice of dynamic shared memory, in float4s: lane_groups' slice
// (window rows, two staging buffers, the compacted j-slots), then the
// compacted i-slots (16 [x, y, vx, vy], then 16 [p, vol, mask, slot]).
constexpr int kFlatF4 = group_f4<kWindows>(kNarr, kCap) + kNarr * kCap;

__global__ void __launch_bounds__(kThreads)
ac1_flat_kernel(const float* __restrict__ packed, const int* __restrict__ nbr,
                int C, float inv_h, float dw_scale, float inv_rho0c0,
                float* __restrict__ out) {
  extern __shared__ float4 group_smem[];
  const Group<kWarp> g;
  const int64_t cell = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  if (cell >= C) return;  // whole warps
  float4* mine = group_smem + (threadIdx.x / kWarp) * kFlatF4;
  int* rows = reinterpret_cast<int*>(mine);
  float4* buf = mine + rows_f4<kWindows>();
  float4* ci = buf + 3 * buf_f4(kNarr, kCap);
  const unsigned live = live_windows<kWindows>(g, nbr, cell, C, rows);

  // the cell's real i-slots, compacted in ascending order
  const int64_t first = cell * kCap;
  const bool has = g.lane < kCap;
  const float4* own = reinterpret_cast<const float4*>(packed) +
                      (first + (has ? g.lane : 0)) * kNarr;
  const float4 a = __ldg(own);
  const float4 b = __ldg(own + 1);
  const bool real = has && PackedSlots::real(PackedSlots::key(b));
  const unsigned ireal = g.ballot(real);
  const int n_i = __popc(ireal);
  if (real) {
    const int k = __popc(ireal & ((1u << g.lane) - 1u));
    ci[k] = a;
    ci[kCap + k] = PackedSlots::tag(b, first + g.lane);
  }
  g.sync();

  // Pair q = j P + i of a segment (i fastest, P = n_i rounded up to a
  // power of 2) goes to lane q % 32: a lane keeps one i (l % P) and takes
  // every (32 / P)-th real j from l / P; lanes with i >= n_i idle.
  const int lg = n_i > 1 ? 32 - __clz(n_i - 1) : 0;   // P = 1 << lg
  const int ii = g.lane & ((1 << lg) - 1);
  float fx = 0.0f, fy = 0.0f, rd = 0.0f;
  if (live != 0u && n_i != 0) {
    const float4 xi = ci[ii < n_i ? ii : 0];
    const float4 pi = ci[kCap + (ii < n_i ? ii : 0)];
    auto stage = [&](bool, int row, int m, float4* dst) {
      stage_packed(g, dst, packed, kCap, row, m);
    };
    auto sum = [&](bool, int count, const float4* cmp) {
      if (ii >= n_i) return;
      for (int j = g.lane >> lg; j < count; j += kWarp >> lg) {
        const float4 xj = cmp[2 * j];
        const float4 pj = cmp[2 * j + 1];
        const float m = __float_as_int(pj.w) == __float_as_int(pi.w)
                            ? 0.0f : pi.z * pj.z;
        const float3 d = ac1_pair(xi.x - xj.x, xi.y - xj.y, pi.x, pj.x, m,
                                  pj.y, inv_h, dw_scale, inv_rho0c0);
        fx -= d.x;
        fy -= d.y;
        rd += d.z;
      }
    };
    walk_rows<PackedSlots>(g, live, 0u, rows, nullptr, kCap, 0, kNarr,
                           kSegSlots6, buf, stage, sum);
    // the 32 / P lanes of each i: a butterfly, the same order every run
    for (int off = 1 << lg; off < kWarp; off <<= 1) {
      fx += __shfl_xor_sync(g.mask, fx, off);
      fy += __shfl_xor_sync(g.mask, fy, off);
      rd += __shfl_xor_sync(g.mask, rd, off);
    }
  }
  // lane k < n_i holds compacted i-slot k (l < P: i = l); padding slots
  // get zeros
  const int64_t plane = (int64_t)C * kCap;
  if (has && !real) {
    out[first + g.lane] = 0.0f;
    out[plane + first + g.lane] = 0.0f;
    out[2 * plane + first + g.lane] = 0.0f;
  }
  if (g.lane < n_i) {
    const int64_t o = __float_as_int(ci[kCap + g.lane].w);
    out[o] = fx;
    out[plane + o] = fy;
    out[2 * plane + o] = rd;
  }
}

// ---------------------------------------------------------------------------
// B7: one thread per (i-slot, cell) on the channel-major pre-gathered input.
// ---------------------------------------------------------------------------
constexpr int kTileC = 32;   // cells a block (one warp per i-slot)
constexpr int kStaged = 4;   // planes staged a live j-row: x, y, p, vol
constexpr int kRing = 3;     // window buffers

// Channel of staged plane k (x, y, p, vol).
__device__ __forceinline__ int staged_channel(int k) {
  return k < 2 ? k : k + 2;
}

// Issues the copies of j-row j of window w's staged planes, cells
// c0 .. c0 + 31, into dst[k][j][*]; cells past C get zeros.  kVec: one
// 16-byte copy a lane (C % 4 == 0), else four 4-byte copies a lane.
template <bool kVec>
__device__ __forceinline__ void stage_row(float (*dst)[kCap][kTileC],
                                          const float* __restrict__ xj_t,
                                          int64_t plane, int C, int w, int j,
                                          int64_t c0, int t) {
  const float* src = xj_t + (int64_t)w * kCh * plane + (int64_t)j * C + c0;
  if constexpr (kVec) {
    const int k = t / 8;       // plane
    const int e = 4 * (t % 8); // first cell of the chunk
    float* d = &dst[k][j][e];
    if (c0 + e < C) {
      __pipeline_memcpy_async(d, src + staged_channel(k) * plane + e,
                              sizeof(float4));
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kStaged; ++k) {
      float* d = &dst[k][j][t];
      if (c0 + t < C) {
        __pipeline_memcpy_async(d, src + staged_channel(k) * plane + t,
                                sizeof(float));
      } else {
        *d = 0.0f;
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kTileC * kCap)
ac1_t_kernel(const float* __restrict__ xi_t, const float* __restrict__ xj_t,
             int C, float inv_h, float dw_scale, float inv_rho0c0,
             float* __restrict__ out) {
  __shared__ float sm[kWindows][kCap][kTileC];   // mask planes [w][j][cell]
  __shared__ __align__(16) float sv[kRing][kStaged][kCap][kTileC];
  __shared__ unsigned rowbits[kCap];             // warp y's vote
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x;
  const int i = threadIdx.y;              // also the j-row this warp stages
  const int64_t c0 = (int64_t)blockIdx.x * kTileC;
  const int64_t c = c0 + t;
  const bool live = c < C;   // a ragged last tile: stage zeros, store nothing
  const int64_t plane = (int64_t)kCap * C;   // one channel, (16, C)
  const int64_t ci = live ? c : 0;
  const float* xi = xi_t + (int64_t)i * C + ci;
  const float x_i = __ldg(xi + kX * plane);
  const float y_i = __ldg(xi + kY * plane);
  const float p_i = __ldg(xi + kP * plane);
  const float m_i = live ? __ldg(xi + kMask * plane) : 0.0f;

  // the vote: bit w of warp y's word, row y of window w has a real slot;
  // bit kWindows, i-row y has one
  unsigned bits = __ballot_sync(full, m_i != 0.0f) != 0u ? 1u << kWindows : 0u;
#pragma unroll
  for (int w = 0; w < kWindows; ++w) {
    const float m = live ? __ldg(xj_t + ((int64_t)w * kCh + kMask) * plane +
                                 (int64_t)i * C + c)
                         : 0.0f;
    sm[w][i][t] = m;
    bits |= __ballot_sync(full, m != 0.0f) != 0u ? 1u << w : 0u;
  }
  if (t == 0) rowbits[i] = bits;
  __syncthreads();
  // lane w < 9 of every warp holds window w's set of live j-rows, lane 9
  // the set of live i-rows
  unsigned set = 0u;
  if (t <= kWindows) {
    for (int r = 0; r < kCap; ++r) set |= ((rowbits[r] >> t) & 1u) << r;
  }
  const unsigned irows = __shfl_sync(full, set, kWindows);
  const bool mine = (irows >> i) & 1u;

  float fx = 0.0f, fy = 0.0f, rd = 0.0f;
  if (irows != 0u) {   // the same for the whole block
    unsigned rest = __ballot_sync(full, t < kWindows && set != 0u);
    // stages the next live window into ring buffer b; returns it (-1: none)
    auto issue = [&](int b) {
      int w = -1;
      if (rest != 0u) {
        w = __ffs(rest) - 1;
        rest &= rest - 1u;
        const unsigned js = __shfl_sync(full, set, w);
        if ((js >> i) & 1u) stage_row<kVec>(sv[b], xj_t, plane, C, w, i, c0, t);
      }
      __pipeline_commit();
      return w;
    };
    int w = issue(0);
    int w_next = issue(1);
    for (int b = 0; w >= 0; b = b + 1 == kRing ? 0 : b + 1) {
      __pipeline_wait_prior(1);
      __syncthreads();   // window w is staged; every warp is done with w - 1
      const int w_new = issue(b + 2 < kRing ? b + 2 : b + 2 - kRing);
      const unsigned js = __shfl_sync(full, set, w);
      if (mine) {
        const float (*v)[kCap][kTileC] = sv[b];
        float sx = 0.0f, sy = 0.0f, sr = 0.0f;
        for (unsigned r = js; r != 0u; r &= r - 1u) {
          const int j = __ffs(r) - 1;
          const float m = (w == kCentre && i == j) ? 0.0f : m_i * sm[w][j][t];
          const float3 d = ac1_pair(x_i - v[0][j][t], y_i - v[1][j][t], p_i,
                                    v[2][j][t], m, v[3][j][t], inv_h,
                                    dw_scale, inv_rho0c0);
          sx += d.x;
          sy += d.y;
          sr += d.z;
        }
        fx -= sx;
        fy -= sy;
        rd += sr;
      }
      w = w_next;
      w_next = w_new;
    }
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
  const unsigned nb = group_blocks<kWarp>(C);
  if (nb == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)(kThreads / kWarp) * kFlatF4 * sizeof(float4);
  ac1_flat_kernel<<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, nbr, C, inv_h, dw_scale, inv_rho0c0, out);
  return (int)cudaGetLastError();
}

int ac1_t_launch(const float* xi_t, const float* xj_t, int C, float inv_h,
                 float dw_scale, float inv_rho0c0, float* out, void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  const unsigned nb = (unsigned)((C + kTileC - 1) / kTileC);
  const dim3 block(kTileC, kCap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(xj_t) % 16 == 0) {
    ac1_t_kernel<true><<<nb, block, 0, s>>>(xi_t, xj_t, C, inv_h, dw_scale,
                                            inv_rho0c0, out);
  } else {
    ac1_t_kernel<false><<<nb, block, 0, s>>>(xi_t, xj_t, C, inv_h, dw_scale,
                                             inv_rho0c0, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
