// Cell-block pair sweeps of the WCSPH solver for Hopper (sm_90a).
//
// Counterparts of the Pallas kernels in sphinxsys_tpu/ops/pallas_block2.py:
//   density_kernel  <- _dens_kernel     (density_sweep_t)
//   ac1_kernel      <- _ac1_kernel      (ac1_sweep_t)
//   ac2_kernel      <- _ac2_kernel      (ac2_sweep_t)
//   visc_tvc_kernel <- _visctvc_kernel  (visc_tvc_sweep_t)
// ported for their meaning, not their TPU tiling.  The plain PyTorch
// versions in sphinxsys_tpu_torch/ops/block_sweeps.py compute the same sums.
//
// Layout: block arrays in their natural (rows, cap, channels) layout —
// fluid fields (C+1, cap, .), wall fields (Cw+1, capw, .), the last row
// of each the all-padding sentinel — and the (C, 3^DIM) int32 window maps
// nbr_block / nbr_wall.  A window whose row is the sentinel is skipped:
// padding slots are parked FAR_AWAY (1e16) with VolumetricMeasure 0, so
// they contribute exactly zero to every sum, and a sentinel row holds
// padding only.
//
// All four kernels: one lane group per cell.  What bounds them on this card
// is slot-pair issue, not HBM: at 1M particles their bytes take 0.01-0.06
// ms, but the first design (a thread per (cell, i-slot) looping over every
// j-slot up to cap) issued a global load per channel per slot pair, 3-7
// against 20-40 flops, on ~2x more slot pairs than have a real j, and its
// threads on rows past the occupied prefix still read the whole window
// map.  The design:
//   * a group of G lanes (16 for cap <= 16, else 32) per cell, lane l on
//     i-slot l, in i-chunks of G for cap > G; register accumulators, no
//     atomics, so results are deterministic;
//   * the group reads the cell's window map once, a lane an entry, and
//     votes (__ballot_sync): a cell with no live window, or an i-chunk with
//     no real slot, writes zeros and stops;
//   * live windows are staged once for the group in its own slice of shared
//     memory, a segment at a time (up to 3 windows whose block rows follow
//     one another: one contiguous run of slots), repacked as float4
//     (x, y, z, w) plus up to two channel float4s by 4-byte cp.async
//     copies, double-buffered so that the next segment's copies are in
//     flight while one is summed.  w is VOL, except in B1's fluid rows,
//     where it is the mask.  TMA buys nothing for gathered runs of
//     0.2-2 KB;
//   * only real j-slots are summed: the group votes w > 0 over the staged
//     segment and copies its real slots, in order, to the front of a third
//     buffer, so the pair loop is dense, one to three broadcast LDS.128 per
//     slot pair.  Every term of B2-B4 carries dW V_j, and B1's carry
//     mask_j (fluid) or V_k (wall), so a slot with w = 0 adds exactly +-0,
//     wherever the padding sits and under the periodic wrap too;
//   * split: when all of a group's real i-slots lie in its lower half,
//     lanes l and l + G/2 both sum for slot l, over the even and the odd
//     real j of each segment, and one shuffle adds the halves;
//   * only warp barriers (__syncwarp on the group's lanes), never a block
//     barrier.
// Each lane sums in the first design's order (windows in order, j
// ascending), split lanes each over their half, so real slots agree with
// it to f32 roundoff; in B2/B3 bitwise where a group does not split (B1's
// r and B4's viscous quotient are rounded differently, see there).  Padding
// i-slots (VOL 0; B1: mask 0) get zeros: the callers scale every output by
// the slot's VOL or mask it, or (B1's density without a free surface)
// write padding values that no real slot reads.
//
// Periodic boxes: each launcher takes the box lengths (Lx, Ly, Lz) as
// doubles, 0 where an axis does not wrap, and every pair displacement takes
// the minimum image d - L rint(d * (1/L)) on the wrapping axes, as
// pallas_block2._make_wrap does (1/L formed in double, then rounded to
// float; rintf rounds half to even, as jnp.round does).  The wrap folds
// FAR-parked padding back into range, so padding stays inert only because
// it carries VolumetricMeasure 0 (and mask 0 in B1): keep both, and never
// build with --use_fast_math.
//
// Every launcher returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lane_groups.cuh"

namespace {

template <int DIM>
struct NW {
  static constexpr int value = DIM == 2 ? 9 : 27;
};

// dW/dr * V_j with the clamped-q Wendland C2 form of the Pallas kernels:
// (qc-2)^3 qc is exactly zero at the 2h cutoff, so clamping q replaces the
// support test; r2 gets +1e-15 so the self pair stays finite.
struct Pair {
  float dwv, inv_r, r;
};

__device__ __forceinline__ Pair wendland_dwv(float r2_no_eps, float vol_j,
                                             float inv_h, float dw_scale) {
  Pair out;
  const float r2 = r2_no_eps + 1e-15f;
  out.inv_r = rsqrtf(r2);
  out.r = r2 * out.inv_r;
  const float qc = fminf(out.r * inv_h, 2.0f);
  const float t = qc - 2.0f;
  out.dwv = (dw_scale * (t * t * t) * qc) * vol_j;
  return out;
}

// Periodic lengths and their reciprocals; L = 0: the axis does not wrap.
struct Box {
  float L[3];
  float inv[3];
};

inline Box make_box(double bx, double by, double bz) {
  const double b[3] = {bx, by, bz};
  Box box;
  for (int k = 0; k < 3; ++k) {
    box.L[k] = (float)b[k];
    box.inv[k] = b[k] > 0.0 ? (float)(1.0 / b[k]) : 0.0f;
  }
  return box;
}

inline bool box_wraps(const Box& box) {
  return box.L[0] > 0.0f || box.L[1] > 0.0f || box.L[2] > 0.0f;
}

// WRAP is a template flag so that a box without periodic axes runs the
// plain displacement: the per-pair test and wrap cost ~25% in the 3D
// dambreak sweeps when left to run time.
template <bool WRAP>
__device__ __forceinline__ float min_image(float d, int k, const Box& box) {
  if (!WRAP) return d;
  return box.L[k] > 0.0f ? d - box.L[k] * rintf(d * box.inv[k]) : d;
}

__device__ __forceinline__ float sign0(float x) {
  // jnp.sign: 0 at 0 (copysignf would give +-1; e.n == 0 does happen for
  // lattice particles beside a flat wall)
  return (float)((x > 0.0f) - (x < 0.0f));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

// Copies of the DIM channels of slots [0, n) of the row at slot `base` of
// `src` into components 0..DIM-1 of dst[j]; of one channel into component
// `k` of dst[j].
template <int DIM, int G>
__device__ __forceinline__ void stage_vec(const Group<G>& g, float4* dst,
                                          const float* src, int64_t base,
                                          int n) {
  for (int j = g.lane; j < n; j += G) {
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      copy4(reinterpret_cast<float*>(dst + j) + k, src + (base + j) * DIM + k);
    }
  }
}

template <int G>
__device__ __forceinline__ void stage_scalar(const Group<G>& g, float4* dst,
                                             int k, const float* src,
                                             int64_t base, int n) {
  for (int j = g.lane; j < n; j += G) {
    copy4(reinterpret_cast<float*>(dst + j) + k, src + base + j);
  }
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// ---------------------------------------------------------------------------
// B1: density summation.  out (C, cap, 2) = [sig, sigw]:
//   sig  = sum_w sum_j W_ij mask_j  (self pair included: W(0) is the seed)
//   sigw = sum_w sum_k W_ik V_k     (wall)
// Staged: (x, y, z, mask) (fluid) or (x, y, z, VOL) (wall), one float4 a
// slot; a lane's i-slot is real where its mask is.  Bound, like B2-B4, by
// slot-pair issue: the first design read 3-4 floats from global memory per
// slot pair for ~20 flops.
// ---------------------------------------------------------------------------

// W_ij w_j of the staged slot xj = (x, y, z, w), Wendland C2 with q clamped
// at 2.  r = r2 rsqrtf(r2), as in B2-B4, but guarded instead of offset by
// an epsilon: the self pair's r2 is exactly 0, where r2 rsqrtf(r2) is
// 0 * inf, and r = 0 gives W(0) = factor_w exactly.  The correctly rounded
// sqrtf (a subroutine with a slow-path branch) made the TG sweep 0.333 ms
// against 0.266 ms with this form (H100, 700 W, benchmarks/ab_sweeps.py).
template <int DIM, bool WRAP>
__device__ __forceinline__ float density_term(const float* xi,
                                              const float4& xj, float inv_h,
                                              float factor_w, const Box& box) {
  float r2 = 0.0f;
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    const float d = min_image<WRAP>(xi[k] - comp(xj, k), k, box);
    r2 += d * d;
  }
  const float r = r2 > 0.0f ? r2 * rsqrtf(r2) : 0.0f;
  const float qc = fminf(r * inv_h, 2.0f);
  const float t = 1.0f - 0.5f * qc;
  return factor_w * (t * t * t * t) * (2.0f * qc + 1.0f) * xj.w;
}

template <int DIM, bool WRAP, int G>
__global__ void __launch_bounds__(kThreads)
    density_kernel(const float* __restrict__ pos,
                   const float* __restrict__ mask, const int* __restrict__ nbr,
                   int C, int cap, const float* __restrict__ wpos,
                   const float* __restrict__ wvol,
                   const int* __restrict__ nbr_w, int Cw, int capw,
                   float inv_h, float factor_w, Box box, int nmax,
                   float* __restrict__ out) {
  constexpr int NWIN = NW<DIM>::value;
  constexpr int NARR = 1;
  extern __shared__ float4 group_smem[];
  const Group<G> g;
  const int64_t cell = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (cell >= C) return;  // whole groups
  float4* mine = group_smem + (threadIdx.x / G) * group_f4<NWIN>(NARR, nmax);
  int* rows = reinterpret_cast<int*>(mine);
  int* wrows = rows + NWIN;
  float4* buf = mine + rows_f4<NWIN>();
  const int arr = seg_rows(nmax) * nmax;  // slots of a staged array
  const unsigned fluid = live_windows<NWIN>(g, nbr, cell, C, rows);
  const unsigned wall =
      nbr_w != nullptr ? live_windows<NWIN>(g, nbr_w, cell, Cw, wrows) : 0u;
  g.sync();

  for (int i0 = 0; i0 < cap; i0 += G) {
    const Slot s = lane_slot(g, cell, cap, i0, mask);
    float xi[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) xi[k] = s.has ? pos[s.gs * DIM + k] : 0.0f;
    float sig = 0.0f, sigw = 0.0f;

    auto stage = [&](bool is_wall, int row, int m, float4* dst) {
      if (!is_wall) {
        const int64_t base = (int64_t)row * cap;
        stage_vec<DIM>(g, dst, pos, base, m * cap);
        stage_scalar(g, dst, 3, mask, base, m * cap);
      } else {
        const int64_t base = (int64_t)row * capw;
        stage_vec<DIM>(g, dst, wpos, base, m * capw);
        stage_scalar(g, dst, 3, wvol, base, m * capw);
      }
    };
    auto sum = [&](bool is_wall, int count, const float4* src) {
      if (!is_wall) {
        for_each_slot(g, s.split, count, [&](int j) {
          sig += density_term<DIM, WRAP>(xi, src[j], inv_h, factor_w, box);
        });
      } else {
        for_each_slot(g, s.split, count, [&](int j) {
          sigw += density_term<DIM, WRAP>(xi, src[j], inv_h, factor_w, box);
        });
      }
    };
    if ((fluid | wall) != 0u && s.real != 0u) {
      walk_rows(g, fluid, wall, rows, wrows, cap, capw, NARR, arr, buf,
                stage, sum);
      if (s.split) {
        sig = fold_halves(g, sig);
        sigw = fold_halves(g, sigw);
      }
    }
    if (s.own) {
      out[s.go * 2 + 0] = s.own_real ? sig : 0.0f;
      out[s.go * 2 + 1] = s.own_real ? sigw : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// B2: first acoustic half (pressure relaxation).  out (C, cap, DIM+1):
//   f_i  = -sum (p_i + p_j) dW V_j e_ij
//   rd_i =  sum (p_i - p_j) dW V_j * inv_rho0c0
// wall term: p_w = p_i + rho_i r max((a_i - a_w).(-e), 0)  (a_w = 0 when
// MOVING is false)
// Staged: (x, y, z, VOL) and p (fluid) or the wall acceleration (MOVING).
// ---------------------------------------------------------------------------
template <int DIM, bool MOVING, bool WRAP, int G>
__global__ void __launch_bounds__(kThreads)
    ac1_kernel(const float* __restrict__ pos, const float* __restrict__ p,
               const float* __restrict__ rho, const float* __restrict__ acc,
               const float* __restrict__ vol, const int* __restrict__ nbr,
               int C, int cap, const float* __restrict__ wpos,
               const float* __restrict__ wvol, const float* __restrict__ wacc,
               const int* __restrict__ nbr_w, int Cw, int capw, float inv_h,
               float dw_scale, float inv_rho0c0, Box box, int nmax,
               float* __restrict__ out) {
  constexpr int NWIN = NW<DIM>::value;
  constexpr int NARR = 2;
  extern __shared__ float4 group_smem[];
  const Group<G> g;
  const int64_t cell = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (cell >= C) return;  // whole groups
  float4* mine = group_smem + (threadIdx.x / G) * group_f4<NWIN>(NARR, nmax);
  int* rows = reinterpret_cast<int*>(mine);
  int* wrows = rows + NWIN;
  float4* buf = mine + rows_f4<NWIN>();
  const int arr = seg_rows(nmax) * nmax;  // slots of a staged array
  const unsigned fluid = live_windows<NWIN>(g, nbr, cell, C, rows);
  const unsigned wall =
      nbr_w != nullptr ? live_windows<NWIN>(g, nbr_w, cell, Cw, wrows) : 0u;
  g.sync();

  for (int i0 = 0; i0 < cap; i0 += G) {
    const Slot s = lane_slot(g, cell, cap, i0, vol);
    const int64_t gi = s.gs;
    float xi[DIM], a_i[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      xi[k] = s.has ? pos[gi * DIM + k] : 0.0f;
      a_i[k] = s.has && nbr_w != nullptr ? acc[gi * DIM + k] : 0.0f;
    }
    const float p_i = s.has ? p[gi] : 0.0f;
    const float rho_i = s.has && nbr_w != nullptr ? rho[gi] : 0.0f;

    float f[DIM], fw[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) f[k] = fw[k] = 0.0f;
    float rd = 0.0f, rdw = 0.0f;

    auto stage = [&](bool is_wall, int row, int m, float4* dst) {
      if (!is_wall) {
        const int64_t base = (int64_t)row * cap;
        stage_vec<DIM>(g, dst, pos, base, m * cap);
        stage_scalar(g, dst, 3, vol, base, m * cap);
        stage_scalar(g, dst + arr, 0, p, base, m * cap);
      } else {
        const int64_t base = (int64_t)row * capw;
        stage_vec<DIM>(g, dst, wpos, base, m * capw);
        stage_scalar(g, dst, 3, wvol, base, m * capw);
        if constexpr (MOVING) {
          stage_vec<DIM>(g, dst + arr, wacc, base, m * capw);
        }
      }
    };
    auto sum = [&](bool is_wall, int count, const float4* src) {
      if (!is_wall) {
        for_each_slot(g, s.split, count, [&](int j) {
          const float4 xj = src[j];
          float d[DIM];
          float r2 = 0.0f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            d[k] = min_image<WRAP>(xi[k] - comp(xj, k), k, box);
            r2 += d[k] * d[k];
          }
          const Pair q = wendland_dwv(r2, xj.w, inv_h, dw_scale);
          const float p_j = src[arr + j].x;
          const float psum = (p_i + p_j) * q.dwv * q.inv_r;
#pragma unroll
          for (int k = 0; k < DIM; ++k) f[k] -= psum * d[k];
          rd += (p_i - p_j) * q.dwv;
        });
      } else {
        for_each_slot(g, s.split, count, [&](int j) {
          const float4 xj = src[j];
          float d[DIM];
          float r2 = 0.0f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            d[k] = min_image<WRAP>(xi[k] - comp(xj, k), k, box);
            r2 += d[k] * d[k];
          }
          const Pair q = wendland_dwv(r2, xj.w, inv_h, dw_scale);
          float4 aw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if constexpr (MOVING) aw = src[arr + j];
          float face_acc = 0.0f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            const float e = d[k] * q.inv_r;
            const float da = MOVING ? a_i[k] - comp(aw, k) : a_i[k];
            face_acc += da * (-e);
          }
          const float p_w = p_i + rho_i * q.r * fmaxf(face_acc, 0.0f);
          const float psum = (p_i + p_w) * q.dwv * q.inv_r;
#pragma unroll
          for (int k = 0; k < DIM; ++k) fw[k] -= psum * d[k];
          rdw += (p_i - p_w) * q.dwv;
        });
      }
    };
    if ((fluid | wall) != 0u && s.real != 0u) {
      walk_rows(g, fluid, wall, rows, wrows, cap, capw, NARR, arr, buf,
                stage, sum);
      if (s.split) {
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          f[k] = fold_halves(g, f[k]);
          fw[k] = fold_halves(g, fw[k]);
        }
        rd = fold_halves(g, rd);
        rdw = fold_halves(g, rdw);
      }
    }

    rd *= inv_rho0c0;
    if (nbr_w != nullptr) {
#pragma unroll
      for (int k = 0; k < DIM; ++k) f[k] += fw[k];
      rd += rdw * inv_rho0c0;
    }
    if (s.own) {
      const int64_t go = s.go * (DIM + 1);
#pragma unroll
      for (int k = 0; k < DIM; ++k) out[go + k] = s.own_real ? f[k] : 0.0f;
      out[go + DIM] = s.own_real ? rd : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// B3: second acoustic half (density relaxation).  out (C, cap, DIM+1):
//   dcr_i = sum (v_i - v_j).e dW V_j
//   f_i   = sum rho0c0_geo u min(lim_scale max(u, 0), 1) dW V_j e_ij
// wall term: the jump is mirrored to 2 (v_i - v_w) along sign(e.n) n
// (v_w = 0 when MOVING is false)
// Staged: (x, y, z, VOL) and the velocity (fluid); (x, y, z, VOL), the
// normal and, MOVING, the velocity (wall).
// ---------------------------------------------------------------------------
template <int DIM, bool MOVING, bool WRAP, int G>
__global__ void __launch_bounds__(kThreads)
    ac2_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
               const float* __restrict__ vol, const int* __restrict__ nbr,
               int C, int cap, const float* __restrict__ wpos,
               const float* __restrict__ wvol, const float* __restrict__ wvel,
               const float* __restrict__ wn, const int* __restrict__ nbr_w,
               int Cw, int capw, float inv_h, float dw_scale, float rho0c0_geo,
               float lim_scale, Box box, int nmax, float* __restrict__ out) {
  constexpr int NWIN = NW<DIM>::value;
  constexpr int NARR = MOVING ? 3 : 2;
  extern __shared__ float4 group_smem[];
  const Group<G> g;
  const int64_t cell = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (cell >= C) return;  // whole groups
  float4* mine = group_smem + (threadIdx.x / G) * group_f4<NWIN>(NARR, nmax);
  int* rows = reinterpret_cast<int*>(mine);
  int* wrows = rows + NWIN;
  float4* buf = mine + rows_f4<NWIN>();
  const int arr = seg_rows(nmax) * nmax;  // slots of a staged array
  const unsigned fluid = live_windows<NWIN>(g, nbr, cell, C, rows);
  const unsigned wall =
      nbr_w != nullptr ? live_windows<NWIN>(g, nbr_w, cell, Cw, wrows) : 0u;
  g.sync();

  for (int i0 = 0; i0 < cap; i0 += G) {
    const Slot s = lane_slot(g, cell, cap, i0, vol);
    const int64_t gi = s.gs;
    float xi[DIM], v_i[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      xi[k] = s.has ? pos[gi * DIM + k] : 0.0f;
      v_i[k] = s.has ? vel[gi * DIM + k] : 0.0f;
    }

    float f[DIM], fw[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) f[k] = fw[k] = 0.0f;
    float dcr = 0.0f, dcrw = 0.0f;

    auto stage = [&](bool is_wall, int row, int m, float4* dst) {
      if (!is_wall) {
        const int64_t base = (int64_t)row * cap;
        stage_vec<DIM>(g, dst, pos, base, m * cap);
        stage_scalar(g, dst, 3, vol, base, m * cap);
        stage_vec<DIM>(g, dst + arr, vel, base, m * cap);
      } else {
        const int64_t base = (int64_t)row * capw;
        stage_vec<DIM>(g, dst, wpos, base, m * capw);
        stage_scalar(g, dst, 3, wvol, base, m * capw);
        stage_vec<DIM>(g, dst + arr, wn, base, m * capw);
        if constexpr (MOVING) {
          stage_vec<DIM>(g, dst + 2 * arr, wvel, base, m * capw);
        }
      }
    };
    auto sum = [&](bool is_wall, int count, const float4* src) {
      if (!is_wall) {
        for_each_slot(g, s.split, count, [&](int j) {
          const float4 xj = src[j];
          const float4 vj = src[arr + j];
          float d[DIM];
          float r2 = 0.0f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            d[k] = min_image<WRAP>(xi[k] - comp(xj, k), k, box);
            r2 += d[k] * d[k];
          }
          const Pair q = wendland_dwv(r2, xj.w, inv_h, dw_scale);
          float e[DIM];
          float u = 0.0f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            e[k] = d[k] * q.inv_r;
            u += (v_i[k] - comp(vj, k)) * e[k];
          }
          dcr += u * q.dwv;
          const float lim = fminf(lim_scale * fmaxf(u, 0.0f), 1.0f);
          const float pj = rho0c0_geo * u * lim * q.dwv;
#pragma unroll
          for (int k = 0; k < DIM; ++k) f[k] += pj * e[k];
        });
      } else {
        for_each_slot(g, s.split, count, [&](int j) {
          const float4 xj = src[j];
          const float4 nj = src[arr + j];
          float4 vw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if constexpr (MOVING) vw = src[2 * arr + j];
          float d[DIM];
          float r2 = 0.0f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            d[k] = min_image<WRAP>(xi[k] - comp(xj, k), k, box);
            r2 += d[k] * d[k];
          }
          const Pair q = wendland_dwv(r2, xj.w, inv_h, dw_scale);
          float e[DIM], n[DIM], dv[DIM];
          float e_dot_n = 0.0f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            e[k] = d[k] * q.inv_r;
            n[k] = comp(nj, k);
            e_dot_n += e[k] * n[k];
            dv[k] = MOVING ? 2.0f * (v_i[k] - comp(vw, k)) : 2.0f * v_i[k];
          }
          const float sgn = sign0(e_dot_n);
          float dve = 0.0f, u = 0.0f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            dve += dv[k] * e[k];
            u += dv[k] * (sgn * n[k]);
          }
          dcrw += dve * q.dwv;
          const float lim = fminf(lim_scale * fmaxf(u, 0.0f), 1.0f);
          const float pj = rho0c0_geo * u * lim * q.dwv;
#pragma unroll
          for (int k = 0; k < DIM; ++k) fw[k] += pj * (sgn * n[k]);
        });
      }
    };
    if ((fluid | wall) != 0u && s.real != 0u) {
      walk_rows(g, fluid, wall, rows, wrows, cap, capw, NARR, arr, buf,
                stage, sum);
      if (s.split) {
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          f[k] = fold_halves(g, f[k]);
          fw[k] = fold_halves(g, fw[k]);
        }
        dcr = fold_halves(g, dcr);
        dcrw = fold_halves(g, dcrw);
      }
    }

    if (nbr_w != nullptr) {
      dcr += dcrw;
#pragma unroll
      for (int k = 0; k < DIM; ++k) f[k] += fw[k];
    }
    if (s.own) {
      const int64_t go = s.go * (DIM + 1);
      out[go] = s.own_real ? dcr : 0.0f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) out[go + 1 + k] = s.own_real ? f[k] : 0.0f;
    }
  }
}
// ---------------------------------------------------------------------------
// B4: viscous force + transport-velocity correction in one window pass
// (both read the same j data).  out (C, cap, 2 DIM) = [fv (DIM), I (DIM)]:
//   fv_i = sum (v_i - v_j) / (r + eps_r) dW V_j
//   I_i  = -sum 2 dW V_j e_ij
// wall term: the fv jump doubled, against the wall velocity (v_w = 0 when
// MOVING is false); the I term as for fluid neighbours.  The caller scales
// fv by 2 mu V_i and applies the limited TVC shift.  Bound, like B1-B3, by
// slot-pair issue: per slot pair it loads what B3 loads, and adds a
// reciprocal (visc_scale) and 4 DIM accumulators (fv, I; fluid and wall).
// Staged: (x, y, z, VOL) and the velocity (fluid); (x, y, z, VOL) and,
// MOVING, the velocity (wall).
// ---------------------------------------------------------------------------

// dW V_j / (r + eps_r) as a correctly rounded reciprocal times dW V_j: two
// roundings where the plain version's divide has one.  The IEEE divide is a
// subroutine with a slow-path branch; on an H100 (700 W) it made the TG
// sweep 0.556 ms against 0.392 ms with this form (benchmarks/ab_sweeps.py).
__device__ __forceinline__ float visc_scale(float dwv, float r_eps) {
  return __frcp_rn(r_eps) * dwv;
}

template <int DIM, bool MOVING, bool WRAP, int G>
__global__ void __launch_bounds__(kThreads)
    visc_tvc_kernel(const float* __restrict__ pos,
                    const float* __restrict__ vel,
                    const float* __restrict__ vol, const int* __restrict__ nbr,
                    int C, int cap, const float* __restrict__ wpos,
                    const float* __restrict__ wvol,
                    const float* __restrict__ wvel,
                    const int* __restrict__ nbr_w, int Cw, int capw,
                    float inv_h, float dw_scale, float eps_r, Box box,
                    int nmax, float* __restrict__ out) {
  constexpr int NWIN = NW<DIM>::value;
  constexpr int NARR = 2;
  extern __shared__ float4 group_smem[];
  const Group<G> g;
  const int64_t cell = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (cell >= C) return;  // whole groups
  float4* mine = group_smem + (threadIdx.x / G) * group_f4<NWIN>(NARR, nmax);
  int* rows = reinterpret_cast<int*>(mine);
  int* wrows = rows + NWIN;
  float4* buf = mine + rows_f4<NWIN>();
  const int arr = seg_rows(nmax) * nmax;  // slots of a staged array
  const unsigned fluid = live_windows<NWIN>(g, nbr, cell, C, rows);
  const unsigned wall =
      nbr_w != nullptr ? live_windows<NWIN>(g, nbr_w, cell, Cw, wrows) : 0u;
  g.sync();

  for (int i0 = 0; i0 < cap; i0 += G) {
    const Slot s = lane_slot(g, cell, cap, i0, vol);
    const int64_t gi = s.gs;
    float xi[DIM], v_i[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      xi[k] = s.has ? pos[gi * DIM + k] : 0.0f;
      v_i[k] = s.has ? vel[gi * DIM + k] : 0.0f;
    }

    float fv[DIM], inc[DIM], fvw[DIM], incw[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) fv[k] = inc[k] = fvw[k] = incw[k] = 0.0f;

    auto stage = [&](bool is_wall, int row, int m, float4* dst) {
      if (!is_wall) {
        const int64_t base = (int64_t)row * cap;
        stage_vec<DIM>(g, dst, pos, base, m * cap);
        stage_scalar(g, dst, 3, vol, base, m * cap);
        stage_vec<DIM>(g, dst + arr, vel, base, m * cap);
      } else {
        const int64_t base = (int64_t)row * capw;
        stage_vec<DIM>(g, dst, wpos, base, m * capw);
        stage_scalar(g, dst, 3, wvol, base, m * capw);
        if constexpr (MOVING) {
          stage_vec<DIM>(g, dst + arr, wvel, base, m * capw);
        }
      }
    };
    auto sum = [&](bool is_wall, int count, const float4* src) {
      if (!is_wall) {
        for_each_slot(g, s.split, count, [&](int j) {
          const float4 xj = src[j];
          const float4 vj = src[arr + j];
          float d[DIM];
          float r2 = 0.0f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            d[k] = min_image<WRAP>(xi[k] - comp(xj, k), k, box);
            r2 += d[k] * d[k];
          }
          const Pair q = wendland_dwv(r2, xj.w, inv_h, dw_scale);
          const float scale = visc_scale(q.dwv, q.r + eps_r);
          const float ie = 2.0f * q.dwv * q.inv_r;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            fv[k] += (v_i[k] - comp(vj, k)) * scale;
            inc[k] -= ie * d[k];
          }
        });
      } else {
        for_each_slot(g, s.split, count, [&](int j) {
          const float4 xj = src[j];
          float4 vw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if constexpr (MOVING) vw = src[arr + j];
          float d[DIM];
          float r2 = 0.0f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            d[k] = min_image<WRAP>(xi[k] - comp(xj, k), k, box);
            r2 += d[k] * d[k];
          }
          const Pair q = wendland_dwv(r2, xj.w, inv_h, dw_scale);
          const float scale = visc_scale(2.0f * q.dwv, q.r + eps_r);
          const float ie = 2.0f * q.dwv * q.inv_r;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            const float dv = MOVING ? v_i[k] - comp(vw, k) : v_i[k];
            fvw[k] += dv * scale;
            incw[k] -= ie * d[k];
          }
        });
      }
    };
    if ((fluid | wall) != 0u && s.real != 0u) {
      walk_rows(g, fluid, wall, rows, wrows, cap, capw, NARR, arr, buf,
                stage, sum);
      if (s.split) {
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          fv[k] = fold_halves(g, fv[k]);
          inc[k] = fold_halves(g, inc[k]);
          fvw[k] = fold_halves(g, fvw[k]);
          incw[k] = fold_halves(g, incw[k]);
        }
      }
    }

    if (nbr_w != nullptr) {
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        fv[k] += fvw[k];
        inc[k] += incw[k];
      }
    }
    if (s.own) {
      const int64_t go = s.go * (2 * DIM);
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        out[go + k] = s.own_real ? fv[k] : 0.0f;
        out[go + DIM + k] = s.own_real ? inc[k] : 0.0f;
      }
    }
  }
}

// Compile-time flags of one kernel instance.
template <int D, bool M, bool W>
struct Flags {
  static constexpr int dim = D;
  static constexpr bool moving = M;
  static constexpr bool wrap = W;
};

// Calls launch(Flags<dim, moving, wrap>{}) for the runtime flags; returns
// cudaGetLastError() after the launch.
template <class F>
int dispatch(int dim, bool moving, bool wrap, F&& launch) {
  if (dim == 2) {
    if (moving) {
      if (wrap) launch(Flags<2, true, true>{});
      else launch(Flags<2, true, false>{});
    } else {
      if (wrap) launch(Flags<2, false, true>{});
      else launch(Flags<2, false, false>{});
    }
  } else if (dim == 3) {
    if (moving) {
      if (wrap) launch(Flags<3, true, true>{});
      else launch(Flags<3, true, false>{});
    } else {
      if (wrap) launch(Flags<3, false, true>{});
      else launch(Flags<3, false, false>{});
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As dispatch, for the lane-group kernels: launch(flags, G) with G = 16
// lanes a cell for cap <= 16, else 32, as std::integral_constant.
template <class F>
int dispatch_grouped(int dim, bool moving, bool wrap, int cap, F&& launch) {
  if (cap <= 16) {
    return dispatch(dim, moving, wrap, [&](auto f) {
      launch(f, std::integral_constant<int, 16>{});
    });
  }
  return dispatch(dim, moving, wrap, [&](auto f) {
    launch(f, std::integral_constant<int, 32>{});
  });
}

}  // namespace

extern "C" {

int density_sweep_launch(int dim, const float* pos, const float* mask,
                         const int* nbr, int C, int cap, const float* wpos,
                         const float* wvol, const int* nbr_w, int Cw, int capw,
                         float inv_h, float factor_w, double bx, double by,
                         double bz, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0) return (int)cudaGetLastError();
  const Box box = make_box(bx, by, bz);
  const int nmax = cap > capw ? cap : capw;
  return dispatch_grouped(dim, false, box_wraps(box), cap,
                          [&](auto f, auto group) {
    using F = decltype(f);
    constexpr int G = decltype(group)::value;
    auto kernel = density_kernel<F::dim, F::wrap, G>;
    const size_t smem = group_smem_bytes<NW<F::dim>::value, G>(kernel, 1, nmax);
    kernel<<<group_blocks<G>(C), kThreads, smem, s>>>(
        pos, mask, nbr, C, cap, wpos, wvol, nbr_w, Cw, capw, inv_h, factor_w,
        box, nmax, out);
  });
}

int ac1_sweep_launch(int dim, int moving, const float* pos, const float* p,
                     const float* rho, const float* acc, const float* vol,
                     const int* nbr, int C, int cap, const float* wpos,
                     const float* wvol, const float* wacc, const int* nbr_w,
                     int Cw, int capw, float inv_h, float dw_scale,
                     float inv_rho0c0, double bx, double by, double bz,
                     float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0) return (int)cudaGetLastError();
  const Box box = make_box(bx, by, bz);
  const int nmax = cap > capw ? cap : capw;
  return dispatch_grouped(dim, moving != 0, box_wraps(box), cap,
                          [&](auto f, auto group) {
    using F = decltype(f);
    constexpr int G = decltype(group)::value;
    auto kernel = ac1_kernel<F::dim, F::moving, F::wrap, G>;
    const size_t smem = group_smem_bytes<NW<F::dim>::value, G>(kernel, 2, nmax);
    kernel<<<group_blocks<G>(C), kThreads, smem, s>>>(
        pos, p, rho, acc, vol, nbr, C, cap, wpos, wvol, wacc, nbr_w, Cw, capw,
        inv_h, dw_scale, inv_rho0c0, box, nmax, out);
  });
}

int ac2_sweep_launch(int dim, int moving, const float* pos, const float* vel,
                     const float* vol, const int* nbr, int C, int cap,
                     const float* wpos, const float* wvol, const float* wvel,
                     const float* wn, const int* nbr_w, int Cw, int capw,
                     float inv_h, float dw_scale, float rho0c0_geo,
                     float lim_scale, double bx, double by, double bz,
                     float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0) return (int)cudaGetLastError();
  const Box box = make_box(bx, by, bz);
  const int nmax = cap > capw ? cap : capw;
  return dispatch_grouped(dim, moving != 0, box_wraps(box), cap,
                          [&](auto f, auto group) {
    using F = decltype(f);
    constexpr int G = decltype(group)::value;
    auto kernel = ac2_kernel<F::dim, F::moving, F::wrap, G>;
    const size_t smem =
        group_smem_bytes<NW<F::dim>::value, G>(kernel, F::moving ? 3 : 2, nmax);
    kernel<<<group_blocks<G>(C), kThreads, smem, s>>>(
        pos, vel, vol, nbr, C, cap, wpos, wvol, wvel, wn, nbr_w, Cw, capw,
        inv_h, dw_scale, rho0c0_geo, lim_scale, box, nmax, out);
  });
}

int visc_tvc_sweep_launch(int dim, int moving, const float* pos,
                          const float* vel, const float* vol, const int* nbr,
                          int C, int cap, const float* wpos, const float* wvol,
                          const float* wvel, const int* nbr_w, int Cw,
                          int capw, float inv_h, float dw_scale, float eps_r,
                          double bx, double by, double bz, float* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0) return (int)cudaGetLastError();
  const Box box = make_box(bx, by, bz);
  const int nmax = cap > capw ? cap : capw;
  return dispatch_grouped(dim, moving != 0, box_wraps(box), cap,
                          [&](auto f, auto group) {
    using F = decltype(f);
    constexpr int G = decltype(group)::value;
    auto kernel = visc_tvc_kernel<F::dim, F::moving, F::wrap, G>;
    const size_t smem = group_smem_bytes<NW<F::dim>::value, G>(kernel, 2, nmax);
    kernel<<<group_blocks<G>(C), kThreads, smem, s>>>(
        pos, vel, vol, nbr, C, cap, wpos, wvol, wvel, nbr_w, Cw, capw, inv_h,
        dw_scale, eps_r, box, nmax, out);
  });
}

}  // extern "C"
