// Packed acoustic sweeps of the 2D WCSPH solver for Hopper (sm_90a).
//
// Counterparts of the Pallas kernels in sphinxsys_tpu/ops/pallas_sweep.py:
//   ac1_inner_kernel <- _ac1_kernel       (ac1_inner_sweep)
//   ac2_inner_kernel <- _ac2_kernel       (ac2_inner_sweep)
//   ac1_wall_kernel  <- _ac1_wall_kernel  (ac1_wall_sweep)
//   ac2_wall_kernel  <- _ac2_wall_kernel  (ac2_wall_sweep)
// ported for their meaning, not their TPU tiling.  The plain PyTorch
// versions in sphinxsys_tpu_torch/ops/packed_sweeps.py compute the same sums.
//
// Layout: every body is one packed block tensor (rows, 16, 8) float32 —
// 16 slots of 8 channels, so a slot is 32 contiguous bytes read as two
// float4 loads — whose last row is the all-padding sentinel (mask 0), and
// the (C, 9) int32 window maps nbr / nbr_wall (sentinel C / Cw).  The TPU
// kernels read a pre-gathered packed[nbr] tensor (C, 9, 16, 8); these read
// the neighbour rows through the window map directly, so that 9x copy
// (295 MB per call for the 2D dambreak at 320k particles) is never made.
// A window whose row is the sentinel is skipped: its slots have mask 0 and
// add exactly zero.
//
// Channels (pallas_sweep.py:33, :218-225):
//   inner          [x, y, vx, vy, p, vol, mask, 0]
//   ac1 wall, i    [x, y, p, rho, ax, ay, mask, 0]
//   ac1 wall, wall [x, y, vol, ax, ay, mask, 0, 0]
//   ac2 wall, i    [x, y, vx, vy, mask, 0, 0, 0]
//   ac2 wall, wall [x, y, vol, vax, vay, nx, ny, mask]
//
// Pair arithmetic exactly as the TPU kernels form it (pallas_sweep.py:50-74,
// :228-236): r = sqrt(dx^2 + dy^2 + 1e-15), e = d * (1/r) (not the rsqrt
// form of block_sweeps.cu), dW/dr = (q < 2) ? S (qc-2)^3 qc : 0 with
// qc = min(q, 2) and S = factor_w/h * 0.625 formed in double by the
// launcher's caller; every pair is multiplied by mask_i mask_j, and the
// inner sweeps drop the self pair (centre window 4, j == i).  Padding may
// carry any finite volume (the mask alone keeps it inert), so never build
// with --use_fast_math.
//
// The inner sweeps (B5a, B5b): lane groups (lane_groups.cuh), as B1-B4.
// At the 2D dambreak's bench width their bytes take ~0.012 ms on an H100;
// what bounds them is slot-pair issue.  The first design (a thread per
// (cell, i-slot) looping over the 16 j-slots of every live window) issued
// two float4 loads per slot pair, on 17x more slot pairs than real pairs
// (padding j-slots, and i-threads of padding slots walking every window).
// The design:
//   * 16 lanes per cell, lane l on i-slot l; register accumulators, no
//     atomics, so results are deterministic;
//   * the group reads the cell's window map once and votes: a cell with no
//     live window or no real slot writes zeros and stops;
//   * live windows are staged in the group's slice of shared memory a
//     segment (up to 3 consecutive block rows, 1.5 KB contiguous) at a time,
//     whole slots as they lie, by 16-byte cp.async (two per slot),
//     double-buffered;
//   * only real j-slots (mask != 0) are summed: the group compacts them in
//     order, each copy carrying its global slot index in the unused
//     channel 7, and a lane drops the slot equal to its own (the self pair
//     by index: with nbr[:, 4] the cell's own row and no window repeated,
//     as without a periodic box, this is JAX's (window 4, j == i) test).
//     mask_i mask_j stays in every term, so a slot of mask 0 adds exactly
//     +-0 and one of any other mask keeps its weight;
//   * split: when a cell's real i-slots fit in lanes 0-7, lanes l and l + 8
//     sum for slot l over the even and the odd real j, and one shuffle adds
//     the halves (about 5 real particles a cell: almost every cell).
// Each lane sums in the first design's order (windows in order, j
// ascending), split lanes each over their half, so real slots agree with it
// to f32 roundoff.  Padding i-slots get zeros (mask_i = 0 gives them).
//
// The wall sweeps (B5c, B5d): lane groups too, from the same helpers.  Their
// bytes take ~0.005 ms on an H100 at the 2D dambreak's bench width, but the
// first design (a thread per (cell, i-slot) that loaded its 32-byte i-slot,
// read all 9 map entries and walked the 16 slots of every live wall window)
// moved ~3x those bytes: only ~1.4% of the cells there have a wall window,
// and it read every i-slot all the same.  The design:
//   * 16 lanes per cell (two cells a warp), lane l on i-slot l; the group
//     reads the cell's wall map row, a lane an entry, and votes: a cell
//     with no live wall window writes its 192 bytes of zeros, one float4
//     store a lane, and stops without reading packed_i;
//   * a live cell votes on its real i-slots (the i-side mask, channel 6
//     for ac1, 4 for ac2) and stops the same way if it has none; only then
//     does a lane load its 32-byte i-slot;
//   * the live wall rows are staged as B5a/B5b stage theirs, in the same
//     slice of shared memory (whole slots, 16-byte cp.async, segments of up
//     to 2 consecutive rows, double-buffered), and only real wall slots
//     are summed: the wall mask lies in channel 5 (ac1) or 7 (ac2) and the
//     compacted copy keeps the slot as it is (PackedWallSlots); a wall
//     sweep has no self pair;
//   * split as B5a/B5b: when a cell's real i-slots fit in lanes 0-7, lanes
//     l and l + 8 sum over the even and the odd real wall slots.
// The pair arithmetic is the first design's; each lane sums in its order
// (windows in order, slots ascending), split lanes each over their half, so
// real slots agree with it to f32 roundoff.
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
constexpr int kMask = 6;  // the mask channel of the inner layout

// One packed slot's 8 channels.
struct Slot8 {
  float c[kCh];
};

__device__ __forceinline__ Slot8 load_slot(const float* __restrict__ base) {
  const float4* p = reinterpret_cast<const float4*>(base);
  const float4 a = __ldg(p);
  const float4 b = __ldg(p + 1);
  return Slot8{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// Pair geometry and masked dW/dr of one slot pair.
struct Geom {
  float r, ex, ey, dw;
};

__device__ __forceinline__ Geom pair_geom(float xi, float yi, float xj,
                                          float yj, float m, float inv_h,
                                          float dw_scale) {
  Geom g;
  const float dx = xi - xj;
  const float dy = yi - yj;
  g.r = sqrtf(dx * dx + dy * dy + 1e-15f);
  const float inv_r = 1.0f / g.r;
  g.ex = dx * inv_r;
  g.ey = dy * inv_r;
  const float q = g.r * inv_h;
  const float qc = fminf(q, 2.0f);
  const float t = qc - 2.0f;
  g.dw = (q < 2.0f ? dw_scale * (t * t * t) * qc : 0.0f) * m;
  return g;
}

__device__ __forceinline__ float sign0(float x) {
  // jnp.sign: 0 at 0 (e.n == 0 does happen beside a flat wall)
  return (float)((x > 0.0f) - (x < 0.0f));
}

// ---------------------------------------------------------------------------
// B5a / B5b: inner sweeps, one 16-lane group per cell (see the top).
// ---------------------------------------------------------------------------
constexpr int kNarr = 2;                             // float4 parts a slot
constexpr int kSegSlotsPacked = seg_rows(kCap) * kCap;  // slots a buffer

// The group's state for one cell: its slice of shared memory, its live
// windows and this lane's i-slot (lane_slot on the mask channel).
struct InnerCell {
  float4* buf;
  int* rows;
  unsigned live;
  Slot s;
};

__device__ __forceinline__ InnerCell inner_cell(
    const Group<kCap>& g, float4* smem, const float* __restrict__ packed,
    const int* __restrict__ nbr, int64_t cell, int C) {
  InnerCell ic;
  float4* mine = smem + (threadIdx.x / kCap) * group_f4<kWindows>(kNarr, kCap);
  ic.rows = reinterpret_cast<int*>(mine);
  ic.buf = mine + rows_f4<kWindows>();
  ic.live = live_windows<kWindows>(g, nbr, cell, C, ic.rows);
  g.sync();
  ic.s = lane_slot<PackedSlots>(g, cell, kCap, 0, packed + kMask);
  return ic;
}

// Walks the cell's live windows and calls pair(xj, cj, m) for every real
// j-slot of this lane's half (xj = [x, y, vx, vy], cj = [p, vol, mask,
// slot index]) with m = mask_i mask_j, 0 for the lane's own slot.
template <class Pair>
__device__ __forceinline__ void inner_pairs(const Group<kCap>& g,
                                            const InnerCell& ic,
                                            const float* __restrict__ packed,
                                            float mask_i, Pair&& pair) {
  const int self = (int)ic.s.gs;
  auto stage = [&](bool, int row, int m, float4* dst) {
    stage_packed(g, dst, packed, kCap, row, m);
  };
  auto sum = [&](bool, int count, const float4* src) {
    for_each_slot(g, ic.s.split, count, [&](int j) {
      const float4 xj = src[2 * j];
      const float4 cj = src[2 * j + 1];
      pair(xj, cj, __float_as_int(cj.w) == self ? 0.0f : mask_i * cj.z);
    });
  };
  walk_rows<PackedSlots>(g, ic.live, 0u, ic.rows, nullptr, kCap, 0, kNarr,
                         kSegSlotsPacked, ic.buf, stage, sum);
}

// ---------------------------------------------------------------------------
// B5a: 1st-half inner sweep.  out (C, 16, 3) = [fx, fy, rd]:
//   f_i  = -sum (p_i + p_j) dW V_j e_ij
//   rd_i =  sum (p_i - p_j) inv_rho0c0 dW V_j
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    ac1_inner_kernel(const float* __restrict__ packed,
                     const int* __restrict__ nbr, int C, float inv_h,
                     float dw_scale, float inv_rho0c0,
                     float* __restrict__ out) {
  extern __shared__ float4 group_smem[];
  const Group<kCap> g;
  const int64_t cell = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kCap;
  if (cell >= C) return;  // whole groups
  const InnerCell ic = inner_cell(g, group_smem, packed, nbr, cell, C);
  const Slot8 si = load_slot(packed + ic.s.gs * kCh);
  const float p_i = si.c[4];
  float fx = 0.0f, fy = 0.0f, rd = 0.0f;
  if (ic.live != 0u && ic.s.real != 0u) {
    inner_pairs(g, ic, packed, si.c[kMask],
                [&](const float4& xj, const float4& cj, float m) {
      const Geom q = pair_geom(si.c[0], si.c[1], xj.x, xj.y, m, inv_h,
                               dw_scale);
      const float dwv = q.dw * cj.y;
      const float p_j = cj.x;
      const float psum = (p_i + p_j) * dwv;
      fx -= psum * q.ex;
      fy -= psum * q.ey;
      rd += (p_i - p_j) * inv_rho0c0 * dwv;
    });
    if (ic.s.split) {
      fx = fold_halves(g, fx);
      fy = fold_halves(g, fy);
      rd = fold_halves(g, rd);
    }
  }
  const bool keep = ic.s.own_real;
  out[ic.s.go * 3 + 0] = keep ? fx : 0.0f;
  out[ic.s.go * 3 + 1] = keep ? fy : 0.0f;
  out[ic.s.go * 3 + 2] = keep ? rd : 0.0f;
}

// ---------------------------------------------------------------------------
// B5b: 2nd-half inner sweep.  out (C, 16, 3) = [dcr, fx, fy]:
//   u     = (v_i - v_j).e_ij
//   dcr_i = sum u dW V_j
//   f_i   = sum rho0c0_geo u min(lim_scale max(u, 0), 1) dW V_j e_ij
// (lim_scale = limiter_coeff * inv_c0, formed in double by the caller)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    ac2_inner_kernel(const float* __restrict__ packed,
                     const int* __restrict__ nbr, int C, float inv_h,
                     float dw_scale, float rho0c0_geo, float lim_scale,
                     float* __restrict__ out) {
  extern __shared__ float4 group_smem[];
  const Group<kCap> g;
  const int64_t cell = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kCap;
  if (cell >= C) return;  // whole groups
  const InnerCell ic = inner_cell(g, group_smem, packed, nbr, cell, C);
  const Slot8 si = load_slot(packed + ic.s.gs * kCh);
  float dcr = 0.0f, fx = 0.0f, fy = 0.0f;
  if (ic.live != 0u && ic.s.real != 0u) {
    inner_pairs(g, ic, packed, si.c[kMask],
                [&](const float4& xj, const float4& cj, float m) {
      const Geom q = pair_geom(si.c[0], si.c[1], xj.x, xj.y, m, inv_h,
                               dw_scale);
      const float dwv = q.dw * cj.y;
      const float du = si.c[2] - xj.z;
      const float dv = si.c[3] - xj.w;
      const float u = du * q.ex + dv * q.ey;
      dcr += u * dwv;
      const float lim = fminf(lim_scale * fmaxf(u, 0.0f), 1.0f);
      const float pjump = rho0c0_geo * u * lim * dwv;
      fx += pjump * q.ex;
      fy += pjump * q.ey;
    });
    if (ic.s.split) {
      dcr = fold_halves(g, dcr);
      fx = fold_halves(g, fx);
      fy = fold_halves(g, fy);
    }
  }
  const bool keep = ic.s.own_real;
  out[ic.s.go * 3 + 0] = keep ? dcr : 0.0f;
  out[ic.s.go * 3 + 1] = keep ? fx : 0.0f;
  out[ic.s.go * 3 + 2] = keep ? fy : 0.0f;
}

// ---------------------------------------------------------------------------
// B5c / B5d: wall sweeps, one group per cell (see the top).
// ---------------------------------------------------------------------------
constexpr int kMaskI1 = 6;  // i-side mask channel, ac1 wall layout
constexpr int kMaskI2 = 4;  // i-side mask channel, ac2 wall layout
using Wall1Slots = PackedWallSlots<5>;  // [x, y, vol, ax | ay, mask, 0, 0]
using Wall2Slots = PackedWallSlots<7>;  // [x, y, vol, vax | vay, nx, ny, mask]

// The group's state for one live cell: its slice of shared memory (laid out
// as B5a/B5b's), its live wall windows, this lane's i-slot (lane_slot on the
// i-side mask channel) and that slot's 8 channels.
struct WallCell {
  float4* buf;
  int* rows;
  unsigned live;
  Slot s;
  Slot8 si;
};

// Zeros over the whole (16, 3) output row of `cell`: 192 contiguous bytes,
// 16-byte aligned, one float4 store a lane.
__device__ __forceinline__ void zero_cell(const Group<kCap>& g,
                                          float* __restrict__ out,
                                          int64_t cell) {
  if (g.lane < kCap * 3 / 4) {
    reinterpret_cast<float4*>(out + cell * kCap * 3)[g.lane] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Votes on `cell`'s wall windows, then on its real i-slots; returns false,
// its zeros written, for a cell with no live wall window or no real i-slot.
// packed_i is read only in a cell with a live wall window.
template <int MASK_I>
__device__ __forceinline__ bool wall_cell(const Group<kCap>& g, float4* smem,
                                          const float* __restrict__ packed_i,
                                          const int* __restrict__ nbr_w,
                                          int64_t cell, int Cw,
                                          float* __restrict__ out,
                                          WallCell* wc) {
  float4* mine = smem + (threadIdx.x / kCap) * group_f4<kWindows>(kNarr, kCap);
  wc->rows = reinterpret_cast<int*>(mine);
  wc->buf = mine + rows_f4<kWindows>();
  wc->live = live_windows<kWindows>(g, nbr_w, cell, Cw, wc->rows);
  if (wc->live != 0u) {
    wc->s = lane_slot<PackedSlots>(g, cell, kCap, 0, packed_i + MASK_I);
    if (wc->s.real != 0u) {
      g.sync();
      wc->si = load_slot(packed_i + wc->s.gs * kCh);
      return true;
    }
  }
  zero_cell(g, out, cell);
  return false;
}

// Walks the cell's live wall windows and calls pair(a, b) for every real
// wall slot of this lane's half (a, b: the slot's two float4 parts).
template <class L, class Pair>
__device__ __forceinline__ void wall_pairs(const Group<kCap>& g,
                                           const WallCell& wc,
                                           const float* __restrict__ wall,
                                           Pair&& pair) {
  auto stage = [&](bool, int row, int m, float4* dst) {
    stage_packed(g, dst, wall, kCap, row, m);
  };
  auto sum = [&](bool, int count, const float4* src) {
    for_each_slot(g, wc.s.split, count,
                  [&](int k) { pair(src[2 * k], src[2 * k + 1]); });
  };
  walk_rows<L>(g, wc.live, 0u, wc.rows, nullptr, kCap, 0, kNarr,
               kSegSlotsPacked, wc.buf, stage, sum);
}

// The three sums of this lane's slot, halves folded; zeros where it is
// padding.
__device__ __forceinline__ void store_wall(const Group<kCap>& g,
                                           const WallCell& wc,
                                           float* __restrict__ out, float a,
                                           float b, float c) {
  if (wc.s.split) {
    a = fold_halves(g, a);
    b = fold_halves(g, b);
    c = fold_halves(g, c);
  }
  const bool keep = wc.s.own_real;
  out[wc.s.go * 3 + 0] = keep ? a : 0.0f;
  out[wc.s.go * 3 + 1] = keep ? b : 0.0f;
  out[wc.s.go * 3 + 2] = keep ? c : 0.0f;
}

// ---------------------------------------------------------------------------
// B5c: 1st-half wall sweep (wall terms only).  out (C, 16, 3) = [fx, fy, rd]:
//   p_w  = p_i + rho_i r max((a_i - a_w).(-e_ik), 0)
//   f_i  = -sum (p_i + p_w) dW V_k e_ik
//   rd_i =  sum (p_i - p_w) inv_rho0c0 dW V_k
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    ac1_wall_kernel(const float* __restrict__ packed_i,
                    const float* __restrict__ wall,
                    const int* __restrict__ nbr_w, int C, int Cw, float inv_h,
                    float dw_scale, float inv_rho0c0,
                    float* __restrict__ out) {
  extern __shared__ float4 group_smem[];
  const Group<kCap> g;
  const int64_t cell = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kCap;
  if (cell >= C) return;  // whole groups
  WallCell wc;
  if (!wall_cell<kMaskI1>(g, group_smem, packed_i, nbr_w, cell, Cw, out,
                          &wc)) {
    return;
  }
  const Slot8& si = wc.si;
  const float p_i = si.c[2], rho_i = si.c[3];
  float fx = 0.0f, fy = 0.0f, rd = 0.0f;
  // a = [x, y, vol, ax], b = [ay, mask, 0, 0]
  wall_pairs<Wall1Slots>(g, wc, wall, [&](const float4& a, const float4& b) {
    const Geom q = pair_geom(si.c[0], si.c[1], a.x, a.y, si.c[kMaskI1] * b.y,
                             inv_h, dw_scale);
    const float dwv = q.dw * a.z;
    const float face_acc =
        (si.c[4] - a.w) * (-q.ex) + (si.c[5] - b.x) * (-q.ey);
    const float p_w = p_i + rho_i * q.r * fmaxf(face_acc, 0.0f);
    const float psum = (p_i + p_w) * dwv;
    fx -= psum * q.ex;
    fy -= psum * q.ey;
    rd += (p_i - p_w) * inv_rho0c0 * dwv;
  });
  store_wall(g, wc, out, fx, fy, rd);
}

// ---------------------------------------------------------------------------
// B5d: 2nd-half wall sweep (wall terms only).  out (C, 16, 3) = [dcr, fx, fy]:
//   dv    = 2 (v_i - v_w)           (v_i minus the mirrored 2 v_w - v_i)
//   n'    = sign(e_ik.n_k) n_k
//   dcr_i = sum (dv.e_ik) dW V_k
//   u     = dv.n'
//   f_i   = sum rho0c0_geo u min(lim_scale max(u, 0), 1) dW V_k n'
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    ac2_wall_kernel(const float* __restrict__ packed_i,
                    const float* __restrict__ wall,
                    const int* __restrict__ nbr_w, int C, int Cw, float inv_h,
                    float dw_scale, float rho0c0_geo, float lim_scale,
                    float* __restrict__ out) {
  extern __shared__ float4 group_smem[];
  const Group<kCap> g;
  const int64_t cell = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kCap;
  if (cell >= C) return;  // whole groups
  WallCell wc;
  if (!wall_cell<kMaskI2>(g, group_smem, packed_i, nbr_w, cell, Cw, out,
                          &wc)) {
    return;
  }
  const Slot8& si = wc.si;
  float dcr = 0.0f, fx = 0.0f, fy = 0.0f;
  // a = [x, y, vol, vax], b = [vay, nx, ny, mask]
  wall_pairs<Wall2Slots>(g, wc, wall, [&](const float4& a, const float4& b) {
    const Geom q = pair_geom(si.c[0], si.c[1], a.x, a.y, si.c[kMaskI2] * b.w,
                             inv_h, dw_scale);
    const float dwv = q.dw * a.z;
    const float nx = b.y, ny = b.z;
    const float sgn = sign0(q.ex * nx + q.ey * ny);
    const float fnx = sgn * nx, fny = sgn * ny;
    const float dvx = 2.0f * (si.c[2] - a.w);
    const float dvy = 2.0f * (si.c[3] - b.x);
    dcr += (dvx * q.ex + dvy * q.ey) * dwv;
    const float u = dvx * fnx + dvy * fny;
    const float lim = fminf(lim_scale * fmaxf(u, 0.0f), 1.0f);
    const float pjump = rho0c0_geo * u * lim * dwv;
    fx += pjump * fnx;
    fy += pjump * fny;
  });
  store_wall(g, wc, out, dcr, fx, fy);
}

}  // namespace

extern "C" {

int ac1_inner_launch(const float* packed, const int* nbr, int C, float inv_h,
                     float dw_scale, float inv_rho0c0, float* out,
                     void* stream) {
  const unsigned nb = group_blocks<kCap>(C);
  if (nb == 0) return (int)cudaGetLastError();
  const size_t smem =
      group_smem_bytes<kWindows, kCap>(ac1_inner_kernel, kNarr, kCap);
  ac1_inner_kernel<<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, nbr, C, inv_h, dw_scale, inv_rho0c0, out);
  return (int)cudaGetLastError();
}

int ac2_inner_launch(const float* packed, const int* nbr, int C, float inv_h,
                     float dw_scale, float rho0c0_geo, float lim_scale,
                     float* out, void* stream) {
  const unsigned nb = group_blocks<kCap>(C);
  if (nb == 0) return (int)cudaGetLastError();
  const size_t smem =
      group_smem_bytes<kWindows, kCap>(ac2_inner_kernel, kNarr, kCap);
  ac2_inner_kernel<<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, nbr, C, inv_h, dw_scale, rho0c0_geo, lim_scale, out);
  return (int)cudaGetLastError();
}

int ac1_wall_launch(const float* packed_i, const float* wall, const int* nbr_w,
                    int C, int Cw, float inv_h, float dw_scale,
                    float inv_rho0c0, float* out, void* stream) {
  const unsigned nb = group_blocks<kCap>(C);
  if (nb == 0) return (int)cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorInvalidValue;
  const size_t smem =
      group_smem_bytes<kWindows, kCap>(ac1_wall_kernel, kNarr, kCap);
  ac1_wall_kernel<<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed_i, wall, nbr_w, C, Cw, inv_h, dw_scale, inv_rho0c0, out);
  return (int)cudaGetLastError();
}

int ac2_wall_launch(const float* packed_i, const float* wall, const int* nbr_w,
                    int C, int Cw, float inv_h, float dw_scale,
                    float rho0c0_geo, float lim_scale, float* out,
                    void* stream) {
  const unsigned nb = group_blocks<kCap>(C);
  if (nb == 0) return (int)cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorInvalidValue;
  const size_t smem =
      group_smem_bytes<kWindows, kCap>(ac2_wall_kernel, kNarr, kCap);
  ac2_wall_kernel<<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed_i, wall, nbr_w, C, Cw, inv_h, dw_scale, rho0c0_geo, lim_scale,
      out);
  return (int)cudaGetLastError();
}

}  // extern "C"
