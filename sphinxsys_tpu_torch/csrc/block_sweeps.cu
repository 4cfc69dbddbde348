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
// Design (first correct version): one thread per (cell, i-slot); the
// thread loops over the 3^DIM window rows and all j-slots of each row,
// accumulating in float32 registers; no atomics, so results are
// deterministic.  Threads of one cell read the same j rows (broadcast
// through L1).  What bounds it: the dense cap x cap x 3^DIM slot sweep is
// arithmetic on ~10-16x more slot pairs than real pairs, read from L1/L2;
// shared-memory staging of neighbour rows and a per-particle cell walk are
// later work.
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

namespace {

constexpr int kThreads = 128;

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

// ---------------------------------------------------------------------------
// B1: density summation.  out (C, cap, 2) = [sig, sigw]:
//   sig  = sum_w sum_j W_ij mask_j  (self pair included: W(0) is the seed)
//   sigw = sum_w sum_k W_ik V_k     (wall)
// ---------------------------------------------------------------------------
template <int DIM, bool WRAP>
__global__ void density_kernel(const float* __restrict__ pos,
                               const float* __restrict__ mask,
                               const int* __restrict__ nbr, int C, int cap,
                               const float* __restrict__ wpos,
                               const float* __restrict__ wvol,
                               const int* __restrict__ nbr_w, int Cw, int capw,
                               float inv_h, float factor_w, Box box,
                               float* __restrict__ out) {
  constexpr int NWIN = NW<DIM>::value;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (int64_t)C * cap) return;
  const int64_t cell = g / cap;
  float xi[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) xi[k] = pos[g * DIM + k];

  float sig = 0.0f;
  for (int w = 0; w < NWIN; ++w) {
    const int row = nbr[cell * NWIN + w];
    if (row >= C) continue;
    const float* pj = pos + (int64_t)row * cap * DIM;
    const float* mj = mask + (int64_t)row * cap;
    for (int j = 0; j < cap; ++j) {
      float r2 = 0.0f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        const float d = min_image<WRAP>(xi[k] - pj[j * DIM + k], k, box);
        r2 += d * d;
      }
      const float qc = fminf(sqrtf(r2) * inv_h, 2.0f);
      const float t = 1.0f - 0.5f * qc;
      sig += factor_w * (t * t * t * t) * (2.0f * qc + 1.0f) * mj[j];
    }
  }

  float sigw = 0.0f;
  if (nbr_w != nullptr) {
    for (int w = 0; w < NWIN; ++w) {
      const int row = nbr_w[cell * NWIN + w];
      if (row >= Cw) continue;
      const float* pj = wpos + (int64_t)row * capw * DIM;
      const float* vj = wvol + (int64_t)row * capw;
      for (int j = 0; j < capw; ++j) {
        float r2 = 0.0f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          const float d = min_image<WRAP>(xi[k] - pj[j * DIM + k], k, box);
          r2 += d * d;
        }
        const float qc = fminf(sqrtf(r2) * inv_h, 2.0f);
        const float t = 1.0f - 0.5f * qc;
        sigw += factor_w * (t * t * t * t) * (2.0f * qc + 1.0f) * vj[j];
      }
    }
  }
  out[g * 2 + 0] = sig;
  out[g * 2 + 1] = sigw;
}

// ---------------------------------------------------------------------------
// B2: first acoustic half (pressure relaxation).  out (C, cap, DIM+1):
//   f_i  = -sum (p_i + p_j) dW V_j e_ij
//   rd_i =  sum (p_i - p_j) dW V_j * inv_rho0c0
// wall term: p_w = p_i + rho_i r max((a_i - a_w).(-e), 0)  (a_w = 0 when
// MOVING is false)
// ---------------------------------------------------------------------------
template <int DIM, bool MOVING, bool WRAP>
__global__ void ac1_kernel(const float* __restrict__ pos,
                           const float* __restrict__ p,
                           const float* __restrict__ rho,
                           const float* __restrict__ acc,
                           const float* __restrict__ vol,
                           const int* __restrict__ nbr, int C, int cap,
                           const float* __restrict__ wpos,
                           const float* __restrict__ wvol,
                           const float* __restrict__ wacc,
                           const int* __restrict__ nbr_w, int Cw, int capw,
                           float inv_h, float dw_scale, float inv_rho0c0,
                           Box box, float* __restrict__ out) {
  constexpr int NWIN = NW<DIM>::value;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (int64_t)C * cap) return;
  const int64_t cell = g / cap;
  float xi[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) xi[k] = pos[g * DIM + k];
  const float p_i = p[g];

  float f[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) f[k] = 0.0f;
  float rd = 0.0f;
  for (int w = 0; w < NWIN; ++w) {
    const int row = nbr[cell * NWIN + w];
    if (row >= C) continue;
    const int64_t base = (int64_t)row * cap;
    for (int j = 0; j < cap; ++j) {
      float d[DIM];
      float r2 = 0.0f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        d[k] = min_image<WRAP>(xi[k] - pos[(base + j) * DIM + k], k, box);
        r2 += d[k] * d[k];
      }
      const Pair q = wendland_dwv(r2, vol[base + j], inv_h, dw_scale);
      const float p_j = p[base + j];
      const float psum = (p_i + p_j) * q.dwv * q.inv_r;
#pragma unroll
      for (int k = 0; k < DIM; ++k) f[k] -= psum * d[k];
      rd += (p_i - p_j) * q.dwv;
    }
  }
  rd *= inv_rho0c0;

  if (nbr_w != nullptr) {
    const float rho_i = rho[g];
    float a_i[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) a_i[k] = acc[g * DIM + k];
    float fw[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) fw[k] = 0.0f;
    float rdw = 0.0f;
    for (int w = 0; w < NWIN; ++w) {
      const int row = nbr_w[cell * NWIN + w];
      if (row >= Cw) continue;
      const int64_t base = (int64_t)row * capw;
      for (int j = 0; j < capw; ++j) {
        float d[DIM];
        float r2 = 0.0f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          d[k] = min_image<WRAP>(xi[k] - wpos[(base + j) * DIM + k], k, box);
          r2 += d[k] * d[k];
        }
        const Pair q = wendland_dwv(r2, wvol[base + j], inv_h, dw_scale);
        float face_acc = 0.0f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          const float e = d[k] * q.inv_r;
          const float da = MOVING ? a_i[k] - wacc[(base + j) * DIM + k] : a_i[k];
          face_acc += da * (-e);
        }
        const float p_w = p_i + rho_i * q.r * fmaxf(face_acc, 0.0f);
        const float psum = (p_i + p_w) * q.dwv * q.inv_r;
#pragma unroll
        for (int k = 0; k < DIM; ++k) fw[k] -= psum * d[k];
        rdw += (p_i - p_w) * q.dwv;
      }
    }
#pragma unroll
    for (int k = 0; k < DIM; ++k) f[k] += fw[k];
    rd += rdw * inv_rho0c0;
  }
#pragma unroll
  for (int k = 0; k < DIM; ++k) out[g * (DIM + 1) + k] = f[k];
  out[g * (DIM + 1) + DIM] = rd;
}

// ---------------------------------------------------------------------------
// B3: second acoustic half (density relaxation).  out (C, cap, DIM+1):
//   dcr_i = sum (v_i - v_j).e dW V_j
//   f_i   = sum rho0c0_geo u min(lim_scale max(u, 0), 1) dW V_j e_ij
// wall term: the jump is mirrored to 2 (v_i - v_w) along sign(e.n) n
// (v_w = 0 when MOVING is false)
// ---------------------------------------------------------------------------
template <int DIM, bool MOVING, bool WRAP>
__global__ void ac2_kernel(const float* __restrict__ pos,
                           const float* __restrict__ vel,
                           const float* __restrict__ vol,
                           const int* __restrict__ nbr, int C, int cap,
                           const float* __restrict__ wpos,
                           const float* __restrict__ wvol,
                           const float* __restrict__ wvel,
                           const float* __restrict__ wn,
                           const int* __restrict__ nbr_w, int Cw, int capw,
                           float inv_h, float dw_scale, float rho0c0_geo,
                           float lim_scale, Box box, float* __restrict__ out) {
  constexpr int NWIN = NW<DIM>::value;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (int64_t)C * cap) return;
  const int64_t cell = g / cap;
  float xi[DIM], v_i[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    xi[k] = pos[g * DIM + k];
    v_i[k] = vel[g * DIM + k];
  }

  float dcr = 0.0f;
  float f[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) f[k] = 0.0f;
  for (int w = 0; w < NWIN; ++w) {
    const int row = nbr[cell * NWIN + w];
    if (row >= C) continue;
    const int64_t base = (int64_t)row * cap;
    for (int j = 0; j < cap; ++j) {
      float d[DIM];
      float r2 = 0.0f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        d[k] = min_image<WRAP>(xi[k] - pos[(base + j) * DIM + k], k, box);
        r2 += d[k] * d[k];
      }
      const Pair q = wendland_dwv(r2, vol[base + j], inv_h, dw_scale);
      float e[DIM];
      float u = 0.0f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        e[k] = d[k] * q.inv_r;
        u += (v_i[k] - vel[(base + j) * DIM + k]) * e[k];
      }
      dcr += u * q.dwv;
      const float lim = fminf(lim_scale * fmaxf(u, 0.0f), 1.0f);
      const float pj = rho0c0_geo * u * lim * q.dwv;
#pragma unroll
      for (int k = 0; k < DIM; ++k) f[k] += pj * e[k];
    }
  }

  if (nbr_w != nullptr) {
    float dcrw = 0.0f;
    float fw[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) fw[k] = 0.0f;
    for (int w = 0; w < NWIN; ++w) {
      const int row = nbr_w[cell * NWIN + w];
      if (row >= Cw) continue;
      const int64_t base = (int64_t)row * capw;
      for (int j = 0; j < capw; ++j) {
        float d[DIM];
        float r2 = 0.0f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          d[k] = min_image<WRAP>(xi[k] - wpos[(base + j) * DIM + k], k, box);
          r2 += d[k] * d[k];
        }
        const Pair q = wendland_dwv(r2, wvol[base + j], inv_h, dw_scale);
        float e[DIM], n[DIM], dv[DIM];
        float e_dot_n = 0.0f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          e[k] = d[k] * q.inv_r;
          n[k] = wn[(base + j) * DIM + k];
          e_dot_n += e[k] * n[k];
          dv[k] = MOVING ? 2.0f * (v_i[k] - wvel[(base + j) * DIM + k])
                         : 2.0f * v_i[k];
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
      }
    }
    dcr += dcrw;
#pragma unroll
    for (int k = 0; k < DIM; ++k) f[k] += fw[k];
  }
  out[g * (DIM + 1)] = dcr;
#pragma unroll
  for (int k = 0; k < DIM; ++k) out[g * (DIM + 1) + 1 + k] = f[k];
}

// ---------------------------------------------------------------------------
// B4: viscous force + transport-velocity correction in one window pass
// (both read the same j data).  out (C, cap, 2 DIM) = [fv (DIM), I (DIM)]:
//   fv_i = sum (v_i - v_j) / (r + eps_r) dW V_j
//   I_i  = -sum 2 dW V_j e_ij
// wall term: the fv jump doubled, against the wall velocity (v_w = 0 when
// MOVING is false); the I term as for fluid neighbours.  The caller scales
// fv by 2 mu V_i and applies the limited TVC shift.  Like B1-B3 it is
// bound by pair arithmetic on L1/L2-resident neighbour rows: ~2x more
// flops per slot pair than B1 on the same slot pairs.
// ---------------------------------------------------------------------------
template <int DIM, bool MOVING, bool WRAP>
__global__ void visc_tvc_kernel(const float* __restrict__ pos,
                                const float* __restrict__ vel,
                                const float* __restrict__ vol,
                                const int* __restrict__ nbr, int C, int cap,
                                const float* __restrict__ wpos,
                                const float* __restrict__ wvol,
                                const float* __restrict__ wvel,
                                const int* __restrict__ nbr_w, int Cw,
                                int capw, float inv_h, float dw_scale,
                                float eps_r, Box box,
                                float* __restrict__ out) {
  constexpr int NWIN = NW<DIM>::value;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (int64_t)C * cap) return;
  const int64_t cell = g / cap;
  float xi[DIM], v_i[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    xi[k] = pos[g * DIM + k];
    v_i[k] = vel[g * DIM + k];
  }

  float fv[DIM], inc[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) fv[k] = inc[k] = 0.0f;
  for (int w = 0; w < NWIN; ++w) {
    const int row = nbr[cell * NWIN + w];
    if (row >= C) continue;
    const int64_t base = (int64_t)row * cap;
    for (int j = 0; j < cap; ++j) {
      float d[DIM];
      float r2 = 0.0f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        d[k] = min_image<WRAP>(xi[k] - pos[(base + j) * DIM + k], k, box);
        r2 += d[k] * d[k];
      }
      const Pair q = wendland_dwv(r2, vol[base + j], inv_h, dw_scale);
      const float scale = q.dwv / (q.r + eps_r);
      const float ie = 2.0f * q.dwv * q.inv_r;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        fv[k] += (v_i[k] - vel[(base + j) * DIM + k]) * scale;
        inc[k] -= ie * d[k];
      }
    }
  }

  if (nbr_w != nullptr) {
    float fvw[DIM], incw[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) fvw[k] = incw[k] = 0.0f;
    for (int w = 0; w < NWIN; ++w) {
      const int row = nbr_w[cell * NWIN + w];
      if (row >= Cw) continue;
      const int64_t base = (int64_t)row * capw;
      for (int j = 0; j < capw; ++j) {
        float d[DIM];
        float r2 = 0.0f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          d[k] = min_image<WRAP>(xi[k] - wpos[(base + j) * DIM + k], k, box);
          r2 += d[k] * d[k];
        }
        const Pair q = wendland_dwv(r2, wvol[base + j], inv_h, dw_scale);
        const float scale = 2.0f * q.dwv / (q.r + eps_r);
        const float ie = 2.0f * q.dwv * q.inv_r;
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          const float dv = MOVING ? v_i[k] - wvel[(base + j) * DIM + k] : v_i[k];
          fvw[k] += dv * scale;
          incw[k] -= ie * d[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      fv[k] += fvw[k];
      inc[k] += incw[k];
    }
  }
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    out[g * (2 * DIM) + k] = fv[k];
    out[g * (2 * DIM) + DIM + k] = inc[k];
  }
}

inline unsigned blocks_for(int C, int cap) {
  return (unsigned)(((int64_t)C * cap + kThreads - 1) / kThreads);
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

}  // namespace

extern "C" {

int density_sweep_launch(int dim, const float* pos, const float* mask,
                         const int* nbr, int C, int cap, const float* wpos,
                         const float* wvol, const int* nbr_w, int Cw, int capw,
                         float inv_h, float factor_w, double bx, double by,
                         double bz, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = blocks_for(C, cap);
  if (nb == 0) return (int)cudaGetLastError();
  const Box box = make_box(bx, by, bz);
  return dispatch(dim, false, box_wraps(box), [&](auto f) {
    using F = decltype(f);
    density_kernel<F::dim, F::wrap><<<nb, kThreads, 0, s>>>(
        pos, mask, nbr, C, cap, wpos, wvol, nbr_w, Cw, capw, inv_h, factor_w,
        box, out);
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
  const unsigned nb = blocks_for(C, cap);
  if (nb == 0) return (int)cudaGetLastError();
  const Box box = make_box(bx, by, bz);
  return dispatch(dim, moving != 0, box_wraps(box), [&](auto f) {
    using F = decltype(f);
    ac1_kernel<F::dim, F::moving, F::wrap><<<nb, kThreads, 0, s>>>(
        pos, p, rho, acc, vol, nbr, C, cap, wpos, wvol, wacc, nbr_w, Cw, capw,
        inv_h, dw_scale, inv_rho0c0, box, out);
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
  const unsigned nb = blocks_for(C, cap);
  if (nb == 0) return (int)cudaGetLastError();
  const Box box = make_box(bx, by, bz);
  return dispatch(dim, moving != 0, box_wraps(box), [&](auto f) {
    using F = decltype(f);
    ac2_kernel<F::dim, F::moving, F::wrap><<<nb, kThreads, 0, s>>>(
        pos, vel, vol, nbr, C, cap, wpos, wvol, wvel, wn, nbr_w, Cw, capw,
        inv_h, dw_scale, rho0c0_geo, lim_scale, box, out);
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
  const unsigned nb = blocks_for(C, cap);
  if (nb == 0) return (int)cudaGetLastError();
  const Box box = make_box(bx, by, bz);
  return dispatch(dim, moving != 0, box_wraps(box), [&](auto f) {
    using F = decltype(f);
    visc_tvc_kernel<F::dim, F::moving, F::wrap><<<nb, kThreads, 0, s>>>(
        pos, vel, vol, nbr, C, cap, wpos, wvol, wvel, nbr_w, Cw, capw, inv_h,
        dw_scale, eps_r, box, out);
  });
}

}  // extern "C"
