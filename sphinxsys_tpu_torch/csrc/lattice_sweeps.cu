// Lattice-stencil sweeps of the total-Lagrangian solid for Hopper (sm_90a).
//
// Hand kernels with no Pallas counterpart: in the JAX package these tap
// sums are plain jnp loops that XLA fuses into one pass over a padded halo
// buffer (sphinxsys_tpu/physics/solid_lattice.py):
//   lattice_force_kernel <- decomposed_integration_1st_half_lattice
//                           (the tap loop, solid_lattice.py:285-300)  L1
//   lattice_dfdt_kernel  <- integration_2nd_half_lattice
//                           (the tap loop, solid_lattice.py:335-347)  L2
// Eager PyTorch runs that loop as ~30 elementwise launches a tap, each one
// moving a whole plane; these kernels are the fusion XLA did.  The plain
// PyTorch versions in sphinxsys_tpu_torch/ops/lattice_sweeps.py compute the
// same sums.
//
// Layout: per-site fields flat (N, ...) float32 in C order of the lattice
// (nx, ny, nz), N = nx ny nz; `valid` one byte a site (torch.bool).  A tap
// is a static offset o of the frozen initial lattice with constant pair
// data; j = i + o.  A j outside the box or not valid adds nothing (JAX's
// zero halo and w_j = 0), so it is skipped.  An invalid site may hold NaN
// (the 0/0 determinant weighting of a neighbour-less correction matrix), so
// site values are SELECTED by validity, never multiplied by it: an invalid
// i computes its sums from zeros, as JAX's sanitized planes give.
//
//   L1: f_a,i = sum_o dwv_o [ sh_o (J_i + J_j)(x_a,i - x_a,j)
//                             + sum_b e_b,o (S_ab,i + S_ab,j) ]
//       (sh_o = cfG / r0_o, dwv_o = dW0_o V0, e_o = -e0_o)
//   L2: dFdt_ab,i = -sum_o g_b,o (v_a,i - v_a,j)      (g_b,o = dwv_o e_b,o)
//
// The tap table (offsets and constants, formed in double on the host and
// rounded once to float, as JAX's trace-time Python floats are) travels
// as a by-value kernel parameter, which the card keeps in its constant
// bank: every thread of a warp reads the same tap at once, so each read
// is a broadcast.  A tap component e_b that is exactly zero is skipped by a
// branch that is uniform across the grid (JAX folds it away at trace time).
//
// Design: one thread a site, the sites of a warp consecutive in z, taps in
// table order (JAX's order), sums in registers.  What bounds them on an
// H100 at the bench's 1.12M sites: operations (L1 ~35 flops, L2 ~13 a real
// pair) over bytes (each field read once), both a few hundredths of a ms;
// these kernels instead re-read each neighbour's fields from L1/L2 once per
// tap.  Tiling the lattice through shared memory is later work.  Sums keep
// the f32 order of the plain version up to FMA contraction; never build
// with --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 96;   // 80 at h = 1.3 dx (cutoff 2.6 dx) in 3D
constexpr int kThreads = 256;

struct ForceTaps {
  int n;
  int4 off[kMaxTaps];        // (ox, oy, oz, flat offset)
  float sh[kMaxTaps];        // cfG / r0
  float dwv[kMaxTaps];       // dW0 V0
  float e[kMaxTaps][3];      // -e0
};

struct DfdtTaps {
  int n;
  int4 off[kMaxTaps];
  float g[kMaxTaps][3];      // dW0 V0 (-e0)
};

static_assert(sizeof(ForceTaps) <= 4096, "kernel parameters over 4 KB");
static_assert(sizeof(DfdtTaps) <= 4096, "kernel parameters over 4 KB");

__device__ __forceinline__ bool in_box(int ix, int iy, int iz, int4 o, int nx,
                                       int ny, int nz) {
  const int jx = ix + o.x, jy = iy + o.y, jz = iz + o.z;
  return jx >= 0 && jx < nx && jy >= 0 && jy < ny && jz >= 0 && jz < nz;
}

__global__ void __launch_bounds__(kThreads)
lattice_force_kernel(const float* __restrict__ pos, const float* __restrict__ S,
                     const float* __restrict__ jm2d,
                     const unsigned char* __restrict__ valid, int nx, int ny,
                     int nz, const ForceTaps taps, float* __restrict__ out) {
  const int n = nx * ny * nz;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int iz = i % nz;
  const int iy = (i / nz) % ny;
  const int ix = i / (nz * ny);
  const bool vi = valid[i] != 0;
  float xi[3], si[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) xi[a] = vi ? pos[3 * i + a] : 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) si[k] = vi ? S[9 * i + k] : 0.0f;
  const float ji = vi ? jm2d[i] : 0.0f;

  float f[3] = {0.0f, 0.0f, 0.0f};
  for (int t = 0; t < taps.n; ++t) {
    const int4 o = taps.off[t];
    if (!in_box(ix, iy, iz, o, nx, ny, nz)) continue;
    const int j = i + o.w;
    if (valid[j] == 0) continue;
    const float sh = taps.sh[t] * (ji + jm2d[j]);
    const float dwv = taps.dwv[t];
    const float e0 = taps.e[t][0], e1 = taps.e[t][1], e2 = taps.e[t][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float acc = sh * (xi[a] - pos[3 * j + a]);
      if (e0 != 0.0f) acc = acc + e0 * (si[3 * a + 0] + S[9 * j + 3 * a + 0]);
      if (e1 != 0.0f) acc = acc + e1 * (si[3 * a + 1] + S[9 * j + 3 * a + 1]);
      if (e2 != 0.0f) acc = acc + e2 * (si[3 * a + 2] + S[9 * j + 3 * a + 2]);
      f[a] = f[a] + dwv * acc;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) out[3 * i + a] = f[a];
}

__global__ void __launch_bounds__(kThreads)
lattice_dfdt_kernel(const float* __restrict__ vel,
                    const unsigned char* __restrict__ valid, int nx, int ny,
                    int nz, const DfdtTaps taps, float* __restrict__ out) {
  const int n = nx * ny * nz;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int iz = i % nz;
  const int iy = (i / nz) % ny;
  const int ix = i / (nz * ny);
  const bool vi = valid[i] != 0;
  float v[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) v[a] = vi ? vel[3 * i + a] : 0.0f;

  float d[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) d[k] = 0.0f;
  for (int t = 0; t < taps.n; ++t) {
    const int4 o = taps.off[t];
    if (!in_box(ix, iy, iz, o, nx, ny, nz)) continue;
    const int j = i + o.w;
    if (valid[j] == 0) continue;
    float dv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) dv[a] = v[a] - vel[3 * j + a];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float g = taps.g[t][b];
      if (g == 0.0f) continue;
#pragma unroll
      for (int a = 0; a < 3; ++a) d[3 * a + b] = d[3 * a + b] - g * dv[a];
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) out[9 * i + k] = d[k];
}

void fill_offsets(int4* dst, const int* off, int n_taps, int ny, int nz) {
  for (int t = 0; t < n_taps; ++t) {
    const int ox = off[3 * t], oy = off[3 * t + 1], oz = off[3 * t + 2];
    dst[t] = make_int4(ox, oy, oz, (ox * ny + oy) * nz + oz);
  }
}

unsigned grid_for(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// off (n_taps, 3) int32 and coef (n_taps, 5) float32 [sh, dwv, e0, e1, e2]
// are host arrays, copied into the kernel's parameters.
int lattice_force_launch(const float* pos, const float* S, const float* jm2d,
                         const unsigned char* valid, int nx, int ny, int nz,
                         const int* off, const float* coef, int n_taps,
                         float* out, void* stream) {
  if (n_taps < 0 || n_taps > kMaxTaps) return (int)cudaErrorInvalidValue;
  ForceTaps taps;
  taps.n = n_taps;
  fill_offsets(taps.off, off, n_taps, ny, nz);
  for (int t = 0; t < n_taps; ++t) {
    taps.sh[t] = coef[5 * t];
    taps.dwv[t] = coef[5 * t + 1];
    for (int b = 0; b < 3; ++b) taps.e[t][b] = coef[5 * t + 2 + b];
  }
  const int n = nx * ny * nz;
  if (n == 0) return (int)cudaGetLastError();
  lattice_force_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pos, S, jm2d, valid, nx, ny, nz, taps, out);
  return (int)cudaGetLastError();
}

// coef (n_taps, 3) float32 [g0, g1, g2].
int lattice_dfdt_launch(const float* vel, const unsigned char* valid, int nx,
                        int ny, int nz, const int* off, const float* coef,
                        int n_taps, float* out, void* stream) {
  if (n_taps < 0 || n_taps > kMaxTaps) return (int)cudaErrorInvalidValue;
  DfdtTaps taps;
  taps.n = n_taps;
  fill_offsets(taps.off, off, n_taps, ny, nz);
  for (int t = 0; t < n_taps; ++t)
    for (int b = 0; b < 3; ++b) taps.g[t][b] = coef[3 * t + b];
  const int n = nx * ny * nz;
  if (n == 0) return (int)cudaGetLastError();
  lattice_dfdt_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      vel, valid, nx, ny, nz, taps, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
