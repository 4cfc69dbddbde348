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
// zero halo and w_j = 0).  An invalid site may hold NaN (the 0/0
// determinant weighting of a neighbour-less correction matrix), so site
// values are SELECTED by validity when they are staged, never multiplied by
// it: an invalid i computes its sums from zeros, as JAX's sanitized planes
// give.
//
//   L1: f_a,i = sum_o dwv_o w_j [ sh_o (J_i + J_j)(x_a,i - x_a,j)
//                                 + sum_b e_b,o (S_ab,i + S_ab,j) ]
//       (sh_o = cfG / r0_o, dwv_o = dW0_o V0, e_o = -e0_o)
//   L2: dFdt_ab,i = -sum_o g_b,o w_j (v_a,i - v_a,j)  (g_b,o = dwv_o e_b,o)
//
// Design.  A block owns a brick of TY x 32 sites of a (y, z) plane (a warp
// a z-row; L1 6 x 32, L2 4 x 32) and marches along x through a chunk of at
// most 12 (L1) or 16 (L2) planes; the launcher splits x into as many
// equal chunks as fill whole waves of the card's resident blocks.  Each
// plane of the brick plus its halo (TY + 4 rows of 36 sites) is staged
// once in shared memory, in a ring of 2m + 1 = 5 planes, with every value
// selected as it is stored: an invalid or out-of-box site stages zeros and
// w = 0.  Staging is pipelined through registers: a thread loads its share
// of the next plane (in-box sites only, row-contiguous copies) before it
// computes the current one, and stores it after the next barrier.  Every
// tap then reads shared memory at a compile-time offset from one of five
// plane pointers: the taps are the 80 offsets 0 < |o|^2 <= 6 of the 5^3
// box (h = 1.3 dx, cutoff 2.6 dx), unrolled in table order, and the
// components e_b that vanish (o_b = 0) are dropped at compile time.  The
// in-box and valid_j branches become JAX's own multiply by the staged w
// (`dWV * wj * acc`, `dv * wj`), exact because a staged value is finite.
// L1 stages (x, J) as a float4 a site and S as 9 floats a site (an odd
// stride, so a warp's 32 sites hit 32 banks), and w in a ring of its own
// one plane ahead of the fields it selects; L2 stages float4 (v, w).  Each
// warp writes its outputs through shared memory, row-contiguous.  Each
// site's sum runs over the taps in table order with the parent's per-pair
// arithmetic, so the sums round as the one-thread-a-site kernels' did (up
// to FMA contraction); never build with --use_fast_math.
//
// What bounds them on an H100 at the bench's 1.13M sites: operations (L1
// ~35 flops, L2 ~13 a real pair) over bytes (each field read once), both a
// few hundredths of a ms.  The staged L1 issues ~3,960 instructions a
// plane a thread (its SASS), ~770 of them shared-memory loads (8.75 a tap:
// the float4 (x, J), w and the S components of the nonzero e_b, 11.75
// wavefronts), and runs 12 warps an SM: two blocks of 104 KB of shared
// memory and 168 registers a thread fill the SM's shared memory and
// register file alike.
// Both kernels also stage the halo (L1 rows 1.7x, L2 2x, plus 4 planes a
// chunk) and run the threads past a ragged edge (57 = 32 + 25 along z).
//
// The tap constants are formed in double on the host and rounded once to
// float (as JAX's trace-time Python floats are) and travel as a by-value
// kernel parameter in the constant bank, read at compile-time offsets.
// The kernels take exactly the 80-tap table of h = 1.3 dx; the launchers
// return cudaErrorInvalidValue for any other (the wrappers raise first),
// and for a lattice of 2^31 / 9 sites or more (32-bit indices).

#include <cuda_runtime.h>

namespace {

constexpr int kM = 2;                 // halo: |o_c| <= 2
constexpr int kR2 = 6;                // taps: 0 < |o|^2 <= 6
constexpr int kTaps = 80;
constexpr int kRing = 2 * kM + 1;     // planes a tap can reach
constexpr int kTZ = 32;               // sites of a brick along z: a warp
constexpr int kPZ = kTZ + 2 * kM;     // staged sites of a row

__host__ __device__ constexpr bool is_tap(int ox, int oy, int oz) {
  return ox * ox + oy * oy + oz * oz > 0 && ox * ox + oy * oy + oz * oz <= kR2;
}

struct ForceCoef {
  float sh[kTaps];        // cfG / r0
  float dwv[kTaps];       // dW0 V0
  float e[kTaps][3];      // -e0
};

struct DfdtCoef {
  float g[kTaps][3];      // dW0 V0 (-e0)
};

// L1: bricks of 6 x 32 sites, two blocks an SM (shared memory and
// registers allow no third)
constexpr int kTY1 = 6;
constexpr int kXC1 = 12;              // planes a block marches over, at most
constexpr int kPY1 = kTY1 + 2 * kM;
constexpr int kSites1 = kPY1 * kPZ;   // staged sites of a plane
// a plane slot: (x, J) as a float4 a site, then S (9 a site) row-contiguous
// as in global memory
constexpr int kXJ1 = 0, kS1 = 4 * kSites1;
constexpr int kSlot1 = 13 * kSites1;
static_assert(kSlot1 % 4 == 0, "float4 slots");
constexpr int kThreads1 = kTY1 * kTZ;
constexpr int kSmem1 =
    (kRing * kSlot1 + (kRing + 1) * kSites1 + kThreads1 * 3) * 4;

// L2: bricks of 4 x 32 sites
constexpr int kTY2 = 4;
constexpr int kXC2 = 16;              // at most
constexpr int kPY2 = kTY2 + 2 * kM;
constexpr int kSites2 = kPY2 * kPZ;
constexpr int kThreads2 = kTY2 * kTZ;
constexpr int kSmem2 = kRing * kSites2 * 16 + kThreads2 * 9 * 4;

// The first plane of chunk k of nx planes split into `chunks` (in 64 bits:
// k nx overflows an int on a long lattice).
__device__ __forceinline__ int chunk_start(int k, int nx, int chunks) {
  return (int)((long long)k * nx / chunks);
}

__device__ __forceinline__ bool in_box(int x, int y, int z, int nx, int ny,
                                       int nz) {
  return (unsigned)x < (unsigned)nx && (unsigned)y < (unsigned)ny &&
         (unsigned)z < (unsigned)nz;
}

// A warp's outputs, K floats a site staged at buf[lane * K + k], written to
// the row-contiguous sites first.. first + count - 1 (count <= 32).
template <int K>
__device__ __forceinline__ void write_row(const float* buf, float* out,
                                          int first, int count, int lane) {
  __syncwarp();
  float* dst = out + (size_t)K * first;
  for (int k = lane; k < K * count; k += 32) dst[k] = buf[k];
}

// Staging is pipelined through registers: a thread loads its share of the
// next plane's raw values (in-box sites only) before it computes the
// current plane, and stores them, selected by validity, after the next
// barrier, so the loads' latency hides behind a plane of taps.

template <int N, int T>
__host__ __device__ constexpr int iters() { return (N + T - 1) / T; }

// L1: thread tid's elements of one plane of a field of K floats a site.
// The staged rows are read as they lie in global memory: element e is
// float j = e % (36 K) of staged row yy = e / (36 K).  Only elements of
// in-box sites are read (32-bit indices: the launcher checks 9 N < 2^31).
template <int K>
__device__ __forceinline__ void load_field(const float* __restrict__ src,
                                           float (&v)[iters<kSites1 * K, kThreads1>()],
                                           int p, int y0, int z0, int nx,
                                           int ny, int nz, int tid) {
  const bool plane = (unsigned)p < (unsigned)nx;
  const int row0 = K * ((p * ny + y0 - kM) * nz + z0 - kM);
  const int ylo = max(0, kM - y0), yhi = min(kPY1, ny - y0 + kM);
  const int jlo = K * max(0, kM - z0), jhi = K * min(kPZ, nz - z0 + kM);
#pragma unroll
  for (int it = 0; it < iters<kSites1 * K, kThreads1>(); ++it) {
    const int e = tid + it * kThreads1;
    const int yy = e / (kPZ * K), j = e - yy * (kPZ * K);
    const bool in = plane && e < kSites1 * K && yy >= ylo && yy < yhi &&
                    j >= jlo && j < jhi;
    v[it] = in ? src[row0 + yy * K * nz + j] : 0.0f;
  }
}

// ... and stored at D s + F + c of the plane `r` (s the site, c the float
// of the site), selected by its site's w
template <int K, int D, int F>
__device__ __forceinline__ void store_field(
    const float (&v)[iters<kSites1 * K, kThreads1>()], const float* w,
    float* r, int tid) {
#pragma unroll
  for (int it = 0; it < iters<kSites1 * K, kThreads1>(); ++it) {
    const int e = tid + it * kThreads1;
    if (e >= kSites1 * K) break;
    const int yy = e / (kPZ * K), j = e - yy * (kPZ * K), zz = j / K;
    const int s = yy * kPZ + zz;
    r[D * s + F + j - zz * K] = w[s] != 0.0f ? v[it] : 0.0f;
  }
}

// one plane of L1's inputs in flight: the fields of plane p and the valid
// bytes of plane p + 1 (its w is staged a plane ahead of its fields)
struct ForcePlane {
  float pos[iters<kSites1 * 3, kThreads1>()];
  float S[iters<kSites1 * 9, kThreads1>()];
  float J[iters<kSites1, kThreads1>()];
  unsigned char ok[iters<kSites1, kThreads1>()];
};

__device__ __forceinline__ void load_valid(const unsigned char* __restrict__ valid,
                                           unsigned char (&ok)[iters<kSites1, kThreads1>()],
                                           int p, int y0, int z0, int nx,
                                           int ny, int nz, int tid) {
#pragma unroll
  for (int it = 0; it < iters<kSites1, kThreads1>(); ++it) {
    const int s = tid + it * kThreads1;
    const int y = y0 - kM + s / kPZ, z = z0 - kM + s % kPZ;
    ok[it] = s < kSites1 && in_box(p, y, z, nx, ny, nz)
                 ? valid[(p * ny + y) * nz + z] : 0;
  }
}

__device__ __forceinline__ void store_w(
    const unsigned char (&ok)[iters<kSites1, kThreads1>()], float* w, int tid) {
#pragma unroll
  for (int it = 0; it < iters<kSites1, kThreads1>(); ++it) {
    const int s = tid + it * kThreads1;
    if (s < kSites1) w[s] = ok[it] ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads1, 2)
lattice_force_kernel(const float* __restrict__ pos, const float* __restrict__ S,
                     const float* __restrict__ jm2d,
                     const unsigned char* __restrict__ valid, int nx, int ny,
                     int nz, int chunks, const ForceCoef c,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  float* rec = smem;                                // 5 planes of x, S, J
  float* wr = rec + kRing * kSlot1;                 // 6 planes of w
  float* ob = wr + (kRing + 1) * kSites1;           // outputs, 3 a thread
  const int tid = threadIdx.x, ty = tid / kTZ, tz = tid % kTZ;
  const int z0 = blockIdx.z * kTZ, y0 = blockIdx.y * kTY1;
  const int x0 = chunk_start(blockIdx.x, nx, chunks),
            x1 = chunk_start(blockIdx.x + 1, nx, chunks);

  ForcePlane in;
  auto load_fields = [&](int p) {
    load_field<3>(pos, in.pos, p, y0, z0, nx, ny, nz, tid);
    load_field<9>(S, in.S, p, y0, z0, nx, ny, nz, tid);
    load_field<1>(jm2d, in.J, p, y0, z0, nx, ny, nz, tid);
  };
  auto store_fields = [&](int slot, int wslot) {
    float* r = rec + slot * kSlot1;
    const float* w = wr + wslot * kSites1;
    store_field<3, 4, 0>(in.pos, w, r + kXJ1, tid);
    store_field<9, 9, 0>(in.S, w, r + kS1, tid);
    store_field<1, 4, 3>(in.J, w, r + kXJ1, tid);
  };

  // plane x0 - kM + k sits in record slot k % 5 and w slot k % 6
  for (int k = 0; k < kRing; ++k) {
    load_valid(valid, in.ok, x0 - kM + k, y0, z0, nx, ny, nz, tid);
    store_w(in.ok, wr + k * kSites1, tid);
  }
  __syncthreads();
  for (int k = 0; k < kRing - 1; ++k) {
    load_fields(x0 - kM + k);
    store_fields(k, k);
  }
  load_fields(x0 + kM);
  load_valid(valid, in.ok, x0 + kM + 1, y0, z0, nx, ny, nz, tid);

  const int own = (ty + kM) * kPZ + tz + kM;
  const int y = y0 + ty;
  for (int x = x0; x < x1; ++x) {
    const int r = x - x0;
    __syncthreads();                 // plane x - 3's slots are free
    store_w(in.ok, wr + ((r + 2 * kM + 1) % (kRing + 1)) * kSites1, tid);
    store_fields((r + 2 * kM) % kRing, (r + 2 * kM) % (kRing + 1));
    __syncthreads();
    if (x + 1 < x1) {                // plane x + 3 in flight
      load_fields(x + kM + 1);
      load_valid(valid, in.ok, x + kM + 2, y0, z0, nx, ny, nz, tid);
    }

    const float* me = rec + ((r + kM) % kRing) * kSlot1;
    const float4 mxj = reinterpret_cast<const float4*>(me + kXJ1)[own];
    const float xi[3] = {mxj.x, mxj.y, mxj.z}, ji = mxj.w;
    float si[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) si[k] = me[kS1 + 9 * own + k];

    float f[3] = {0.0f, 0.0f, 0.0f};
    int t = 0;
#pragma unroll
    for (int ox = -kM; ox <= kM; ++ox) {
      const int k = r + kM + ox;
      const float* pl = rec + (k % kRing) * kSlot1;
      const float4* pxj = reinterpret_cast<const float4*>(pl + kXJ1) + own;
      const float* ps = pl + kS1 + 9 * own;
      const float* pw = wr + (k % (kRing + 1)) * kSites1 + own;
#pragma unroll
      for (int oy = -kM; oy <= kM; ++oy) {
#pragma unroll
        for (int oz = -kM; oz <= kM; ++oz) {
          if (!is_tap(ox, oy, oz)) continue;
          const int d = oy * kPZ + oz;
          const float4 xj = pxj[d];
          const float xjv[3] = {xj.x, xj.y, xj.z};
          const float* sj = ps + 9 * d;
          const float dwvw = c.dwv[t] * pw[d];
          const float sh = c.sh[t] * (ji + xj.w);
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            float acc = sh * (xi[a] - xjv[a]);
            if (ox != 0) acc = acc + c.e[t][0] * (si[3 * a + 0] + sj[3 * a + 0]);
            if (oy != 0) acc = acc + c.e[t][1] * (si[3 * a + 1] + sj[3 * a + 1]);
            if (oz != 0) acc = acc + c.e[t][2] * (si[3 * a + 2] + sj[3 * a + 2]);
            f[a] = f[a] + dwvw * acc;
          }
          ++t;
        }
      }
    }

    float* mine = ob + tid * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) mine[a] = f[a];
    if (y < ny && z0 < nz)
      write_row<3>(ob + ty * kTZ * 3, out, (x * ny + y) * nz + z0,
                   min(kTZ, nz - z0), tz);
  }
}

// L2: thread tid's sites of one plane in flight, raw (in-box sites only)
struct DfdtPlane {
  float v[iters<kSites2, kThreads2>()][3];
  unsigned char ok[iters<kSites2, kThreads2>()];
};

__global__ void __launch_bounds__(kThreads2, 4)
lattice_dfdt_kernel(const float* __restrict__ vel,
                    const unsigned char* __restrict__ valid, int nx, int ny,
                    int nz, int chunks, const DfdtCoef c,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  float4* rec = reinterpret_cast<float4*>(smem);    // 5 planes of (v, w)
  float* ob = smem + kRing * kSites2 * 4;           // outputs, 9 a thread
  const int tid = threadIdx.x, ty = tid / kTZ, tz = tid % kTZ;
  const int z0 = blockIdx.z * kTZ, y0 = blockIdx.y * kTY2;
  const int x0 = chunk_start(blockIdx.x, nx, chunks),
            x1 = chunk_start(blockIdx.x + 1, nx, chunks);

  DfdtPlane in;
  auto load = [&](int p) {
#pragma unroll
    for (int it = 0; it < iters<kSites2, kThreads2>(); ++it) {
      const int s = tid + it * kThreads2;
      const int y = y0 - kM + s / kPZ, z = z0 - kM + s % kPZ;
      const bool box = s < kSites2 && in_box(p, y, z, nx, ny, nz);
      const int i = box ? (p * ny + y) * nz + z : 0;
      in.ok[it] = box ? valid[i] : 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) in.v[it][a] = box ? vel[3 * i + a] : 0.0f;
    }
  };
  auto store = [&](int slot) {     // selected by validity
    float4* r = rec + slot * kSites2;
#pragma unroll
    for (int it = 0; it < iters<kSites2, kThreads2>(); ++it) {
      const int s = tid + it * kThreads2;
      if (s >= kSites2) break;
      r[s] = in.ok[it] ? make_float4(in.v[it][0], in.v[it][1], in.v[it][2], 1.0f)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };

  // plane x0 - kM + k sits in slot k % 5
  for (int k = 0; k < kRing - 1; ++k) {
    load(x0 - kM + k);
    store(k);
  }
  load(x0 + kM);

  const int own = (ty + kM) * kPZ + tz + kM;
  const int y = y0 + ty;
  for (int x = x0; x < x1; ++x) {
    const int r = x - x0;
    __syncthreads();                 // plane x - 3's slot is free
    store((r + 2 * kM) % kRing);
    __syncthreads();
    if (x + 1 < x1) load(x + kM + 1);

    const float4 me = rec[((r + kM) % kRing) * kSites2 + own];
    const float v[3] = {me.x, me.y, me.z};
    float d[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) d[k] = 0.0f;
    int t = 0;
#pragma unroll
    for (int ox = -kM; ox <= kM; ++ox) {
      const float4* pl = rec + ((r + kM + ox) % kRing) * kSites2 + own;
#pragma unroll
      for (int oy = -kM; oy <= kM; ++oy) {
#pragma unroll
        for (int oz = -kM; oz <= kM; ++oz) {
          if (!is_tap(ox, oy, oz)) continue;
          const float4 q = pl[oy * kPZ + oz];
          const float dv[3] = {(v[0] - q.x) * q.w, (v[1] - q.y) * q.w,
                               (v[2] - q.z) * q.w};
          const int o[3] = {ox, oy, oz};
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            if (o[b] == 0) continue;
            const float g = c.g[t][b];
#pragma unroll
            for (int a = 0; a < 3; ++a) d[3 * a + b] = d[3 * a + b] - g * dv[a];
          }
          ++t;
        }
      }
    }

    float* mine = ob + tid * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) mine[k] = d[k];
    if (y < ny && z0 < nz)
      write_row<9>(ob + ty * kTZ * 9, out, (x * ny + y) * nz + z0,
                   min(kTZ, nz - z0), tz);
  }
}

// True if off (n_taps, 3) is the kernels' table: the offsets 0 < |o|^2 <= 6
// in lexicographic order (lattice_offsets at h = 1.3 dx).
bool taps_match(const int* off, int n_taps) {
  if (n_taps != kTaps) return false;
  int t = 0;
  for (int ox = -kM; ox <= kM; ++ox)
    for (int oy = -kM; oy <= kM; ++oy)
      for (int oz = -kM; oz <= kM; ++oz) {
        if (!is_tap(ox, oy, oz)) continue;
        if (off[3 * t] != ox || off[3 * t + 1] != oy || off[3 * t + 2] != oz)
          return false;
        ++t;
      }
  return true;
}

constexpr int kMaxDevices = 64;

// What the grid of a kernel depends on, worked out once per device: the
// kernel's resident blocks an SM (after the opt-in to its shared memory)
// and the card's SMs.
struct Fill {
  int per_sm = 0, sms = 0;
};

template <typename Kernel>
int fill_for(Kernel kernel, int threads, int smem, Fill* fill) {
  static Fill cached[kMaxDevices];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Fill& f = cached[dev];
  if (f.sms == 0) {
    Fill got;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == 0)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &got.per_sm, kernel, threads, smem);
    if (err == 0)
      err = (int)cudaDeviceGetAttribute(
          &got.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != 0) return err;
    if (got.per_sm < 1 || got.sms < 1)
      return (int)cudaErrorInvalidConfiguration;
    f = got;
  }
  *fill = f;
  return 0;
}

// The number of x chunks: at most xc planes each, as many as fill whole
// waves of the card's resident blocks (tiles a plane), so that no last
// wave runs part empty; chunks differ by a plane at most.
int chunks_for(int nx, int tiles, const Fill& fill, int xc) {
  const long long resident = (long long)fill.per_sm * fill.sms;
  const long long blocks = (long long)tiles * ((nx + xc - 1) / xc);
  const long long waves = (blocks + resident - 1) / resident;
  return (int)max(1LL, min((long long)nx, waves * resident / tiles));
}

// The grid of a kernel of `threads` a block and `smem` bytes whose bricks
// are ty x 32 sites, marching over chunks of at most xc planes.
template <typename Kernel>
int grid_for(Kernel kernel, int threads, int smem, int ty, int xc, int nx,
             int ny, int nz, dim3* grid) {
  Fill fill;
  const int err = fill_for(kernel, threads, smem, &fill);
  if (err != 0) return err;
  const int tiles_y = (ny + ty - 1) / ty, tiles_z = (nz + kTZ - 1) / kTZ;
  *grid = dim3((unsigned)chunks_for(nx, tiles_y * tiles_z, fill, xc),
               (unsigned)tiles_y, (unsigned)tiles_z);
  return 0;
}

}  // namespace

extern "C" {

// off (n_taps, 3) int32 and coef (n_taps, 5) float32 [sh, dwv, e0, e1, e2]
// are host arrays; the constants are copied into the kernel's parameters.
int lattice_force_launch(const float* pos, const float* S, const float* jm2d,
                         const unsigned char* valid, int nx, int ny, int nz,
                         const int* off, const float* coef, int n_taps,
                         float* out, void* stream) {
  if (!taps_match(off, n_taps)) return (int)cudaErrorInvalidValue;
  ForceCoef c;
  for (int t = 0; t < kTaps; ++t) {
    c.sh[t] = coef[5 * t];
    c.dwv[t] = coef[5 * t + 1];
    for (int b = 0; b < 3; ++b) c.e[t][b] = coef[5 * t + 2 + b];
  }
  const long long n = (long long)nx * ny * nz;
  if (n == 0) return (int)cudaGetLastError();
  if (9 * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  dim3 grid;
  const int err = grid_for(lattice_force_kernel, kThreads1, kSmem1, kTY1,
                           kXC1, nx, ny, nz, &grid);
  if (err != 0) return err;
  lattice_force_kernel<<<grid, kThreads1, kSmem1,
                         static_cast<cudaStream_t>(stream)>>>(
      pos, S, jm2d, valid, nx, ny, nz, (int)grid.x, c, out);
  return (int)cudaGetLastError();
}

// coef (n_taps, 3) float32 [g0, g1, g2].
int lattice_dfdt_launch(const float* vel, const unsigned char* valid, int nx,
                        int ny, int nz, const int* off, const float* coef,
                        int n_taps, float* out, void* stream) {
  if (!taps_match(off, n_taps)) return (int)cudaErrorInvalidValue;
  DfdtCoef c;
  for (int t = 0; t < kTaps; ++t)
    for (int b = 0; b < 3; ++b) c.g[t][b] = coef[3 * t + b];
  const long long n = (long long)nx * ny * nz;
  if (n == 0) return (int)cudaGetLastError();
  if (9 * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  dim3 grid;
  const int err = grid_for(lattice_dfdt_kernel, kThreads2, kSmem2, kTY2, kXC2,
                           nx, ny, nz, &grid);
  if (err != 0) return err;
  lattice_dfdt_kernel<<<grid, kThreads2, kSmem2,
                        static_cast<cudaStream_t>(stream)>>>(
      vel, valid, nx, ny, nz, (int)grid.x, c, out);
  return (int)cudaGetLastError();
}

// The design's occupancy: for L1 (which 0) or L2 (1), writes [blocks an SM,
// threads a block, dynamic shared memory a block in bytes] to res.
int lattice_occupancy(int which, int* res) {
  Fill fill;
  const int err =
      which == 0 ? fill_for(lattice_force_kernel, kThreads1, kSmem1, &fill)
                 : fill_for(lattice_dfdt_kernel, kThreads2, kSmem2, &fill);
  res[0] = fill.per_sm;
  res[1] = which == 0 ? kThreads1 : kThreads2;
  res[2] = which == 0 ? kSmem1 : kSmem2;
  return err;
}

}  // extern "C"
