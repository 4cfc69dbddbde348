// Lane groups for the cell-block pair sweeps on Hopper (sm_90a): G lanes of
// one warp sweep one cell, its live window rows staged in the group's slice
// of shared memory a segment at a time and only their real j-slots summed.
// Included by block_sweeps.cu (B1-B4), packed_sweeps.cu (B5a-d) and
// layout_sweeps.cu (B6, whose 32-lane warp walks a cell's rows the same way
// but spreads the pairs over its lanes); each source is its own library, so
// everything here stays file-local.
//
// What differs between the two is the staged slot: a layout class says
// where a slot's float4 parts sit in a staging buffer, which channel marks
// it real, and what the compacted copy carries besides its data.
//   SplitSlots   block arrays repacked per channel: (x, y, z, w) then up to
//                two channel float4s, array-major; real where w > 0 (w is
//                VOL, or B1's fluid mask);
//   PackedSlots  packed (rows, 16, 8) slots copied as they lie, 32 bytes
//                [x, y, vx, vy | p, vol, mask, 0] as two float4s side by
//                side; real where mask != 0; the compacted copy carries the
//                slot's global index (row * 16 + j) in channel 7, so that a
//                lane can drop its self pair by index;
//   PackedWallSlots<CH>  the packed wall slots of B5c/B5d, copied as
//                PackedSlots are; real where channel CH (part 1: 5 for
//                [x, y, vol, ax | ay, mask, 0, 0], 7 for
//                [x, y, vol, vax | vay, nx, ny, mask]) != 0; the compacted
//                copy is the slot as it is (channel 7 may be the mask, and
//                a wall sweep has no self pair to drop).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int G>
__device__ __forceinline__ unsigned low_bits() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return (1u << G) - 1u;
  }
}

template <int G>
struct Group {
  unsigned mask;  // the group's lanes in the warp
  int base;       // its first lane in the warp
  int lane;       // this thread's lane in the group

  __device__ __forceinline__ Group() {
    const int wl = threadIdx.x & 31;
    lane = wl & (G - 1);
    base = wl - lane;
    mask = low_bits<G>() << base;
  }
  // bit l: `pred` of the group's lane l
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    return (__ballot_sync(mask, pred) >> base) & low_bits<G>();
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

// Part r of staged slot j in a buffer of narr arrays of `arr` float4s at
// at(j, r, arr); key(part kKeyPart) marks a real slot; an i-side key array
// holds one key every kKeyStride floats; tag(part kKeyPart, slot) is what
// the compacted copy keeps of that part.
struct SplitSlots {
  static constexpr int kKeyPart = 0;
  static constexpr int kKeyStride = 1;
  __device__ static __forceinline__ int at(int j, int r, int arr) {
    return r * arr + j;
  }
  __device__ static __forceinline__ float key(const float4& a) { return a.w; }
  __device__ static __forceinline__ bool real(float key) { return key > 0.0f; }
  __device__ static __forceinline__ float4 tag(const float4& a, int64_t) {
    return a;
  }
};

struct PackedSlots {
  static constexpr int kKeyPart = 1;
  static constexpr int kKeyStride = 8;
  __device__ static __forceinline__ int at(int j, int r, int) {
    return 2 * j + r;
  }
  __device__ static __forceinline__ float key(const float4& a) { return a.z; }
  __device__ static __forceinline__ bool real(float key) {
    return key != 0.0f;
  }
  __device__ static __forceinline__ float4 tag(const float4& a,
                                               int64_t slot) {
    return make_float4(a.x, a.y, a.z, __int_as_float((int)slot));
  }
};

template <int CH>
struct PackedWallSlots : PackedSlots {
  static_assert(CH >= 4 && CH < 8, "the mask lies in part 1");
  __device__ static __forceinline__ float key(const float4& a) {
    return CH == 4 ? a.x : CH == 5 ? a.y : CH == 6 ? a.z : a.w;
  }
  __device__ static __forceinline__ float4 tag(const float4& a, int64_t) {
    return a;
  }
};

// A segment: live windows whose block rows follow one another (row r,
// r + 1, ...; in row-major cell order the last axis's -1, 0, +1 windows of
// a cell whose neighbours are all occupied), staged and summed as one run
// of slots, in the same order as row by row.  A segment holds one row,
// and up to 3 rows as long as they fit in kSegSlots slots.
constexpr int kSegSlots = 48;

__host__ __device__ constexpr int seg_rows(int nmax) {
  return nmax >= kSegSlots / 2 ? 1 : (nmax >= kSegSlots / 3 ? 2 : 3);
}

// A group's slice of dynamic shared memory, in float4s: its cell's window
// rows (fluid, then wall; int32), two staging buffers and one buffer of
// compacted real slots, each NARR float4 arrays of seg_rows(nmax) * nmax
// slots.
template <int NWIN>
__host__ __device__ constexpr int rows_f4() {
  return (2 * NWIN + 3) / 4;
}

__host__ __device__ constexpr int buf_f4(int narr, int nmax) {
  return narr * seg_rows(nmax) * nmax;
}

template <int NWIN>
__host__ __device__ constexpr int group_f4(int narr, int nmax) {
  return rows_f4<NWIN>() + 3 * buf_f4(narr, nmax);
}

// The window rows of `cell` into rows[0, NWIN), a map entry per lane (two
// where NWIN > G); returns the live windows (row < sentinel) as bits.
template <int NWIN, int G>
__device__ __forceinline__ unsigned live_windows(const Group<G>& g,
                                                 const int* __restrict__ nbr,
                                                 int64_t cell, int sentinel,
                                                 int* rows) {
  unsigned live = 0u;
#pragma unroll
  for (int w0 = 0; w0 < NWIN; w0 += G) {
    const int w = w0 + g.lane;
    bool ok = false;
    if (w < NWIN) {
      const int row = nbr[cell * NWIN + w];
      rows[w] = row;
      ok = row < sentinel;
    }
    live |= g.ballot(ok) << w0;
  }
  return live;
}

// Copies of rows row .. row + m - 1 of a packed (rows, cap, 8) tensor
// (m * cap slots, contiguous) into dst as they lie, slot j's parts at
// dst[2 j], dst[2 j + 1] (PackedSlots), one 16-byte cp.async a part.
template <int G>
__device__ __forceinline__ void stage_packed(const Group<G>& g, float4* dst,
                                             const float* __restrict__ packed,
                                             int cap, int row, int m) {
  const float4* src =
      reinterpret_cast<const float4*>(packed) + (int64_t)row * cap * 2;
  for (int q = g.lane; q < m * cap * 2; q += G) {
    __pipeline_memcpy_async(dst + q, src + q, sizeof(float4));
  }
}

// Copies the real slots of a staged segment of n slots, each with its narr
// float4 parts (layout L, arrays of `arr` float4s), to the front of `dst`
// (same layout) in ascending j; returns their count.  `first` is the
// global index of the segment's slot 0 (for L::tag).
template <class L, int G>
__device__ __forceinline__ int compact_real(const Group<G>& g,
                                            const float4* raw, int n,
                                            int narr, int arr, float4* dst,
                                            int64_t first) {
  const unsigned below = (1u << g.lane) - 1u;
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += G) {
    const int jl = j0 + g.lane;
    const float4 a = jl < n ? raw[L::at(jl, L::kKeyPart, arr)]
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const bool real = L::real(L::key(a));
    const unsigned live = g.ballot(real);
    if (real) {
      const int k = count + __popc(live & below);
      dst[L::at(k, L::kKeyPart, arr)] = L::tag(a, first + jl);
      for (int r = 0; r < narr; ++r) {
        if (r != L::kKeyPart) dst[L::at(k, r, arr)] = raw[L::at(jl, r, arr)];
      }
    }
    count += __popc(live);
  }
  return count;
}

// One cell's live windows, fluid rows (bits of `fluid`, ascending), then
// wall rows, a segment at a time: stage(wall, row, m, dst) issues the
// copies of rows row .. row + m - 1 (m * cap slots, m * capw for the wall)
// into a staging buffer; its real slots are compacted into `cmp` and
// sum(wall, count, cmp) sums them.  The next segment's copies are in
// flight while one is summed (two staging buffers at `buf`, then `cmp`,
// each narr arrays of `arr` float4s; past the last segment an empty copy
// group is committed).
template <class L = SplitSlots, int G, class Stage, class Sum>
__device__ __forceinline__ void walk_rows(const Group<G>& g, unsigned fluid,
                                          unsigned wall, const int* rows,
                                          const int* wrows, int cap, int capw,
                                          int narr, int arr, float4* buf,
                                          Stage&& stage, Sum&& sum) {
  const int len = narr * arr;
  const int max_rows = arr / (cap > capw ? cap : capw);
  float4* cmp = buf + 2 * len;
  unsigned sf = fluid, sw = wall;  // windows still to stage
  // stages the next segment into `dst`; returns its rows (0: none left),
  // *is_wall whether it is a wall segment, *first its first block row
  auto stage_next = [&](float4* dst, bool* is_wall, int* first) {
    unsigned& live = sf != 0u ? sf : sw;
    const int* r = sf != 0u ? rows : wrows;
    *is_wall = sf == 0u;
    int m = 0;
    if (live != 0u) {
      const int row = r[__ffs(live) - 1];
      *first = row;
      do {
        live &= live - 1u;
        ++m;
      } while (m < max_rows && live != 0u && r[__ffs(live) - 1] == row + m);
      stage(*is_wall, row, m, dst);
    }
    __pipeline_commit();
    return m;
  };
  float4* cur = buf;
  float4* nxt = buf + len;
  bool cur_wall, nxt_wall;
  int cur_row = 0, nxt_row = 0;
  int m = stage_next(cur, &cur_wall, &cur_row);
  while (m > 0) {
    const int m_next = stage_next(nxt, &nxt_wall, &nxt_row);
    __pipeline_wait_prior(1);
    g.sync();
    const int width = cur_wall ? capw : cap;
    const int count = compact_real<L>(g, cur, m * width, narr, arr, cmp,
                                      (int64_t)cur_row * width);
    g.sync();
    sum(cur_wall, count, cmp);
    g.sync();
    float4* t = cur;
    cur = nxt;
    nxt = t;
    cur_wall = nxt_wall;
    cur_row = nxt_row;
    m = m_next;
  }
}

// fn(j) over the compacted real slots [0, count), j ascending; in a split
// group (group-uniform) the lower half takes the even j, the upper the odd.
template <int G, class Fn>
__device__ __forceinline__ void for_each_slot(const Group<G>& g, bool split,
                                              int count, Fn&& fn) {
  const int step = split ? 2 : 1;
  for (int j = split && g.lane >= G / 2 ? 1 : 0; j < count; j += step) fn(j);
}

// In a split group, adds the upper half's partial sum to the lower's.
template <int G>
__device__ __forceinline__ float fold_halves(const Group<G>& g, float x) {
  return x + __shfl_down_sync(g.mask, x, G / 2, G);
}

// A lane's i-slot in the i-chunk at i0.  Lane l owns slot i0 + l: it
// writes that slot's sums, zeros where the slot is padding (its key, read
// from `key` every L::kKeyStride floats, not real).  The group votes on its
// real slots; when all of them lie in the lower half (split), lanes l and
// l + G/2 both sum for slot i0 + l, each over half of the real j-slots
// (for_each_slot), and fold_halves adds them.
struct Slot {
  int64_t gs;     // the slot this lane sums for (clamped into the row)
  int64_t go;     // the slot this lane owns
  bool has;       // the summed slot exists (< cap)
  bool own;       // the owned slot exists
  bool own_real;  // the owned slot is real
  bool split;
  unsigned real;  // the chunk's real slots, bit l: slot i0 + l
};

template <class L = SplitSlots, int G>
__device__ __forceinline__ Slot lane_slot(const Group<G>& g, int64_t cell,
                                          int cap, int i0,
                                          const float* __restrict__ key) {
  Slot s;
  const int io = i0 + g.lane;
  s.own = io < cap;
  s.go = cell * cap + (s.own ? io : 0);
  s.own_real = s.own && L::real(key[s.go * L::kKeyStride]);
  s.real = g.ballot(s.own_real);
  s.split = (s.real >> (G / 2)) == 0u;
  const int is = s.split ? i0 + (g.lane & (G / 2 - 1)) : io;
  s.has = is < cap;
  s.gs = cell * cap + (s.has ? is : 0);
  return s;
}

// One group of G lanes per cell: blocks, and the dynamic shared memory of
// a block's kThreads / G groups (group_f4 float4s each);
// above the default 48 KB the kernel is allowed more first.
template <int G>
inline unsigned group_blocks(int C) {
  return (unsigned)(((int64_t)C * G + kThreads - 1) / kThreads);
}

template <int NWIN, int G, class K>
inline size_t group_smem_bytes(K kernel, int narr, int nmax) {
  const size_t bytes =
      (size_t)(kThreads / G) * group_f4<NWIN>(narr, nmax) * sizeof(float4);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  }
  return bytes;
}

}  // namespace
