// Particle tiles staged in shared memory, for the kernels that keep a tile
// of particles' landmark slots on chip for a tick or a chunk: the FastSLAM
// 2.0 pair (fused_fs2.cu, production) and the motion pair (fused_update.cu,
// production and parity).
//
// A block owns T particles with G lanes (threads) each.  It stages the
// tile's planes in dynamic shared memory, laid out [plane][slot][T], only
// the slots below the tile's largest count, with plain coalesced 4-byte
// loads.  The measurements then read and write shared memory only; at the
// end the block writes back, coalesced, only the slots that a measurement
// stored (a bit per slot and particle).
//
// Planes of a tile: 0 mx, 1 my, 2 ca, 3 cb, 4 cd, 5 the det entry, and in
// parity mode 6 cc (the covariance is not kept symmetric there).  The det
// entry is 1/det(cov) in production (-1 for an unusable slot), which takes
// the divide out of the packed-argmin scan, and det(cov) itself in parity
// (-1 past the count), which the first-hit test multiplies by the gate.
// Both are the values the plain versions compute (core/cuda_kernels.py:
// _initial_detp, _packed_argmin).
//
// The G lanes of a particle split its association scan: lane g takes slots
// g, g + G, ..., and the lanes take the minimum (of the packed key in
// production, of the hit slot in parity) with __shfl_xor_sync.  A minimum of
// integers does not depend on order, so the split is exact.  Slot l of
// particle i sits at column i ^ ((l mod G) * min(T, 32) / G) of its row, a
// permutation inside each group of min(T, 32) columns, so the G slots that
// the lanes of a warp's particles read together fall in distinct banks.

#pragma once

#include "measurement.cuh"

namespace {

constexpr int kPlanes = 6;                  // production: mx, my, ca, cb, cd, 1/det(cov)
constexpr int kParityPlanes = 7;            // parity: ..., det(cov), cc
constexpr int kSmemOptInLimit = 232448;     // 227 KB a block may opt into
constexpr int kStaticSmemBytes = 64;        // the kernels' __shared__ scalars

// One particle's column of the block's tile, the view apply_measurement
// (measurement.cuh) reaches its slots through.  Slot l of plane k sits at
// t[k * LT + at(l)]; the scan is split over the particle's G lanes.
template <bool PARITY>
struct TileColumn {
  float* t;            // [planes][L][T]
  unsigned* written;   // [ceil(L / 32)][T]: bit l of column i set once slot l is stored
  int LT, T, i, g, G, swz_mask, swz_shift, L;
  unsigned lanes;      // the particle's lanes within its warp

  __device__ __forceinline__ int at(const int l) const {
    return l * T + (i ^ ((l & swz_mask) << swz_shift));
  }

  __device__ __forceinline__ int argmin(const float wx, const float wy, const int cnt) const {
    // slots at and above the count are never usable (-1 det at staging, and
    // an append fills slot cnt first), so the scan stops there.  Lane g's
    // slots g, g + G, ... share one swizzle: their offsets step by G rows.
    int kmin = kInvalidKey;
    int o = at(g);
#pragma unroll 4
    for (int l = g; l < cnt; l += G, o += G * T) {
      const float inv = t[5 * LT + o];
      const float cb = t[3 * LT + o];
      const int key = slot_key(t[o], t[LT + o], t[2 * LT + o], cb, cb, t[4 * LT + o], inv,
                               wx, wy, l);
      kmin = min(kmin, inv >= 0.0f ? key : kInvalidKey);
    }
    for (int off = 1; off < G; off <<= 1) {
      kmin = min(kmin, __shfl_xor_sync(lanes, kmin, off));
    }
    return kmin;
  }

  // parity: the first usable slot under the gate (d2 < gate^2 * det), L if
  // none; each lane finds the first of its slots, and the smallest of those
  // is the first of all
  __device__ __forceinline__ int first_hit(const float qx, const float qy, const float gate2,
                                           const int cnt) const {
    int hit = L;
    int o = at(g);
    for (int l = g; l < cnt; l += G, o += G * T) {
      const float dtp = t[5 * LT + o];
      if (!(dtp > 0.0f)) continue;
      const float dx = t[o] - qx;
      const float dy = t[LT + o] - qy;
      const float d2f = dx * (t[4 * LT + o] * dx - t[3 * LT + o] * dy)
                        + dy * (-t[6 * LT + o] * dx + t[2 * LT + o] * dy);
      if (d2f < gate2 * dtp) {
        hit = l;
        break;
      }
    }
    for (int off = 1; off < G; off <<= 1) {
      hit = min(hit, __shfl_xor_sync(lanes, hit, off));
    }
    return hit;
  }

  template <bool P_>
  __device__ __forceinline__ void load(const int l, float& mu_x, float& mu_y, float& a,
                                       float& b, float& c, float& d) const {
    static_assert(P_ == PARITY, "a tile is staged for one mode");
    const int o = at(l);
    mu_x = t[o];
    mu_y = t[LT + o];
    a = t[2 * LT + o];
    b = t[3 * LT + o];
    if constexpr (PARITY) {
      c = t[6 * LT + o];
    } else {
      c = b;
    }
    d = t[4 * LT + o];
  }

  template <bool P_>
  __device__ __forceinline__ void store(const int l, const float new_mx, const float new_my,
                                        const float a, const float b, const float c,
                                        const float d, const float det) {
    static_assert(P_ == PARITY, "a tile is staged for one mode");
    __syncwarp(lanes);   // every lane has read the slot
    if (g != 0) return;
    const int o = at(l);
    t[o] = new_mx;
    t[LT + o] = new_my;
    t[2 * LT + o] = a;
    t[3 * LT + o] = b;
    t[4 * LT + o] = d;
    if constexpr (PARITY) {
      t[5 * LT + o] = det;
      t[6 * LT + o] = c;
    } else {
      t[5 * LT + o] = det > 0.0f ? 1.0f / det : -1.0f;
    }
    written[(l >> 5) * T + i] |= 1u << (l & 31);
  }

  __device__ __forceinline__ void sync() const { __syncwarp(lanes); }
};

// The block's dynamic shared memory: the tile [planes][L][T] | written bits
// [ceil(L / 32)][T] | counts [T] | z table [M][4] | valid [M]
struct TileBlock {
  float* t;
  unsigned* written;
  int* cnt;
  float* z;
  int* zv;
};

inline size_t tile_shared_bytes(const int L, const int M, const int T,
                                const int planes = kPlanes) {
  return (static_cast<size_t>(planes) * L * T + static_cast<size_t>((L + 31) / 32) * T + T
          + 5 * static_cast<size_t>(M)) * sizeof(float);
}

template <bool PARITY = false>
__device__ __forceinline__ TileBlock carve(float* smem, const int L, const int M,
                                           const int T) {
  TileBlock b;
  b.t = smem;
  b.written = reinterpret_cast<unsigned*>(
      smem + static_cast<size_t>(PARITY ? kParityPlanes : kPlanes) * L * T);
  b.cnt = reinterpret_cast<int*>(b.written + ((L + 31) / 32) * T);
  b.z = reinterpret_cast<float*>(b.cnt + T);
  b.zv = reinterpret_cast<int*>(b.z + 4 * M);
  return b;
}

// The particle tile and lane layout of one thread.
struct Lanes {
  int T, G, i, g, swz_mask, swz_shift;
  unsigned lanes;
};

// group_log2: log2 of the columns the swizzle permutes, min(T, 32); the fs2
// tiles are whole multiples of 32
__device__ __forceinline__ Lanes lanes_of(const int G, const int group_log2 = 5) {
  Lanes w;
  w.G = G;
  w.T = blockDim.x / G;
  w.i = threadIdx.x / G;
  w.g = threadIdx.x & (G - 1);
  w.swz_mask = G - 1;
  w.swz_shift = group_log2 + 1 - __ffs(G);   // log2(min(T, 32) / G)
  const int lane = threadIdx.x & 31;
  w.lanes = (G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u)) << (lane & ~(G - 1));
  return w;
}

template <bool PARITY = false>
__device__ __forceinline__ TileColumn<PARITY> column(const TileBlock& b, const Lanes& w,
                                                     const int L) {
  return TileColumn<PARITY>{b.t, b.written, L * w.T, w.T, w.i, w.g, w.G, w.swz_mask,
                            w.swz_shift, L, w.lanes};
}

// Stage the tile of particles p0 .. p0 + T - 1; every thread of the block
// takes part.  Counts (0 past P) go to b.cnt and their largest to `rows`;
// then the planes of the slots below it, and the det entry of each slot.
// cc is read in parity mode only.  Clears the written bits.  Ends with a
// barrier.
template <bool PARITY = false>
__device__ __forceinline__ void stage_tile(
    const TileBlock& b, int& rows, const Lanes& w, const size_t p0, const int P,
    const int L, const float* __restrict__ mx, const float* __restrict__ my,
    const float* __restrict__ ca, const float* __restrict__ cb, const float* cc,
    const float* __restrict__ cd, const int* __restrict__ cnt_in) {
  const int T = w.T;
  const int LT = L * T;
  if (threadIdx.x == 0) rows = 0;
  for (int k = threadIdx.x; k < ((L + 31) / 32) * T; k += blockDim.x) b.written[k] = 0u;
  __syncthreads();
  for (int c = threadIdx.x; c < T; c += blockDim.x) {
    const int n = p0 + c < static_cast<size_t>(P) ? cnt_in[p0 + c] : 0;
    b.cnt[c] = n;
    atomicMax(&rows, n);
  }
  __syncthreads();
  // thread (row r, column c) of the block takes rows r, r + G, ... of
  // column c: coalesced rows, one swizzle per thread
  const int staged = rows;
  const int c = threadIdx.x % T;
  const int r = threadIdx.x / T;
  const size_t p = p0 + c;
  if (p < static_cast<size_t>(P)) {
    const int n = b.cnt[c];
    int o = r * T + (c ^ (r << w.swz_shift));
#pragma unroll 4
    for (int l = r; l < staged; l += w.G, o += w.G * T) {
      const size_t q = static_cast<size_t>(l) * P + p;
      const float a = ca[q];
      const float bb = cb[q];
      const float d = cd[q];
      b.t[o] = mx[q];
      b.t[LT + o] = my[q];
      b.t[2 * LT + o] = a;
      b.t[3 * LT + o] = bb;
      b.t[4 * LT + o] = d;
      if constexpr (PARITY) {
        const float cv = cc[q];
        b.t[6 * LT + o] = cv;
        b.t[5 * LT + o] = l < n ? a * d - bb * cv : -1.0f;
      } else {
        const float det = a * d - bb * bb;
        b.t[5 * LT + o] = (l < n && det > 0.0f) ? 1.0f / det : -1.0f;
      }
    }
  }
  __syncthreads();
}

// Write back the slots that a measurement stored, once every particle of
// the tile is done (a barrier before; `rows` is the tile's largest count by
// then, raised by each particle's final count).  cc is written in parity
// mode only.
template <bool PARITY = false>
__device__ __forceinline__ void write_back(
    const TileBlock& b, const int rows, const Lanes& w, const size_t p0, const int P,
    const int L, float* __restrict__ mx, float* __restrict__ my, float* __restrict__ ca,
    float* __restrict__ cb, float* cc, float* __restrict__ cd) {
  const int T = w.T;
  const int LT = L * T;
  const int c = threadIdx.x % T;   // rows r, r + G, ... of column c, as staged
  const int r = threadIdx.x / T;
  const size_t p = p0 + c;
  if (p >= static_cast<size_t>(P)) return;
  int o = r * T + (c ^ (r << w.swz_shift));
  for (int l = r; l < rows; l += w.G, o += w.G * T) {
    if (!((b.written[(l >> 5) * T + c] >> (l & 31)) & 1u)) continue;
    const size_t q = static_cast<size_t>(l) * P + p;
    mx[q] = b.t[o];
    my[q] = b.t[LT + o];
    ca[q] = b.t[2 * LT + o];
    cb[q] = b.t[3 * LT + o];
    cd[q] = b.t[4 * LT + o];
    if constexpr (PARITY) cc[q] = b.t[6 * LT + o];
  }
}

}  // namespace
