// Shared device helpers of the hand-written kernels: the W4 SPH spline,
// the softened gravity factor and the erfc truncation polynomial. Each
// function spells out, in the same operation order, the float32 arithmetic
// of its plain PyTorch twin (ops/sph_kernels.py, ops/softening.py,
// ops/cells.py), so a kernel and its plain version differ only in the
// order of the sums. Also the box culling and the cp.async staging that
// the block SPH kernels C and D share, the ranking of targets in space
// order of A, H, I/J and K, and the chunk walk of the entries kernels F
// and G (their need words and the items those name).
#pragma once

#include <cuda_runtime.h>

namespace glt {

// KERNEL_COEFF_1 = 8 / pi
constexpr float kNorm3d = 2.5464790894703255f;

// Source tiles are staged in shared memory in chunks of at most this many
// slots, so a block's shared memory stays fixed whatever the capacity.
constexpr int kTile = 256;

__device__ __forceinline__ float inv_or_zero(float h) {
  return h > 0.f ? 1.0f / h : 0.f;
}

// w(u) of the W4 spline (without the 8/(pi h^3) factor)
__device__ __forceinline__ float w4_u(float u) {
  const float one_m = 1.0f - u;
  if (u < 0.5f) return 1.0f - 6.0f * u * u + 6.0f * u * u * u;
  if (u < 1.0f) return 2.0f * one_m * one_m * one_m;
  return 0.f;
}

// dw/du of the W4 spline
__device__ __forceinline__ float w4_du(float u) {
  const float one_m = 1.0f - u;
  if (u < 0.5f) return u * (18.0f * u - 12.0f);
  if (u < 1.0f) return -6.0f * one_m * one_m;
  return 0.f;
}

// dW/dr for a given 1/h (kernel_dw_dr)
__device__ __forceinline__ float w4_dw_dr(float r, float hinv) {
  const float hinv2 = hinv * hinv;
  return kNorm3d * hinv2 * hinv2 * w4_du(r * hinv);
}

// softened 1/r^3 with no division (grav_fac_nodiv)
__device__ __forceinline__ float grav_fac_nodiv(float r, float rinv, float h,
                                                float hinv) {
  const float u = r * hinv;
  const float rinv3 = rinv * rinv * rinv;
  if (u < 0.5f) {
    const float hinv3 = hinv * hinv * hinv;
    return hinv3 * (10.666666666667f + u * u * (32.0f * u - 38.4f));
  }
  if (u < 1.0f) {
    const float hinv3 = hinv * hinv * hinv;
    const float uinv3 = h * h * h * rinv3;
    return hinv3 * (21.333333333333f - 48.0f * u + 38.4f * u * u -
                    10.666666666667f * (u * u * u) -
                    0.066666666667f * uinv3);
  }
  return rinv3;
}

// erfc(x) + 2x/sqrt(pi) exp(-x^2) as a degree-10 polynomial on
// x in [0, 2.25] (the JAX package's _TRUNC_P10, max |err| 6.5e-6); the
// caller masks r >= rcut, so x never leaves the fitted range.
__device__ __forceinline__ float trunc_p10(float x) {
  float p = 0.00527855602f;
  p = p * x + -0.0574951754f;
  p = p * x + 0.239634766f;
  p = p * x + -0.426925219f;
  p = p * x + 0.121668214f;
  p = p * x + 0.480734922f;
  p = p * x + -0.060829609f;
  p = p * x + -0.724873424f;
  p = p * x + -0.00511726609f;
  p = p * x + 0.00034025031f;
  p = p * x + 0.999996443f;
  return p;
}

// softened potential factor phi / (G m) with no division
// (grav_pot_nodiv): the spline inside h, -1/r outside
__device__ __forceinline__ float grav_pot_nodiv(float r, float rinv, float h,
                                                float hinv) {
  const float u = r * hinv;
  if (u < 0.5f) {
    return hinv * (-2.8f + u * u * (5.333333333333f + u * u * (6.4f * u - 9.6f)));
  }
  if (u < 1.0f) {
    const float uinv = h * rinv;
    return hinv * (-3.2f + 0.066666666667f * uinv +
                   u * u * (10.666666666667f +
                            u * (-16.0f + u * (9.6f - 2.133333333333f * u))));
  }
  return -rinv;
}

// erfc(x) as a degree-10 polynomial on x in [0, 2.25] (the JAX package's
// _ERFC_P10, max |err| 5.2e-7; ops/softening.py ERFC_P10)
__device__ __forceinline__ float erfc_p10(float x) {
  float p = -0.000708430614f;
  p = p * x + 0.0086528472f;
  p = p * x + -0.0418223107f;
  p = p * x + 0.0932881235f;
  p = p * x + -0.0643211737f;
  p = p * x + -0.0737919465f;
  p = p * x + -0.0145173017f;
  p = p * x + 0.379212313f;
  p = p * x + -0.000326738866f;
  p = p * x + -1.1283663f;
  p = p * x + 0.999999923f;
  return p;
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// One axis of a coarse-cell stencil (kernels I/J and K): the neighbour
// coordinate i of a grid of n cells on that axis. A periodic axis (kWrap)
// wraps i into [0, n) and sets the whole-tile shift sh to -+box across
// the wrap (n >= 3, so a cell is met once); a clamped axis leaves sh
// alone and says whether i lies inside the grid.
template <bool kWrap>
__device__ __forceinline__ bool stencil_axis(int& i, int n, float& sh,
                                             float box) {
  if constexpr (kWrap) {
    if (i < 0) {
      i += n;
      sh = -box;
    } else if (i >= n) {
      i -= n;
      sh = box;
    }
    return true;
  } else {
    return i >= 0 && i < n;
  }
}

// The pair arithmetic below is shared by a dense kernel and its
// active-entry twin (A and E, C and F; G repeats D's), so the two tiers of
// a force differ only in the order of their sums. The coarse-cell density
// kernel (I/J) shares C's; the coarse-cell hydro kernel (K) spells out D's.

// Short-range gravity (A, E): adds to (ax, ay, az) the pull of a source at
// (sx, sy, sz), already shifted by its stencil offset, of mass m and
// softening (sh, 1/sh) on a target at (tx, ty, tz) with (th, 1/th). Pairs
// with r2 = 0 (the self-pair) or r >= rcut add nothing.
__device__ __forceinline__ void gravity_pair(float tx, float ty, float tz,
                                             float th, float thinv, float sx,
                                             float sy, float sz, float m,
                                             float sh, float shinv,
                                             float half_inv_asmth,
                                             float rcut2, float& ax,
                                             float& ay, float& az) {
  const float dx = tx - sx;
  const float dy = ty - sy;
  const float dz = tz - sz;
  const float r2 = dx * dx + dy * dy + dz * dz;
  if (!(r2 < rcut2 && r2 > 0.f)) return;
  const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
  const float r = r2 * rinv;
  const float hh = fmaxf(th, sh);
  const float hhinv = fminf(thinv, shinv);
  float fac = grav_fac_nodiv(r, rinv, hh, hhinv);
  fac = fac * trunc_p10(fminf(r * half_inv_asmth, 2.25f));
  const float w = m * fac;
  ax -= w * dx;
  ay -= w * dy;
  az -= w * dz;
}

// Short-range gravity and potential (H): gravity_pair's arithmetic, and
// adds to pot the erfc-truncated softened potential m grav_pot(r)
// erfc(r / (2 asmth)). Kept apart from gravity_pair so that A's and E's
// code stays as it was.
__device__ __forceinline__ void gravity_potential_pair(
    float tx, float ty, float tz, float th, float thinv, float sx, float sy,
    float sz, float m, float sh, float shinv, float half_inv_asmth,
    float rcut2, float& ax, float& ay, float& az, float& pot) {
  const float dx = tx - sx;
  const float dy = ty - sy;
  const float dz = tz - sz;
  const float r2 = dx * dx + dy * dy + dz * dz;
  if (!(r2 < rcut2 && r2 > 0.f)) return;
  const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
  const float r = r2 * rinv;
  const float hh = fmaxf(th, sh);
  const float hhinv = fminf(thinv, shinv);
  const float x = fminf(r * half_inv_asmth, 2.25f);
  const float fac = grav_fac_nodiv(r, rinv, hh, hhinv) * trunc_p10(x);
  const float pfac = grav_pot_nodiv(r, rinv, hh, hhinv) * erfc_p10(x);
  const float w = m * fac;
  ax -= w * dx;
  ay -= w * dy;
  az -= w * dz;
  pot += m * pfac;
}

// SPH density (C, F and the coarse-cell I/J): adds the pair at separation (dx, dy, dz) and
// relative velocity (dvx, dvy, dvz) (target minus source) of a source of
// mass m to a target's sums acc = (rho, drho/dh, div v, rot v x, y, z),
// for the target's 1/h = hinv. Pairs outside the support add nothing.
__device__ __forceinline__ void density_pair(float dx, float dy, float dz,
                                             float dvx, float dvy, float dvz,
                                             float m, float hinv,
                                             float (&acc)[6]) {
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
  const float r = r2 * rinv;
  const float u = r * hinv;
  if (!(u < 1.0f)) return;
  const float hinv2 = hinv * hinv;
  const float hinv3 = hinv2 * hinv;
  const float wu = w4_u(u);
  const float du = w4_du(u);
  const float w = kNorm3d * hinv3 * wu;
  const float dwdh = -kNorm3d * hinv3 * hinv * (3.0f * wu + u * du);
  const float dwdr = kNorm3d * hinv2 * hinv2 * du;
  const float fac = m * dwdr * rinv;
  const float vdotr = dvx * dx + dvy * dy + dvz * dz;
  acc[0] += m * w;
  acc[1] += m * dwdh;
  acc[2] -= fac * vdotr;
  acc[3] += fac * (dvy * dz - dvz * dy);
  acc[4] += fac * (dvz * dx - dvx * dz);
  acc[5] += fac * (dvx * dy - dvy * dx);
}

// The fields of a hydro pair's target (pack rows 4-11).
struct HydroTarget {
  float vx, vy, vz, h, rho, por, c, bal;
};

// SPH hydro (G; kernel D spells out the same arithmetic inline, where a
// shared call took 56 registers against 48 and cost D a fifth of its
// occupancy): adds a pair inside the support, r < max(h_i, h_j), at
// separation (dx, dy, dz) (target minus source) and distance r = 1/rinv,
// of target t (with 1/h = hinv_t) and the source with pack rows s[0..11],
// to the target's sums acc = (ax, ay, az, raw dA/dt, max v_sig): the
// entropy-form force with Monaghan-Balsara viscosity, the Balsara
// limiter, the Hubble-flow term and fac_mu [G2: hydra.c ::
// hydro_evaluate()]. The caller has already left out invalid sources, the
// self-pair (by particle index) and pairs outside the support.
__device__ __forceinline__ void hydro_pair(float dx, float dy, float dz,
                                           float r, float rinv,
                                           const HydroTarget& t, float hinv_t,
                                           const float (&s)[12],
                                           float hubble_a2_flow, float fac_mu,
                                           float half_visc, float (&acc)[5]) {
  const float dwk_i = w4_dw_dr(r, hinv_t);
  const float dwk_j = w4_dw_dr(r, inv_or_zero(s[7]));
  const float dvx = t.vx - s[4];
  const float dvy = t.vy - s[5];
  const float dvz = t.vz - s[6];
  const float rr = r * r;
  const float vdotr2 = dvx * dx + dvy * dy + dvz * dz + hubble_a2_flow * rr;
  const bool approaching = vdotr2 < 0.f;
  const float mu = fac_mu * vdotr2 * rinv;
  const float vsig = t.c + s[10] - 3.0f * (approaching ? mu : 0.f);
  const float rho_ij = 0.5f * (t.rho + s[8]);
  const float rs = rsqrtf(fmaxf(rho_ij, 1e-37f));
  const float rho_ij_inv = rs * rs;
  const float f_ij = 0.5f * (t.bal + s[11]);
  const float visc =
      approaching ? half_visc * vsig * (-mu) * rho_ij_inv * f_ij : 0.f;
  const float m = s[3];
  const float hfc_visc = 0.5f * m * visc * (dwk_i + dwk_j) * rinv;
  const float hfc = hfc_visc + m * (t.por * dwk_i + s[9] * dwk_j) * rinv;
  acc[0] -= hfc * dx;
  acc[1] -= hfc * dy;
  acc[2] -= hfc * dz;
  acc[3] += 0.5f * (hfc_visc * vdotr2);
  acc[4] = fmaxf(acc[4], vsig);
}

// Warp-wide sum and max: every lane ends with the same value (the
// butterfly adds a + b and b + a, which are equal in IEEE arithmetic).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Threads of the active-entry kernels (E, F, G): one warp per entry, this
// many entries per thread block.
constexpr int kEntryLanes = 8;   // ENTRY_LANES of ops/cells.py
constexpr int kEntryWarps = 4;

// The culling of the SPH kernels C, D and I/J (csrc/sph_density.cu,
// csrc/sph_hydro.cu, csrc/sph_cells_density.cu, whose headers set out the
// rule): boxes of a warp's targets and of each source subcell or chunk,
// and the test of a pair on boxes that contain both its ends.

constexpr unsigned kFull = 0xffffffffu;
// a source is culled only beyond its reach (1 + 1e-5) of a box
constexpr float kCullMargin2 = 1.00002f;

// A bounding box and the largest h (the reach) of the particles in it
struct Box {
  float lo[3], hi[3], h;
};

// How a source's shift sh enters dx on each axis, as each kernel takes
// dx: kNone, dx = t - s (the absolute packs of C and D); kPair, dx = (t -
// s) + sh (C and D's block-relative packs); kSource, dx = t - (s + sh)
// (I/J, whose tiles across the wrap are shifted as a whole). The box test
// must take dx as its kernel does to stay monotone, so the argument names
// the caller's form of dx.
enum class Shift { kNone, kPair, kSource };

// Whether a pair with its target in box t and its source in box s (dx per
// axis by kShift) may have r < max(t.h, hs): the box distance per axis is
// taken as dx is, monotone in both ends, so it is never above the |dx| of
// a pair inside the boxes.
template <Shift kShift>
__device__ __forceinline__ bool near_boxes(const Box& t, const float (&slo)[3],
                                           const float (&shi)[3], float hs,
                                           const float (&sh)[3]) {
  float e2 = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float l, u;
    if constexpr (kShift == Shift::kNone) {
      l = t.lo[a] - shi[a];
      u = t.hi[a] - slo[a];
    } else if constexpr (kShift == Shift::kPair) {
      l = (t.lo[a] - shi[a]) + sh[a];
      u = (t.hi[a] - slo[a]) + sh[a];
    } else {
      l = t.lo[a] - (shi[a] + sh[a]);
      u = t.hi[a] - (slo[a] + sh[a]);
    }
    const float e = fmaxf(fmaxf(l, -u), 0.f);
    e2 += e * e;
  }
  const float hh = fmaxf(t.h, hs);
  return e2 < hh * hh * kCullMargin2;
}

// The box of the warp's lanes with `in` set (all lanes call it)
__device__ __forceinline__ Box warp_box(bool in, float x, float y, float z,
                                        float h) {
  const float inf = __int_as_float(0x7f800000);
  Box b{{in ? x : inf, in ? y : inf, in ? z : inf},
        {in ? x : -inf, in ? y : -inf, in ? z : -inf},
        in ? h : 0.f};
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      b.lo[a] = fminf(b.lo[a], __shfl_xor_sync(kFull, b.lo[a], off));
      b.hi[a] = fmaxf(b.hi[a], __shfl_xor_sync(kFull, b.hi[a], off));
    }
    b.h = fmaxf(b.h, __shfl_xor_sync(kFull, b.h, off));
  }
  return b;
}

// Targets in space order (kernels A, H, I/J and K): a block ranks its slots
// by the Morton key of their cells (qx, qy, qz) on a (2^kKeyBits)^3 grid,
// so that each warp holds 32 close targets.
constexpr int kKeyBits = 3;

__device__ __forceinline__ unsigned morton_key(unsigned qx, unsigned qy,
                                               unsigned qz) {
  unsigned out = 0;
  for (int b = 0; b < kKeyBits; ++b)
    out |= ((qx >> b) & 1u) << (3 * b + 2) | ((qy >> b) & 1u) << (3 * b + 1) |
           ((qz >> b) & 1u) << (3 * b);
  return out;
}

// s_slot[r] = the slot t of the thread whose key ranks r-th in the block,
// ties by thread (a parked slot's key is kFull: parked slots come last);
// s_key holds blockDim.x keys. All threads call it; it ends with a
// barrier.
__device__ __forceinline__ void rank_slots(unsigned key, int t,
                                           unsigned* s_key, int* s_slot) {
  s_key[threadIdx.x] = key;
  __syncthreads();
  int rank = 0;
  for (int i = 0; i < static_cast<int>(blockDim.x); ++i) {
    const unsigned ki = s_key[i];
    rank += ki < key || (ki == key && i < static_cast<int>(threadIdx.x));
  }
  s_slot[rank] = t;
  __syncthreads();
}

// The coarse-cell kernels I/J and K rank a cell's slots by the Morton key
// over the box of the block's live slots (they do not know a vacuum
// grid's origin): x's cell on the key's grid over [lo, lo + (2^kKeyBits)
// / scale], with no contraction (__fsub_rn, __fmul_rn), so the host can
// repeat it.
__device__ __forceinline__ unsigned key_axis(float x, float lo, float scale) {
  const float f = floorf(__fmul_rn(__fsub_rn(x, lo), scale));
  return static_cast<unsigned>(
      fminf(fmaxf(f, 0.f), static_cast<float>((1 << kKeyBits) - 1)));
}

// rank_slots for slot t at (x, y, z), live where `in`, keyed over the box
// of the block's live slots; s_box holds a Box a warp. All threads call
// it; it ends with a barrier.
__device__ __forceinline__ void rank_by_box(bool in, float x, float y,
                                            float z, int t, Box* s_box,
                                            unsigned* s_key, int* s_slot) {
  const Box wb = warp_box(in, x, y, z, 0.f);
  if ((threadIdx.x & 31) == 0) s_box[threadIdx.x >> 5] = wb;
  __syncthreads();
  float lo[3], scale[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float l = s_box[0].lo[a], u = s_box[0].hi[a];
    for (int w = 1; w < static_cast<int>(blockDim.x) / 32; ++w) {
      l = fminf(l, s_box[w].lo[a]);
      u = fmaxf(u, s_box[w].hi[a]);
    }
    lo[a] = l;
    scale[a] = u > l ? static_cast<float>(1 << kKeyBits) / (u - l) : 0.f;
  }
  unsigned key = kFull;
  if (in)
    key = morton_key(key_axis(x, lo[0], scale[0]), key_axis(y, lo[1], scale[1]),
                     key_axis(z, lo[2], scale[2]));
  rank_slots(key, t, s_key, s_slot);
}

// Threads of subcell_boxes_kernel: one warp a part
constexpr int kBoxThreads = 256;

namespace {

// boxes[(o * parts + k) * 8 + 0..6] = lo x, y, z, hi x, y, z and the
// largest h of the valid sources among slots k * part .. (k + 1) * part - 1
// (those below lanes) of tile o (lo = +inf, hi = -inf, h = 0 where it has
// none) in a pack of kStride rows of lanes slots a tile, for items = tiles
// x parts: a source is valid where row kValidRow is > 0, and its h is row
// kHRow (or 0 for every source where kHRow < 0: the density kernels,
// whose support is the target's h alone). The parts are the 8 subcells of
// a block of C and D (part = lanes / 8) or the 32-slot chunks of a cell
// of I/J (part = 32). One warp a part.
template <int kStride, int kValidRow, int kHRow>
__global__ void __launch_bounds__(kBoxThreads)
    subcell_boxes_kernel(const float* __restrict__ src,
                         float* __restrict__ boxes, int lanes, int part,
                         int parts, int items) {
  const int item = blockIdx.x * (kBoxThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= items) return;   // the whole warp
  const int o = item / parts, k = item - o * parts;
  const int end = min(part, lanes - k * part);
  const float* s = src + static_cast<size_t>(o) * kStride * lanes + k * part;
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf}, h = 0.f;
  for (int i = lane; i < end; i += 32) {
    if (!(s[kValidRow * lanes + i] > 0.f)) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], s[a * lanes + i]);
      hi[a] = fmaxf(hi[a], s[a * lanes + i]);
    }
    if constexpr (kHRow >= 0) h = fmaxf(h, s[kHRow * lanes + i]);
  }
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], off));
    }
    h = fmaxf(h, __shfl_xor_sync(kFull, h, off));
  }
  if (lane < 8) {
    const float v[8] = {lo[0], lo[1], lo[2], hi[0], hi[1], hi[2], h, 0.f};
    boxes[static_cast<size_t>(item) * 8 + lane] = v[lane];
  }
}

// subcell_boxes_kernel over tiles x ceil(lanes / part) parts, on st
template <int kStride, int kValidRow, int kHRow>
void launch_boxes(const float* src, float* boxes, int tiles, int lanes,
                  int part, cudaStream_t st) {
  const int parts = (lanes + part - 1) / part;
  const int items = tiles * parts;
  constexpr int per_block = kBoxThreads / 32;
  subcell_boxes_kernel<kStride, kValidRow, kHRow>
      <<<(items + per_block - 1) / per_block, kBoxThreads, 0, st>>>(
          src, boxes, lanes, part, parts, items);
}

}  // namespace

// The active-entry SPH kernels F and G (csrc/sph_density_entries.cu,
// csrc/sph_hydro_entries.cu, whose headers set out the walk): an entry's
// target rows sit at tgt + e * kTgtRows * kEntryLanes (x, y, z in rows
// 0-2), a lane is live where row kLiveRow is > 0, and its h is row kHRow
// of the entry, or, where kHRow < 0, h[e * kEntryLanes + lane].
template <int kTgtRows, int kLiveRow, int kHRow>
struct EntryRows {
  __device__ __forceinline__ static const float* rows(const float* tgt,
                                                      int e) {
    return tgt + static_cast<size_t>(e) * kTgtRows * kEntryLanes;
  }
  __device__ __forceinline__ static const float* hs(const float* tg,
                                                    const float* h, int e) {
    if constexpr (kHRow >= 0) return tg + kHRow * kEntryLanes;
    return h + static_cast<size_t>(e) * kEntryLanes;
  }
  // The box of the entry's live lanes and the reach of their largest h
  // (all lanes call it; lanes 0-7 read the entry's lanes). A NaN h adds
  // nothing, and the reach is at least 0.
  __device__ __forceinline__ static Box box(const float* tg, const float* he,
                                            int lane) {
    const bool in =
        lane < kEntryLanes && tg[kLiveRow * kEntryLanes + lane] > 0.f;
    const int l = in ? lane : 0;
    return warp_box(in, tg[l], tg[kEntryLanes + l], tg[2 * kEntryLanes + l],
                    in ? he[l] : 0.f);
  }
};

// The 8 odd source blocks of even block b and their shifts
struct OddBlocks {
  int bx, by, bz, nb;
  float lf;
  template <bool kAbs>
  __device__ __forceinline__ int block(int g) const {
    const int gx = g >> 2, gy = (g >> 1) & 1, gz = g & 1;
    if constexpr (kAbs) {
      const int nbo = nb + 1;
      return ((bx + gx) * nbo + (by + gy)) * nbo + (bz + gz);
    } else {
      return (wrap(bx + gx, nb) * nb + wrap(by + gy, nb)) * nb +
             wrap(bz + gz, nb);
    }
  }
  template <bool kAbs>
  __device__ __forceinline__ void shifts(int g, float (&sh)[3]) const {
    sh[0] = kAbs ? 0.f : static_cast<float>(1 - 2 * (g >> 2)) * lf;
    sh[1] = kAbs ? 0.f : static_cast<float>(1 - 2 * ((g >> 1) & 1)) * lf;
    sh[2] = kAbs ? 0.f : static_cast<float>(1 - 2 * (g & 1)) * lf;
  }
};

__device__ __forceinline__ OddBlocks odd_blocks(int b, int nb, float lf) {
  return {b / (nb * nb), (b / nb) % nb, b % nb, nb, lf};
}

// The even block grid of kernels C and D, per axis: n[a] even blocks, bit a
// of `per` set where axis a wraps. A wrapped axis's odd grid has n[a]
// blocks and its source ids wrap mod n[a]; a clamped axis's odd grid has
// n[a] + 1 and needs no wrap. A cubic periodic grid is n = (nb, nb, nb),
// per = 7; the absolute mode's clamped grid per = 0; the slab's grid
// (clamped x, periodic y and z) per = 6.
struct BlockGrid {
  int n[3];
  int per;
  __device__ __forceinline__ int odd(int a) const {
    return (per >> a) & 1 ? n[a] : n[a] + 1;
  }
  __device__ __forceinline__ int coord(int a, int i) const {
    return (per >> a) & 1 ? wrap(i, n[a]) : i;
  }
  // odd source block b + g of even block (bx, by, bz)
  __device__ __forceinline__ int source(int bx, int by, int bz, int g) const {
    return (coord(0, bx + (g >> 2)) * odd(1) + coord(1, by + ((g >> 1) & 1))) *
               odd(2) +
           coord(2, bz + (g & 1));
  }
};

inline int odd_blocks_of(const int (&n)[3], int per) {
  int c = 1;
  for (int a = 0; a < 3; ++a) c *= (per >> a) & 1 ? n[a] : n[a] + 1;
  return c;
}

// The items (odd block g, chunk c), u = g * chunks + c, that an entry's
// need words name, in ascending order: each lane holds the need word of
// one group of a round of 32 groups. All lanes call next(); it returns
// -1 past the last.
struct NeedItems {
  const unsigned* ne;
  int groups, lane;
  int round = -32, q = 0;
  unsigned word = 0, full = 0, pending = 0;
  __device__ __forceinline__ int next() {
    while (pending == 0) {
      while (full == 0) {
        round += 32;
        if (round >= groups) return -1;
        word = round + lane < groups ? ne[round + lane] : 0u;
        full = __ballot_sync(kFull, word != 0);
      }
      const int i = __ffs(full) - 1;
      full &= full - 1;
      pending = __shfl_sync(kFull, word, i);
      q = round + i;
    }
    const int u = q * 32 + __ffs(pending) - 1;
    pending &= pending - 1;
    return u;
  }
};

// Threads of entries_need_kernel: one warp a group
constexpr int kNeedThreads = 256;

namespace {

// need[e * groups + q], bit i: item u = 32 q + i of entry e (odd block g =
// u / chunks, chunk u % chunks) lies within reach of the entry's box: the
// chunk box (boxes, as subcell_boxes_kernel writes them with parts of 32
// slots) within max(the entry's reach, the chunk's largest h), dx taken
// as the sums take it (Shift::kPair with the shift (1 - 2g) Lf, Shift::kNone
// in absolute mode); 0 for a switched-off entry. One warp a (entry,
// group).
template <class Rows, bool kAbs>
__global__ void __launch_bounds__(kNeedThreads)
    entries_need_kernel(const float* __restrict__ tgt,
                        const float* __restrict__ h,
                        const int* __restrict__ entry_blk,
                        const float* __restrict__ boxes,
                        unsigned* __restrict__ need, int nb, int chunks,
                        int groups, int k_entries, float lf) {
  constexpr Shift kShift = kAbs ? Shift::kNone : Shift::kPair;
  const int w = blockIdx.x * (kNeedThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= k_entries * groups) return;   // the whole warp
  const int e = w / groups, u = (w % groups) * 32 + lane;
  const int b = entry_blk[e];
  bool near = false;
  if (b >= 0) {
    const float* tg = Rows::rows(tgt, e);
    const Box tbox = Rows::box(tg, Rows::hs(tg, h, e), lane);
    if (u < 8 * chunks) {
      const OddBlocks ob = odd_blocks(b, nb, lf);
      const int g = u / chunks;
      const float* q =
          boxes +
          (static_cast<size_t>(ob.block<kAbs>(g)) * chunks + u % chunks) * 8;
      const float slo[3] = {q[0], q[1], q[2]}, shi[3] = {q[3], q[4], q[5]};
      float sh[3];
      ob.shifts<kAbs>(g, sh);
      near = near_boxes<kShift>(tbox, slo, shi, q[6], sh);
    }
  }
  const unsigned m = __ballot_sync(kFull, near);
  if (lane == 0) need[w] = m;
}

// entries_need_kernel over k_entries x groups warps, on st
template <class Rows, bool kAbs>
void launch_need(const float* tgt, const float* h, const int* entry_blk,
                 const float* boxes, unsigned* need, int nb, int chunks,
                 int groups, int k_entries, float lf, cudaStream_t st) {
  constexpr int per_block = kNeedThreads / 32;
  entries_need_kernel<Rows, kAbs>
      <<<(k_entries * groups + per_block - 1) / per_block, kNeedThreads, 0,
         st>>>(tgt, h, entry_blk, boxes, need, nb, chunks, groups, k_entries,
               lf);
}

}  // namespace

// A warp's own double-buffered staging: 4-byte cp.async copies, committed
// per chunk, waiting for all but the newest group.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace glt
