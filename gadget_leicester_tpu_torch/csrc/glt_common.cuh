// Shared device helpers of the hand-written kernels: the W4 SPH spline,
// the softened gravity factor and the erfc truncation polynomial. Each
// function spells out, in the same operation order, the float32 arithmetic
// of its plain PyTorch twin (ops/sph_kernels.py, ops/softening.py,
// ops/cells.py), so a kernel and its plain version differ only in the
// order of the sums.
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

}  // namespace glt
