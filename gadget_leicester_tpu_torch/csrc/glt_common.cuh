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

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

}  // namespace glt
