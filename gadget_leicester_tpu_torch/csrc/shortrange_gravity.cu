// Kernel A: TreePM short-range gravity over cell tiles.
//
// Replaces gadget_leicester_tpu/ops/pallas_cells.py ::
// shortrange_gravity_pallas_dma9 (kernel body _make_kernel_dma9), in its
// cell-relative mode. Plain PyTorch twin: ops/cells.py ::
// shortrange_gravity_tiles_plain.
//
// What it computes. soa is the [C, 8, cap] pack of ops/cells.py ::
// pack_cells_soa (rows x, y, z relative to the cell centre, m, soft, 1,
// 1/soft, 0; parked slots at -7 cells with m = 0). For every target slot
// of a cell whose flag is set it sums, over the 27 neighbour cells,
//   -m_j * g(r) * erfc_trunc(r / (2 asmth)) * dx    for 0 < r < rcut,
// with source coordinates shifted by the stencil offset times the cell
// edge. The shift is exact for stale in-margin assignments because
// relative coordinates are wrap-invariant. A cell whose flag is 0 writes
// zeros. out is [C, 3, cap] (ax, ay, az, without the factor G).
//
// What bounds it on the card. Pairs: at the 2x128^3 configuration
// C = 34^3 and cap = 128, so one sweep evaluates 27 * 128 * 128 pairs per
// cell, about 1.7e10, at some 40 float32 operations per pair inside rcut.
// It is bound by the FP32 pipes and by issue, not by memory: each cell
// reads 27 source tiles of 3 KB.
//
// What the design does about it. One thread block per target cell, one
// thread per target slot; each source tile is staged once in shared memory
// and read by every thread, so device memory traffic is 27 tiles per
// block. Parked source slots (m = 0) are skipped with a branch that is
// uniform across the block, and pairs beyond rcut leave before the
// polynomial. No wgmma, TMA or tuning yet.

#include "glt_common.cuh"

namespace {

__global__ void shortrange_gravity_kernel(const float* __restrict__ soa,
                                          const int* __restrict__ flags,
                                          float* __restrict__ out, int n,
                                          int cap, float edge,
                                          float half_inv_asmth, float rcut2) {
  const int c = blockIdx.x;
  float* o = out + static_cast<size_t>(c) * 3 * cap;
  if (flags[c] == 0) {
    for (int t = threadIdx.x; t < cap; t += blockDim.x) {
      o[t] = 0.f;
      o[cap + t] = 0.f;
      o[2 * cap + t] = 0.f;
    }
    return;
  }
  __shared__ float s_x[glt::kTile], s_y[glt::kTile], s_z[glt::kTile];
  __shared__ float s_m[glt::kTile], s_h[glt::kTile], s_hinv[glt::kTile];

  const int cx = c / (n * n), cy = (c / n) % n, cz = c % n;
  const float* tile = soa + static_cast<size_t>(c) * 8 * cap;

  for (int t0 = 0; t0 < cap; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool live = t < cap && tile[5 * cap + t] > 0.f;
    float tx = 0.f, ty = 0.f, tz = 0.f, th = 0.f, thinv = 0.f;
    if (live) {
      tx = tile[t];
      ty = tile[cap + t];
      tz = tile[2 * cap + t];
      th = tile[4 * cap + t];
      thinv = tile[6 * cap + t];
    }
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int j = 0; j < 27; ++j) {
      const int ox = j / 9 - 1, oy = (j / 3) % 3 - 1, oz = j % 3 - 1;
      const int src = (glt::wrap(cx + ox, n) * n + glt::wrap(cy + oy, n)) * n +
                      glt::wrap(cz + oz, n);
      const float* s = soa + static_cast<size_t>(src) * 8 * cap;
      const float shx = static_cast<float>(ox) * edge;
      const float shy = static_cast<float>(oy) * edge;
      const float shz = static_cast<float>(oz) * edge;
      for (int s0 = 0; s0 < cap; s0 += glt::kTile) {
        const int len = min(glt::kTile, cap - s0);
        __syncthreads();
        for (int k = threadIdx.x; k < len; k += blockDim.x) {
          s_x[k] = s[s0 + k] + shx;
          s_y[k] = s[cap + s0 + k] + shy;
          s_z[k] = s[2 * cap + s0 + k] + shz;
          s_m[k] = s[3 * cap + s0 + k];
          s_h[k] = s[4 * cap + s0 + k];
          s_hinv[k] = s[6 * cap + s0 + k];
        }
        __syncthreads();
        if (!live) continue;
        for (int k = 0; k < len; ++k) {
          const float m = s_m[k];
          if (m == 0.f) continue;  // parked slot: uniform across the block
          const float dx = tx - s_x[k];
          const float dy = ty - s_y[k];
          const float dz = tz - s_z[k];
          const float r2 = dx * dx + dy * dy + dz * dz;
          if (!(r2 < rcut2 && r2 > 0.f)) continue;
          const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
          const float r = r2 * rinv;
          const float hh = fmaxf(th, s_h[k]);
          const float hhinv = fminf(thinv, s_hinv[k]);
          float fac = glt::grav_fac_nodiv(r, rinv, hh, hhinv);
          fac = fac * glt::trunc_p10(fminf(r * half_inv_asmth, 2.25f));
          const float w = m * fac;
          ax -= w * dx;
          ay -= w * dy;
          az -= w * dz;
        }
      }
    }
    if (t < cap) {
      o[t] = ax;
      o[cap + t] = ay;
      o[2 * cap + t] = az;
    }
  }
}

}  // namespace

extern "C" int glt_shortrange_gravity(const float* soa, const int* flags,
                                      float* out, int n_cells, int cap,
                                      float edge, float half_inv_asmth,
                                      float rcut2, void* stream) {
  const int c = n_cells * n_cells * n_cells;
  const int threads = cap < 128 ? ((cap + 31) / 32) * 32 : 128;
  shortrange_gravity_kernel<<<c, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      soa, flags, out, n_cells, cap, edge, half_inv_asmth, rcut2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* glt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
