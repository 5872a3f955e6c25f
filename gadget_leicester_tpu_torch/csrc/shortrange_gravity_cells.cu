// Kernel M: short-range gravity per cell over its 27 neighbours, in
// absolute coordinates with the per-pair minimum image.
//
// Replaces gadget_leicester_tpu/ops/pallas_cells.py ::
// shortrange_gravity_pallas (kernel body _make_kernel). Plain PyTorch twin:
// ops/gravity_short.py :: shortrange_gravity_cells_plain.
//
// What it computes. soa is the [C, 8, cap] ABSOLUTE pack of ops/cells.py ::
// pack_cells_abs (rows x, y, z as the particles hold them, m, soft, 1,
// 1/soft, 0; parked slots with m = 0). For every packed target slot it
// sums, over the 27 cells around its cell,
//   -m_j * g(r, max(h_i, h_j)) * trunc(r / (2 asmth)) * dx
// over the pairs with 0 < r < rcut, where on a periodic grid each component
// of dx is reduced PER PAIR to its minimum image dx - box * round(dx / box).
// On a clamped (vacuum) grid nothing is reduced and a stencil cell beyond
// the grid adds nothing. half_inv_asmth == 0 switches the truncation off
// (plain softened gravity). The self-pair leaves by r > 0: target and
// source are the same pack slot, so dx is 0 bit for bit before and after
// the minimum image. out is [C, 3, cap] (ax, ay, az, without the factor G).
//
// Why the minimum image stays per pair. A whole-tile +-box shift (kernels
// I-K) needs every slot of a tile to lie inside that tile's cell; a
// particle whose float32 coordinate equals the box is filed in cell 0 a
// box away from its neighbours, and a tile shift loses them. The per-pair
// reduction is immune to where a coordinate was wrapped, at a multiply, a
// round and an FMA per axis and pair.
//
// What bounds it on the card. As kernel A: 27 * cap * cap pair tests per
// cell, bound by the FP32 pipes, not by memory (27 tiles of 3 KB
// per block). The minimum image and the exact r < rcut test (an rsqrt
// before the cut, where A compares r^2) make each pair dearer than A's.
//
// What the design does about it. Kernel A's shape on the absolute pack: one
// thread block per target cell, one thread per target slot, each neighbour
// tile staged once in shared memory in chunks of kTile slots. A cheap
// r^2 < rcut^2 (1 + 1e-6) test, clamped to the largest float so that
// rcut = 1e30 does not square to inf, comes before the rsqrt; the exact
// r < rcut of the reference after it. The TPU kernel's grid of (cell, 27)
// steps with one BlockSpec per neighbour is not carried over.

#include <cfloat>

#include "glt_common.cuh"

namespace {

__global__ void shortrange_gravity_cells_kernel(
    const float* __restrict__ soa, float* __restrict__ out, int n, int cap,
    float box, int periodic, float half_inv_asmth, float rcut, float rcut2_up) {
  const int c = blockIdx.x;
  float* o = out + static_cast<size_t>(c) * 3 * cap;
  __shared__ float s_x[glt::kTile], s_y[glt::kTile], s_z[glt::kTile];
  __shared__ float s_m[glt::kTile], s_h[glt::kTile], s_hinv[glt::kTile];

  const int cx = c / (n * n), cy = (c / n) % n, cz = c % n;
  const float* tile = soa + static_cast<size_t>(c) * 8 * cap;
  const float inv_box = periodic ? 1.0f / box : 0.f;

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
    // the barrier also closes the previous chunk's reads of the tiles
    const bool any_live = __syncthreads_or(live) != 0;
    for (int j = 0; any_live && j < 27; ++j) {
      int nx = cx + j / 9 - 1, ny = cy + (j / 3) % 3 - 1, nz = cz + j % 3 - 1;
      if (periodic) {
        nx = glt::wrap(nx, n);
        ny = glt::wrap(ny, n);
        nz = glt::wrap(nz, n);
      } else if (nx < 0 || nx >= n || ny < 0 || ny >= n || nz < 0 ||
                 nz >= n) {
        continue;  // beyond the edge of a clamped grid: uniform in the block
      }
      const float* s = soa + static_cast<size_t>((nx * n + ny) * n + nz) * 8 * cap;
      for (int s0 = 0; s0 < cap; s0 += glt::kTile) {
        const int len = min(glt::kTile, cap - s0);
        __syncthreads();
        for (int k = threadIdx.x; k < len; k += blockDim.x) {
          s_x[k] = s[s0 + k];
          s_y[k] = s[cap + s0 + k];
          s_z[k] = s[2 * cap + s0 + k];
          s_m[k] = s[3 * cap + s0 + k];
          s_h[k] = s[4 * cap + s0 + k];
          s_hinv[k] = s[6 * cap + s0 + k];
        }
        __syncthreads();
        if (!live) continue;
        for (int k = 0; k < len; ++k) {
          const float m = s_m[k];
          if (m == 0.f) continue;  // parked slot: uniform across the block
          float dx = tx - s_x[k];
          float dy = ty - s_y[k];
          float dz = tz - s_z[k];
          if (periodic) {
            dx = dx - box * rintf(dx * inv_box);
            dy = dy - box * rintf(dy * inv_box);
            dz = dz - box * rintf(dz * inv_box);
          }
          const float r2 = dx * dx + dy * dy + dz * dz;
          if (!(r2 < rcut2_up && r2 > 0.f)) continue;
          const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
          const float r = r2 * rinv;
          if (!(r < rcut && r > 0.f)) continue;
          const float hh = fmaxf(th, s_h[k]);
          const float hhinv = fminf(thinv, s_hinv[k]);
          float fac = glt::grav_fac_nodiv(r, rinv, hh, hhinv);
          if (half_inv_asmth > 0.f)
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

extern "C" int glt_shortrange_gravity_cells(const float* soa, float* out,
                                            int n_cells, int cap, float box,
                                            int periodic, float half_inv_asmth,
                                            float rcut, void* stream) {
  const int c = n_cells * n_cells * n_cells;
  const int threads = cap < 128 ? ((cap + 31) / 32) * 32 : 128;
  const double up = static_cast<double>(rcut) * rcut * (1.0 + 1e-6);
  const float rcut2_up = up < FLT_MAX ? static_cast<float>(up) : FLT_MAX;
  shortrange_gravity_cells_kernel<<<c, threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      soa, out, n_cells, cap, box, periodic, half_inv_asmth, rcut, rcut2_up);
  return static_cast<int>(cudaGetLastError());
}
