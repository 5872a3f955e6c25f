// Kernel K: SPH hydro force sums over the 27-cell stencil of a coarse cell
// list.
//
// Replaces gadget_leicester_tpu/ops/pallas_cells.py :: hydro_sums_pallas
// (kernel body _make_hydro_kernel).
// Plain PyTorch twin: ops/sph_cells.py :: hydro_sums_cells_plain.
//
// What it computes. soa16 is the [C, 16, cap] pack of ops/sph_cells.py ::
// pack_hydro_cells: rows 0-7 x, y, z ABSOLUTE (each the periodic image
// nearest its cell's centre), m, vx, vy, vz, h; rows 8-12
// rho, P/rho^2 f, c_sound, Balsara, valid (the TPU kernel's soa_a and
// soa_b in one tensor; targets and sources come from the same pack). For
// each live target slot of a cell c, over the 27 cells around c, each pair
// with 0 < r < max(h_i, h_j) and a valid source adds the entropy-form pair
// force with Monaghan-Balsara viscosity, the Balsara limiter, the
// Hubble-flow term and fac_mu [G2: hydra.c :: hydro_evaluate()];
// out[C, 5, cap] = ax, ay, az, raw dA/dt, max signal velocity (from 0, over
// the masked pairs only). The caller applies the (gamma-1) / (a^2 H
// rho^(gamma-1)) factor. Wrap and vacuum edges as in sph_cells_density.cu.
//
// The self-pair is excluded by r2 > 0: the coordinates are absolute and
// the centre cell's shift is 0, so a target meets its own slot at r2 == 0
// bit for bit. (Kernels D and G, on block-relative coordinates, compare
// int32 particle indices instead.) Every mask is a branch, never a
// product: 1 / rho_ij reaches 1e37 where both densities are 0.
//
// What bounds it on the card. Pairs, as sph_cells_density.cu (5.4e9 at
// 2x128^3), about 86 float32 operations for each inside the support;
// bound by the FP32 pipes and by divergence at the support edge.
//
// What the design does about it. Kernel D's: one thread block per cell,
// one thread per target slot, each 13-row neighbour tile staged once in
// shared memory in chunks of kTile slots, shift added while staging.
// Invalid sources are skipped with a branch uniform across the block; a
// warp whose targets are all parked skips the pair loop; a cell with no
// live target skips its stencil. The pair arithmetic is spelt out inline,
// as in kernel D (a shared pair function cost D 8 registers).
// hubble_a2_flow and fac_mu are read from device memory, so the launch
// needs no host sync.

#include "glt_common.cuh"

namespace {

__global__ void sph_cells_hydro_kernel(const float* __restrict__ soa16,
                                       const float* __restrict__ params,
                                       float* __restrict__ out, int n, int cap,
                                       float box, int periodic,
                                       float half_visc) {
  __shared__ float s_x[glt::kTile], s_y[glt::kTile], s_z[glt::kTile];
  __shared__ float s_m[glt::kTile], s_h[glt::kTile];
  __shared__ float s_vx[glt::kTile], s_vy[glt::kTile], s_vz[glt::kTile];
  __shared__ float s_rho[glt::kTile], s_por[glt::kTile], s_c[glt::kTile];
  __shared__ float s_bal[glt::kTile], s_valid[glt::kTile];

  const int c = blockIdx.x;
  float* o = out + static_cast<size_t>(c) * 5 * cap;
  const float hubble_a2_flow = params[0];
  const float fac_mu = params[1];
  const int cx = c / (n * n), cy = (c / n) % n, cz = c % n;
  const float* tile = soa16 + static_cast<size_t>(c) * 16 * cap;

  for (int t0 = 0; t0 < cap; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool slot = t < cap;
    float tx = 0.f, ty = 0.f, tz = 0.f, tvx = 0.f, tvy = 0.f, tvz = 0.f;
    float ht = 0.f, trho = 0.f, tpor = 0.f, tc = 0.f, tbal = 0.f;
    bool live = false;
    if (slot) {
      live = tile[12 * cap + t] > 0.f;
      tx = tile[t];
      ty = tile[cap + t];
      tz = tile[2 * cap + t];
      tvx = tile[4 * cap + t];
      tvy = tile[5 * cap + t];
      tvz = tile[6 * cap + t];
      ht = tile[7 * cap + t];
      trho = tile[8 * cap + t];
      tpor = tile[9 * cap + t];
      tc = tile[10 * cap + t];
      tbal = tile[11 * cap + t];
    }
    const float hinv_t = glt::inv_or_zero(ht);
    float ax = 0.f, ay = 0.f, az = 0.f, dte = 0.f, msv = 0.f;
    // the barrier also closes the previous chunk's reads of the tiles
    const bool any_live = __syncthreads_or(live) != 0;
    for (int j = 0; any_live && j < 27; ++j) {
      int nx = cx + j / 9 - 1, ny = cy + (j / 3) % 3 - 1, nz = cz + j % 3 - 1;
      float shx = 0.f, shy = 0.f, shz = 0.f;
      if (periodic) {
        if (nx < 0) { nx += n; shx = -box; } else if (nx >= n) { nx -= n; shx = box; }
        if (ny < 0) { ny += n; shy = -box; } else if (ny >= n) { ny -= n; shy = box; }
        if (nz < 0) { nz += n; shz = -box; } else if (nz >= n) { nz -= n; shz = box; }
      } else if (nx < 0 || nx >= n || ny < 0 || ny >= n || nz < 0 ||
                 nz >= n) {
        continue;  // beyond the edge of a vacuum grid: uniform in the block
      }
      const float* s =
          soa16 + static_cast<size_t>((nx * n + ny) * n + nz) * 16 * cap;
      for (int s0 = 0; s0 < cap; s0 += glt::kTile) {
        const int len = min(glt::kTile, cap - s0);
        __syncthreads();
        for (int k = threadIdx.x; k < len; k += blockDim.x) {
          const int q = s0 + k;
          s_x[k] = s[q] + shx;
          s_y[k] = s[cap + q] + shy;
          s_z[k] = s[2 * cap + q] + shz;
          s_m[k] = s[3 * cap + q];
          s_vx[k] = s[4 * cap + q];
          s_vy[k] = s[5 * cap + q];
          s_vz[k] = s[6 * cap + q];
          s_h[k] = s[7 * cap + q];
          s_rho[k] = s[8 * cap + q];
          s_por[k] = s[9 * cap + q];
          s_c[k] = s[10 * cap + q];
          s_bal[k] = s[11 * cap + q];
          s_valid[k] = s[12 * cap + q];
        }
        __syncthreads();
        if (!live) continue;
        for (int k = 0; k < len; ++k) {
          if (!(s_valid[k] > 0.f)) continue;  // uniform across the block
          const float dx = tx - s_x[k];
          const float dy = ty - s_y[k];
          const float dz = tz - s_z[k];
          const float r2 = dx * dx + dy * dy + dz * dz;
          const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
          const float r = r2 * rinv;
          const float hs = s_h[k];
          if (!(r < fmaxf(ht, hs)) || !(r2 > 0.f)) continue;
          const float dwk_i = glt::w4_dw_dr(r, hinv_t);
          const float dwk_j = glt::w4_dw_dr(r, glt::inv_or_zero(hs));
          const float dvx = tvx - s_vx[k];
          const float dvy = tvy - s_vy[k];
          const float dvz = tvz - s_vz[k];
          const float rr = r * r;
          const float vdotr2 =
              dvx * dx + dvy * dy + dvz * dz + hubble_a2_flow * rr;
          const bool approaching = vdotr2 < 0.f;
          const float mu = fac_mu * vdotr2 * rinv;
          const float vsig = tc + s_c[k] - 3.0f * (approaching ? mu : 0.f);
          const float rho_ij = 0.5f * (trho + s_rho[k]);
          const float rs = rsqrtf(fmaxf(rho_ij, 1e-37f));
          const float rho_ij_inv = rs * rs;
          const float f_ij = 0.5f * (tbal + s_bal[k]);
          const float visc =
              approaching ? half_visc * vsig * (-mu) * rho_ij_inv * f_ij
                          : 0.f;
          const float m = s_m[k];
          const float hfc_visc = 0.5f * m * visc * (dwk_i + dwk_j) * rinv;
          const float hfc =
              hfc_visc + m * (tpor * dwk_i + s_por[k] * dwk_j) * rinv;
          ax -= hfc * dx;
          ay -= hfc * dy;
          az -= hfc * dz;
          dte += 0.5f * (hfc_visc * vdotr2);
          msv = fmaxf(msv, vsig);
        }
      }
    }
    if (slot) {
      o[t] = ax;
      o[cap + t] = ay;
      o[2 * cap + t] = az;
      o[3 * cap + t] = dte;
      o[4 * cap + t] = msv;
    }
  }
}

}  // namespace

extern "C" int glt_sph_cells_hydro(const float* soa16, const float* params,
                                   float* out, int n, int cap, float box,
                                   int periodic, float half_visc,
                                   void* stream) {
  const int blocks = n * n * n;
  const int threads = cap < 256 ? ((cap + 31) / 32) * 32 : 256;
  sph_cells_hydro_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      soa16, params, out, n, cap, box, periodic, half_visc);
  return static_cast<int>(cudaGetLastError());
}
