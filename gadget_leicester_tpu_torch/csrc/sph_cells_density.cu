// Kernels I and J: SPH density sums over the 27-cell stencil of a coarse
// cell list.
//
// Replaces gadget_leicester_tpu/ops/pallas_cells.py ::
// density_sums_pallas_dma (kernel body _make_density_kernel_dma) and its
// grid twin density_sums_pallas (_make_density_kernel): two TPU schedules
// of one function, one kernel here.
// Plain PyTorch twin: ops/sph_cells.py :: density_sums_cells_plain.
//
// What it computes. soa is the [C, 8, cap] pack of ops/sph_cells.py ::
// pack_sph_soa (rows x, y, z ABSOLUTE, each the periodic image nearest its
// cell's centre, so every slot of a tile lies in that tile's cell; m, vx,
// vy, vz, h; parked slots with m = 0), h the [C, cap] smoothing length of
// each target slot. For each
// live target slot of a cell c whose flag is set, over the 27 cells around
// c:
//   rho = sum m W(r, h_i),  drho/dh = sum m dW/dh,
//   div = -sum m dW/dr / r (dv . dx),  rot = sum m dW/dr / r (dv x dx).
// On a periodic grid a neighbour tile across the wrap is shifted by -+box
// as a whole (n_cells >= 3, so this equals the per-pair minimum image); on
// a vacuum grid nothing is shifted and the stencil cells beyond the edge
// add nothing. The self-pair is included: the target meets its own slot in
// the centre cell (shift 0) at r = 0 exactly, where it adds m W(0, h) and
// dW/dr = 0. The stencil is complete because the caller caps h at the cell
// edge. A cell whose flag is 0 and a parked target write zeros. out is
// [C, 6, cap].
//
// What bounds it on the card. Pairs: at 2x128^3 gas, C = 28^3 cells with
// ~96 of cap = 128 slots live, 27 * 96 * 96 pairs per cell, 5.4e9 per
// sweep, of which the few percent inside the support pay the whole pair
// arithmetic; the Newton loop runs a few sweeps. Bound by the FP32 pipes.
//
// What the design does about it. One thread block per cell, one thread per
// target slot; each neighbour tile is staged once in shared memory (7
// rows, in chunks of kTile slots so the block's shared memory does not
// grow with cap) with its shift already added, and read by every thread.
// Parked sources are skipped with a branch uniform across the block; a
// warp whose targets are all parked skips the pair loop; a cell with no
// live target skips its stencil. The TPU kernels' double-buffered DMA of
// whole tiles, their [cap, cap] pair matrices and the (C, 27) grid are not
// carried over.

#include "glt_common.cuh"

namespace {

__global__ void sph_cells_density_kernel(const float* __restrict__ soa,
                                         const float* __restrict__ h,
                                         const int* __restrict__ flags,
                                         float* __restrict__ out, int n,
                                         int cap, float box, int periodic) {
  const int c = blockIdx.x;
  float* o = out + static_cast<size_t>(c) * 6 * cap;
  if (flags[c] == 0) {
    for (int t = threadIdx.x; t < 6 * cap; t += blockDim.x) o[t] = 0.f;
    return;
  }
  __shared__ float s_x[glt::kTile], s_y[glt::kTile], s_z[glt::kTile];
  __shared__ float s_m[glt::kTile];
  __shared__ float s_vx[glt::kTile], s_vy[glt::kTile], s_vz[glt::kTile];

  const int cx = c / (n * n), cy = (c / n) % n, cz = c % n;
  const float* tile = soa + static_cast<size_t>(c) * 8 * cap;

  for (int t0 = 0; t0 < cap; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool slot = t < cap;
    float tx = 0.f, ty = 0.f, tz = 0.f, tvx = 0.f, tvy = 0.f, tvz = 0.f;
    float hinv = 0.f;
    bool live = false;
    if (slot) {
      live = tile[3 * cap + t] > 0.f;
      tx = tile[t];
      ty = tile[cap + t];
      tz = tile[2 * cap + t];
      tvx = tile[4 * cap + t];
      tvy = tile[5 * cap + t];
      tvz = tile[6 * cap + t];
      hinv = glt::inv_or_zero(h[static_cast<size_t>(c) * cap + t]);
    }
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
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
      const float* s = soa + static_cast<size_t>((nx * n + ny) * n + nz) * 8 * cap;
      for (int s0 = 0; s0 < cap; s0 += glt::kTile) {
        const int len = min(glt::kTile, cap - s0);
        __syncthreads();
        for (int k = threadIdx.x; k < len; k += blockDim.x) {
          s_x[k] = s[s0 + k] + shx;
          s_y[k] = s[cap + s0 + k] + shy;
          s_z[k] = s[2 * cap + s0 + k] + shz;
          s_m[k] = s[3 * cap + s0 + k];
          s_vx[k] = s[4 * cap + s0 + k];
          s_vy[k] = s[5 * cap + s0 + k];
          s_vz[k] = s[6 * cap + s0 + k];
        }
        __syncthreads();
        if (!live) continue;
        for (int k = 0; k < len; ++k) {
          const float m = s_m[k];
          if (m == 0.f) continue;  // parked slot: uniform across the block
          glt::density_pair(tx - s_x[k], ty - s_y[k], tz - s_z[k],
                            tvx - s_vx[k], tvy - s_vy[k], tvz - s_vz[k], m,
                            hinv, acc);
        }
      }
    }
    if (slot) {
#pragma unroll
      for (int r = 0; r < 6; ++r) o[r * cap + t] = acc[r];
    }
  }
}

}  // namespace

extern "C" int glt_sph_cells_density(const float* soa, const float* h,
                                     const int* flags, float* out, int n,
                                     int cap, float box, int periodic,
                                     void* stream) {
  const int blocks = n * n * n;
  const int threads = cap < 256 ? ((cap + 31) / 32) * 32 : 256;
  sph_cells_density_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      soa, h, flags, out, n, cap, box, periodic);
  return static_cast<int>(cudaGetLastError());
}
