// Kernel B: cloud-in-cell mass deposit onto the periodic PM mesh.
//
// Replaces gadget_leicester_tpu/ops/pm_tiles.py :: pm_deposit_tiles
// (kernel body _make_deposit_kernel). Plain PyTorch twin:
// ops/pm_tiles.py :: pm_deposit_tiles_plain.
//
// What it computes. It reads the short-range pack ([C, 8, cap], cell-
// relative coordinates, mass in row 3, 1 in row 5 for packed slots, parked
// slots with m = 0) and adds, for each packed slot, m * wx * wy * wz to the
// 8 mesh cells around u = rel * n_pm / box + cell centre, wrapped
// periodically. Only alive particles are packed, so the mesh holds the
// mass of alive particles only, as pm_forces_periodic requires.
//
// What bounds it on the card. 8 float atomics per particle into a
// 192^3 x 4 B = 28 MB mesh, which fits in the 50 MB L2: it is bound by
// atomic throughput in L2, with about 34 M atomics per deposit at
// 2x128^3.
//
// What the design does about it. One thread per slot, so consecutive
// threads hold particles of one cell and their atomics hit neighbouring
// mesh cells in L2. The TPU kernel's padded windows, colour-class order and
// one-hot matmuls existed to avoid scatters on a machine without atomics;
// atomicAdd replaces all of them, and the periodic wrap replaces the fold
// of the pads. Atomics make the order of each sum vary from run to run.

#include "glt_common.cuh"

namespace {

__global__ void pm_deposit_kernel(const float* __restrict__ soa,
                                  float* __restrict__ mesh, int n_cells,
                                  int cap, int n_pm, float scale,
                                  float edge_pm) {
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  const long long total =
      static_cast<long long>(n_cells) * n_cells * n_cells * cap;
  if (slot >= total) return;
  const int c = static_cast<int>(slot / cap);
  const int s = static_cast<int>(slot % cap);
  const float* t = soa + static_cast<size_t>(c) * 8 * cap;
  const float m = t[3 * cap + s];
  if (m == 0.f) return;  // parked slot
  const float valid = t[5 * cap + s];
  const int cx = c / (n_cells * n_cells);
  const int cy = (c / n_cells) % n_cells;
  const int cz = c % n_cells;
  const float ux = t[s] * scale + (static_cast<float>(cx) + 0.5f) * edge_pm;
  const float uy = t[cap + s] * scale +
                   (static_cast<float>(cy) + 0.5f) * edge_pm;
  const float uz = t[2 * cap + s] * scale +
                   (static_cast<float>(cz) + 0.5f) * edge_pm;
  const float fx0 = floorf(ux), fy0 = floorf(uy), fz0 = floorf(uz);
  const float fx = ux - fx0, fy = uy - fy0, fz = uz - fz0;
  const int ix = glt::wrap(static_cast<int>(fx0), n_pm);
  const int iy = glt::wrap(static_cast<int>(fy0), n_pm);
  const int iz = glt::wrap(static_cast<int>(fz0), n_pm);
  const int jx[2] = {ix, ix + 1 == n_pm ? 0 : ix + 1};
  const int jy[2] = {iy, iy + 1 == n_pm ? 0 : iy + 1};
  const int jz[2] = {iz, iz + 1 == n_pm ? 0 : iz + 1};
  const float wx[2] = {1.0f - fx, fx};
  const float wy[2] = {1.0f - fy, fy};
  const float wz[2] = {m * (1.0f - fz), m * fz};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wxy = wx[a] * wy[b] * valid;
      const size_t row =
          (static_cast<size_t>(jx[a]) * n_pm + jy[b]) * n_pm;
      atomicAdd(mesh + row + jz[0], wxy * wz[0]);
      atomicAdd(mesh + row + jz[1], wxy * wz[1]);
    }
  }
}

}  // namespace

extern "C" int glt_pm_deposit(const float* soa, float* mesh, int n_cells,
                              int cap, int n_pm, float scale, float edge_pm,
                              void* stream) {
  const long long total =
      static_cast<long long>(n_cells) * n_cells * n_cells * cap;
  const int threads = 256;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  pm_deposit_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      soa, mesh, n_cells, cap, n_pm, scale, edge_pm);
  return static_cast<int>(cudaGetLastError());
}
