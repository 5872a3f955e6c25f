// Kernel H: TreePM short-range gravity and potential over cell tiles.
//
// Replaces gadget_leicester_tpu/ops/pallas_cells.py ::
// shortrange_gravity_pallas_dma (kernel body _make_kernel_dma, with
// with_potential), whose one caller is models/forces.py ::
// compute_potential. Plain PyTorch twin: ops/gravity_short.py ::
// shortrange_potential_tiles_plain.
//
// What it computes. soa is the [C, 8, cap] cell-relative pack of
// ops/cells.py :: pack_cells_soa on a fresh cell list (rows x, y, z
// relative to the cell centre, m, soft, 1, 1/soft, 0; parked slots at -7
// cells with m = 0). For every target slot of a cell whose flag is set it
// sums, over the 27 neighbour cells and for 0 < r2 < rcut^2,
//   ax -= m_j g(r) trunc(r / (2 asmth)) dx     (and y, z)
//   pot += m_j grav_pot(r) erfc(r / (2 asmth))
// with source coordinates shifted by the stencil offset times the cell
// edge. The TPU kernel works in absolute coordinates with a wrap shift per
// tile; the relative pack computes the same function, and a target meets
// its own slot at r2 == 0 exactly (same pack value, centre shift 0), so
// the self-pair, whose softened potential -2.8/h would dominate, adds
// nothing. A cell whose flag is 0 writes zeros. out is [C, 4, cap] (ax,
// ay, az, pot, without the factor G).
//
// What bounds it on the card. At 2x128^3 (C = 34^3, cap = 128, about 107
// particles per cell) one call tests 1.2e10 stencil pairs, 15% of them
// inside rcut. Every pair costs the distance test, 10 float32 operations
// (FMA = 2, rsqrt = 1); a pair inside rcut in the unsoftened branch 77 in
// all: the force factor and erfc-truncation polynomial 40 more, the
// potential factor and its erfc polynomial 27. It is bound by the FP32
// pipes and the instruction rate; the bytes (27 source tiles of 3 KB per
// cell, mostly from L2) are far below the memory rate.
//
// What the design does about it. Kernel A's: one thread block per target
// cell, one thread per target slot keeping its four sums in registers;
// each source tile is staged once in shared memory and read by every
// thread; parked source slots (m = 0) are skipped by a branch uniform
// across the block, and pairs beyond rcut leave before the polynomials,
// which share one x. Its own source, so A's registers stay as they were.
// No wgmma, TMA or tuning yet.

#include "glt_common.cuh"

namespace {

__global__ void shortrange_potential_kernel(const float* __restrict__ soa,
                                            const int* __restrict__ flags,
                                            float* __restrict__ out, int n,
                                            int cap, float edge,
                                            float half_inv_asmth,
                                            float rcut2) {
  const int c = blockIdx.x;
  float* o = out + static_cast<size_t>(c) * 4 * cap;
  if (flags[c] == 0) {
    for (int t = threadIdx.x; t < cap; t += blockDim.x) {
      o[t] = 0.f;
      o[cap + t] = 0.f;
      o[2 * cap + t] = 0.f;
      o[3 * cap + t] = 0.f;
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
    float ax = 0.f, ay = 0.f, az = 0.f, pot = 0.f;
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
          glt::gravity_potential_pair(tx, ty, tz, th, thinv, s_x[k], s_y[k],
                                      s_z[k], m, s_h[k], s_hinv[k],
                                      half_inv_asmth, rcut2, ax, ay, az, pot);
        }
      }
    }
    if (t < cap) {
      o[t] = ax;
      o[cap + t] = ay;
      o[2 * cap + t] = az;
      o[3 * cap + t] = pot;
    }
  }
}

}  // namespace

extern "C" int glt_shortrange_potential(const float* soa, const int* flags,
                                        float* out, int n_cells, int cap,
                                        float edge, float half_inv_asmth,
                                        float rcut2, void* stream) {
  const int c = n_cells * n_cells * n_cells;
  const int threads = cap < 128 ? ((cap + 31) / 32) * 32 : 128;
  shortrange_potential_kernel<<<c, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      soa, flags, out, n_cells, cap, edge, half_inv_asmth, rcut2);
  return static_cast<int>(cudaGetLastError());
}
