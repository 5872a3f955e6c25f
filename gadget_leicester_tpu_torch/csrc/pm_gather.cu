// Kernel L: cloud-in-cell interpolation of a K-component PM mesh field to
// the particles of each short-range cell, through one mesh window per cell.
//
// Replaces gadget_leicester_tpu/ops/pm_tiles.py :: pm_gather_tiles (kernel
// body _make_gather_col_kernel). Plain PyTorch twin: ops/pm_tiles.py ::
// pm_gather_windows_plain.
//
// What it computes. soa is the [C, 8, cap] pack of ops/cells.py ::
// pack_cells_soa (cell-relative coordinates in rows 0-2, 1 in row 5 for
// packed slots, parked slots with row 5 = 0), field the periodic mesh
// [n_pm, n_pm, n_pm, K] (K = 3 force components, or 4 with the potential
// last). For each packed slot, with u = rel * n_pm / box + cell centre in
// mesh units (kernel B's coordinate), i = floor(u), f = u - i:
//   out[c, k, slot] = sum over the 8 corners (a, b, d) of
//                     wx_a wy_b wz_d field[i + (a, b, d) mod n_pm, k].
// Parked slots write 0 and read nothing. out is [C, K, cap].
//
// What bounds it on the card. Bytes: the pack's four rows, the mesh and the
// output once each, about 225 MB at 2x128^3 (34^3 cells of 128 slots, a
// 192^3 x 3 mesh); the 8 K-vector reads per particle are what a row gather
// pays at random in device memory or L2.
//
// What the design does about it. One thread block per cell. The block
// stages the cell's window of the mesh, w^3 x K floats from base
// floor(c * edge - margin) on each axis, into shared memory, with the
// periodic wrap applied to the mesh index while staging; consecutive
// threads copy consecutive floats of a z-run of w K values. One thread per
// slot then reads its 8 corners from shared memory. A slot whose corners
// leave the window (a particle that drifted beyond the margin) reads the
// mesh in device memory instead, so the result is exact for any position.
// The TPU kernel's one-hot contractions, wrap-padded and lane-aligned mesh
// copy, aligned-down window bases and column walk served a machine that
// cannot address at random; none is carried over. Plain loads only: no TMA
// or cp.async for the window yet.

#include "glt_common.cuh"

namespace {

constexpr int kMaxComp = 4;

__global__ void pm_gather_kernel(const float* __restrict__ soa,
                                 const float* __restrict__ field,
                                 float* __restrict__ out, int n_cells, int cap,
                                 int n_pm, int k_comp, int w, float scale,
                                 float edge_pm, float margin_pm) {
  extern __shared__ float s_win[];  // [w, w, w, K]; unused when w == 0
  const int c = blockIdx.x;
  const int cx = c / (n_cells * n_cells);
  const int cy = (c / n_cells) % n_cells;
  const int cz = c % n_cells;
  const float* tile = soa + static_cast<size_t>(c) * 8 * cap;
  float* o = out + static_cast<size_t>(c) * k_comp * cap;

  bool mine = false;
  for (int t = threadIdx.x; t < cap; t += blockDim.x)
    mine = mine || tile[5 * cap + t] > 0.f;
  const bool any_live = __syncthreads_or(mine) != 0;
  if (!any_live) {
    for (int t = threadIdx.x; t < k_comp * cap; t += blockDim.x) o[t] = 0.f;
    return;
  }

  const int bx = static_cast<int>(floorf(static_cast<float>(cx) * edge_pm - margin_pm));
  const int by = static_cast<int>(floorf(static_cast<float>(cy) * edge_pm - margin_pm));
  const int bz = static_cast<int>(floorf(static_cast<float>(cz) * edge_pm - margin_pm));
  const int run = w * k_comp;           // floats of one z-run of the window
  const int total = w * w * run;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int lxy = e / run;
    const int rem = e - lxy * run;      // lz * K + k
    const int lz = rem / k_comp;
    const int k = rem - lz * k_comp;
    const int gx = glt::wrap(bx + lxy / w, n_pm);
    const int gy = glt::wrap(by + lxy % w, n_pm);
    const int gz = glt::wrap(bz + lz, n_pm);
    s_win[e] = field[((static_cast<size_t>(gx) * n_pm + gy) * n_pm + gz) *
                         k_comp + k];
  }
  __syncthreads();

  const float offx = (static_cast<float>(cx) + 0.5f) * edge_pm;
  const float offy = (static_cast<float>(cy) + 0.5f) * edge_pm;
  const float offz = (static_cast<float>(cz) + 0.5f) * edge_pm;
  for (int t = threadIdx.x; t < cap; t += blockDim.x) {
    float acc[kMaxComp] = {0.f, 0.f, 0.f, 0.f};
    if (tile[5 * cap + t] > 0.f) {
      const float ux = tile[t] * scale + offx;
      const float uy = tile[cap + t] * scale + offy;
      const float uz = tile[2 * cap + t] * scale + offz;
      const float fx0 = floorf(ux), fy0 = floorf(uy), fz0 = floorf(uz);
      const float fx = ux - fx0, fy = uy - fy0, fz = uz - fz0;
      const int ix = static_cast<int>(fx0);
      const int iy = static_cast<int>(fy0);
      const int iz = static_cast<int>(fz0);
      const float wx[2] = {1.0f - fx, fx};
      const float wy[2] = {1.0f - fy, fy};
      const float wz[2] = {1.0f - fz, fz};
      const int lx = glt::wrap(ix - bx, n_pm);
      const int ly = glt::wrap(iy - by, n_pm);
      const int lz = glt::wrap(iz - bz, n_pm);
      if (lx < w - 1 && ly < w - 1 && lz < w - 1) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const float wxy = wx[a] * wy[b];
            const float* row = s_win + ((lx + a) * w + (ly + b)) * run;
#pragma unroll
            for (int d = 0; d < 2; ++d) {
              const float wgt = wxy * wz[d];
              const float* v = row + (lz + d) * k_comp;
#pragma unroll
              for (int k = 0; k < kMaxComp; ++k)
                if (k < k_comp) acc[k] += v[k] * wgt;
            }
          }
        }
      } else {
        // beyond the staged window: the mesh itself, wrapped
        const int gx0 = glt::wrap(ix, n_pm), gy0 = glt::wrap(iy, n_pm);
        const int gz0 = glt::wrap(iz, n_pm);
        const int jx[2] = {gx0, gx0 + 1 == n_pm ? 0 : gx0 + 1};
        const int jy[2] = {gy0, gy0 + 1 == n_pm ? 0 : gy0 + 1};
        const int jz[2] = {gz0, gz0 + 1 == n_pm ? 0 : gz0 + 1};
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const float wxy = wx[a] * wy[b];
            const size_t row = (static_cast<size_t>(jx[a]) * n_pm + jy[b]) * n_pm;
#pragma unroll
            for (int d = 0; d < 2; ++d) {
              const float wgt = wxy * wz[d];
              const float* v = field + (row + jz[d]) * k_comp;
#pragma unroll
              for (int k = 0; k < kMaxComp; ++k)
                if (k < k_comp) acc[k] += v[k] * wgt;
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxComp; ++k)
      if (k < k_comp) o[k * cap + t] = acc[k];
  }
}

}  // namespace

// w: the window's side in mesh cells. A window that does not fit a block's
// shared memory is not staged (w = 0 in the kernel): every slot then reads
// the mesh in device memory.
extern "C" int glt_pm_gather(const float* soa, const float* field, float* out,
                             int n_cells, int cap, int n_pm, int k_comp, int w,
                             float scale, float edge_pm, float margin_pm,
                             void* stream) {
  if (k_comp < 1 || k_comp > kMaxComp) return static_cast<int>(cudaErrorInvalidValue);
  const int c = n_cells * n_cells * n_cells;
  const int threads = cap < 128 ? ((cap + 31) / 32) * 32 : 128;
  size_t smem = static_cast<size_t>(w) * w * w * k_comp * sizeof(float);
  if (smem > 227 * 1024) {
    w = 0;
    smem = 0;
  }
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        pm_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  pm_gather_kernel<<<c, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      soa, field, out, n_cells, cap, n_pm, k_comp, w, scale, edge_pm,
      margin_pm);
  return static_cast<int>(cudaGetLastError());
}
