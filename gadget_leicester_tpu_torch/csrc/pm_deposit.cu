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
// What bounds it on the card. Row 3 of every slot, rows 0-2 and 5 of the
// packed ones, and the 192^3 x 4 B = 28 MB mesh written once: 0.035 ms of
// bytes at 2x128^3. One thread a slot with 8 global atomics each (the
// earlier design) makes about 34 M float atomics a deposit, and the ~107
// particles of a cell fall on ~180 mesh cells, so neighbouring threads
// queue on the same L2 addresses: the atomics bound it.
//
// What the design does about it. A thread block takes a column of
// short-range cells along z, whose slots are one run of the pack, and sums
// their CIC weights into a slab of the mesh in shared memory that covers
// the column's footprint: ceil(n_pm / n_cells) + 2 mesh cells a side in x
// and y and the whole z axis, each row of z padded to an odd length so
// that the rows of one z fall in different banks. Then it adds the slab's
// non-zero runs of 4 z cells into the mesh with one vector reduction each
// (atomicAdd on float4, sm_90). At 2x128^3: 34^2 blocks of 8 x 8 x 193
// floats (49,408 B of dynamic shared memory, three blocks an SM), about
// 3.5 M vector reductions in place of 34 M scalar atomics. sm_90 has no
// float add in shared memory: nvcc makes each atomicAdd on the slab a
// compare-and-swap loop (ATOMS.CAST.SPIN), about 0.085 ms of the deposit
// at 2x128^3 (PERF.md section 6). An axis whose slab would cover n_pm or
// more mesh cells (the small boxes of the tests) takes the whole axis, so
// no mesh cell has two places in the slab. A slot with a corner outside
// the slab (a particle staler than the fraction of a mesh cell between
// its cell's edge and the slab's) adds its 8 weights straight into the
// mesh, as the earlier design did, so no mass is lost; so does every slot
// where the slab would not fit in shared memory (short-range cells of tens
// of mesh cells, or a mesh of some thousand cells a side). u, the floor
// and the weights are the earlier design's arithmetic line for line: each
// term is the same float, and only the order of the sums changes (atomics
// make it vary from run to run, as before). Columns of 2 x 2 cells (one
// block an SM) took more than twice as long; 512 threads held to 40
// registers by __launch_bounds__ (three blocks an SM) beat 50 registers
// (two) by a fifth (PERF.md section 6).
// nvcc 12.8 -Xptxas=-v for sm_90a: 40 registers, no spill.

#include <cmath>

#include "glt_common.cuh"

namespace {

constexpr int kDepositThreads = 512;

// One axis of a block's slab: mesh cells lo .. lo + w - 1 (periodic), or
// the whole axis where w == n (lo = 0).
struct SlabAxis {
  int lo, w, n;
  // the slab index of mesh cell i (unwrapped, as floor(u) gives it), with
  // i + 1 at index + 1 (mod w on the whole axis); false where either lies
  // outside the slab
  __device__ __forceinline__ bool index(int i, int& a, int& a1) const {
    if (w == n) {
      a = glt::wrap(i, n);
      a1 = a + 1 == n ? 0 : a + 1;
      return true;
    }
    a = i - lo;
    a1 = a + 1;
    return a >= 0 && a1 < w;
  }
  __device__ __forceinline__ int mesh(int a) const {
    return glt::wrap(lo + a, n);
  }
};

// the slab axis of w mesh cells from the first mesh cell of cell c (of
// edge e mesh cells)
__device__ __forceinline__ SlabAxis slab_axis(int c, float e, int w, int n) {
  if (w == n) return {0, w, n};
  return {static_cast<int>(floorf(static_cast<float>(c) * e)), w, n};
}

__global__ void __launch_bounds__(kDepositThreads, 3)
    pm_deposit_kernel(const float* __restrict__ soa,
                      float* __restrict__ mesh, int n_cells, int cap,
                      int n_pm, float scale, float edge_pm, int slab_xy,
                      int vec) {
  extern __shared__ float slab[];
  const int cx = blockIdx.x / n_cells, cy = blockIdx.x % n_cells;
  const SlabAxis ax = slab_axis(cx, edge_pm, slab_xy, n_pm);
  const SlabAxis ay = slab_axis(cy, edge_pm, slab_xy, n_pm);
  const SlabAxis az = {0, n_pm, n_pm};
  // a slab row (x, y) holds n_pm + 1 floats: an odd stride spreads the
  // rows of one z over the 32 banks
  const int row_len = n_pm + 1;
  const int n_rows = slab_xy * slab_xy;
  for (int i = threadIdx.x; i < n_rows * row_len; i += blockDim.x)
    slab[i] = 0.f;
  __syncthreads();

  // the column's slots: cells (cx, cy, 0 .. n_cells - 1), one run of the
  // pack
  for (int i = threadIdx.x; i < n_cells * cap; i += blockDim.x) {
    const int cz = i / cap, s = i - cz * cap;
    const int c = (cx * n_cells + cy) * n_cells + cz;
    const float* t = soa + static_cast<size_t>(c) * 8 * cap;
    const float m = t[3 * cap + s];
    if (m == 0.f) continue;  // parked slot
    const float valid = t[5 * cap + s];
    const float ux = t[s] * scale + (static_cast<float>(cx) + 0.5f) * edge_pm;
    const float uy = t[cap + s] * scale +
                     (static_cast<float>(cy) + 0.5f) * edge_pm;
    const float uz = t[2 * cap + s] * scale +
                     (static_cast<float>(cz) + 0.5f) * edge_pm;
    const float fx0 = floorf(ux), fy0 = floorf(uy), fz0 = floorf(uz);
    const float fx = ux - fx0, fy = uy - fy0, fz = uz - fz0;
    const float wx[2] = {1.0f - fx, fx};
    const float wy[2] = {1.0f - fy, fy};
    const float wz[2] = {m * (1.0f - fz), m * fz};
    int jx[2], jy[2], jz[2];
    if (ax.index(static_cast<int>(fx0), jx[0], jx[1]) &
        ay.index(static_cast<int>(fy0), jy[0], jy[1]) &
        az.index(static_cast<int>(fz0), jz[0], jz[1])) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float wxy = wx[a] * wy[b] * valid;
          float* row = slab + (jx[a] * slab_xy + jy[b]) * row_len;
          atomicAdd(row + jz[0], wxy * wz[0]);
          atomicAdd(row + jz[1], wxy * wz[1]);
        }
      }
      continue;
    }
    // a corner outside the slab: straight into the mesh
    const int ix = glt::wrap(static_cast<int>(fx0), n_pm);
    const int iy = glt::wrap(static_cast<int>(fy0), n_pm);
    const int iz = glt::wrap(static_cast<int>(fz0), n_pm);
    jx[0] = ix;
    jx[1] = ix + 1 == n_pm ? 0 : ix + 1;
    jy[0] = iy;
    jy[1] = iy + 1 == n_pm ? 0 : iy + 1;
    jz[0] = iz;
    jz[1] = iz + 1 == n_pm ? 0 : iz + 1;
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
  __syncthreads();

  // the slab into the mesh: a vector reduction a non-zero run of 4 z
  // cells (aligned where n_pm is a multiple of 4), a scalar one a
  // non-zero cell otherwise
  const int run_len = vec ? 4 : 1, runs = n_pm / run_len;
  for (int i = threadIdx.x; i < n_rows * runs; i += blockDim.x) {
    const int row = i / runs, c = (i - row * runs) * run_len;
    const float* v = slab + row * row_len + c;
    const size_t at = (static_cast<size_t>(ax.mesh(row / slab_xy)) * n_pm +
                       ay.mesh(row % slab_xy)) * n_pm + az.mesh(c);
    if (vec) {
      const float4 v4 = make_float4(v[0], v[1], v[2], v[3]);
      if (v4.x != 0.f || v4.y != 0.f || v4.z != 0.f || v4.w != 0.f)
        atomicAdd(reinterpret_cast<float4*>(mesh + at), v4);
    } else if (v[0] != 0.f) {
      atomicAdd(mesh + at, v[0]);
    }
  }
}

}  // namespace

extern "C" int glt_pm_deposit(const float* soa, float* mesh, int n_cells,
                              int cap, int n_pm, float scale, float edge_pm,
                              void* stream) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // the slab: x and y cover the footprint of a cell (or the whole axis),
  // z the whole axis; where that does not fit (cells of many mesh cells,
  // or a mesh of some thousand cells a side), no slab: every slot adds
  // straight into the mesh
  int wxy = static_cast<int>(std::ceil(edge_pm)) + 2;
  if (wxy >= n_pm) wxy = n_pm;
  size_t smem = static_cast<size_t>(wxy) * wxy * (n_pm + 1) * sizeof(float);
  if (smem > static_cast<size_t>(max_smem)) {
    wxy = 0;
    smem = 0;
  }
  cudaFuncSetAttribute(pm_deposit_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  pm_deposit_kernel<<<n_cells * n_cells, kDepositThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      soa, mesh, n_cells, cap, n_pm, scale, edge_pm, wxy, n_pm % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}
