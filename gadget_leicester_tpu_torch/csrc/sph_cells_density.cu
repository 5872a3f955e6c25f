// Kernels I and J: SPH density sums over the 27-cell stencil of a coarse
// cell list.
//
// Replaces gadget_leicester_tpu/ops/pallas_cells.py ::
// density_sums_pallas_dma (kernel body _make_density_kernel_dma) and its
// grid twin density_sums_pallas (_make_density_kernel): two TPU schedules
// of one function, one kernel here.
// Plain PyTorch twin: ops/sph_cells.py :: density_sums_cells_plain.
//
// The ghost-row mode (the same C entry, glt_sph_cells_density) is the slab
// step's: density_adaptive_pallas with a tuple n_cells = (nx, n_sph,
// n_sph), periodic = (False, pyz, pyz), n_targets and a prebuilt cell list
// (pallas_cells.py:1401-1480), as parallel/spmd.py :: _sph calls it. It is
// this kernel with two generalisations, each a no-op on the cubic calls,
// which stay bit for bit what they were:
// - per-axis cell counts (nx, ny, nz); the cube passes (n, n, n);
// - a per-axis image mask kPer (bit a set: axis a periodic), a template
//   argument, as in kernel A's slab mode (shortrange_gravity_cells.cu): a
//   tile across the wrap of a periodic axis is shifted by -+box as a
//   whole, and a stencil cell beyond a clamped face adds nothing. The cube
//   instantiates 7 and 0, the slab 6 (x clamped, y and z periodic) and 0.
// The ghost rows need nothing of the kernel: they are slots like any
// other, sources of the targets around them. The restriction to targets
// lies in the flags: the caller sets the flag of a cell only where one of
// its live slots is a target (its row below n_targets), and iterates the
// Newton solve and scatters back the target slots only; a ghost slot in a
// flagged cell is summed and its sums dropped. On the clamped x axis nx may
// be 1 or 2 (a cell is never met twice), a particle past the grid's edge
// is filed in the edge cell with its own coordinate (its pairs are exact,
// and the caller caps h at the cell edge, so no pair is lost), and a
// parked slot at -7 cells has m = 0 and never enters a box or a sum.
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
// as a whole (n_cells >= 3, so this equals the per-pair minimum image):
// dx = t - (s + shift); on a vacuum grid nothing is shifted and the
// stencil cells beyond the edge add nothing. The self-pair is included:
// the target meets its own slot in the centre cell (shift 0) at r = 0
// exactly, where it adds m W(0, h) and dW/dr = 0. The stencil is complete
// because the caller caps h at the cell edge. A cell whose flag is 0 and
// a parked target write zeros. out is [C, 6, cap].
//
// What bounds it on the card. Pairs: at 2x128^3 gas, C = 28^3 cells with
// ~96 of cap = 128 slots live, 27 * 96 * 96 pairs per cell, 5.4e9 per
// sweep, of which 1.15% lie inside the support h_i (h ~ 0.43 cell edges)
// and pay the whole pair arithmetic; the Newton loop runs a few sweeps.
// A warp pays a pair's arithmetic whenever one of its lanes is inside, so
// the kernel is bound by instruction issue and divergence at the edge of
// the support, not by bytes.
//
// What the design does about it: kernel C's (csrc/sph_density.cu) on the
// 27-cell stencil, with the reach of the target's h alone.
// - Chunk boxes. A first kernel (glt::subcell_boxes_kernel, shared with C
//   and D, with parts of 32 slots) writes, for each cell and each chunk of
//   32 slots of it, the bounding box of its sources with m > 0 (an empty
//   chunk's box is +inf..-inf, beyond any reach), into a workspace of C x
//   ceil(cap / 32) x 8 floats that the wrapper allocates.
// - Targets in space order. A thread block is 128 slots of one cell, one
//   thread a target slot. The block ranks its live slots (m > 0) by a
//   Morton key on an 8^3 grid over the bounding box of those slots (the
//   kernel does not know a vacuum grid's origin), ties by slot, parked
//   slots last, so each warp holds 32 close targets; the warp reduces
//   their box and its reach, the largest h of its live targets
//   (glt::warp_box).
// - The chunk skip. A warp walks the items (stencil cell j, chunk) in
//   order and skips those whose shifted box lies at least its reach
//   (1 + 1e-5) from its targets' box; it stages the others itself (7
//   rows, x, y, z, m, vx, vy, vz, of 32 slots), double-buffered with
//   cp.async, from L2.
// - Warp-uniform culling within a chunk: each lane tests its chunk's
//   source against the warp's box, and a ballot keeps the sources with m >
//   0 whose box distance is below the reach (1 + 1e-5). Every box test
//   (glt::near_boxes<glt::Shift::kSource>) takes the shifted source
//   coordinate as dx does, s + shift, so the box distance per axis, max(lo
//   - (s + shift), (s + shift) - hi, 0), is in float32 never above |dx|
//   for a target of the box (rounding is monotone); the 1e-5 covers the rounding of r = r2 rsqrt(r2), of the
//   squares and of u = r (1/h). A culled source has u >= 1 for every lane
//   of the warp, which the earlier design's density_pair left without
//   adding. A target whose 1/h is 0 (glt::inv_or_zero: h not above 0, or
//   infinite) adds only zeros, so what its h reaches does not change its
//   sums; a NaN h adds nothing to the reach.
// - The order of sums is kept: each target adds its pairs stencil cell j
//   = 0..26, then slot k ascending, skipping only pairs the earlier design
//   skipped (m = 0 or u >= 1), with the earlier design's pair arithmetic
//   (glt::density_pair on the same expressions); the warp walks the kept
//   sources two at a time where there are two, so that the two pairs'
//   arithmetic can overlap. So I/J equals its earlier design (one thread
//   per target walking every staged source) bit for bit, built with
//   -fmad=false on both and, with nvcc 12.8, with its default contraction
//   into FMAs too, periodic and vacuum (PERF.md section 6). No compaction
//   of the inside pairs.
// nvcc 12.8 -Xptxas=-v for sm_90a: 56 registers periodic, 54 vacuum, 8,304
// bytes of shared memory a block of 128 threads; the chunk boxes (C's
// instantiation of glt::subcell_boxes_kernel) 32 registers.

#include "glt_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 7;   // staged rows x, y, z, m, vx, vy, vz

template <int kPer>
__global__ void __launch_bounds__(kThreads)
    sph_cells_density_kernel(const float* __restrict__ soa,
                             const float* __restrict__ h,
                             const int* __restrict__ flags,
                             const float* __restrict__ boxes,
                             float* __restrict__ out, int nx, int ny, int nz,
                             int cap, int chunks, float box) {
  const int c = blockIdx.x;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  float* o = out + static_cast<size_t>(c) * 6 * cap;
  if (flags[c] == 0) {
    if (t < cap)
      for (int r = 0; r < 6; ++r) o[r * cap + t] = 0.f;
    return;
  }
  __shared__ float s_ring[kWarps][2][kRows][32];
  __shared__ glt::Box s_tbox[kWarps];
  __shared__ unsigned s_key[kThreads];
  __shared__ int s_slot[kThreads];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float(*ring)[kRows][32] = s_ring[warp];
  const int cx = c / (ny * nz), cy = (c / nz) % ny, cz = c % nz;
  const float* tile = soa + static_cast<size_t>(c) * 8 * cap;

  // 1. rank the block's slots: live ones by Morton key over their box,
  // parked ones last
  {
    const bool in = t < cap && tile[3 * cap + t] > 0.f;
    glt::rank_by_box(in, in ? tile[t] : 0.f, in ? tile[cap + t] : 0.f,
                     in ? tile[2 * cap + t] : 0.f, t, s_tbox, s_key, s_slot);
  }
  const int ts = s_slot[threadIdx.x];   // the slot this thread sums for
  const bool live = ts < cap && tile[3 * cap + ts] > 0.f;
  float tx = 0.f, ty = 0.f, tz = 0.f, tvx = 0.f, tvy = 0.f, tvz = 0.f;
  float ht = 0.f;
  if (live) {
    tx = tile[ts];
    ty = tile[cap + ts];
    tz = tile[2 * cap + ts];
    tvx = tile[4 * cap + ts];
    tvy = tile[5 * cap + ts];
    tvz = tile[6 * cap + ts];
    ht = h[static_cast<size_t>(c) * cap + ts];
  }
  const float hinv = glt::inv_or_zero(ht);
  // 2. the warp's box and reach
  const glt::Box tbox = glt::warp_box(live, tx, ty, tz, ht);

  // stencil cell j: the flat id of the neighbour and its shift; false
  // beyond the edge of a clamped axis
  auto neighbour = [&](int j, int& src, float (&sh)[3]) {
    int ix = cx + j / 9 - 1, iy = cy + (j / 3) % 3 - 1, iz = cz + j % 3 - 1;
    sh[0] = sh[1] = sh[2] = 0.f;
    if (!(glt::stencil_axis<(kPer & 1) != 0>(ix, nx, sh[0], box) &&
          glt::stencil_axis<(kPer & 2) != 0>(iy, ny, sh[1], box) &&
          glt::stencil_axis<(kPer & 4) != 0>(iz, nz, sh[2], box)))
      return false;
    src = (ix * ny + iy) * nz + iz;
    return true;
  };
  // the items (j, chunk) u = j * chunks + k of group g that the warp needs
  const int items = 27 * chunks;
  const int groups = (items + 31) >> 5;
  auto need_mask = [&](int g) {
    const int u = g * 32 + lane;
    bool need = false;
    int src;
    float sh[3];
    if (u < items && neighbour(u / chunks, src, sh)) {
      const float* q =
          boxes + (static_cast<size_t>(src) * chunks + u % chunks) * 8;
      const float slo[3] = {q[0], q[1], q[2]}, shi[3] = {q[3], q[4], q[5]};
      need = glt::near_boxes<glt::Shift::kSource>(tbox, slo, shi, 0.f, sh);
    }
    return __ballot_sync(glt::kFull, need);
  };
  int g = 0;
  unsigned pending = 0;
  // the next needed item after those taken, or -1 (warp-uniform)
  auto next_item = [&]() {
    while (pending == 0) {
      if (g >= groups) return -1;
      pending = need_mask(g++);
    }
    const int u = (g - 1) * 32 + __ffs(pending) - 1;
    pending &= pending - 1;
    return u;
  };
  auto stage = [&](int u, int buf) {
    int src;
    float sh[3];
    neighbour(u / chunks, src, sh);
    const int k0 = (u % chunks) * 32;
    if (lane >= min(32, cap - k0)) return;
    const float* s = soa + static_cast<size_t>(src) * 8 * cap + k0 + lane;
    for (int r = 0; r < kRows; ++r)
      glt::cp_async4(&ring[buf][r][lane], s + r * cap);
  };

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int u = __any_sync(glt::kFull, live) ? next_item() : -1;
  int buf = 0;
  if (u >= 0) stage(u, 0);
  glt::cp_async_commit();
  while (u >= 0) {
    const int nu = next_item();
    if (nu >= 0) stage(nu, buf ^ 1);   // in flight while this one sums
    glt::cp_async_commit();
    glt::cp_async_wait_prior();
    __syncwarp();

    int src;
    float sh[3];
    neighbour(u / chunks, src, sh);
    const float shx = sh[0], shy = sh[1], shz = sh[2];
    const float(*sr)[32] = ring[buf];
    bool near = false;
    if (lane < min(32, cap - (u % chunks) * 32) && sr[3][lane] > 0.f) {
      const float s3[3] = {sr[0][lane], sr[1][lane], sr[2][lane]};
      near = glt::near_boxes<glt::Shift::kSource>(tbox, s3, s3, 0.f, sh);
    }
    unsigned todo = __ballot_sync(glt::kFull, near);
    if (!live) todo = 0;
    // the earlier design's call, on the same expressions
    auto pair = [&](int k) {
      glt::density_pair(tx - (sr[0][k] + shx), ty - (sr[1][k] + shy),
                        tz - (sr[2][k] + shz), tvx - sr[4][k],
                        tvy - sr[5][k], tvz - sr[6][k], sr[3][k], hinv, acc);
    };
    while (todo) {
      const int k1 = __ffs(todo) - 1;
      todo &= todo - 1;
      if (todo) {
        const int k2 = __ffs(todo) - 1;
        todo &= todo - 1;
        pair(k1);
        pair(k2);
      } else {
        pair(k1);
      }
    }
    __syncwarp();   // every lane is done with this buffer before its refill
    u = nu;
    buf ^= 1;
  }
  if (ts < cap) {
#pragma unroll
    for (int r = 0; r < 6; ++r) o[r * cap + ts] = acc[r];
  }
}

int launch(const float* soa, const float* h, const int* flags, float* boxes,
           float* out, int nx, int ny, int nz, int per, int cap, float box,
           cudaStream_t st) {
  const int cells = nx * ny * nz;
  const int chunks = (cap + 31) / 32;
  const int threads = cap < kThreads ? ((cap + 31) / 32) * 32 : kThreads;
  const dim3 grid(cells, (cap + threads - 1) / threads);
  glt::launch_boxes<8, 3, -1>(soa, boxes, cells, cap, 32, st);
  switch (per) {
    case 7:   // the periodic cube
      sph_cells_density_kernel<7><<<grid, threads, 0, st>>>(
          soa, h, flags, boxes, out, nx, ny, nz, cap, chunks, box);
      break;
    case 6:   // the periodic box's slab grid: x clamped
      sph_cells_density_kernel<6><<<grid, threads, 0, st>>>(
          soa, h, flags, boxes, out, nx, ny, nz, cap, chunks, box);
      break;
    case 0:   // a vacuum cube or slab grid
      sph_cells_density_kernel<0><<<grid, threads, 0, st>>>(
          soa, h, flags, boxes, out, nx, ny, nz, cap, chunks, box);
      break;
    default:  // no other image mask is instantiated
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// one entry for both modes: per-axis cell counts (the cube passes (n, n,
// n)) and the image mask per (bit a set: axis a periodic; the cube's 7 or
// 0, the slab's 6 or 0)
extern "C" int glt_sph_cells_density(const float* soa, const float* h,
                                     const int* flags, float* boxes,
                                     float* out, int nx, int ny, int nz,
                                     int per, int cap, float box,
                                     void* stream) {
  return launch(soa, h, flags, boxes, out, nx, ny, nz, per, cap, box,
                static_cast<cudaStream_t>(stream));
}
