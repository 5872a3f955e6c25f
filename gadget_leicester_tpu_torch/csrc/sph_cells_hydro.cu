// Kernel K: SPH hydro force sums over the 27-cell stencil of a coarse cell
// list.
//
// Replaces gadget_leicester_tpu/ops/pallas_cells.py :: hydro_sums_pallas
// (kernel body _make_hydro_kernel).
// Plain PyTorch twin: ops/sph_cells.py :: hydro_sums_cells_plain.
//
// The ghost-row mode (the same C entry, glt_sph_cells_hydro) is the slab
// step's: hydro_force_pallas with a tuple n_cells and n_targets
// (pallas_cells.py:1483-1544), on the density pass's cell list. As in
// sph_cells_density.cu it takes per-axis cell counts (nx, ny, nz) and the
// image mask kPer (7 and 0 on the cube, 6 and 0 on the slab), and it
// gains cell flags: a cell whose flag is 0 writes zeros and does nothing
// else. The caller flags the cells that hold a live target slot (row below
// n_targets), so cells of ghosts alone cost one write. The flags are a
// template argument, kFlags: the cube passes none (nullptr), and its
// instances compile without the test and sum every cell, as before, bit
// for bit.
//
// What it computes. soa16 is the [C, 16, cap] pack of ops/sph_cells.py ::
// pack_hydro_cells: rows 0-7 x, y, z ABSOLUTE (each the periodic image
// nearest its cell's centre), m, vx, vy, vz, h; rows 8-12
// rho, P/rho^2 f, c_sound, Balsara, valid (the TPU kernel's soa_a and
// soa_b in one tensor; targets and sources come from the same pack). For
// each live target slot (valid > 0) of a cell c, over the 27 cells around
// c, each pair with 0 < r < max(h_i, h_j) and a valid source adds the
// entropy-form pair force with Monaghan-Balsara viscosity, the Balsara
// limiter, the Hubble-flow term and fac_mu [G2: hydra.c ::
// hydro_evaluate()]; out[C, 5, cap] = ax, ay, az, raw dA/dt, max signal
// velocity (from 0, over the masked pairs only). The caller applies the
// (gamma-1) / (a^2 H rho^(gamma-1)) factor. Wrap and vacuum edges as in
// sph_cells_density.cu: a neighbour tile across the wrap is shifted by
// -+box as a whole, dx = t - (s + shift); stencil cells beyond a vacuum
// grid's edge add nothing. The self-pair is excluded by r2 > 0: the
// coordinates are absolute and the centre cell's shift is 0, so a target
// meets its own slot at r2 == 0 bit for bit. (Kernels D and G, on
// block-relative coordinates, compare int32 particle indices instead.)
// Every mask is a branch, never a product: 1 / rho_ij reaches 1e37 where
// both densities are 0. Parked target slots write zeros.
//
// What bounds it on the card. Pairs: at 2x128^3 gas, C = 28^3 cells with
// ~96 of cap = 128 slots live, 5.4e9 stencil pairs a pass, about 1.2% of
// them inside max(h_i, h_j), each of those about 86 float32 operations
// and a division. A warp pays a pair's arithmetic whenever one of its
// lanes is inside, so the kernel is bound by instruction issue and
// divergence at the edge of the support, not by bytes.
//
// What the design does about it: kernel I/J's (csrc/sph_cells_density.cu)
// with hydro's reach max(h_i, h_j), as kernel D takes it
// (csrc/sph_hydro.cu).
// - Chunk boxes. A first kernel (glt::subcell_boxes_kernel in D's
//   instantiation, valid row 12 and h row 7, with parts of 32 slots)
//   writes, for each cell and each chunk of 32 slots of it, the bounding
//   box of its valid sources and their largest h (an empty chunk's box is
//   +inf..-inf, beyond any reach), into a workspace of C x ceil(cap / 32)
//   x 8 floats that the wrapper allocates.
// - Targets in space order. A thread block is 128 slots of one cell, one
//   thread a target slot. The block ranks its live slots by a Morton key
//   on an 8^3 grid over the bounding box of those slots
//   (glt::rank_by_box), ties by slot, parked slots last, so each warp
//   holds 32 close targets; the warp reduces their box and its reach, the
//   largest h of its live targets (glt::warp_box; a NaN adds nothing, and
//   the reach is at least 0).
// - The chunk skip. A warp walks the items (stencil cell j, chunk) in
//   order and skips those whose shifted box lies at least max(h_max,
//   h_chunk) (1 + 1e-5) from its targets' box; it stages the others itself
//   (13 rows: x, y, z, m, vx, vy, vz, h, rho, P/rho^2 f, c, Balsara,
//   valid, of 32 slots, 3.3 KB), double-buffered with cp.async, from L2.
// - Warp-uniform culling within a chunk: each lane tests its chunk's
//   source against the warp's box with the reach max(h_max, h_s), and a
//   ballot keeps the valid sources within it (1 + 1e-5). Every box test
//   (glt::near_boxes<glt::Shift::kSource>) takes the shifted source
//   coordinate as dx does, s + shift, so the box distance per axis is in
//   float32 never above |dx| for a target of the box (rounding is
//   monotone); the 1e-5 covers the rounding of r = r2 rsqrt(r2) and of the
//   squares. A culled source has r >= max(h_i, h_j) for every lane of the
//   warp, which the earlier design left with `continue`; so msv, which
//   takes its max over the masked pairs only, is unchanged too.
// - The order of sums is kept: each target adds its pairs stencil cell j
//   = 0..26, then slot ascending, skipping only pairs the earlier design
//   skipped, with the earlier design's pair arithmetic line for line
//   (spelt out here, not glt::hydro_pair: D's note on registers); the warp
//   walks the kept sources two at a time where there are two, so that the
//   two pairs' arithmetic can overlap. K equals its earlier design (one
//   thread per target walking every staged source of each stencil cell)
//   bit for bit, built with -fmad=false on both and, with nvcc 12.8, with
//   its default contraction into FMAs too, periodic and vacuum, at 128
//   and 256 slots (PERF.md section 6). No compaction of the inside pairs.
// - hubble_a2_flow and fac_mu are read from device memory, so the launch
//   needs no host sync.
// nvcc 12.8 -Xptxas=-v for sm_90a: 56 registers periodic and vacuum (the
// earlier design 64), 14,448 bytes of shared memory a block of 128
// threads; the chunk boxes (D's instantiation of
// glt::subcell_boxes_kernel) 40 registers.

#include "glt_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 13;   // staged rows 0-12 of the pack

template <int kPer, bool kFlags>
__global__ void __launch_bounds__(kThreads)
    sph_cells_hydro_kernel(const float* __restrict__ soa16,
                           const float* __restrict__ params,
                           const int* __restrict__ flags,
                           const float* __restrict__ boxes,
                           float* __restrict__ out, int nx, int ny, int nz,
                           int cap, int chunks, float box, float half_visc) {
  __shared__ float s_ring[kWarps][2][kRows][32];
  __shared__ glt::Box s_tbox[kWarps];
  __shared__ unsigned s_key[kThreads];
  __shared__ int s_slot[kThreads];
  const int c = blockIdx.x;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  float* o = out + static_cast<size_t>(c) * 5 * cap;
  if constexpr (kFlags) {
    if (flags[c] == 0) {
      if (t < cap)
        for (int r = 0; r < 5; ++r) o[r * cap + t] = 0.f;
      return;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float(*ring)[kRows][32] = s_ring[warp];
  const int cx = c / (ny * nz), cy = (c / nz) % ny, cz = c % nz;
  const float* tile = soa16 + static_cast<size_t>(c) * 16 * cap;

  // 1. rank the block's slots: live ones by Morton key over their box,
  // parked ones last
  {
    const bool in = t < cap && tile[12 * cap + t] > 0.f;
    glt::rank_by_box(in, in ? tile[t] : 0.f, in ? tile[cap + t] : 0.f,
                     in ? tile[2 * cap + t] : 0.f, t, s_tbox, s_key, s_slot);
  }
  const int ts = s_slot[threadIdx.x];   // the slot this thread sums for
  const bool live = ts < cap && tile[12 * cap + ts] > 0.f;
  float tx = 0.f, ty = 0.f, tz = 0.f, tvx = 0.f, tvy = 0.f, tvz = 0.f;
  float ht = 0.f, trho = 0.f, tpor = 0.f, tc = 0.f, tbal = 0.f;
  if (live) {
    tx = tile[ts];
    ty = tile[cap + ts];
    tz = tile[2 * cap + ts];
    tvx = tile[4 * cap + ts];
    tvy = tile[5 * cap + ts];
    tvz = tile[6 * cap + ts];
    ht = tile[7 * cap + ts];
    trho = tile[8 * cap + ts];
    tpor = tile[9 * cap + ts];
    tc = tile[10 * cap + ts];
    tbal = tile[11 * cap + ts];
  }
  const float hinv_t = glt::inv_or_zero(ht);
  // 2. the warp's box and reach
  const glt::Box tbox = glt::warp_box(live, tx, ty, tz, ht);
  const float hubble_a2_flow = params[0];
  const float fac_mu = params[1];

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
      need = glt::near_boxes<glt::Shift::kSource>(tbox, slo, shi, q[6], sh);
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
    const float* s = soa16 + static_cast<size_t>(src) * 16 * cap + k0 + lane;
    for (int r = 0; r < kRows; ++r)
      glt::cp_async4(&ring[buf][r][lane], s + r * cap);
  };

  float ax = 0.f, ay = 0.f, az = 0.f, dte = 0.f, msv = 0.f;
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
    if (lane < min(32, cap - (u % chunks) * 32) && sr[12][lane] > 0.f) {
      const float s3[3] = {sr[0][lane], sr[1][lane], sr[2][lane]};
      near = glt::near_boxes<glt::Shift::kSource>(tbox, s3, s3, sr[7][lane],
                                                  sh);
    }
    unsigned todo = __ballot_sync(glt::kFull, near);
    if (!live) todo = 0;
    // the earlier design's pair arithmetic, line for line
    auto pair = [&](int k) {
      const float dx = tx - (sr[0][k] + shx);
      const float dy = ty - (sr[1][k] + shy);
      const float dz = tz - (sr[2][k] + shz);
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
      const float r = r2 * rinv;
      const float hs = sr[7][k];
      if (!(r < fmaxf(ht, hs)) || !(r2 > 0.f)) return;
      const float dwk_i = glt::w4_dw_dr(r, hinv_t);
      const float dwk_j = glt::w4_dw_dr(r, glt::inv_or_zero(hs));
      const float dvx = tvx - sr[4][k];
      const float dvy = tvy - sr[5][k];
      const float dvz = tvz - sr[6][k];
      const float rr = r * r;
      const float vdotr2 = dvx * dx + dvy * dy + dvz * dz + hubble_a2_flow * rr;
      const bool approaching = vdotr2 < 0.f;
      const float mu = fac_mu * vdotr2 * rinv;
      const float vsig = tc + sr[10][k] - 3.0f * (approaching ? mu : 0.f);
      const float rho_ij = 0.5f * (trho + sr[8][k]);
      const float rs = rsqrtf(fmaxf(rho_ij, 1e-37f));
      const float rho_ij_inv = rs * rs;
      const float f_ij = 0.5f * (tbal + sr[11][k]);
      const float visc =
          approaching ? half_visc * vsig * (-mu) * rho_ij_inv * f_ij : 0.f;
      const float m = sr[3][k];
      const float hfc_visc = 0.5f * m * visc * (dwk_i + dwk_j) * rinv;
      const float hfc = hfc_visc + m * (tpor * dwk_i + sr[9][k] * dwk_j) * rinv;
      ax -= hfc * dx;
      ay -= hfc * dy;
      az -= hfc * dz;
      dte += 0.5f * (hfc_visc * vdotr2);
      msv = fmaxf(msv, vsig);
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
    o[ts] = ax;
    o[cap + ts] = ay;
    o[2 * cap + ts] = az;
    o[3 * cap + ts] = dte;
    o[4 * cap + ts] = msv;
  }
}

// one image mask, with or without cell flags
template <int kPer>
void run(const dim3& grid, int threads, cudaStream_t st, const float* soa16,
         const float* params, const int* flags, const float* boxes,
         float* out, int nx, int ny, int nz, int cap, int chunks, float box,
         float half_visc) {
  if (flags != nullptr)
    sph_cells_hydro_kernel<kPer, true><<<grid, threads, 0, st>>>(
        soa16, params, flags, boxes, out, nx, ny, nz, cap, chunks, box,
        half_visc);
  else
    sph_cells_hydro_kernel<kPer, false><<<grid, threads, 0, st>>>(
        soa16, params, flags, boxes, out, nx, ny, nz, cap, chunks, box,
        half_visc);
}

int launch(const float* soa16, const float* params, const int* flags,
           float* boxes, float* out, int nx, int ny, int nz, int per, int cap,
           float box, float half_visc, cudaStream_t st) {
  const int cells = nx * ny * nz;
  const int chunks = (cap + 31) / 32;
  const int threads = cap < kThreads ? ((cap + 31) / 32) * 32 : kThreads;
  const dim3 grid(cells, (cap + threads - 1) / threads);
  glt::launch_boxes<16, 12, 7>(soa16, boxes, cells, cap, 32, st);
  switch (per) {
    case 7:   // the periodic cube
      run<7>(grid, threads, st, soa16, params, flags, boxes, out, nx, ny, nz,
             cap, chunks, box, half_visc);
      break;
    case 6:   // the periodic box's slab grid: x clamped
      run<6>(grid, threads, st, soa16, params, flags, boxes, out, nx, ny, nz,
             cap, chunks, box, half_visc);
      break;
    case 0:   // a vacuum cube or slab grid
      run<0>(grid, threads, st, soa16, params, flags, boxes, out, nx, ny, nz,
             cap, chunks, box, half_visc);
      break;
    default:  // no other image mask is instantiated
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// one entry for both modes: per-axis cell counts (the cube passes (n, n,
// n)), the image mask per (bit a set: axis a periodic; the cube's 7 or 0,
// the slab's 6 or 0) and cell flags, or nullptr to sum every cell (the
// cube): a cell whose flag is 0 writes zeros (it holds no target)
extern "C" int glt_sph_cells_hydro(const float* soa16, const float* params,
                                   const int* flags, float* boxes, float* out,
                                   int nx, int ny, int nz, int per, int cap,
                                   float box, float half_visc, void* stream) {
  return launch(soa16, params, flags, boxes, out, nx, ny, nz, per, cap, box,
                half_visc, static_cast<cudaStream_t>(stream));
}
