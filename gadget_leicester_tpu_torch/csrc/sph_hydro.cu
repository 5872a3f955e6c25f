// Kernel D: SPH hydro force sums over block tiles.
//
// Replaces gadget_leicester_tpu/ops/sph_blocks.py :: hydro_sums_blocks
// (kernel body _make_hydro_block_kernel) in both its modes: block-relative
// on a periodic grid (C entry glt_sph_hydro) and absolute on a clamped
// (vacuum) grid (relative=False there; C entry glt_sph_hydro_abs), and the
// relative mode on the anisotropic block grid of a slab (per-axis block
// counts and periodicity, fine_edge given: gadget_leicester_tpu/parallel/
// spmd.py :: _sph_blocks; C entry glt_sph_hydro_aniso). Plain PyTorch twin:
// ops/sph_blocks.py :: hydro_sums_blocks_plain.
//
// What it computes. Targets come from the even block's [B, 8, lanes]
// soa_a (x, y, z, m, vx, vy, vz, h) and [B, 8, lanes] soa_b (rho,
// P/rho^2 f, c_sound, Balsara, valid, ...); sources from the odd blocks'
// [Bo, 16, lanes] src16 (rows 0-7 as soa_a, 8-12 as soa_b rows 0-4). For
// each pair with r < max(h_i, h_j) and a valid source it evaluates the
// entropy-form pair force with Monaghan-Balsara viscosity, the Balsara
// limiter, the Hubble-flow term and fac_mu [G2: hydra.c ::
// hydro_evaluate()], and writes out[B, 5, lanes] = ax, ay, az, raw dA/dt,
// max signal velocity. The caller applies the (gamma-1) / (a^2 H
// rho^(gamma-1)) factor.
//
// Relative mode: x, y, z relative to the block centre, Bo = B, the source
// blocks wrap mod nb, dx = (t - s) + (1 - 2g) * Lf. On a slab's grid
// (nbx, nb, nb) blocks, clamped along x: the ids wrap along y and z only,
// the odd grid has nbx + 1 blocks along x, and dx is the same expression
// (an even block's centre lies (1 - 2g) Lf from its odd source's along
// every axis, clamped or not); glt::BlockGrid holds the per-axis counts. The self-pair is
// excluded by comparing int32 particle indices (idx_e, idx_o): its
// separation is zero only up to rounding, and the float32 ids of the JAX
// package are exact only below 2^24 particles. Absolute mode: absolute
// x, y, z, Bo = (nb+1)^3 with no wrap, dx = t - s, and the self-pair is
// dropped by r > 0 as the JAX package drops it there: target and source
// rows are copies of one row of the table, so its r2 is exactly 0 (two
// particles at one position drop each other's pair too, and so each
// other's signal velocity, as in the reference). Invalid targets write
// zeros; a parked source (which may lie inside the cloud) is skipped by
// its valid row.
//
// What bounds it on the card. Pairs: each target's 8 odd source blocks
// are the 4^3 window of 64 fine cells around its 2^3 even block, 3.3e9
// pairs at 2x128^3, 1.9% of them inside the support, and a pair inside
// costs about 86 float32 operations and one division. Every pair walked
// costs the distance test, and a warp pays the body whenever one of its
// lanes has a pair inside, so the kernel is bound by instruction issue
// and by divergence at the support edge, not by bytes.
//
// What the design does about it.
// - The subcell skip. A first kernel (glt::subcell_boxes_kernel in
//   glt_common.cuh, shared with kernel C) writes, for each of
//   the Bo x 8 source subcells, the bounding box of its valid sources and
//   their largest h. A warp skips source subcell (g, sk) when the distance
//   from its targets' box to that box is at least max(h_max, h_s)
//   (1 + 1e-5), h_max the warp's largest target h and h_s the subcell's:
//   the test of a pair on boxes that contain both ends. It needs no
//   invariant of the caller, so it stays exact for any input: h above the
//   cap, a list gone stale, a particle clamped into an edge cell. That is
//   needed because the hydro pass takes the stored h of inactive gas, which
//   a vacuum grid re-fitted since their last density pass may leave above
//   the new cap (models/forces.py, compute_sph). Where the caller's
//   invariants hold, it skips at least the 37 of 64 source subcells whose
//   fine cell is more than 1 away from the warp's on some axis (the target
//   of lane t at fine coordinate 2 b + s per axis, s the bits of t /
//   subcap; a source of odd block b + g at 2 (b + g) - 1 + s_k): h is
//   capped at (1 - 2 kappa) Lf (compute_sph), and the lists are rebuilt
//   before 2 disp > 2 kappa Lf, disp the largest drift of a particle per
//   axis since the build (models/grids.py, refresh), so two particles whose
//   fine cells lie two apart on an axis are at least (1 - 2 kappa) Lf >=
//   max(h_i, h_j) apart, less the drift they have not used. Invalid
//   targets write zeros in absolute mode, as the plain version does. In
//   relative mode the plain version also sums the parked targets (-7 fine
//   cells from their block centre, h = 1; ops/sph_blocks.py, _hydro_rows):
//   a warp keeps a second box for its parked targets, and walks what lies
//   within reach of either box, so even their rows stay the plain's.
// - Warps stand alone. Lanes are subcell * subcap + rank, so with subcap a
//   multiple of 32 (32 at 2x128^3, 64 and 4,096 on vacuum grids) a warp
//   is one target fine cell; otherwise its box spans the fine cells of its
//   lanes. The work of a subcell varies 8:1 from one odd block to the
//   next, so a barrier per block would idle most warps: each warp stages
//   its own chunks of 32 source lanes (13 rows and the index),
//   double-buffered with cp.async, only the chunks it needs. A needed odd
//   subcell is staged once by each warp that needs it (3.4 times on
//   average at 2x128^3), from L2.
// - Warp-uniform culling within the walked subcells, as kernel A's: each
//   lane tests its chunk's source against the warp's boxes, and a ballot
//   keeps the valid sources whose box distance is below max(h_max, h_j)
//   (1 + 1e-5). The box distance per axis is taken as dx is, (lo - s) +
//   shift and (hi - s) + shift (and the same on a subcell's box), which is
//   monotone in both coordinates, so in float32 it is never above |dx|;
//   the 1e-5 covers the rounding of r = r2 rsqrt(r2) and of the squares. A
//   skipped or culled source has r >= max(h_i, h_j) for every lane, which
//   the earlier design left with `continue`.
// - The order of sums is kept: each target adds its pairs g = 0..7, then
//   lane k ascending, skipping only pairs the earlier design skipped; the
//   pair arithmetic is the earlier design's, line for line, and the warp
//   walks the kept sources two at a time where there are two, so that the
//   two pairs' arithmetic can overlap. Built with -fmad=false, D equals its
//   earlier design bit for bit in both modes; with nvcc's default
//   contraction into FMAs, the relative mode's acceleration rows differ in
//   their last bits (the compiler fuses the rebuilt kernel's products
//   differently). No compaction of inside pairs.
// - hubble_a2_flow and fac_mu are read from device memory, so the launch
//   needs no host sync; the boxes go to a workspace of Bo x 64 floats that
//   the caller allocates.
// nvcc 12.8 -Xptxas=-v for sm_90a: 64 registers in either mode, 28,896
// bytes of shared memory a block of 256 threads; subcell_boxes 40
// registers.

#include "glt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 14;   // src16 rows 0-12 and, in relative mode, idx_o

using glt::Box;
using glt::cp_async4;
using glt::cp_async_commit;
using glt::cp_async_wait_prior;
using glt::kFull;
using glt::near_boxes;
using glt::warp_box;

template <bool kAbs, bool kAniso>
__global__ void __launch_bounds__(kThreads)
    sph_hydro_kernel(const float* __restrict__ soa_a,
                     const float* __restrict__ soa_b,
                     const float* __restrict__ src16,
                     const int* __restrict__ idx_e,
                     const int* __restrict__ idx_o,
                     const int* __restrict__ flags,
                     const float* __restrict__ params,
                     const float* __restrict__ boxes,
                     float* __restrict__ out, glt::BlockGrid grid, int lanes,
                     float lf, float half_visc) {
  constexpr glt::Shift kShift = kAbs ? glt::Shift::kNone : glt::Shift::kPair;
  const int b = blockIdx.x;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  float* o = out + static_cast<size_t>(b) * 5 * lanes;
  if (flags[b] == 0) {
    if (t < lanes)
      for (int r = 0; r < 5; ++r) o[r * lanes + t] = 0.f;
    return;
  }
  __shared__ float s_ring[kWarps][2][kRows][32];
  __shared__ Box s_park[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float(*ring)[kRows][32] = s_ring[warp];

  const int subcap = lanes >> 3;
  const int chunks = (subcap + 31) >> 5;   // chunks of 32 lanes a subcell
  // a cube (both modes) decodes and wraps as before the per-axis grid,
  // so its instances compile as they did; an anisotropic grid reads the
  // per-axis counts
  const int nb = grid.n[0];
  const int bx = kAniso ? b / (grid.n[1] * grid.n[2]) : b / (nb * nb);
  const int by = kAniso ? (b / grid.n[2]) % grid.n[1] : (b / nb) % nb;
  const int bz = kAniso ? b % grid.n[2] : b % nb;
  const float* ta = soa_a + static_cast<size_t>(b) * 8 * lanes;
  const float* tb = soa_b + static_cast<size_t>(b) * 8 * lanes;

  float tx = 0.f, ty = 0.f, tz = 0.f, tvx = 0.f, tvy = 0.f, tvz = 0.f;
  float ht = 0.f, trho = 0.f, tpor = 0.f, tc = 0.f, tbal = 0.f;
  int tid = -1;
  bool valid = false, parked = false;   // the two kinds of live target
  if (t < lanes) {
    tx = ta[t];
    ty = ta[lanes + t];
    tz = ta[2 * lanes + t];
    tvx = ta[4 * lanes + t];
    tvy = ta[5 * lanes + t];
    tvz = ta[6 * lanes + t];
    ht = ta[7 * lanes + t];
    trho = tb[t];
    tpor = tb[lanes + t];
    tc = tb[2 * lanes + t];
    tbal = tb[3 * lanes + t];
    if constexpr (!kAbs) tid = idx_e[static_cast<size_t>(b) * lanes + t];
    valid = tb[4 * lanes + t] > 0.f;
    parked = !kAbs && !valid;   // absolute mode: invalid targets get zeros
  }
  const bool live = valid || parked;
  const float hinv_t = glt::inv_or_zero(ht);

  // the boxes of the warp's valid targets (registers) and of its parked
  // targets (shared memory; relative mode only)
  const Box tbox = warp_box(valid, tx, ty, tz, ht);
  const bool any_valid = __any_sync(kFull, valid);
  const bool any_parked = __any_sync(kFull, parked);
  if (any_parked) {
    const Box pbox = warp_box(parked, tx, ty, tz, ht);
    if (lane == 0) s_park[warp] = pbox;
  }
  __syncwarp();

  auto src_block = [&](int g) {
    const int gx = g >> 2, gy = (g >> 1) & 1, gz = g & 1;
    if constexpr (kAniso) {
      return grid.source(bx, by, bz, g);
    } else if constexpr (kAbs) {
      const int nbo = nb + 1;
      return ((bx + gx) * nbo + (by + gy)) * nbo + (bz + gz);
    } else {
      return (glt::wrap(bx + gx, nb) * nb + glt::wrap(by + gy, nb)) * nb +
             glt::wrap(bz + gz, nb);
    }
  };
  auto shifts = [&](int g, float (&sh)[3]) {
    sh[0] = kAbs ? 0.f : static_cast<float>(1 - 2 * (g >> 2)) * lf;
    sh[1] = kAbs ? 0.f : static_cast<float>(1 - 2 * ((g >> 1) & 1)) * lf;
    sh[2] = kAbs ? 0.f : static_cast<float>(1 - 2 * (g & 1)) * lf;
  };

  // the source subcells (bit g * 8 + sk) within reach of each box
  unsigned long long need_valid = 0, need_parked = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int bit = lane + 32 * half;
    const float* q =
        boxes + (static_cast<size_t>(src_block(bit >> 3)) * 8 + (bit & 7)) * 8;
    const float slo[3] = {q[0], q[1], q[2]}, shi[3] = {q[3], q[4], q[5]};
    float sh[3];
    shifts(bit >> 3, sh);
    const bool nv = any_valid && near_boxes<kShift>(tbox, slo, shi, q[6], sh);
    const bool np =
        any_parked && near_boxes<kShift>(s_park[warp], slo, shi, q[6], sh);
    need_valid |= static_cast<unsigned long long>(__ballot_sync(kFull, nv))
                  << (32 * half);
    need_parked |= static_cast<unsigned long long>(__ballot_sync(kFull, np))
                   << (32 * half);
  }
  const unsigned long long warp_need = need_valid | need_parked;

  const float hubble_a2_flow = params[0];
  const float fac_mu = params[1];
  float ax = 0.f, ay = 0.f, az = 0.f, dte = 0.f, msv = 0.f;

  // the chunks this warp walks, in order: (bit = g * 8 + sk, chunk c)
  auto next_bit = [&](int bit) {
    const unsigned long long rest =
        bit >= 63 ? 0ull : warp_need & (~0ull << (bit + 1));
    return rest ? __ffsll(static_cast<long long>(rest)) - 1 : -1;
  };
  auto stage = [&](int bit, int c, int buf) {
    const int q0 = (bit & 7) * subcap + 32 * c;
    if (lane >= min(32, subcap - 32 * c)) return;
    const int src = src_block(bit >> 3);
    const float* s = src16 + static_cast<size_t>(src) * 16 * lanes + q0 + lane;
    for (int r = 0; r < 13; ++r) cp_async4(&ring[buf][r][lane], s + r * lanes);
    if constexpr (!kAbs)
      cp_async4(&ring[buf][13][lane],
                idx_o + static_cast<size_t>(src) * lanes + q0 + lane);
  };

  int bit = warp_need ? __ffsll(static_cast<long long>(warp_need)) - 1 : -1;
  int c = 0, buf = 0;
  if (bit >= 0) stage(bit, 0, 0);
  cp_async_commit();
  while (bit >= 0) {
    int nbit = bit, nc = c + 1;
    if (nc == chunks) {
      nbit = next_bit(bit);
      nc = 0;
    }
    if (nbit >= 0) stage(nbit, nc, buf ^ 1);   // in flight while this sums
    cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();

    const int g = bit >> 3;
    float sh[3];
    shifts(g, sh);
    const float shx = sh[0], shy = sh[1], shz = sh[2];
    const float(*sr)[32] = ring[buf];
    const bool test_valid = (need_valid >> bit) & 1ull;     // warp-uniform
    const bool test_parked = (need_parked >> bit) & 1ull;
    bool near = false;
    if (lane < min(32, subcap - 32 * c) && sr[12][lane] > 0.f) {
      const float s3[3] = {sr[0][lane], sr[1][lane], sr[2][lane]};
      const float hs = sr[7][lane];
      near = (test_valid && near_boxes<kShift>(tbox, s3, s3, hs, sh)) ||
             (test_parked && near_boxes<kShift>(s_park[warp], s3, s3, hs, sh));
    }
    unsigned todo = __ballot_sync(kFull, near);
    if (!live) todo = 0;
    auto pair = [&](int k) {
      const float dx = kAbs ? tx - sr[0][k] : (tx - sr[0][k]) + shx;
      const float dy = kAbs ? ty - sr[1][k] : (ty - sr[1][k]) + shy;
      const float dz = kAbs ? tz - sr[2][k] : (tz - sr[2][k]) + shz;
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
      const float r = r2 * rinv;
      const float hs = sr[7][k];
      if (!(r < fmaxf(ht, hs))) return;
      if constexpr (kAbs) {
        if (!(r > 0.f)) return;  // the self-pair
      } else {
        if (tid == __float_as_int(sr[13][k])) return;  // the self-pair
      }
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
    bit = nbit;
    c = nc;
    buf ^= 1;
  }
  if (t < lanes) {
    o[t] = ax;
    o[lanes + t] = ay;
    o[2 * lanes + t] = az;
    o[3 * lanes + t] = dte;
    o[4 * lanes + t] = msv;
  }
}

int threads_for(int lanes) {
  return lanes < kThreads ? ((lanes + 31) / 32) * 32 : kThreads;
}

int launch(bool abs, const float* soa_a, const float* soa_b,
           const float* src16, const int* idx_e, const int* idx_o,
           const int* flags, const float* params, float* boxes, float* out,
           const int (&n)[3], int per, int lanes, float lf, float half_visc,
           cudaStream_t st) {
  const int threads = threads_for(lanes);
  const dim3 grid(n[0] * n[1] * n[2], (lanes + threads - 1) / threads);
  const glt::BlockGrid g{{n[0], n[1], n[2]}, per};
  glt::launch_boxes<16, 12, 7>(src16, boxes, glt::odd_blocks_of(n, per),
                               lanes, lanes / 8, st);
  if (abs)   // the clamped cube of a vacuum grid
    sph_hydro_kernel<true, false><<<grid, threads, 0, st>>>(
        soa_a, soa_b, src16, nullptr, nullptr, flags, params, boxes, out, g,
        lanes, 0.f, half_visc);
  else if (per == 7 && n[0] == n[1] && n[1] == n[2])   // a periodic cube
    sph_hydro_kernel<false, false><<<grid, threads, 0, st>>>(
        soa_a, soa_b, src16, idx_e, idx_o, flags, params, boxes, out, g,
        lanes, lf, half_visc);
  else   // an anisotropic grid (the slab's)
    sph_hydro_kernel<false, true><<<grid, threads, 0, st>>>(
        soa_a, soa_b, src16, idx_e, idx_o, flags, params, boxes, out, g,
        lanes, lf, half_visc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int glt_sph_hydro(const float* soa_a, const float* soa_b,
                             const float* src16, const int* idx_e,
                             const int* idx_o, const int* flags,
                             const float* params, float* boxes, float* out,
                             int nb, int lanes, float lf, float half_visc,
                             void* stream) {
  return launch(false, soa_a, soa_b, src16, idx_e, idx_o, flags, params,
                boxes, out, {nb, nb, nb}, 7, lanes, lf, half_visc,
                static_cast<cudaStream_t>(stream));
}

extern "C" int glt_sph_hydro_abs(const float* soa_a, const float* soa_b,
                                 const float* src16, const int* flags,
                                 const float* params, float* boxes,
                                 float* out, int nb, int lanes,
                                 float half_visc, void* stream) {
  return launch(true, soa_a, soa_b, src16, nullptr, nullptr, flags, params,
                boxes, out, {nb, nb, nb}, 0, lanes, 0.f, half_visc,
                static_cast<cudaStream_t>(stream));
}

// relative mode on per-axis block counts; bit a of per set where axis a
// wraps (the slab's grid: 6)
extern "C" int glt_sph_hydro_aniso(const float* soa_a, const float* soa_b,
                                   const float* src16, const int* idx_e,
                                   const int* idx_o, const int* flags,
                                   const float* params, float* boxes,
                                   float* out, int nbx, int nby, int nbz,
                                   int per, int lanes, float lf,
                                   float half_visc, void* stream) {
  return launch(false, soa_a, soa_b, src16, idx_e, idx_o, flags, params,
                boxes, out, {nbx, nby, nbz}, per, lanes, lf, half_visc,
                static_cast<cudaStream_t>(stream));
}
