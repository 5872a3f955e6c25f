// Kernel C: SPH density sums over block tiles.
//
// Replaces gadget_leicester_tpu/ops/sph_blocks.py :: density_sums_blocks
// (kernel body _make_density_block_kernel) in both its modes: block-
// relative on a periodic grid (C entry glt_sph_density) and absolute on a
// clamped (vacuum) grid (relative=False there; C entry
// glt_sph_density_abs), and the relative mode on the anisotropic block grid
// of a slab (per-axis block counts and periodicity, fine_edge given:
// gadget_leicester_tpu/parallel/spmd.py :: _sph_blocks; C entry
// glt_sph_density_aniso). Plain PyTorch twin: ops/sph_blocks.py ::
// density_sums_blocks_plain.
//
// What it computes. soa_e / soa_o are the even [B, 8, lanes] and odd
// [Bo, 8, lanes] packs of ops/sph_blocks.py :: pack_sph_soa (rows x, y,
// z, m, vx, vy, vz, h; parked slots with m = 0). For each target slot of
// an even block b whose flag is set, over the 8 odd source blocks
// b + {0,1}^3:
//   rho = sum m W(r, h_i),  drho/dh = sum m dW/dh,
//   div = -sum m dW/dr / r (dv . dx),  rot = sum m dW/dr / r (dv x dx),
// over the sources with m > 0 and u = r / h_i < 1 (glt::density_pair).
// Relative mode: x, y, z relative to the block centre, Bo = B = nb^3, the
// source blocks wrap mod nb and dx = (t - s) + (1 - 2g) * Lf per axis;
// every target lane is summed, the parked ones too (-7 fine cells from
// their block centre, with whatever h the caller passes them). On a slab's
// grid, (nbx, nb, nb) blocks clamped along x, the ids wrap along y and z
// only, the odd grid has nbx + 1 blocks along x and dx is the same
// expression (glt::BlockGrid; kernel D's note). Absolute
// mode: absolute x, y, z, Bo = (nb+1)^3 with no wrap, dx = t - s; a parked
// slot's position (-7 fine cells) may lie inside the cloud, so a source is
// skipped by its mass, never by its distance, and a target that is parked
// or has h = 0 (the Newton loop passes 0 for slots it does not solve)
// writes zeros. The 8-block stencil is complete because the caller caps h
// at (1 - 2 kappa) times the fine-cell edge. A block whose flag is 0
// writes zeros. out is [B, 6, lanes].
//
// What bounds it on the card. Pairs: at 2x128^3, B = 22^3 and lanes = 256,
// 8 * 256 * 256 pairs per block, 3.3e9 live pairs per sweep, 1.9% of them
// inside h_i; a pair inside costs about 73 float32 operations, every pair
// walked the distance test; the Newton loop runs 2-3 sweeps per sync point
// (later sweeps only on blocks with unconverged targets). Bound by
// instruction issue and by divergence at the support edge, not by bytes.
// A vacuum disc fills few blocks, each with a few dense subcells: subcap
// grows to hundreds of slots, most of them parked.
//
// What the design does about it: kernel D's (csrc/sph_hydro.cu), with the
// density's support, the target's h alone.
// - The subcell skip. A first kernel (glt::subcell_boxes_kernel, shared
//   with D) writes, for each of the Bo x 8 source subcells, the bounding
//   box of its sources with m > 0. A warp skips source subcell (g, sk)
//   when the distance from its targets' box to that box is at least its
//   reach (1 + 1e-5), the reach being the warp's largest target h: the
//   test of a pair on boxes that contain both ends, exact for any input.
//   A target whose 1/h is 0 (h not above 0, or infinite:
//   glt::inv_or_zero) adds only zeros, so what its h reaches does not
//   change its sums. Invalid targets write zeros in absolute mode. In
//   relative mode a warp keeps a second box for its parked targets (m =
//   0), and walks what lies within reach of either box, so even their rows
//   stay the plain's.
// - Warps stand alone. Lanes are subcell * subcap + rank, so with subcap a
//   multiple of 32 (32 at 2x128^3, 64 and 512 on vacuum grids) a warp is
//   one target fine cell (or part of one); otherwise its box spans the
//   fine cells of its lanes. Each warp stages its own chunks of 32 source
//   lanes (7 rows: x, y, z, m, vx, vy, vz), double-buffered with cp.async,
//   only for the subcells it needs, from L2.
// - Warp-uniform culling within the walked subcells: each lane tests its
//   chunk's source against the warp's boxes, and a ballot keeps the
//   sources with m > 0 whose box distance is below the reach (1 + 1e-5).
//   The box distance per axis is taken as dx is, (lo - s) + shift and (hi
//   - s) + shift, monotone in both coordinates, so in float32 it is never
//   above |dx|; the 1e-5 covers the rounding of r = r2 rsqrt(r2), of the
//   squares and of u = r (1/h). A culled source has u >= 1 for every lane
//   of the warp, which the earlier design's density_pair left without
//   adding.
// - The order of sums is kept: each target adds its pairs g = 0..7, then
//   source lane ascending, skipping only pairs the earlier design skipped
//   (m = 0 or u >= 1), with the earlier design's pair arithmetic
//   (glt::density_pair on the same expressions); the warp walks the kept
//   sources two at a time where there are two, so that the two pairs'
//   arithmetic can overlap. Built with -fmad=false, C equals its earlier
//   design (one thread per target walking every staged source) bit for
//   bit in both modes; with nvcc's default contraction into FMAs its rows
//   may differ in their last bits. No compaction of inside pairs.
// - The boxes go to a workspace of Bo x 64 floats that the caller
//   allocates.
// nvcc 12.8 -Xptxas=-v for sm_90a: 61 registers relative on a cube, 63 on
// an anisotropic grid (glt::BlockGrid), 58 absolute,
// 14,560 bytes of shared memory a block of 256 threads; the subcell boxes
// 32 registers.

#include "glt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 7;   // soa_o rows x, y, z, m, vx, vy, vz

template <bool kAbs, bool kAniso>
__global__ void __launch_bounds__(kThreads)
    sph_density_kernel(const float* __restrict__ soa_e,
                       const float* __restrict__ soa_o,
                       const float* __restrict__ h,
                       const int* __restrict__ flags,
                       const float* __restrict__ boxes,
                       float* __restrict__ out, glt::BlockGrid grid,
                       int lanes, float lf) {
  constexpr glt::Shift kShift = kAbs ? glt::Shift::kNone : glt::Shift::kPair;
  const int b = blockIdx.x;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  float* o = out + static_cast<size_t>(b) * 6 * lanes;
  if (flags[b] == 0) {
    if (t < lanes)
      for (int r = 0; r < 6; ++r) o[r * lanes + t] = 0.f;
    return;
  }
  __shared__ float s_ring[kWarps][2][kRows][32];
  __shared__ glt::Box s_park[kWarps];
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
  const float* tile = soa_e + static_cast<size_t>(b) * 8 * lanes;

  float tx = 0.f, ty = 0.f, tz = 0.f, tvx = 0.f, tvy = 0.f, tvz = 0.f;
  float ht = 0.f, hinv = 0.f;
  bool valid = false, parked = false;   // the two kinds of live target
  if (t < lanes) {
    tx = tile[t];
    ty = tile[lanes + t];
    tz = tile[2 * lanes + t];
    tvx = tile[4 * lanes + t];
    tvy = tile[5 * lanes + t];
    tvz = tile[6 * lanes + t];
    ht = h[static_cast<size_t>(b) * lanes + t];
    hinv = glt::inv_or_zero(ht);
    const bool massive = tile[3 * lanes + t] > 0.f;
    if constexpr (kAbs) {
      valid = massive && hinv > 0.f;   // others write zeros
    } else {
      valid = massive;
      parked = !massive;
    }
  }
  const bool live = valid || parked;

  // the boxes of the warp's valid targets (registers) and of its parked
  // targets (shared memory; relative mode only)
  const glt::Box tbox = glt::warp_box(valid, tx, ty, tz, ht);
  const bool any_valid = __any_sync(glt::kFull, valid);
  const bool any_parked = __any_sync(glt::kFull, parked);
  if (any_parked) {
    const glt::Box pbox = glt::warp_box(parked, tx, ty, tz, ht);
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
    const bool nv =
        any_valid && glt::near_boxes<kShift>(tbox, slo, shi, 0.f, sh);
    const bool np =
        any_parked && glt::near_boxes<kShift>(s_park[warp], slo, shi, 0.f, sh);
    need_valid |= static_cast<unsigned long long>(__ballot_sync(glt::kFull, nv))
                  << (32 * half);
    need_parked |=
        static_cast<unsigned long long>(__ballot_sync(glt::kFull, np))
        << (32 * half);
  }
  const unsigned long long warp_need = need_valid | need_parked;

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  // the chunks this warp walks, in order: (bit = g * 8 + sk, chunk c)
  auto next_bit = [&](int bit) {
    const unsigned long long rest =
        bit >= 63 ? 0ull : warp_need & (~0ull << (bit + 1));
    return rest ? __ffsll(static_cast<long long>(rest)) - 1 : -1;
  };
  auto stage = [&](int bit, int c, int buf) {
    const int q0 = (bit & 7) * subcap + 32 * c;
    if (lane >= min(32, subcap - 32 * c)) return;
    const float* s = soa_o + static_cast<size_t>(src_block(bit >> 3)) * 8 *
                                 lanes + q0 + lane;
    for (int r = 0; r < kRows; ++r)
      glt::cp_async4(&ring[buf][r][lane], s + r * lanes);
  };

  int bit = warp_need ? __ffsll(static_cast<long long>(warp_need)) - 1 : -1;
  int c = 0, buf = 0;
  if (bit >= 0) stage(bit, 0, 0);
  glt::cp_async_commit();
  while (bit >= 0) {
    int nbit = bit, nc = c + 1;
    if (nc == chunks) {
      nbit = next_bit(bit);
      nc = 0;
    }
    if (nbit >= 0) stage(nbit, nc, buf ^ 1);   // in flight while this sums
    glt::cp_async_commit();
    glt::cp_async_wait_prior();
    __syncwarp();

    float sh[3];
    shifts(bit >> 3, sh);
    const float shx = sh[0], shy = sh[1], shz = sh[2];
    const float(*sr)[32] = ring[buf];
    const bool test_valid = (need_valid >> bit) & 1ull;     // warp-uniform
    const bool test_parked = (need_parked >> bit) & 1ull;
    bool near = false;
    if (lane < min(32, subcap - 32 * c) && sr[3][lane] > 0.f) {
      const float s3[3] = {sr[0][lane], sr[1][lane], sr[2][lane]};
      near = (test_valid && glt::near_boxes<kShift>(tbox, s3, s3, 0.f, sh)) ||
             (test_parked &&
              glt::near_boxes<kShift>(s_park[warp], s3, s3, 0.f, sh));
    }
    unsigned todo = __ballot_sync(glt::kFull, near);
    if (!live) todo = 0;
    // the earlier design's call, on the same expressions
    auto pair = [&](int k) {
      if constexpr (kAbs)
        glt::density_pair(tx - sr[0][k], ty - sr[1][k], tz - sr[2][k],
                          tvx - sr[4][k], tvy - sr[5][k], tvz - sr[6][k],
                          sr[3][k], hinv, acc);
      else
        glt::density_pair((tx - sr[0][k]) + shx, (ty - sr[1][k]) + shy,
                          (tz - sr[2][k]) + shz, tvx - sr[4][k],
                          tvy - sr[5][k], tvz - sr[6][k], sr[3][k], hinv,
                          acc);
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
#pragma unroll
    for (int r = 0; r < 6; ++r) o[r * lanes + t] = acc[r];
  }
}

int threads_for(int lanes) {
  return lanes < kThreads ? ((lanes + 31) / 32) * 32 : kThreads;
}

int launch(bool abs, const float* soa_e, const float* soa_o, const float* h,
           const int* flags, float* boxes, float* out, const int (&n)[3],
           int per, int lanes, float lf, cudaStream_t st) {
  const int threads = threads_for(lanes);
  const dim3 grid(n[0] * n[1] * n[2], (lanes + threads - 1) / threads);
  const glt::BlockGrid g{{n[0], n[1], n[2]}, per};
  glt::launch_boxes<8, 3, -1>(soa_o, boxes, glt::odd_blocks_of(n, per), lanes,
                              lanes / 8, st);
  if (abs)   // the clamped cube of a vacuum grid
    sph_density_kernel<true, false><<<grid, threads, 0, st>>>(
        soa_e, soa_o, h, flags, boxes, out, g, lanes, 0.f);
  else if (per == 7 && n[0] == n[1] && n[1] == n[2])   // a periodic cube
    sph_density_kernel<false, false><<<grid, threads, 0, st>>>(
        soa_e, soa_o, h, flags, boxes, out, g, lanes, lf);
  else   // an anisotropic grid (the slab's)
    sph_density_kernel<false, true><<<grid, threads, 0, st>>>(
        soa_e, soa_o, h, flags, boxes, out, g, lanes, lf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int glt_sph_density(const float* soa_e, const float* soa_o,
                               const float* h, const int* flags, float* boxes,
                               float* out, int nb, int lanes, float lf,
                               void* stream) {
  return launch(false, soa_e, soa_o, h, flags, boxes, out, {nb, nb, nb}, 7,
                lanes, lf, static_cast<cudaStream_t>(stream));
}

extern "C" int glt_sph_density_abs(const float* soa_e, const float* soa_o,
                                   const float* h, const int* flags,
                                   float* boxes, float* out, int nb,
                                   int lanes, void* stream) {
  return launch(true, soa_e, soa_o, h, flags, boxes, out, {nb, nb, nb}, 0,
                lanes, 0.f, static_cast<cudaStream_t>(stream));
}

// relative mode on per-axis block counts; bit a of per set where axis a
// wraps (the slab's grid: 6)
extern "C" int glt_sph_density_aniso(const float* soa_e, const float* soa_o,
                                     const float* h, const int* flags,
                                     float* boxes, float* out, int nbx,
                                     int nby, int nbz, int per, int lanes,
                                     float lf, void* stream) {
  return launch(false, soa_e, soa_o, h, flags, boxes, out, {nbx, nby, nbz},
                per, lanes, lf, static_cast<cudaStream_t>(stream));
}
