// Kernel M: short-range gravity per cell over its 27 neighbours, in
// absolute coordinates with the per-pair minimum image.
//
// Replaces gadget_leicester_tpu/ops/pallas_cells.py ::
// shortrange_gravity_pallas (kernel body _make_kernel). Plain PyTorch twin:
// ops/gravity_short.py :: shortrange_gravity_cells_plain.
//
// The same source hosts kernel A's slab mode (C entry
// glt_shortrange_gravity_slab): gadget_leicester_tpu/ops/pallas_cells.py ::
// shortrange_gravity_pallas_dma9 with a tuple n_cells = (nx, nyz, nyz),
// periodic = (False, True, True), absolute coordinates and a prebuilt cell
// list, as parallel/spmd.py :: _gravity calls it. Plain PyTorch twin:
// ops/gravity_short.py :: shortrange_gravity_slab_plain. Why M's kernel and
// not A's: A works on the cell-relative pack of a cubic periodic grid, where
// a stencil cell's offset is one shift per tile; the slab's pack is
// absolute (its ghosts' x is already mapped into the slab's frame, and y, z
// wrap), which is M's pack and M's per-pair minimum image. The mode is M's
// kernel with three generalisations, each a no-op on M's own calls:
// - per-axis cell counts (nx, ny, nz); M passes (n, n, n);
// - a per-axis image mask kPer (bit a set: axis a periodic), a template
//   argument: the minimum image, the wrap of the stencil and the box test's
//   nearest multiple of the box are taken on the axes of the mask only, so
//   the slab's clamped x takes no image (a ghost's x was mapped onto the
//   slab's face, and an image of it along x would be a second copy), and a
//   stencil cell beyond a clamped face adds nothing (the TPU kernel's inb
//   mask, which keeps a clamped DMA from counting the edge column twice);
//   M instantiates 7 and 0, the slab 6;
// - tile flags: a cell whose flag is 0 writes zeros and does nothing else,
//   as A's dense tier gates its tiles by the step's activity (the TPU slab
//   call passes active=None and masks afterwards; the results agree, as
//   the step keeps an inactive particle's acc). M passes no flags.
// - the potential (kPot, C entry glt_shortrange_gravity_slab_pot): the
//   reference's with_potential=True on the same call (parallel/spmd.py
//   :888-898), for the in-step potential that sinks and Stamatellos cooling
//   read on slabs. A fourth output row holds, for each target slot, the
//   erfc-truncated softened potential m_j grav_pot(r, max(h_i, h_j))
//   erfc(r / (2 asmth)), summed over the same pairs and in the same order as
//   its force rows, with H's arithmetic (glt::gravity_potential_pair) in
//   explicitly rounded operations apart from the force's (pot_pair); the
//   self-pair (r2 == 0 on the same slot) adds nothing, as in H. The force's
//   instructions are the force-only mode's, so rows 0-2 equal it bit for
//   bit.
//   Instantiated for the slab's masks 6 (periodic) and 0 (vacuum), with
//   at most 64 registers (8 blocks an SM: the fourth accumulator and the
//   erfc polynomial) where the force-only mode keeps 56.
// Where the slab differs from a cube: nx may be 1 or 2 (a clamped axis
// never meets a cell twice), nx != nyz, a target on the slab's face at
// float32 x == x1 is a pair like any other (the grid clamps it into the
// last cell, no image is taken), and a ghost's x lies outside [x0, x1) by
// construction. The TPU kernel's test is r2 < rcut^2, this one's M's r <
// rcut (exact after the rsqrt); a pair at rcut to the last ulp may differ,
// where the truncated force is 1.5e-3 of its untruncated value.
//
// What it computes. soa is the [C, 8, cap] ABSOLUTE pack of ops/cells.py ::
// pack_cells_abs (rows x, y, z as the particles hold them, m, soft, 1,
// 1/soft, 0; parked slots with m = 0). For every packed target slot it
// sums, over the 27 cells around its cell,
//   -m_j * g(r, max(h_i, h_j)) * trunc(r / (2 asmth)) * dx
// over the pairs with 0 < r < rcut, where on a periodic grid each component
// of dx is reduced PER PAIR to its minimum image dx - box * round(dx / box).
// On a clamped (vacuum) grid nothing is reduced and a stencil cell beyond
// the grid adds nothing. half_inv_asmth == 0 switches the truncation off
// (plain softened gravity). The self-pair leaves by r > 0: target and
// source are the same pack slot, so dx is 0 bit for bit before and after
// the minimum image. out is [C, 3, cap] (ax, ay, az, without the factor G).
//
// Why the minimum image stays per pair. A whole-tile +-box shift (kernels
// I-K) needs every slot of a tile to lie inside that tile's cell; a
// particle whose float32 coordinate equals the box is filed in cell 0 a
// box away from its neighbours, and a tile shift loses them. The per-pair
// reduction is immune to where a coordinate was wrapped, at a multiply, a
// round and an FMA per axis and pair.
//
// What bounds it on the card. At 2x128^3 on the potential pass's grid (34^3
// cells of 128 slots) the stencil holds 1.2e10 pairs, 15% of them inside
// rcut. The earlier design (kernel A's before its redesign: one thread a
// target slot, tiles staged in shared memory, no culling) paid the whole
// pair arithmetic, the minimum image and the exact r < rcut test after
// the rsqrt included, for every source whenever one of a warp's 32
// targets was within reach: 25.849 ms against a bound of 1.777 ms
// (operations), bound by instruction issue and the latency of the pair
// arithmetic's dependent chain, as A was (PERF.md section 6).
//
// What the design does about it: kernel A's (csrc/shortrange_gravity.cu),
// on the absolute pack.
// - Targets in space order. A thread block is one cell, one thread a
//   target slot, in passes of 128 slots for a cell of more (a fresh list
//   may hold 256). Each pass ranks its live slots by a Morton key over the
//   box of the pass's live slots (glt::rank_by_box: the absolute pack has
//   no cell centre at 0), parked slots last, so each warp holds 32 close
//   targets, and takes their bounding box.
// - Warp-uniform culling, torus-aware. The stencil is the list of its
//   cells that lie on the grid (all 27 on a periodic one; on a clamped
//   one those inside, the same for the whole block). For each staged
//   chunk of sources every lane tests one source s against its warp's box
//   [lo, hi]; a ballot gives those within rcut of it, and the warp walks
//   only those, in slot order, two at a time where there are two. On a
//   periodic grid the test may not shift the tile (see above): per axis,
//   every dx = t - s of the box lies in [l, u] = [lo - s, hi - s] (float32
//   rounding is monotone), and the test takes the distance of that
//   interval from the nearest multiple of the box, k box for k = k0 - 1,
//   k0, k0 + 1 with k0 = rint(mid / box). Where u - l < box / 2, a pair's
//   reduced dx - box rint(dx / box) has k within 1 of k0, so its |minimum
//   image| is never below that distance; a wider interval (a warp that
//   holds a slot at x = box, filed in cell 0 beside slots near x = 0)
//   counts as distance 0. The reduction itself is exact where it matters:
//   k box is exact for |k| <= 2, and dx - k box is exact (Sterbenz) for
//   |dx| >= box / 2, where k = +-1; even half an ulp of the box, 1.9e-6 at
//   box 50, would sit well inside the margin of rcut^2 (1 + 2e-5), about
//   1.5e-5 at rcut 1.465. So the margin covers only the rounding of the
//   sum of squares, as in A, and a dropped source is one that the pair
//   arithmetic would have added nothing for, for every target of the
//   warp. On a clamped grid the test is A's, with no image. With rcut =
//   1e30 its square is clamped to the largest float and the culling bound
//   is inf: nothing is culled and nothing turns NaN.
// - The order of sums is kept: each target adds its pairs stencil cell j
//   = 0..26 (those on the grid), then slot k = 0..cap-1, skipping only
//   pairs that add nothing, so M equals its earlier design bit for bit
//   (PERF.md section 6 says with which flags).
// - Staging through registers, double-buffered, as A: the stencil's cells
//   are one stream of n_src * cap sources in chunks of one slot a thread,
//   each thread loading its slot of the next chunk while the warp sums the
//   current one.
// - At most 56 registers (__launch_bounds__ with 9 blocks an SM): the
//   periodic instantiation takes 63 without it, and 8 blocks an SM were
//   1.07x the time (PERF.md section 6).
// On phase 12's arguments (34^3 cells of 128 slots) the model of this walk
// (chip_smoke.gravity_cells_walk) evaluates 54.9% of the stencil pairs,
// and M took 21.08 ms against the earlier design's 25.58-25.76, in turns
// on an H100 (PERF.md section 6); what is left is the pair arithmetic of
// the evaluated pairs, dearer than A's by the minimum image and the exact
// r < rcut test. -Xptxas=-v for sm_90a: 56 registers in each instance (7,
// 6, 0), 7,392
// bytes of shared memory a block of 128 threads, no spills.

#include <cfloat>

#include "glt_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 9;   // at most 56 registers, as kernel A
// the potential mode's fourth accumulator and its polynomial: 8 blocks an
// SM (at most 64 registers), so that nothing spills
constexpr int kBlocksPerSmPot = 8;
using glt::kFull;

// The potential factor of a pair for kPot: glt::grav_pot_nodiv times
// glt::erfc_p10 (H's arithmetic), in explicitly rounded operations
// (__fmul_rn, __fmaf_rn) that the compiler fuses with nothing.
__device__ __forceinline__ float pot_factor_rn(float r, float rinv, float h,
                                               float hinv,
                                               float half_inv_asmth) {
  const float u = __fmul_rn(r, hinv);
  const float u2 = __fmul_rn(u, u);
  float phi;
  if (u < 0.5f) {
    float t = __fmaf_rn(6.4f, u, -9.6f);
    t = __fmaf_rn(u2, t, 5.333333333333f);
    phi = __fmul_rn(hinv, __fmaf_rn(u2, t, -2.8f));
  } else if (u < 1.0f) {
    float t = __fmaf_rn(-2.133333333333f, u, 9.6f);
    t = __fmaf_rn(u, t, -16.0f);
    t = __fmaf_rn(u, t, 10.666666666667f);
    const float lin = __fmaf_rn(0.066666666667f, __fmul_rn(h, rinv), -3.2f);
    phi = __fmul_rn(hinv, __fmaf_rn(u2, t, lin));
  } else {
    phi = -rinv;
  }
  if (!(half_inv_asmth > 0.f)) return phi;
  const float x = fminf(__fmul_rn(r, half_inv_asmth), 2.25f);
  float p = -0.000708430614f;
  p = __fmaf_rn(p, x, 0.0086528472f);
  p = __fmaf_rn(p, x, -0.0418223107f);
  p = __fmaf_rn(p, x, 0.0932881235f);
  p = __fmaf_rn(p, x, -0.0643211737f);
  p = __fmaf_rn(p, x, -0.0737919465f);
  p = __fmaf_rn(p, x, -0.0145173017f);
  p = __fmaf_rn(p, x, 0.379212313f);
  p = __fmaf_rn(p, x, -0.000326738866f);
  p = __fmaf_rn(p, x, -1.1283663f);
  p = __fmaf_rn(p, x, 0.999999923f);
  return __fmul_rn(phi, p);
}

// The earlier design's pair arithmetic, unchanged: the pull of source (q,
// hq) = (x, y, z, m), (soft, 1/soft) on target (tx, ty, tz) with (th,
// thinv), per-pair minimum image on the axes of kPer.
template <int kPer>
__device__ __forceinline__ void cells_pair(float tx, float ty, float tz,
                                           float th, float thinv,
                                           const float4& q, const float2& hq,
                                           float box, float inv_box,
                                           float half_inv_asmth, float rcut,
                                           float rcut2_up, float& ax,
                                           float& ay, float& az) {
  float dx = tx - q.x;
  float dy = ty - q.y;
  float dz = tz - q.z;
  if constexpr ((kPer & 1) != 0) dx = dx - box * rintf(dx * inv_box);
  if constexpr ((kPer & 2) != 0) dy = dy - box * rintf(dy * inv_box);
  if constexpr ((kPer & 4) != 0) dz = dz - box * rintf(dz * inv_box);
  const float r2 = dx * dx + dy * dy + dz * dz;
  if (!(r2 < rcut2_up && r2 > 0.f)) return;
  const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
  const float r = r2 * rinv;
  if (!(r < rcut && r > 0.f)) return;
  const float hh = fmaxf(th, hq.x);
  const float hhinv = fminf(thinv, hq.y);
  float fac = glt::grav_fac_nodiv(r, rinv, hh, hhinv);
  if (half_inv_asmth > 0.f)
    fac = fac * glt::trunc_p10(fminf(r * half_inv_asmth, 2.25f));
  const float w = q.w * fac;
  ax -= w * dx;
  ay -= w * dy;
  az -= w * dz;
}

// The potential of the same pair for kPot (A's slab mode with the
// potential): its separation, the cut and the factor again, from the loaded
// target and source, in explicitly rounded operations, and added to pot.
// It shares no intermediate value with cells_pair: with the potential
// folded into cells_pair (reusing its r, 1/r and softenings, with plain or
// rounded operations, branchy or branch-free), the force rows differed from
// the force-only mode's in the last bits on an H100 (nvcc 12), at pairs
// inside the softening: the compiler laid out the softened branch
// differently. Apart, the force compiles as in the force-only mode and its
// rows are equal bit for bit.
template <int kPer>
__device__ __forceinline__ void pot_pair(float tx, float ty, float tz,
                                         float th, float thinv,
                                         const float4& q, const float2& hq,
                                         float box, float inv_box,
                                         float half_inv_asmth, float rcut,
                                         float rcut2_up, float& pot) {
  float dx = __fsub_rn(tx, q.x);
  float dy = __fsub_rn(ty, q.y);
  float dz = __fsub_rn(tz, q.z);
  if constexpr ((kPer & 1) != 0)
    dx = __fmaf_rn(-box, rintf(__fmul_rn(dx, inv_box)), dx);
  if constexpr ((kPer & 2) != 0)
    dy = __fmaf_rn(-box, rintf(__fmul_rn(dy, inv_box)), dy);
  if constexpr ((kPer & 4) != 0)
    dz = __fmaf_rn(-box, rintf(__fmul_rn(dz, inv_box)), dz);
  const float r2 = __fmaf_rn(dx, dx, __fmaf_rn(dy, dy, __fmul_rn(dz, dz)));
  const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
  const float r = __fmul_rn(r2, rinv);
  const bool ok = r2 < rcut2_up && r2 > 0.f && r < rcut && r > 0.f;
  const float f = pot_factor_rn(r, rinv, fmaxf(th, hq.x), fminf(thinv, hq.y),
                                half_inv_asmth);
  pot = ok ? __fmaf_rn(q.w, f, pot) : pot;
}

// The distance of the interval [l, u] of dx on one axis from the nearest
// multiple of the box (kPeriodic), or from 0.
template <bool kPeriodic>
__device__ __forceinline__ float image_gap(float l, float u, float box,
                                           float inv_box) {
  if constexpr (!kPeriodic) {
    return fmaxf(fmaxf(l, -u), 0.f);
  } else {
    // an interval of half the box or more (a pass that holds a slot at x
    // = box, filed with those near x = 0) is taken to reach a multiple
    if (!(u - l < 0.5f * box)) return 0.f;
    const float kb = rintf(0.5f * (l + u) * inv_box) * box;
    float e = fmaxf(fmaxf(l - kb, kb - u), 0.f);
    e = fminf(e, fmaxf(fmaxf(l - (kb - box), (kb - box) - u), 0.f));
    return fminf(e, fmaxf(fmaxf(l - (kb + box), (kb + box) - u), 0.f));
  }
}

template <int kPer, bool kPot>
__global__ void __launch_bounds__(kThreads,
                                  kPot ? kBlocksPerSmPot : kBlocksPerSm)
    shortrange_gravity_cells_kernel(const float* __restrict__ soa,
                                    const int* __restrict__ flags,
                                    float* __restrict__ out, int nx, int ny,
                                    int nz, int cap, float box,
                                    float half_inv_asmth, float rcut,
                                    float rcut2_up, float cull2) {
  __shared__ float4 s_pos[2][kThreads];   // x, y, z; m
  __shared__ float2 s_soft[2][kThreads];  // soft, 1/soft
  __shared__ unsigned s_key[kThreads];
  __shared__ int s_slot[kThreads];
  __shared__ glt::Box s_box[kThreads / 32];
  __shared__ int s_src[27];
  __shared__ int s_nsrc;

  constexpr int kRowsOut = kPot ? 4 : 3;
  const int c = blockIdx.x;
  float* o = out + static_cast<size_t>(c) * kRowsOut * cap;
  if (flags != nullptr && flags[c] == 0) {   // a gated tile: zeros
    for (int t = threadIdx.x; t < cap; t += blockDim.x) {
#pragma unroll
      for (int r = 0; r < kRowsOut; ++r) o[r * cap + t] = 0.f;
    }
    return;
  }
  const int nt = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int cx = c / (ny * nz), cy = (c / nz) % ny, cz = c % nz;
  const float* tile = soa + static_cast<size_t>(c) * 8 * cap;
  const float inv_box = kPer != 0 ? 1.0f / box : 0.f;

  // the stencil's cells on the grid, in order j = 0..26: wrapped along the
  // axes of kPer, those beyond a clamped face left out
  if (threadIdx.x < 32) {
    const int j = lane;
    int sx = cx + j / 9 - 1, sy = cy + (j / 3) % 3 - 1, sz = cz + j % 3 - 1;
    bool on = j < 27;
    if constexpr ((kPer & 1) != 0) sx = glt::wrap(sx, nx);
    else on = on && sx >= 0 && sx < nx;
    if constexpr ((kPer & 2) != 0) sy = glt::wrap(sy, ny);
    else on = on && sy >= 0 && sy < ny;
    if constexpr ((kPer & 4) != 0) sz = glt::wrap(sz, nz);
    else on = on && sz >= 0 && sz < nz;
    const unsigned mask = __ballot_sync(kFull, on);
    if (on)
      s_src[__popc(mask & ((1u << lane) - 1u))] = (sx * ny + sy) * nz + sz;
    if (lane == 0) s_nsrc = __popc(mask);
  }
  __syncthreads();
  const int total = s_nsrc * cap;
  const int steps = (total + nt - 1) / nt;

  // source u of the stream (stencil cell s_src[u / cap], slot u % cap; m
  // = 0 past the stream's end)
  auto fetch = [&](int u, float4& p, float2& h) {
    p = make_float4(0.f, 0.f, 0.f, 0.f);
    h = make_float2(0.f, 0.f);
    if (u >= total) return;
    const int j = u / cap, k = u - j * cap;
    const float* s = soa + static_cast<size_t>(s_src[j]) * 8 * cap;
    p = make_float4(s[k], s[cap + k], s[2 * cap + k], s[3 * cap + k]);
    h = make_float2(s[4 * cap + k], s[6 * cap + k]);
  };

  for (int t0 = 0; t0 < cap; t0 += nt) {
    // 1. rank this pass's slots: live ones by Morton key over their box,
    // parked ones last
    {
      const int t = t0 + threadIdx.x;
      const bool in = t < cap && tile[5 * cap + t] > 0.f;
      glt::rank_by_box(in, in ? tile[t] : 0.f, in ? tile[cap + t] : 0.f,
                       in ? tile[2 * cap + t] : 0.f, t, s_box, s_key, s_slot);
    }
    const int ts = s_slot[threadIdx.x];   // the slot this thread sums for
    const bool live = ts < cap && tile[5 * cap + ts] > 0.f;
    float tx = 0.f, ty = 0.f, tz = 0.f, th = 0.f, thinv = 0.f;
    if (live) {
      tx = tile[ts];
      ty = tile[cap + ts];
      tz = tile[2 * cap + ts];
      th = tile[4 * cap + ts];
      thinv = tile[6 * cap + ts];
    }
    // 2. the warp's box (empty for a warp of parked slots)
    const glt::Box wb = glt::warp_box(live, tx, ty, tz, 0.f);
    const bool warp_live = __any_sync(kFull, live);

    // 3. the stream of the stencil's sources in chunks of nt,
    // double-buffered (none for a pass of parked slots: uniform in the
    // block)
    float ax = 0.f, ay = 0.f, az = 0.f, pot = 0.f;
    float4 p;
    float2 h;
    const bool any_live = __syncthreads_or(live) != 0;
    if (any_live) {
      fetch(threadIdx.x, p, h);
      s_pos[0][threadIdx.x] = p;
      s_soft[0][threadIdx.x] = h;
    }
    __syncthreads();
    auto pair = [&](const float4& q, const float2& hq) {
      cells_pair<kPer>(tx, ty, tz, th, thinv, q, hq, box, inv_box,
                       half_inv_asmth, rcut, rcut2_up, ax, ay, az);
      if constexpr (kPot)
        pot_pair<kPer>(tx, ty, tz, th, thinv, q, hq, box, inv_box,
                       half_inv_asmth, rcut, rcut2_up, pot);
    };
    for (int step = 0; any_live && step < steps; ++step) {
      const int b = step & 1;
      const bool more = step + 1 < steps;
      if (more) fetch((step + 1) * nt + threadIdx.x, p, h);   // in flight
      if (warp_live) {
        const int len = min(nt, total - step * nt);
        for (int i0 = 0; i0 < len; i0 += 32) {
          const int k = i0 + lane;
          bool near = false;
          if (k < len) {
            const float4 q = s_pos[b][k];
            const float ex = image_gap<(kPer & 1) != 0>(
                wb.lo[0] - q.x, wb.hi[0] - q.x, box, inv_box);
            const float ey = image_gap<(kPer & 2) != 0>(
                wb.lo[1] - q.y, wb.hi[1] - q.y, box, inv_box);
            const float ez = image_gap<(kPer & 4) != 0>(
                wb.lo[2] - q.z, wb.hi[2] - q.z, box, inv_box);
            near = q.w != 0.f && ex * ex + ey * ey + ez * ez < cull2;
          }
          // the near sources in slot order, two at a time where there are
          // two, so that the two pairs' arithmetic can overlap
          unsigned todo = __ballot_sync(kFull, near);
          while (todo) {
            const int k1 = i0 + __ffs(todo) - 1;
            todo &= todo - 1;
            const float4 q1 = s_pos[b][k1];
            const float2 h1 = s_soft[b][k1];
            if (todo) {
              const int k2 = i0 + __ffs(todo) - 1;
              todo &= todo - 1;
              const float4 q2 = s_pos[b][k2];
              const float2 h2 = s_soft[b][k2];
              if (live) {
                pair(q1, h1);
                pair(q2, h2);
              }
            } else if (live) {
              pair(q1, h1);
            }
          }
        }
      }
      if (more) {
        s_pos[b ^ 1][threadIdx.x] = p;
        s_soft[b ^ 1][threadIdx.x] = h;
      }
      __syncthreads();
    }
    if (ts < cap) {
      o[ts] = ax;
      o[cap + ts] = ay;
      o[2 * cap + ts] = az;
      if constexpr (kPot) o[3 * cap + ts] = pot;
    }
  }
}

template <bool kPot>
int launch(const float* soa, const int* flags, float* out, int nx, int ny,
           int nz, int per, int cap, float box, float half_inv_asmth,
           float rcut, cudaStream_t st) {
  const int c = nx * ny * nz;
  const int threads = cap < kThreads ? ((cap + 31) / 32) * 32 : kThreads;
  const double up = static_cast<double>(rcut) * rcut * (1.0 + 1e-6);
  const float rcut2_up = up < FLT_MAX ? static_cast<float>(up) : FLT_MAX;
  // a source is culled only beyond rcut (1 + 2e-5 on the square) of its
  // warp's box; inf where rcut2_up is the largest float: nothing is culled
  const float cull2 = rcut2_up * glt::kCullMargin2;
  switch (per) {
    case 7:   // M's periodic cube; the potential mode is the slab's only
      if constexpr (kPot) {
        return static_cast<int>(cudaErrorInvalidValue);
      } else {
        shortrange_gravity_cells_kernel<7, false><<<c, threads, 0, st>>>(
            soa, flags, out, nx, ny, nz, cap, box, half_inv_asmth, rcut,
            rcut2_up, cull2);
      }
      break;
    case 6:
      shortrange_gravity_cells_kernel<6, kPot><<<c, threads, 0, st>>>(
          soa, flags, out, nx, ny, nz, cap, box, half_inv_asmth, rcut,
          rcut2_up, cull2);
      break;
    case 0:
      shortrange_gravity_cells_kernel<0, kPot><<<c, threads, 0, st>>>(
          soa, flags, out, nx, ny, nz, cap, box, half_inv_asmth, rcut,
          rcut2_up, cull2);
      break;
    default:   // no other image mask is instantiated
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int glt_shortrange_gravity_cells(const float* soa, float* out,
                                            int n_cells, int cap, float box,
                                            int periodic, float half_inv_asmth,
                                            float rcut, void* stream) {
  return launch<false>(soa, nullptr, out, n_cells, n_cells, n_cells,
                periodic ? 7 : 0, cap, box, half_inv_asmth, rcut,
                static_cast<cudaStream_t>(stream));
}

// kernel A's slab mode: per-axis cell counts, the image mask per (bit a
// set: axis a periodic; the slab's 6) and tile flags
extern "C" int glt_shortrange_gravity_slab(const float* soa, const int* flags,
                                           float* out, int nx, int ny, int nz,
                                           int per, int cap, float box,
                                           float half_inv_asmth, float rcut,
                                           void* stream) {
  return launch<false>(soa, flags, out, nx, ny, nz, per, cap, box,
                       half_inv_asmth, rcut,
                       static_cast<cudaStream_t>(stream));
}

// kernel A's slab mode with the potential: the slab mode's arguments, out
// [C, 4, cap] (the potential as row 3); the slab's masks 6 and 0 only
extern "C" int glt_shortrange_gravity_slab_pot(const float* soa,
                                               const int* flags, float* out,
                                               int nx, int ny, int nz,
                                               int per, int cap, float box,
                                               float half_inv_asmth,
                                               float rcut, void* stream) {
  return launch<true>(soa, flags, out, nx, ny, nz, per, cap, box,
                      half_inv_asmth, rcut,
                      static_cast<cudaStream_t>(stream));
}
