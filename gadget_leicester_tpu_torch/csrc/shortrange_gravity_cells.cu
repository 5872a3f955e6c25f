// Kernel M and kernel A's slab mode: short-range gravity per cell over its
// 27 neighbours, in absolute coordinates with the per-pair minimum image.
//
// Kernel M replaces gadget_leicester_tpu/ops/pallas_cells.py ::
// shortrange_gravity_pallas (kernel body _make_kernel); plain PyTorch twin
// ops/gravity_short.py :: shortrange_gravity_cells_plain. Kernel A's slab
// mode (C entries glt_shortrange_gravity_slab and, with the potential row,
// glt_shortrange_gravity_slab_pot) replaces gadget_leicester_tpu/ops/
// pallas_cells.py :: shortrange_gravity_pallas_dma9 with a tuple n_cells =
// (nx, nyz, nyz), periodic = (False, pyz, pyz), absolute coordinates and a
// prebuilt cell list, as parallel/spmd.py :: _gravity calls it; plain
// PyTorch twin ops/gravity_short.py :: shortrange_gravity_slab_plain.
//
// What both compute. soa is the [C, 8, cap] ABSOLUTE pack of ops/cells.py
// :: pack_cells_abs (rows x, y, z as the particles hold them, m, soft, 1,
// 1/soft, 0; parked slots with m = 0 and row 5 = 0) of a grid of (nx, ny,
// nz) cells. For every live target slot it sums, over the 27 cells around
// its cell,
//   -m_j * g(r, max(h_i, h_j)) * trunc(r / (2 asmth)) * dx
// over the pairs with 0 < r < rcut, where along each axis of the image
// mask kPer (bit a set: axis a periodic) each component of dx is reduced
// PER PAIR to its minimum image dx - box * round(dx / box). Along a
// clamped axis nothing is reduced and a stencil cell beyond the grid adds
// nothing (the TPU kernel's inb mask). half_inv_asmth == 0 switches the
// truncation off. The self-pair leaves by r > 0: target and source are the
// same pack slot, so dx is 0 bit for bit. out is [C, 3, cap] (ax, ay, az,
// without the factor G), zeros at parked slots; the slab mode writes zeros
// in a cell whose tile flag is 0 (the TPU slab call passes active=None and
// masks afterwards; the results agree, as the step keeps an inactive
// particle's acc). With the potential (kPot, the reference's
// with_potential=True on the same call, parallel/spmd.py :888-898, for the
// in-step potential that sinks and Stamatellos cooling read on slabs) a
// fourth row holds m_j grav_pot(r, max(h_i, h_j)) erfc(r / (2 asmth)) over
// the same pairs, as kernel H's. M instantiates masks 7 and 0; the slab
// mode 6 and 0 (and 7 on M's kernel with its flags, a call no step makes).
// Where the slab differs from a cube: nx may be 1 or 2 (a clamped axis
// never meets a cell twice), nx != nyz, a target on the slab's face at
// float32 x == x1 is a pair like any other (the grid clamps it into the
// last cell), and a ghost's x lies outside [x0, x1) by construction. The
// TPU kernel's test is r2 < rcut^2, these kernels' r < rcut (exact after
// the rsqrt); a pair at rcut to the last ulp may differ, where the
// truncated force is 1.5e-3 of its untruncated value.
//
// Why the minimum image stays per pair. A whole-tile +-box shift (kernels
// I-K) needs every slot of a tile to lie inside that tile's cell; a
// particle whose float32 coordinate equals the box is filed in cell 0 a
// box away from its neighbours, and a tile shift loses them. The per-pair
// reduction is immune to where a coordinate was wrapped, at a multiply, a
// round and an FMA per axis and pair.
//
// The culling rule both share (image_gap). Per axis, every dx = t - s of a
// target t in a box [lo, hi] and a source s in [slo, shi] lies in [l, u] =
// [lo - shi, hi - slo] (float32 rounding is monotone; a single source has
// slo = shi = s). On a periodic axis the test takes the distance of that
// interval from the nearest multiple of the box, k box for k = k0 - 1, k0,
// k0 + 1 with k0 = rint(mid / box): where u - l < box / 2 a pair's reduced
// dx has k within 1 of k0, so its |minimum image| is never below that
// distance; a wider interval (a box that holds a slot at y = box, filed in
// cell 0 beside slots near y = 0) counts as distance 0. k box is exact for
// |k| <= 2, and dx - k box is exact (Sterbenz) for |dx| >= box / 2, where
// k = +-1, so the margin of rcut^2 (1 + 2e-5, glt::kCullMargin2 on rcut^2
// (1 + 1e-6)) covers only the rounding of the sum of squares, as in A: a
// source is dropped only where the pair arithmetic would add nothing for
// every target of the warp. On a clamped axis the distance is from 0. With
// rcut = 1e30 its square is clamped to the largest float and the culling
// bound is inf: nothing is culled and nothing turns NaN.
//
// Kernel M, kept as it was. A thread block is one cell, one thread a
// target slot, in passes of 128 slots; each pass ranks its live slots by a
// Morton key over their box (glt::rank_by_box), so each warp holds 32
// close targets, and streams the stencil's n_src * cap sources through
// shared memory in chunks of 128, double-buffered through registers; every
// lane tests one source of a chunk against its warp's box, and the warp
// walks the near ones in slot order, the whole pair arithmetic for each.
// Each target adds its pairs stencil cell j = 0..26, then slot k =
// 0..cap-1. At most 56 registers (9 blocks an SM). On phase 12's arguments
// (34^3 cells of 128 slots) the model of its walk
// (chip_smoke.gravity_cells_walk) evaluates 54.9% of the stencil pairs:
// 21.1 ms on an H100 (PERF.md section 6).
//
// Kernel A's slab mode: what bounds it. The slab's grid is coarse: at
// 2x128^3 on a ring of one, 24 x 23 x 23 cells of 512 slots after the
// grid's raises, ~360 live a cell (phase 18). On M's design the stencil
// held ~4e10 pairs, ~5% inside the cut, and M's walk paid four passes of
// the whole stencil's stream a cell (one a pass of 128 targets), warp
// boxes a quarter of a cell wide, the whole pair arithmetic for each near
// source whenever one lane of 32 was inside the cut, and the potential's
// separation, cut and factor a second time apart from the force's: 33.7
// ms (53.3 with the potential) against a bound of 1.8 ms by operations,
// bound by instruction issue.
//
// What its design does (two launches of one C entry):
// 1. Rank each cell once (slab_rank_kernel, a block a cell): every live
//    slot of the cell by the Morton key of glt::rank_by_box over the box
//    of the cell's live slots, ties by slot, parked slots last; write the
//    cell ranked into a workspace the wrapper allocates: (x, y, z, m) and
//    (soft, 1/soft) of each rank (zeros past the live ones), the slot of
//    each rank, the live count, and the box of each chunk of 32 ranks.
//    The ranking is the same for every block that reads the cell.
// 2. Walk (slab_gravity_kernel): a warp is one chunk of 32 ranked targets
//    of a cell (a block four chunks of one cell), so its box is the
//    chunk's, close across the whole cell. It tests the boxes of the
//    stencil cells' live chunks against its own (lane j a chunk) and
//    keeps the list of near chunks in shared memory; then streams them,
//    the next chunk's load in flight while it tests the current one's 32
//    sources against its box (lane k source k); the near ones enter a
//    ring of 64 in shared memory in stream order.
// 3. Per-lane cut masks: for each batch of 32 queued sources each lane
//    computes the imaged separation and r^2 of all 32 (the cheap part)
//    and keeps a 32-bit mask of its pairs with r^2 < rcut^2 (1 + 1e-6);
//    then sums only those, in queue order (the dear part: the hardware
//    rsqrt, the exact 0 < r < rcut as a zero weight, softening,
//    truncation, branch-free but for the softened branch). The warp pays
//    the largest lane's count, not every near source.
// 4. The potential on the force's pair: the separation, r, 1/r, the
//    softenings, u and the truncation's argument are the force's. Every
//    operation of the pair is explicitly rounded (__fsub_rn, __fmul_rn,
//    __fmaf_rn), so the compiler contracts nothing, and the force's
//    values are the same with the potential and without: rows 0-2 equal
//    the force-only mode's bit for bit.
// Each target adds its pairs stencil cell j = 0..26 (those on the grid),
// then rank 0..cap-1 of that cell, skipping only pairs that add nothing: a
// fixed, deterministic order, which differs from M's slot order, so the
// sums differ from M's design in the last bits (both are held to the
// float64 plain version within chip_smoke.TOL).
//
// Where its time goes now (an H100, PERF.md section 6). On phase 18's
// arguments 23.0 ms against M's design's 33.7 in turns, 27.0 with the
// potential (1.18x the force's); in vacuum (phase 19) 27.8 against 36.0.
// The model of the walk (chip_smoke.slab_gravity_walk) tests 19.1% of the
// stencil pairs in the cheap part (8.1e9; 40.0% in vacuum), 2.0e9 of them
// inside the cut. Diagnostic builds (wrong by design, timed only) put the
// stream and its culling at 4.2 ms, the cheap part at 7.1 and the dear
// part at 11.7: there a warp pays its busiest lane, and 37.5% of the
// lanes' iterations sum a pair (44% in vacuum). One or two warps a block
// were slower; the imbalance across lanes follows the stencil's order,
// which the order of sums fixes. -Xptxas=-v for sm_90a: 61 registers
// (mask 6), 63 (mask 6 with the potential), 54 and 55 (mask 0), the
// ranking launch 32, no spill.

#include <cfloat>

#include "glt_common.cuh"

namespace {

using glt::kFull;

// ---------------------------------------------------------------------------
// Kernel M (and the slab mode's mask 7)
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 9;   // at most 56 registers, as kernel A

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

template <int kPer>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
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

  constexpr int kRowsOut = 3;
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
    float ax = 0.f, ay = 0.f, az = 0.f;
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
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel A's slab mode
// ---------------------------------------------------------------------------
constexpr int kRankThreads = 256;
constexpr int kSlabWarps = 4;   // chunks of one cell a block
constexpr int kSlabThreads = 32 * kSlabWarps;
// at most 64 registers in every instance (8 blocks of 128 an SM)
constexpr int kSlabBlocksPerSm = 8;
constexpr int kRing = 64;   // queued near sources a warp, two batches

// A queued source: (x, y, z, m), (soft, 1/soft), padded to 32 bytes
struct Queued {
  float4 q;
  float2 h;
  float2 pad;
};

// The workspace of the two launches, for C cells of cap slots in nch =
// ceil(cap / 32) chunks of 32 ranks (capp = 32 nch): pos [C capp] (x, y,
// z, m) and soft [C capp] (soft, 1/soft) in rank order, zeros past the live
// ranks; slot [C capp] the slot of each rank (cap and more for the ranks
// past cap); box [C nch 2] lo (x, y, z, 0) and hi of each chunk's live
// ranks (+inf, -inf where it has none); nin [C] the live slots of each
// cell: C (28 capp + 32 nch + 4) bytes, as ops/cells.py ::
// slab_workspace_bytes counts them.
struct SlabWork {
  float4* pos;
  float2* soft;
  int* slot;
  float4* box;
  int* nin;
};

inline SlabWork slab_work(void* ws, int cells, int nch) {
  char* p = static_cast<char*>(ws);
  const size_t n = static_cast<size_t>(cells) * nch * 32;
  SlabWork w;
  w.pos = reinterpret_cast<float4*>(p);
  w.soft = reinterpret_cast<float2*>(p + n * 16);
  w.slot = reinterpret_cast<int*>(p + n * 24);
  w.box = reinterpret_cast<float4*>(p + n * 28);
  w.nin = reinterpret_cast<int*>(p + n * 28 + static_cast<size_t>(cells) *
                                          nch * 32);
  return w;
}

// Launch 1: one block a cell ranks its slots (dynamic shared memory: capp
// keys, then capp slots) and writes the cell in rank order.
__global__ void __launch_bounds__(kRankThreads)
    slab_rank_kernel(const float* __restrict__ soa, SlabWork ws, int cap,
                     int nch) {
  extern __shared__ unsigned s_rank[];
  unsigned* s_key = s_rank;
  const int capp = nch * 32;
  int* s_slot = reinterpret_cast<int*>(s_rank + capp);
  __shared__ glt::Box s_box[kRankThreads / 32];
  const int c = blockIdx.x;
  const int nt = blockDim.x;
  const int lane = threadIdx.x & 31;
  const float* tile = soa + static_cast<size_t>(c) * 8 * cap;
  const float inf = __int_as_float(0x7f800000);

  // the box and the count of the cell's live slots
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  int n_in = 0;
  for (int t0 = 0; t0 < cap; t0 += nt) {
    const int t = t0 + threadIdx.x;
    const bool in = t < cap && tile[5 * cap + t] > 0.f;
    if (in) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], tile[a * cap + t]);
        hi[a] = fmaxf(hi[a], tile[a * cap + t]);
      }
    }
    n_in += __syncthreads_count(in);
  }
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], off));
    }
  }
  if (lane == 0)
    s_box[threadIdx.x >> 5] = glt::Box{{lo[0], lo[1], lo[2]},
                                       {hi[0], hi[1], hi[2]}, 0.f};
  __syncthreads();
  float scale[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float l = s_box[0].lo[a], u = s_box[0].hi[a];
    for (int w = 1; w < nt / 32; ++w) {
      l = fminf(l, s_box[w].lo[a]);
      u = fmaxf(u, s_box[w].hi[a]);
    }
    lo[a] = l;
    scale[a] = u > l ? static_cast<float>(1 << glt::kKeyBits) / (u - l) : 0.f;
  }

  // keys (parked slots and the padding past cap: kFull), then ranks, ties
  // by slot
  for (int t = threadIdx.x; t < capp; t += nt) {
    unsigned key = kFull;
    if (t < cap && tile[5 * cap + t] > 0.f)
      key = glt::morton_key(glt::key_axis(tile[t], lo[0], scale[0]),
                            glt::key_axis(tile[cap + t], lo[1], scale[1]),
                            glt::key_axis(tile[2 * cap + t], lo[2], scale[2]));
    s_key[t] = key;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < capp; t += nt) {
    const unsigned key = s_key[t];
    int rank = 0;
    for (int i = 0; i < capp; ++i) {
      const unsigned ki = s_key[i];
      rank += ki < key || (ki == key && i < t);
    }
    s_slot[rank] = t;
  }
  __syncthreads();

  // the cell in rank order, and each chunk's box (a warp a chunk: nt and
  // capp are multiples of 32)
  const size_t base = static_cast<size_t>(c) * capp;
  for (int r0 = 0; r0 < capp; r0 += nt) {
    const int r = r0 + threadIdx.x;
    if (r >= capp) break;   // whole warps
    const int t = s_slot[r];
    const bool live = r < n_in;
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    float2 h = make_float2(0.f, 0.f);
    if (live) {
      p = make_float4(tile[t], tile[cap + t], tile[2 * cap + t],
                      tile[3 * cap + t]);
      h = make_float2(tile[4 * cap + t], tile[6 * cap + t]);
    }
    ws.pos[base + r] = p;
    ws.soft[base + r] = h;
    ws.slot[base + r] = t;
    const glt::Box b = glt::warp_box(live, p.x, p.y, p.z, 0.f);
    if (lane == 0) {
      const size_t k = 2 * (static_cast<size_t>(c) * nch + (r >> 5));
      ws.box[k] = make_float4(b.lo[0], b.lo[1], b.lo[2], 0.f);
      ws.box[k + 1] = make_float4(b.hi[0], b.hi[1], b.hi[2], 0.f);
    }
  }
  if (threadIdx.x == 0) ws.nin[c] = n_in;
}

// The pair arithmetic of the slab mode, every operation explicitly rounded
// (the compiler fuses nothing, so the force's values do not depend on what
// else the instance computes).

// t - s per axis, reduced to its minimum image on the axes of kPer
template <int kPer>
__device__ __forceinline__ float3 separation(const float4& t, const float4& s,
                                             float box, float inv_box) {
  float dx = __fsub_rn(t.x, s.x);
  float dy = __fsub_rn(t.y, s.y);
  float dz = __fsub_rn(t.z, s.z);
  if constexpr ((kPer & 1) != 0)
    dx = __fmaf_rn(-box, rintf(__fmul_rn(dx, inv_box)), dx);
  if constexpr ((kPer & 2) != 0)
    dy = __fmaf_rn(-box, rintf(__fmul_rn(dy, inv_box)), dy);
  if constexpr ((kPer & 4) != 0)
    dz = __fmaf_rn(-box, rintf(__fmul_rn(dz, inv_box)), dz);
  return make_float3(dx, dy, dz);
}

__device__ __forceinline__ float norm2(const float3& d) {
  return __fmaf_rn(d.x, d.x, __fmaf_rn(d.y, d.y, __fmul_rn(d.z, d.z)));
}

// glt::grav_fac_nodiv at u = r / h
__device__ __forceinline__ float grav_fac_rn(float u, float rinv, float h,
                                             float hinv) {
  const float rinv3 = __fmul_rn(__fmul_rn(rinv, rinv), rinv);
  if (!(u < 1.0f)) return rinv3;
  const float hinv3 = __fmul_rn(__fmul_rn(hinv, hinv), hinv);
  if (u < 0.5f) {
    const float t = __fmaf_rn(32.0f, u, -38.4f);
    return __fmul_rn(hinv3, __fmaf_rn(__fmul_rn(u, u), t, 10.666666666667f));
  }
  const float uinv3 = __fmul_rn(__fmul_rn(__fmul_rn(h, h), h), rinv3);
  float t = __fmaf_rn(-10.666666666667f, u, 38.4f);
  t = __fmaf_rn(t, u, -48.0f);
  t = __fmaf_rn(t, u, 21.333333333333f);
  return __fmul_rn(hinv3, __fmaf_rn(-0.066666666667f, uinv3, t));
}

// glt::trunc_p10
__device__ __forceinline__ float trunc_p10_rn(float x) {
  float p = 0.00527855602f;
  p = __fmaf_rn(p, x, -0.0574951754f);
  p = __fmaf_rn(p, x, 0.239634766f);
  p = __fmaf_rn(p, x, -0.426925219f);
  p = __fmaf_rn(p, x, 0.121668214f);
  p = __fmaf_rn(p, x, 0.480734922f);
  p = __fmaf_rn(p, x, -0.060829609f);
  p = __fmaf_rn(p, x, -0.724873424f);
  p = __fmaf_rn(p, x, -0.00511726609f);
  p = __fmaf_rn(p, x, 0.00034025031f);
  return __fmaf_rn(p, x, 0.999996443f);
}

// glt::grav_pot_nodiv at u = r / h
__device__ __forceinline__ float grav_pot_rn(float u, float rinv, float h,
                                             float hinv) {
  if (!(u < 1.0f)) return -rinv;
  const float u2 = __fmul_rn(u, u);
  if (u < 0.5f) {
    float t = __fmaf_rn(6.4f, u, -9.6f);
    t = __fmaf_rn(u2, t, 5.333333333333f);
    return __fmul_rn(hinv, __fmaf_rn(u2, t, -2.8f));
  }
  float t = __fmaf_rn(-2.133333333333f, u, 9.6f);
  t = __fmaf_rn(u, t, -16.0f);
  t = __fmaf_rn(u, t, 10.666666666667f);
  const float lin = __fmaf_rn(0.066666666667f, __fmul_rn(h, rinv), -3.2f);
  return __fmul_rn(hinv, __fmaf_rn(u2, t, lin));
}

// glt::erfc_p10
__device__ __forceinline__ float erfc_p10_rn(float x) {
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
  return __fmaf_rn(p, x, 0.999999923f);
}

// 1/sqrt(x) for a normal x (the pair takes x >= 1e-37): the hardware's
// approximation alone, as rsqrtf gives it for a normal argument, without
// the denormal scaling that nvcc wraps around rsqrtf
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The dear part of a pair inside the cut's square: the pull of source (s,
// hs) on target (t, th) added to acc[0..2], with kPot its potential to
// acc[3]. A pair at r >= rcut to the last bit, or the self-pair (r = 0),
// adds a zero weight (branch-free: exact zeros leave the sums as they
// are).
template <int kPer, bool kPot>
__device__ __forceinline__ void slab_pair(const float4& t, const float2& th,
                                          const float4& s, const float2& hs,
                                          float box, float inv_box,
                                          float half_inv_asmth, float rcut,
                                          float (&acc)[4]) {
  const float3 d = separation<kPer>(t, s, box, inv_box);
  const float r2 = norm2(d);
  const float rinv = rsqrt_normal(fmaxf(r2, 1e-37f));
  const float r = __fmul_rn(r2, rinv);
  const bool ok = r < rcut && r > 0.f;
  const float h = fmaxf(th.x, hs.x);
  const float hinv = fminf(th.y, hs.y);
  const float u = __fmul_rn(r, hinv);
  const float x = fminf(__fmul_rn(r, half_inv_asmth), 2.25f);
  float fac = grav_fac_rn(u, rinv, h, hinv);
  if (half_inv_asmth > 0.f) fac = __fmul_rn(fac, trunc_p10_rn(x));
  const float w = ok ? __fmul_rn(s.w, fac) : 0.f;
  acc[0] = __fmaf_rn(-w, d.x, acc[0]);
  acc[1] = __fmaf_rn(-w, d.y, acc[1]);
  acc[2] = __fmaf_rn(-w, d.z, acc[2]);
  if constexpr (kPot) {
    float p = grav_pot_rn(u, rinv, h, hinv);
    if (half_inv_asmth > 0.f) p = __fmul_rn(p, erfc_p10_rn(x));
    acc[3] = __fmaf_rn(s.w, ok ? p : 0.f, acc[3]);
  }
}

// The distance squared, by image_gap per axis, of the intervals [lo - shi,
// hi - slo] of dx between a target box and a source box.
template <int kPer>
__device__ __forceinline__ float box_gap2(const float4& lo, const float4& hi,
                                          const float4& slo,
                                          const float4& shi, float box,
                                          float inv_box) {
  const float ex = image_gap<(kPer & 1) != 0>(lo.x - shi.x, hi.x - slo.x, box,
                                              inv_box);
  const float ey = image_gap<(kPer & 2) != 0>(lo.y - shi.y, hi.y - slo.y, box,
                                              inv_box);
  const float ez = image_gap<(kPer & 4) != 0>(lo.z - shi.z, hi.z - slo.z, box,
                                              inv_box);
  return ex * ex + ey * ey + ez * ez;
}

// Launch 2: a warp a chunk of 32 ranked targets (kSlabWarps chunks of one
// cell a block); dynamic shared memory: the near-chunk list of each warp,
// 27 nch entries.
template <int kPer, bool kPot>
__global__ void __launch_bounds__(kSlabThreads, kSlabBlocksPerSm)
    slab_gravity_kernel(const SlabWork ws, const int* __restrict__ flags,
                        float* __restrict__ out, int nx, int ny, int nz,
                        int cap, int nch, float box, float half_inv_asmth,
                        float rcut, float rcut2_up, float cull2) {
  extern __shared__ int s_list[];
  __shared__ Queued s_ring[kSlabWarps][kRing];
  constexpr int kRows = kPot ? 4 : 3;
  const int groups = (nch + kSlabWarps - 1) / kSlabWarps;
  const int c = blockIdx.x / groups;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = (blockIdx.x - c * groups) * kSlabWarps + w;
  if (k >= nch) return;   // the whole warp
  const int capp = nch * 32;
  const int r = k * 32 + lane;
  const size_t at = static_cast<size_t>(c) * capp + r;
  float* o = out + static_cast<size_t>(c) * kRows * cap;
  const int n_c = ws.nin[c];
  const bool gated = flags != nullptr && flags[c] == 0;
  if (gated || k * 32 >= n_c) {
    // zeros: a gated cell's slots by slot, a chunk of parked ranks by rank
    const int ts = gated ? r : ws.slot[at];
    if (ts < cap) {
#pragma unroll
      for (int row = 0; row < kRows; ++row) o[row * cap + ts] = 0.f;
    }
    return;
  }
  const float inv_box = kPer != 0 ? 1.0f / box : 0.f;
  const bool live = r < n_c;
  float4 tp = make_float4(0.f, 0.f, 0.f, 0.f);
  float2 th = make_float2(0.f, 0.f);
  if (live) {
    tp = ws.pos[at];
    th = ws.soft[at];
  }
  const size_t kb = 2 * (static_cast<size_t>(c) * nch + k);
  const float4 lo = ws.box[kb], hi = ws.box[kb + 1];

  // the stencil's cells on the grid, j = 0..26 (lane j): wrapped along the
  // axes of kPer, those beyond a clamped face left out; and their chunks
  // of live ranks
  int sj = 0, nj = 0;
  if (lane < 27) {
    const int cx = c / (ny * nz), cy = (c / nz) % ny, cz = c % nz;
    int sx = cx + lane / 9 - 1, sy = cy + (lane / 3) % 3 - 1,
        sz = cz + lane % 3 - 1;
    bool on = true;
    if constexpr ((kPer & 1) != 0) sx = glt::wrap(sx, nx);
    else on = on && sx >= 0 && sx < nx;
    if constexpr ((kPer & 2) != 0) sy = glt::wrap(sy, ny);
    else on = on && sy >= 0 && sy < ny;
    if constexpr ((kPer & 4) != 0) sz = glt::wrap(sz, nz);
    else on = on && sz >= 0 && sz < nz;
    if (on) {
      sj = (sx * ny + sy) * nz + sz;
      nj = (ws.nin[sj] + 31) >> 5;
    }
  }

  // the list of the stencil's chunks whose box lies within the cut of
  // this warp's box, in stencil order, then chunk order
  int* list = s_list + w * 27 * nch;
  const unsigned below = (1u << lane) - 1u;
  int nl = 0;
  for (int j = 0; j < 27; ++j) {
    const int s = __shfl_sync(kFull, sj, j);
    const int ns = __shfl_sync(kFull, nj, j);
    for (int k0 = 0; k0 < ns; k0 += 32) {
      const int kk = k0 + lane;
      bool near = false;
      if (kk < ns) {
        const size_t b = 2 * (static_cast<size_t>(s) * nch + kk);
        near = box_gap2<kPer>(lo, hi, ws.box[b], ws.box[b + 1], box,
                              inv_box) < cull2;
      }
      const unsigned bits = __ballot_sync(kFull, near);
      if (near) list[nl + __popc(bits & below)] = s * nch + kk;
      nl += __popc(bits);
    }
  }
  __syncwarp();

  // stream the near chunks (the next one's load in flight), queue the
  // sources within the cut of the warp's box, and sum each full batch of
  // 32 queued sources (the last batch when the stream ends)
  Queued* ring = s_ring[w];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  float2 hq = make_float2(0.f, 0.f);
  if (nl > 0) {
    const size_t e = static_cast<size_t>(list[0]) * 32 + lane;
    q = ws.pos[e];
    hq = ws.soft[e];
  }
  int li = 0, head = 0, n = 0;
  for (;;) {
    if (li < nl) {
      const float4 qc = q;
      const float2 hc = hq;
      if (++li < nl) {
        const size_t e = static_cast<size_t>(list[li]) * 32 + lane;
        q = ws.pos[e];
        hq = ws.soft[e];
      }
      const float4 qv = make_float4(qc.x, qc.y, qc.z, qc.x);
      const bool near =
          qc.w != 0.f &&
          box_gap2<kPer>(lo, hi, qv, qv, box, inv_box) < cull2;
      const unsigned bits = __ballot_sync(kFull, near);
      if (near) {
        const int p = (head + n + __popc(bits & below)) & (kRing - 1);
        ring[p].q = qc;
        ring[p].h = hc;
      }
      n += __popc(bits);
      if (n < 32) continue;
    } else if (n == 0) {
      break;
    }
    __syncwarp();
    const int m = min(n, 32);
    // the cheap part: this lane's pairs of the batch inside the cut's
    // square (its self-pair too: the dear part adds it as zero)
    unsigned mine = 0;
    if (live) {
      for (int i = 0; i < m; ++i) {
        const float r2 = norm2(separation<kPer>(
            tp, ring[(head + i) & (kRing - 1)].q, box, inv_box));
        mine |= r2 < rcut2_up ? 1u << i : 0u;
      }
    }
    // the dear part: only those, in queue order
    while (mine != 0) {
      const Queued& e = ring[(head + __ffs(mine) - 1) & (kRing - 1)];
      mine &= mine - 1;
      slab_pair<kPer, kPot>(tp, th, e.q, e.h, box, inv_box, half_inv_asmth,
                            rcut, acc);
    }
    __syncwarp();
    head = (head + m) & (kRing - 1);
    n -= m;
  }
  const int ts = ws.slot[at];
  if (ts < cap) {
#pragma unroll
    for (int row = 0; row < kRows; ++row) o[row * cap + ts] = acc[row];
  }
}

// A kernel's dynamic shared memory beyond the 48 KB a launch takes unasked
template <class F>
void allow_shared(F* kernel, size_t bytes) {
  if (bytes > 40 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
}

// rcut^2 (1 + 1e-6), clamped to the largest float; a source is culled only
// beyond rcut (1 + 2e-5 on the square) of its warp's box, and nothing
// where rcut2_up is the largest float (the bound is then inf)
inline float rcut2_up_of(float rcut) {
  const double up = static_cast<double>(rcut) * rcut * (1.0 + 1e-6);
  return up < FLT_MAX ? static_cast<float>(up) : FLT_MAX;
}

int launch_cells(const float* soa, const int* flags, float* out, int nx,
                 int ny, int nz, int per, int cap, float box,
                 float half_inv_asmth, float rcut, cudaStream_t st) {
  const int c = nx * ny * nz;
  const int threads = cap < kThreads ? ((cap + 31) / 32) * 32 : kThreads;
  const float rcut2_up = rcut2_up_of(rcut);
  const float cull2 = rcut2_up * glt::kCullMargin2;
  switch (per) {
    case 7:
      shortrange_gravity_cells_kernel<7><<<c, threads, 0, st>>>(
          soa, flags, out, nx, ny, nz, cap, box, half_inv_asmth, rcut,
          rcut2_up, cull2);
      break;
    case 0:
      shortrange_gravity_cells_kernel<0><<<c, threads, 0, st>>>(
          soa, flags, out, nx, ny, nz, cap, box, half_inv_asmth, rcut,
          rcut2_up, cull2);
      break;
    default:   // no other image mask is instantiated
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kPer, bool kPot>
int launch_slab(const float* soa, const int* flags, float* out, void* work,
                int nx, int ny, int nz, int cap, float box,
                float half_inv_asmth, float rcut, cudaStream_t st) {
  const int c = nx * ny * nz;
  const int nch = (cap + 31) / 32;
  const SlabWork ws = slab_work(work, c, nch);
  const size_t rank_shared = static_cast<size_t>(nch) * 32 * 8;
  allow_shared(slab_rank_kernel, rank_shared);
  slab_rank_kernel<<<c, kRankThreads, rank_shared, st>>>(soa, ws, cap, nch);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const float rcut2_up = rcut2_up_of(rcut);
  const size_t list_shared = static_cast<size_t>(kSlabWarps) * 27 * nch * 4;
  allow_shared(slab_gravity_kernel<kPer, kPot>, list_shared);
  const int groups = (nch + kSlabWarps - 1) / kSlabWarps;
  slab_gravity_kernel<kPer, kPot><<<c * groups, kSlabThreads, list_shared,
                                    st>>>(
      ws, flags, out, nx, ny, nz, cap, nch, box, half_inv_asmth, rcut,
      rcut2_up, rcut2_up * glt::kCullMargin2);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPot>
int launch_slab_mask(const float* soa, const int* flags, float* out,
                     void* work, int nx, int ny, int nz, int per, int cap,
                     float box, float half_inv_asmth, float rcut,
                     cudaStream_t st) {
  switch (per) {
    case 6:
      return launch_slab<6, kPot>(soa, flags, out, work, nx, ny, nz, cap, box,
                                  half_inv_asmth, rcut, st);
    case 0:
      return launch_slab<0, kPot>(soa, flags, out, work, nx, ny, nz, cap, box,
                                  half_inv_asmth, rcut, st);
    case 7:   // M's periodic cube: M's kernel with the flags, no potential
      if constexpr (kPot)
        return static_cast<int>(cudaErrorInvalidValue);
      else
        return launch_cells(soa, flags, out, nx, ny, nz, 7, cap, box,
                            half_inv_asmth, rcut, st);
    default:   // no other image mask is instantiated
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int glt_shortrange_gravity_cells(const float* soa, float* out,
                                            int n_cells, int cap, float box,
                                            int periodic, float half_inv_asmth,
                                            float rcut, void* stream) {
  return launch_cells(soa, nullptr, out, n_cells, n_cells, n_cells,
                      periodic ? 7 : 0, cap, box, half_inv_asmth, rcut,
                      static_cast<cudaStream_t>(stream));
}

// kernel A's slab mode: per-axis cell counts, the image mask per (bit a
// set: axis a periodic; the slab's 6, in vacuum 0), tile flags and the
// workspace (SlabWork)
extern "C" int glt_shortrange_gravity_slab(const float* soa, const int* flags,
                                           float* out, void* work, int nx,
                                           int ny, int nz, int per, int cap,
                                           float box, float half_inv_asmth,
                                           float rcut, void* stream) {
  return launch_slab_mask<false>(soa, flags, out, work, nx, ny, nz, per, cap,
                                 box, half_inv_asmth, rcut,
                                 static_cast<cudaStream_t>(stream));
}

// kernel A's slab mode with the potential: the slab mode's arguments, out
// [C, 4, cap] (the potential as row 3); the slab's masks 6 and 0 only
extern "C" int glt_shortrange_gravity_slab_pot(const float* soa,
                                               const int* flags, float* out,
                                               void* work, int nx, int ny,
                                               int nz, int per, int cap,
                                               float box,
                                               float half_inv_asmth,
                                               float rcut, void* stream) {
  return launch_slab_mask<true>(soa, flags, out, work, nx, ny, nz, per, cap,
                                box, half_inv_asmth, rcut,
                                static_cast<cudaStream_t>(stream));
}
