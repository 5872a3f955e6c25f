// Kernel E: TreePM short-range gravity over compacted active entries, and
// its potential mode.
//
// Replaces gadget_leicester_tpu/ops/pallas_cells.py ::
// shortrange_gravity_pallas_entries (kernel body _make_kernel_entries), in
// its cell-relative mode, with and without with_potential. Plain PyTorch
// twin: ops/gravity_short.py :: shortrange_gravity_entries_plain
// (with_potential for the second mode).
//
// What it computes. An entry is at most 8 active targets of one cell
// (ops/cells.py :: build_active_entries). tgt [K, 8, 8] holds each entry's
// target rows in the layout of the [C, 8, cap] source pack soa (x, y, z
// relative to the cell centre, m, soft, 1, 1/soft, 0; a dead lane has row
// 5 = 0), gathered by the pack's own arithmetic, so a target sees itself at
// r2 = 0 exactly and drops out as in kernel A. For each live target lane
// it sums kernel A's pair term (glt_common.cuh :: gravity_pair) over the
// 27 cells around entry_cell[e], with the constant stencil shifts. out is
// [K, 3, 8]; padded entries (entry_cell = -1) and dead lanes write 0.
//
// The potential mode (C entry glt_shortrange_potential_entries) feeds the
// in-step potential that sink formation and Stamatellos cooling read at a
// near-idle sync point. It sums kernel H's pair term instead
// (glt_common.cuh :: gravity_potential_pair: the same force, and m
// grav_pot(r) erfc(r / (2 asmth)) into a fourth accumulator per lane) and
// writes out [K, 4, 8]. The self-pair, whose softened potential -2.8/h is
// the largest term a target meets, is dropped by r2 == 0 exactly, as in
// H. Both modes are one template on kPot; their support is the same, 0 <
// r2 < rcut^2, so they take the same walk.
//
// What bounds it on the card. At a near-idle sync point of the 2x128^3
// box (1% active) about 26,000 entries of k_max = 58,956 are live, with
// about 1.6 live lanes each, and each reaches 27 * 128 = 3456 source
// slots (83 KB of source rows; a launch must read 125 MB, the 0.037 ms
// bound). Only about 15% of the stencil's pairs lie inside rcut, about
// one cell edge. The earlier design (one warp an entry, lane l walking
// slots l, l + 32, ... of each stencil cell) took 0.589 ms, 0.491 of it
// with its pair arithmetic cut out: its walk costs more than its pairs.
// The walk is bound by the latency of its loads and of its instructions'
// chain at too few warps an SM: fewer bytes did not make it faster, more
// loads in flight a warp (more registers, fewer warps) made it slower,
// and more warps an SM made it faster (PERF.md section 6).
//
// What the design does about it: two launches, F's chunk walk on the
// 27-cell stencil, with fewer instructions a source and more warps an SM.
// - Chunk boxes. glt::subcell_boxes_kernel in F's instantiation (m > 0
//   valid, no h row) with parts of 32 slots writes the box of each chunk
//   of 32 slots of each cell of the pack into a workspace of C x
//   ceil(cap / 32) x 8 floats that the wrapper allocates (an empty
//   chunk's box is +inf..-inf, beyond any reach): 0.046 ms at 2x128^3.
// - Sums. One warp an entry, two entries a block, at most 64 registers
//   (__launch_bounds__ for 16 blocks an SM: 32 warps, not the 24 that 76
//   registers left, at the price of a small spill). The warp takes the
//   box of its live lanes with rcut as its reach (glt::warp_box) and
//   tests the chunk boxes of its stencil 32 at a time, a ballot each
//   (glt::near_boxes<Shift::kSource> with the stencil shift: E takes dx
//   = t - (s + shift), and the test takes it so); it loads only the
//   chunks within reach, the next chunk's rows in flight while this one
//   sums. A lane whose own source has m = 0 or lies beyond reach skips
//   the target loop. The tests are conservative (glt_common.cuh): what
//   they drop adds nothing for any live lane, in the force and the
//   potential alike (their support is the same). The stencil's cells
//   and shifts are a table in shared memory, and the live lanes' target
//   rows are packed, so the target loop runs over the live lanes only.
// - The order of sums is kept. A chunk holds slot k at lane k mod 32, as
//   the earlier design's loop mapped slots to lanes, and the chunks come
//   in stream order (j = 0..26, then k ascending), so skipping chunks and
//   sources that add nothing leaves every lane's sequence of added terms
//   and the warp's shuffle tree unchanged: E equals its earlier design bit
//   for bit, with either flags (PERF.md section 6).
// Designs measured and not kept (PERF.md section 6): a bit a source and
// a walk of each lane's kept sources, a queue of the kept sources a warp
// or a lane, batches of loads in flight, a block's entries sharing their
// stencil cells in shared memory, 8 entries a block, 4 entries a block
// with or without a register bound.
// -Xptxas=-v for sm_90a: the sums 64 registers with a 24-byte spill (the
// potential mode a 144-byte one), 1,408 bytes of shared memory a block
// of 64 threads; the box kernel 32 registers.

#include "glt_common.cuh"

namespace {

using glt::kEntryLanes;
using glt::kFull;

// entries (warps) a block, and blocks an SM: at most 64 registers, so
// that 32 warps an SM hide the walk's latency (PERF.md section 6)
constexpr int kEntryWarps = 2;
constexpr int kBlocksPerSm = 16;

template <bool kPot>
__global__ void __launch_bounds__(32 * kEntryWarps, kBlocksPerSm)
    shortrange_gravity_entries_kernel(const float* __restrict__ soa,
                                      const int* __restrict__ entry_cell,
                                      const float* __restrict__ tgt,
                                      const float* __restrict__ boxes,
                                      float* __restrict__ out, int n, int cap,
                                      int k_entries, float edge,
                                      float half_inv_asmth, float rcut2) {
  constexpr int kRows = kPot ? 4 : 3;
  // the live lanes' x, y, z, soft, 1/soft (rows 0-2, 4, 6), live lane i of
  // the entry in column i; the stencil's cells and shifts
  __shared__ float s_t[kEntryWarps][5][kEntryLanes];
  __shared__ int s_cell[kEntryWarps][27];
  __shared__ float4 s_shift[kEntryWarps][27];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * kEntryWarps + warp;
  if (e >= k_entries) return;  // whole warps leave together
  float* o = out + static_cast<size_t>(e) * kRows * kEntryLanes;
  const int c = entry_cell[e];
  if (c < 0) {
    if (lane < kRows * kEntryLanes) o[lane] = 0.f;
    return;
  }
  const float* tg = tgt + static_cast<size_t>(e) * 8 * kEntryLanes;
  const bool in = lane < kEntryLanes && tg[5 * kEntryLanes + lane] > 0.f;
  const unsigned live = __ballot_sync(kFull, in);
  const int n_live = __popc(live);
  float(*t)[kEntryLanes] = s_t[warp];
  if (in) {
    const int i = __popc(live & ((1u << lane) - 1u));
#pragma unroll
    for (int r = 0; r < 5; ++r)
      t[r][i] = tg[(r < 3 ? r : 2 * r - 2) * kEntryLanes + lane];
  }
  const int cx = c / (n * n), cy = (c / n) % n, cz = c % n;
  if (lane < 27) {
    const int ox = lane / 9 - 1, oy = (lane / 3) % 3 - 1, oz = lane % 3 - 1;
    s_cell[warp][lane] = (glt::wrap(cx + ox, n) * n + glt::wrap(cy + oy, n)) *
                             n + glt::wrap(cz + oz, n);
    s_shift[warp][lane] =
        make_float4(static_cast<float>(ox) * edge, static_cast<float>(oy) * edge,
                    static_cast<float>(oz) * edge, 0.f);
  }
  __syncwarp();
  const int* cells = s_cell[warp];
  const float4* shifts = s_shift[warp];
  // the box of the live lanes, with rcut as its reach
  const int li = in ? lane : 0;
  const glt::Box tbox =
      glt::warp_box(in, tg[li], tg[kEntryLanes + li],
                    tg[2 * kEntryLanes + li], sqrtf(rcut2));

  float ax[kEntryLanes], ay[kEntryLanes], az[kEntryLanes];
  float pot[kPot ? kEntryLanes : 1];
#pragma unroll
  for (int i = 0; i < kEntryLanes; ++i) ax[i] = ay[i] = az[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kPot ? kEntryLanes : 1); ++i) pot[i] = 0.f;

  // the lane's sources, item u = j * chunks + q of the stream: slot q *
  // 32 + lane of stencil cell j, shifted by its offset times the cell
  // edge; the items whose chunk box lies within reach, in order (none
  // where no lane is live)
  const int chunks = (cap + 31) / 32;
  const int items = live != 0u ? 27 * chunks : 0;
  const float inv_chunks = 1.0f / static_cast<float>(chunks);
  // u / chunks, exact: u + 1/2 lies 1/2 from a multiple of chunks
  auto cell_of = [&](int u) {
    return static_cast<int>((static_cast<float>(u) + 0.5f) * inv_chunks);
  };
  auto shift_of = [&](int j, float (&sh)[3]) {
    const float4 v = shifts[j];
    sh[0] = v.x;
    sh[1] = v.y;
    sh[2] = v.z;
  };
  // the need word of items 32 r .. 32 r + 31: a ballot of their chunk
  // boxes' test (all lanes call it)
  auto need_word = [&](int r) {
    const int u = 32 * r + lane;
    bool near = false;
    if (u < items) {
      const int j = cell_of(u);
      const float* q = boxes + (static_cast<size_t>(cells[j]) * chunks +
                                (u - j * chunks)) * 8;
      const float slo[3] = {q[0], q[1], q[2]}, shi[3] = {q[3], q[4], q[5]};
      float sh[3];
      shift_of(j, sh);
      near = glt::near_boxes<glt::Shift::kSource>(tbox, slo, shi, 0.f, sh);
    }
    return __ballot_sync(kFull, near);
  };
  int round = 0;
  unsigned word = items > 0 ? need_word(0) : 0u;
  // the next item within reach, or -1 (all lanes call it)
  auto next = [&]() {
    while (word == 0u) {
      if (32 * ++round >= items) return -1;
      word = need_word(round);
    }
    const int u = 32 * round + __ffs(word) - 1;
    word &= word - 1;
    return u;
  };
  // this lane's source of item u (in stencil cell j): x, y, z, m, soft,
  // 1/soft (m = 0 past the cell's last slot)
  auto load = [&](int u, int& j, float (&v)[6]) {
    j = cell_of(u);
    const int k = (u - j * chunks) * 32 + lane;
    if (k < cap) {
      const float* s = soa + static_cast<size_t>(cells[j]) * 8 * cap + k;
      v[0] = s[0];
      v[1] = s[cap];
      v[2] = s[2 * cap];
      v[3] = s[3 * cap];
      v[4] = s[4 * cap];
      v[5] = s[6 * cap];
    }
  };
  int u = items > 0 ? next() : -1;
  int j = 0;
  float cur[6] = {};
  if (u >= 0) load(u, j, cur);
  while (u >= 0) {
    const int nu = next();
    int nj = 0;
    float nxt[6] = {};
    if (nu >= 0) load(nu, nj, nxt);   // in flight while this chunk sums
    float sh[3];
    shift_of(j, sh);
    const float p3[3] = {cur[0], cur[1], cur[2]};
    if (cur[3] != 0.f &&
        glt::near_boxes<glt::Shift::kSource>(tbox, p3, p3, 0.f, sh)) {
      const float sx = cur[0] + sh[0];
      const float sy = cur[1] + sh[1];
      const float sz = cur[2] + sh[2];
#pragma unroll
      for (int i = 0; i < kEntryLanes; ++i) {
        if (i >= n_live) break;  // uniform across the warp
        if constexpr (kPot) {
          glt::gravity_potential_pair(t[0][i], t[1][i], t[2][i], t[3][i],
                                      t[4][i], sx, sy, sz, cur[3], cur[4],
                                      cur[5], half_inv_asmth, rcut2, ax[i],
                                      ay[i], az[i], pot[i]);
        } else {
          glt::gravity_pair(t[0][i], t[1][i], t[2][i], t[3][i], t[4][i], sx,
                            sy, sz, cur[3], cur[4], cur[5], half_inv_asmth,
                            rcut2, ax[i], ay[i], az[i]);
        }
      }
    }
    u = nu;
    j = nj;
#pragma unroll
    for (int r = 0; r < 6; ++r) cur[r] = nxt[r];
  }
  // each live lane's sums, to its column; zeros for the dead lanes
  unsigned rest = live;
#pragma unroll
  for (int i = 0; i < kEntryLanes; ++i) {
    if (i >= n_live) break;
    const int l = __ffs(rest) - 1;
    rest &= rest - 1;
    const float vx = glt::warp_sum(ax[i]);
    const float vy = glt::warp_sum(ay[i]);
    const float vz = glt::warp_sum(az[i]);
    float vp = 0.f;
    if constexpr (kPot) vp = glt::warp_sum(pot[i]);
    if (lane == l) {
      o[l] = vx;
      o[kEntryLanes + l] = vy;
      o[2 * kEntryLanes + l] = vz;
      if constexpr (kPot) o[3 * kEntryLanes + l] = vp;
    }
  }
  if (lane < kEntryLanes && !in) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) o[r * kEntryLanes + lane] = 0.f;
  }
}

// the two launches of kernel E on the stream: chunk boxes, sums
template <bool kPot>
int launch_entries(const float* soa, const int* entry_cell, const float* tgt,
                   float* boxes, float* out, int n_cells, int cap,
                   int k_entries, float edge, float half_inv_asmth,
                   float rcut2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  glt::launch_boxes<8, 3, -1>(soa, boxes, n_cells * n_cells * n_cells, cap,
                              32, st);
  const int blocks = (k_entries + kEntryWarps - 1) / kEntryWarps;
  shortrange_gravity_entries_kernel<kPot><<<blocks, 32 * kEntryWarps, 0, st>>>(
      soa, entry_cell, tgt, boxes, out, n_cells, cap, k_entries, edge,
      half_inv_asmth, rcut2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes: the workspace of the chunk boxes, [C, ceil(cap / 32), 8] floats
extern "C" int glt_shortrange_gravity_entries(const float* soa,
                                              const int* entry_cell,
                                              const float* tgt, float* boxes,
                                              float* out, int n_cells,
                                              int cap, int k_entries,
                                              float edge,
                                              float half_inv_asmth,
                                              float rcut2, void* stream) {
  return launch_entries<false>(soa, entry_cell, tgt, boxes, out, n_cells,
                               cap, k_entries, edge, half_inv_asmth, rcut2,
                               stream);
}

// The potential mode: out [K, 4, 8], row 3 the potential (no G).
extern "C" int glt_shortrange_potential_entries(const float* soa,
                                                const int* entry_cell,
                                                const float* tgt,
                                                float* boxes, float* out,
                                                int n_cells, int cap,
                                                int k_entries, float edge,
                                                float half_inv_asmth,
                                                float rcut2, void* stream) {
  return launch_entries<true>(soa, entry_cell, tgt, boxes, out, n_cells, cap,
                              k_entries, edge, half_inv_asmth, rcut2, stream);
}
