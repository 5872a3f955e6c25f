// Kernel F: SPH density sums over compacted active entries.
//
// Replaces gadget_leicester_tpu/ops/sph_blocks.py ::
// density_sums_blocks_entries (kernel body _make_sph_entries_kernel,
// kind "density"), on a periodic grid in block-relative coordinates (C
// entry glt_sph_density_entries) and on a clamped (vacuum) grid in
// absolute coordinates (periodic=False there; C entry
// glt_sph_density_entries_abs). Plain PyTorch twin: ops/sph_blocks.py ::
// density_sums_blocks_entries_plain.
//
// What it computes. An entry is at most 8 active gas targets of one even
// block (ops/cells.py :: build_active_entries on the even list). tgt
// [K, 8, 8] holds their rows in the layout of the even pack (x, y, z
// relative to the even block's centre, m, vx, vy, vz, 1; a dead lane has
// m = 0), gathered by the pack's own arithmetic; h [K, 8] their smoothing
// lengths. For each live lane it sums kernel C's pair terms
// (glt_common.cuh :: density_pair), self-pair included as in C, over the
// sources with m > 0 (the pack parks a slot with m = 0; no mass is
// negative) of the 8 odd source blocks entry_blk[e] + {0,1}^3 of soa_o,
// dx = (t - s) + (1 - 2g) * Lf per axis. In absolute mode tgt and soa_o
// hold absolute x, y, z, soa_o has (nb+1)^3 blocks, and dx = t - s with no
// wrap and no shift (the JAX kernel's own geometry with periodic=False).
// out is [K, 6, 8] = rho, drho/dh, raw div v, raw rot v; padded or
// switched-off entries (entry_blk = -1: the Newton loop switches off
// entries whose lanes have all converged) and dead lanes write 0.
//
// What bounds it on the card. An entry's 8 odd blocks hold 8 * lanes
// source slots: 2,048 at 2x128^3 (about 57 KB of rows) against up to 8
// live lanes (a near-idle sync point fills most entries), 262,144 on the
// Leicester disc's 2^3 blocks of 4,096 slots a subcell, about 2% of them
// live, where a launch has at most 16 entries (k_max = 2 nb^3) on 132
// SMs. Few pairs lie inside the support: the kernel is bound by the
// latency of its loads, not by arithmetic or bytes.
//
// What the design does about it: three launches.
// - Chunk boxes. glt::subcell_boxes_kernel in C's instantiation (m > 0
//   valid, no h row) with parts of 32 slots writes, for each source block
//   and each chunk of 32 slots of it, the bounding box of its sources
//   with m > 0 (an empty chunk's box is +inf..-inf, beyond any reach),
//   into a workspace of Bo x ceil(lanes / 32) x 8 floats that the wrapper
//   allocates.
// - Need words. glt::entries_need_kernel (glt_common.cuh, shared with
//   kernel G), a warp for each group of 32 items (odd block g, chunk c) of
//   each entry, takes the box of the entry's live lanes (m > 0) and their
//   largest h as its reach (glt::EntryRows::box: a NaN adds nothing, and
//   the reach is at least 0; the chunks' largest h is 0 here), tests its
//   32 chunk boxes
//   (glt::near_boxes with dx as the sums take it: Shift::kPair with the
//   shift (1 - 2g) Lf, Shift::kNone in absolute mode) and writes the
//   ballot, one word a group, into a second workspace of K x ceil(8
//   chunks / 32) words. Spread over that many warps, the tests of the
//   disc's 8,192 chunks an entry no longer queue in the entry's one warp
//   (there they took 70% of the walk's time: PERF.md section 6).
// - Sums. One warp an entry, four entries a thread block, as the earlier
//   design. The warp reads the entry's need words 32 at a time (a word a
//   lane, a ballot of the non-zero ones: glt::NeedItems) and walks only
//   the chunks within reach (1 + 1e-5), the next chunk's rows loaded into
//   registers while this one sums. A lane whose own source has m = 0 or fails the same
//   test skips the target loop: density_pair would have added nothing for
//   it, since u >= 1 for every target. A target whose 1/h is 0
//   (glt::inv_or_zero) adds only zeros, so what its h reaches does not
//   change its sums.
// - The order of sums is kept. A 32-slot chunk starting at a multiple of
//   32 holds slot k at lane k mod 32, as the earlier design's loop (k =
//   lane; k < lanes; k += 32) mapped slots to lanes, so skipping whole
//   chunks and single sources that add nothing leaves every lane's
//   sequence of added terms (g = 0..7, then k ascending) and the warp's
//   shuffle tree unchanged, whatever subcap is. Built with -fmad=false on
//   both, F equals its earlier design (one warp per entry walking every
//   slot) bit for bit in both modes; with nvcc's default contraction into
//   FMAs its rows may differ in their last bits (PERF.md section 6).
// nvcc 12.8 -Xptxas=-v for sm_90a: the sums 107 registers relative, 109
// absolute (the earlier design 92, 95), 1,152 bytes of shared memory a
// block of 128 threads; the need words 30 registers, the chunk boxes 32.

#include "glt_common.cuh"

namespace {

using glt::kEntryLanes;
using glt::kFull;

constexpr int kRows = 7;             // soa_o rows x, y, z, m, vx, vy, vz
// the entry's target rows: tgt [K, 8, 8], live where m (row 3) > 0, h
// apart
using Rows = glt::EntryRows<8, 3, -1>;

template <bool kAbs>
__global__ void __launch_bounds__(32 * glt::kEntryWarps)
    sph_density_entries_kernel(const float* __restrict__ soa_o,
                               const float* __restrict__ tgt,
                               const float* __restrict__ h,
                               const int* __restrict__ entry_blk,
                               const unsigned* __restrict__ need,
                               float* __restrict__ out, int nb, int lanes,
                               int chunks, int groups, int k_entries,
                               float lf) {
  constexpr glt::Shift kShift = kAbs ? glt::Shift::kNone : glt::Shift::kPair;
  __shared__ float s_t[glt::kEntryWarps][8 * kEntryLanes];
  __shared__ float s_hinv[glt::kEntryWarps][kEntryLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * glt::kEntryWarps + warp;
  if (e >= k_entries) return;  // whole warps leave together
  float* o = out + static_cast<size_t>(e) * 6 * kEntryLanes;
  const int b = entry_blk[e];
  if (b < 0) {
    for (int i = lane; i < 6 * kEntryLanes; i += 32) o[i] = 0.f;
    return;
  }
  float* t = s_t[warp];
  float* hinv = s_hinv[warp];
  const float* tg = tgt + static_cast<size_t>(e) * 8 * kEntryLanes;
  const float* he = h + static_cast<size_t>(e) * kEntryLanes;
  for (int i = lane; i < 8 * kEntryLanes; i += 32) t[i] = tg[i];
  if (lane < kEntryLanes) hinv[lane] = glt::inv_or_zero(he[lane]);
  __syncwarp();
  const unsigned live = __ballot_sync(
      kFull, lane < kEntryLanes && t[3 * kEntryLanes + lane] > 0.f);
  const glt::Box tbox = Rows::box(t, he, lane);
  const glt::OddBlocks ob = glt::odd_blocks(b, nb, lf);
  // the items within reach, in order
  glt::NeedItems items{need + static_cast<size_t>(e) * groups, groups, lane};
  // this lane's source of item u into v (left as it is past the last
  // slot: the caller zeroes it, so m = 0 there)
  auto load = [&](int u, float (&v)[kRows]) {
    const int k = (u % chunks) * 32 + lane;
    if (k < lanes) {
      const float* s = soa_o +
                       static_cast<size_t>(ob.block<kAbs>(u / chunks)) * 8 *
                           lanes + k;
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = s[r * lanes];
    }
  };

  float acc[kEntryLanes][6];
#pragma unroll
  for (int l = 0; l < kEntryLanes; ++l)
#pragma unroll
    for (int r = 0; r < 6; ++r) acc[l][r] = 0.f;

  int u = live ? items.next() : -1;
  float cur[kRows] = {};
  if (u >= 0) load(u, cur);
  while (u >= 0) {
    const int nu = items.next();
    float nxt[kRows] = {};
    if (nu >= 0) load(nu, nxt);   // in flight while this chunk sums
    float sh[3];
    ob.shifts<kAbs>(u / chunks, sh);
    const float s3[3] = {cur[0], cur[1], cur[2]};
    if (cur[3] > 0.f && glt::near_boxes<kShift>(tbox, s3, s3, 0.f, sh)) {
#pragma unroll
      for (int l = 0; l < kEntryLanes; ++l) {
        if (!((live >> l) & 1u)) continue;  // uniform across the warp
        const float dx = kAbs ? t[l] - cur[0] : (t[l] - cur[0]) + sh[0];
        const float dy = kAbs ? t[kEntryLanes + l] - cur[1]
                              : (t[kEntryLanes + l] - cur[1]) + sh[1];
        const float dz = kAbs ? t[2 * kEntryLanes + l] - cur[2]
                              : (t[2 * kEntryLanes + l] - cur[2]) + sh[2];
        glt::density_pair(dx, dy, dz, t[4 * kEntryLanes + l] - cur[4],
                          t[5 * kEntryLanes + l] - cur[5],
                          t[6 * kEntryLanes + l] - cur[6], cur[3], hinv[l],
                          acc[l]);
      }
    }
    u = nu;
#pragma unroll
    for (int r = 0; r < kRows; ++r) cur[r] = nxt[r];
  }
#pragma unroll
  for (int l = 0; l < kEntryLanes; ++l) {
    const bool on = (live >> l) & 1u;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const float v = on ? glt::warp_sum(acc[l][r]) : 0.f;
      if (lane == l) o[r * kEntryLanes + l] = v;
    }
  }
}

// the three launches of kernel F on st: chunk boxes, need words, sums
template <bool kAbs>
int launch_entries(const float* soa_o, const float* tgt, const float* h,
                   const int* entry_blk, float* boxes, unsigned* need,
                   float* out, int nb, int lanes, int k_entries, float lf,
                   cudaStream_t st) {
  const int bo = kAbs ? (nb + 1) * (nb + 1) * (nb + 1) : nb * nb * nb;
  const int chunks = (lanes + 31) / 32;
  const int groups = (8 * chunks + 31) / 32;
  glt::launch_boxes<8, 3, -1>(soa_o, boxes, bo, lanes, 32, st);
  glt::launch_need<Rows, kAbs>(tgt, h, entry_blk, boxes, need, nb, chunks,
                               groups, k_entries, lf, st);
  sph_density_entries_kernel<kAbs>
      <<<(k_entries + glt::kEntryWarps - 1) / glt::kEntryWarps,
         32 * glt::kEntryWarps, 0, st>>>(soa_o, tgt, h, entry_blk, need, out,
                                         nb, lanes, chunks, groups, k_entries,
                                         lf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int glt_sph_density_entries(const float* soa_o, const float* tgt,
                                       const float* h, const int* entry_blk,
                                       float* boxes, unsigned* need,
                                       float* out, int nb, int lanes,
                                       int k_entries, float lf,
                                       void* stream) {
  return launch_entries<false>(soa_o, tgt, h, entry_blk, boxes, need, out,
                               nb, lanes, k_entries, lf,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int glt_sph_density_entries_abs(const float* soa_o,
                                           const float* tgt, const float* h,
                                           const int* entry_blk, float* boxes,
                                           unsigned* need, float* out, int nb,
                                           int lanes, int k_entries,
                                           void* stream) {
  return launch_entries<true>(soa_o, tgt, h, entry_blk, boxes, need, out, nb,
                              lanes, k_entries, 0.f,
                              static_cast<cudaStream_t>(stream));
}
