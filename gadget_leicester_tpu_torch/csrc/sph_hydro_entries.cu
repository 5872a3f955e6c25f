// Kernel G: SPH hydro force sums over compacted active entries.
//
// Replaces gadget_leicester_tpu/ops/sph_blocks.py ::
// hydro_sums_blocks_entries (kernel body _make_sph_entries_kernel, kind
// "hydro"), on a periodic grid in block-relative coordinates (C entry
// glt_sph_hydro_entries) and on a clamped (vacuum) grid in absolute
// coordinates (periodic=False there; C entry glt_sph_hydro_entries_abs).
// Plain PyTorch twin: ops/sph_blocks.py :: hydro_sums_blocks_entries_plain.
//
// What it computes. An entry is at most 8 active gas targets of one even
// block. tgt16 [K, 16, 8] holds their rows in the layout of kernel D's
// even pack (x, y, z relative to the even block's centre, m, vx, vy, vz,
// h, rho, P/rho^2 f, c_sound, Balsara, valid, 0, 0, 0; a dead lane has
// valid = 0), tidx [K, 8] their int32 particle indices. For each live
// lane it sums kernel D's pair terms (glt_common.cuh :: hydro_pair, the
// arithmetic of kernel D and of the plain version) over the valid sources
// (row 12 > 0) of the 8 odd source blocks entry_blk[e] + {0,1}^3 of src16
// (the odd pack, [B, 16, lanes]) with r < max(h_i, h_j), dx = (t - s) +
// (1 - 2g) * Lf per axis. out is [K, 5, 8] = ax, ay, az, raw dA/dt, max
// signal velocity; padded entries (entry_blk = -1) and dead lanes write 0.
//
// Relative mode: the self-pair is excluded by comparing int32 particle
// indices (tidx against idx_o), as kernel D does. The JAX entry kernel
// tests r > 0 instead, which holds only in absolute coordinates: in
// relative coordinates the self-pair's r is rounding, and kept, it would
// set the target's signal velocity to 2 c_i through the max. Absolute
// mode (tgt16 and src16 hold absolute x, y, z, src16 has (nb+1)^3 blocks,
// dx = t - s with no shift): the JAX kernel's own rule, r > 0; the target
// rows come from the same table row as the source copy, so the self-pair's
// r2 is exactly 0 (tidx and idx_o are not read).
//
// What bounds it on the card. An entry's 8 odd blocks hold 8 * lanes
// source slots of 13 rows: 2,048 at 2x128^3 against up to 8 live lanes,
// 262,144 on the Leicester disc's 2^3 blocks of 4,096 slots a subcell,
// few of them within reach of an entry's lanes. Few pairs lie inside the
// support: the kernel is bound by the latency of its loads, not by
// arithmetic or bytes.
//
// What the design does about it: kernel F's three launches
// (csrc/sph_density_entries.cu) with hydro's reach.
// - Chunk boxes. glt::subcell_boxes_kernel in D's and K's instantiation
//   (valid row 12, h row 7) with parts of 32 slots writes, for each
//   source block and each chunk of 32 slots of it, the bounding box of
//   its valid sources and their largest h (an empty chunk's box is
//   +inf..-inf, beyond any reach), into a workspace of Bo x ceil(lanes /
//   32) x 8 floats that the wrapper allocates.
// - Need words. glt::entries_need_kernel, shared with F, a warp for each
//   group of 32 items (odd block g, chunk c) of each entry, tests the box
//   of the entry's live lanes (row 12 > 0) against each chunk box with the
//   reach max(the live lanes' largest h, the chunk's largest h), and
//   writes the ballot, one word a group, into a second workspace of K x
//   ceil(8 chunks / 32) words.
// - Sums. One warp an entry, four entries a thread block, as the earlier
//   design. The warp walks only the chunks its need words name
//   (glt::NeedItems), the next chunk's rows and index loaded into
//   registers while this one sums. A lane whose own source is invalid, or
//   whose box test fails with the reach max(the live lanes' largest h, its
//   own h), skips the target loop: for every live lane r >= max(h_i, h_j),
//   so the pair would have been left out. The pair arithmetic and the
//   warp reductions (a sum for the first four rows, a max for the signal
//   velocity) are the earlier design's.
// - The order of sums is kept. A 32-slot chunk starting at a multiple of
//   32 holds slot k at lane k mod 32, as the earlier design's loop (k =
//   lane; k < lanes; k += 32) mapped slots to lanes, so skipping whole
//   chunks and single sources that add nothing leaves every lane's
//   sequence of added terms (g = 0..7, then k ascending) and the warp's
//   shuffle tree unchanged. Built with -fmad=false on both, G equals its
//   earlier design (one warp per entry walking every slot) bit for bit in
//   both modes; with nvcc's default contraction into FMAs its rows may
//   differ in their last bits (PERF.md section 6).
// nvcc 12.8 -Xptxas=-v for sm_90a: the sums 124 registers relative, 118
// absolute (the earlier design 94, 91), 2,304 and 2,176 bytes of shared
// memory a block of 128 threads; the need words 30, the chunk boxes 40.

#include "glt_common.cuh"

namespace {

using glt::kEntryLanes;
using glt::kEntryWarps;
using glt::kFull;

constexpr int kRows = 12;   // src16 rows 0-11 of a pair; row 12 is valid
// the entry's target rows: tgt16 [K, 16, 8], live where row 12 > 0, h in
// row 7
using Rows = glt::EntryRows<16, 12, 7>;

template <bool kAbs>
__global__ void __launch_bounds__(32 * kEntryWarps)
    sph_hydro_entries_kernel(const float* __restrict__ tgt16,
                             const int* __restrict__ tidx,
                             const float* __restrict__ src16,
                             const int* __restrict__ idx_o,
                             const int* __restrict__ entry_blk,
                             const unsigned* __restrict__ need,
                             const float* __restrict__ params,
                             float* __restrict__ out, int nb, int lanes,
                             int chunks, int groups, int k_entries, float lf,
                             float half_visc) {
  constexpr glt::Shift kShift = kAbs ? glt::Shift::kNone : glt::Shift::kPair;
  __shared__ float s_t[kEntryWarps][16 * kEntryLanes];
  __shared__ float s_hinv[kEntryWarps][kEntryLanes];
  __shared__ int s_id[kEntryWarps][kEntryLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kEntryWarps + warp;
  if (e >= k_entries) return;  // whole warps leave together
  float* o = out + static_cast<size_t>(e) * 5 * kEntryLanes;
  const int b = entry_blk[e];
  if (b < 0) {
    for (int i = lane; i < 5 * kEntryLanes; i += 32) o[i] = 0.f;
    return;
  }
  float* t = s_t[warp];
  const float* tg = Rows::rows(tgt16, e);
  for (int i = lane; i < 16 * kEntryLanes; i += 32) t[i] = tg[i];
  if (lane < kEntryLanes) {
    s_hinv[warp][lane] = glt::inv_or_zero(tg[7 * kEntryLanes + lane]);
    if (!kAbs)
      s_id[warp][lane] = tidx[static_cast<size_t>(e) * kEntryLanes + lane];
  }
  __syncwarp();
  const unsigned live = __ballot_sync(
      kFull, lane < kEntryLanes && t[12 * kEntryLanes + lane] > 0.f);
  const glt::Box tbox = Rows::box(t, t + 7 * kEntryLanes, lane);
  const glt::OddBlocks ob = glt::odd_blocks(b, nb, lf);
  const float hubble_a2_flow = params[0];
  const float fac_mu = params[1];
  // the items within reach, in order
  glt::NeedItems items{need + static_cast<size_t>(e) * groups, groups, lane};
  // this lane's source of item u: rows 0-11 into v, row 12 into valid and
  // its particle index into id (left as they are past the last slot: the
  // caller zeroes valid, so the source is invalid there)
  auto load = [&](int u, float (&v)[kRows], float& valid, int& id) {
    const int k = (u % chunks) * 32 + lane;
    if (k < lanes) {
      const size_t blk = ob.block<kAbs>(u / chunks);
      const float* s = src16 + blk * 16 * lanes + k;
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = s[r * lanes];
      valid = s[12 * lanes];
      if (!kAbs) id = idx_o[blk * lanes + k];
    }
  };

  float acc[kEntryLanes][5];
#pragma unroll
  for (int l = 0; l < kEntryLanes; ++l)
#pragma unroll
    for (int r = 0; r < 5; ++r) acc[l][r] = 0.f;

  int u = live ? items.next() : -1;
  float cur[kRows] = {}, cur_valid = 0.f;
  int cur_id = -1;
  if (u >= 0) load(u, cur, cur_valid, cur_id);
  while (u >= 0) {
    const int nu = items.next();
    float nxt[kRows] = {}, nxt_valid = 0.f;
    int nxt_id = -1;
    if (nu >= 0) load(nu, nxt, nxt_valid, nxt_id);  // in flight meanwhile
    float sh[3];
    ob.shifts<kAbs>(u / chunks, sh);
    const float s3[3] = {cur[0], cur[1], cur[2]};
    if (cur_valid > 0.f &&
        glt::near_boxes<kShift>(tbox, s3, s3, cur[7], sh)) {
#pragma unroll
      for (int l = 0; l < kEntryLanes; ++l) {
        if (!((live >> l) & 1u)) continue;  // uniform across the warp
        if (!kAbs && s_id[warp][l] == cur_id) continue;  // the self-pair
        const float dx = kAbs ? t[l] - cur[0] : (t[l] - cur[0]) + sh[0];
        const float dy = kAbs ? t[kEntryLanes + l] - cur[1]
                              : (t[kEntryLanes + l] - cur[1]) + sh[1];
        const float dz = kAbs ? t[2 * kEntryLanes + l] - cur[2]
                              : (t[2 * kEntryLanes + l] - cur[2]) + sh[2];
        const float r2 = dx * dx + dy * dy + dz * dz;
        const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
        const float r = r2 * rinv;
        if (!(r < fmaxf(t[7 * kEntryLanes + l], cur[7]))) continue;
        if (kAbs && !(r > 0.f)) continue;  // the self-pair
        const glt::HydroTarget tt = {
            t[4 * kEntryLanes + l],  t[5 * kEntryLanes + l],
            t[6 * kEntryLanes + l],  t[7 * kEntryLanes + l],
            t[8 * kEntryLanes + l],  t[9 * kEntryLanes + l],
            t[10 * kEntryLanes + l], t[11 * kEntryLanes + l]};
        glt::hydro_pair(dx, dy, dz, r, rinv, tt, s_hinv[warp][l], cur,
                        hubble_a2_flow, fac_mu, half_visc, acc[l]);
      }
    }
    u = nu;
#pragma unroll
    for (int r = 0; r < kRows; ++r) cur[r] = nxt[r];
    cur_valid = nxt_valid;
    cur_id = nxt_id;
  }
#pragma unroll
  for (int l = 0; l < kEntryLanes; ++l) {
    const bool on = (live >> l) & 1u;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      float v = 0.f;
      if (on) v = r < 4 ? glt::warp_sum(acc[l][r]) : glt::warp_max(acc[l][r]);
      if (lane == l) o[r * kEntryLanes + l] = v;
    }
  }
}

// the three launches of kernel G on st: chunk boxes, need words, sums
template <bool kAbs>
int launch_entries(const float* tgt16, const int* tidx, const float* src16,
                   const int* idx_o, const int* entry_blk,
                   const float* params, float* boxes, unsigned* need,
                   float* out, int nb, int lanes, int k_entries, float lf,
                   float half_visc, cudaStream_t st) {
  const int bo = kAbs ? (nb + 1) * (nb + 1) * (nb + 1) : nb * nb * nb;
  const int chunks = (lanes + 31) / 32;
  const int groups = (8 * chunks + 31) / 32;
  glt::launch_boxes<16, 12, 7>(src16, boxes, bo, lanes, 32, st);
  glt::launch_need<Rows, kAbs>(tgt16, nullptr, entry_blk, boxes, need, nb,
                               chunks, groups, k_entries, lf, st);
  sph_hydro_entries_kernel<kAbs>
      <<<(k_entries + kEntryWarps - 1) / kEntryWarps, 32 * kEntryWarps, 0,
         st>>>(tgt16, tidx, src16, idx_o, entry_blk, need, params, out, nb,
               lanes, chunks, groups, k_entries, lf, half_visc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int glt_sph_hydro_entries(const float* tgt16, const int* tidx,
                                     const float* src16, const int* idx_o,
                                     const int* entry_blk,
                                     const float* params, float* boxes,
                                     unsigned* need, float* out, int nb,
                                     int lanes, int k_entries, float lf,
                                     float half_visc, void* stream) {
  return launch_entries<false>(tgt16, tidx, src16, idx_o, entry_blk, params,
                               boxes, need, out, nb, lanes, k_entries, lf,
                               half_visc, static_cast<cudaStream_t>(stream));
}

extern "C" int glt_sph_hydro_entries_abs(const float* tgt16,
                                         const float* src16,
                                         const int* entry_blk,
                                         const float* params, float* boxes,
                                         unsigned* need, float* out, int nb,
                                         int lanes, int k_entries,
                                         float half_visc, void* stream) {
  return launch_entries<true>(tgt16, nullptr, src16, nullptr, entry_blk,
                              params, boxes, need, out, nb, lanes, k_entries,
                              0.f, half_visc,
                              static_cast<cudaStream_t>(stream));
}
