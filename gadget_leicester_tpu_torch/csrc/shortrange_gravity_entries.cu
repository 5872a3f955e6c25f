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
// H. Both modes are one template on kPot, so the force-only instantiation
// compiles to the code it was before the potential mode came.
//
// What bounds it on the card. At a near-idle sync point of the 2x128^3
// box an entry has about 1.6 live lanes of 8, so one thread per target
// slot (kernel A's design) would leave most threads idle. The work is
// 27 * 128 = 3456 source slots per entry, about 83 KB of source rows read
// from L2 or device memory and ~1.6 * 3456 pair terms: bound by memory
// latency, not arithmetic.
//
// What the design does about it. One warp per entry, four entries per
// thread block; each warp walks the entry's sources, 108 per thread, with
// coalesced reads of the pack rows, and keeps the 8 targets' accumulators
// in registers (the targets themselves in shared memory, read as
// broadcasts). Dead lanes are skipped by a branch uniform across the warp,
// parked sources (m = 0) per thread. The warp then sums each live lane
// with shuffles. The TPU kernel's padded stencil layout and double-buffered
// DMA are not carried over.

#include "glt_common.cuh"

namespace {

using glt::kEntryLanes;
using glt::kEntryWarps;

template <bool kPot>
__global__ void shortrange_gravity_entries_kernel(
    const float* __restrict__ soa, const int* __restrict__ entry_cell,
    const float* __restrict__ tgt, float* __restrict__ out, int n, int cap,
    int k_entries, float edge, float half_inv_asmth, float rcut2) {
  constexpr int kRows = kPot ? 4 : 3;
  __shared__ float s_t[kEntryWarps][8 * kEntryLanes];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * kEntryWarps + warp;
  if (e >= k_entries) return;  // whole warps leave together
  float* o = out + static_cast<size_t>(e) * kRows * kEntryLanes;
  const int c = entry_cell[e];
  if (c < 0) {
    if (lane < kRows * kEntryLanes) o[lane] = 0.f;
    return;
  }
  float* t = s_t[warp];
  const float* tg = tgt + static_cast<size_t>(e) * 8 * kEntryLanes;
  for (int i = lane; i < 8 * kEntryLanes; i += 32) t[i] = tg[i];
  __syncwarp();
  const unsigned live =
      __ballot_sync(0xffffffffu, lane < kEntryLanes &&
                                     t[5 * kEntryLanes + lane] > 0.f);

  float ax[kEntryLanes], ay[kEntryLanes], az[kEntryLanes];
  float pot[kPot ? kEntryLanes : 1];
#pragma unroll
  for (int l = 0; l < kEntryLanes; ++l) ax[l] = ay[l] = az[l] = 0.f;
#pragma unroll
  for (int l = 0; l < (kPot ? kEntryLanes : 1); ++l) pot[l] = 0.f;

  const int cx = c / (n * n), cy = (c / n) % n, cz = c % n;
  for (int j = 0; j < 27; ++j) {
    const int ox = j / 9 - 1, oy = (j / 3) % 3 - 1, oz = j % 3 - 1;
    const int src = (glt::wrap(cx + ox, n) * n + glt::wrap(cy + oy, n)) * n +
                    glt::wrap(cz + oz, n);
    const float* s = soa + static_cast<size_t>(src) * 8 * cap;
    const float shx = static_cast<float>(ox) * edge;
    const float shy = static_cast<float>(oy) * edge;
    const float shz = static_cast<float>(oz) * edge;
    for (int k = lane; k < cap; k += 32) {
      const float m = s[3 * cap + k];
      if (m == 0.f) continue;  // parked slot
      const float sx = s[k] + shx;
      const float sy = s[cap + k] + shy;
      const float sz = s[2 * cap + k] + shz;
      const float sh = s[4 * cap + k];
      const float shinv = s[6 * cap + k];
#pragma unroll
      for (int l = 0; l < kEntryLanes; ++l) {
        if (!((live >> l) & 1u)) continue;  // uniform across the warp
        if constexpr (kPot) {
          glt::gravity_potential_pair(
              t[l], t[kEntryLanes + l], t[2 * kEntryLanes + l],
              t[4 * kEntryLanes + l], t[6 * kEntryLanes + l], sx, sy, sz, m,
              sh, shinv, half_inv_asmth, rcut2, ax[l], ay[l], az[l], pot[l]);
        } else {
          glt::gravity_pair(t[l], t[kEntryLanes + l], t[2 * kEntryLanes + l],
                            t[4 * kEntryLanes + l], t[6 * kEntryLanes + l],
                            sx, sy, sz, m, sh, shinv, half_inv_asmth, rcut2,
                            ax[l], ay[l], az[l]);
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kEntryLanes; ++l) {
    float vx = 0.f, vy = 0.f, vz = 0.f, vp = 0.f;
    if ((live >> l) & 1u) {
      vx = glt::warp_sum(ax[l]);
      vy = glt::warp_sum(ay[l]);
      vz = glt::warp_sum(az[l]);
      if constexpr (kPot) vp = glt::warp_sum(pot[l]);
    }
    if (lane == l) {
      o[l] = vx;
      o[kEntryLanes + l] = vy;
      o[2 * kEntryLanes + l] = vz;
      if constexpr (kPot) o[3 * kEntryLanes + l] = vp;
    }
  }
}

template <bool kPot>
int launch_entries(const float* soa, const int* entry_cell, const float* tgt,
                   float* out, int n_cells, int cap, int k_entries,
                   float edge, float half_inv_asmth, float rcut2,
                   void* stream) {
  const int blocks = (k_entries + kEntryWarps - 1) / kEntryWarps;
  shortrange_gravity_entries_kernel<kPot>
      <<<blocks, 32 * kEntryWarps, 0, static_cast<cudaStream_t>(stream)>>>(
          soa, entry_cell, tgt, out, n_cells, cap, k_entries, edge,
          half_inv_asmth, rcut2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int glt_shortrange_gravity_entries(const float* soa,
                                              const int* entry_cell,
                                              const float* tgt, float* out,
                                              int n_cells, int cap,
                                              int k_entries, float edge,
                                              float half_inv_asmth,
                                              float rcut2, void* stream) {
  return launch_entries<false>(soa, entry_cell, tgt, out, n_cells, cap,
                               k_entries, edge, half_inv_asmth, rcut2, stream);
}

// The potential mode: out [K, 4, 8], row 3 the potential (no G).
extern "C" int glt_shortrange_potential_entries(const float* soa,
                                                const int* entry_cell,
                                                const float* tgt, float* out,
                                                int n_cells, int cap,
                                                int k_entries, float edge,
                                                float half_inv_asmth,
                                                float rcut2, void* stream) {
  return launch_entries<true>(soa, entry_cell, tgt, out, n_cells, cap,
                              k_entries, edge, half_inv_asmth, rcut2, stream);
}
