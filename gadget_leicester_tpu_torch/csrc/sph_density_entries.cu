// Kernel F: SPH density sums over compacted active entries.
//
// Replaces gadget_leicester_tpu/ops/sph_blocks.py ::
// density_sums_blocks_entries (kernel body _make_sph_entries_kernel,
// kind "density"). Plain PyTorch twin: ops/sph_blocks.py ::
// density_sums_blocks_entries_plain.
//
// What it computes. An entry is at most 8 active gas targets of one even
// block (ops/cells.py :: build_active_entries on the even list). tgt
// [K, 8, 8] holds their rows in the layout of the even pack (x, y, z
// relative to the even block's centre, m, vx, vy, vz, 1; a dead lane has
// m = 0), gathered by the pack's own arithmetic; h [K, 8] their smoothing
// lengths. For each live lane it sums kernel C's pair terms
// (glt_common.cuh :: density_pair), self-pair included as in C, over the
// 8 odd source blocks entry_blk[e] + {0,1}^3 of soa_o with the constant
// shifts (1 - 2g) * Lf. out is [K, 6, 8] = rho, drho/dh, raw div v, raw
// rot v; padded or switched-off entries (entry_blk = -1: the Newton loop
// switches off entries whose lanes have all converged) and dead lanes
// write 0.
//
// What bounds it on the card. 8 * 256 = 2048 source slots per entry at
// the 2x128^3 configuration, about 57 KB of source rows, against ~1.6
// live lanes: bound by memory latency, not arithmetic (kernel C's design,
// one thread per target slot, would idle 7 threads in 8).
//
// What the design does about it. One warp per entry, four entries per
// thread block; each thread walks 64 sources with coalesced reads and
// keeps the 8 targets' six sums in registers (targets in shared memory,
// read as broadcasts); dead lanes are skipped by a branch uniform across
// the warp, parked sources (m = 0) per thread; the warp sums each live
// lane with shuffles. The TPU kernel's padded odd layout and
// double-buffered DMA are not carried over.

#include "glt_common.cuh"

namespace {

using glt::kEntryLanes;
using glt::kEntryWarps;

__global__ void sph_density_entries_kernel(
    const float* __restrict__ soa_o, const float* __restrict__ tgt,
    const float* __restrict__ h, const int* __restrict__ entry_blk,
    float* __restrict__ out, int nb, int lanes, int k_entries, float lf) {
  __shared__ float s_t[kEntryWarps][8 * kEntryLanes];
  __shared__ float s_hinv[kEntryWarps][kEntryLanes];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * kEntryWarps + warp;
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
  for (int i = lane; i < 8 * kEntryLanes; i += 32) t[i] = tg[i];
  if (lane < kEntryLanes)
    hinv[lane] =
        glt::inv_or_zero(h[static_cast<size_t>(e) * kEntryLanes + lane]);
  __syncwarp();
  const unsigned live =
      __ballot_sync(0xffffffffu, lane < kEntryLanes &&
                                     t[3 * kEntryLanes + lane] > 0.f);

  float acc[kEntryLanes][6];
#pragma unroll
  for (int l = 0; l < kEntryLanes; ++l)
#pragma unroll
    for (int r = 0; r < 6; ++r) acc[l][r] = 0.f;

  const int bx = b / (nb * nb), by = (b / nb) % nb, bz = b % nb;
  for (int g = 0; g < 8; ++g) {
    const int gx = g >> 2, gy = (g >> 1) & 1, gz = g & 1;
    const int src = (glt::wrap(bx + gx, nb) * nb + glt::wrap(by + gy, nb)) *
                        nb +
                    glt::wrap(bz + gz, nb);
    const float* s = soa_o + static_cast<size_t>(src) * 8 * lanes;
    const float shx = static_cast<float>(1 - 2 * gx) * lf;
    const float shy = static_cast<float>(1 - 2 * gy) * lf;
    const float shz = static_cast<float>(1 - 2 * gz) * lf;
    for (int k = lane; k < lanes; k += 32) {
      const float m = s[3 * lanes + k];
      if (m == 0.f) continue;  // parked slot
      const float sx = s[k], sy = s[lanes + k], sz = s[2 * lanes + k];
      const float svx = s[4 * lanes + k], svy = s[5 * lanes + k],
                  svz = s[6 * lanes + k];
#pragma unroll
      for (int l = 0; l < kEntryLanes; ++l) {
        if (!((live >> l) & 1u)) continue;  // uniform across the warp
        glt::density_pair((t[l] - sx) + shx,
                          (t[kEntryLanes + l] - sy) + shy,
                          (t[2 * kEntryLanes + l] - sz) + shz,
                          t[4 * kEntryLanes + l] - svx,
                          t[5 * kEntryLanes + l] - svy,
                          t[6 * kEntryLanes + l] - svz, m, hinv[l], acc[l]);
      }
    }
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

}  // namespace

extern "C" int glt_sph_density_entries(const float* soa_o, const float* tgt,
                                       const float* h, const int* entry_blk,
                                       float* out, int nb, int lanes,
                                       int k_entries, float lf,
                                       void* stream) {
  const int blocks = (k_entries + kEntryWarps - 1) / kEntryWarps;
  sph_density_entries_kernel<<<blocks, 32 * kEntryWarps, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      soa_o, tgt, h, entry_blk, out, nb, lanes, k_entries, lf);
  return static_cast<int>(cudaGetLastError());
}
