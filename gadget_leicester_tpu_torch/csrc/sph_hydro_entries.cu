// Kernel G: SPH hydro force sums over compacted active entries.
//
// Replaces gadget_leicester_tpu/ops/sph_blocks.py ::
// hydro_sums_blocks_entries (kernel body _make_sph_entries_kernel, kind
// "hydro"). Plain PyTorch twin: ops/sph_blocks.py ::
// hydro_sums_blocks_entries_plain.
//
// What it computes. An entry is at most 8 active gas targets of one even
// block. tgt16 [K, 16, 8] holds their rows in the layout of kernel D's
// even pack (x, y, z relative to the even block's centre, m, vx, vy, vz,
// h, rho, P/rho^2 f, c_sound, Balsara, valid, 0, 0, 0; a dead lane has
// valid = 0), tidx [K, 8] their int32 particle indices. For each live
// lane it sums kernel D's pair terms (glt_common.cuh :: hydro_pair, the
// arithmetic of kernel D and of the plain version) over
// the 8 odd source blocks entry_blk[e] + {0,1}^3 of src16 (the odd pack,
// [B, 16, lanes]) with the shifts (1 - 2g) * Lf. out is [K, 5, 8] = ax,
// ay, az, raw dA/dt, max signal velocity; padded entries (entry_blk = -1)
// and dead lanes write 0.
//
// The self-pair is excluded by comparing int32 particle indices (tidx
// against idx_o), as kernel D does. The JAX entry kernel tests r > 0
// instead, which holds only in absolute coordinates: in these relative
// coordinates the self-pair's r is rounding, and kept, it would set the
// target's signal velocity to 2 c_i through the max.
//
// What bounds it on the card. 8 * 256 = 2048 source slots per entry at
// 2x128^3, about 115 KB of source rows, against ~1.6 live lanes: bound by
// memory latency.
//
// What the design does about it. As kernel F: one warp per entry, four
// entries per block, 64 sources per thread with coalesced reads, the 8
// targets' five sums in registers (targets in shared memory), dead lanes
// skipped uniformly across the warp, invalid sources per thread; the
// warp reduces each live lane with shuffles, a sum for the first four
// sums and a max for the signal velocity.

#include "glt_common.cuh"

namespace {

using glt::kEntryLanes;
using glt::kEntryWarps;

__global__ void sph_hydro_entries_kernel(
    const float* __restrict__ tgt16, const int* __restrict__ tidx,
    const float* __restrict__ src16, const int* __restrict__ idx_o,
    const int* __restrict__ entry_blk, const float* __restrict__ params,
    float* __restrict__ out, int nb, int lanes, int k_entries, float lf,
    float half_visc) {
  __shared__ float s_t[kEntryWarps][16 * kEntryLanes];
  __shared__ float s_hinv[kEntryWarps][kEntryLanes];
  __shared__ int s_id[kEntryWarps][kEntryLanes];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * kEntryWarps + warp;
  if (e >= k_entries) return;  // whole warps leave together
  float* o = out + static_cast<size_t>(e) * 5 * kEntryLanes;
  const int b = entry_blk[e];
  if (b < 0) {
    for (int i = lane; i < 5 * kEntryLanes; i += 32) o[i] = 0.f;
    return;
  }
  float* t = s_t[warp];
  const float* tg = tgt16 + static_cast<size_t>(e) * 16 * kEntryLanes;
  for (int i = lane; i < 16 * kEntryLanes; i += 32) t[i] = tg[i];
  if (lane < kEntryLanes) {
    s_hinv[warp][lane] = glt::inv_or_zero(tg[7 * kEntryLanes + lane]);
    s_id[warp][lane] = tidx[static_cast<size_t>(e) * kEntryLanes + lane];
  }
  __syncwarp();
  const unsigned live =
      __ballot_sync(0xffffffffu, lane < kEntryLanes &&
                                     t[12 * kEntryLanes + lane] > 0.f);
  const float hubble_a2_flow = params[0];
  const float fac_mu = params[1];

  float acc[kEntryLanes][5];
#pragma unroll
  for (int l = 0; l < kEntryLanes; ++l)
#pragma unroll
    for (int r = 0; r < 5; ++r) acc[l][r] = 0.f;

  const int bx = b / (nb * nb), by = (b / nb) % nb, bz = b % nb;
  for (int g = 0; g < 8; ++g) {
    const int gx = g >> 2, gy = (g >> 1) & 1, gz = g & 1;
    const int src = (glt::wrap(bx + gx, nb) * nb + glt::wrap(by + gy, nb)) *
                        nb +
                    glt::wrap(bz + gz, nb);
    const float* s = src16 + static_cast<size_t>(src) * 16 * lanes;
    const int* sid = idx_o + static_cast<size_t>(src) * lanes;
    const float shx = static_cast<float>(1 - 2 * gx) * lf;
    const float shy = static_cast<float>(1 - 2 * gy) * lf;
    const float shz = static_cast<float>(1 - 2 * gz) * lf;
    for (int k = lane; k < lanes; k += 32) {
      if (!(s[12 * lanes + k] > 0.f)) continue;  // invalid source
      float sv[12];  // rows 0-11, read once for all the lanes
#pragma unroll
      for (int row = 0; row < 12; ++row) sv[row] = s[row * lanes + k];
      const int id = sid[k];
#pragma unroll
      for (int l = 0; l < kEntryLanes; ++l) {
        if (!((live >> l) & 1u)) continue;  // uniform across the warp
        if (s_id[warp][l] == id) continue;  // the self-pair
        const float dx = (t[l] - sv[0]) + shx;
        const float dy = (t[kEntryLanes + l] - sv[1]) + shy;
        const float dz = (t[2 * kEntryLanes + l] - sv[2]) + shz;
        const float r2 = dx * dx + dy * dy + dz * dz;
        const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
        const float r = r2 * rinv;
        if (!(r < fmaxf(t[7 * kEntryLanes + l], sv[7]))) continue;
        const glt::HydroTarget tt = {
            t[4 * kEntryLanes + l],  t[5 * kEntryLanes + l],
            t[6 * kEntryLanes + l],  t[7 * kEntryLanes + l],
            t[8 * kEntryLanes + l],  t[9 * kEntryLanes + l],
            t[10 * kEntryLanes + l], t[11 * kEntryLanes + l]};
        glt::hydro_pair(dx, dy, dz, r, rinv, tt, s_hinv[warp][l], sv,
                        hubble_a2_flow, fac_mu, half_visc, acc[l]);
      }
    }
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

}  // namespace

extern "C" int glt_sph_hydro_entries(const float* tgt16, const int* tidx,
                                     const float* src16, const int* idx_o,
                                     const int* entry_blk,
                                     const float* params, float* out, int nb,
                                     int lanes, int k_entries, float lf,
                                     float half_visc, void* stream) {
  const int blocks = (k_entries + kEntryWarps - 1) / kEntryWarps;
  sph_hydro_entries_kernel<<<blocks, 32 * kEntryWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      tgt16, tidx, src16, idx_o, entry_blk, params, out, nb, lanes,
      k_entries, lf, half_visc);
  return static_cast<int>(cudaGetLastError());
}
