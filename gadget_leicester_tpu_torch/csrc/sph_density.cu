// Kernel C: SPH density sums over block tiles.
//
// Replaces gadget_leicester_tpu/ops/sph_blocks.py :: density_sums_blocks
// (kernel body _make_density_block_kernel) in both its modes: block-
// relative on a periodic grid (C entry glt_sph_density) and absolute on a
// clamped (vacuum) grid (relative=False there; C entry
// glt_sph_density_abs). Plain PyTorch twin: ops/sph_blocks.py ::
// density_sums_blocks_plain.
//
// What it computes. soa_e / soa_o are the even [B, 8, lanes] and odd
// [Bo, 8, lanes] packs of ops/sph_blocks.py :: pack_sph_soa (rows x, y,
// z, m, vx, vy, vz, h; parked slots with m = 0). For each target slot of
// an even block b whose flag is set, over the 8 odd source blocks
// b + {0,1}^3:
//   rho = sum m W(r, h_i),  drho/dh = sum m dW/dh,
//   div = -sum m dW/dr / r (dv . dx),  rot = sum m dW/dr / r (dv x dx).
// Relative mode: x, y, z relative to the block centre, Bo = B = nb^3, the
// source blocks wrap mod nb and dx = (t - s) + (1 - 2g) * Lf per axis.
// Absolute mode: absolute x, y, z, Bo = (nb+1)^3 with no wrap, dx = t - s;
// a parked slot's position (-7 fine cells) may lie inside the cloud, so a
// source is skipped by its mass, never by its distance, and a target that
// is parked or has h = 0 (the Newton loop passes 0 for slots it does not
// solve) writes zeros. The 8-block stencil is complete because the caller
// caps h at (1 - 2 kappa) times the fine-cell edge. A block whose flag is
// 0 writes zeros. out is [B, 6, lanes].
//
// What bounds it on the card. Pairs: at 2x128^3, B = 22^3 and lanes = 256,
// 8 * 256 * 256 pairs per block, 5.6e9 per sweep at about 50 float32
// operations each, and the Newton loop runs up to 40 sweeps (later sweeps
// only on blocks with unconverged targets). Bound by the FP32 pipes. A
// vacuum disc fills few blocks, each with a few dense subcells: subcap
// grows to hundreds of slots, most of them parked.
//
// What the design does about it. One thread per target lane; each odd
// source tile is staged in shared memory in chunks of kTile slots (7 rows)
// and read by every thread. Parked sources are skipped with a branch
// uniform across the block. Relative mode: one thread block per even
// block, looping over its lanes. Absolute mode: a thread block per
// blockDim-wide slice of an even block's lanes (a second grid dimension),
// which leaves at once when no target of its slice is live, and a staged
// chunk whose sources are all parked is skipped whole. The TPU kernel's
// z-split and z-padded source layout are not carried over.

#include "glt_common.cuh"

namespace {

template <bool kAbs>
__global__ void sph_density_kernel(const float* __restrict__ soa_e,
                                   const float* __restrict__ soa_o,
                                   const float* __restrict__ h,
                                   const int* __restrict__ flags,
                                   float* __restrict__ out, int nb,
                                   int lanes, float lf) {
  const int b = blockIdx.x;
  float* o = out + static_cast<size_t>(b) * 6 * lanes;
  if (flags[b] == 0) {
    if constexpr (kAbs) {
      const int t = blockIdx.y * blockDim.x + threadIdx.x;
      if (t < lanes)
        for (int r = 0; r < 6; ++r) o[r * lanes + t] = 0.f;
    } else {
      for (int t = threadIdx.x; t < 6 * lanes; t += blockDim.x) o[t] = 0.f;
    }
    return;
  }
  __shared__ float s_x[glt::kTile], s_y[glt::kTile], s_z[glt::kTile];
  __shared__ float s_m[glt::kTile];
  __shared__ float s_vx[glt::kTile], s_vy[glt::kTile], s_vz[glt::kTile];

  const int bx = b / (nb * nb), by = (b / nb) % nb, bz = b % nb;
  const int nbo = kAbs ? nb + 1 : nb;
  const float* tile = soa_e + static_cast<size_t>(b) * 8 * lanes;

  // relative: this block loops over all lanes; absolute: its own slice
  // (computed here, not held across the branch above: 8 registers more)
  for (int t0 = kAbs ? blockIdx.y * blockDim.x : 0; t0 < lanes;
       t0 += kAbs ? gridDim.y * blockDim.x : blockDim.x) {
    const int t = t0 + threadIdx.x;
    bool live = t < lanes;
    float tx = 0.f, ty = 0.f, tz = 0.f, tvx = 0.f, tvy = 0.f, tvz = 0.f;
    float hinv = 0.f;
    if (live) {
      tx = tile[t];
      ty = tile[lanes + t];
      tz = tile[2 * lanes + t];
      tvx = tile[4 * lanes + t];
      tvy = tile[5 * lanes + t];
      tvz = tile[6 * lanes + t];
      hinv = glt::inv_or_zero(h[static_cast<size_t>(b) * lanes + t]);
      if constexpr (kAbs) live = tile[3 * lanes + t] > 0.f && hinv > 0.f;
    }
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    // absolute mode: a slice with no live target writes its zeros and
    // stages nothing (the test is uniform across the block)
    if (!kAbs || __syncthreads_or(live)) {
      for (int g = 0; g < 8; ++g) {
        const int gx = g >> 2, gy = (g >> 1) & 1, gz = g & 1;
        const int src =
            kAbs ? ((bx + gx) * nbo + (by + gy)) * nbo + (bz + gz)
                 : (glt::wrap(bx + gx, nb) * nb + glt::wrap(by + gy, nb)) *
                           nb +
                       glt::wrap(bz + gz, nb);
        const float* s = soa_o + static_cast<size_t>(src) * 8 * lanes;
        const float shx = kAbs ? 0.f : static_cast<float>(1 - 2 * gx) * lf;
        const float shy = kAbs ? 0.f : static_cast<float>(1 - 2 * gy) * lf;
        const float shz = kAbs ? 0.f : static_cast<float>(1 - 2 * gz) * lf;
        for (int s0 = 0; s0 < lanes; s0 += glt::kTile) {
          const int len = min(glt::kTile, lanes - s0);
          bool any = false;
          __syncthreads();
          for (int k = threadIdx.x; k < len; k += blockDim.x) {
            s_x[k] = s[s0 + k];
            s_y[k] = s[lanes + s0 + k];
            s_z[k] = s[2 * lanes + s0 + k];
            s_m[k] = s[3 * lanes + s0 + k];
            s_vx[k] = s[4 * lanes + s0 + k];
            s_vy[k] = s[5 * lanes + s0 + k];
            s_vz[k] = s[6 * lanes + s0 + k];
            if constexpr (kAbs) any = any || s_m[k] != 0.f;
          }
          if constexpr (kAbs) {
            if (!__syncthreads_or(any)) continue;  // every source parked
          } else {
            __syncthreads();
          }
          if (!live) continue;
          for (int k = 0; k < len; ++k) {
            const float m = s_m[k];
            if (m == 0.f) continue;  // parked slot: uniform across the block
            // absolute mode: dx = t - s, with no shift
            if constexpr (kAbs)
              glt::density_pair(tx - s_x[k], ty - s_y[k], tz - s_z[k],
                                tvx - s_vx[k], tvy - s_vy[k], tvz - s_vz[k],
                                m, hinv, acc);
            else
              glt::density_pair((tx - s_x[k]) + shx, (ty - s_y[k]) + shy,
                                (tz - s_z[k]) + shz, tvx - s_vx[k],
                                tvy - s_vy[k], tvz - s_vz[k], m, hinv, acc);
          }
        }
      }
    }
    if (t < lanes) {
#pragma unroll
      for (int r = 0; r < 6; ++r) o[r * lanes + t] = acc[r];
    }
  }
}

int threads_for(int lanes) {
  return lanes < 256 ? ((lanes + 31) / 32) * 32 : 256;
}

}  // namespace

extern "C" int glt_sph_density(const float* soa_e, const float* soa_o,
                               const float* h, const int* flags, float* out,
                               int nb, int lanes, float lf, void* stream) {
  const int blocks = nb * nb * nb;
  sph_density_kernel<false><<<blocks, threads_for(lanes), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      soa_e, soa_o, h, flags, out, nb, lanes, lf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glt_sph_density_abs(const float* soa_e, const float* soa_o,
                                   const float* h, const int* flags,
                                   float* out, int nb, int lanes,
                                   void* stream) {
  const int threads = threads_for(lanes);
  const dim3 grid(nb * nb * nb, (lanes + threads - 1) / threads);
  sph_density_kernel<true><<<grid, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      soa_e, soa_o, h, flags, out, nb, lanes, 0.f);
  return static_cast<int>(cudaGetLastError());
}
