// Kernel C: SPH density sums over block tiles.
//
// Replaces gadget_leicester_tpu/ops/sph_blocks.py :: density_sums_blocks
// (kernel body _make_density_block_kernel), in its block-relative mode.
// Plain PyTorch twin: ops/sph_blocks.py :: density_sums_blocks_plain.
//
// What it computes. soa_e / soa_o are the even and odd [B, 8, lanes] packs
// of ops/sph_blocks.py :: pack_sph_soa (rows x, y, z relative to the block
// centre, m, vx, vy, vz, h; parked slots with m = 0). For each target slot
// of an even block b whose flag is set, over the 8 odd source blocks
// b + {0,1}^3 (periodic), with the constant shift (1 - 2g) * Lf per axis:
//   rho = sum m W(r, h_i),  drho/dh = sum m dW/dh,
//   div = -sum m dW/dr / r (dv . dx),  rot = sum m dW/dr / r (dv x dx).
// The 8-block stencil is complete because the caller caps h at
// (1 - 2 kappa) times the fine-cell edge. A block whose flag is 0 writes
// zeros. out is [B, 6, lanes].
//
// What bounds it on the card. Pairs: at 2x128^3, B = 22^3 and lanes = 256,
// 8 * 256 * 256 pairs per block, 5.6e9 per sweep at about 50 float32
// operations each, and the Newton loop runs up to 40 sweeps (later sweeps
// only on blocks with unconverged targets). Bound by the FP32 pipes.
//
// What the design does about it. One thread block per even block, one
// thread per target lane; each odd source tile is staged once in shared
// memory (7 rows, 7 KB at 256 lanes) and read by every thread. Parked
// sources are skipped with a branch uniform across the block. The TPU
// kernel's z-split and z-padded source layout are not carried over.

#include "glt_common.cuh"

namespace {

__global__ void sph_density_kernel(const float* __restrict__ soa_e,
                                   const float* __restrict__ soa_o,
                                   const float* __restrict__ h,
                                   const int* __restrict__ flags,
                                   float* __restrict__ out, int nb,
                                   int lanes, float lf) {
  const int b = blockIdx.x;
  float* o = out + static_cast<size_t>(b) * 6 * lanes;
  if (flags[b] == 0) {
    for (int t = threadIdx.x; t < 6 * lanes; t += blockDim.x) o[t] = 0.f;
    return;
  }
  __shared__ float s_x[glt::kTile], s_y[glt::kTile], s_z[glt::kTile];
  __shared__ float s_m[glt::kTile];
  __shared__ float s_vx[glt::kTile], s_vy[glt::kTile], s_vz[glt::kTile];

  const int bx = b / (nb * nb), by = (b / nb) % nb, bz = b % nb;
  const float* tile = soa_e + static_cast<size_t>(b) * 8 * lanes;

  for (int t0 = 0; t0 < lanes; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool live = t < lanes;
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
    }
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int g = 0; g < 8; ++g) {
      const int gx = g >> 2, gy = (g >> 1) & 1, gz = g & 1;
      const int src = (glt::wrap(bx + gx, nb) * nb + glt::wrap(by + gy, nb)) *
                          nb +
                      glt::wrap(bz + gz, nb);
      const float* s = soa_o + static_cast<size_t>(src) * 8 * lanes;
      const float shx = static_cast<float>(1 - 2 * gx) * lf;
      const float shy = static_cast<float>(1 - 2 * gy) * lf;
      const float shz = static_cast<float>(1 - 2 * gz) * lf;
      for (int s0 = 0; s0 < lanes; s0 += glt::kTile) {
        const int len = min(glt::kTile, lanes - s0);
        __syncthreads();
        for (int k = threadIdx.x; k < len; k += blockDim.x) {
          s_x[k] = s[s0 + k];
          s_y[k] = s[lanes + s0 + k];
          s_z[k] = s[2 * lanes + s0 + k];
          s_m[k] = s[3 * lanes + s0 + k];
          s_vx[k] = s[4 * lanes + s0 + k];
          s_vy[k] = s[5 * lanes + s0 + k];
          s_vz[k] = s[6 * lanes + s0 + k];
        }
        __syncthreads();
        if (!live) continue;
        for (int k = 0; k < len; ++k) {
          const float m = s_m[k];
          if (m == 0.f) continue;  // parked slot: uniform across the block
          glt::density_pair((tx - s_x[k]) + shx, (ty - s_y[k]) + shy,
                            (tz - s_z[k]) + shz, tvx - s_vx[k],
                            tvy - s_vy[k], tvz - s_vz[k], m, hinv, acc);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < 6; ++r) o[r * lanes + t] = acc[r];
    }
  }
}

}  // namespace

extern "C" int glt_sph_density(const float* soa_e, const float* soa_o,
                               const float* h, const int* flags, float* out,
                               int nb, int lanes, float lf, void* stream) {
  const int blocks = nb * nb * nb;
  const int threads = lanes < 256 ? ((lanes + 31) / 32) * 32 : 256;
  sph_density_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      soa_e, soa_o, h, flags, out, nb, lanes, lf);
  return static_cast<int>(cudaGetLastError());
}
