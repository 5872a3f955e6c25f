// Kernel D: SPH hydro force sums over block tiles.
//
// Replaces gadget_leicester_tpu/ops/sph_blocks.py :: hydro_sums_blocks
// (kernel body _make_hydro_block_kernel) in both its modes: block-relative
// on a periodic grid (C entry glt_sph_hydro) and absolute on a clamped
// (vacuum) grid (relative=False there; C entry glt_sph_hydro_abs). Plain
// PyTorch twin: ops/sph_blocks.py :: hydro_sums_blocks_plain.
//
// What it computes. Targets come from the even block's [B, 8, lanes]
// soa_a (x, y, z, m, vx, vy, vz, h) and [B, 8, lanes] soa_b (rho,
// P/rho^2 f, c_sound, Balsara, valid, ...); sources from the odd blocks'
// [Bo, 16, lanes] src16 (rows 0-7 as soa_a, 8-12 as soa_b rows 0-4). For
// each pair with r < max(h_i, h_j) and a valid source it evaluates the
// entropy-form pair force with Monaghan-Balsara viscosity, the Balsara
// limiter, the Hubble-flow term and fac_mu [G2: hydra.c ::
// hydro_evaluate()], and writes out[B, 5, lanes] = ax, ay, az, raw dA/dt,
// max signal velocity. The caller applies the (gamma-1) / (a^2 H
// rho^(gamma-1)) factor.
//
// Relative mode: x, y, z relative to the block centre, Bo = B, the source
// blocks wrap mod nb, dx = (t - s) + (1 - 2g) * Lf. The self-pair is
// excluded by comparing int32 particle indices (idx_e, idx_o): its
// separation is zero only up to rounding, and the float32 ids of the JAX
// package are exact only below 2^24 particles. Absolute mode: absolute
// x, y, z, Bo = (nb+1)^3 with no wrap, dx = t - s, and the self-pair is
// dropped by r > 0 as the JAX package drops it there: target and source
// rows are copies of one row of the table, so its r2 is exactly 0 (two
// particles at one position drop each other's pair too, and so each
// other's signal velocity, as in the reference). Invalid targets write
// zeros; a parked source (which may lie inside the cloud) is skipped by
// its valid row.
//
// What bounds it on the card. Pairs, as kernel C (5.6e9 per sweep at
// 2x128^3), with about 80 float32 operations and one division per pair
// inside the support; bound by the FP32 pipes and by divergence at the
// support edge.
//
// What the design does about it. One thread per target lane, each
// 13-row source tile (plus indices in relative mode, 14 KB at 256 lanes)
// staged in shared memory. Invalid sources are skipped with a branch
// uniform across the block. hubble_a2_flow and fac_mu are read from
// device memory, so the launch needs no host sync. Relative mode: one
// thread block per even block. Absolute mode: one per blockDim-wide slice
// of its lanes, leaving at once when no target of the slice is valid and
// skipping a staged chunk of invalid sources whole (kernel C's design).

#include "glt_common.cuh"

namespace {

template <bool kAbs>
__global__ void sph_hydro_kernel(const float* __restrict__ soa_a,
                                 const float* __restrict__ soa_b,
                                 const float* __restrict__ src16,
                                 const int* __restrict__ idx_e,
                                 const int* __restrict__ idx_o,
                                 const int* __restrict__ flags,
                                 const float* __restrict__ params,
                                 float* __restrict__ out, int nb, int lanes,
                                 float lf, float half_visc) {
  const int b = blockIdx.x;
  float* o = out + static_cast<size_t>(b) * 5 * lanes;
  if (flags[b] == 0) {
    if constexpr (kAbs) {
      const int t = blockIdx.y * blockDim.x + threadIdx.x;
      if (t < lanes)
        for (int r = 0; r < 5; ++r) o[r * lanes + t] = 0.f;
    } else {
      for (int t = threadIdx.x; t < 5 * lanes; t += blockDim.x) o[t] = 0.f;
    }
    return;
  }
  __shared__ float s_x[glt::kTile], s_y[glt::kTile], s_z[glt::kTile];
  __shared__ float s_m[glt::kTile], s_h[glt::kTile];
  __shared__ float s_vx[glt::kTile], s_vy[glt::kTile], s_vz[glt::kTile];
  __shared__ float s_rho[glt::kTile], s_por[glt::kTile], s_c[glt::kTile];
  __shared__ float s_bal[glt::kTile], s_valid[glt::kTile];
  __shared__ int s_id[kAbs ? 1 : glt::kTile];

  const float hubble_a2_flow = params[0];
  const float fac_mu = params[1];
  const int bx = b / (nb * nb), by = (b / nb) % nb, bz = b % nb;
  const int nbo = kAbs ? nb + 1 : nb;
  const float* ta = soa_a + static_cast<size_t>(b) * 8 * lanes;
  const float* tb = soa_b + static_cast<size_t>(b) * 8 * lanes;

  // relative: this block loops over all lanes; absolute: its own slice
  // (computed here, not held across the branch above, as in kernel C)
  for (int t0 = kAbs ? blockIdx.y * blockDim.x : 0; t0 < lanes;
       t0 += kAbs ? gridDim.y * blockDim.x : blockDim.x) {
    const int t = t0 + threadIdx.x;
    bool live = t < lanes;
    float tx = 0.f, ty = 0.f, tz = 0.f, tvx = 0.f, tvy = 0.f, tvz = 0.f;
    float ht = 0.f, trho = 0.f, tpor = 0.f, tc = 0.f, tbal = 0.f;
    int tid = -1;
    if (live) {
      tx = ta[t];
      ty = ta[lanes + t];
      tz = ta[2 * lanes + t];
      tvx = ta[4 * lanes + t];
      tvy = ta[5 * lanes + t];
      tvz = ta[6 * lanes + t];
      ht = ta[7 * lanes + t];
      trho = tb[t];
      tpor = tb[lanes + t];
      tc = tb[2 * lanes + t];
      tbal = tb[3 * lanes + t];
      if constexpr (kAbs)
        live = tb[4 * lanes + t] > 0.f;
      else
        tid = idx_e[static_cast<size_t>(b) * lanes + t];
    }
    const float hinv_t = glt::inv_or_zero(ht);
    float ax = 0.f, ay = 0.f, az = 0.f, dte = 0.f, msv = 0.f;
    if (!kAbs || __syncthreads_or(live)) {
      for (int g = 0; g < 8; ++g) {
        const int gx = g >> 2, gy = (g >> 1) & 1, gz = g & 1;
        const int src =
            kAbs ? ((bx + gx) * nbo + (by + gy)) * nbo + (bz + gz)
                 : (glt::wrap(bx + gx, nb) * nb + glt::wrap(by + gy, nb)) *
                           nb +
                       glt::wrap(bz + gz, nb);
        const float* s = src16 + static_cast<size_t>(src) * 16 * lanes;
        const int* sid =
            kAbs ? nullptr : idx_o + static_cast<size_t>(src) * lanes;
        const float shx = kAbs ? 0.f : static_cast<float>(1 - 2 * gx) * lf;
        const float shy = kAbs ? 0.f : static_cast<float>(1 - 2 * gy) * lf;
        const float shz = kAbs ? 0.f : static_cast<float>(1 - 2 * gz) * lf;
        for (int s0 = 0; s0 < lanes; s0 += glt::kTile) {
          const int len = min(glt::kTile, lanes - s0);
          bool any = false;
          __syncthreads();
          for (int k = threadIdx.x; k < len; k += blockDim.x) {
            const int q = s0 + k;
            s_x[k] = s[q];
            s_y[k] = s[lanes + q];
            s_z[k] = s[2 * lanes + q];
            s_m[k] = s[3 * lanes + q];
            s_vx[k] = s[4 * lanes + q];
            s_vy[k] = s[5 * lanes + q];
            s_vz[k] = s[6 * lanes + q];
            s_h[k] = s[7 * lanes + q];
            s_rho[k] = s[8 * lanes + q];
            s_por[k] = s[9 * lanes + q];
            s_c[k] = s[10 * lanes + q];
            s_bal[k] = s[11 * lanes + q];
            s_valid[k] = s[12 * lanes + q];
            if constexpr (kAbs)
              any = any || s_valid[k] > 0.f;
            else
              s_id[k] = sid[q];
          }
          if constexpr (kAbs) {
            if (!__syncthreads_or(any)) continue;  // every source invalid
          } else {
            __syncthreads();
          }
          if (!live) continue;
          for (int k = 0; k < len; ++k) {
            if (!(s_valid[k] > 0.f)) continue;  // uniform across the block
            const float dx = kAbs ? tx - s_x[k] : (tx - s_x[k]) + shx;
            const float dy = kAbs ? ty - s_y[k] : (ty - s_y[k]) + shy;
            const float dz = kAbs ? tz - s_z[k] : (tz - s_z[k]) + shz;
            const float r2 = dx * dx + dy * dy + dz * dz;
            const float rinv = rsqrtf(fmaxf(r2, 1e-37f));
            const float r = r2 * rinv;
            const float hs = s_h[k];
            if (!(r < fmaxf(ht, hs))) continue;
            if constexpr (kAbs) {
              if (!(r > 0.f)) continue;  // the self-pair
            } else {
              if (tid == s_id[k]) continue;  // the self-pair
            }
            const float dwk_i = glt::w4_dw_dr(r, hinv_t);
            const float dwk_j = glt::w4_dw_dr(r, glt::inv_or_zero(hs));
            const float dvx = tvx - s_vx[k];
            const float dvy = tvy - s_vy[k];
            const float dvz = tvz - s_vz[k];
            const float rr = r * r;
            const float vdotr2 =
                dvx * dx + dvy * dy + dvz * dz + hubble_a2_flow * rr;
            const bool approaching = vdotr2 < 0.f;
            const float mu = fac_mu * vdotr2 * rinv;
            const float vsig = tc + s_c[k] - 3.0f * (approaching ? mu : 0.f);
            const float rho_ij = 0.5f * (trho + s_rho[k]);
            const float rs = rsqrtf(fmaxf(rho_ij, 1e-37f));
            const float rho_ij_inv = rs * rs;
            const float f_ij = 0.5f * (tbal + s_bal[k]);
            const float visc =
                approaching ? half_visc * vsig * (-mu) * rho_ij_inv * f_ij
                            : 0.f;
            const float m = s_m[k];
            const float hfc_visc = 0.5f * m * visc * (dwk_i + dwk_j) * rinv;
            const float hfc =
                hfc_visc + m * (tpor * dwk_i + s_por[k] * dwk_j) * rinv;
            ax -= hfc * dx;
            ay -= hfc * dy;
            az -= hfc * dz;
            dte += 0.5f * (hfc_visc * vdotr2);
            msv = fmaxf(msv, vsig);
          }
        }
      }
    }
    if (t < lanes) {
      o[t] = ax;
      o[lanes + t] = ay;
      o[2 * lanes + t] = az;
      o[3 * lanes + t] = dte;
      o[4 * lanes + t] = msv;
    }
  }
}

int threads_for(int lanes) {
  return lanes < 256 ? ((lanes + 31) / 32) * 32 : 256;
}

}  // namespace

extern "C" int glt_sph_hydro(const float* soa_a, const float* soa_b,
                             const float* src16, const int* idx_e,
                             const int* idx_o, const int* flags,
                             const float* params, float* out, int nb,
                             int lanes, float lf, float half_visc,
                             void* stream) {
  const int blocks = nb * nb * nb;
  sph_hydro_kernel<false><<<blocks, threads_for(lanes), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      soa_a, soa_b, src16, idx_e, idx_o, flags, params, out, nb, lanes, lf,
      half_visc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glt_sph_hydro_abs(const float* soa_a, const float* soa_b,
                                 const float* src16, const int* flags,
                                 const float* params, float* out, int nb,
                                 int lanes, float half_visc, void* stream) {
  const int threads = threads_for(lanes);
  const dim3 grid(nb * nb * nb, (lanes + threads - 1) / threads);
  sph_hydro_kernel<true><<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      soa_a, soa_b, src16, nullptr, nullptr, flags, params, out, nb, lanes,
      0.f, half_visc);
  return static_cast<int>(cudaGetLastError());
}
