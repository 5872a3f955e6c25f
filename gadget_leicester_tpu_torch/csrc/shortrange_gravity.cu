// Kernels A and H: TreePM short-range gravity over cell tiles, without
// (A) and with (H) the potential.
//
// Replaces gadget_leicester_tpu/ops/pallas_cells.py ::
// shortrange_gravity_pallas_dma9 (kernel body _make_kernel_dma9) in its
// cell-relative mode (A, C entry glt_shortrange_gravity; its
// with_potential mode on the step is H on the step's pack), and
// shortrange_gravity_pallas_dma (kernel body _make_kernel_dma, with
// with_potential; H, C entry glt_shortrange_potential), whose one caller
// is models/forces.py :: compute_potential. Plain PyTorch twins:
// ops/gravity_short.py :: shortrange_gravity_tiles_plain and
// shortrange_potential_tiles_plain.
//
// What it computes. soa is the [C, 8, cap] pack of ops/cells.py ::
// pack_cells_soa (rows x, y, z relative to the cell centre, m, soft, 1,
// 1/soft, 0; parked slots at -7 cells with m = 0). For every target slot
// of a cell whose flag is set it sums, over the 27 neighbour cells and for
// 0 < r2 < rcut^2,
//   ax -= m_j g(r) trunc(r / (2 asmth)) dx     (and y, z)
//   pot += m_j grav_pot(r) erfc(r / (2 asmth))  (H only)
// with source coordinates shifted by the stencil offset times the cell
// edge. The shift is exact for stale in-margin assignments because
// relative coordinates are wrap-invariant. The TPU kernel of H works in
// absolute coordinates with a wrap shift per tile; the relative pack
// computes the same function, and a target meets its own slot at r2 == 0
// exactly (same pack value, centre shift 0), so the self-pair, whose
// softened potential -2.8/h would dominate, adds nothing. A cell whose
// flag is 0 writes zeros. out is [C, 3, cap] (A: ax, ay, az) or [C, 4,
// cap] (H: ax, ay, az, pot), without the factor G.
//
// What bounds it on the card. At 2x128^3 (C = 34^3, cap = 128, about 107
// live slots a cell) the stencil holds 1.2e10 pairs, 15% of them inside
// rcut, which is about one cell edge. A warp pays the whole pair
// arithmetic for a source whenever one of its 32 targets is inside rcut,
// so the kernel is bound by instruction issue, divergence and the latency
// of the pair arithmetic's dependent chain (rsqrt, the degree-10
// polynomials), not by the FP32 pipes or by bytes (27 source tiles of 3 KB
// a cell, from L2). The potential (H) adds its factor and the erfc
// polynomial to the same pairs: its support is the force's, 0 < r2 <
// rcut^2.
//
// What the design does about it.
// - Targets in space order. A thread block is one cell, one thread a
//   target slot. The block ranks its live slots by a Morton key of their
//   position on an 8^3 grid over the cell (ties by slot; parked slots
//   last; glt::morton_key, glt::rank_slots), so each warp holds 32 close
//   targets, and reduces their bounding box with shuffles. A cell of more
//   than 128 slots (H on a fresh cell list) takes one pass of 128 slots
//   after another, each ranked on its own.
// - Warp-uniform culling. For each staged chunk of sources every lane
//   tests one source against its warp's box, and a ballot gives the
//   sources within rcut (1 + 1e-5) of the box; the warp then walks only
//   those, in increasing slot order, each lane adding its own pair
//   through glt::gravity_pair (A) or glt::gravity_potential_pair (H), two
//   sources at a time where there are two (the two pairs' arithmetic
//   overlaps; the sums stay in order). The test is conservative: the box
//   distance per axis, max(lo - s, s - hi, 0), is in float32 never above
//   |t - s| for a target t of the box (rounding is monotone), and the
//   1e-5 margin covers the rounding of the sum of squares, so a dropped
//   source is one that the pair functions would have added nothing for
//   (r2 >= rcut2) for every target of the warp, in the force and the
//   potential alike. Parked sources (m = 0) are dropped as before. About
//   half of the stencil's warp-source iterations are left (PERF.md
//   section 6).
// - The order of sums is kept: each target adds its pairs stencil cell j
//   = 0..26, then slot k = 0..cap-1, skipping only pairs that add
//   nothing. So A equals its earlier design bit for bit; H is the same
//   kernel with the potential row (kPot), and walks the same sources in
//   the same order, so its force rows equal A's bit for bit.
// - Staging through registers, double-buffered: the 27 tiles are one
//   stream of 27 cap sources in chunks of one slot a thread; each thread
//   loads its slot of the next chunk (shifted x, y, z and m as a float4,
//   soft and 1/soft as a float2) before the warp sums the current one, and
//   stores it after, so one barrier a chunk separates the two buffers and
//   the loads overlap the sums.
// Not used: compaction of pairs into queues or atomics on the sums, which
// would change the order of sums. nvcc 12.8 -Xptxas=-v for sm_90a: A 56
// registers, H 54, 7,168 bytes of shared memory a block of 128 threads.

#include "glt_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// a source is culled only beyond rcut (1 + 1e-5) of its warp's box
constexpr float kCullMargin2 = 1.00002f;
constexpr int kKeyBits = glt::kKeyBits;

// the cell of x on the key's grid over the target's cell
__device__ __forceinline__ unsigned key_axis(float x, float scale) {
  // __fmul_rn and __fadd_rn: no contraction, so the host can repeat it
  const float f = floorf(__fadd_rn(__fmul_rn(x, scale),
                                   static_cast<float>(1 << (kKeyBits - 1))));
  return static_cast<unsigned>(
      min(max(static_cast<int>(f), 0), (1 << kKeyBits) - 1));
}

// kPot: H, with the potential as a fourth output row
template <bool kPot>
__global__ void __launch_bounds__(kThreads)
    shortrange_gravity_kernel(const float* __restrict__ soa,
                              const int* __restrict__ flags,
                              float* __restrict__ out, int n, int cap,
                              float edge, float half_inv_asmth, float rcut2,
                              float cull2, float key_scale) {
  constexpr int kRowsOut = kPot ? 4 : 3;
  const int c = blockIdx.x;
  float* o = out + static_cast<size_t>(c) * kRowsOut * cap;
  if (flags[c] == 0) {
    for (int t = threadIdx.x; t < cap; t += blockDim.x) {
#pragma unroll
      for (int r = 0; r < kRowsOut; ++r) o[r * cap + t] = 0.f;
    }
    return;
  }
  __shared__ float4 s_pos[2][kThreads];   // x, y, z shifted; m
  __shared__ float2 s_soft[2][kThreads];  // soft, 1/soft
  __shared__ unsigned s_key[kThreads];
  __shared__ int s_slot[kThreads];

  const int nt = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int cx = c / (n * n), cy = (c / n) % n, cz = c % n;
  const float* tile = soa + static_cast<size_t>(c) * 8 * cap;
  const int total = 27 * cap;
  const int steps = (total + nt - 1) / nt;

  // source u of the stream (stencil cell j = u / cap, slot u % cap),
  // shifted by its stencil offset as the earlier design staged it (m = 0
  // past the stream's end)
  auto fetch = [&](int u, float4& p, float2& h) {
    p = make_float4(0.f, 0.f, 0.f, 0.f);
    h = make_float2(0.f, 0.f);
    if (u >= total) return;
    const int j = u / cap, k = u - j * cap;
    const int ox = j / 9 - 1, oy = (j / 3) % 3 - 1, oz = j % 3 - 1;
    const int src = (glt::wrap(cx + ox, n) * n + glt::wrap(cy + oy, n)) * n +
                    glt::wrap(cz + oz, n);
    const float* s = soa + static_cast<size_t>(src) * 8 * cap;
    p = make_float4(s[k] + static_cast<float>(ox) * edge,
                    s[cap + k] + static_cast<float>(oy) * edge,
                    s[2 * cap + k] + static_cast<float>(oz) * edge,
                    s[3 * cap + k]);
    h = make_float2(s[4 * cap + k], s[6 * cap + k]);
  };

  for (int t0 = 0; t0 < cap; t0 += nt) {
    // 1. rank this pass's slots: live ones by Morton key, parked ones last
    {
      const int t = t0 + threadIdx.x;
      unsigned key = kFull;
      if (t < cap && tile[5 * cap + t] > 0.f)
        key = glt::morton_key(key_axis(tile[t], key_scale),
                              key_axis(tile[cap + t], key_scale),
                              key_axis(tile[2 * cap + t], key_scale));
      glt::rank_slots(key, t, s_key, s_slot);
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
    const float inf = __int_as_float(0x7f800000);
    float lox = live ? tx : inf, hix = live ? tx : -inf;
    float loy = live ? ty : inf, hiy = live ? ty : -inf;
    float loz = live ? tz : inf, hiz = live ? tz : -inf;
    for (int off = 16; off > 0; off >>= 1) {
      lox = fminf(lox, __shfl_xor_sync(kFull, lox, off));
      loy = fminf(loy, __shfl_xor_sync(kFull, loy, off));
      loz = fminf(loz, __shfl_xor_sync(kFull, loz, off));
      hix = fmaxf(hix, __shfl_xor_sync(kFull, hix, off));
      hiy = fmaxf(hiy, __shfl_xor_sync(kFull, hiy, off));
      hiz = fmaxf(hiz, __shfl_xor_sync(kFull, hiz, off));
    }
    const bool warp_live = __any_sync(kFull, live);

    // 3. the stream of 27 * cap sources in chunks of nt, double-buffered
    float ax = 0.f, ay = 0.f, az = 0.f, pot = 0.f;
    float4 p;
    float2 h;
    fetch(threadIdx.x, p, h);
    s_pos[0][threadIdx.x] = p;
    s_soft[0][threadIdx.x] = h;
    __syncthreads();
    auto pair = [&](const float4& q, const float2& hq) {
      if constexpr (kPot)
        glt::gravity_potential_pair(tx, ty, tz, th, thinv, q.x, q.y, q.z,
                                    q.w, hq.x, hq.y, half_inv_asmth, rcut2,
                                    ax, ay, az, pot);
      else
        glt::gravity_pair(tx, ty, tz, th, thinv, q.x, q.y, q.z, q.w, hq.x,
                          hq.y, half_inv_asmth, rcut2, ax, ay, az);
    };
    for (int step = 0; step < steps; ++step) {
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
            const float ex = fmaxf(fmaxf(lox - q.x, q.x - hix), 0.f);
            const float ey = fmaxf(fmaxf(loy - q.y, q.y - hiy), 0.f);
            const float ez = fmaxf(fmaxf(loz - q.z, q.z - hiz), 0.f);
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
      if constexpr (kPot) o[3 * cap + ts] = pot;
    }
  }
}

template <bool kPot>
int launch(const float* soa, const int* flags, float* out, int n_cells,
           int cap, float edge, float half_inv_asmth, float rcut2,
           void* stream) {
  const int c = n_cells * n_cells * n_cells;
  const int threads = cap < kThreads ? ((cap + 31) / 32) * 32 : kThreads;
  const float key_scale = static_cast<float>(1 << kKeyBits) / edge;
  shortrange_gravity_kernel<kPot><<<c, threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      soa, flags, out, n_cells, cap, edge, half_inv_asmth, rcut2,
      rcut2 * kCullMargin2, key_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int glt_shortrange_gravity(const float* soa, const int* flags,
                                      float* out, int n_cells, int cap,
                                      float edge, float half_inv_asmth,
                                      float rcut2, void* stream) {
  return launch<false>(soa, flags, out, n_cells, cap, edge, half_inv_asmth,
                       rcut2, stream);
}

extern "C" int glt_shortrange_potential(const float* soa, const int* flags,
                                        float* out, int n_cells, int cap,
                                        float edge, float half_inv_asmth,
                                        float rcut2, void* stream) {
  return launch<true>(soa, flags, out, n_cells, cap, edge, half_inv_asmth,
                      rcut2, stream);
}

extern "C" const char* glt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
