// Kernel L: cloud-in-cell interpolation of a K-component periodic PM mesh
// field to particle positions.
//
// Replaces gadget_leicester_tpu/ops/pm_tiles.py :: pm_gather_tiles (kernel
// body _make_gather_col_kernel) and serves the PM step's gather, which the
// JAX package keeps as a row gather (ops/pm.py :: cic_gather_vec). Plain
// PyTorch twin: ops/pm.py :: cic_gather_vec_plain.
//
// What it computes. pos is [N, 3], wrapped into [0, box] by the caller
// (torch.remainder), field the periodic mesh [n, n, n, K] (K = 1 to 4: the
// potential, the three force components, or the four together). For each
// particle, with u = pos * scale (scale = n / box rounded to the working
// type), i0 = floor(u) as an integer, its remainder mod n, and frac = u -
// floor(u):
//   out[i, k] = sum over dx, dy, dz in {0, 1}, in that order, of
//               field[(i0 + (dx, dy, dz)) mod n, k] * ((wx wy) wz),
// w = 1 - frac or frac per axis, added to 0 one corner at a time. That is
// ops/pm.py's row gather operation for operation, each product and sum
// rounded on its own (__fmul_rn, __fadd_rn: nvcc contracts nothing into an
// FMA), so the kernel equals cic_gather_vec_plain bit for bit. u == n maps
// to index 0 with frac 0. A position that is not finite, or whose floor
// does not fit an int64, takes index 0 (the plain version's is undefined):
// whatever it is given, the kernel reads only inside the mesh. Rows of
// dead particles are the callers' to mask. float32 and float64.
//
// What bounds it on the card. Bytes: the positions and the output once,
// the mesh once, about 185 MB at 2x128^3 with pmgrid 192 and K = 3 (the
// mesh 85 MB of it); 8 corners of K values per particle are read at
// random, from L2 where the particles' order follows space.
//
// What the design does about it. One thread per particle, in particle
// order, reading its 8 corners straight from the mesh through L1 and L2:
// no staging and no pack. Particle order on the main path is the ICs'
// lattice order, which the particles keep as they move, so a warp's
// corners fall on a few mesh lines. The earlier design staged a window of
// the mesh per short-range cell in shared memory, about 470 MB of staged
// reads for the 85 MB mesh; the TPU kernel's one-hot contractions,
// wrap-padded mesh and column walk served a machine that cannot address at
// random, and none is carried over.

#include "glt_common.cuh"

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float floor_t(float a) { return floorf(a); }
__device__ __forceinline__ double floor_t(double a) { return ::floor(a); }

// floor(u) (already integral) as an int64, then its remainder mod n in [0,
// n); 0 where it is not finite or beyond the int64 range
template <typename T>
__device__ __forceinline__ int wrap_floor(T f, int n) {
  if (!(f >= T(-9.2e18) && f <= T(9.2e18))) return 0;
  const int r = static_cast<int>(static_cast<long long>(f) % n);
  return r < 0 ? r + n : r;
}

template <typename T, int K>
__global__ void pm_gather_kernel(const T* __restrict__ pos,
                                 const T* __restrict__ field,
                                 T* __restrict__ out, int n_part, int n,
                                 T scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_part) return;
  int i0[3];
  T w[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T u = mul_rn(pos[static_cast<size_t>(i) * 3 + a], scale);
    const T f = floor_t(u);
    const T frac = sub_rn(u, f);
    i0[a] = wrap_floor(f, n);
    w[a][0] = sub_rn(T(1), frac);
    w[a][1] = frac;
  }
  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int ix = dx && i0[0] + 1 == n ? 0 : i0[0] + dx;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int iy = dy && i0[1] + 1 == n ? 0 : i0[1] + dy;
      const T wxy = mul_rn(w[0][dx], w[1][dy]);
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int iz = dz && i0[2] + 1 == n ? 0 : i0[2] + dz;
        const T wgt = mul_rn(wxy, w[2][dz]);
        // n <= 1290 (the wrapper's limit): the cell index fits an int
        const T* v = field + static_cast<size_t>((ix * n + iy) * n + iz) * K;
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc[k] = add_rn(acc[k], mul_rn(__ldg(v + k), wgt));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[static_cast<size_t>(i) * K + k] = acc[k];
}

template <typename T>
cudaError_t launch(const void* pos, const void* field, void* out, int n_part,
                   int n, int k_comp, double scale, cudaStream_t st) {
  constexpr int kThreads = 256;
  const int blocks = (n_part + kThreads - 1) / kThreads;
  const T* p = static_cast<const T*>(pos);
  const T* f = static_cast<const T*>(field);
  T* o = static_cast<T*>(out);
  // the scale rounded to the working type, as PyTorch rounds a Python
  // float multiplying a tensor
  const T s = static_cast<T>(scale);
  switch (k_comp) {
    case 1:
      pm_gather_kernel<T, 1><<<blocks, kThreads, 0, st>>>(p, f, o, n_part, n, s);
      break;
    case 2:
      pm_gather_kernel<T, 2><<<blocks, kThreads, 0, st>>>(p, f, o, n_part, n, s);
      break;
    case 3:
      pm_gather_kernel<T, 3><<<blocks, kThreads, 0, st>>>(p, f, o, n_part, n, s);
      break;
    case 4:
      pm_gather_kernel<T, 4><<<blocks, kThreads, 0, st>>>(p, f, o, n_part, n, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// scale: n / box as a double (rounded to float32 for f64 = 0); f64: the
// tensors are float64
extern "C" int glt_pm_gather(const void* pos, const void* field, void* out,
                             int n_part, int n, int k_comp, double scale,
                             int f64, void* stream) {
  if (n_part <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? launch<double>(pos, field, out, n_part, n, k_comp, scale, st)
          : launch<float>(pos, field, out, n_part, n, k_comp, scale, st));
}
