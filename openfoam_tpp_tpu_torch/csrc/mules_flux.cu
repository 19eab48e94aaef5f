// MULES flux construction: all six flux arrays (low, anti) × (x, y, z) of
// one alpha subcycle in one pass.
//
// Replaces the TPU kernel openfoam_tpp_tpu/ops/pallas/mules_flux.py
// `flux_all` (mules_flux.py:135, body `_flux_core` at :54).
//
// Layout: cell lower-face. Entry [i, j, k] of an x-face array is the face
// between cells (i−1, j, k) and (i, j, k) (likewise y, z); the global
// upper-boundary faces are implicit zeros. Per face: donor-cell upwind
// low-order flux, van Leer MUSCL reconstruction upwinded by phi, a second
// van Leer reconstruction upwinded by the compression flux uc, and
// anti = high − low. Alpha is read at cells i−2 … i+1 along each axis with
// edge-clamped indices, which is exactly what the TPU kernel's clamped
// index maps (x) and clamped in-slab shifts (y, z) give: at the ends the
// clamps make the upwind slope zero and the limiter drops the correction.
//
// What bounds it on the H100: bytes. Per cell it reads alpha, three phi
// (f32) and three uc (f32 or bf16) and writes three low (f32) and three
// anti (f32 or bf16): 56 MB per 112³ call with bf16 uc/anti, about 17 µs at
// 3.35 TB/s; the arithmetic is about 40 flops and 6 divides per face.
// Design: one thread per cell computing its three lower faces, 32
// consecutive z cells per warp; the 10 alpha reads per cell (3 axes × 4 taps, shared
// centre) are served by L1/L2, so alpha leaves DRAM about once. All
// arithmetic is f32; bf16 is widened on load and rounded once on store.
//
// The halo variant (`mules_flux_halo_launch`) replaces the TPU kernel
// mules_flux.py `flux_all_h` (mules_flux.py:179), the per-shard kernel of
// the x-sharded step: the same kernel with HALO set, where an x-face's
// alpha taps outside the shard's slab (cells −2, −1 and nx) come from the
// exchanged halo planes (h_lo: 2 planes, h_hi: 1). It never clamps: at the
// global ends the halos hold the clamp planes. Same bytes plus three
// planes, same bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Block: 32 cells along z (one warp, contiguous) × 8 along y; the grid's
// z dimension walks x. No integer division in the index math.
constexpr int kBX = 32, kBY = 8, kBlock = kBX * kBY;
constexpr float kEps = 1e-30f;

__device__ __forceinline__ float ld(const float* a, int64_t i) { return a[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* a, int64_t i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void st(float* a, int64_t i, float v) { a[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* a, int64_t i, float v) {
  a[i] = __float2bfloat16_rn(v);
}

// van Leer limiter φ(r)·Δdown, r = Δup/Δdown (mules_flux.py `_limited`).
__device__ __forceinline__ float limited(float up, float down) {
  const float safe = fabsf(down) > kEps ? down : (down >= 0.0f ? kEps : -kEps);
  const float r = up / safe;
  const float phi = (r + fabsf(r)) / (1.0f + fabsf(r));
  return phi * down;
}

__device__ __forceinline__ int clampi(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// (low, anti) through the lower face of cell c from alpha at the cells
// −2, −1, 0, +1 along the face's axis.
template <typename TU, typename TA>
__device__ __forceinline__ void face_from(float am2, float am1, float a0,
                                          float ap1, const float* phi,
                                          const TU* uc, float* low_out,
                                          TA* anti_out, int64_t c) {
  const float d0 = am1 - am2;
  const float d1 = a0 - am1;
  const float d2 = ap1 - a0;
  const float fl = am1 + 0.5f * limited(d0, d1);
  const float fr = a0 - 0.5f * limited(d2, d1);
  const float ph = phi[c];
  const float u = ld(uc, c);
  const float low = ph * (ph >= 0.0f ? am1 : a0);
  float high = ph * (ph >= 0.0f ? fl : fr);
  const float ac = u >= 0.0f ? fl : fr;
  high = high + u * ac * (1.0f - ac);
  low_out[c] = low;
  st(anti_out, c, high - low);
}

// The same with edge-clamped taps; `i` is the cell's index along the axis,
// `s` the axis stride, `n` its extent.
template <typename TU, typename TA>
__device__ __forceinline__ void face(const float* alpha, const float* phi,
                                     const TU* uc, float* low_out,
                                     TA* anti_out, int64_t c, int i,
                                     int64_t s, int n) {
  const int64_t base = c - (int64_t)i * s;
  face_from(alpha[base + (int64_t)clampi(i - 2, n) * s],
            alpha[base + (int64_t)clampi(i - 1, n) * s], alpha[c],
            alpha[base + (int64_t)clampi(i + 1, n) * s], phi, uc, low_out,
            anti_out, c);
}

// HALO: h_lo holds alpha's planes x = −2, −1 of the slab, h_hi plane x = nx.
template <typename TU, typename TA, bool HALO>
__global__ void __launch_bounds__(kBlock)
flux_all_kernel(const float* __restrict__ alpha, const float* __restrict__ h_lo,
                const float* __restrict__ h_hi, const float* __restrict__ phx,
                const float* __restrict__ phy, const float* __restrict__ phz,
                const TU* __restrict__ ucx, const TU* __restrict__ ucy,
                const TU* __restrict__ ucz, float* __restrict__ olx,
                TA* __restrict__ oax, float* __restrict__ oly,
                TA* __restrict__ oay, float* __restrict__ olz,
                TA* __restrict__ oaz, int nx, int ny, int nz) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  const int i = blockIdx.z;
  if (k >= nz || j >= ny) return;
  const int64_t c = ((int64_t)i * ny + j) * nz + k;
  if (HALO) {
    const int64_t sx = (int64_t)ny * nz, q = (int64_t)j * nz + k;
    // Plane x = i + d of the slab: the slab itself or a halo plane.
    auto tap = [&](int d) {
      const int x = i + d;
      return x < 0 ? h_lo[(x + 2) * sx + q] : (x >= nx ? h_hi[q] : alpha[c + d * sx]);
    };
    face_from(tap(-2), tap(-1), alpha[c], tap(1), phx, ucx, olx, oax, c);
  } else {
    face(alpha, phx, ucx, olx, oax, c, i, (int64_t)ny * nz, nx);
  }
  face(alpha, phy, ucy, oly, oay, c, j, (int64_t)nz, ny);
  face(alpha, phz, ucz, olz, oaz, c, k, (int64_t)1, nz);
}

template <typename TU, typename TA, bool HALO>
void launch(const void* const* in, const void* const* halo, void* const* out,
            int nx, int ny, int nz, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY, nx);
  flux_all_kernel<TU, TA, HALO><<<grid, block, 0, stream>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(halo[0]),
      static_cast<const float*>(halo[1]), static_cast<const float*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
      static_cast<const TU*>(in[4]), static_cast<const TU*>(in[5]),
      static_cast<const TU*>(in[6]), static_cast<float*>(out[0]),
      static_cast<TA*>(out[1]), static_cast<float*>(out[2]),
      static_cast<TA*>(out[3]), static_cast<float*>(out[4]),
      static_cast<TA*>(out[5]), nx, ny, nz);
}

template <bool HALO>
int dispatch(int uc_dtype, int anti_dtype, const void* const* in,
             const void* const* halo, void* const* out, int nx, int ny, int nz,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uc_dtype == 0 && anti_dtype == 0)
    launch<float, float, HALO>(in, halo, out, nx, ny, nz, s);
  else if (uc_dtype == 0)
    launch<float, __nv_bfloat16, HALO>(in, halo, out, nx, ny, nz, s);
  else if (anti_dtype == 0)
    launch<__nv_bfloat16, float, HALO>(in, halo, out, nx, ny, nz, s);
  else
    launch<__nv_bfloat16, __nv_bfloat16, HALO>(in, halo, out, nx, ny, nz, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// uc_dtype / anti_dtype: 0 float32, 1 bfloat16. Inputs: alpha, phx, phy,
// phz (f32), ucx, ucy, ucz; outputs: lx, ax, ly, ay, lz, az.
int mules_flux_launch(int uc_dtype, int anti_dtype, const void* alpha,
                      const void* phx, const void* phy, const void* phz,
                      const void* ucx, const void* ucy, const void* ucz,
                      void* olx, void* oax, void* oly, void* oay, void* olz,
                      void* oaz, int nx, int ny, int nz, void* stream) {
  const void* in[7] = {alpha, phx, phy, phz, ucx, ucy, ucz};
  const void* halo[2] = {nullptr, nullptr};
  void* out[6] = {olx, oax, oly, oay, olz, oaz};
  return dispatch<false>(uc_dtype, anti_dtype, in, halo, out, nx, ny, nz,
                         stream);
}

// The same on one shard's (nx, ny, nz) slab: h_lo (2, ny, nz) alpha's
// planes x = −2, −1, h_hi (1, ny, nz) its plane x = nx (f32).
int mules_flux_halo_launch(int uc_dtype, int anti_dtype, const void* alpha,
                           const void* h_lo, const void* h_hi, const void* phx,
                           const void* phy, const void* phz, const void* ucx,
                           const void* ucy, const void* ucz, void* olx,
                           void* oax, void* oly, void* oay, void* olz,
                           void* oaz, int nx, int ny, int nz, void* stream) {
  const void* in[7] = {alpha, phx, phy, phz, ucx, ucy, ucz};
  const void* halo[2] = {h_lo, h_hi};
  void* out[6] = {olx, oax, oly, oay, olz, oaz};
  return dispatch<true>(uc_dtype, anti_dtype, in, halo, out, nx, ny, nz,
                        stream);
}

}  // extern "C"
