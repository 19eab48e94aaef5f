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

// (low, anti) through the lower face of cell c along one axis; `i` is the
// cell's index along that axis, `s` the axis stride, `n` its extent.
template <typename TU, typename TA>
__device__ __forceinline__ void face(const float* alpha, const float* phi,
                                     const TU* uc, float* low_out,
                                     TA* anti_out, int64_t c, int i,
                                     int64_t s, int n) {
  const int64_t base = c - (int64_t)i * s;
  const float am2 = alpha[base + (int64_t)clampi(i - 2, n) * s];
  const float am1 = alpha[base + (int64_t)clampi(i - 1, n) * s];
  const float a0 = alpha[c];
  const float ap1 = alpha[base + (int64_t)clampi(i + 1, n) * s];
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

template <typename TU, typename TA>
__global__ void __launch_bounds__(kBlock)
flux_all_kernel(const float* __restrict__ alpha, const float* __restrict__ phx,
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
  face(alpha, phx, ucx, olx, oax, c, i, (int64_t)ny * nz, nx);
  face(alpha, phy, ucy, oly, oay, c, j, (int64_t)nz, ny);
  face(alpha, phz, ucz, olz, oaz, c, k, (int64_t)1, nz);
}

template <typename TU, typename TA>
void launch(const void* const* in, void* const* out, int nx, int ny, int nz,
            cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY, nx);
  flux_all_kernel<TU, TA><<<grid, block, 0, stream>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
      static_cast<const TU*>(in[4]), static_cast<const TU*>(in[5]),
      static_cast<const TU*>(in[6]), static_cast<float*>(out[0]),
      static_cast<TA*>(out[1]), static_cast<float*>(out[2]),
      static_cast<TA*>(out[3]), static_cast<float*>(out[4]),
      static_cast<TA*>(out[5]), nx, ny, nz);
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
  void* out[6] = {olx, oax, oly, oay, olz, oaz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uc_dtype == 0 && anti_dtype == 0)
    launch<float, float>(in, out, nx, ny, nz, s);
  else if (uc_dtype == 0)
    launch<float, __nv_bfloat16>(in, out, nx, ny, nz, s);
  else if (anti_dtype == 0)
    launch<__nv_bfloat16, float>(in, out, nx, ny, nz, s);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(in, out, nx, ny, nz, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
