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
// What bounds it on the H100. Its floor is bytes: per cell it reads alpha,
// three phi (f32) and three uc (f32 or bf16) and writes three low (f32)
// and three anti (f32 or bf16): 56 MB per 112³ call with bf16 uc/anti,
// 16.8 µs at 3.35 TB/s. The arithmetic is about 30 flops and 2 IEEE
// divisions per face (the van Leer limiter, twice), 90 flops per cell.
// What bounded the earlier design (one thread per cell, 40.3 µs) was the
// divisions: a division whose dividend is ±0 (up = 0 across a uniform
// region, r + |r| = 0 whenever r ≤ 0) leaves the IEEE division's fast
// path, and such faces are most of a real step's. `limited` skips those
// divisions where the result is known, bitwise as the plain formula.
//
// Design: a 2.5-D march along x. A block owns a 16 × 16 (y, z) tile, one
// cell per thread, and walks a chunk of x planes sized so that the
// grid's blocks fill the card once at the kernel's occupancy (a 28-plane
// shard still fills it). The four x taps of alpha (planes i−2 … i+1) roll
// through each thread's registers, plane i+2 loaded one plane ahead, so
// each x tap is loaded once; the y and z taps are read through L1 with
// clamped indices (the block's neighbours loaded them one plane before).
// The x clamps are taken once per plane (the plane read is the clamped or
// halo plane), not per tap. All arithmetic is f32, in flux_all_plain's
// order; bf16 is widened on load and rounded once on store, so the
// kernel is bitwise equal to the plain version.
//
// Measured against this design on the H100 (PERF.md §6): 4 or 2 z cells
// per thread with 16-/8-byte accesses, and y/z taps from a shared-memory
// copy of each plane staged by cp.async with one barrier per plane, were
// each slower: the kernel is latency-bound on its divisions, and more
// registers per thread or a barrier per plane leave fewer warps to hide
// them.
//
// The halo variant (`mules_flux_halo_launch`) replaces the TPU kernel
// mules_flux.py `flux_all_h` (mules_flux.py:179), the per-shard kernel of
// the x-sharded step: the same kernel with HALO set, where the x planes
// −2, −1 and nx of the shard's slab are read from the exchanged halo
// planes (h_lo: 2 planes, h_hi: 1), chosen once per plane. It never
// clamps in x: at the global ends the halos hold the clamp planes. Same
// bytes plus three planes, same bound, and the same arithmetic per cell,
// so the shards composed equal the single-grid kernel bitwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTZ = 16, kTY = 16;         // tile, cells along z and y
constexpr int kBlock = kTZ * kTY;
// Blocks per launch: about kWaves times what the card holds at once at
// this kernel's occupancy (one wave: the most blocks in flight, no tail).
constexpr float kWaves = 1.0f;
// Blocks per SM the register budget is set for (40 registers a thread):
// the kernel is latency-bound on its divisions, so warps in flight count
// more than the registers the compiler would otherwise take.
constexpr int kMinBlocks = 6;
constexpr float kEps = 1e-30f;

// van Leer limiter φ(r)·Δdown, r = Δup/Δdown (mules_flux.py `_limited`),
// bitwise the plain version's φ = (r + |r|)/(1 + |r|) for every input: a
// division whose dividend is ±0 (up = 0 in a uniform region; r + |r| for
// r ≤ 0) takes the IEEE division's slow path, so it is skipped where its
// result is known: up = ±0 gives r = ±0, and any r ≤ 0 but −∞ gives
// r + |r| = +0, φ = +0 either way.
__device__ __forceinline__ float limited(float up, float down) {
  const float safe = fabsf(down) > kEps ? down : (down >= 0.0f ? kEps : -kEps);
  float phi = 0.0f;
  if (up != 0.0f) {
    const float r = up / safe;
    if (!(r <= 0.0f) || r == -INFINITY) phi = (r + fabsf(r)) / (1.0f + fabsf(r));
  }
  return phi * down;
}

struct LowAnti {
  float low, anti;
};

// (low, anti) through the lower face of a cell from alpha at the cells
// −2, −1, 0, +1 along the face's axis, its phi and its uc.
__device__ __forceinline__ LowAnti face_from(float am2, float am1, float a0,
                                             float ap1, float ph, float u) {
  const float d0 = am1 - am2;
  const float d1 = a0 - am1;
  const float d2 = ap1 - a0;
  const float fl = am1 + 0.5f * limited(d0, d1);
  const float fr = a0 - 0.5f * limited(d2, d1);
  const float low = ph * (ph >= 0.0f ? am1 : a0);
  float high = ph * (ph >= 0.0f ? fl : fr);
  const float ac = u >= 0.0f ? fl : fr;
  high = high + u * ac * (1.0f - ac);
  return {low, high - low};
}

__device__ __forceinline__ float ld(const float* a, int64_t i) { return a[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* a, int64_t i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void st(float* a, int64_t i, float v) { a[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* a, int64_t i, float v) {
  a[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int clampi(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

template <typename TU, typename TA>
struct Args {
  const float *alpha, *h_lo, *h_hi;
  const float *phx, *phy, *phz;
  const TU *ucx, *ucy, *ucz;
  float *olx, *oly, *olz;
  TA *oax, *oay, *oaz;
  int nx, ny, nz, cx;   // cx: x planes per block
};

// Alpha's x plane q (−2 … nx) as an (ny, nz) array: the slab's plane, or
// with HALO a halo plane outside the slab, else the clamped edge plane.
template <typename TU, typename TA, bool HALO>
__device__ __forceinline__ const float* plane(const Args<TU, TA>& a, int q) {
  const int64_t sx = (int64_t)a.ny * a.nz;
  if (HALO) {
    if (q < 0) return a.h_lo + (q + 2) * sx;
    if (q >= a.nx) return a.h_hi;
  }
  return a.alpha + clampi(q, a.nx) * sx;
}

template <typename TU, typename TA, bool HALO>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
flux_all_kernel(const Args<TU, TA> a) {
  const int k = blockIdx.x * kTZ + threadIdx.x;
  const int j = blockIdx.y * kTY + threadIdx.y;
  if (k >= a.nz || j >= a.ny) return;
  const int i0 = blockIdx.z * a.cx;
  const int i1 = i0 + a.cx < a.nx ? i0 + a.cx : a.nx;
  const int64_t sx = (int64_t)a.ny * a.nz;
  const int64_t q = (int64_t)j * a.nz + k;   // the cell's place in a plane
  // Rows j−2, j−1, j+1 and columns k−2, k−1, k+1 of a plane, clamped.
  const int64_t y2 = (int64_t)clampi(j - 2, a.ny) * a.nz + k;
  const int64_t y1 = (int64_t)clampi(j - 1, a.ny) * a.nz + k;
  const int64_t yp = (int64_t)clampi(j + 1, a.ny) * a.nz + k;
  const int64_t z2 = (int64_t)j * a.nz + clampi(k - 2, a.nz);
  const int64_t z1 = (int64_t)j * a.nz + clampi(k - 1, a.nz);
  const int64_t zp = (int64_t)j * a.nz + clampi(k + 1, a.nz);
  // Alpha at x−2 … x+1 for the cell, plane x+2 loaded one plane ahead.
  float am2 = plane<TU, TA, HALO>(a, i0 - 2)[q];
  float am1 = plane<TU, TA, HALO>(a, i0 - 1)[q];
  float a0 = plane<TU, TA, HALO>(a, i0)[q];
  float ap1 = plane<TU, TA, HALO>(a, i0 + 1)[q];
  for (int i = i0; i < i1; ++i) {
    const float nxt = i + 1 < i1 ? plane<TU, TA, HALO>(a, i + 2)[q] : 0.0f;
    const float* pl = a.alpha + i * sx;
    const int64_t c = i * sx + q;
    LowAnti f = face_from(am2, am1, a0, ap1, a.phx[c], ld(a.ucx, c));
    a.olx[c] = f.low;
    st(a.oax, c, f.anti);
    f = face_from(pl[y2], pl[y1], a0, pl[yp], a.phy[c], ld(a.ucy, c));
    a.oly[c] = f.low;
    st(a.oay, c, f.anti);
    f = face_from(pl[z2], pl[z1], a0, pl[zp], a.phz[c], ld(a.ucz, c));
    a.olz[c] = f.low;
    st(a.oaz, c, f.anti);
    am2 = am1;
    am1 = a0;
    a0 = ap1;
    ap1 = nxt;
  }
}

// x planes per block for `tiles` (y, z) tiles of an nx-plane grid: the
// fewest that keep the launch within kWaves waves of the current device
// at the kernel's occupancy (asked at every launch: a process may use
// more than one card).
template <typename K>
int chunk_planes(K kernel, int threads, int tiles, int nx) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  int chunks = (int)(kWaves * (float)(sms * per_sm)) / tiles;
  chunks = chunks < 1 ? 1 : (chunks > nx ? nx : chunks);
  return (nx + chunks - 1) / chunks;
}

template <typename TU, typename TA, bool HALO>
void launch(const void* const* in, const void* const* halo, void* const* out,
            int nx, int ny, int nz, cudaStream_t stream) {
  Args<TU, TA> a;
  a.alpha = static_cast<const float*>(in[0]);
  a.h_lo = static_cast<const float*>(halo[0]);
  a.h_hi = static_cast<const float*>(halo[1]);
  a.phx = static_cast<const float*>(in[1]);
  a.phy = static_cast<const float*>(in[2]);
  a.phz = static_cast<const float*>(in[3]);
  a.ucx = static_cast<const TU*>(in[4]);
  a.ucy = static_cast<const TU*>(in[5]);
  a.ucz = static_cast<const TU*>(in[6]);
  a.olx = static_cast<float*>(out[0]);
  a.oax = static_cast<TA*>(out[1]);
  a.oly = static_cast<float*>(out[2]);
  a.oay = static_cast<TA*>(out[3]);
  a.olz = static_cast<float*>(out[4]);
  a.oaz = static_cast<TA*>(out[5]);
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  const int tiles = ((nz + kTZ - 1) / kTZ) * ((ny + kTY - 1) / kTY);
  a.cx = chunk_planes(flux_all_kernel<TU, TA, HALO>, kBlock, tiles, nx);
  const dim3 block(kTZ, kTY);
  const dim3 grid((nz + kTZ - 1) / kTZ, (ny + kTY - 1) / kTY,
                  (nx + a.cx - 1) / a.cx);
  flux_all_kernel<TU, TA, HALO><<<grid, block, 0, stream>>>(a);
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
