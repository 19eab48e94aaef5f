// Fused projection epilogue: the velocity correction of the last PIMPLE
// corrector and the divergence error of the corrected field in one pass.
//
// Replaces the TPU kernel openfoam_tpp_tpu/ops/pallas/correction.py
// `correct_divmax` (correction.py:149, pallas_call at :186, body
// `_corr_core` at :48).
//
// Per face: q_c = q − dt·β_f·∂dp/∂n (gradient_at_faces: zero on the
// domain-boundary faces), plus the open-top half-cell Dirichlet term
// dt·β_top·2·dp/hz on w's face-nz row where the top is open, then masked
// to zero where the aperture is 0. u's face-nx row (the sealed +x wall)
// is written as zeros. Per cell: |∇·(A·q_c)| where vfrac > 0, reduced to
// its maximum. dt is read from device memory (a 0-d tensor), so the step
// never waits on the host for it.
//
// What bounds it on the H100: bytes. It reads dp and vfrac (cells), nine
// face arrays (u, v, w, β×3, A×3) and two (nx, ny) planes, and writes
// three face arrays: 79 MB per 112³ call, about 24 µs at 3.35 TB/s; about
// 32 flops per cell. Design: one thread per cell, 32 consecutive z cells
// per warp. A thread writes the low face of its cell on each axis (and
// the high boundary face where it is last) and recomputes its three high
// faces to form the divergence, so the corrected velocities never make a
// round trip through DRAM. The maximum: each block writes the maximum of
// its cells (a shared-memory tree) and a second one-block pass reduces
// those partials. A maximum is exact, so the result does not depend on
// the order; NaN propagates, as in torch.max.
//
// The halo variant (`correction_halo_launch`) replaces the TPU kernel
// correction.py `correct_divmax_h` (correction.py:219), the per-shard
// kernel of the x-sharded step: the same kernel with HALO set. u, βx and
// ax come packed to the slab's cells; the x face above the slab reads
// their exchanged planes (the next shard's first faces; zeros at the
// global end, the sealed wall's true values), and the x gradient at the
// slab's two end faces reads dp's exchanged ±1 planes (the edge plane at
// the global ends, so the gradient there is (dp0 − dp0)/hx = 0). No wall
// row is written; the maximum is the shard's, reduced over the shards by
// the caller. Same bytes plus five planes, same bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32, kBY = 8, kBlock = kBX * kBY;
constexpr int kMaxBlock = 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// HALO: h = {dp lo, dp hi, u hi, βx hi, ax hi}, (ny, nz) planes each.
struct Halo {
  const float *dp_lo, *dp_hi, *u, *bx, *ax;
};

template <bool OPEN_TOP, bool HALO>
__global__ void __launch_bounds__(kBlock)
correct_divmax_kernel(const Halo h, const float* __restrict__ dt_p,
                      const float* __restrict__ dp,
                      const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ w, const float* __restrict__ bx,
                      const float* __restrict__ by, const float* __restrict__ bz,
                      const float* __restrict__ ax, const float* __restrict__ ay,
                      const float* __restrict__ az, const float* __restrict__ vfrac,
                      const float* __restrict__ topo, const float* __restrict__ rho,
                      float* __restrict__ ou, float* __restrict__ ov,
                      float* __restrict__ ow, float* __restrict__ partial, int nx,
                      int ny, int nz, float hx, float hy, float hz) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  const int i = blockIdx.z;
  float val = 0.0f;
  if (k < nz && j < ny) {
    const float dt = __ldg(dt_p);
    auto cell = [&](int a, int b, int c) { return ((int64_t)a * ny + b) * nz + c; };
    const int64_t c0 = cell(i, j, k);

    // x faces f = i, i+1 of this cell: u layout (nx+1, ny, nz); with HALO
    // (nx, ny, nz), face nx in the halo planes.
    const int64_t pq = (int64_t)j * nz + k;   // the cell's place in a plane
    auto corr_u = [&](int f, float& phi) {
      const int64_t o = cell(f, j, k);
      float g, a, uf, bf;
      if (HALO) {
        const float d1 = f < nx ? __ldg(dp + cell(f, j, k)) : __ldg(h.dp_hi + pq);
        const float d0 = f > 0 ? __ldg(dp + cell(f - 1, j, k)) : __ldg(h.dp_lo + pq);
        g = (d1 - d0) / hx;
        const bool top = f == nx;
        a = top ? __ldg(h.ax + pq) : __ldg(ax + o);
        uf = top ? __ldg(h.u + pq) : __ldg(u + o);
        bf = top ? __ldg(h.bx + pq) : __ldg(bx + o);
      } else {
        g = (f == 0 || f == nx) ? 0.0f
            : (__ldg(dp + cell(f, j, k)) - __ldg(dp + cell(f - 1, j, k))) / hx;
        a = __ldg(ax + o);
        uf = __ldg(u + o);
        bf = __ldg(bx + o);
      }
      const float q = a > 0.0f ? uf - dt * bf * g : 0.0f;
      phi = a * q;
      return q;
    };
    // y faces: v layout (nx, ny+1, nz).
    auto corr_v = [&](int f, float& phi) {
      const int64_t o = ((int64_t)i * (ny + 1) + f) * nz + k;
      const float g = (f == 0 || f == ny) ? 0.0f
                      : (__ldg(dp + cell(i, f, k)) - __ldg(dp + cell(i, f - 1, k))) / hy;
      const float a = __ldg(ay + o);
      const float q = a > 0.0f ? __ldg(v + o) - dt * __ldg(by + o) * g : 0.0f;
      phi = a * q;
      return q;
    };
    // z faces: w layout (nx, ny, nz+1); the open-top row at f == nz.
    auto corr_w = [&](int f, float& phi) {
      const int64_t o = ((int64_t)i * ny + j) * (nz + 1) + f;
      const float g = (f == 0 || f == nz) ? 0.0f
                      : (__ldg(dp + cell(i, j, f)) - __ldg(dp + cell(i, j, f - 1))) / hz;
      const float a = __ldg(az + o);
      float q = __ldg(w + o) - dt * __ldg(bz + o) * g;
      if (OPEN_TOP && f == nz) {
        const int64_t t = (int64_t)i * ny + j;
        const float beta_top = __ldg(topo + t) > 0.0f
                                   ? 1.0f / __ldg(rho + cell(i, j, nz - 1)) : 0.0f;
        q = q + dt * beta_top * 2.0f * __ldg(dp + cell(i, j, nz - 1)) / hz;
      }
      q = a > 0.0f ? q : 0.0f;
      phi = a * q;
      return q;
    };

    float px0, px1, py0, py1, pz0, pz1;
    const float u0 = corr_u(i, px0);
    corr_u(i + 1, px1);
    const float v0 = corr_v(j, py0);
    const float v1 = corr_v(j + 1, py1);
    const float w0 = corr_w(k, pz0);
    const float w1 = corr_w(k + 1, pz1);
    ou[cell(i, j, k)] = u0;
    if (!HALO && i == nx - 1) ou[cell(nx, j, k)] = 0.0f;   // the sealed +x wall row
    ov[((int64_t)i * (ny + 1) + j) * nz + k] = v0;
    if (j == ny - 1) ov[((int64_t)i * (ny + 1) + ny) * nz + k] = v1;
    ow[((int64_t)i * ny + j) * (nz + 1) + k] = w0;
    if (k == nz - 1) ow[((int64_t)i * ny + j) * (nz + 1) + nz] = w1;

    const float div = ((px1 - px0) / hx + (py1 - py0) / hy) + (pz1 - pz0) / hz;
    val = fabsf(div) * (__ldg(vfrac + c0) > 0.0f ? 1.0f : 0.0f);
  }
  __shared__ float sh[kBlock];
  const int t = threadIdx.y * kBX + threadIdx.x;
  sh[t] = val;
  __syncthreads();
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = nan_max(sh[t], sh[t + s]);
    __syncthreads();
  }
  if (t == 0)
    partial[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)] = sh[0];
}

// One block: the maximum of the per-block partials.
__global__ void __launch_bounds__(kMaxBlock)
max_partials_kernel(const float* __restrict__ partial, int n, float* __restrict__ out) {
  __shared__ float sh[kMaxBlock];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kMaxBlock) acc = nan_max(acc, partial[i]);
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kMaxBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = nan_max(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = sh[0];
}

template <bool HALO>
int launch(const Halo& h, int open_top, const void* dt, const void* dp,
           const void* u, const void* v, const void* w, const void* bx,
           const void* by, const void* bz, const void* ax, const void* ay,
           const void* az, const void* vfrac, const void* topo,
           const void* rho, void* ou, void* ov, void* ow, void* partial,
           void* div_max, int nx, int ny, int nz, float hx, float hy,
           float hz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBX, kBY);
  const dim3 grid((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY, nx);
  const float* f[14] = {
      static_cast<const float*>(dt), static_cast<const float*>(dp),
      static_cast<const float*>(u),  static_cast<const float*>(v),
      static_cast<const float*>(w),  static_cast<const float*>(bx),
      static_cast<const float*>(by), static_cast<const float*>(bz),
      static_cast<const float*>(ax), static_cast<const float*>(ay),
      static_cast<const float*>(az), static_cast<const float*>(vfrac),
      static_cast<const float*>(topo), static_cast<const float*>(rho)};
  float* part = static_cast<float*>(partial);
  if (open_top)
    correct_divmax_kernel<true, HALO><<<grid, block, 0, s>>>(
        h, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10],
        f[11], f[12], f[13], static_cast<float*>(ou), static_cast<float*>(ov),
        static_cast<float*>(ow), part, nx, ny, nz, hx, hy, hz);
  else
    correct_divmax_kernel<false, HALO><<<grid, block, 0, s>>>(
        h, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10],
        f[11], f[12], f[13], static_cast<float*>(ou), static_cast<float*>(ov),
        static_cast<float*>(ow), part, nx, ny, nz, hx, hy, hz);
  max_partials_kernel<<<1, kMaxBlock, 0, s>>>(
      part, (int)(grid.x * grid.y * grid.z), static_cast<float*>(div_max));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partials on an (nx, ny, nz) grid.
int correction_num_partials(int nx, int ny, int nz) {
  return ((nz + kBX - 1) / kBX) * ((ny + kBY - 1) / kBY) * nx;
}

// dt: 0-d f32 on the device. dp, vfrac, rho: (nx, ny, nz) cells (only
// rho's top plane is read); u, bx, ax: (nx+1, ny, nz); v, by, ay:
// (nx, ny+1, nz); w, bz, az: (nx, ny, nz+1); topo: (nx, ny), read only
// with open_top. Outputs ou, ov, ow on the u, v, w grids and div_max[0].
int correction_launch(int open_top, const void* dt, const void* dp, const void* u,
                      const void* v, const void* w, const void* bx, const void* by,
                      const void* bz, const void* ax, const void* ay, const void* az,
                      const void* vfrac, const void* topo, const void* rho, void* ou,
                      void* ov, void* ow, void* partial, void* div_max, int nx,
                      int ny, int nz, float hx, float hy, float hz, void* stream) {
  const Halo h = {nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch<false>(h, open_top, dt, dp, u, v, w, bx, by, bz, ax, ay, az,
                       vfrac, topo, rho, ou, ov, ow, partial, div_max, nx, ny,
                       nz, hx, hy, hz, stream);
}

// The same on one shard's slab of nx cells along x: u, bx, ax and ou packed
// to (nx, ny, nz); dp_lo, dp_hi dp's planes x = −1, nx; u_hi, bx_hi, ax_hi
// the faces x = nx, all (1, ny, nz). div_max is the shard's.
int correction_halo_launch(int open_top, const void* dt, const void* dp,
                           const void* dp_lo, const void* dp_hi, const void* u,
                           const void* u_hi, const void* v, const void* w,
                           const void* bx, const void* bx_hi, const void* by,
                           const void* bz, const void* ax, const void* ax_hi,
                           const void* ay, const void* az, const void* vfrac,
                           const void* topo, const void* rho, void* ou, void* ov,
                           void* ow, void* partial, void* div_max, int nx,
                           int ny, int nz, float hx, float hy, float hz,
                           void* stream) {
  const Halo h = {static_cast<const float*>(dp_lo),
                  static_cast<const float*>(dp_hi),
                  static_cast<const float*>(u_hi),
                  static_cast<const float*>(bx_hi),
                  static_cast<const float*>(ax_hi)};
  return launch<true>(h, open_top, dt, dp, u, v, w, bx, by, bz, ax, ay, az,
                      vfrac, topo, rho, ou, ov, ow, partial, div_max, nx, ny,
                      nz, hx, hy, hz, stream);
}

}  // extern "C"
