// One Zalesak/FCT limiter iteration for all three face sets.
//
// Replaces the TPU kernel openfoam_tpp_tpu/ops/pallas/mules_fct.py
// `fct_iter` (mules_fct.py:217, body `_fct_core` at :45).
//
// Layout: cell lower-face, as in mules_flux.cu; the upper-boundary faces
// are implicit zeros (the plane beyond the top x face is zero, and the
// vacated y/z upper faces are zero). Per cell the iteration forms the
// provisional update a_work with the applied antidiffusion, the remaining
// in/outflow sums P±, the acceptance ratios R± = clip((bound − a_work) /
// (dt_iv·P± + eps), 0, 1), and for each lower face the new λ from the R±
// of its two cells. R± is recomputed for the cell and for its three lower
// neighbours (no intermediate array). The lower x neighbour of the first
// plane is the TPU kernel's clamped halo: plane 0's data with its lower
// x face taken as its upper one. It only feeds λ of the x = 0 wall face,
// whose antidiffusive flux is zero.
//
// What bounds it on the H100: bytes. Per cell it reads three λ and three
// anti (bf16 by default) and four f32 cell arrays and writes three λ:
// 48 MB per 112³ call with bf16 streams, about 14 µs at 3.35 TB/s. The
// arithmetic is ~4 × 60 flops per cell with the R± recompute (about
// 0.35 GFLOP per call, 5 µs at the f32 rate), so bytes still bound it.
// Design: one thread per cell, 32 consecutive z cells per warp; the neighbour
// re-reads are served by L1/L2. λ and anti are widened to f32 on load; all
// arithmetic is f32 and λ is rounded once on store.
//
// The halo variant (`mules_fct_halo_launch`) replaces the TPU kernel
// mules_fct.py `fct_iter_h` (mules_fct.py:261), the per-shard kernel of
// the x-sharded step: the same kernel with HALO set. The lower x
// neighbour of the slab's first plane is the halo cell whose λ/anti
// planes (all three axes) and alpha_low/amax/amin/dt_iv planes were
// exchanged from the previous shard (its upper x face is the slab's own
// first face), and the upper x face of the slab's last plane is the next
// shard's first λ/anti x plane. It never clamps and has no end flag: at
// the global ends the halos hold the clamp planes below and zeros above.
// Same bytes plus twelve planes, same bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Block: 32 cells along z (one warp, contiguous) × 8 along y; the grid's
// z dimension walks x. No integer division in the index math.
constexpr int kBX = 32, kBY = 8, kBlock = kBX * kBY;

__device__ __forceinline__ float ld(const float* a, int64_t i) { return a[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* a, int64_t i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void st(float* a, int64_t i, float v) { a[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* a, int64_t i, float v) {
  a[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

template <typename T>
struct Args {
  const T *lx, *ly, *lz, *ax, *ay, *az;
  const float *al, *amax, *amin, *div;
  T *ox, *oy, *oz;
  int nx, ny, nz;
  float hx, hy, hz, eps;
  // HALO: the (ny, nz) planes of the cell below the slab (λ and anti of
  // its three lower faces, its four cell values) and the λ/anti x plane
  // above the slab.
  const T *hlx, *hly, *hlz, *hax, *hay, *haz, *hlx_hi, *hax_hi;
  const float *hal, *hamax, *hamin, *hdiv;
};

// Where a cell's own data lie: its y/z face streams and cell values, and
// its index `c` in them.
template <typename T>
struct Src {
  const T *ly, *ay, *lz, *az;
  const float *al, *amax, *amin, *div;
  int64_t c;
};

struct RPM {
  float rp, rm;
};

// R± of the cell at grid position (j, k) in y/z whose data `s` holds,
// given its lower / upper x face values (λ, anti).
template <typename T>
__device__ __forceinline__ RPM rpm(const Args<T>& a, const Src<T>& s, int j,
                                   int k, float lxl, float axl, float lxh,
                                   float axh) {
  const int64_t c = s.c, sy = a.nz;
  const float lyl = ld(s.ly, c), ayl = ld(s.ay, c);
  const bool yup = j + 1 < a.ny, zup = k + 1 < a.nz;
  const float lyh = yup ? ld(s.ly, c + sy) : 0.0f;
  const float ayh = yup ? ld(s.ay, c + sy) : 0.0f;
  const float lzl = ld(s.lz, c), azl = ld(s.az, c);
  const float lzh = zup ? ld(s.lz, c + 1) : 0.0f;
  const float azh = zup ? ld(s.az, c + 1) : 0.0f;
  const float dv = s.div[c];

  float appl = (lxh * axh - lxl * axl) / a.hx;
  appl = appl + (lyh * ayh - lyl * ayl) / a.hy;
  appl = appl + (lzh * azh - lzl * azl) / a.hz;
  const float work = s.al[c] - dv * appl;

  const float rxl = (1.0f - lxl) * axl, rxh = (1.0f - lxh) * axh;
  const float ryl = (1.0f - lyl) * ayl, ryh = (1.0f - lyh) * ayh;
  const float rzl = (1.0f - lzl) * azl, rzh = (1.0f - lzh) * azh;
  float p_in = (fmaxf(rxl, 0.0f) - fminf(rxh, 0.0f)) / a.hx;
  p_in = p_in + (fmaxf(ryl, 0.0f) - fminf(ryh, 0.0f)) / a.hy;
  p_in = p_in + (fmaxf(rzl, 0.0f) - fminf(rzh, 0.0f)) / a.hz;
  float p_out = (fmaxf(rxh, 0.0f) - fminf(rxl, 0.0f)) / a.hx;
  p_out = p_out + (fmaxf(ryh, 0.0f) - fminf(ryl, 0.0f)) / a.hy;
  p_out = p_out + (fmaxf(rzh, 0.0f) - fminf(rzl, 0.0f)) / a.hz;
  RPM r;
  r.rp = clip01((s.amax[c] - work) / (dv * p_in + a.eps));
  r.rm = clip01((work - s.amin[c]) / (dv * p_out + a.eps));
  return r;
}

// λ' of one lower face: `left` is the cell below the face, `self` above.
__device__ __forceinline__ float upd(float lam, float anti, RPM left,
                                     RPM self) {
  const float rem = (1.0f - lam) * anti;
  const float c = rem >= 0.0f ? fminf(left.rm, self.rp) : fminf(left.rp, self.rm);
  return clip01(lam + (1.0f - lam) * c);
}

template <typename T, bool HALO>
__global__ void __launch_bounds__(kBlock) fct_iter_kernel(Args<T> a) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  const int i = blockIdx.z;
  if (k >= a.nz || j >= a.ny) return;
  const int64_t sx = (int64_t)a.ny * a.nz, sy = a.nz;
  const int64_t c = ((int64_t)i * a.ny + j) * a.nz + k;
  const int64_t q = (int64_t)j * a.nz + k;   // the cell's place in an x-plane
  auto at = [&](int64_t cc) {
    return Src<T>{a.ly, a.ay, a.lz, a.az, a.al, a.amax, a.amin, a.div, cc};
  };
  // The upper x face (stream f, its halo plane fh) of the cell at index cc
  // of this plane, whose place in a plane is qq: zero past the domain end.
  auto x_up = [&](const T* f, const T* fh, int64_t cc, int64_t qq) {
    if (i + 1 < a.nx) return ld(f, cc + sx);
    return HALO ? ld(fh, qq) : 0.0f;
  };

  const RPM self = rpm(a, at(c), j, k, ld(a.lx, c), ld(a.ax, c),
                       x_up(a.lx, a.hlx_hi, c, q), x_up(a.ax, a.hax_hi, c, q));
  // x: lower neighbour; below the first plane the halo cell (HALO) or the
  // clamped halo: plane 0's data with its lower x face taken as its upper.
  RPM xl;
  if (i > 0)
    xl = rpm(a, at(c - sx), j, k, ld(a.lx, c - sx), ld(a.ax, c - sx),
             ld(a.lx, c), ld(a.ax, c));
  else if (HALO)
    xl = rpm(a, Src<T>{a.hly, a.hay, a.hlz, a.haz, a.hal, a.hamax, a.hamin,
                       a.hdiv, q},
             j, k, ld(a.hlx, q), ld(a.hax, q), ld(a.lx, c), ld(a.ax, c));
  else
    xl = rpm(a, at(c), j, k, ld(a.lx, c), ld(a.ax, c), ld(a.lx, c),
             ld(a.ax, c));
  // y/z: lower neighbour edge-clamped to the cell itself.
  const RPM yl = j > 0 ? rpm(a, at(c - sy), j - 1, k, ld(a.lx, c - sy),
                             ld(a.ax, c - sy), x_up(a.lx, a.hlx_hi, c - sy, q - sy),
                             x_up(a.ax, a.hax_hi, c - sy, q - sy))
                       : self;
  const RPM zl = k > 0 ? rpm(a, at(c - 1), j, k - 1, ld(a.lx, c - 1),
                             ld(a.ax, c - 1), x_up(a.lx, a.hlx_hi, c - 1, q - 1),
                             x_up(a.ax, a.hax_hi, c - 1, q - 1))
                       : self;

  st(a.ox, c, upd(ld(a.lx, c), ld(a.ax, c), xl, self));
  st(a.oy, c, upd(ld(a.ly, c), ld(a.ay, c), yl, self));
  st(a.oz, c, upd(ld(a.lz, c), ld(a.az, c), zl, self));
}

// f: lx, ly, lz, ax, ay, az; cell: al, amax, amin, div; halo (HALO only):
// hlx, hly, hlz, hax, hay, haz, hlx_hi, hax_hi (T), hal, hamax, hamin,
// hdiv (f32).
template <typename T, bool HALO>
void launch(const void* const* f, const void* const* cell,
            const void* const* halo, void* const* out, int nx, int ny, int nz,
            float hx, float hy, float hz, float eps, cudaStream_t stream) {
  Args<T> a = {};
  a.lx = static_cast<const T*>(f[0]);
  a.ly = static_cast<const T*>(f[1]);
  a.lz = static_cast<const T*>(f[2]);
  a.ax = static_cast<const T*>(f[3]);
  a.ay = static_cast<const T*>(f[4]);
  a.az = static_cast<const T*>(f[5]);
  a.al = static_cast<const float*>(cell[0]);
  a.amax = static_cast<const float*>(cell[1]);
  a.amin = static_cast<const float*>(cell[2]);
  a.div = static_cast<const float*>(cell[3]);
  a.ox = static_cast<T*>(out[0]);
  a.oy = static_cast<T*>(out[1]);
  a.oz = static_cast<T*>(out[2]);
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.hx = hx;
  a.hy = hy;
  a.hz = hz;
  a.eps = eps;
  if (HALO) {
    a.hlx = static_cast<const T*>(halo[0]);
    a.hly = static_cast<const T*>(halo[1]);
    a.hlz = static_cast<const T*>(halo[2]);
    a.hax = static_cast<const T*>(halo[3]);
    a.hay = static_cast<const T*>(halo[4]);
    a.haz = static_cast<const T*>(halo[5]);
    a.hlx_hi = static_cast<const T*>(halo[6]);
    a.hax_hi = static_cast<const T*>(halo[7]);
    a.hal = static_cast<const float*>(halo[8]);
    a.hamax = static_cast<const float*>(halo[9]);
    a.hamin = static_cast<const float*>(halo[10]);
    a.hdiv = static_cast<const float*>(halo[11]);
  }
  const dim3 block(kBX, kBY);
  const dim3 grid((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY, nx);
  fct_iter_kernel<T, HALO><<<grid, block, 0, stream>>>(a);
}

template <bool HALO>
int dispatch(int dtype, const void* const* f, const void* const* cell,
             const void* const* halo, void* const* out, int nx, int ny, int nz,
             float hx, float hy, float hz, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float, HALO>(f, cell, halo, out, nx, ny, nz, hx, hy, hz, eps, s);
  else
    launch<__nv_bfloat16, HALO>(f, cell, halo, out, nx, ny, nz, hx, hy, hz,
                                eps, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (λ and anti): 0 float32, 1 bfloat16. Face inputs lx, ly, lz, ax,
// ay, az; cell inputs (f32) alpha_low, amax, amin, dt_iv; outputs ox, oy, oz.
int mules_fct_launch(int dtype, const void* lx, const void* ly, const void* lz,
                     const void* ax, const void* ay, const void* az,
                     const void* al, const void* amax, const void* amin,
                     const void* div, void* ox, void* oy, void* oz, int nx,
                     int ny, int nz, float hx, float hy, float hz, float eps,
                     void* stream) {
  const void* f[6] = {lx, ly, lz, ax, ay, az};
  const void* cell[4] = {al, amax, amin, div};
  void* out[3] = {ox, oy, oz};
  return dispatch<false>(dtype, f, cell, nullptr, out, nx, ny, nz, hx, hy, hz,
                         eps, stream);
}

// The same on one shard's (nx, ny, nz) slab. halo: 12 (ny, nz) planes —
// the λ x, y, z and anti x, y, z planes of the cell layer below the slab,
// the λ and anti x planes above it (dtype), and the alpha_low, amax, amin,
// dt_iv planes below it (f32).
int mules_fct_halo_launch(int dtype, const void* lx, const void* ly,
                          const void* lz, const void* ax, const void* ay,
                          const void* az, const void* al, const void* amax,
                          const void* amin, const void* div,
                          const void* const* halo, void* ox, void* oy,
                          void* oz, int nx, int ny, int nz, float hx, float hy,
                          float hz, float eps, void* stream) {
  const void* f[6] = {lx, ly, lz, ax, ay, az};
  const void* cell[4] = {al, amax, amin, div};
  void* out[3] = {ox, oy, oz};
  return dispatch<true>(dtype, f, cell, halo, out, nx, ny, nz, hx, hy, hz, eps,
                        stream);
}

}  // extern "C"
