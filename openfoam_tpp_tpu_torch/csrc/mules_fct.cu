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
// of its two cells. The lower x neighbour of the first plane is the TPU
// kernel's clamped halo: plane 0's data with its lower x face taken as its
// upper one. It only feeds λ of the x = 0 wall face, whose antidiffusive
// flux is zero.
//
// Its floor on the H100 is bytes. Per cell it reads three λ and three
// anti (bf16 by default) and four f32 cell arrays and writes three λ:
// 48 MB per 112³ call with bf16 streams, 14.3 µs at 3.35 TB/s. The
// arithmetic is one R± per cell (~60 flops, two divisions) and three λ
// updates (~6 flops each), ~80 flops per cell: 0.1 GFLOP per call, under
// 2 µs at the f32 rate. What bounds this design is instruction issue and
// the latency of each plane's two barriers: at 112³ its 392 blocks leave
// about three (30 warps) per SM, each walking 18 planes in sequence. It
// took 64.2 µs there, 4.5× the byte bound, at 35 registers, no spills
// and 38.9 KB of shared memory per block with bf16 streams; with
// approximate division 57.1 µs (H100 80GB HBM3, 700 W;
// scripts/port_kernel_variants.py).
//
// Design: a 2.5-D march along x. A block owns a 8 × 32 (y, z) tile (one
// warp per y row, z contiguous; ten warps, so that R± of the tile and its
// lower row and column is one pass) and walks up to kCX = 16 x planes
// (8 or 4 where 16 would leave SMs without a block: a shard's slab). Each
// plane's ten arrays are staged into shared memory over the tile plus one
// row and column below it (the y/z lower neighbours) and one above
// (their upper faces), all chunks of a plane spread over the block, with
// cp.async in 16-byte chunks (value by value where a row is not 16-byte
// aligned: the ragged shapes of the tests). Plane i+2 is in flight
// while plane i is computed: double buffering over a ring of
// three planes, because plane i reads plane i+1's λx/anti x as its upper
// x face. R± is computed once per cell of the tile and its lower row and
// column into shared memory; the lower x neighbour's R± is the thread's
// own register from the previous plane, and a block recomputes the plane
// below its first one. Then each thread updates the three lower faces of
// its cell and stores λ' once. The divisions by the spacing are
// multiplications by 1/h ((float)(1.0 / h), taken in double on the host
// and rounded to f32, as PyTorch's CUDA division by a Python scalar does
// for the plain version), so a cell costs
// two divisions (R+ and R−). λ and anti are widened to f32 from shared
// memory; all arithmetic is f32 in fct_iter_plain's order, λ rounded once
// on store.
//
// The halo variant (`mules_fct_halo_launch`) replaces the TPU kernel
// mules_fct.py `fct_iter_h` (mules_fct.py:261), the per-shard kernel of
// the x-sharded step: the same kernel with HALO set. Plane −1 (the cell
// below the slab) is staged from the halo planes exchanged from the
// previous shard (its upper x face is the slab's own first face), and
// plane nx's λ/anti x from the next shard's first x plane; the x branch is
// taken once per staged plane, never per read. It never clamps and has no
// end flag: at the global ends the halos hold the clamp planes below and
// zeros above. Same bytes plus twelve planes, same bound, and the same
// arithmetic per cell, so the shards composed equal the single-grid
// kernel bitwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int kTZ = 32, kTY = 8;
// Ten warps: one pass computes R± over the tile and its lower row and
// column (297 cells); the first eight own the tile's cells.
constexpr int kWarps = 10, kBlock = 32 * kWarps;
constexpr int kCX = 16;   // x planes per block, at most
// Staged region of a plane: rows j0−1 … j0+kTY (kRY), and columns in
// 16-byte chunks from k0 − kV (kV values per chunk), through k0+kTZ.
constexpr int kRY = kTY + 2;
template <typename R>
constexpr int kV = 16 / (int)sizeof(R);
// Columns k0 − kV … k0 + kTZ, rounded up to whole chunks.
template <typename R>
constexpr int kRow = (kTZ + 1 + kV<R> + kV<R> - 1) / kV<R> * kV<R>;
// R± region: the tile and its lower row and column.
constexpr int kQY = kTY + 1, kQZ = kTZ + 1;
constexpr int kRing = 3;
static_assert(kQY * kQZ <= kBlock, "one R± pass");

// Shared memory holds the streams as raw bits: f32, or bf16 as uint16_t.
template <typename T>
struct RawOf {
  using type = float;
};
template <>
struct RawOf<__nv_bfloat16> {
  using type = uint16_t;
};
__device__ __forceinline__ float wide(float v) { return v; }
__device__ __forceinline__ float wide(uint16_t v) {
  return __uint_as_float((unsigned)v << 16);   // bf16 → f32, exact
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
  int nx, ny, nz, cx;   // cx: x planes per block
  float rhx, rhy, rhz, eps;
  // HALO: the (ny, nz) planes of the cell below the slab (λ and anti of
  // its three lower faces, its four cell values) and the λ/anti x plane
  // above the slab.
  const T *hlx, *hly, *hlz, *hax, *hay, *haz, *hlx_hi, *hax_hi;
  const float *hal, *hamax, *hamin, *hdiv;
};

// One staged plane: six face streams and four cell arrays.
template <typename T>
struct __align__(16) Plane {
  using R = typename RawOf<T>::type;
  R f[6][kRY][kRow<R>];           // lx, ly, lz, ax, ay, az
  float c[4][kRY][kRow<float>];   // alpha_low, amax, amin, dt_iv
};

// Stage one chunk of kV values, row j and columns k … k + kV − 1 of the
// (ny, nz) plane `src`, into `d`; rows and columns outside the grid, and
// a null `src`, are zeros. A chunk inside its row whose global address is
// 16-byte aligned (every chunk of an interior row when nz is a multiple of
// kV) is one 16-byte cp.async; the others go value by value, 4-byte
// cp.async for f32 and synchronous copies for bf16.
template <typename R>
__device__ __forceinline__ void stage_chunk(R* d, const R* src, int j, int k,
                                            int ny, int nz) {
  constexpr int V = kV<R>;
  const bool row = src != nullptr && j >= 0 && j < ny;
  const R* g = row ? src + ((int64_t)j * nz + k) : nullptr;
  if (row && k >= 0 && k + V <= nz &&
      (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    __pipeline_memcpy_async(d, g, 16);
    return;
  }
  for (int t = 0; t < V; ++t) {
    const bool in = row && k + t >= 0 && k + t < nz;
    if (sizeof(R) == 4 && in)
      __pipeline_memcpy_async(d + t, g + t, 4);
    else
      d[t] = in ? g[t] : R();
  }
}

template <typename P>
__device__ __forceinline__ P pick(int n, P p0, P p1, P p2, P p3, P p4 = P(),
                                  P p5 = P()) {
  return n == 0 ? p0 : n == 1 ? p1 : n == 2 ? p2 : n == 3 ? p3 : n == 4 ? p4 : p5;
}

struct RPM {
  float rp, rm;
};

// R± of a cell from its lower / upper faces (λ, anti) per axis and its
// cell values: fct_iter_plain's `_rpm`, with the spacing's reciprocals.
template <typename T>
__device__ __forceinline__ RPM rpm(const Args<T>& a, float lxl, float axl,
                                   float lxh, float axh, float lyl, float ayl,
                                   float lyh, float ayh, float lzl, float azl,
                                   float lzh, float azh, float al, float amax,
                                   float amin, float dv) {
  float appl = (lxh * axh - lxl * axl) * a.rhx;
  appl = appl + (lyh * ayh - lyl * ayl) * a.rhy;
  appl = appl + (lzh * azh - lzl * azl) * a.rhz;
  const float work = al - dv * appl;

  const float rxl = (1.0f - lxl) * axl, rxh = (1.0f - lxh) * axh;
  const float ryl = (1.0f - lyl) * ayl, ryh = (1.0f - lyh) * ayh;
  const float rzl = (1.0f - lzl) * azl, rzh = (1.0f - lzh) * azh;
  float p_in = (fmaxf(rxl, 0.0f) - fminf(rxh, 0.0f)) * a.rhx;
  p_in = p_in + (fmaxf(ryl, 0.0f) - fminf(ryh, 0.0f)) * a.rhy;
  p_in = p_in + (fmaxf(rzl, 0.0f) - fminf(rzh, 0.0f)) * a.rhz;
  float p_out = (fmaxf(rxh, 0.0f) - fminf(rxl, 0.0f)) * a.rhx;
  p_out = p_out + (fmaxf(ryh, 0.0f) - fminf(ryl, 0.0f)) * a.rhy;
  p_out = p_out + (fmaxf(rzh, 0.0f) - fminf(rzl, 0.0f)) * a.rhz;
  RPM r;
  r.rp = clip01((amax - work) / (dv * p_in + a.eps));
  r.rm = clip01((work - amin) / (dv * p_out + a.eps));
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
struct Smem {
  Plane<T> ring[kRing];
  float rp[kQY][kQZ], rm[kQY][kQZ];
};

// Stage x plane q (−1 … nx) of every array into `p`, or only its λ/anti
// x (`x_only`: the plane above a block's last, read as that plane's upper
// x face). Plane −1 is the halo cell layer (HALO) or plane 0 again (the
// clamped halo); plane nx is the next shard's first plane (HALO) or zeros.
template <typename T, bool HALO>
__device__ __forceinline__ void stage_plane(const Args<T>& a, Plane<T>& p,
                                            int q, bool x_only, int j0,
                                            int k0, int tid) {
  using R = typename RawOf<T>::type;
  const int64_t off = (int64_t)(q < 0 ? 0 : q) * a.ny * a.nz;
  const bool halo_lo = HALO && q < 0;
  x_only = x_only || q >= a.nx;
  // Stream n (lx, ly, lz, ax, ay, az) and cell array n of plane q.
  auto fp = [&](int n) -> const R* {
    const T* t;
    if (q >= a.nx)
      t = HALO ? (n == 0 ? a.hlx_hi : a.hax_hi) : nullptr;
    else if (halo_lo)
      t = pick(n, a.hlx, a.hly, a.hlz, a.hax, a.hay, a.haz);
    else
      t = pick(n, a.lx, a.ly, a.lz, a.ax, a.ay, a.az) + off;
    return reinterpret_cast<const R*>(t);
  };
  auto cp = [&](int n) -> const float* {
    return halo_lo ? pick(n, a.hal, a.hamax, a.hamin, a.hdiv)
                   : pick(n, a.al, a.amax, a.amin, a.div) + off;
  };
  // All chunks of the plane's streams (of lx and ax alone for x_only),
  // then of its cell arrays, spread over the whole block.
  constexpr int CF = kRow<R> / kV<R>, PF = kRY * CF;
  constexpr int CC = kRow<float> / kV<float>, PC = kRY * CC;
  for (int e = tid; e < (x_only ? 2 : 6) * PF; e += kBlock) {
    const int m = e / PF, w = e - m * PF, r = w / CF, ch = w - r * CF;
    const int n = x_only ? 3 * m : m;
    stage_chunk<R>(&p.f[n][r][kV<R> * ch], fp(n), j0 - 1 + r,
                   k0 - kV<R> + kV<R> * ch, a.ny, a.nz);
  }
  if (x_only) return;
  for (int e = tid; e < 4 * PC; e += kBlock) {
    const int n = e / PC, w = e - n * PC, r = w / CC, ch = w - r * CC;
    stage_chunk<float>(&p.c[n][r][kV<float> * ch], cp(n), j0 - 1 + r,
                       k0 - kV<float> + kV<float> * ch, a.ny, a.nz);
  }
}

template <typename T, bool HALO>
__global__ void __launch_bounds__(kBlock) fct_iter_kernel(Args<T> a) {
  extern __shared__ __align__(16) uint8_t smem[];
  Smem<T, HALO>& s = *reinterpret_cast<Smem<T, HALO>*>(smem);
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTZ + tx;
  const int k0 = blockIdx.x * kTZ, j0 = blockIdx.y * kTY;
  const int i0 = blockIdx.z * a.cx;
  const int i1 = i0 + a.cx < a.nx ? i0 + a.cx : a.nx;
  const int j = j0 + ty, k = k0 + tx;
  const bool mine = j < a.ny && k < a.nz;
  const int64_t sx = (int64_t)a.ny * a.nz;

  // Planes i0 − 1 … i1 live in ring slot (q − i0 + 4) % kRing.
  auto slot = [&](int q) -> Plane<T>& { return s.ring[(q - i0 + 4) % kRing]; };
  // Region column cz (column k0 − 1 + cz) of stream n, row r.
  constexpr int oF = kV<typename RawOf<T>::type> - 1, oC = kV<float> - 1;
  auto fv = [&](const Plane<T>& p, int n, int r, int cz) {
    return wide(p.f[n][r][cz + oF]);
  };
  RPM below = {0.0f, 0.0f};   // R± of this thread's cell one plane down
  // The first two passes only stage planes i0 − 1 and i0.
  for (int q = i0 - 3; q < i1; ++q) {
    __pipeline_wait_prior(0);
    __syncthreads();   // planes q and q + 1 staged; plane q − 1 read out
    if (q + 2 <= i1)
      stage_plane<T, HALO>(a, slot(q + 2), q + 2, q + 2 == i1, j0, k0, tid);
    __pipeline_commit();
    if (q < i0 - 1) continue;

    const Plane<T>& p = slot(q);
    // The clamped halo below plane 0 takes its lower x face as its upper.
    const bool clamp = !HALO && q < 0;
    const Plane<T>& up = clamp ? p : slot(q + 1);
    if (tid < kQY * kQZ) {
      const int r = tid / kQZ, cz = tid - r * kQZ;
      const RPM v = rpm(a, fv(p, 0, r, cz), fv(p, 3, r, cz), fv(up, 0, r, cz),
                        fv(up, 3, r, cz), fv(p, 1, r, cz), fv(p, 4, r, cz),
                        fv(p, 1, r + 1, cz), fv(p, 4, r + 1, cz),
                        fv(p, 2, r, cz), fv(p, 5, r, cz), fv(p, 2, r, cz + 1),
                        fv(p, 5, r, cz + 1), p.c[0][r][cz + oC],
                        p.c[1][r][cz + oC], p.c[2][r][cz + oC],
                        p.c[3][r][cz + oC]);
      s.rp[r][cz] = v.rp;
      s.rm[r][cz] = v.rm;
    }
    __syncthreads();

    const int r = ty + 1, cz = tx + 1;
    if (ty >= kTY) continue;
    const RPM self = {s.rp[r][cz], s.rm[r][cz]};
    if (q >= i0 && mine) {
      // y/z: lower neighbour edge-clamped to the cell itself.
      const RPM yl = j > 0 ? RPM{s.rp[r - 1][cz], s.rm[r - 1][cz]} : self;
      const RPM zl = k > 0 ? RPM{s.rp[r][cz - 1], s.rm[r][cz - 1]} : self;
      const int64_t c = q * sx + (int64_t)j * a.nz + k;
      st(a.ox, c, upd(fv(p, 0, r, cz), fv(p, 3, r, cz), below, self));
      st(a.oy, c, upd(fv(p, 1, r, cz), fv(p, 4, r, cz), yl, self));
      st(a.oz, c, upd(fv(p, 2, r, cz), fv(p, 5, r, cz), zl, self));
    }
    below = self;
  }
}

// The current device's SM count (asked at every launch: a process may
// use more than one card).
int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// f: lx, ly, lz, ax, ay, az; cell: al, amax, amin, div; halo (HALO only):
// hlx, hly, hlz, hax, hay, haz, hlx_hi, hax_hi (T), hal, hamax, hamin,
// hdiv (f32).
template <typename T, bool HALO>
int launch(const void* const* f, const void* const* cell,
            const void* const* halo, void* const* out, int nx, int ny, int nz,
            double hx, double hy, double hz, float eps, cudaStream_t stream) {
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
  // The reciprocals as PyTorch's CUDA division by a Python scalar forms
  // them: in double from the scalar, rounded to f32 (not 1.0f / (float)h,
  // which differs in the last bit for some h, such as 0.002 and 0.013).
  a.rhx = (float)(1.0 / hx);
  a.rhy = (float)(1.0 / hy);
  a.rhz = (float)(1.0 / hz);
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
  // Dynamic shared memory: the f32 ring is above the 48 KB static limit.
  // The attribute holds for the current device only, so it is set at
  // every launch.
  constexpr int bytes = (int)sizeof(Smem<T, HALO>);
  const cudaError_t err = cudaFuncSetAttribute(
      fct_iter_kernel<T, HALO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kTZ, kWarps);
  // Up to kCX planes per block, fewer while the grid would not give every
  // SM a block.
  const int tiles = ((nz + kTZ - 1) / kTZ) * ((ny + kTY - 1) / kTY);
  a.cx = kCX;
  while (a.cx > 4 && tiles * ((nx + a.cx - 1) / a.cx) < sm_count()) a.cx /= 2;
  const dim3 grid((nz + kTZ - 1) / kTZ, (ny + kTY - 1) / kTY,
                  (nx + a.cx - 1) / a.cx);
  fct_iter_kernel<T, HALO><<<grid, block, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool HALO>
int dispatch(int dtype, const void* const* f, const void* const* cell,
             const void* const* halo, void* const* out, int nx, int ny, int nz,
             double hx, double hy, double hz, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, HALO>(f, cell, halo, out, nx, ny, nz, hx, hy, hz,
                               eps, s);
  return launch<__nv_bfloat16, HALO>(f, cell, halo, out, nx, ny, nz, hx, hy,
                                     hz, eps, s);
}

}  // namespace

extern "C" {

// dtype (λ and anti): 0 float32, 1 bfloat16. Face inputs lx, ly, lz, ax,
// ay, az; cell inputs (f32) alpha_low, amax, amin, dt_iv; outputs ox, oy, oz.
int mules_fct_launch(int dtype, const void* lx, const void* ly, const void* lz,
                     const void* ax, const void* ay, const void* az,
                     const void* al, const void* amax, const void* amin,
                     const void* div, void* ox, void* oy, void* oz, int nx,
                     int ny, int nz, double hx, double hy, double hz,
                     float eps, void* stream) {
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
                          void* oz, int nx, int ny, int nz, double hx,
                          double hy, double hz, float eps, void* stream) {
  const void* f[6] = {lx, ly, lz, ax, ay, az};
  const void* cell[4] = {al, amax, amin, div};
  void* out[3] = {ox, oy, oz};
  return dispatch<true>(dtype, f, cell, halo, out, nx, ny, nz, hx, hy, hz, eps,
                        stream);
}

}  // extern "C"
