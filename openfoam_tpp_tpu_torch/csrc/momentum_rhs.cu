// Fused momentum right-hand side: visc [+ dev2] − conv for all three MAC
// velocity components in one launch.
//
// Replaces the TPU kernel openfoam_tpp_tpu/ops/pallas/momentum_rhs.py
// `momentum_rhs` (momentum_rhs.py:387, pallas_call at :432, body
// `_mom_core` at :261).
//
// Per component q (on its own face grid) and direction d it evaluates
// exactly the terms of solver/momentum.py, face by face:
//   conv  ∇·(ρφ q̃): van Leer MUSCL value upwinded by the mass flux, which
//         is ρφ_d averaged to the cell centres (d = q's axis, zero-padded
//         at both ends) or to the q faces (d ≠ q's axis, edge faces take
//         the edge cell);
//   visc  ∇·(μ∇q): centre μ along q's axis (zero-padded), edge μ (face
//         averages along the lower axis, then the higher) across it, with
//         gradient_at_faces' zero boundary faces;
//   dev2  ∇·(μ[(∇U)ᵀ − (2/3)(∇·U)I]) with the same μ and zero padding.
// u's face-nx row (the sealed +x wall) is written as zeros.
//
// Its floor on the H100 is bytes. It reads six face arrays (u, v, w,
// ρφ×3) and two cell arrays (μ, ∇·U) and writes three face arrays: 62 MB
// per 112³ call, about 18.6 µs at 3.35 TB/s. The arithmetic, with each
// flux evaluated once, is about 3 × 105 flops per cell (9 fluxes per
// component, one division in each van Leer limiter), ~5 µs at 67 TFLOP/s
// f32. What bounds this design is instruction issue: per face and plane
// about 3.2 flux evaluations (x, and the y and z fluxes of one more row
// and column than the tile), each of a convective, a viscous and a dev2
// flux with ~25 shared-memory reads and their index arithmetic; ~15,400
// SASS instructions over the three component bodies. It took 254 µs at
// 112³ (dev2 on), 13.6× the byte bound, at 55 registers, no spills and
// 54.6 KB of dynamic shared memory per block, four blocks per SM (H100
// 80GB HBM3, 700 W; scripts/port_kernel_variants.py).
//
// Design: one launch over the three components (blockIdx.z = component ·
// chunks + chunk); per component a block owns an 8 × 32 (y, z) tile of
// that component's face grid (z contiguous, one warp per y row) and
// marches kCX = 8 x planes. Every array the component reads is staged
// plane by plane into shared memory over the tile plus the stencil's
// reach in y and z (±2: the MUSCL stencil of the flux at a tile edge),
// with cp.async in 16-byte chunks (value by value where a row is not
// 16-byte aligned), into a ring per array whose depth is that array's
// reach in x plus one: the next plane of every array is in flight while
// this plane is computed. Rows, columns and single-grid planes outside
// an array are staged as copies of its edge, so the clamps and the edge
// averages (`favg`, `mu_edge`) need no rule in the inner loop: the
// average of two equal values is that value exactly. What stays are the
// zero-padded end fluxes, the zero boundary gradients and the MUSCL
// centre's clamp. Each flux is evaluated once: the y and z fluxes of a
// plane (one more row or column than the tile) into shared memory, then
// differenced; the x flux is carried in a register from one plane to
// the next, its upper face being the next plane's lower one. A block
// recomputes the x flux below its first plane. The divisions by the
// spacing are multiplications by 1/h (f32 reciprocals formed on the
// host, as PyTorch's CUDA division by a Python scalar does for the plain
// version); the van Leer limiter takes its one-division form, that
// division to 2 ulp. Otherwise the operation order is the plain
// version's and the build has no FMA contraction: the two agree to 1e-7
// of the output's scale.
//
// The halo variant (`momentum_rhs_halo_launch`) replaces the TPU kernel
// momentum_rhs.py `momentum_rhs_h` (momentum_rhs.py:463), the per-shard
// kernel of the x-sharded step: the same kernel with H set. u and ρφ_x
// come packed to the slab's cells (the global face-nx plane is the sealed
// wall and rides in their zero hi halo), and x planes outside the slab
// are staged from the exchanged halo planes: u, v, w ±2, ρφ_x and μ ±1,
// ρφ_y, ρφ_z and ∇·U −1 (the widest reach of any output face). The x
// branch is taken once per staged plane, never per read. Along x it
// applies no boundary rule of its own (no zero-padded end flux, no zero
// gradient, no clamp, no wall row): the halo content carries them — edge
// planes replicated, zeros for the sealed wall and for ∇·U below the
// domain, and zero wall mass fluxes make the end convective fluxes 0.
// Same bytes plus the halo planes, same bound, and the same arithmetic
// per face, so the shards composed equal the single-grid kernel bitwise.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int kTZ = 32, kTY = 8, kBlock = kTZ * kTY;
constexpr int kCX = 8;   // x planes per block
// Staged region of a plane: rows j0−2 … j0+kTY+1 (the stencil's reach),
// columns k0−4 … k0+kTZ+3 (the reach, k0−2 … k0+kTZ+1, widened to whole
// 16-byte chunks).
constexpr int kW = 2, kWZ = 4;
constexpr int kRY = kTY + 2 * kW, kRZ = kTZ + 2 * kWZ, kSlot = kRY * kRZ;
constexpr float kTwoThirds = (float)(2.0 / 3.0);

// Arrays: u, v, w, ρφ_x, ρφ_y, ρφ_z, μ, ∇·U.
enum { U, V, W, RX, RY, RZ, MU, DIVU, kArrays };

// Planes of each array a component reads, relative to its output plane i
// (the x flux at i + 1 and the y/z fluxes at i): [lo, hi]. Its ring holds
// hi − lo + 2 planes: those and the next one in flight.
template <int Q>
__host__ __device__ constexpr int reach_lo(int a) {
  //                  u   v   w  ρx  ρy  ρz   μ  ∇·U
  const int t[3][kArrays] = {{-1, -1, -1, 0, -1, -1, -1, 0},
                             {1, -1, 0, 1, 0, 0, 0, 0},
                             {1, 0, -1, 1, 0, 0, 0, 0}};
  return t[Q][a];
}
template <int Q>
__host__ __device__ constexpr int reach_hi(int a) {
  const int t[3][kArrays] = {{2, 0, 0, 1, 0, 0, 0, 0},
                             {1, 2, 0, 1, 0, 0, 1, 0},
                             {1, 0, 2, 1, 0, 0, 1, 0}};
  return t[Q][a];
}
// Array a's ring: ring_len slots from slot ring_base.
template <int Q>
__host__ __device__ constexpr int ring_len(int a) {
  return reach_hi<Q>(a) - reach_lo<Q>(a) + 2;
}
template <int Q>
__host__ __device__ constexpr int ring_base(int a) {
  int b = 0;
  for (int n = 0; n < a; ++n) b += ring_len<Q>(n);
  return b;
}
constexpr int kMaxSlots = ring_base<0>(kArrays) > ring_base<1>(kArrays)
                              ? ring_base<0>(kArrays)
                              : ring_base<1>(kArrays);
static_assert(ring_base<2>(kArrays) <= kMaxSlots, "ring slots");
// Flux scratch: y fluxes (kTY + 1 rows × kTZ) and z fluxes (kTY × kTZ + 1
// columns) of conv, visc and dev2.
constexpr int kFy = (kTY + 1) * kTZ, kFz = kTY * (kTZ + 1);
static_assert(kFy % 32 == 0, "the y fluxes fill whole warps");
constexpr size_t kSmem = sizeof(float) * ((size_t)kMaxSlots * kSlot + 3 * (kFy + kFz));

struct P3 {
  int i[3];
};

template <int A>
__device__ __forceinline__ P3 at(P3 p, int v) {
  p.i[A] = v;
  return p;
}

// An array: its extents (e[0] planes, e[1] rows, e[2] columns) and, for
// the halo kernel, `wl` planes below the slab in `lo` and `wh` above it
// in `hi`.
struct Arr {
  const float* p;
  int e[3];
  const float* lo;
  const float* hi;
  int wl, wh;
};

struct Fields {
  Arr a[kArrays];
  float rh[3];   // 1/hx, 1/hy, 1/hz
};

// True where axis A carries the grid's own boundary rules: every axis of
// the single-grid kernel, y and z of the halo kernel.
template <int A, bool H>
constexpr bool kEnds = !(H && A == 0);

// f32 division to 2 ulp (div.full.f32, what nvcc -prec-div=false emits):
// no call to the IEEE division's slow path, whose register saves cost the
// kernel a fifth of its time (scripts/port_kernel_variants.py).
__device__ __forceinline__ float div_full(float a, float b) {
#ifdef __CUDA_ARCH__
  float q;
  asm("div.full.f32 %0, %1, %2;" : "=f"(q) : "f"(a), "f"(b));
  return q;
#else
  return a / b;
#endif
}

// van Leer limiter φ(r)·Δdown, r = Δup/Δdown (stencil.vanleer_limited),
// in its one-division form (up·|down| + |up|·down) / (|up| + |down|),
// 0 where both differences are 0: the same function, within 1e-7 of the
// plain version's two IEEE divisions (scripts/port_kernel_variants.py).
__device__ __forceinline__ float vl(float up, float down) {
  const float den = fabsf(up) + fabsf(down);
  return den > 0.0f ? div_full(up * fabsf(down) + fabsf(up) * down, den)
                    : 0.0f;
}

// The staged planes of one component's block.
template <int Q, bool H>
struct Stage {
  float* sm;       // kMaxSlots slots of kRY × kRZ, 16-byte aligned
  int j0, k0, p0;  // tile origin; plane p0 is ring position 0
};

// The ring slot of array A's plane p.
template <int A, int Q, bool H>
__device__ __forceinline__ float* slot(const Stage<Q, H>& S, int p) {
  constexpr int base = ring_base<Q>(A), len = ring_len<Q>(A);
  return S.sm + (base + (p - S.p0) % len) * kSlot;
}

// Array A at absolute (plane, row, column) x.
template <int A, int Q, bool H>
__device__ __forceinline__ float ld(const Stage<Q, H>& S, const P3& x) {
  return slot<A>(S, x.i[0])[(x.i[1] - S.j0 + kW) * kRZ + (x.i[2] - S.k0 + kWZ)];
}

// Copy plane p of array A into its ring slot: rows and columns past the
// array's ends (and, single-grid, planes) repeat its edge; halo planes
// from lo / hi; a plane the halo kernel does not have is not staged (no
// output face reads it).
template <int A, int Q, bool H>
__device__ __forceinline__ void load(const Stage<Q, H>& S, const Arr& r, int p,
                                     int tid) {
  const float* src;
  const int plane = r.e[1] * r.e[2];
  if (!H) {
    src = r.p + (int64_t)(p < 0 ? 0 : (p >= r.e[0] ? r.e[0] - 1 : p)) * plane;
  } else if (p < 0) {
    if (-p > r.wl) return;
    src = r.lo + (int64_t)(p + r.wl) * plane;
  } else if (p >= r.e[0]) {
    if (p - r.e[0] >= r.wh) return;
    src = r.hi + (int64_t)(p - r.e[0]) * plane;
  } else {
    src = r.p + (int64_t)p * plane;
  }
  float* d = slot<A>(S, p);
  constexpr int C = kRZ / 4;   // 16-byte chunks per row
  for (int e = tid; e < kRY * C; e += kBlock) {
    const int rr = e / C, ch = e - rr * C;
    int j = S.j0 - kW + rr;
    j = j < 0 ? 0 : (j >= r.e[1] ? r.e[1] - 1 : j);
    const int k = S.k0 - kWZ + 4 * ch;   // the chunk's first column
    const float* g = src + j * r.e[2];
    float* dc = d + rr * kRZ + 4 * ch;
    // Inside the row and 16-byte aligned (every chunk of an interior row
    // when the row length is a multiple of 4): one copy; else value by
    // value, columns clamped.
    if (k >= 0 && k + 4 <= r.e[2] &&
        (reinterpret_cast<uintptr_t>(g + k) & 15) == 0) {
      __pipeline_memcpy_async(dc, g + k, 16);
      continue;
    }
    for (int t = 0; t < 4; ++t) {
      const int kk = k + t < 0 ? 0 : (k + t >= r.e[2] ? r.e[2] - 1 : k + t);
      __pipeline_memcpy_async(dc + t, g + kk, 4);
    }
  }
}

// Whether component Q reads array A.
template <int Q, bool DEV2, bool DIV>
__host__ __device__ constexpr bool needed(int a) {
  return a == Q || (a >= RX && a <= MU) || (DEV2 && a <= W) ||
         (DEV2 && DIV && a == DIVU);
}

// Stage, for every array A… component Q reads, its planes i + lo … i + hi
// (`all`), or only plane i + hi.
template <int Q, bool DEV2, bool DIV, bool H, int A = 0>
__device__ __forceinline__ void load_all(const Stage<Q, H>& S, const Fields& F,
                                         int i, bool all, int tid) {
  if constexpr (A < kArrays) {
    if constexpr (needed<Q, DEV2, DIV>(A)) {
      constexpr int lo = reach_lo<Q>(A), hi = reach_hi<Q>(A);
      for (int d = all ? lo : hi; d <= hi; ++d) load<A>(S, F.a[A], i + d, tid);
    }
    load_all<Q, DEV2, DIV, H, A + 1>(S, F, i, all, tid);
  }
}

// stencil.vanleer_faces at face e along AX (faces 0 … n of q's entries
// along AX): up_plus of the entry below, or up_minus of the entry above,
// by the sign of the mass flux g; the centre is clamped to the array, its
// neighbours are the staged edge copies.
template <int AX, int Q, bool H>
__device__ __forceinline__ float muscl(const Stage<Q, H>& S, const Fields& F,
                                       const P3& x, int e, float g) {
  const int n = F.a[Q].e[AX];
  int c = g >= 0.0f ? e - 1 : e;
  if (kEnds<AX, H>) c = c < 0 ? 0 : (c > n - 1 ? n - 1 : c);
  const float q0 = ld<Q>(S, at<AX>(x, c));
  const float dm = q0 - ld<Q>(S, at<AX>(x, c - 1));
  const float dp = ld<Q>(S, at<AX>(x, c + 1)) - q0;
  return g >= 0.0f ? q0 + 0.5f * vl(dm, dp) : q0 - 0.5f * vl(dp, dm);
}

// cells_to_faces_avg of array A along AX at face f (the edge faces read
// the staged edge copy twice, which averages to the edge value).
template <int AX, int A, int Q, bool H>
__device__ __forceinline__ float favg(const Stage<Q, H>& S, const P3& x, int f) {
  return 0.5f * (ld<A>(S, at<AX>(x, f - 1)) + ld<A>(S, at<AX>(x, f)));
}

// μ on the (Q-face fq, D-face fd) edge: cells_to_faces_avg along the
// lower axis, then along the higher (solver/momentum.py edge_viscosities).
template <int Q, int D, bool H>
__device__ __forceinline__ float mu_edge(const Stage<Q, H>& S, const P3& x,
                                         int fq, int fd) {
  constexpr int LO = Q < D ? Q : D, HI = Q < D ? D : Q;
  const int flo = LO == Q ? fq : fd, fhi = HI == Q ? fq : fd;
  return 0.5f * (favg<LO, MU>(S, at<HI>(x, fhi - 1), flo) +
                 favg<LO, MU>(S, at<HI>(x, fhi), flo));
}

// The three direction-D fluxes of component Q at face e along D (the
// other coordinates from x): convective, viscous, and the dev2 transpose
// stress's (0 without DEV2).
struct Flux {
  float conv, visc, dev2;
};

template <int Q, int D, bool DEV2, bool DIV, bool H>
__device__ __forceinline__ Flux flux(const Stage<Q, H>& S, const Fields& F,
                                     const P3& x, int e) {
  Flux r = {0.0f, 0.0f, 0.0f};
  const float rh = F.rh[D];
  if constexpr (Q == D) {
    // Between q's entries e − 1 and e along Q (centre e − 1 of the cells);
    // zero-padded at both ends.
    const int n = F.a[Q].e[Q];
    if (kEnds<Q, H> && (e == 0 || e == n)) return r;
    const float g = 0.5f * (ld<RX + D>(S, at<Q>(x, e - 1)) + ld<RX + D>(S, at<Q>(x, e)));
    r.conv = g * muscl<Q>(S, F, x, e, g);
    const int c = e - 1;
    const float dq = (ld<Q>(S, at<Q>(x, c + 1)) - ld<Q>(S, at<Q>(x, c))) * rh;
    const float m = ld<MU>(S, at<Q>(x, c));
    r.visc = m * dq;
    if (DEV2) r.dev2 = m * (DIV ? dq - kTwoThirds * ld<DIVU>(S, at<Q>(x, c)) : dq);
    return r;
  } else {
    const int fq = x.i[Q];
    const P3 y = at<D>(x, e);
    const float g = favg<Q, RX + D>(S, y, fq);
    r.conv = g * muscl<D>(S, F, x, e, g);
    const float me = mu_edge<Q, D>(S, x, fq, e);
    {  // ∂q/∂x_D at the D face, zero on the boundary faces
      const int n = F.a[Q].e[D];
      const float gr = (kEnds<D, H> && (e == 0 || e == n))
                           ? 0.0f
                           : (ld<Q>(S, y) - ld<Q>(S, at<D>(x, e - 1))) * rh;
      r.visc = me * gr;
    }
    if (DEV2) {  // ∂(vel_D)/∂x_Q at the Q face, zero on the boundary faces
      const int n = F.a[D].e[Q];
      const float gr = (kEnds<Q, H> && (fq == 0 || fq == n))
                           ? 0.0f
                           : (ld<D>(S, at<Q>(y, fq)) - ld<D>(S, at<Q>(y, fq - 1))) *
                                 F.rh[Q];
      r.dev2 = me * gr;
    }
    return r;
  }
}

// One component's block: output planes i0 … i1 − 1 of the (j0, k0) tile.
template <int Q, bool DEV2, bool DIV, bool H>
__device__ __forceinline__ void component(const Fields& F, float* __restrict__ out,
                                          float* sm, int chunk) {
  const int e0 = F.a[Q].e[0], e1 = F.a[Q].e[1], e2 = F.a[Q].e[2];
  const int k0 = blockIdx.x * kTZ, j0 = blockIdx.y * kTY;
  const int i0 = chunk * kCX;
  if (i0 >= e0 || j0 >= e1 || k0 >= e2) return;   // uniform over the block
  const int i1 = i0 + kCX < e0 ? i0 + kCX : e0;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTZ + tx;
  const int j = j0 + ty, k = k0 + tx;
  const Stage<Q, H> S = {sm, j0, k0, i0 - 3};
  float* fy = sm + (size_t)kMaxSlots * kSlot;   // [3][kTY + 1][kTZ]
  float* fz = fy + 3 * kFy;                     // [3][kTY][kTZ + 1]

  // Planes i0 − 1 + lo … i0 − 1 + hi of every array (the x flux below the
  // first plane is computed first).
  load_all<Q, DEV2, DIV, H>(S, F, i0 - 1, true, tid);
  __pipeline_commit();

  Flux below = {0.0f, 0.0f, 0.0f};   // the x flux at this thread's face i
  for (int i = i0 - 1; i < i1; ++i) {
    __pipeline_wait_prior(0);
    __syncthreads();   // plane i's ring complete; plane i − 1's fluxes read
    if (i + 1 < i1) load_all<Q, DEV2, DIV, H>(S, F, i + 1, false, tid);
    __pipeline_commit();

    const P3 x = {{i, j, k}};
    const Flux above = flux<Q, 0, DEV2, DIV, H>(S, F, x, i + 1);
    if (i >= i0) {
      // The y fluxes, then the z fluxes, as one list over the block (kFy
      // is a whole number of warps, so each warp takes one direction).
      for (int t = tid; t < kFy + kFz; t += kBlock) {
        if (t < kFy) {
          const int r = t / kTZ, c = t - r * kTZ;
          const Flux f = flux<Q, 1, DEV2, DIV, H>(S, F, P3{{i, j0 + r, k0 + c}}, j0 + r);
          fy[t] = f.conv;
          fy[kFy + t] = f.visc;
          fy[2 * kFy + t] = f.dev2;
        } else {
          const int u = t - kFy, r = u / (kTZ + 1), c = u - r * (kTZ + 1);
          const Flux f = flux<Q, 2, DEV2, DIV, H>(S, F, P3{{i, j0 + r, k0 + c}}, k0 + c);
          fz[u] = f.conv;
          fz[kFz + u] = f.visc;
          fz[2 * kFz + u] = f.dev2;
        }
      }
    }
    __syncthreads();
    if (i >= i0 && j < e1 && k < e2) {
      const int o = (i * e1 + j) * e2 + k;
      if (!H && Q == 0 && i == e0 - 1) {   // u's face-nx row: the sealed +x wall
        out[o] = 0.0f;
      } else {
        const int y0 = ty * kTZ + tx, y1 = y0 + kTZ;            // fy rows j, j + 1
        const int z0 = ty * (kTZ + 1) + tx, z1 = z0 + 1;        // fz columns k, k + 1
        const float* rh = F.rh;
        float visc = (above.visc - below.visc) * rh[0];
        visc = visc + (fy[kFy + y1] - fy[kFy + y0]) * rh[1];
        visc = visc + (fz[kFz + z1] - fz[kFz + z0]) * rh[2];
        float conv = (above.conv - below.conv) * rh[0];
        conv = conv + (fy[y1] - fy[y0]) * rh[1];
        conv = conv + (fz[z1] - fz[z0]) * rh[2];
        float a = visc - conv;
        if (DEV2) {
          float t = (above.dev2 - below.dev2) * rh[0];
          t = t + (fy[2 * kFy + y1] - fy[2 * kFy + y0]) * rh[1];
          t = t + (fz[2 * kFz + z1] - fz[2 * kFz + z0]) * rh[2];
          a = a + t;
        }
        out[o] = a;
      }
    }
    below = above;
  }
}

// Grid: x over z tiles, y over y tiles (of the largest face grid along
// each), z = component · chunks + chunk of kCX x planes (chunks of u's
// x-extent: nx + 1 faces, or the slab's nx packed faces with H); a block
// takes one component's tile and chunk, and the components run one
// after the other.
template <bool DEV2, bool DIV, bool H>
__global__ void __launch_bounds__(kBlock)
momentum_rhs_kernel(Fields F, float* __restrict__ au, float* __restrict__ av,
                    float* __restrict__ aw, int chunks) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.z / chunks, chunk = blockIdx.z - c * chunks;
  if (c == 0)
    component<0, DEV2, DIV, H>(F, au, smem, chunk);
  else if (c == 1)
    component<1, DEV2, DIV, H>(F, av, smem, chunk);
  else
    component<2, DEV2, DIV, H>(F, aw, smem, chunk);
}

template <bool DEV2, bool DIV, bool H>
int launch(const Fields& F, float* au, float* av, float* aw, int ny, int nz,
           cudaStream_t stream) {
  // The dynamic shared memory above 48 KB; the attribute holds for the
  // current device only, so it is set at every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      momentum_rhs_kernel<DEV2, DIV, H>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (F.a[U].e[0] + kCX - 1) / kCX;
  const dim3 block(kTZ, kTY);
  // The extents of the largest grid along y and z: ny + 1 y-faces (v's),
  // nz + 1 z-faces (w's).
  const dim3 grid((nz + 1 + kTZ - 1) / kTZ, (ny + 1 + kTY - 1) / kTY,
                  3 * chunks);
  momentum_rhs_kernel<DEV2, DIV, H><<<grid, block, kSmem, stream>>>(F, au, av, aw,
                                                                    chunks);
  return (int)cudaGetLastError();
}

template <bool H>
int dispatch(int dev2, bool has_div, const Fields& F, void* au, void* av,
             void* aw, int ny, int nz, void* stream) {
  float* A = static_cast<float*>(au);
  float* B = static_cast<float*>(av);
  float* C = static_cast<float*>(aw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dev2) return launch<false, false, H>(F, A, B, C, ny, nz, s);
  if (!has_div) return launch<true, false, H>(F, A, B, C, ny, nz, s);
  return launch<true, true, H>(F, A, B, C, ny, nz, s);
}

void spacing(Fields& F, float hx, float hy, float hz) {
  // f32 reciprocals, as PyTorch's CUDA division by a Python scalar forms.
  F.rh[0] = 1.0f / hx;
  F.rh[1] = 1.0f / hy;
  F.rh[2] = 1.0f / hz;
}

}  // namespace

extern "C" {

// u, rpx: (nx+1, ny, nz); v, rpy: (nx, ny+1, nz); w, rpz: (nx, ny, nz+1);
// mu, div_u: (nx, ny, nz), div_u may be null (then no −(2/3)∇·U term).
// Outputs au, av, aw on the u, v, w face grids. All f32, contiguous.
int momentum_rhs_launch(int dev2, const void* u, const void* v, const void* w,
                        const void* rpx, const void* rpy, const void* rpz,
                        const void* mu, const void* div_u, void* au, void* av,
                        void* aw, int nx, int ny, int nz, float hx, float hy,
                        float hz, void* stream) {
  // 32-bit indices: the largest array must hold fewer than 2³¹ values.
  if ((int64_t)(nx + 1) * (ny + 1) * (nz + 1) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  auto f = [&](const void* t) { return static_cast<const float*>(t); };
  Fields F = {};
  const void* vel[3] = {u, v, w};
  const void* rp[3] = {rpx, rpy, rpz};
  for (int a = 0; a < 3; ++a) {
    const int e[3] = {nx + (a == 0), ny + (a == 1), nz + (a == 2)};
    F.a[U + a] = {f(vel[a]), {e[0], e[1], e[2]}, nullptr, nullptr, 0, 0};
    F.a[RX + a] = {f(rp[a]), {e[0], e[1], e[2]}, nullptr, nullptr, 0, 0};
  }
  F.a[MU] = {f(mu), {nx, ny, nz}, nullptr, nullptr, 0, 0};
  F.a[DIVU] = {f(div_u), {nx, ny, nz}, nullptr, nullptr, 0, 0};
  spacing(F, hx, hy, hz);
  return dispatch<false>(dev2, div_u != nullptr, F, au, av, aw, ny, nz, stream);
}

// The same on one shard's slab of nx cells along x. u, rpx packed to the
// slab's cells: (nx, ny, nz); v, rpy, w, rpz, mu, div_u as above. halo: 13
// planes blocks — u lo, u hi, v lo, v hi, w lo, w hi (2 planes each), rpx
// lo, rpx hi, rpy lo, rpz lo, mu lo, mu hi, div_u lo (1 plane each; div_u's
// null with it). Outputs au (nx, ny, nz) packed, av, aw.
int momentum_rhs_halo_launch(int dev2, const void* u, const void* v,
                             const void* w, const void* rpx, const void* rpy,
                             const void* rpz, const void* mu, const void* div_u,
                             const void* const* halo, void* au, void* av,
                             void* aw, int nx, int ny, int nz, float hx,
                             float hy, float hz, void* stream) {
  if ((int64_t)(nx + 1) * (ny + 1) * (nz + 1) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  auto f = [&](const void* t) { return static_cast<const float*>(t); };
  Fields F = {};
  const void* vel[3] = {u, v, w};
  const void* rp[3] = {rpx, rpy, rpz};
  for (int a = 0; a < 3; ++a) {
    const int e[3] = {nx, ny + (a == 1), nz + (a == 2)};
    F.a[U + a] = {f(vel[a]), {e[0], e[1], e[2]}, f(halo[2 * a]),
                  f(halo[2 * a + 1]), 2, 2};
    F.a[RX + a] = {f(rp[a]), {e[0], e[1], e[2]},
                   f(halo[6 + (a == 0 ? 0 : a + 1)]),
                   a == 0 ? f(halo[7]) : nullptr, 1, a == 0 ? 1 : 0};
  }
  F.a[MU] = {f(mu), {nx, ny, nz}, f(halo[10]), f(halo[11]), 1, 1};
  F.a[DIVU] = {f(div_u), {nx, ny, nz}, f(halo[12]), nullptr, 1, 0};
  spacing(F, hx, hy, hz);
  return dispatch<true>(dev2, div_u != nullptr, F, au, av, aw, ny, nz, stream);
}

}  // extern "C"
