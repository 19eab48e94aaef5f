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
// The shifts are edge-clamped, like stencil.shift_down/shift_up. u's
// face-nx row (the sealed +x wall) is written as zeros.
//
// Its bound on the H100 is bytes. It reads six face arrays (u, v, w,
// ρφ×3) and two cell arrays (μ, ∇·U) and writes three face arrays: 62 MB
// per 112³ call, about 18.6 µs at 3.35 TB/s. The arithmetic is about 320
// flops per cell (18 van Leer limiters, two divisions each), about 7 µs
// at 67 TFLOP/s f32. Design: one thread per output face, 32 consecutive
// z faces per warp, one launch over the union of the three face grids
// with the component taken from the block index: all of u's blocks,
// then v's, then w's (blockIdx.z = c·(nx+1) + i). The three component
// bodies together are ~8000 SASS instructions; on an H100, blocks of all
// three interleaved on an SM ran 6% slower (scripts/port_kernel_variants.py).
// Every neighbour read goes through L1/L2 with 32-bit index arithmetic
// (each array holds < 2³¹ values; 64-bit indices cost 1.3× there), and each
// thread recomputes the two fluxes that bound its face instead of
// sharing them through shared memory (tiling is later work). So the
// kernel is bound by instruction issue, not by bytes. The operation
// order is the plain version's, and the build has no FMA contraction,
// so the two agree to rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32, kBY = 8, kBlock = kBX * kBY;
constexpr float kEps = 1e-30f;
constexpr float kTwoThirds = (float)(2.0 / 3.0);

struct P3 {
  int i[3];
};

template <int A>
__device__ __forceinline__ P3 at(P3 p, int v) {
  p.i[A] = v;
  return p;
}

// A read-only row-major array with extents (e[0], e[1], e[2]).
struct Arr {
  const float* __restrict__ p;
  int e[3];
  __device__ __forceinline__ float operator()(const P3& c) const {
    return __ldg(p + (c.i[0] * e[1] + c.i[1]) * e[2] + c.i[2]);
  }
};

template <int A>
__device__ __forceinline__ float clamped(const Arr& a, const P3& x, int v) {
  const int n = a.e[A];
  return a(at<A>(x, v < 0 ? 0 : (v >= n ? n - 1 : v)));
}

// van Leer limiter φ(r)·Δdown, r = Δup/Δdown (stencil.vanleer_limited).
__device__ __forceinline__ float vl(float up, float down) {
  const float safe = fabsf(down) > kEps ? down : (down >= 0.0f ? kEps : -kEps);
  const float r = up / safe;
  const float phi = (r + fabsf(r)) / (1.0f + fabsf(r));
  return phi * down;
}

// stencil.vanleer_faces at face e along A (faces 0 … n_A of q's entries
// along A): up_plus of the entry below, or up_minus of the entry above,
// by the sign of the mass flux g; face_lr clamps both ends.
template <int A>
__device__ __forceinline__ float muscl(const Arr& q, const P3& x, int e, float g) {
  const int n = q.e[A];
  const int c = g >= 0.0f ? (e - 1 < 0 ? 0 : e - 1) : (e > n - 1 ? n - 1 : e);
  const float q0 = q(at<A>(x, c));
  const float dm = q0 - clamped<A>(q, x, c - 1);
  const float dp = clamped<A>(q, x, c + 1) - q0;
  return g >= 0.0f ? q0 + 0.5f * vl(dm, dp) : q0 - 0.5f * vl(dp, dm);
}

// cells_to_faces_avg along A at face f (n cells along A).
template <int A>
__device__ __forceinline__ float favg(const Arr& a, const P3& x, int f, int n) {
  if (f == 0) return a(at<A>(x, 0));
  if (f == n) return a(at<A>(x, n - 1));
  return 0.5f * (a(at<A>(x, f - 1)) + a(at<A>(x, f)));
}

// μ on the (Q-face fq, D-face fd) edge: cells_to_faces_avg along the
// lower axis, then along the higher (solver/momentum.py edge_viscosities).
template <int Q, int D>
__device__ __forceinline__ float mu_edge(const Arr& mu, const P3& x, int fq, int fd) {
  constexpr int LO = Q < D ? Q : D, HI = Q < D ? D : Q;
  const int flo = LO == Q ? fq : fd, fhi = HI == Q ? fq : fd;
  const int n = mu.e[HI];
  auto inner = [&](int ch) { return favg<LO>(mu, at<HI>(x, ch), flo, mu.e[LO]); };
  if (fhi == 0) return inner(0);
  if (fhi == n) return inner(n - 1);
  return 0.5f * (inner(fhi - 1) + inner(fhi));
}

struct Fields {
  Arr vel[3], rp[3], mu, div;
  float h[3];
};

// convect_face_field's direction-D term for component Q at face x.
template <int Q, int D>
__device__ __forceinline__ float conv_term(const Fields& F, const P3& x) {
  const Arr& q = F.vel[Q];
  const Arr& rp = F.rp[D];
  const float h = F.h[D];
  if (Q == D) {
    const int n = q.e[Q];   // faces of q along Q; centres 1 … n−1 inside
    auto flux = [&](int m) {
      if (m == 0 || m == n) return 0.0f;
      const float g = 0.5f * (rp(at<Q>(x, m - 1)) + rp(at<Q>(x, m)));
      return g * muscl<Q>(q, x, m, g);
    };
    const int f = x.i[Q];
    return (flux(f + 1) - flux(f)) / h;
  }
  const int fq = x.i[Q];
  auto flux = [&](int e) {
    const float g = favg<Q>(rp, at<D>(x, e), fq, rp.e[Q]);
    return g * muscl<D>(q, x, e, g);
  };
  const int e = x.i[D];
  return (flux(e + 1) - flux(e)) / h;
}

// viscous_face_field's direction-D term (DEV2: the transpose stress's).
template <int Q, int D, bool DEV2, bool DIV>
__device__ __forceinline__ float visc_term(const Fields& F, const P3& x) {
  const Arr& q = F.vel[Q];
  const Arr& mu = F.mu;
  const float h = F.h[D];
  if (Q == D) {
    const int n = q.e[Q];
    auto flux = [&](int m) {
      if (m == 0 || m == n) return 0.0f;
      const int c = m - 1;
      float dq = (q(at<Q>(x, c + 1)) - q(at<Q>(x, c))) / h;
      if (DEV2 && DIV) dq = dq - kTwoThirds * F.div(at<Q>(x, c));
      return mu(at<Q>(x, c)) * dq;
    };
    const int f = x.i[Q];
    return (flux(f + 1) - flux(f)) / h;
  }
  const int fq = x.i[Q];
  auto flux = [&](int e) {
    const float me = mu_edge<Q, D>(mu, x, fq, e);
    const P3 y = at<D>(x, e);
    float g;
    if (DEV2) {   // ∂(vel_D)/∂x_Q at the Q face, zero on the boundary faces
      const Arr& vd = F.vel[D];
      const int n = vd.e[Q];
      g = (fq == 0 || fq == n) ? 0.0f
          : (vd(at<Q>(y, fq)) - vd(at<Q>(y, fq - 1))) / F.h[Q];
    } else {      // ∂q/∂x_D at the D face, zero on the boundary faces
      const int n = q.e[D];
      g = (e == 0 || e == n) ? 0.0f : (q(y) - q(at<D>(x, e - 1))) / h;
    }
    return me * g;
  };
  const int e = x.i[D];
  return (flux(e + 1) - flux(e)) / h;
}

// The output face (i, j, k) of component Q, on Q's face grid.
template <int Q, bool DEV2, bool DIV>
__device__ __forceinline__ void face_rhs(const Fields& F, float* __restrict__ out,
                                         int i, int j, int k) {
  const int e0 = F.vel[Q].e[0], e1 = F.vel[Q].e[1], e2 = F.vel[Q].e[2];
  if (i >= e0 || j >= e1 || k >= e2) return;
  const int o = (i * e1 + j) * e2 + k;
  if (Q == 0 && i == e0 - 1) {   // u's face-nx row: the sealed +x wall
    out[o] = 0.0f;
    return;
  }
  const P3 x = {{i, j, k}};
  float visc = visc_term<Q, 0, false, false>(F, x);
  visc = visc + visc_term<Q, 1, false, false>(F, x);
  visc = visc + visc_term<Q, 2, false, false>(F, x);
  float conv = conv_term<Q, 0>(F, x);
  conv = conv + conv_term<Q, 1>(F, x);
  conv = conv + conv_term<Q, 2>(F, x);
  float a = visc - conv;
  if (DEV2) {
    float t = visc_term<Q, 0, true, DIV>(F, x);
    t = t + visc_term<Q, 1, true, DIV>(F, x);
    t = t + visc_term<Q, 2, true, DIV>(F, x);
    a = a + t;
  }
  out[o] = a;
}

// Grid: x over z faces, y over y faces, z = component·(nx+1) + i; a
// block takes one component of one x-plane (the component is uniform in
// it), and the components run one after the other.
template <bool DEV2, bool DIV>
__global__ void __launch_bounds__(kBlock)
momentum_rhs_kernel(Fields F, float* __restrict__ au, float* __restrict__ av,
                    float* __restrict__ aw) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  const int n0 = F.vel[0].e[0];
  const int c = blockIdx.z / n0, i = blockIdx.z - c * n0;
  if (c == 0)
    face_rhs<0, DEV2, DIV>(F, au, i, j, k);
  else if (c == 1)
    face_rhs<1, DEV2, DIV>(F, av, i, j, k);
  else
    face_rhs<2, DEV2, DIV>(F, aw, i, j, k);
}

template <bool DEV2, bool DIV>
void launch(const Fields& F, float* au, float* av, float* aw, int nx, int ny,
            int nz, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  // The extents of the largest grid along each axis: nx + 1 x-planes
  // (u's), ny + 1 y-faces (v's), nz + 1 z-faces (w's).
  const dim3 grid((nz + 1 + kBX - 1) / kBX, (ny + 1 + kBY - 1) / kBY, 3 * (nx + 1));
  momentum_rhs_kernel<DEV2, DIV><<<grid, block, 0, stream>>>(F, au, av, aw);
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
  Fields F;
  const void* vel[3] = {u, v, w};
  const void* rp[3] = {rpx, rpy, rpz};
  for (int a = 0; a < 3; ++a) {
    const int e[3] = {nx + (a == 0), ny + (a == 1), nz + (a == 2)};
    F.vel[a] = Arr{static_cast<const float*>(vel[a]), {e[0], e[1], e[2]}};
    F.rp[a] = Arr{static_cast<const float*>(rp[a]), {e[0], e[1], e[2]}};
  }
  F.mu = Arr{static_cast<const float*>(mu), {nx, ny, nz}};
  F.div = Arr{static_cast<const float*>(div_u), {nx, ny, nz}};
  F.h[0] = hx;
  F.h[1] = hy;
  F.h[2] = hz;
  float* A = static_cast<float*>(au);
  float* B = static_cast<float*>(av);
  float* C = static_cast<float*>(aw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dev2)
    launch<false, false>(F, A, B, C, nx, ny, nz, s);
  else if (div_u == nullptr)
    launch<true, false>(F, A, B, C, nx, ny, nz, s);
  else
    launch<true, true>(F, A, B, C, nx, ny, nz, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
