// Fused momentum finish: the explicit update's last step for all three
// MAC velocity components in one launch.
//
// Replaces the TPU kernel openfoam_tpp_tpu/ops/pallas/mom_finish.py
// `momentum_finish` (mom_finish.py:88, pallas_call at :115, body
// `_kernel` at :58).
//
// Per face of component a: q* = (ρ_f^old·q + dt·vc)/ρ_f^new + dt·G_a,
// masked to zero where the aperture is 0, with ρ_f the arithmetic face
// mean of the cell densities (cells_to_faces_avg: the boundary faces take
// the edge cell). vc is the momentum right-hand side, its x component
// cell-shaped; u's face-nx row (the sealed +x wall) is written as zeros.
// dt (0-d) and G (3,) are read from device memory, so the step never
// waits on the host for them.
//
// What bounds it on the H100: bytes. It reads two densities and the x
// right-hand side (cells), u, v, w, the y and z right-hand sides and the
// three apertures (faces), and writes three face arrays: 79 MB per 112³
// call, about 24 µs at 3.35 TB/s; about 33 flops per cell. Design: one
// thread per output face, 32 consecutive z faces per warp, one launch over
// the union of the three face grids with the component taken from the
// block index (blockIdx.z = 3·i + a), 32-bit indices (each array holds
// < 2³¹ values); the densities' second read for the face mean hits L1/L2.
// The operation order is the plain version's and the build has no FMA
// contraction, so the two agree to rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32, kBY = 8, kBlock = kBX * kBY;

// One component's arrays: q and ap on its face grid, vc on the same grid
// (cell-shaped for A == 0), out on the face grid.
struct Comp {
  const float* q;
  const float* vc;
  const float* ap;
  float* out;
};

// The output face (i, j, k) of component A: the face grid's extents are
// the cells' + 1 along A.
template <int A>
__device__ __forceinline__ void finish_face(const float* __restrict__ dt_p,
                                            const float* __restrict__ G,
                                            const float* __restrict__ ro,
                                            const float* __restrict__ rn, const Comp& C,
                                            int nx, int ny, int nz, int i, int j, int k) {
  const int e0 = nx + (A == 0), e1 = ny + (A == 1), e2 = nz + (A == 2);
  if (i >= e0 || j >= e1 || k >= e2) return;
  // The same linear offset indexes q, ap, out and vc: for A == 0, vc has
  // nx rows of the same (ny, nz) planes, and row nx is not read.
  const int o = (i * e1 + j) * e2 + k;
  if (A == 0 && i == nx) {
    C.out[o] = 0.0f;
    return;
  }
  const int n = A == 0 ? nx : (A == 1 ? ny : nz);
  const int f = A == 0 ? i : (A == 1 ? j : k);
  const int s = A == 0 ? ny * nz : (A == 1 ? nz : 1);
  // Cell (f, …) along A; the face's lower cell is one stride below it.
  const int c = ((A == 0 ? (f < nx ? f : nx - 1) : i) * ny
                 + (A == 1 ? (f < ny ? f : ny - 1) : j)) * nz
                + (A == 2 ? (f < nz ? f : nz - 1) : k);
  float rof, rnf;
  if (f == 0 || f == n) {   // boundary face: the edge cell
    rof = __ldg(ro + c);
    rnf = __ldg(rn + c);
  } else {
    rof = 0.5f * (__ldg(ro + c - s) + __ldg(ro + c));
    rnf = 0.5f * (__ldg(rn + c - s) + __ldg(rn + c));
  }
  const float dt = __ldg(dt_p);
  float r = (rof * __ldg(C.q + o) + dt * __ldg(C.vc + o)) / rnf;
  r = r + dt * __ldg(G + A);
  C.out[o] = __ldg(C.ap + o) > 0.0f ? r : 0.0f;
}

// Grid: x over z faces, y over y faces, z = 3·i + component; a block
// takes one component of one x-plane.
__global__ void __launch_bounds__(kBlock)
finish_kernel(const float* __restrict__ dt_p, const float* __restrict__ G,
              const float* __restrict__ ro, const float* __restrict__ rn, Comp cu,
              Comp cv, Comp cw, int nx, int ny, int nz) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  const int i = blockIdx.z / 3, a = blockIdx.z - 3 * i;
  if (a == 0)
    finish_face<0>(dt_p, G, ro, rn, cu, nx, ny, nz, i, j, k);
  else if (a == 1)
    finish_face<1>(dt_p, G, ro, rn, cv, nx, ny, nz, i, j, k);
  else
    finish_face<2>(dt_p, G, ro, rn, cw, nx, ny, nz, i, j, k);
}

}  // namespace

extern "C" {

// dt: 0-d, G: (3,), both f32 on the device. ro, rn, vcx: (nx, ny, nz);
// u, ax: (nx+1, ny, nz); v, vcy, ay: (nx, ny+1, nz); w, vcz, az:
// (nx, ny, nz+1). Outputs ou, ov, ow on the u, v, w grids.
int mom_finish_launch(const void* dt, const void* G, const void* ro, const void* rn,
                      const void* u, const void* v, const void* w, const void* vcx,
                      const void* vcy, const void* vcz, const void* ax,
                      const void* ay, const void* az, void* ou, void* ov, void* ow,
                      int nx, int ny, int nz, void* stream) {
  // 32-bit indices: the largest array must hold fewer than 2³¹ values.
  if ((int64_t)(nx + 1) * (ny + 1) * (nz + 1) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto O = [](void* p) { return static_cast<float*>(p); };
  const dim3 block(kBX, kBY);
  const dim3 grid((nz + 1 + kBX - 1) / kBX, (ny + 1 + kBY - 1) / kBY, 3 * nx + 1);
  finish_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      F(dt), F(G), F(ro), F(rn), Comp{F(u), F(vcx), F(ax), O(ou)},
      Comp{F(v), F(vcy), F(ay), O(ov)}, Comp{F(w), F(vcz), F(az), O(ow)}, nx, ny, nz);
  return (int)cudaGetLastError();
}

}  // extern "C"
