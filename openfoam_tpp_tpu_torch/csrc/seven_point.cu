// 7-point variable-coefficient stencil family on the face-lite layout.
//
// Replaces the TPU kernels in openfoam_tpp_tpu/ops/pallas/seven_point.py:
//   apply_7pt        (seven_point.py:229)  A·p, unit or stored diagonal
//   resid_scaled_7pt (seven_point.py:258)  b − Â·p, or (b − A·p)/diag
//   apply_dot_7pt    (seven_point.py:286)  (Â·p, p·Â·p)
// all three built on the shared neighbour-sum core `_nb_core`
// (seven_point.py:58-83), which becomes `nb_sum` below.
//
// Face-lite layout: only the three LOW-face weight arrays are read; wxl[c]
// multiplies p[x−1]. The high-face term of cell c is (w_l·p)[c+1], the
// low face of the next cell, and it is exactly zero at the domain edge
// because domain-boundary faces carry zero weight (mesh/geometry.py
// `_finalize`). Low neighbours are edge-clamped, as on the TPU.
//
// What bounds it on the H100: bytes. Per cell the unit apply reads p and
// three weights and writes one value (5 arrays, 28 MB per 112³ f32 call,
// about 8 µs at 3.35 TB/s); the arithmetic is 13 flops per cell. Design:
// one thread per cell, 32 consecutive z cells per warp so every array
// access is coalesced; the six neighbour reads of p and the three shifted weight
// reads hit L1/L2 (planes of 112² cells fit in L2 many times over), so
// DRAM traffic stays near one read per array. All arithmetic is f32 (bf16
// arrays are widened on load and rounded once on store). Shared-memory
// tiling is left for a later change.
//
// The dot: blocks run in no order, so each block writes its own partial
// (a fixed-shape tree in shared memory) and a second one-block pass sums
// the partials in a fixed order. No float atomics: the result, and so the
// CG iteration count, repeats from run to run.
//
// Halo variants (`seven_point_halo_launch`) replace the TPU kernels in
// openfoam_tpp_tpu/ops/pallas/halo7.py: apply_7pt_h (halo7.py:141),
// resid_scaled_7pt_h (:160) and apply_dot_7pt_h (:179), the per-shard
// kernels of the x-sharded step. They are the same kernel with HALO set:
// the x-neighbour loads that fall outside the shard's slab read the
// exchanged planes instead (p's ±1 planes h_lo / h_hi, and wx_hi, the next
// shard's first wxl plane, for the last plane's high-face term
// wx_hi·h_hi). They never clamp: at the global ends the halo content
// carries the clamp. Same bytes plus three planes, same bound; the dot is
// the shard's partial, summed over the shards by the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Block: 32 cells along z (one warp, contiguous) × 8 along y; the grid's
// z dimension walks x. No integer division in the index math.
constexpr int kBX = 32, kBY = 8, kBlock = kBX * kBY;
constexpr int kSumBlock = 1024;

enum Mode { kApply = 0, kResid = 1, kApplyDot = 2 };

__device__ __forceinline__ float ld(const float* a, int64_t i) { return a[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* a, int64_t i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void st(float* a, int64_t i, float v) { a[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* a, int64_t i, float v) {
  a[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float rounded(float, float v) { return v; }
__device__ __forceinline__ float rounded(__nv_bfloat16, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A shard's halo planes, each (1, ny, nz): p's planes x = −1 and x = nx,
// and the next shard's first wxl plane.
template <typename T>
struct Halo {
  const T *lo, *hi, *wx_hi;
};

// Σ_f w_f·p_nb for cell c = (i, j, k); same products and add order as
// `_nb_core`: wl·xm + xh + wy·ym + yh + wz·zm + zh. With HALO the
// x-neighbours outside the slab come from the halo planes h.
template <typename T, bool HALO>
__device__ __forceinline__ float nb_sum(const T* p, const T* wx, const T* wy,
                                        const T* wz, const Halo<T>& h,
                                        int64_t c, int i, int j, int k, int nx,
                                        int ny, int nz) {
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  const int64_t q = (int64_t)j * nz + k;   // the cell's place in an x-plane
  float xm, xh;
  if (HALO) {
    xm = i > 0 ? ld(p, c - sx) : ld(h.lo, q);
    xh = (i + 1 < nx) ? ld(wx, c + sx) * ld(p, c + sx)
                      : ld(h.wx_hi, q) * ld(h.hi, q);
  } else {
    xm = ld(p, i > 0 ? c - sx : c);
    xh = (i + 1 < nx) ? ld(wx, c + sx) * ld(p, c + sx) : 0.0f;
  }
  const float ym = ld(p, j > 0 ? c - sy : c);
  const float zm = ld(p, k > 0 ? c - 1 : c);
  const float yh = (j + 1 < ny) ? ld(wy, c + sy) * ld(p, c + sy) : 0.0f;
  const float zh = (k + 1 < nz) ? ld(wz, c + 1) * ld(p, c + 1) : 0.0f;
  float s = ld(wx, c) * xm;
  s = s + xh;
  s = s + ld(wy, c) * ym;
  s = s + yh;
  s = s + ld(wz, c) * zm;
  s = s + zh;
  return s;
}

template <typename T, int MODE, bool DIAG, bool HALO>
__global__ void __launch_bounds__(kBlock)
seven_point_kernel(const T* __restrict__ p, const Halo<T> h,
                   const T* __restrict__ wx,
                   const T* __restrict__ wy, const T* __restrict__ wz,
                   const T* __restrict__ diag, const T* __restrict__ b,
                   T* __restrict__ out, float* __restrict__ partial, int nx,
                   int ny, int nz) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  const int i = blockIdx.z;
  const int64_t c = ((int64_t)i * ny + j) * nz + k;
  float dot = 0.0f;
  if (k < nz && j < ny) {
    const float pc = ld(p, c);
    const float nb = nb_sum<T, HALO>(p, wx, wy, wz, h, c, i, j, k, nx, ny, nz);
    float v;
    if (MODE == kResid) {
      if (DIAG) {
        const float d = ld(diag, c);
        v = (ld(b, c) - (d * pc - nb)) / d;
      } else {
        v = ld(b, c) - (pc - nb);
      }
    } else {
      v = DIAG ? ld(diag, c) * pc - nb : pc - nb;
    }
    st(out, c, v);
    if (MODE == kApplyDot) dot = pc * rounded(T(), v);
  }
  if (MODE == kApplyDot) {
    __shared__ float sh[kBlock];
    const int t = threadIdx.y * kBX + threadIdx.x;
    sh[t] = dot;
    __syncthreads();
    for (int s = kBlock / 2; s > 0; s >>= 1) {
      if (t < s) sh[t] = sh[t] + sh[t + s];
      __syncthreads();
    }
    if (t == 0)
      partial[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)] = sh[0];
  }
}

// One block: fixed-order sum of the per-block partials.
__global__ void __launch_bounds__(kSumBlock)
sum_partials_kernel(const float* __restrict__ partial, int n,
                    float* __restrict__ out) {
  __shared__ float sh[kSumBlock];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kSumBlock) acc = acc + partial[i];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kSumBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = sh[threadIdx.x] + sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = sh[0];
}

template <typename T, bool HALO>
void launch(int mode, int has_diag, const void* p, const void* const* halo,
            const void* wx, const void* wy, const void* wz, const void* diag,
            const void* b, void* out, float* partial, float* dot, int nx,
            int ny, int nz, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY, nx);
  const int n_partials = (int)(grid.x * grid.y * grid.z);
  const T* P = static_cast<const T*>(p);
  Halo<T> H = {nullptr, nullptr, nullptr};
  if (HALO)
    H = {static_cast<const T*>(halo[0]), static_cast<const T*>(halo[1]),
         static_cast<const T*>(halo[2])};
  const T* WX = static_cast<const T*>(wx);
  const T* WY = static_cast<const T*>(wy);
  const T* WZ = static_cast<const T*>(wz);
  const T* D = static_cast<const T*>(diag);
  const T* B = static_cast<const T*>(b);
  T* O = static_cast<T*>(out);
  if (mode == kApply) {
    if (has_diag)
      seven_point_kernel<T, kApply, true, HALO><<<grid, block, 0, stream>>>(
          P, H, WX, WY, WZ, D, B, O, partial, nx, ny, nz);
    else
      seven_point_kernel<T, kApply, false, HALO><<<grid, block, 0, stream>>>(
          P, H, WX, WY, WZ, D, B, O, partial, nx, ny, nz);
  } else if (mode == kResid) {
    if (has_diag)
      seven_point_kernel<T, kResid, true, HALO><<<grid, block, 0, stream>>>(
          P, H, WX, WY, WZ, D, B, O, partial, nx, ny, nz);
    else
      seven_point_kernel<T, kResid, false, HALO><<<grid, block, 0, stream>>>(
          P, H, WX, WY, WZ, D, B, O, partial, nx, ny, nz);
  } else {
    seven_point_kernel<T, kApplyDot, false, HALO><<<grid, block, 0, stream>>>(
        P, H, WX, WY, WZ, D, B, O, partial, nx, ny, nz);
    sum_partials_kernel<<<1, kSumBlock, 0, stream>>>(partial, n_partials, dot);
  }
}

template <bool HALO>
int dispatch(int mode, int dtype, int has_diag, const void* p,
             const void* const* halo, const void* wx, const void* wy,
             const void* wz, const void* diag, const void* b, void* out,
             void* partial, void* dot, int nx, int ny, int nz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* d = static_cast<float*>(dot);
  if (dtype == 0)
    launch<float, HALO>(mode, has_diag, p, halo, wx, wy, wz, diag, b, out, part,
                        d, nx, ny, nz, s);
  else
    launch<__nv_bfloat16, HALO>(mode, has_diag, p, halo, wx, wy, wz, diag, b,
                                out, part, d, nx, ny, nz, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partials apply-dot needs on an (nx, ny, nz) grid.
int seven_point_num_partials(int nx, int ny, int nz) {
  return ((nz + kBX - 1) / kBX) * ((ny + kBY - 1) / kBY) * nx;
}

// mode: 0 apply, 1 resid, 2 apply+dot (unit diagonal only).
// dtype: 0 float32, 1 bfloat16. `diag`/`b`/`partial`/`dot` may be null
// where the mode does not read them.
int seven_point_launch(int mode, int dtype, int has_diag, const void* p,
                       const void* wx, const void* wy, const void* wz,
                       const void* diag, const void* b, void* out,
                       void* partial, void* dot, int nx, int ny, int nz,
                       void* stream) {
  return dispatch<false>(mode, dtype, has_diag, p, nullptr, wx, wy, wz, diag,
                         b, out, partial, dot, nx, ny, nz, stream);
}

// The same on one shard's (nx, ny, nz) slab, with its halo planes (each
// (1, ny, nz), the slab's dtype): h_lo / h_hi p's planes x = −1 / nx, and
// wx_hi the next shard's first wxl plane. The dot is the shard's partial.
int seven_point_halo_launch(int mode, int dtype, int has_diag, const void* p,
                            const void* h_lo, const void* h_hi,
                            const void* wx_hi, const void* wx, const void* wy,
                            const void* wz, const void* diag, const void* b,
                            void* out, void* partial, void* dot, int nx, int ny,
                            int nz, void* stream) {
  const void* halo[3] = {h_lo, h_hi, wx_hi};
  return dispatch<true>(mode, dtype, has_diag, p, halo, wx, wy, wz, diag, b,
                        out, partial, dot, nx, ny, nz, stream);
}

}  // extern "C"
