// Batch-native 7-point stencil family: many cases in one launch, on the
// (nx, ny, nz, B) layout with the case axis B trailing (contiguous).
//
// Replaces the TPU kernels in
// openfoam_tpp_tpu/ops/pallas/seven_point_batch.py:
//   apply_7pt_nb        (seven_point_batch.py:174)  A·p, unit or stored diag
//   resid_scaled_7pt_nb (seven_point_batch.py:191)  b − Â·p, or (b − A·p)/diag
//   apply_dot_7pt_nb    (seven_point_batch.py:215)  (Â·p, per-case p·Â·p)
// built on `_nb_core4` (seven_point_batch.py:82-95): the face-lite
// product-shift neighbour sum in which the case axis never shifts, so no
// case reads another's data. Same products and add order as `nb_sum` in
// seven_point.cu (wl·xm + xh + wy·ym + yh + wz·zm + zh): a case's f32
// result equals the single-grid kernel's on that case.
//
// What bounds it on the H100: bytes (5 arrays per unit apply, 13 flops per
// cell). Design: one thread per (cell, case); a warp covers 32 consecutive
// cases of one cell, so with B a multiple of 32 every load and store is
// one coalesced 128-byte (f32) line as the data lies; the spatial
// neighbours are whole rows of B cases at strides B, nz·B and ny·nz·B and
// hit L1/L2. Any (nx, ny, nz, B) is taken: the ragged edge of B and of nz
// is masked. All arithmetic is f32 (bf16 widened on load, rounded once on
// store).
//
// The per-case dot: a block covers 8 z-cells × 32 cases; its 8 rows are
// summed in a fixed order in shared memory into one partial per case and
// block, (n_blocks, B) in all, and a second kernel sums each case's
// partials in a fixed order. No float atomics: the dots, and so every
// lane's CG iteration count, repeat from run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Block: 32 cases (one warp, contiguous) × 8 cells along z. grid.x walks
// the (x, y) columns, grid.y the z chunks, grid.z the case chunks.
constexpr int kBB = 32, kBZ = 8, kBlock = kBB * kBZ;
constexpr int kSumRows = 32;   // rows of the second pass's block

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

// Σ_f w_f·p_nb for element c = cell (i, j, k) of one case. Low neighbours
// are edge-clamped; the high-face term (w_l·p)[+1] is zero at the edge.
template <typename T>
__device__ __forceinline__ float nb_sum(const T* p, const T* wx, const T* wy,
                                        const T* wz, int64_t c, int i, int j,
                                        int k, int nx, int ny, int nz,
                                        int64_t sx, int64_t sy, int64_t sz) {
  const float xm = ld(p, i > 0 ? c - sx : c);
  const float ym = ld(p, j > 0 ? c - sy : c);
  const float zm = ld(p, k > 0 ? c - sz : c);
  const float xh = (i + 1 < nx) ? ld(wx, c + sx) * ld(p, c + sx) : 0.0f;
  const float yh = (j + 1 < ny) ? ld(wy, c + sy) * ld(p, c + sy) : 0.0f;
  const float zh = (k + 1 < nz) ? ld(wz, c + sz) * ld(p, c + sz) : 0.0f;
  float s = ld(wx, c) * xm;
  s = s + xh;
  s = s + ld(wy, c) * ym;
  s = s + yh;
  s = s + ld(wz, c) * zm;
  s = s + zh;
  return s;
}

template <typename T, int MODE, bool DIAG>
__global__ void __launch_bounds__(kBlock)
seven_point_batch_kernel(const T* __restrict__ p, const T* __restrict__ wx,
                         const T* __restrict__ wy, const T* __restrict__ wz,
                         const T* __restrict__ diag, const T* __restrict__ b,
                         T* __restrict__ out, float* __restrict__ partial,
                         int nx, int ny, int nz, int nb) {
  const int lane = blockIdx.z * kBB + threadIdx.x;   // case
  const int k = blockIdx.y * kBZ + threadIdx.y;
  const int i = blockIdx.x / ny;
  const int j = blockIdx.x - i * ny;
  const int64_t sz = nb, sy = (int64_t)nz * nb, sx = (int64_t)ny * sy;
  const int64_t c = i * sx + j * sy + k * sz + lane;
  float dot = 0.0f;
  if (lane < nb && k < nz) {
    const float pc = ld(p, c);
    const float nbs = nb_sum(p, wx, wy, wz, c, i, j, k, nx, ny, nz, sx, sy, sz);
    float v;
    if (MODE == kResid) {
      if (DIAG) {
        const float d = ld(diag, c);
        v = (ld(b, c) - (d * pc - nbs)) / d;
      } else {
        v = ld(b, c) - (pc - nbs);
      }
    } else {
      v = DIAG ? ld(diag, c) * pc - nbs : pc - nbs;
    }
    st(out, c, v);
    if (MODE == kApplyDot) dot = pc * rounded(T(), v);
  }
  if (MODE == kApplyDot) {
    __shared__ float sh[kBZ][kBB];
    sh[threadIdx.y][threadIdx.x] = dot;
    __syncthreads();
    if (threadIdx.y == 0 && lane < nb) {
      float acc = sh[0][threadIdx.x];
      for (int r = 1; r < kBZ; ++r) acc = acc + sh[r][threadIdx.x];
      const int64_t blk = blockIdx.y + (int64_t)gridDim.y * blockIdx.x;
      partial[blk * nb + lane] = acc;
    }
  }
}

// Per case: fixed-order sum of its `n` per-block partials. Block: 32 cases
// × kSumRows rows; row r sums partials r, r + kSumRows, ...; then the rows
// are summed in order.
__global__ void __launch_bounds__(kBB * kSumRows)
sum_partials_batch_kernel(const float* __restrict__ partial, int n, int nb,
                          float* __restrict__ out) {
  __shared__ float sh[kSumRows][kBB];
  const int lane = blockIdx.x * kBB + threadIdx.x;
  float acc = 0.0f;
  if (lane < nb)
    for (int r = threadIdx.y; r < n; r += kSumRows)
      acc = acc + partial[(int64_t)r * nb + lane];
  sh[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && lane < nb) {
    float s = sh[0][threadIdx.x];
    for (int r = 1; r < kSumRows; ++r) s = s + sh[r][threadIdx.x];
    out[lane] = s;
  }
}

template <typename T>
void launch(int mode, int has_diag, const void* p, const void* wx,
            const void* wy, const void* wz, const void* diag, const void* b,
            void* out, float* partial, float* dots, int nx, int ny, int nz,
            int nb, cudaStream_t stream) {
  const dim3 block(kBB, kBZ);
  const dim3 grid(nx * ny, (nz + kBZ - 1) / kBZ, (nb + kBB - 1) / kBB);
  const T* P = static_cast<const T*>(p);
  const T* WX = static_cast<const T*>(wx);
  const T* WY = static_cast<const T*>(wy);
  const T* WZ = static_cast<const T*>(wz);
  const T* D = static_cast<const T*>(diag);
  const T* B = static_cast<const T*>(b);
  T* O = static_cast<T*>(out);
  if (mode == kApply) {
    if (has_diag)
      seven_point_batch_kernel<T, kApply, true><<<grid, block, 0, stream>>>(
          P, WX, WY, WZ, D, B, O, partial, nx, ny, nz, nb);
    else
      seven_point_batch_kernel<T, kApply, false><<<grid, block, 0, stream>>>(
          P, WX, WY, WZ, D, B, O, partial, nx, ny, nz, nb);
  } else if (mode == kResid) {
    if (has_diag)
      seven_point_batch_kernel<T, kResid, true><<<grid, block, 0, stream>>>(
          P, WX, WY, WZ, D, B, O, partial, nx, ny, nz, nb);
    else
      seven_point_batch_kernel<T, kResid, false><<<grid, block, 0, stream>>>(
          P, WX, WY, WZ, D, B, O, partial, nx, ny, nz, nb);
  } else {
    seven_point_batch_kernel<T, kApplyDot, false><<<grid, block, 0, stream>>>(
        P, WX, WY, WZ, D, B, O, partial, nx, ny, nz, nb);
    const int n_blocks = (int)(grid.x * grid.y);
    sum_partials_batch_kernel<<<grid.z, dim3(kBB, kSumRows), 0, stream>>>(
        partial, n_blocks, nb, dots);
  }
}

}  // namespace

extern "C" {

// Number of per-case partial rows apply-dot needs on an (nx, ny, nz, ·)
// grid: the scratch buffer holds that many rows of B floats.
int seven_point_batch_num_partials(int nx, int ny, int nz) {
  return ((nz + kBZ - 1) / kBZ) * nx * ny;
}

// mode: 0 apply, 1 resid, 2 apply+dot (unit diagonal only).
// dtype: 0 float32, 1 bfloat16. `diag`/`b`/`partial`/`dots` may be null
// where the mode does not read them. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a grid the launch cannot index.
int seven_point_batch_launch(int mode, int dtype, int has_diag, const void* p,
                             const void* wx, const void* wy, const void* wz,
                             const void* diag, const void* b, void* out,
                             void* partial, void* dots, int nx, int ny, int nz,
                             int nb, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || nb < 1 ||
      (int64_t)nx * ny > 2147483647LL || (nz + kBZ - 1) / kBZ > 65535 ||
      (nb + kBB - 1) / kBB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* d = static_cast<float*>(dots);
  if (dtype == 0)
    launch<float>(mode, has_diag, p, wx, wy, wz, diag, b, out, part, d, nx, ny,
                  nz, nb, s);
  else
    launch<__nv_bfloat16>(mode, has_diag, p, wx, wy, wz, diag, b, out, part, d,
                          nx, ny, nz, nb, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
