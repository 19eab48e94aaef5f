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
// cell). Apply: one thread per (cell, case); a warp covers 32 consecutive
// cases of one cell, so with B a multiple of 32 every load and store is
// one coalesced 128-byte (f32) line as the data lies; the spatial
// neighbours are whole rows of B cases at strides B, nz·B and ny·nz·B and
// hit L1/L2. Any (nx, ny, nz, B) is taken: the ragged edge of B and of nz
// is masked. All arithmetic is f32 (bf16 widened on load, rounded once on
// store).
//
// Resid (the V-cycle's smoother, most of the sweep's launches), on grids
// of at least kMarchFrom elements with B even and every pointer aligned
// for pairs: a thread takes two adjacent cases (one bf16x2 / float2 load,
// so a warp reads 64 cases, a full 128-byte bf16 line), a block kCC (x, y)
// columns (one warp a column; one column a block measured fastest), and
// it marches a chunk of z planes with p at z−1, z, z+1 and wz at z, z+1 in
// registers, the next plane's loaded one plane ahead; the x and y taps go
// through L1/L2. The chunk is the fewest planes that keep the launch
// within kRWaves waves of the card. Per element the arithmetic is
// `nb_sum`'s, in its order, with the IEEE division by diag: bitwise equal
// to the one-thread-per-element kernel, which takes every other resid
// input, and to the single-grid kernel on each case.
//
// Apply-dot (the sweep CG's curvature step): one launch for any input. A
// block is one (x, y) column and 32 consecutive cases, one case a thread;
// warp w of its kDZ takes the column's planes w, w + kDZ, …, each with
// `nb_sum`'s products and add order, so Â·p is bitwise equal to the
// single-grid kernel on each case. A thread adds its case's p·(Â·p) in
// plane order, and the block adds its warps' sums in warp order into one
// partial per (column, case), partial[column · B + case]. Each block then
// fences and takes a ticket from its case group's counter:
// atomicInc(counter, columns − 1) wraps it back to 0 by itself. The
// block that draws a group's last ticket sums the group's partials with
// all its warps: warp w adds columns w, w + kDZ, … in order, kDSlotRuns
// loads in flight a thread, and the warps' sums are added in warp order.
// No float atomics: the dots, and so every case's CG iteration count,
// repeat bitwise from run to run, in an order set by the shape alone. At
// the sweep's 12×12×50×128 on an H100 the main pass takes ~7.3 µs, the
// partials and tickets ~1.2 and the last blocks' sums ~1.4 (PERF.md §6,
// where a z march, unrolled plane loops and one last block for all cases
// are measured slower). The counters are the device's ticket buffer
// (ops/kernels/_build.py `ticket`, one counter a case group), shared with
// seven_point.cu, cheb2.cu and correction.cu, so these calls run on one
// stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Block: 32 cases (one warp, contiguous) × 8 cells along z. grid.x walks
// the (x, y) columns, grid.y the z chunks, grid.z the case chunks.
constexpr int kBB = 32, kBZ = 8, kBlock = kBB * kBZ;
// Apply-dot: warps per block (each a set of z planes), and partials a
// thread of a case group's last block loads at once.
constexpr int kDZ = 8, kDBlock = 32 * kDZ;
constexpr int kDSlotRuns = 3;
// Resid march: threads along the case pairs, (x, y) columns per block,
// and the waves of the card one launch is sized to.
constexpr int kCB = 32, kCC = 1, kRBlock = kCB * kCC;
constexpr float kRWaves = 1.0f;
// Grids of fewer elements (cells × cases) take the one-thread-per-element
// kernel for resid too: in the sweep step it was the faster at the
// V-cycle's 6×6×25×128 and 3×3×13×128 levels (PERF.md §6).
constexpr int64_t kMarchFrom = 262144;

enum Mode { kApply = 0, kResid = 1, kApplyDot = 2 };

__device__ __forceinline__ float ld(const float* a, int64_t i) { return a[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* a, int64_t i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void st(float* a, int64_t i, float v) { a[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* a, int64_t i, float v) {
  a[i] = __float2bfloat16_rn(v);
}
// Two adjacent elements from i (one 8- or 4-byte access; i must be even
// and the array aligned for it).
__device__ __forceinline__ void ld2(const float* a, int64_t i, float (&o)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(a + i);
  o[0] = t.x;
  o[1] = t.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* a, int64_t i,
                                    float (&o)[2]) {
  const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(a + i);
  o[0] = __bfloat162float(t.x);
  o[1] = __bfloat162float(t.y);
}
__device__ __forceinline__ void st2(float* a, int64_t i, const float (&v)[2]) {
  *reinterpret_cast<float2*>(a + i) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void st2(__nv_bfloat16* a, int64_t i,
                                    const float (&v)[2]) {
  __nv_bfloat162 t;
  t.x = __float2bfloat16_rn(v[0]);
  t.y = __float2bfloat16_rn(v[1]);
  *reinterpret_cast<__nv_bfloat162*>(a + i) = t;
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
                         T* __restrict__ out, int nx, int ny, int nz, int nb) {
  const int lane = blockIdx.z * kBB + threadIdx.x;   // case
  const int k = blockIdx.y * kBZ + threadIdx.y;
  const int i = blockIdx.x / ny;
  const int j = blockIdx.x - i * ny;
  const int64_t sz = nb, sy = (int64_t)nz * nb, sx = (int64_t)ny * sy;
  const int64_t c = i * sx + j * sy + k * sz + lane;
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
  }
}

// b − Â·p, or (b − A·p)/diag, over z planes k0 … k0 + cz − 1 of one
// (x, y) column and two adjacent cases per thread; the per-element
// arithmetic is nb_sum's, in its order (the z taps from registers).
// grid.x walks column groups, grid.y case groups, grid.z z chunks.
template <typename T, bool DIAG>
__global__ void __launch_bounds__(kRBlock)
resid_batch_kernel(const T* __restrict__ p, const T* __restrict__ wx,
                   const T* __restrict__ wy, const T* __restrict__ wz,
                   const T* __restrict__ diag, const T* __restrict__ b,
                   T* __restrict__ out, int nx, int ny, int nz, int nb,
                   int cz) {
  const int e0 = (blockIdx.y * kCB + threadIdx.x) * 2;   // first case
  const int col = blockIdx.x * kCC + threadIdx.y;        // i · ny + j
  if (e0 >= nb || col >= nx * ny) return;
  const int i = col / ny;
  const int j = col - i * ny;
  const int k0 = blockIdx.z * cz;
  const int k1 = k0 + cz < nz ? k0 + cz : nz;
  const int64_t sz = nb, sy = (int64_t)nz * nb, sx = (int64_t)ny * sy;
  int64_t c = col * sy + k0 * sz + e0;
  // p at z−1 (clamped), z and z+1; wz at z and z+1.
  float pm[2], pc[2], pp[2], wzc[2], wzp[2];
  ld2(p, k0 > 0 ? c - sz : c, pm);
  ld2(p, c, pc);
  ld2(wz, c, wzc);
  if (k0 + 1 < nz) {
    ld2(p, c + sz, pp);
    ld2(wz, c + sz, wzp);
  } else {
    for (int e = 0; e < 2; ++e) pp[e] = wzp[e] = 0.0f;
  }
  for (int k = k0; k < k1; ++k, c += sz) {
    float pn[2], wzn[2], xm[2], xh[2], ym[2], yh[2], wxc[2], wyc[2];
    float bc[2], dc[2], v[2];
    if (k + 2 < nz && k + 1 < k1) {
      ld2(p, c + 2 * sz, pn);
      ld2(wz, c + 2 * sz, wzn);
    } else {
      for (int e = 0; e < 2; ++e) pn[e] = wzn[e] = 0.0f;
    }
    ld2(p, i > 0 ? c - sx : c, xm);
    if (i + 1 < nx) {
      float wn[2], pnb[2];
      ld2(wx, c + sx, wn);
      ld2(p, c + sx, pnb);
      for (int e = 0; e < 2; ++e) xh[e] = wn[e] * pnb[e];
    } else {
      for (int e = 0; e < 2; ++e) xh[e] = 0.0f;
    }
    ld2(p, j > 0 ? c - sy : c, ym);
    if (j + 1 < ny) {
      float wn[2], pnb[2];
      ld2(wy, c + sy, wn);
      ld2(p, c + sy, pnb);
      for (int e = 0; e < 2; ++e) yh[e] = wn[e] * pnb[e];
    } else {
      for (int e = 0; e < 2; ++e) yh[e] = 0.0f;
    }
    ld2(wx, c, wxc);
    ld2(wy, c, wyc);
    ld2(b, c, bc);
    if (DIAG) ld2(diag, c, dc);
    const bool up = k + 1 < nz;
    for (int e = 0; e < 2; ++e) {
      float s = wxc[e] * xm[e];
      s = s + xh[e];
      s = s + wyc[e] * ym[e];
      s = s + yh[e];
      s = s + wzc[e] * pm[e];
      s = s + (up ? wzp[e] * pp[e] : 0.0f);
      v[e] = DIAG ? (bc[e] - (dc[e] * pc[e] - s)) / dc[e]
                  : bc[e] - (pc[e] - s);
      pm[e] = pc[e];
      pc[e] = pp[e];
      wzc[e] = wzp[e];
      pp[e] = pn[e];
      wzp[e] = wzn[e];
    }
    st2(out, c, v);
  }
}

// The resid march: chunks of z planes sized so that the launch stays
// within kRWaves waves of the current device at the kernel's occupancy
// (asked at every launch), and within grid.z's limit.
template <typename T, bool DIAG>
void launch_resid(const T* p, const T* wx, const T* wy, const T* wz,
                  const T* diag, const T* b, T* out, int nx, int ny, int nz,
                  int nb, cudaStream_t stream) {
  const auto kernel = resid_batch_kernel<T, DIAG>;
  const int gx = (int)(((int64_t)nx * ny + kCC - 1) / kCC);
  const int gy = (nb + kCB * 2 - 1) / (kCB * 2);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRBlock, 0);
  int64_t chunks = (int64_t)(kRWaves * (float)(sms * per_sm)) /
                   ((int64_t)gx * gy);
  chunks = chunks < 1 ? 1 : (chunks > nz ? nz : chunks);
  int cz = (int)((nz + chunks - 1) / chunks);
  if ((nz + cz - 1) / cz > 65535) cz = (nz + 65534) / 65535;
  const dim3 grid(gx, gy, (nz + cz - 1) / cz);
  kernel<<<grid, dim3(kCB, kCC), 0, stream>>>(p, wx, wy, wz, diag, b, out, nx,
                                              ny, nz, nb, cz);
}

// Whether every pointer is a multiple of n bytes (a null pointer is).
template <typename... P>
bool aligned(uintptr_t n, P... ptrs) {
  return ((reinterpret_cast<uintptr_t>(ptrs) % n == 0) && ...);
}

// The shuffle tree over the 32 lanes of a warp: lane 0 ends with the sum.
__device__ __forceinline__ float warp_tree(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Â·p and the per-case p·Â·p (unit diagonal) of one (x, y) column
// (blockIdx.x) and 32 consecutive cases (blockIdx.y), one case a thread:
// warp w takes planes w, w + kDZ, …, each with nb_sum's arithmetic, and
// adds its p·(Â·p) in plane order. The block's warps' sums go in warp
// order to partial[column · B + case]; the block that draws its case
// group's last ticket sums the group's partials into dots (see the
// header).
template <typename T>
__global__ void __launch_bounds__(kDBlock)
apply_dot_batch_kernel(const T* __restrict__ p, const T* __restrict__ wx,
                       const T* __restrict__ wy, const T* __restrict__ wz,
                       T* __restrict__ out, float* __restrict__ partial,
                       unsigned* __restrict__ ticket, float* __restrict__ dots,
                       int nx, int ny, int nz, int nb) {
  __shared__ float rows[kDZ][32];
  __shared__ bool last;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int e = blockIdx.y * 32 + lane;   // case
  const int col = blockIdx.x;             // i · ny + j
  const int cols = gridDim.x;
  const int i = col / ny;
  const int j = col - i * ny;
  const int64_t sz = nb, sy = (int64_t)nz * nb, sx = (int64_t)ny * sy;
  float acc = 0.0f;
  if (e < nb) {
    for (int k = warp; k < nz; k += kDZ) {
      const int64_t c = col * sy + k * sz + e;
      const float pc = ld(p, c);
      const float v =
          pc - nb_sum(p, wx, wy, wz, c, i, j, k, nx, ny, nz, sx, sy, sz);
      st(out, c, v);
      acc = acc + pc * rounded(T(), v);
    }
  }
  rows[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && e < nb) {
    const int used = nz < kDZ ? nz : kDZ;
    float s = rows[0][lane];
    for (int r = 1; r < used; ++r) s = s + rows[r][lane];
    partial[(int64_t)col * nb + e] = s;
    __threadfence();   // visible before this block's ticket
  }
  __syncthreads();
  // The case group's own counter: its last block sums the group's dots.
  const unsigned nblocks = gridDim.x;
  if (lane == 0 && warp == 0) {
    last = atomicInc(ticket + blockIdx.y, nblocks - 1) == nblocks - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // Every partial of the group is written. Warp w adds columns w,
  // w + kDZ, … of its lane's case in order, kDSlotRuns of them a pass with
  // their loads issued together; then the warps' sums are added in warp
  // order.
  float s = 0.0f;
  if (e < nb) {
    const float* row = partial + e;
    for (int m0 = warp; m0 < cols; m0 += kDZ * kDSlotRuns) {
      float v[kDSlotRuns];
#pragma unroll
      for (int t = 0; t < kDSlotRuns; ++t) {
        const int m = m0 + kDZ * t;
        v[t] = m < cols ? __ldcg(row + (int64_t)m * nb) : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < kDSlotRuns; ++t)
        if (m0 + kDZ * t < cols) s = s + v[t];
    }
  }
  rows[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < nb) {
    const int used = cols < kDZ ? cols : kDZ;
    float d = rows[0][lane];
    for (int r = 1; r < used; ++r) d = d + rows[r][lane];
    dots[e] = d;
  }
}

template <typename T>
void launch(int mode, int has_diag, const void* p, const void* wx,
            const void* wy, const void* wz, const void* diag, const void* b,
            void* out, float* partial, unsigned* ticket, float* dots, int nx,
            int ny, int nz, int nb, cudaStream_t stream) {
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
          P, WX, WY, WZ, D, B, O, nx, ny, nz, nb);
    else
      seven_point_batch_kernel<T, kApply, false><<<grid, block, 0, stream>>>(
          P, WX, WY, WZ, D, B, O, nx, ny, nz, nb);
  } else if (mode == kResid && (int64_t)nx * ny * nz * nb >= kMarchFrom &&
             nb % 2 == 0 && aligned(2 * sizeof(T), P, WX, WY, WZ, D, B, O)) {
    if (has_diag)
      launch_resid<T, true>(P, WX, WY, WZ, D, B, O, nx, ny, nz, nb, stream);
    else
      launch_resid<T, false>(P, WX, WY, WZ, D, B, O, nx, ny, nz, nb, stream);
  } else if (mode == kResid) {
    if (has_diag)
      seven_point_batch_kernel<T, kResid, true><<<grid, block, 0, stream>>>(
          P, WX, WY, WZ, D, B, O, nx, ny, nz, nb);
    else
      seven_point_batch_kernel<T, kResid, false><<<grid, block, 0, stream>>>(
          P, WX, WY, WZ, D, B, O, nx, ny, nz, nb);
  } else {
    apply_dot_batch_kernel<T><<<dim3(nx * ny, (nb + 31) / 32),
                                dim3(32, kDZ), 0, stream>>>(
        P, WX, WY, WZ, O, partial, ticket, dots, nx, ny, nz, nb);
  }
}

}  // namespace

extern "C" {

// Number of per-case partial rows apply-dot needs on an (nx, ny, nz, ·)
// grid: the scratch buffer holds that many rows of B floats (one per
// (x, y) column).
int seven_point_batch_num_partials(int nx, int ny, int nz) {
  (void)nz;
  return nx * ny;
}

// mode: 0 apply, 1 resid, 2 apply+dot (unit diagonal only).
// dtype: 0 float32, 1 bfloat16. `diag`/`b`/`partial`/`ticket`/`dots` may be
// null where the mode does not read them; `ticket` holds ceil(B/32)
// unsigned counters, one per 32 cases, each 0 between calls (apply-dot
// leaves them so). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a grid the launch cannot index.
int seven_point_batch_launch(int mode, int dtype, int has_diag, const void* p,
                             const void* wx, const void* wy, const void* wz,
                             const void* diag, const void* b, void* out,
                             void* partial, void* dots, void* ticket, int nx,
                             int ny, int nz, int nb, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || nb < 1 ||
      (int64_t)nx * ny > 2147483647LL || (nz + kBZ - 1) / kBZ > 65535 ||
      (nb + kBB - 1) / kBB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  unsigned* tk = static_cast<unsigned*>(ticket);
  float* d = static_cast<float*>(dots);
  if (dtype == 0)
    launch<float>(mode, has_diag, p, wx, wy, wz, diag, b, out, part, tk, d, nx,
                  ny, nz, nb, s);
  else
    launch<__nv_bfloat16>(mode, has_diag, p, wx, wy, wz, diag, b, out, part,
                          tk, d, nx, ny, nz, nb, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
