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
// about 8 µs at 3.35 TB/s); the arithmetic is 13 flops per cell.
//
// apply / resid (modes 0, 1): one thread per cell, 32 consecutive z cells
// per warp so every array access is coalesced; the six neighbour reads of
// p and the three shifted weight reads hit L1/L2 (planes of 112² cells fit
// in L2 many times over), so DRAM traffic stays near one read per array.
// All arithmetic is f32 (bf16 arrays are widened on load and rounded once
// on store). They run at 1.1× (apply) and 1.9× (bf16 resid) their bound.
//
// apply-dot (mode 2): one launch, with a dot that repeats bitwise and
// that the x-sharded island reproduces bitwise. A block owns a 8 × 32
// (y, z) tile and marches along a chunk of x planes, one cell per thread
// per plane, keeping p at x−1, x, x+1 and wxl at x, x+1 in registers, the
// next plane's loaded one plane ahead (the y/z taps hit L1: the block
// loaded them one plane before as its x+1 values). The chunk is the
// fewest planes (at most kMaxCX) that keep the grid within one wave of
// the card at the kernel's occupancy (the SM count and the blocks per SM
// are asked at every launch), so all blocks are in flight at once and a
// 28-plane shard still fills the card. The dot is built per x plane, so
// that neither the chunk nor a cut into x-slabs changes its bits: per
// plane each warp sums its row with a fixed shuffle tree, and after the
// march one thread per plane adds the tile's 8 row sums in a fixed tree
// into partial[plane · tiles + tile]. Each block then fences and takes a
// ticket: atomicInc(ticket, nblocks − 1) wraps the counter back to 0 by
// itself, so it needs no reset. The block that draws the last ticket
// forms each plane's sum (a fixed tree over its tiles) and adds the plane
// sums in plane order to `acc` (0 on a single grid; on a shard, the dot
// of the shards before it), so the chain of shards adds exactly what the
// single grid adds. No float atomics: the dot, and so the CG iteration
// count, repeats from run to run, on any card. What this costs: the last
// block's pass over nx · tiles partials and the ticket's round trip, a
// tail of a few µs after the march (PERF.md §6). The ticket counter is one
// per device, owned by the wrappers (ops/kernels/_build.py `ticket`) and
// shared with cheb2.cu and correction.cu: calls that share it must not
// overlap, so they run on one stream. A launch that faults part-way leaves it
// non-zero; the process must then start again, as after any CUDA fault.
//
// Halo variants (`seven_point_halo_launch`) replace the TPU kernels in
// openfoam_tpp_tpu/ops/pallas/halo7.py: apply_7pt_h (halo7.py:141),
// resid_scaled_7pt_h (:160) and apply_dot_7pt_h (:179), the per-shard
// kernels of the x-sharded step. They are the same kernels with HALO set:
// the x-neighbour loads that fall outside the shard's slab read the
// exchanged planes instead (p's ±1 planes h_lo / h_hi, and wx_hi, the next
// shard's first wxl plane, for the last plane's high-face term
// wx_hi·h_hi). They never clamp: at the global ends the halo content
// carries the clamp. Same bytes plus three planes, same bound; the dot is
// the caller's `acc` (the shards before this one) plus this shard's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Block: 32 cells along z (one warp, contiguous) × 8 along y; the grid's
// z dimension walks x. No integer division in the index math.
constexpr int kBX = 32, kBY = 8, kBlock = kBX * kBY;
constexpr int kWarps = kBlock / 32;
// apply-dot: blocks per launch, about kWaves times what the card holds at
// once at the kernel's occupancy (one wave: the most blocks in flight, no
// tail).
constexpr float kWaves = 1.0f;
constexpr int kMaxCX = 16;   // x planes per block, at most
constexpr int kPerWarp = 16;   // planes per warp per batch of the final sum
constexpr int kPlanes = kWarps * kPerWarp;
static_assert(kWarps == 8, "the row tree adds 8 warp sums");

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
                   T* __restrict__ out, int nx, int ny, int nz) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  const int i = blockIdx.z;
  if (k >= nz || j >= ny) return;
  const int64_t c = ((int64_t)i * ny + j) * nz + k;
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
}

// The shuffle tree over the 32 lanes of a warp: lane 0 ends with the sum.
__device__ __forceinline__ float warp_tree(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Â·p and p·Â·p (unit diagonal) over x planes i0 … i0 + cx − 1 of one
// (y, z) tile; the per-cell arithmetic is nb_sum's, in its order. Per
// plane each warp (a z row of the tile) sums its cells' p·(Â·p) with
// warp_tree; after the march one thread per plane adds the 8 row sums in
// a fixed tree into partial[plane · tiles + tile]: the same values
// whatever the chunk. The last block to finish sums them: each plane's
// sum is warp_tree over lane sums (lane l: tiles l, l + 32, … in order),
// and the dot is acc_in (or 0) plus the plane sums in plane order.
template <typename T, bool HALO>
__global__ void __launch_bounds__(kBlock)
apply_dot_kernel(const T* __restrict__ p, const Halo<T> h,
                 const T* __restrict__ wx, const T* __restrict__ wy,
                 const T* __restrict__ wz, T* __restrict__ out,
                 float* __restrict__ partial, unsigned* __restrict__ ticket,
                 const float* __restrict__ acc_in, float* __restrict__ dot,
                 int nx, int ny, int nz, int cx) {
  __shared__ float rows[kMaxCX][kWarps];
  __shared__ float planes[kPlanes];
  __shared__ bool last;
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  const int t = threadIdx.y * kBX + threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.x + gridDim.x * blockIdx.y;
  const int i0 = blockIdx.z * cx;
  const int i1 = i0 + cx < nx ? i0 + cx : nx;
  const bool in = k < nz && j < ny;
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  const int64_t q = (int64_t)j * nz + k;   // the cell's place in an x-plane
  int64_t c = i0 * sx + q;
  // p at x−1 (clamped, or the halo plane), x and x+1; wxl at x and x+1;
  // the next plane's p and wxl are loaded one plane ahead.
  float pm = 0.0f, pc = 0.0f, wxc = 0.0f, pp = 0.0f, wxp = 0.0f;
  if (in) {
    pm = i0 > 0 ? ld(p, c - sx) : (HALO ? ld(h.lo, q) : ld(p, c));
    pc = ld(p, c);
    wxc = ld(wx, c);
    pp = i0 + 1 < nx ? ld(p, c + sx) : 0.0f;
    wxp = i0 + 1 < nx ? ld(wx, c + sx) : 0.0f;
  }
  for (int i = i0; i < i1; ++i, c += sx) {
    float d = 0.0f;
    if (in) {
      const bool up = i + 1 < nx;
      const bool ahead = i + 2 < nx && i + 1 < i1;
      const float pn = ahead ? ld(p, c + 2 * sx) : 0.0f;
      const float wxn = ahead ? ld(wx, c + 2 * sx) : 0.0f;
      float xh;
      if (HALO)
        xh = up ? wxp * pp : ld(h.wx_hi, q) * ld(h.hi, q);
      else
        xh = up ? wxp * pp : 0.0f;
      const float ym = ld(p, j > 0 ? c - sy : c);
      const float zm = ld(p, k > 0 ? c - 1 : c);
      const float yh = (j + 1 < ny) ? ld(wy, c + sy) * ld(p, c + sy) : 0.0f;
      const float zh = (k + 1 < nz) ? ld(wz, c + 1) * ld(p, c + 1) : 0.0f;
      float s = wxc * pm;
      s = s + xh;
      s = s + ld(wy, c) * ym;
      s = s + yh;
      s = s + ld(wz, c) * zm;
      s = s + zh;
      const float v = pc - s;
      st(out, c, v);
      d = pc * rounded(T(), v);
      pm = pc;
      pc = pp;
      wxc = wxp;
      pp = pn;
      wxp = wxn;
    }
    d = warp_tree(d);
    if (lane == 0) rows[i - i0][warp] = d;
  }
  __syncthreads();
  if (t < i1 - i0) {
    const float* r = rows[t];
    partial[(int64_t)(i0 + t) * tiles + tile] =
        ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    __threadfence();   // visible before this block's ticket
  }
  __syncthreads();
  const unsigned nblocks = gridDim.x * gridDim.y * gridDim.z;
  if (t == 0) {
    last = atomicInc(ticket, nblocks - 1) == nblocks - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // Every partial is written. Per batch of kPlanes planes, warp w takes
  // planes w, w + kWarps, … with all their loads issued together.
  float run = acc_in != nullptr ? *acc_in : 0.0f;
  for (int b0 = 0; b0 < nx; b0 += kPlanes) {
    const int nb = nx - b0 < kPlanes ? nx - b0 : kPlanes;
    float ls[kPerWarp];
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) ls[u] = 0.0f;
    for (int m = lane; m < tiles; m += 32) {
#pragma unroll
      for (int u = 0; u < kPerWarp; ++u) {
        const int pl = warp + kWarps * u;
        if (pl < nb)
          ls[u] = ls[u] + __ldcg(partial + (int64_t)(b0 + pl) * tiles + m);
      }
    }
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      const float e = warp_tree(ls[u]);
      if (lane == 0) planes[warp + kWarps * u] = e;
    }
    __syncthreads();
    if (t == 0)
      for (int pl = 0; pl < nb; ++pl) run = run + planes[pl];
    __syncthreads();   // the batch is read before the next overwrites it
  }
  if (t == 0) dot[0] = run;
}

// apply-dot's x planes per block for `tiles` (y, z) tiles of an nx-plane
// grid: the fewest that keep the launch within kWaves waves of the
// current device at the kernel's occupancy (asked at every launch: a
// process may use more than one card).
template <typename K>
int chunk_planes(K kernel, int tiles, int nx) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
  int chunks = (int)(kWaves * (float)(sms * per_sm)) / tiles;
  chunks = chunks < 1 ? 1 : (chunks > nx ? nx : chunks);
  const int cx = (nx + chunks - 1) / chunks;
  return cx < kMaxCX ? cx : kMaxCX;
}

template <typename T, bool HALO>
void launch(int mode, int has_diag, const void* p, const void* const* halo,
            const void* wx, const void* wy, const void* wz, const void* diag,
            const void* b, void* out, float* partial, float* dot,
            unsigned* ticket, const float* acc, int nx, int ny, int nz,
            cudaStream_t stream) {
  const dim3 block(kBX, kBY);
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
  if (mode == kApplyDot) {
    const int tiles = ((nz + kBX - 1) / kBX) * ((ny + kBY - 1) / kBY);
    const int cx = chunk_planes(apply_dot_kernel<T, HALO>, tiles, nx);
    const dim3 grid((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY,
                    (nx + cx - 1) / cx);
    apply_dot_kernel<T, HALO><<<grid, block, 0, stream>>>(
        P, H, WX, WY, WZ, O, partial, ticket, acc, dot, nx, ny, nz, cx);
    return;
  }
  const dim3 grid((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY, nx);
  if (mode == kApply) {
    if (has_diag)
      seven_point_kernel<T, kApply, true, HALO><<<grid, block, 0, stream>>>(
          P, H, WX, WY, WZ, D, B, O, nx, ny, nz);
    else
      seven_point_kernel<T, kApply, false, HALO><<<grid, block, 0, stream>>>(
          P, H, WX, WY, WZ, D, B, O, nx, ny, nz);
  } else {
    if (has_diag)
      seven_point_kernel<T, kResid, true, HALO><<<grid, block, 0, stream>>>(
          P, H, WX, WY, WZ, D, B, O, nx, ny, nz);
    else
      seven_point_kernel<T, kResid, false, HALO><<<grid, block, 0, stream>>>(
          P, H, WX, WY, WZ, D, B, O, nx, ny, nz);
  }
}

template <bool HALO>
int dispatch(int mode, int dtype, int has_diag, const void* p,
             const void* const* halo, const void* wx, const void* wy,
             const void* wz, const void* diag, const void* b, void* out,
             void* partial, void* dot, void* ticket, const void* acc, int nx,
             int ny, int nz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* d = static_cast<float*>(dot);
  unsigned* tk = static_cast<unsigned*>(ticket);
  const float* ac = static_cast<const float*>(acc);
  if (dtype == 0)
    launch<float, HALO>(mode, has_diag, p, halo, wx, wy, wz, diag, b, out, part,
                        d, tk, ac, nx, ny, nz, s);
  else
    launch<__nv_bfloat16, HALO>(mode, has_diag, p, halo, wx, wy, wz, diag, b,
                                out, part, d, tk, ac, nx, ny, nz, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-(plane, tile) partials apply-dot needs on an (nx, ny, nz) grid.
int seven_point_num_partials(int nx, int ny, int nz) {
  return ((nz + kBX - 1) / kBX) * ((ny + kBY - 1) / kBY) * nx;
}

// mode: 0 apply, 1 resid, 2 apply+dot (unit diagonal only).
// dtype: 0 float32, 1 bfloat16. `diag`/`b`/`partial`/`dot`/`ticket` may be
// null where the mode does not read them; `ticket` is one unsigned
// counter that is 0 between calls (apply-dot leaves it so).
int seven_point_launch(int mode, int dtype, int has_diag, const void* p,
                       const void* wx, const void* wy, const void* wz,
                       const void* diag, const void* b, void* out,
                       void* partial, void* dot, void* ticket, int nx, int ny,
                       int nz, void* stream) {
  return dispatch<false>(mode, dtype, has_diag, p, nullptr, wx, wy, wz, diag,
                         b, out, partial, dot, ticket, nullptr, nx, ny, nz,
                         stream);
}

// The same on one shard's (nx, ny, nz) slab, with its halo planes (each
// (1, ny, nz), the slab's dtype): h_lo / h_hi p's planes x = −1 / nx, and
// wx_hi the next shard's first wxl plane. The dot is `acc` (the previous
// shards' dot, f32; null: 0) plus this shard's planes, added in the order
// the single-grid kernel adds them, so a chain of shards gives its dot.
int seven_point_halo_launch(int mode, int dtype, int has_diag, const void* p,
                            const void* h_lo, const void* h_hi,
                            const void* wx_hi, const void* wx, const void* wy,
                            const void* wz, const void* diag, const void* b,
                            void* out, void* partial, void* dot, void* ticket,
                            const void* acc, int nx, int ny, int nz,
                            void* stream) {
  const void* halo[3] = {h_lo, h_hi, wx_hi};
  return dispatch<true>(mode, dtype, has_diag, p, halo, wx, wy, wz, diag, b,
                        out, partial, dot, ticket, acc, nx, ny, nz, stream);
}

}  // extern "C"
