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
// on store). They run at 1.1× (apply) and 1.8× (bf16 resid) their bound.
// An x march (apply-dot's, below, without the dot) gave resid no gain in
// the steps, which the host paces: there every launch meets an idle card,
// and the grid of one thread per cell, with the most loads in flight,
// finished first (PERF.md §6).
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
// Halo variants replace the TPU kernels in openfoam_tpp_tpu/ops/pallas/
// halo7.py: apply_7pt_h (halo7.py:141), resid_scaled_7pt_h (:160) and
// apply_dot_7pt_h (:179), the per-shard kernels of the x-sharded step.
// They do the single-grid arithmetic, but the x-neighbour loads that fall
// outside a shard's slab read the exchanged planes instead (p's ±1 planes
// h_lo / h_hi, and wx_hi, the next shard's first wxl plane, for the last
// plane's high-face term wx_hi·h_hi). They never clamp: at the global
// ends the halo content carries the clamp. Same bytes plus three planes,
// same bound.
//
// Apply and resid (`seven_point_slabs_launch`) take a table of slabs: one
// launch covers every slab the process holds, as the TPU mesh runs an
// island's shards at once. The table (at most kMaxSlabs descriptors, each
// a slab's p, its three halo planes, weights, diag, b and out; every slab
// the same (nx, ny, nz)) is a kernel parameter, read in place from the
// constant bank (__grid_constant__); the grid's z dimension walks all
// S·nx planes and a block finds its slab from blockIdx.z. A block
// addresses each operand from its plane's first cell (uniform in the
// block) plus the cell's place in the plane: the per-cell halo selects
// and 64-bit index math of a shard kernel, and a division for the slab,
// took the first table kernel to 1.6× the single grid (PERF.md §6). A slab's
// x-neighbours beyond its planes come from its own halo pointers, never
// from the next slab's memory, so a table of one slab with received halo
// planes is the form a process holding one shard launches. Launched one
// shard at a time (even chained by programmatic dependent launch), an
// island of four 28-plane shards lost three launches' ramp and drain
// against the single grid, not bytes (PERF.md §6, rows 11a-b).
//
// Apply-dot (`seven_point_halo_launch`, mode 2) stays one launch a shard:
// its dot is the caller's `acc` (the shards before this one) plus this
// shard's, so the chain of shards adds exactly what the single grid adds.
// It takes a row window [y0, y1): only the cells of those y rows enter
// the dot (Â·p is written on every row). A rank of the 2-D x·y
// decomposition runs it on its block extended by the y neighbours' rows
// (parallel/spmd.py) and passes its own rows; with the full window
// [0, ny), what a single grid and the 1-D decomposition pass, every term
// is what it was, bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Block: 32 cells along z (one warp, contiguous) × 8 along y; the grid's
// z dimension walks x (and the slabs of a table). No integer division in
// the index math (a table's slab index is a multiply-high).
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
// Slabs one apply / resid launch takes at most (the table's size).
constexpr int kMaxSlabs = 16;

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
// `_nb_core`: wl·xm + xh + wy·ym + yh + wz·zm + zh.
template <typename T>
__device__ __forceinline__ float nb_sum(const T* p, const T* wx, const T* wy,
                                        const T* wz, int64_t c, int i, int j,
                                        int k, int nx, int ny, int nz) {
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  const float xm = ld(p, i > 0 ? c - sx : c);
  const float xh = (i + 1 < nx) ? ld(wx, c + sx) * ld(p, c + sx) : 0.0f;
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

// Apply (A·p, or Â·p without DIAG) or resid ((b − A·p)/diag, or b − Â·p)
// of cell c from p there and its neighbour sum.
template <typename T, int MODE, bool DIAG>
__device__ __forceinline__ float value(float pc, float nb,
                                       const T* __restrict__ diag,
                                       const T* __restrict__ b, int64_t c) {
  if (MODE == kResid) {
    if (DIAG) {
      const float d = ld(diag, c);
      return (ld(b, c) - (d * pc - nb)) / d;
    }
    return ld(b, c) - (pc - nb);
  }
  return DIAG ? ld(diag, c) * pc - nb : pc - nb;
}

template <typename T, int MODE, bool DIAG>
__global__ void __launch_bounds__(kBlock)
seven_point_kernel(const T* __restrict__ p, const T* __restrict__ wx,
                   const T* __restrict__ wy, const T* __restrict__ wz,
                   const T* __restrict__ diag, const T* __restrict__ b,
                   T* __restrict__ out, int nx, int ny, int nz) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  if (k >= nz || j >= ny) return;
  const int i = blockIdx.z;
  const int64_t c = ((int64_t)i * ny + j) * nz + k;
  const float pc = ld(p, c);
  const float nb = nb_sum<T>(p, wx, wy, wz, c, i, j, k, nx, ny, nz);
  st(out, c, value<T, MODE, DIAG>(pc, nb, diag, b, c));
}

// One slab of an apply / resid table: its operands, its halo planes and
// its output. `diag` / `b` are null where the mode does not read them.
template <typename T>
struct Slab {
  const T *p;
  Halo<T> h;
  const T *wx, *wy, *wz, *diag, *b;
  T* out;
};
template <typename T>
struct Slabs {
  Slab<T> s[kMaxSlabs];
};

// Every slab of the table in one grid: blockIdx.z = slab · nx + plane.
// The slab is blockIdx.z / nx as a multiply-high by magic = ⌈2^32 / nx⌉
// (exact for blockIdx.z and nx below 2^16). Each operand is addressed
// from its x plane's first cell, the same for the whole block (the halo
// plane where the x-neighbour lies beyond the slab), plus the cell's
// place q in the plane; the products and adds are nb_sum's, in its order.
template <typename T, int MODE, bool DIAG>
__global__ void __launch_bounds__(kBlock)
seven_point_slabs_kernel(const __grid_constant__ Slabs<T> t, int nx, int ny,
                         int nz, unsigned magic) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  if (k >= nz || j >= ny) return;
  const int z = blockIdx.z;
  const int n = nx == 1 ? z : (int)__umulhi((unsigned)z, magic);
  const int i = z - n * nx;
  const Slab<T>& s = t.s[n];
  const int64_t sx = (int64_t)ny * nz, c0 = i * sx;
  const bool up = i + 1 < nx;
  const T* pc = s.p + c0;
  const T* pm = i > 0 ? pc - sx : s.h.lo;
  const T* pp = up ? pc + sx : s.h.hi;
  const T* wxp = up ? s.wx + c0 + sx : s.h.wx_hi;
  const T* wxc = s.wx + c0;
  const T* wyc = s.wy + c0;
  const T* wzc = s.wz + c0;
  const int64_t q = (int64_t)j * nz + k;
  const float pq = ld(pc, q);
  const float ym = ld(pc, j > 0 ? q - nz : q);
  const float zm = ld(pc, k > 0 ? q - 1 : q);
  const float yh = (j + 1 < ny) ? ld(wyc, q + nz) * ld(pc, q + nz) : 0.0f;
  const float zh = (k + 1 < nz) ? ld(wzc, q + 1) * ld(pc, q + 1) : 0.0f;
  float nb = ld(wxc, q) * ld(pm, q);
  nb = nb + ld(wxp, q) * ld(pp, q);
  nb = nb + ld(wyc, q) * ym;
  nb = nb + yh;
  nb = nb + ld(wzc, q) * zm;
  nb = nb + zh;
  st(s.out, c0 + q, value<T, MODE, DIAG>(pq, nb, s.diag, s.b, c0 + q));
}

// The shuffle tree over the 32 lanes of a warp: lane 0 ends with the sum.
__device__ __forceinline__ float warp_tree(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Â·p and p·Â·p (unit diagonal) over x planes i0 … i0 + cx − 1 of one
// (y, z) tile; the per-cell arithmetic is nb_sum's, in its order. A cell
// outside the row window [y0, y1) adds 0 to the dot. Per
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
                 int nx, int ny, int nz, int cx, int y0, int y1) {
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
  const bool owned = j >= y0 && j < y1;   // the row window of the dot
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
      d = owned ? pc * rounded(T(), v) : 0.0f;
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
            int y0, int y1, cudaStream_t stream) {
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
        P, H, WX, WY, WZ, O, partial, ticket, acc, dot, nx, ny, nz, cx, y0,
        y1);
    return;
  }
  if (HALO) return;   // halo apply / resid: launch_slabs
  const dim3 grid((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY, nx);
  if (mode == kApply) {
    if (has_diag)
      seven_point_kernel<T, kApply, true><<<grid, block, 0, stream>>>(
          P, WX, WY, WZ, D, B, O, nx, ny, nz);
    else
      seven_point_kernel<T, kApply, false><<<grid, block, 0, stream>>>(
          P, WX, WY, WZ, D, B, O, nx, ny, nz);
  } else if (has_diag) {
    seven_point_kernel<T, kResid, true><<<grid, block, 0, stream>>>(
        P, WX, WY, WZ, D, B, O, nx, ny, nz);
  } else {
    seven_point_kernel<T, kResid, false><<<grid, block, 0, stream>>>(
        P, WX, WY, WZ, D, B, O, nx, ny, nz);
  }
}

// Apply (mode 0) or resid (mode 1) over `n` slabs; `ptrs` holds kSlabPtrs
// pointers a slab, in Slab<T>'s order.
constexpr int kSlabPtrs = 10;
template <typename T>
int launch_slabs(int mode, int has_diag, int n, const void* const* ptrs,
                 int nx, int ny, int nz, cudaStream_t stream) {
  Slabs<T> t = {};
  for (int m = 0; m < n; ++m) {
    const void* const* q = ptrs + m * kSlabPtrs;
    const auto in = [&](int u) { return static_cast<const T*>(q[u]); };
    t.s[m] = {in(0), {in(1), in(2), in(3)}, in(4), in(5), in(6), in(7),
              in(8), static_cast<T*>(const_cast<void*>(q[9]))};
  }
  const dim3 grid((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY, n * nx);
  const dim3 block(kBX, kBY);
  const auto kernel =
      mode == kApply
          ? (has_diag ? seven_point_slabs_kernel<T, kApply, true>
                      : seven_point_slabs_kernel<T, kApply, false>)
          : (has_diag ? seven_point_slabs_kernel<T, kResid, true>
                      : seven_point_slabs_kernel<T, kResid, false>);
  const unsigned magic =
      nx > 1 ? (unsigned)(((1ull << 32) + nx - 1) / nx) : 0u;
  kernel<<<grid, block, 0, stream>>>(t, nx, ny, nz, magic);
  return (int)cudaGetLastError();
}

template <bool HALO>
int dispatch(int mode, int dtype, int has_diag, const void* p,
             const void* const* halo, const void* wx, const void* wy,
             const void* wz, const void* diag, const void* b, void* out,
             void* partial, void* dot, void* ticket, const void* acc, int nx,
             int ny, int nz, int y0, int y1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* d = static_cast<float*>(dot);
  unsigned* tk = static_cast<unsigned*>(ticket);
  const float* ac = static_cast<const float*>(acc);
  if (dtype == 0)
    launch<float, HALO>(mode, has_diag, p, halo, wx, wy, wz, diag, b, out, part,
                        d, tk, ac, nx, ny, nz, y0, y1, s);
  else
    launch<__nv_bfloat16, HALO>(mode, has_diag, p, halo, wx, wy, wz, diag, b,
                                out, part, d, tk, ac, nx, ny, nz, y0, y1, s);
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
                         b, out, partial, dot, ticket, nullptr, nx, ny, nz, 0,
                         ny, stream);
}

// Slabs one seven_point_slabs_launch takes at most.
int seven_point_max_slabs() { return kMaxSlabs; }

// Apply (mode 0) or resid (mode 1) on `n_slabs` (1 … kMaxSlabs) x-slabs of
// (nx, ny, nz) cells each, in one launch. `table` holds 10 pointers a
// slab: p, h_lo, h_hi, wx_hi, wx, wy, wz, diag, b, out. The halo planes
// are (1, ny, nz), the slabs' dtype: h_lo / h_hi p's planes x = −1 / nx,
// and wx_hi the next shard's first wxl plane. `diag` (with has_diag) and
// `b` (resid) as in seven_point_launch; no slab's `out` may overlap any
// slab's operands. dtype as above.
int seven_point_slabs_launch(int mode, int dtype, int has_diag, int n_slabs,
                             const void* const* table, int nx, int ny, int nz,
                             void* stream) {
  if (n_slabs < 1 || n_slabs > kMaxSlabs || (mode != kApply && mode != kResid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_slabs<float>(mode, has_diag, n_slabs, table, nx, ny, nz, s);
  return launch_slabs<__nv_bfloat16>(mode, has_diag, n_slabs, table, nx, ny,
                                     nz, s);
}

// Apply-dot (mode 2 only) on one shard's (nx, ny, nz) slab, with its halo
// planes as above. The dot is `acc` (the previous shards' dot, f32; null:
// 0) plus this shard's planes over the rows [y0, y1) (0 <= y0 <= y1 <=
// ny; [0, ny) is the whole slab), added in the order the single-grid
// kernel adds them, so a chain of shards gives its dot.
int seven_point_halo_launch(int mode, int dtype, int has_diag, const void* p,
                            const void* h_lo, const void* h_hi,
                            const void* wx_hi, const void* wx, const void* wy,
                            const void* wz, const void* diag, const void* b,
                            void* out, void* partial, void* dot, void* ticket,
                            const void* acc, int nx, int ny, int nz, int y0,
                            int y1, void* stream) {
  if (mode != kApplyDot || y0 < 0 || y0 > y1 || y1 > ny)
    return (int)cudaErrorInvalidValue;
  const void* halo[3] = {h_lo, h_hi, wx_hi};
  return dispatch<true>(mode, dtype, has_diag, p, halo, wx, wy, wz, diag, b,
                        out, partial, dot, ticket, acc, nx, ny, nz, y0, y1,
                        stream);
}

}  // extern "C"
