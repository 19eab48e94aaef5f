// Fused degree-2 Chebyshev smoothing on the unit-diagonal 7-point operator
// Â (face-lite layout, see seven_point.cu).
//
// Replaces the TPU kernels in openfoam_tpp_tpu/ops/pallas/seven_point.py:
//   cheb2_pre_7pt      (seven_point.py:500, body _kernel_cheb2_pre :377)
//       x = two Chebyshev steps on Â·x = b from x ≡ 0, and r = b − Â·x
//   cheb2_post_7pt     (seven_point.py:523, body _kernel_cheb2_post :406)
//       z = two Chebyshev steps continuing from x
//   cheb2_post_dot_7pt (seven_point.py:548, body _kernel_cheb2_post_dot :437)
//       the same z, plus Σ b·z in f32
// With inv_theta, c_pp, c_pd from ops/kernels/seven_point.py `cheb_coefs`:
//   pre :  x1 = b·inv_theta;  d1 = b − Â·x1;  x = x1 + (c_pp·x1 + c_pd·d1);
//          r = b − Â·x
//   post:  d1 = b − Â·x;  p1 = d1·inv_theta;  x1 = x + p1;  d2 = b − Â·x1;
//          z = x1 + (c_pp·p1 + c_pd·d2)
// Each pass chains two applications of Â, so an output cell depends on its
// ±2 neighbourhood, through an intermediate field (pre's x, post's x1).
//
// What bounds it on the H100: by bytes moved (b, x, three weights in, one
// or two arrays out: 16.9 MB per 112³ bf16 call, 19.7 MB with post's f32
// store, 5.0–5.9 µs at 3.35 TB/s) the bound is memory. The earlier design
// (one thread per output cell, 42–52 µs) recomputed the intermediate at
// the cell and at its six neighbours, each from a full neighbour sum:
// about 50 loads and 8× one apply's arithmetic per cell, bound by load
// issue. This one takes 20.7 µs (pre) and 24.1 (post-dot) at 112³, 4.1×
// the bound; staging the inputs by cp.async into a ring of planes read
// 44.4 / 51.2 µs, and loading the y/z taps one plane ahead 25.6 / 30.5
// (PERF.md §6).
//
// Design: a 2.5-D march along x with the intermediate computed once per
// cell. A block of 32 × 16 threads covers a (z, y) tile of 30 × 14 output
// cells and a one-cell ring around it, one cell per thread, and walks a
// chunk of x planes (the plane below the chunk and the one above it are
// computed again by the neighbouring chunks). Per plane each thread
// forms the intermediate of its cell in f32 (the first sum, with its own
// column's field at x − 1, x, x + 1 and wx at x, x + 1 in registers, the
// next plane's loaded one plane ahead, and the y and z taps read through
// L1, where the neighbouring threads loaded them) and writes it to a ring
// of three planes in shared memory; after one barrier the tile's threads
// apply Â a second time, with the y and z neighbours' intermediates from
// shared memory and the x neighbours' from their own registers, and the
// weights, b and post's p1 kept from the first sum. The intermediate is
// never rounded, and both sums keep `nb_sum`'s products and add order
// (wl·xm + xh + wy·ym + yh + wz·zm + zh, low neighbour clamped, high-face
// term zero at the domain edge), so every output is bitwise that of the
// plain version's f32 arithmetic rounded once on store (bf16 operands are
// widened exactly on load).
//
// The dot follows apply_dot_7pt (seven_point.cu): per x plane each warp
// sums its cells' b·z with a fixed shuffle tree and, after the march, one
// thread per plane adds the block's warp sums in a fixed tree into
// partial[plane · tiles + tile]; the block that draws the last ticket
// (atomicInc(ticket, nblocks − 1), which wraps back to 0 by itself) sums
// each plane's tiles in a fixed tree and the planes in order. One launch
// per call, no float atomics: the dot repeats bitwise from run to run.
// The ticket counter is one per device (ops/kernels/_build.py `ticket`):
// calls that share it run on one stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// A block is kTZ × kTY threads, one cell each: the output tile and a
// one-cell ring around it (kOZ × kOY outputs).
constexpr int kTZ = 32, kTY = 16;
constexpr int kOZ = kTZ - 2, kOY = kTY - 2;
constexpr int kBlock = kTZ * kTY;
constexpr int kWarps = kBlock / 32;
// Blocks per launch: about kWaves times what the card holds at once at
// the kernel's occupancy.
constexpr float kWaves = 1.0f;
constexpr int kMaxCX = 16;   // x planes per block, at most
constexpr int kPerWarp = 8;   // planes per warp per batch of the final sum
constexpr int kPlanes = kWarps * kPerWarp;

enum Mode { kPre = 0, kPost = 1, kPostDot = 2 };

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

// The shuffle tree over the 32 lanes of a warp: lane 0 ends with the sum.
__device__ __forceinline__ float warp_tree(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// A fixed pairwise tree over n = 2^p values.
template <int N>
__device__ __forceinline__ float tree(const float* r) {
  if constexpr (N == 1) {
    return r[0];
  } else {
    return tree<N / 2>(r) + tree<N / 2>(r + N / 2);
  }
}

template <typename TIn, typename TOut>
struct Args {
  const TIn *x, *b, *wx, *wy, *wz;
  TOut* out;
  TIn* out_r;
  float* partial;
  float* dot;
  unsigned* ticket;
  float inv_theta, c_pp, c_pd;
  int nx, ny, nz, cx;   // cx: x planes per block
};

// The three weights a cell's sum reads beside its own wx: the high x, y
// and z ones (zero where the face is the domain's edge).
struct Weights {
  float wx, wxh, wy, wyh, wz, wzh;
};

template <typename TIn, typename TOut, int MODE>
__global__ void __launch_bounds__(kBlock) cheb2_kernel(const Args<TIn, TOut> a) {
  __shared__ float xi[3][kTY][kTZ];          // the intermediate, per plane
  __shared__ float rows[kMaxCX][kWarps];     // the dot's warp sums
  __shared__ float planes[kPlanes];
  __shared__ bool last;
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTZ + tz, lane = tid & 31, warp = tid >> 5;
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int j = blockIdx.y * kOY - 1 + ty, k = blockIdx.x * kOZ - 1 + tz;
  const bool in = j >= 0 && j < ny && k >= 0 && k < nz;
  const bool out = in && ty >= 1 && ty <= kOY && tz >= 1 && tz <= kOZ;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.x + gridDim.x * blockIdx.y;
  const int i0 = blockIdx.z * a.cx;
  const int i1 = i0 + a.cx < nx ? i0 + a.cx : nx;
  // Intermediate planes lo … hi.
  const int lo = i0 > 0 ? i0 - 1 : 0;
  const int hi = i1 < nx ? i1 : nx - 1;
  const float th = a.inv_theta, c_pp = a.c_pp, c_pd = a.c_pd;
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  const int64_t q = (int64_t)(in ? j : 0) * nz + (in ? k : 0);
  const TIn* fsrc = MODE == kPre ? a.b : a.x;
  // The first sum's field: pre's x1 = b·inv_theta, post's x.
  auto F = [&](int64_t c) {
    const float v = ld(fsrc, c);
    return MODE == kPre ? v * th : v;
  };

  // This column's field at planes m − 1, m, m + 1 and wx at m, m + 1; the
  // next plane's loaded one plane ahead.
  float fm = 0.0f, fc = 0.0f, fp = 0.0f, wxc = 0.0f, wxp = 0.0f;
  if (in) {
    fc = F(lo * sx + q);
    fm = lo > 0 ? F((lo - 1) * sx + q) : fc;
    wxc = ld(a.wx, lo * sx + q);
    if (lo + 1 < nx) {
      fp = F((lo + 1) * sx + q);
      wxp = ld(a.wx, (lo + 1) * sx + q);
    }
  }
  // The intermediate of this column at the output plane and the planes
  // below and above it; the output plane's weights, b and p1.
  float xm = 0.0f, xc = 0.0f;
  Weights wo = {};
  float bo = 0.0f, p1o = 0.0f;
  for (int m = lo; m <= i1; ++m) {
    float v = 0.0f, p1 = 0.0f, bc = 0.0f;
    Weights w = {};
    if (m <= hi && in) {
      const int64_t c = m * sx + q;
      float fn = 0.0f, wxn = 0.0f;
      if (m + 2 < nx && m + 1 <= hi) {
        fn = F(c + 2 * sx);
        wxn = ld(a.wx, c + 2 * sx);
      }
      w.wx = wxc;
      w.wxh = m + 1 < nx ? wxp : 0.0f;
      w.wy = ld(a.wy, c);
      w.wz = ld(a.wz, c);
      const float ym = j > 0 ? F(c - sy) : fc;
      const float zm = k > 0 ? F(c - 1) : fc;
      float yh = 0.0f, zh = 0.0f;
      if (j + 1 < ny) {
        w.wyh = ld(a.wy, c + sy);
        yh = w.wyh * F(c + sy);
      }
      if (k + 1 < nz) {
        w.wzh = ld(a.wz, c + 1);
        zh = w.wzh * F(c + 1);
      }
      float nb = w.wx * fm;
      nb = nb + w.wxh * fp;
      nb = nb + w.wy * ym;
      nb = nb + yh;
      nb = nb + w.wz * zm;
      nb = nb + zh;
      if (MODE == kPre) {
        bc = ld(a.b, c);
        const float d1 = bc - (fc - nb);
        v = fc + (c_pp * fc + c_pd * d1);
      } else {
        bc = ld(a.b, c);
        const float d1 = bc - (fc - nb);
        p1 = d1 * th;
        v = fc + p1;
      }
      fm = fc;
      fc = fp;
      fp = fn;
      wxc = wxp;
      wxp = wxn;
    }
    if (m <= hi) xi[m % 3][ty][tz] = v;
    __syncthreads();   // the intermediate of plane m is complete

    const int i = m - 1;   // the output plane
    if (i >= i0) {
      float d = 0.0f;
      if (out) {
        const float (*X)[kTZ] = xi[i % 3];
        const float xl = i > 0 ? xm : xc;
        const float yl = j > 0 ? X[ty - 1][tz] : xc;
        const float zl = k > 0 ? X[ty][tz - 1] : xc;
        // The high faces' weights are zero at the domain's edge.
        float nb = wo.wx * xl;
        nb = nb + (i + 1 < nx ? wo.wxh * v : 0.0f);
        nb = nb + wo.wy * yl;
        nb = nb + (j + 1 < ny ? wo.wyh * X[ty + 1][tz] : 0.0f);
        nb = nb + wo.wz * zl;
        nb = nb + (k + 1 < nz ? wo.wzh * X[ty][tz + 1] : 0.0f);
        const int64_t c = i * sx + q;
        if (MODE == kPre) {
          st(a.out, c, xc);
          st(a.out_r, c, bo - (xc - nb));
        } else {
          const float d2 = bo - (xc - nb);
          const float z = xc + (c_pp * p1o + c_pd * d2);
          st(a.out, c, z);
          if (MODE == kPostDot) d = bo * rounded(TOut(), z);
        }
      }
      if (MODE == kPostDot) {
        d = warp_tree(d);
        if (lane == 0) rows[i - i0][warp] = d;
      }
    }
    xm = xc;
    xc = v;
    wo = w;
    bo = bc;
    p1o = p1;
  }
  if (MODE != kPostDot) return;

  // The dot: per plane the block's warp sums in a fixed tree, then the
  // block that draws the last ticket sums them.
  __syncthreads();
  if (tid < i1 - i0) {
    a.partial[(int64_t)(i0 + tid) * tiles + tile] = tree<kWarps>(rows[tid]);
    __threadfence();   // visible before this block's ticket
  }
  __syncthreads();
  const unsigned nblocks = gridDim.x * gridDim.y * gridDim.z;
  if (tid == 0) {
    last = atomicInc(a.ticket, nblocks - 1) == nblocks - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // Every partial is written. Per batch of kPlanes planes, warp w takes
  // planes w, w + kWarps, … with all their loads issued together.
  float run = 0.0f;
  for (int b0 = 0; b0 < nx; b0 += kPlanes) {
    const int nb = nx - b0 < kPlanes ? nx - b0 : kPlanes;
    float ls[kPerWarp];
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) ls[u] = 0.0f;
    for (int t = lane; t < tiles; t += 32) {
#pragma unroll
      for (int u = 0; u < kPerWarp; ++u) {
        const int pl = warp + kWarps * u;
        if (pl < nb)
          ls[u] = ls[u] + __ldcg(a.partial + (int64_t)(b0 + pl) * tiles + t);
      }
    }
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      const float e = warp_tree(ls[u]);
      if (lane == 0) planes[warp + kWarps * u] = e;
    }
    __syncthreads();
    if (tid == 0)
      for (int pl = 0; pl < nb; ++pl) run = run + planes[pl];
    __syncthreads();   // the batch is read before the next overwrites it
  }
  if (tid == 0) a.dot[0] = run;
}

// x planes per block for `tiles` (y, z) tiles of an nx-plane grid: the
// fewest that keep the launch within kWaves waves of the current device
// at the kernel's occupancy (asked at every launch: a process may use
// more than one card), at most kMaxCX.
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

template <typename TIn, typename TOut, int MODE>
int run(Args<TIn, TOut> a, cudaStream_t stream) {
  auto kernel = cheb2_kernel<TIn, TOut, MODE>;
  const int tiles = ((a.nz + kOZ - 1) / kOZ) * ((a.ny + kOY - 1) / kOY);
  a.cx = chunk_planes(kernel, tiles, a.nx);
  const dim3 grid((a.nz + kOZ - 1) / kOZ, (a.ny + kOY - 1) / kOY,
                  (a.nx + a.cx - 1) / a.cx);
  kernel<<<grid, dim3(kTZ, kTY), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch(int mode, const void* x, const void* b, const void* wx,
           const void* wy, const void* wz, void* out, void* out_r,
           void* partial, void* dot, void* ticket, float inv_theta,
           float c_pp, float c_pd, int nx, int ny, int nz,
           cudaStream_t stream) {
  Args<TIn, TOut> a = {};
  a.x = static_cast<const TIn*>(x);
  a.b = static_cast<const TIn*>(b);
  a.wx = static_cast<const TIn*>(wx);
  a.wy = static_cast<const TIn*>(wy);
  a.wz = static_cast<const TIn*>(wz);
  a.out = static_cast<TOut*>(out);
  a.out_r = static_cast<TIn*>(out_r);
  a.partial = static_cast<float*>(partial);
  a.dot = static_cast<float*>(dot);
  a.ticket = static_cast<unsigned*>(ticket);
  a.inv_theta = inv_theta;
  a.c_pp = c_pp;
  a.c_pd = c_pd;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  if (mode == kPre) return run<TIn, TOut, kPre>(a, stream);
  if (mode == kPost) return run<TIn, TOut, kPost>(a, stream);
  return run<TIn, TOut, kPostDot>(a, stream);
}

}  // namespace

extern "C" {

// Per-(plane, tile) partials post_dot needs on an (nx, ny, nz) grid.
int cheb2_num_partials(int nx, int ny, int nz) {
  return ((nz + kOZ - 1) / kOZ) * ((ny + kOY - 1) / kOY) * nx;
}

// mode: 0 pre (writes out = x and out_r = r; x is not read), 1 post,
// 2 post+dot (partial: cheb2_num_partials floats; ticket: one unsigned
// counter that is 0 between calls, and the launch leaves it so).
// in_dtype/out_dtype: 0 float32, 1 bfloat16; the store type is the
// operands' own or float32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a combination of types it does not take.
int cheb2_launch(int mode, int in_dtype, int out_dtype, const void* x,
                 const void* b, const void* wx, const void* wy,
                 const void* wz, void* out, void* out_r, void* partial,
                 void* dot, void* ticket, float inv_theta, float c_pp,
                 float c_pd, int nx, int ny, int nz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(mode, x, b, wx, wy, wz, out, out_r, partial,
                                dot, ticket, inv_theta, c_pp, c_pd, nx, ny,
                                nz, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        mode, x, b, wx, wy, wz, out, out_r, partial, dot, ticket, inv_theta,
        c_pp, c_pd, nx, ny, nz, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(mode, x, b, wx, wy, wz, out, out_r,
                                        partial, dot, ticket, inv_theta, c_pp,
                                        c_pd, nx, ny, nz, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
