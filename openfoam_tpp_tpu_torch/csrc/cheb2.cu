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
//
// Each pass chains two applications of Â, so an output cell depends on
// its ±2 neighbourhood. The TPU kernels keep the intermediate in VMEM over
// an x-slab with halo planes. Here each thread owns one output cell and
// recomputes the intermediate (x1) at itself and at its six neighbours from
// the inputs: seven inner neighbour sums, about 50 distinct loads a cell,
// all but the first touch of each line served by L1/L2. Nothing
// intermediate goes to device memory, and every grid shape works: the
// chained sums are exactly two applications of `nb_sum` (low neighbour
// clamped, high-face term zero at the domain edge), with no halo
// bookkeeping.
//
// What bounds it on the H100: by bytes moved (b, x, three weights in, one
// or two arrays out: 12–14 B a cell in the bf16 cycle, 5–6 µs at 112³) the
// bound is memory; the recomputation makes the simple kernel several times
// slower than that. Shared-memory tiling of the intermediate is left for a
// later change. All arithmetic is f32: bf16 operands are widened on load
// and each output is rounded once on store (`post` may store f32 from bf16
// operands: the V-cycle's hand-off to CG).
//
// The dot follows apply_dot_7pt: per-block partials from a fixed-shape
// shared-memory tree, then a one-block pass that sums them in a fixed
// order. No float atomics, so CG's iteration count repeats from run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32, kBY = 8, kBlock = kBX * kBY;
constexpr int kSumBlock = 1024;

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

template <typename T>
struct Grid {
  const T* wx;
  const T* wy;
  const T* wz;
  int nx, ny, nz;
};

// Σ_f w_f·f_nb for cell c = (i, j, k) of a field given as a functor
// f(cell, i, j, k) → f32; the products and add order of seven_point.cu
// `nb_sum`: wl·xm + xh + wy·ym + yh + wz·zm + zh.
template <typename T, typename F>
__device__ __forceinline__ float nb_sum(const Grid<T>& g, const F& f,
                                        int64_t c, int i, int j, int k) {
  const int64_t sx = (int64_t)g.ny * g.nz, sy = g.nz;
  const float xm = i > 0 ? f(c - sx, i - 1, j, k) : f(c, i, j, k);
  const float ym = j > 0 ? f(c - sy, i, j - 1, k) : f(c, i, j, k);
  const float zm = k > 0 ? f(c - 1, i, j, k - 1) : f(c, i, j, k);
  const float xh =
      (i + 1 < g.nx) ? ld(g.wx, c + sx) * f(c + sx, i + 1, j, k) : 0.0f;
  const float yh =
      (j + 1 < g.ny) ? ld(g.wy, c + sy) * f(c + sy, i, j + 1, k) : 0.0f;
  const float zh =
      (k + 1 < g.nz) ? ld(g.wz, c + 1) * f(c + 1, i, j, k + 1) : 0.0f;
  float s = ld(g.wx, c) * xm;
  s = s + xh;
  s = s + ld(g.wy, c) * ym;
  s = s + yh;
  s = s + ld(g.wz, c) * zm;
  s = s + zh;
  return s;
}

// A stored array as a field.
template <typename T>
struct Stored {
  const T* a;
  __device__ __forceinline__ float operator()(int64_t c, int, int, int) const {
    return ld(a, c);
  }
};

// pre's first step: x1 = b·inv_theta.
template <typename T>
struct PreX1 {
  const T* b;
  float inv_theta;
  __device__ __forceinline__ float operator()(int64_t c, int, int, int) const {
    return ld(b, c) * inv_theta;
  }
};

// pre's result x = x1 + (c_pp·x1 + c_pd·(b − Â·x1)) as a field.
template <typename T>
struct PreX {
  Grid<T> g;
  PreX1<T> x1;
  float c_pp, c_pd;
  __device__ __forceinline__ float operator()(int64_t c, int i, int j,
                                              int k) const {
    const float v = x1(c, i, j, k);
    const float d1 = ld(x1.b, c) - (v - nb_sum(g, x1, c, i, j, k));
    return v + (c_pp * v + c_pd * d1);
  }
};

// post's first step: p1 = (b − Â·x)·inv_theta; the field is x1 = x + p1.
template <typename T>
struct PostX1 {
  Grid<T> g;
  Stored<T> x;
  const T* b;
  float inv_theta;
  __device__ __forceinline__ float p1(int64_t c, int i, int j, int k) const {
    const float d1 = ld(b, c) - (ld(x.a, c) - nb_sum(g, x, c, i, j, k));
    return d1 * inv_theta;
  }
  __device__ __forceinline__ float operator()(int64_t c, int i, int j,
                                              int k) const {
    return ld(x.a, c) + p1(c, i, j, k);
  }
};

template <typename TIn, typename TOut, int MODE>
__global__ void __launch_bounds__(kBlock)
cheb2_kernel(const TIn* __restrict__ x, const TIn* __restrict__ b,
             const TIn* __restrict__ wx, const TIn* __restrict__ wy,
             const TIn* __restrict__ wz, TOut* __restrict__ out,
             TIn* __restrict__ out_r, float* __restrict__ partial,
             float inv_theta, float c_pp, float c_pd, int nx, int ny, int nz) {
  const int k = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  const int i = blockIdx.z;
  const int64_t c = ((int64_t)i * ny + j) * nz + k;
  const Grid<TIn> g{wx, wy, wz, nx, ny, nz};
  float dot = 0.0f;
  if (k < nz && j < ny) {
    const float bc = ld(b, c);
    if (MODE == kPre) {
      const PreX<TIn> xf{g, PreX1<TIn>{b, inv_theta}, c_pp, c_pd};
      const float xc = xf(c, i, j, k);
      st(out, c, xc);
      st(out_r, c, bc - (xc - nb_sum(g, xf, c, i, j, k)));
    } else {
      const PostX1<TIn> x1{g, Stored<TIn>{x}, b, inv_theta};
      const float p1 = x1.p1(c, i, j, k);
      const float x1c = ld(x, c) + p1;
      const float d2 = bc - (x1c - nb_sum(g, x1, c, i, j, k));
      const float z = x1c + (c_pp * p1 + c_pd * d2);
      st(out, c, z);
      if (MODE == kPostDot) dot = bc * rounded(TOut(), z);
    }
  }
  if (MODE == kPostDot) {
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

template <typename TIn, typename TOut>
void launch(int mode, const void* x, const void* b, const void* wx,
            const void* wy, const void* wz, void* out, void* out_r,
            float* partial, float* dot, float inv_theta, float c_pp,
            float c_pd, int nx, int ny, int nz, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((nz + kBX - 1) / kBX, (ny + kBY - 1) / kBY, nx);
  const int n_partials = (int)(grid.x * grid.y * grid.z);
  const TIn* X = static_cast<const TIn*>(x);
  const TIn* B = static_cast<const TIn*>(b);
  const TIn* WX = static_cast<const TIn*>(wx);
  const TIn* WY = static_cast<const TIn*>(wy);
  const TIn* WZ = static_cast<const TIn*>(wz);
  TOut* O = static_cast<TOut*>(out);
  TIn* R = static_cast<TIn*>(out_r);
  if (mode == kPre) {
    cheb2_kernel<TIn, TOut, kPre><<<grid, block, 0, stream>>>(
        X, B, WX, WY, WZ, O, R, partial, inv_theta, c_pp, c_pd, nx, ny, nz);
  } else if (mode == kPost) {
    cheb2_kernel<TIn, TOut, kPost><<<grid, block, 0, stream>>>(
        X, B, WX, WY, WZ, O, R, partial, inv_theta, c_pp, c_pd, nx, ny, nz);
  } else {
    cheb2_kernel<TIn, TOut, kPostDot><<<grid, block, 0, stream>>>(
        X, B, WX, WY, WZ, O, R, partial, inv_theta, c_pp, c_pd, nx, ny, nz);
    sum_partials_kernel<<<1, kSumBlock, 0, stream>>>(partial, n_partials, dot);
  }
}

}  // namespace

extern "C" {

// Number of per-block partials post_dot needs on an (nx, ny, nz) grid.
int cheb2_num_partials(int nx, int ny, int nz) {
  return ((nz + kBX - 1) / kBX) * ((ny + kBY - 1) / kBY) * nx;
}

// mode: 0 pre (writes out = x and out_r = r; x is not read), 1 post,
// 2 post+dot. in_dtype/out_dtype: 0 float32, 1 bfloat16; the store type is
// the operands' own or float32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a combination of types it does not take.
int cheb2_launch(int mode, int in_dtype, int out_dtype, const void* x,
                 const void* b, const void* wx, const void* wy,
                 const void* wz, void* out, void* out_r, void* partial,
                 void* dot, float inv_theta, float c_pp, float c_pd, int nx,
                 int ny, int nz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* d = static_cast<float*>(dot);
  if (in_dtype == 0 && out_dtype == 0)
    launch<float, float>(mode, x, b, wx, wy, wz, out, out_r, part, d,
                         inv_theta, c_pp, c_pd, nx, ny, nz, s);
  else if (in_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(mode, x, b, wx, wy, wz, out, out_r,
                                         part, d, inv_theta, c_pp, c_pd, nx,
                                         ny, nz, s);
  else if (in_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(mode, x, b, wx, wy, wz, out, out_r, part, d,
                                 inv_theta, c_pp, c_pd, nx, ny, nz, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
