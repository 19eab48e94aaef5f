// Fused projection epilogue: the velocity correction of the last PIMPLE
// corrector and the divergence error of the corrected field in one pass.
//
// Replaces the TPU kernel openfoam_tpp_tpu/ops/pallas/correction.py
// `correct_divmax` (correction.py:149, pallas_call at :186, body
// `_corr_core` at :48).
//
// Per face: q_c = q − dt·β_f·∂dp/∂n (gradient_at_faces: zero on the
// domain-boundary faces), plus the open-top half-cell Dirichlet term
// dt·β_top·2·dp/hz on w's face-nz row where the top is open, then masked
// to zero where the aperture is 0. u's face-nx row (the sealed +x wall)
// is written as zeros. Per cell: |∇·(A·q_c)| where vfrac > 0, reduced to
// its maximum. dt is read from device memory (a 0-d tensor), so the step
// never waits on the host for it.
//
// What bounds it on the H100: bytes. It reads dp and vfrac (cells), nine
// face arrays (u, v, w, β×3, A×3) and two (nx, ny) planes, and writes
// three face arrays: 79 MB per 112³ call, 23.7 µs at 3.35 TB/s; about 32
// flops per cell. The earlier design (one thread per cell, 69 µs) fetched
// every face array twice (each thread recomputed its three high faces,
// and the x-high face belongs to another x plane, out of L1's reach),
// left half of its last 32-wide z block idle at nz = 112, took nine IEEE
// divisions per cell and finished the maximum in a second launch.
//
// Design: a 2.5-D march along x. A block owns an 8 × 32 (y, z) tile, one
// cell per thread, and walks a chunk of x planes sized so that the
// grid's blocks fill the card once at the kernel's occupancy. (16 × 16
// tiles leave no lane idle at nz = 112, where the last 32-wide z tile is
// half empty, but ran 5% slower: PERF.md §6.) The x face above the cell, with
// its flux A·q, stays in registers as the next plane's low face, and dp
// of the next plane is loaded one plane ahead, so each u, βx, ax and dp
// plane is read once. The y and z faces: each thread corrects its low and
// high face; the high one is its neighbour's low face, read through L1
// (the block's neighbours loaded it in the same instruction or plane).
// The divisions by the spacing are multiplications by the f32 reciprocal
// 1/h formed on the host as PyTorch's CUDA division by a Python scalar
// forms it (in double, rounded to f32), so the outputs are bitwise those
// of correct_divmax_plain on the card; the one division left is 1/ρ on
// the open top row (IEEE, as PyTorch's reciprocal). IEEE divisions by h
// in this march took 59.4 µs against 42.0 (PERF.md §6). The maximum: a
// running maximum per thread over its planes, a shuffle tree per warp,
// one value per block, then a ticket: atomicInc(ticket, nblocks − 1)
// wraps the counter back to 0 by itself, and the block that draws the
// last ticket reduces the blocks' values. One launch per call; a maximum is exact, so the result does
// not depend on the order, and NaN propagates, as in torch.max. The
// ticket counter is one per device (ops/kernels/_build.py `ticket`),
// shared with the other one-launch reductions: calls that share it must
// not overlap, so they run on one stream.
//
// The halo variant (`correction_halo_launch`) replaces the TPU kernel
// correction.py `correct_divmax_h` (correction.py:219), the per-shard
// kernel of the x-sharded step: the same kernel with HALO set. u, βx and
// ax come packed to the slab's cells; the x face above the slab reads
// their exchanged planes (the next shard's first faces; zeros at the
// global end, the sealed wall's true values), and the x gradient at the
// slab's two end faces reads dp's exchanged ±1 planes (the edge plane at
// the global ends, so the gradient there is (dp0 − dp0)/hx = 0). No wall
// row is written; the maximum is the shard's, reduced over the shards by
// the caller. Same bytes plus five planes, same bound, and the same
// arithmetic per face, so the shards composed equal the single-grid
// kernel bitwise. The halo launch takes a row window [y0, y1): only the
// cells of those y rows enter the maximum (every face is corrected). A
// rank of the 2-D x·y decomposition runs it on its block extended by the
// y neighbours' rows (parallel/spmd.py) and passes its own rows; the full
// window [0, ny), what the single grid and the 1-D decomposition pass,
// leaves the maximum as it was.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTZ = 32, kTY = 8, kBlock = kTZ * kTY;
constexpr int kWarps = kBlock / 32;
// Blocks per launch: about kWaves times what the card holds at once at
// the kernel's occupancy (one wave: the most blocks in flight, no tail).
constexpr float kWaves = 1.0f;
// Blocks per SM the register budget is set for (64 registers a thread): a
// march that streams 14 arrays needs warps in flight to keep enough loads
// outstanding (none: 75 registers, 3 blocks, 27% slower).
constexpr int kMinBlocks = 4;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

struct Args {
  const float *dt, *dp, *u, *v, *w, *bx, *by, *bz, *ax, *ay, *az, *vfrac,
      *topo, *rho;
  // HALO: dp's planes x = −1, nx and the faces x = nx of u, βx, ax, each
  // an (ny, nz) plane.
  const float *dp_lo, *dp_hi, *u_hi, *bx_hi, *ax_hi;
  float *ou, *ov, *ow, *partial, *div_max;
  unsigned* ticket;
  int nx, ny, nz, cx;   // cx: x planes per block
  int y0, y1;           // the row window of the maximum
  float hx, hy, hz;     // the spacing
  float rhx, rhy, rhz;  // its f32 reciprocals
};

// A difference over the spacing: d·(1/h), as PyTorch's CUDA division by
// a Python scalar computes it (h: the f32 spacing, for other forms).
__device__ __forceinline__ float over_h(float d, float h, float rh) {
  return d * rh;
}

// One corrected face: q_c = (q − dt·β·g) where the aperture is open, else
// 0; phi = A·q_c.
__device__ __forceinline__ float corr(float q, float beta, float ap, float g,
                                      float dt, float& phi) {
  const float qc = ap > 0.0f ? q - dt * beta * g : 0.0f;
  phi = ap * qc;
  return qc;
}

template <bool OPEN_TOP, bool HALO>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
correct_divmax_kernel(const Args a) {
  __shared__ float wmax[kWarps];
  __shared__ bool last;
  const int t = threadIdx.y * kTZ + threadIdx.x, lane = t & 31, warp = t >> 5;
  const int k = blockIdx.x * kTZ + threadIdx.x;
  const int j = blockIdx.y * kTY + threadIdx.y;
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int i0 = blockIdx.z * a.cx;
  const int i1 = i0 + a.cx < nx ? i0 + a.cx : nx;
  float val = 0.0f;   // the running maximum of this thread's cells
  const bool owned = j >= a.y0 && j < a.y1;
  if (k < nz && j < ny) {
    const float dt = __ldg(a.dt);
    const int64_t sx = (int64_t)ny * nz, sy = nz;
    const int64_t q = (int64_t)j * nz + k;   // the cell's place in a plane
    auto gx = [&](float d) { return over_h(d, a.hx, a.rhx); };
    auto gy = [&](float d) { return over_h(d, a.hy, a.rhy); };
    auto gz = [&](float d) { return over_h(d, a.hz, a.rhz); };
    // x face f of this column (u layout (nx+1, ny, nz); with HALO
    // (nx, ny, nz), face nx in the halo planes) from dp below and above it.
    auto xface = [&](int f, float d0, float d1, float& phi) {
      const float* U = a.u;
      const float* B = a.bx;
      const float* A = a.ax;
      int64_t o = f * sx + q;
      if (HALO && f == nx) {
        U = a.u_hi;
        B = a.bx_hi;
        A = a.ax_hi;
        o = q;
      }
      const float g = (!HALO && (f == 0 || f == nx)) ? 0.0f : gx(d1 - d0);
      return corr(__ldg(U + o), __ldg(B + o), __ldg(A + o), g, dt, phi);
    };
    float dc = __ldg(a.dp + i0 * sx + q);   // dp of the current plane
    float dm = i0 > 0 ? __ldg(a.dp + (i0 - 1) * sx + q)
                      : (HALO ? __ldg(a.dp_lo + q) : dc);
    float px0;   // A·q_c of the plane's low x face
    float qx0 = xface(i0, dm, dc, px0);
    for (int i = i0; i < i1; ++i) {
      const int64_t c = i * sx + q;
      const float dn = i + 1 < nx ? __ldg(a.dp + c + sx)
                                  : (HALO ? __ldg(a.dp_hi + q) : dc);
      float px1;
      const float qx1 = xface(i + 1, dc, dn, px1);
      a.ou[c] = qx0;
      if (!HALO && i == nx - 1) a.ou[c + sx] = 0.0f;   // the sealed +x wall

      // y faces j, j + 1: v layout (nx, ny+1, nz).
      const int64_t oy = ((int64_t)i * (ny + 1) + j) * nz + k;
      const float gy0 = j > 0 ? gy(dc - __ldg(a.dp + c - sy)) : 0.0f;
      const float gy1 = j + 1 < ny ? gy(__ldg(a.dp + c + sy) - dc) : 0.0f;
      float py0, py1;
      const float qy0 = corr(__ldg(a.v + oy), __ldg(a.by + oy),
                             __ldg(a.ay + oy), gy0, dt, py0);
      const float qy1 = corr(__ldg(a.v + oy + nz), __ldg(a.by + oy + nz),
                             __ldg(a.ay + oy + nz), gy1, dt, py1);
      a.ov[oy] = qy0;
      if (j == ny - 1) a.ov[oy + nz] = qy1;

      // z faces k, k + 1: w layout (nx, ny, nz+1); the open-top row at nz.
      const int64_t oz = ((int64_t)i * ny + j) * (nz + 1) + k;
      const float gz0 = k > 0 ? gz(dc - __ldg(a.dp + c - 1)) : 0.0f;
      float pz0, pz1;
      const float qz0 = corr(__ldg(a.w + oz), __ldg(a.bz + oz),
                             __ldg(a.az + oz), gz0, dt, pz0);
      float qz1;
      const float w1 = __ldg(a.w + oz + 1), bz1 = __ldg(a.bz + oz + 1);
      const float az1 = __ldg(a.az + oz + 1);
      if (k + 1 < nz) {
        qz1 = corr(w1, bz1, az1, gz(__ldg(a.dp + c + 1) - dc), dt, pz1);
      } else {
        // The top row: w − dt·β·0 (the boundary face's gradient) plus,
        // where open, the half-cell term; then masked.
        float wq = w1 - dt * bz1 * 0.0f;
        if (OPEN_TOP) {
          const float beta_top = __ldg(a.topo + (int64_t)i * ny + j) > 0.0f
                                     ? 1.0f / __ldg(a.rho + c) : 0.0f;
          wq = wq + gz(dt * beta_top * 2.0f * dc);
        }
        qz1 = az1 > 0.0f ? wq : 0.0f;
        pz1 = az1 * qz1;
        a.ow[oz + 1] = qz1;
      }
      a.ow[oz] = qz0;

      const float div = (gx(px1 - px0) + gy(py1 - py0)) + gz(pz1 - pz0);
      const float fluid = __ldg(a.vfrac + c) > 0.0f ? 1.0f : 0.0f;
      if (owned) val = nan_max(val, fabsf(div) * fluid);
      dc = dn;
      qx0 = qx1;
      px0 = px1;
    }
  }
  // The block's maximum, then the last block's over the blocks.
  val = warp_max(val);
  if (lane == 0) wmax[warp] = val;
  __syncthreads();
  const unsigned nblocks = gridDim.x * gridDim.y * gridDim.z;
  if (t == 0) {
    float m = wmax[0];
    for (int w = 1; w < kWarps; ++w) m = nan_max(m, wmax[w]);
    a.partial[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)] =
        m;
    __threadfence();   // visible before this block's ticket
    last = atomicInc(a.ticket, nblocks - 1) == nblocks - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  float m = 0.0f;
  for (unsigned b = t; b < nblocks; b += kBlock)
    m = nan_max(m, __ldcg(a.partial + b));
  m = warp_max(m);
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  if (t == 0) {
    m = wmax[0];
    for (int w = 1; w < kWarps; ++w) m = nan_max(m, wmax[w]);
    a.div_max[0] = m;
  }
}

// x planes per block for `tiles` (y, z) tiles of an nx-plane grid: the
// fewest that keep the launch within kWaves waves of the current device
// at the kernel's occupancy (asked at every launch: a process may use
// more than one card).
template <typename K>
int chunk_planes(K kernel, int tiles, int nx) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
  int chunks = (int)(kWaves * (float)(sms * per_sm)) / tiles;
  chunks = chunks < 1 ? 1 : (chunks > nx ? nx : chunks);
  return (nx + chunks - 1) / chunks;
}

template <bool OPEN_TOP, bool HALO>
void run(Args& a, cudaStream_t s) {
  const int tiles = ((a.nz + kTZ - 1) / kTZ) * ((a.ny + kTY - 1) / kTY);
  a.cx = chunk_planes(correct_divmax_kernel<OPEN_TOP, HALO>, tiles, a.nx);
  const dim3 grid((a.nz + kTZ - 1) / kTZ, (a.ny + kTY - 1) / kTY,
                  (a.nx + a.cx - 1) / a.cx);
  correct_divmax_kernel<OPEN_TOP, HALO><<<grid, dim3(kTZ, kTY), 0, s>>>(a);
}

// f: dt, dp, u, v, w, bx, by, bz, ax, ay, az, vfrac, topo, rho; halo (HALO
// only): dp_lo, dp_hi, u_hi, bx_hi, ax_hi; out: ou, ov, ow, partial,
// div_max, ticket.
template <bool HALO>
int launch(int open_top, const void* const* f, const void* const* halo,
           void* const* out, int nx, int ny, int nz, int y0, int y1,
           double hx, double hy, double hz, void* stream) {
  auto F = [&](int n) { return static_cast<const float*>(f[n]); };
  Args a = {};
  a.dt = F(0);
  a.dp = F(1);
  a.u = F(2);
  a.v = F(3);
  a.w = F(4);
  a.bx = F(5);
  a.by = F(6);
  a.bz = F(7);
  a.ax = F(8);
  a.ay = F(9);
  a.az = F(10);
  a.vfrac = F(11);
  a.topo = F(12);
  a.rho = F(13);
  if (HALO) {
    a.dp_lo = static_cast<const float*>(halo[0]);
    a.dp_hi = static_cast<const float*>(halo[1]);
    a.u_hi = static_cast<const float*>(halo[2]);
    a.bx_hi = static_cast<const float*>(halo[3]);
    a.ax_hi = static_cast<const float*>(halo[4]);
  }
  a.ou = static_cast<float*>(out[0]);
  a.ov = static_cast<float*>(out[1]);
  a.ow = static_cast<float*>(out[2]);
  a.partial = static_cast<float*>(out[3]);
  a.div_max = static_cast<float*>(out[4]);
  a.ticket = static_cast<unsigned*>(out[5]);
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.y0 = y0;
  a.y1 = y1;
  a.hx = (float)hx;
  a.hy = (float)hy;
  a.hz = (float)hz;
  // The reciprocals as PyTorch's CUDA division by a Python scalar forms
  // them: in double from the scalar, rounded to f32 (not 1.0f / (float)h,
  // which differs in the last bit for some h, such as 0.013).
  a.rhx = (float)(1.0 / hx);
  a.rhy = (float)(1.0 / hy);
  a.rhz = (float)(1.0 / hz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (open_top)
    run<true, HALO>(a, s);
  else
    run<false, HALO>(a, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-block values the maximum needs on an (nx, ny, nz) grid, at most.
int correction_num_partials(int nx, int ny, int nz) {
  return ((nz + kTZ - 1) / kTZ) * ((ny + kTY - 1) / kTY) * nx;
}

// dt: 0-d f32 on the device. dp, vfrac, rho: (nx, ny, nz) cells (only
// rho's top plane is read); u, bx, ax: (nx+1, ny, nz); v, by, ay:
// (nx, ny+1, nz); w, bz, az: (nx, ny, nz+1); topo: (nx, ny), read only
// with open_top; hx, hy, hz the spacing as the caller holds it (double,
// so that 1/h rounds as PyTorch rounds it). Outputs ou, ov, ow on the u,
// v, w grids and div_max[0];
// `partial` holds correction_num_partials floats, `ticket` one unsigned
// counter that is 0 between calls (the launch leaves it so).
int correction_launch(int open_top, const void* dt, const void* dp, const void* u,
                      const void* v, const void* w, const void* bx, const void* by,
                      const void* bz, const void* ax, const void* ay, const void* az,
                      const void* vfrac, const void* topo, const void* rho, void* ou,
                      void* ov, void* ow, void* partial, void* div_max,
                      void* ticket, int nx, int ny, int nz, double hx,
                      double hy, double hz, void* stream) {
  const void* f[14] = {dt, dp, u, v, w, bx, by, bz, ax, ay, az, vfrac, topo, rho};
  void* out[6] = {ou, ov, ow, partial, div_max, ticket};
  return launch<false>(open_top, f, nullptr, out, nx, ny, nz, 0, ny, hx, hy,
                       hz, stream);
}

// The same on one shard's slab of nx cells along x: u, bx, ax and ou packed
// to (nx, ny, nz); dp_lo, dp_hi dp's planes x = −1, nx; u_hi, bx_hi, ax_hi
// the faces x = nx, all (1, ny, nz). div_max is the shard's over the rows
// [y0, y1) (0 <= y0 <= y1 <= ny; [0, ny) is the whole slab).
int correction_halo_launch(int open_top, const void* dt, const void* dp,
                           const void* dp_lo, const void* dp_hi, const void* u,
                           const void* u_hi, const void* v, const void* w,
                           const void* bx, const void* bx_hi, const void* by,
                           const void* bz, const void* ax, const void* ax_hi,
                           const void* ay, const void* az, const void* vfrac,
                           const void* topo, const void* rho, void* ou, void* ov,
                           void* ow, void* partial, void* div_max, void* ticket,
                           int nx, int ny, int nz, int y0, int y1, double hx,
                           double hy, double hz, void* stream) {
  if (y0 < 0 || y0 > y1 || y1 > ny) return (int)cudaErrorInvalidValue;
  const void* f[14] = {dt, dp, u, v, w, bx, by, bz, ax, ay, az, vfrac, topo, rho};
  const void* halo[5] = {dp_lo, dp_hi, u_hi, bx_hi, ax_hi};
  void* out[6] = {ou, ov, ow, partial, div_max, ticket};
  return launch<true>(open_top, f, halo, out, nx, ny, nz, y0, y1, hx, hy, hz,
                      stream);
}

}  // extern "C"
