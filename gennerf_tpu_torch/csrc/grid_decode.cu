// Separable dense-grid TSDF decode: the ResnetFC residual blocks and the
// folded tanh head over every point of an (nx, ny, nz) grid.
//
// Replaces the TPU kernel gennerf_tpu/ops/pallas/fused_decoder.py::_grid_kernel
// (launched by _grid_kernel_call from fused_grid_decode). lin_in and every
// lin_z are applied to per-axis tables outside the kernel (torch, see
// ops/grid_decode.py grid_tables), so per point the kernel only rebuilds
//   x = (q_yz[j,k] + q_xz[i,k]) + q_xy[i,j]
// and, for each block b,
//   x += (z_y[b,j] + z_z[b,k]) + z_x[i,b]
//   x += W1_b relu(W0_b relu(x) + b0_b) + b1_b
// then writes tanh(relu(x) . w_last + b_last) * smoothing. The products take
// bf16 inputs with f32 accumulation; the residual stream and the tables
// stay f32, as on the TPU.
//
// What bounds it on this card: arithmetic. At the predict shape (516,096
// points, H=256, 5 blocks) the H x H products are 6.8e11 FLOP against a few
// MB of tables and output, far above the card's ~295 FLOP/byte balance.
//
// What the design does about it: the products run on the tensor cores
// (WMMA bf16 16x16x16 fragments with f32 accumulators, written here, no
// library GEMM). A block of 8 warps takes a tile of TM = 16384/H
// consecutive grid points (64 at H=256); the tile's residual stream, the
// f32 product output and the bf16 activations stay in shared memory
// (~164 KB), so nothing but the tables, the weights and the (n,) output
// crosses device memory. Unlike the TPU's VMEM, shared memory cannot hold
// the 10 H x H bf16 weight matrices (1.25 MB), so the B fragments are read
// from global memory per tile, where they stay resident in the 50 MB L2.
// Each warp owns H/8 output columns of every row of the tile. Points are
// taken in flat order and the ragged last tile is masked, so any grid
// shape works. This is the simple first version: wgmma, TMA-fed weight
// tiles and persistent blocks are later work.
#include "resnet_tile.cuh"

namespace {

using namespace gennerf;

template <int H>
__global__ void __launch_bounds__(kThreads)
grid_decode_kernel(const float* __restrict__ q_yz, const float* __restrict__ q_xz,
                   const float* __restrict__ q_xy, const float* __restrict__ z_x,
                   const float* __restrict__ z_y, const float* __restrict__ z_z,
                   const bf16* __restrict__ w0, const float* __restrict__ b0,
                   const bf16* __restrict__ w1, const float* __restrict__ b1,
                   const bf16* __restrict__ w_last, float b_last, float smoothing,
                   float* __restrict__ out, int nx, int ny, int nz, int nb) {
  using T = Tile<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);                   // residual stream
  float* sc = reinterpret_cast<float*>(smem + T::X_BYTES);      // product output
  bf16* act = reinterpret_cast<bf16*>(smem + 2 * T::X_BYTES);   // bf16 product input
  int* ri = reinterpret_cast<int*>(act + T::TM * T::LDA);
  int* rj = ri + T::TM;
  int* rk = rj + T::TM;
  int* rv = rk + T::TM;

  const long long n_pts = static_cast<long long>(nx) * ny * nz;
  const long long p0 = static_cast<long long>(blockIdx.x) * T::TM;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  if (t < T::TM) {
    const long long p = p0 + t;
    const int valid = p < n_pts;
    const long long pc = valid ? p : 0;  // masked rows decode point 0, never stored
    const long long ij = pc / nz;
    rk[t] = static_cast<int>(pc - ij * nz);
    rj[t] = static_cast<int>(ij % ny);
    ri[t] = static_cast<int>(ij / ny);
    rv[t] = valid;
  }
  __syncthreads();

  for (int e = t; e < T::TM * H; e += kThreads) {
    const int r = e / H, h = e % H;
    const size_t i = ri[r], j = rj[r], k = rk[r];
    float v = q_yz[(j * nz + k) * H + h] + q_xz[(i * nz + k) * H + h];
    v = v + q_xy[(i * ny + j) * H + h];
    xs[r * T::LDX + h] = v;
  }

  for (int b = 0; b < nb; ++b) {
    __syncthreads();
    for (int e = t; e < T::TM * H; e += kThreads) {
      const int r = e / H, h = e % H;
      const size_t i = ri[r], j = rj[r], k = rk[r];
      float tz = z_y[(static_cast<size_t>(b) * ny + j) * H + h] +
                 z_z[(static_cast<size_t>(b) * nz + k) * H + h];
      tz = tz + z_x[(i * nb + b) * H + h];
      const float xv = xs[r * T::LDX + h] + tz;
      xs[r * T::LDX + h] = xv;
      act[r * T::LDA + h] = __float2bfloat16_rn(fmaxf(xv, 0.0f));
    }
    __syncthreads();
    tile_gemm<H>(act, T::LDA, w0 + static_cast<size_t>(b) * H * H, H, sc, warp);
    __syncthreads();
    for (int e = t; e < T::TM * H; e += kThreads) {
      const int r = e / H, h = e % H;
      const float net = sc[r * T::LDX + h] + b0[b * H + h];
      act[r * T::LDA + h] = __float2bfloat16_rn(fmaxf(net, 0.0f));
    }
    __syncthreads();
    tile_gemm<H>(act, T::LDA, w1 + static_cast<size_t>(b) * H * H, H, sc, warp);
    __syncthreads();
    for (int e = t; e < T::TM * H; e += kThreads) {
      const int r = e / H, h = e % H;
      xs[r * T::LDX + h] = xs[r * T::LDX + h] + (sc[r * T::LDX + h] + b1[b * H + h]);
    }
  }
  __syncthreads();

  tile_head<H>(xs, w_last, b_last, smoothing, out, p0, warp, lane,
               [&](int r) { return rv[r] != 0; });
}

template <int H>
cudaError_t launch(const float* q_yz, const float* q_xz, const float* q_xy, const float* z_x,
                   const float* z_y, const float* z_z, const bf16* w0, const float* b0,
                   const bf16* w1, const float* b1, const bf16* w_last, float b_last,
                   float smoothing, float* out, int nx, int ny, int nz, int nb,
                   cudaStream_t stream) {
  using T = Tile<H>;
  constexpr size_t smem = 2 * T::X_BYTES + T::ACT_BYTES + sizeof(int) * 4 * T::TM;
  cudaError_t err = cudaFuncSetAttribute(grid_decode_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_pts = static_cast<long long>(nx) * ny * nz;
  const long long blocks = (n_pts + T::TM - 1) / T::TM;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grid_decode_kernel<H><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q_yz, q_xz, q_xy, z_x, z_y, z_z, w0, b0, w1, b1, w_last, b_last, smoothing, out, nx, ny,
      nz, nb);
  return cudaGetLastError();
}

}  // namespace

// Tables (f32, contiguous): q_yz (ny*nz, H), q_xz (nx, nz, H), q_xy (nx, ny, H),
// z_x (nx, nb, H), z_y (nb, ny, H), z_z (nb, nz, H). Weights: w0, w1 (nb, H, H)
// bf16 as (in, out); b0, b1 (nb, H) f32; w_last (H,) bf16. out: (nx*ny*nz,) f32.
// H must be 128, 256 or 512. Returns a cudaError_t (0 on success).
extern "C" int gennerf_grid_decode(const void* q_yz, const void* q_xz, const void* q_xy,
                                   const void* z_x, const void* z_y, const void* z_z,
                                   const void* w0, const void* b0, const void* w1,
                                   const void* b1, const void* w_last, float b_last,
                                   float smoothing, void* out, int nx, int ny, int nz, int nb,
                                   int H, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define GENNERF_GRID_ARGS                                                                      \
  static_cast<const float*>(q_yz), static_cast<const float*>(q_xz),                           \
      static_cast<const float*>(q_xy), static_cast<const float*>(z_x),                        \
      static_cast<const float*>(z_y), static_cast<const float*>(z_z),                         \
      static_cast<const bf16*>(w0), static_cast<const float*>(b0),                            \
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),                            \
      static_cast<const bf16*>(w_last), b_last, smoothing, static_cast<float*>(out), nx, ny, \
      nz, nb, static_cast<cudaStream_t>(stream)
  cudaError_t err;
  switch (H) {
    case 128: err = launch<128>(GENNERF_GRID_ARGS); break;
    case 256: err = launch<256>(GENNERF_GRID_ARGS); break;
    case 512: err = launch<512>(GENNERF_GRID_ARGS); break;
    default: err = cudaErrorInvalidValue;
  }
#undef GENNERF_GRID_ARGS
  return static_cast<int>(err);
}
