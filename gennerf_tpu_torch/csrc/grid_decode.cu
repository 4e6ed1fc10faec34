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
// What the design does about it: the tile machinery of resnet_tile.cuh. A
// block takes R consecutive grid points (128 at H <= 256), points in flat
// order with the ragged last tile masked, so any grid shape works. Its two
// consumer warpgroups run the H x H products with wgmma from shared memory
// while the producer streams w0_b, w1_b through the bulk-copy ring; the
// residual stream stays in registers. The table sums run in the
// epilogues: each thread rebuilds the residual stream of its two rows from
// the q tables at the start, and adds block b + 1's lin_z injection in the
// epilogue of block b's second product, just before rounding relu(x) into
// the A buffer of block b + 1's first product; the tables stay in L1/L2.
#include "resnet_tile.cuh"

namespace {

using namespace gennerf;

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
grid_decode_kernel(const float* __restrict__ q_yz, const float* __restrict__ q_xz,
                   const float* __restrict__ q_xy, const float* __restrict__ z_x,
                   const float* __restrict__ z_y, const float* __restrict__ z_z,
                   const bf16* __restrict__ slabs, const float* __restrict__ b0,
                   const float* __restrict__ b1, const bf16* __restrict__ w_last, float b_last,
                   float smoothing, float* __restrict__ out, int nx, int ny, int nz, int nb,
                   int n_pts) {
  using T = Tile<H>;
  extern __shared__ __align__(1024) unsigned char smem[];
  Ring ring(smem);
  if (threadIdx.x == 0) ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= kConsumers * 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) produce<H>(ring, slabs, 2 * nb, [](int) { return H; });
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const Frag<H> f(threadIdx.x);
  unsigned char* a1 = smem + T::A1_OFF;  // bf16 relu(x): the first product's A
  unsigned char* a2 = smem + T::A2_OFF;  // bf16 relu(net): the second product's A
  float* partial = reinterpret_cast<float*>(smem + 16 * kStages);
  int* pos = reinterpret_cast<int*>(smem + T::END);  // (R, 3): i, j, k of each tile row
  const int p0 = blockIdx.x * T::R;

  // grid position of the thread's two rows, kept in shared memory for the
  // injections (registers hold the residual stream); masked rows decode
  // point 0 and are never stored
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = f.row(rr), p = p0 + r;
    const int pc = p < n_pts ? p : 0;
    const int ij = pc / nz;
    if ((f.lane & 3) == 0) {
      pos[3 * r] = ij / ny;
      pos[3 * r + 1] = ij % ny;
      pos[3 * r + 2] = pc - ij * nz;
    }
  }
  __syncwarp();

  float x[T::XR];
  // x += block b's lin_z injection on chunk c's columns, then a1 = bf16 relu(x)
  auto inject = [&](int b, auto c) {
    int zx_r[2], zy_r[2], zz_r[2];  // row offsets, from one read of the indices
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int* ijk = pos + 3 * f.row(rr);
      zx_r[rr] = (ijk[0] * nb + b) * H;
      zy_r[rr] = (b * ny + ijk[1]) * H;
      zz_r[rr] = (b * nz + ijk[2]) * H;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f.col(c, j);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float2 zy = ldg2(z_y + zy_r[rr] + col);
        const float2 zz = ldg2(z_z + zz_r[rr] + col);
        const float2 zx = ldg2(z_x + zx_r[rr] + col);
        const int i = c * 32 + 4 * j + 2 * rr;
        x[i] = x[i] + ((zy.x + zz.x) + zx.x);
        x[i + 1] = x[i + 1] + ((zy.y + zz.y) + zx.y);
        f.store_pair(a1, c, j, rr, fmaxf(x[i], 0.0f), fmaxf(x[i + 1], 0.0f));
      }
    }
  };

  static_for<T::CHUNKS>([&](auto c) {
    int yz_r[2], xz_r[2], xy_r[2];  // row offsets
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int* ijk = pos + 3 * f.row(rr);
      yz_r[rr] = (ijk[1] * nz + ijk[2]) * H;
      xz_r[rr] = (ijk[0] * nz + ijk[2]) * H;
      xy_r[rr] = (ijk[0] * ny + ijk[1]) * H;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f.col(c, j);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float2 yz = ldg2(q_yz + yz_r[rr] + col);
        const float2 xz = ldg2(q_xz + xz_r[rr] + col);
        const float2 xy = ldg2(q_xy + xy_r[rr] + col);
        const int i = c * 32 + 4 * j + 2 * rr;
        x[i] = (yz.x + xz.x) + xy.x;
        x[i + 1] = (yz.y + xz.y) + xy.y;
      }
    }
    inject(0, c);
  });
  sync_activations<H>(f.wg);

  for (int b = 0; b < nb; ++b) {
    const float* b0b = b0 + static_cast<size_t>(b) * H;
    const float* b1b = b1 + static_cast<size_t>(b) * H;
    tile_product<H>(ring, f, smem_u32(a1), H, [&](auto c, float(&acc)[32]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias = ldg2(b0b + f.col(c, j));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr;
          f.store_pair(a2, c, j, rr, fmaxf(acc[i] + bias.x, 0.0f), fmaxf(acc[i + 1] + bias.y, 0.0f));
        }
      }
    });
    sync_activations<H>(f.wg);
    tile_product<H>(ring, f, smem_u32(a2), H, [&](auto c, float(&acc)[32]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias = ldg2(b1b + f.col(c, j));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr;
          x[c * 32 + i] = x[c * 32 + i] + (acc[i] + bias.x);
          x[c * 32 + i + 1] = x[c * 32 + i + 1] + (acc[i + 1] + bias.y);
        }
      }
      if (b + 1 < nb) inject(b + 1, c);
    });
    if (b + 1 < nb) sync_activations<H>(f.wg);
  }

  tile_head<H>(f, x, w_last, b_last, smoothing, partial, out, p0,
               [&](int r) { return p0 + r < n_pts; });
}

template <int H>
cudaError_t launch(const float* q_yz, const float* q_xz, const float* q_xy, const float* z_x,
                   const float* z_y, const float* z_z, const bf16* slabs, const float* b0,
                   const float* b1, const bf16* w_last, float b_last, float smoothing, float* out,
                   int nx, int ny, int nz, int nb, cudaStream_t stream) {
  using T = Tile<H>;
  constexpr int smem = T::END + T::R * 3 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(grid_decode_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // point indices and table offsets are 32-bit
  const long long n_pts = static_cast<long long>(nx) * ny * nz;
  if (n_pts > 0x7fffffffLL - T::R) return cudaErrorInvalidValue;
  const long long table_rows[] = {1LL * ny * nz, 1LL * nx * nz, 1LL * nx * ny,
                                  1LL * nx * nb, 1LL * nb * ny, 1LL * nb * nz};
  for (long long rows : table_rows)
    if (rows * H > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((n_pts + T::R - 1) / T::R);
  grid_decode_kernel<H><<<blocks, kThreads, smem, stream>>>(
      q_yz, q_xz, q_xy, z_x, z_y, z_z, slabs, b0, b1, w_last, b_last, smoothing, out, nx, ny, nz,
      nb, static_cast<int>(n_pts));
  return cudaGetLastError();
}

}  // namespace

// Tables (f32, contiguous): q_yz (ny*nz, H), q_xz (nx, nz, H), q_xy (nx, ny, H),
// z_x (nx, nb, H), z_y (nb, ny, H), z_z (nb, nz, H). slabs: bf16, w0_0, w1_0,
// w0_1, ... each packed as its bulk-copy slabs (ops/weight_slabs.py);
// b0, b1 (nb, H) f32; w_last (H,) bf16. out: (nx*ny*nz,) f32. Points and
// table elements each fewer than 2^31. H must be 128, 256 or 512. Returns a
// cudaError_t (0 on success).
extern "C" int gennerf_grid_decode(const void* q_yz, const void* q_xz, const void* q_xy,
                                   const void* z_x, const void* z_y, const void* z_z,
                                   const void* slabs, const void* b0, const void* b1,
                                   const void* w_last, float b_last, float smoothing, void* out,
                                   int nx, int ny, int nz, int nb, int H, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define GENNERF_GRID_ARGS                                                                      \
  static_cast<const float*>(q_yz), static_cast<const float*>(q_xz),                           \
      static_cast<const float*>(q_xy), static_cast<const float*>(z_x),                        \
      static_cast<const float*>(z_y), static_cast<const float*>(z_z),                         \
      static_cast<const bf16*>(slabs), static_cast<const float*>(b0),                         \
      static_cast<const float*>(b1), static_cast<const bf16*>(w_last), b_last, smoothing,    \
      static_cast<float*>(out), nx, ny, nz, nb, static_cast<cudaStream_t>(stream)
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
