// Tile machinery shared by the two ResnetFC decode kernels (grid_decode.cu,
// point_decode.cu): one 8-warp block holds a tile of TM = 16384/H points in
// shared memory and runs its products on the tensor cores with WMMA bf16
// 16x16x16 fragments and f32 accumulators (no library GEMM).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace gennerf {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int H>
struct Tile {
  static constexpr int TM = 16384 / H;        // points per block
  static constexpr int LDX = H + 4;           // f32 row stride (padded)
  static constexpr int LDA = H + 8;           // bf16 row stride (padded)
  static constexpr int ROW_FRAGS = TM / 16;
  static constexpr int COL_FRAGS = H / (16 * kWarps);
  static constexpr size_t X_BYTES = sizeof(float) * TM * LDX;
  static constexpr size_t ACT_BYTES = sizeof(bf16) * TM * LDA;
  static_assert(TM <= kThreads, "one thread per tile row computes its indices");
  static_assert(COL_FRAGS >= 1, "H must be a multiple of 128");
};

// out(TM x H, f32, stride LDX) = act(TM x K, bf16, stride lda) @ W(K x H, bf16, row-major).
// K is a multiple of 16 and lda a multiple of 8; each warp owns H/8 output
// columns of every row of the tile. Callers pass K = H (a constant once
// inlined) for the H x H block products and the padded input width for
// the K3 input products.
template <int H>
__device__ __forceinline__ void tile_gemm(const bf16* act, int lda, const bf16* __restrict__ W,
                                          int K, float* out, int warp) {
  using T = Tile<H>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::ROW_FRAGS][T::COL_FRAGS];
#pragma unroll
  for (int r = 0; r < T::ROW_FRAGS; ++r)
#pragma unroll
    for (int c = 0; c < T::COL_FRAGS; ++c) wmma::fill_fragment(acc[r][c], 0.0f);
  const int col0 = warp * (H / kWarps);
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag[T::COL_FRAGS];
#pragma unroll
    for (int c = 0; c < T::COL_FRAGS; ++c)
      wmma::load_matrix_sync(bfrag[c], W + static_cast<size_t>(kk) * H + col0 + c * 16, H);
#pragma unroll
    for (int r = 0; r < T::ROW_FRAGS; ++r) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
      wmma::load_matrix_sync(afrag, act + r * 16 * lda + kk, lda);
#pragma unroll
      for (int c = 0; c < T::COL_FRAGS; ++c) wmma::mma_sync(acc[r][c], afrag, bfrag[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < T::ROW_FRAGS; ++r)
#pragma unroll
    for (int c = 0; c < T::COL_FRAGS; ++c)
      wmma::store_matrix_sync(out + r * 16 * T::LDX + col0 + c * 16, acc[r][c], T::LDX,
                              wmma::mem_row_major);
}

// The folded lin_out . head over the tile's residual stream:
// out[p0 + r] = tanh(bf16(relu(x_r)) . bf16 w_last + b_last) * smoothing,
// f32 sums, one warp per row; rows with valid(r) false are not stored.
template <int H, typename Valid>
__device__ __forceinline__ void tile_head(const float* xs, const bf16* __restrict__ w_last,
                                          float b_last, float smoothing, float* __restrict__ out,
                                          long long p0, int warp, int lane, Valid valid) {
  using T = Tile<H>;
  for (int r = warp; r < T::TM; r += kWarps) {
    float s = 0.0f;
    for (int h = lane; h < H; h += 32) {
      const float a = __bfloat162float(__float2bfloat16_rn(fmaxf(xs[r * T::LDX + h], 0.0f)));
      s += a * __bfloat162float(w_last[h]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0 && valid(r)) out[p0 + r] = tanhf(s + b_last) * smoothing;
  }
}

}  // namespace gennerf
