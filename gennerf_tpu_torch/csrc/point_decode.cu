// Arbitrary-point TSDF decode (K3): the whole ResnetFC and the folded tanh
// head over N independent points, given each point's triplane feature and
// positional code.
//
// Replaces the TPU kernel gennerf_tpu/ops/pallas/fused_decoder.py::_kernel
// (fused_decoder.py:53; body _mlp_tail -> _blocks_and_head, launched by
// _fused_resnetfc_tsdf_jit through fused_resnetfc_tsdf). Per point:
//   x = feat @ w_in + b_in
//   for each block b:
//     x += alpha * (code @ wz_b + bz_b)
//     x += relu(relu(x) @ w0_b + b0_b) @ w1_b + b1_b
//   out = tanh(relu(x) . w_last + b_last) * smoothing
// Every product takes bf16 inputs with f32 accumulation; feat and code are
// rounded to bf16 once, as the TPU wrapper casts them; the residual stream
// stays f32. Forward only.
//
// What bounds it on this card: arithmetic. At the renderer's width (d_in 32,
// d_code 39, H 256, 5 blocks) a point costs 1,427,456 FLOP against ~290
// bytes of f32 inputs and output, about 4,900 FLOP per byte, far above the
// card's ~295.
//
// What the design does about it: the products run on the tensor cores
// through the tile machinery K2 uses (resnet_tile.cuh: WMMA bf16 fragments,
// 8 warps, a tile of TM = 16384/H points per block, 64 at H = 256, taken in
// flat order with the ragged tail masked). The block stages its points'
// feat rows into the bf16 activation buffer (they are needed only for
// lin_in) and its code rows into their own buffer, where they stay for
// every block's lin_z product; both are zero-padded to the product depth,
// a multiple of 16. Residual stream, product output, activations and code
// tile sit in 174,080 bytes of shared memory at H = 256, so only the inputs,
// the weights and the (N,) output cross device memory. The weight
// fragments are read from L2 per tile, as in K2. The triplane gather and
// the positional code stay outside (torch ops, as XLA computed them for
// the TPU kernel). wgmma, TMA-staged weights and the in-kernel gather are
// later work.
#include "resnet_tile.cuh"

namespace {

using namespace gennerf;

template <int H>
__global__ void __launch_bounds__(kThreads)
point_decode_kernel(const float* __restrict__ feat, const float* __restrict__ code, long long n,
                    int d_in, int d_in_p, int d_code, int d_code_p,
                    const bf16* __restrict__ w_in, const float* __restrict__ b_in,
                    const bf16* __restrict__ wz, const float* __restrict__ bz,
                    const bf16* __restrict__ w0, const float* __restrict__ b0,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w_last, float alpha, float b_last, float smoothing,
                    float* __restrict__ out, int nb) {
  using T = Tile<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);                   // residual stream
  float* sc = reinterpret_cast<float*>(smem + T::X_BYTES);      // product output
  bf16* act = reinterpret_cast<bf16*>(smem + 2 * T::X_BYTES);   // bf16 product input
  bf16* cs = reinterpret_cast<bf16*>(smem + 2 * T::X_BYTES + T::ACT_BYTES);  // code tile
  const int ldc = d_code_p + 8;

  const long long p0 = static_cast<long long>(blockIdx.x) * T::TM;
  const long long left = n - p0;
  const int rows = left < T::TM ? static_cast<int>(left) : T::TM;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  // stage the tile's inputs, each value rounded once to bf16; padded columns
  // and masked rows are 0 (masked rows are never stored)
  for (int e = t; e < T::TM * d_in_p; e += kThreads) {
    const int r = e / d_in_p, c = e - r * d_in_p;
    const float v = (r < rows && c < d_in) ? feat[(p0 + r) * d_in + c] : 0.0f;
    act[r * T::LDA + c] = __float2bfloat16_rn(v);
  }
  for (int e = t; e < T::TM * d_code_p; e += kThreads) {
    const int r = e / d_code_p, c = e - r * d_code_p;
    const float v = (r < rows && c < d_code) ? code[(p0 + r) * d_code + c] : 0.0f;
    cs[r * ldc + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  tile_gemm<H>(act, T::LDA, w_in, d_in_p, xs, warp);
  __syncthreads();
  for (int e = t; e < T::TM * H; e += kThreads) {
    const int r = e / H, h = e % H;
    xs[r * T::LDX + h] = xs[r * T::LDX + h] + b_in[h];
  }

  for (int b = 0; b < nb; ++b) {
    __syncthreads();
    tile_gemm<H>(cs, ldc, wz + static_cast<size_t>(b) * d_code_p * H, d_code_p, sc, warp);
    __syncthreads();
    for (int e = t; e < T::TM * H; e += kThreads) {
      const int r = e / H, h = e % H;
      const float xv = xs[r * T::LDX + h] + alpha * (sc[r * T::LDX + h] + bz[b * H + h]);
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
               [&](int r) { return r < rows; });
}

template <int H>
cudaError_t launch(const float* feat, const float* code, long long n, int d_in, int d_in_p,
                   int d_code, int d_code_p, const bf16* w_in, const float* b_in, const bf16* wz,
                   const float* bz, const bf16* w0, const float* b0, const bf16* w1,
                   const float* b1, const bf16* w_last, float alpha, float b_last,
                   float smoothing, float* out, int nb, cudaStream_t stream) {
  using T = Tile<H>;
  // the feat rows are staged in the activation buffer
  if (d_in_p > H) return cudaErrorInvalidValue;
  const size_t smem = 2 * T::X_BYTES + T::ACT_BYTES + sizeof(bf16) * T::TM * (d_code_p + 8);
  cudaError_t err = cudaFuncSetAttribute(point_decode_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + T::TM - 1) / T::TM;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  point_decode_kernel<H><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      feat, code, n, d_in, d_in_p, d_code, d_code_p, w_in, b_in, wz, bz, w0, b0, w1, b1, w_last,
      alpha, b_last, smoothing, out, nb);
  return cudaGetLastError();
}

}  // namespace

// feat (n, d_in) and code (n, d_code) f32, contiguous. Weights: w_in
// (d_in_p, H) and wz (nb, d_code_p, H) bf16 as (in, out), zero rows past
// d_in / d_code; w0, w1 (nb, H, H) bf16; b_in (H,), bz, b0, b1 (nb, H) f32;
// w_last (H,) bf16. d_in_p and d_code_p are multiples of 16, at most 128.
// out: (n,) f32. H must be 128, 256 or 512. Returns a cudaError_t (0 on
// success).
extern "C" int gennerf_point_decode(const void* feat, const void* code, long long n, int d_in,
                                    int d_in_p, int d_code, int d_code_p, const void* w_in,
                                    const void* b_in, const void* wz, const void* bz,
                                    const void* w0, const void* b0, const void* w1,
                                    const void* b1, const void* w_last, float alpha,
                                    float b_last, float smoothing, void* out, int nb, int H,
                                    void* stream) {
  if (n <= 0 || nb <= 0 || d_in <= 0 || d_code <= 0 || d_in > d_in_p || d_code > d_code_p ||
      d_in_p % 16 || d_code_p % 16 || d_in_p > 128 || d_code_p > 128)
    return static_cast<int>(cudaErrorInvalidValue);
#define GENNERF_POINT_ARGS                                                                     \
  static_cast<const float*>(feat), static_cast<const float*>(code), n, d_in, d_in_p, d_code,  \
      d_code_p, static_cast<const bf16*>(w_in), static_cast<const float*>(b_in),              \
      static_cast<const bf16*>(wz), static_cast<const float*>(bz),                            \
      static_cast<const bf16*>(w0), static_cast<const float*>(b0),                            \
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),                            \
      static_cast<const bf16*>(w_last), alpha, b_last, smoothing, static_cast<float*>(out),   \
      nb, static_cast<cudaStream_t>(stream)
  cudaError_t err;
  switch (H) {
    case 128: err = launch<128>(GENNERF_POINT_ARGS); break;
    case 256: err = launch<256>(GENNERF_POINT_ARGS); break;
    case 512: err = launch<512>(GENNERF_POINT_ARGS); break;
    default: err = cudaErrorInvalidValue;
  }
#undef GENNERF_POINT_ARGS
  return static_cast<int>(err);
}
