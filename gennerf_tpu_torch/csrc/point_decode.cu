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
// What the design does about it: the tile machinery K2 uses
// (resnet_tile.cuh: two wgmma consumer warpgroups, a producer streaming the
// weights through a bulk-copy ring, the residual stream in registers, a
// tile of R = 128 points at H <= 256, taken in flat order with the ragged
// tail masked). The consumers stage the tile's feat rows into the second
// activation buffer (needed only by lin_in, whose product runs before that
// buffer is first written) and its code rows into their own buffer, where
// they stay for every block's lin_z product; both are rounded to bf16 once
// and zero-padded to the product depth, a multiple of 16. lin_in and lin_z
// run on the tensor cores like the H x H products; the lin_z epilogue adds
// alpha * (code @ wz_b + bz_b) to the residual stream and rounds relu(x)
// into the first product's A buffer. The triplane gather and the
// positional code stay outside (torch ops, as XLA computed them for the TPU
// kernel).
#include "resnet_tile.cuh"

namespace {

using namespace gennerf;

// rows [p0, p0 + rows) of an (n, d) f32 array into an activation-layout
// buffer of depth d_p, as bf16; columns past d and rows past `rows` are 0
template <int H>
__device__ __forceinline__ void stage_rows(unsigned char* buf, const float* __restrict__ src,
                                           long long p0, int rows, int d, int d_p, int t) {
  using T = Tile<H>;
  const int units = T::R * (d_p / 8);  // 16-byte rows of core matrices
  for (int u = t; u < units; u += kConsumers * 128) {
    const int r = u % T::R, kc = u / T::R;
    const float* s = src + (p0 + r) * d;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = kc * 8 + 2 * e;
      const float v0 = (r < rows && c < d) ? s[c] : 0.0f;
      const float v1 = (r < rows && c + 1 < d) ? s[c + 1] : 0.0f;
      const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
      w[e] = *reinterpret_cast<const uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(buf + kc * (T::R * 16) + (r / 8) * 128 + (r % 8) * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
point_decode_kernel(const float* __restrict__ feat, const float* __restrict__ code, long long n,
                    int d_in, int d_in_p, int d_code, int d_code_p,
                    const bf16* __restrict__ slabs, const float* __restrict__ b_in,
                    const float* __restrict__ bz, const float* __restrict__ b0,
                    const float* __restrict__ b1, const bf16* __restrict__ w_last, float alpha,
                    float b_last, float smoothing, float* __restrict__ out, int nb) {
  using T = Tile<H>;
  extern __shared__ __align__(1024) unsigned char smem[];
  Ring ring(smem);
  if (threadIdx.x == 0) ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= kConsumers * 128) {
    setmaxnreg_dec<kProducerRegs>();
    // the products: lin_in, then per block lin_z, w0, w1
    if (threadIdx.x == kConsumers * 128)
      produce<H>(ring, slabs, 1 + 3 * nb,
                 [=](int p) { return p == 0 ? d_in_p : (p % 3 == 1 ? d_code_p : H); });
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const Frag<H> f(threadIdx.x);
  unsigned char* a1 = smem + T::A1_OFF;  // bf16 relu(x): w0's A
  unsigned char* a2 = smem + T::A2_OFF;  // bf16 feat (lin_in's A), then relu(net): w1's A
  unsigned char* cs = smem + T::END;     // bf16 code: every lin_z's A
  float* partial = reinterpret_cast<float*>(smem + 16 * kStages);
  const long long p0 = static_cast<long long>(blockIdx.x) * T::R;
  const long long left = n - p0;
  const int rows = left < T::R ? static_cast<int>(left) : T::R;

  stage_rows<H>(a2, feat, p0, rows, d_in, d_in_p, threadIdx.x);
  stage_rows<H>(cs, code, p0, rows, d_code, d_code_p, threadIdx.x);
  fence_proxy_async();
  sync_consumers();

  float x[T::XR];
  tile_product<H>(ring, f, smem_u32(a2), d_in_p, [&](auto c, float(&acc)[32]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bias = __ldg(reinterpret_cast<const float2*>(b_in + f.col(c, j)));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 4 * j + 2 * rr;
        x[c * 32 + i] = acc[i] + bias.x;
        x[c * 32 + i + 1] = acc[i + 1] + bias.y;
      }
    }
  });

  for (int b = 0; b < nb; ++b) {
    const float* bzb = bz + static_cast<size_t>(b) * H;
    const float* b0b = b0 + static_cast<size_t>(b) * H;
    const float* b1b = b1 + static_cast<size_t>(b) * H;
    tile_product<H>(ring, f, smem_u32(cs), d_code_p, [&](auto c, float(&acc)[32]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias = __ldg(reinterpret_cast<const float2*>(bzb + f.col(c, j)));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr;
          float& x0 = x[c * 32 + i];
          float& x1 = x[c * 32 + i + 1];
          x0 = x0 + alpha * (acc[i] + bias.x);
          x1 = x1 + alpha * (acc[i + 1] + bias.y);
          f.store_pair(a1, c, j, rr, fmaxf(x0, 0.0f), fmaxf(x1, 0.0f));
        }
      }
    });
    sync_activations<H>(f.wg);
    tile_product<H>(ring, f, smem_u32(a1), H, [&](auto c, float(&acc)[32]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias = __ldg(reinterpret_cast<const float2*>(b0b + f.col(c, j)));
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
        const float2 bias = __ldg(reinterpret_cast<const float2*>(b1b + f.col(c, j)));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr;
          x[c * 32 + i] = x[c * 32 + i] + (acc[i] + bias.x);
          x[c * 32 + i + 1] = x[c * 32 + i + 1] + (acc[i + 1] + bias.y);
        }
      }
    });
  }

  tile_head<H>(f, x, w_last, b_last, smoothing, partial, out, p0,
               [&](int r) { return r < rows; });
}

template <int H>
cudaError_t launch(const float* feat, const float* code, long long n, int d_in, int d_in_p,
                   int d_code, int d_code_p, const bf16* slabs, const float* b_in,
                   const float* bz, const float* b0, const float* b1, const bf16* w_last,
                   float alpha, float b_last, float smoothing, float* out, int nb,
                   cudaStream_t stream) {
  using T = Tile<H>;
  // the feat rows are staged in the second activation buffer
  if (d_in_p > H) return cudaErrorInvalidValue;
  const int smem = T::END + T::R * d_code_p * 2;
  cudaError_t err = cudaFuncSetAttribute(point_decode_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + T::R - 1) / T::R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  point_decode_kernel<H><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      feat, code, n, d_in, d_in_p, d_code, d_code_p, slabs, b_in, bz, b0, b1, w_last, alpha,
      b_last, smoothing, out, nb);
  return cudaGetLastError();
}

}  // namespace

// feat (n, d_in) and code (n, d_code) f32, contiguous. slabs: bf16, w_in
// (d_in_p, H), then per block wz_b (d_code_p, H), w0_b, w1_b (H, H), each as
// (in, out) with zero rows past d_in / d_code and packed as its bulk-copy
// slabs (ops/weight_slabs.py); b_in (H,), bz, b0, b1 (nb, H) f32; w_last (H,)
// bf16. d_in_p and d_code_p are multiples of 16, at most 128. out: (n,) f32.
// H must be 128, 256 or 512. Returns a cudaError_t (0 on success).
extern "C" int gennerf_point_decode(const void* feat, const void* code, long long n, int d_in,
                                    int d_in_p, int d_code, int d_code_p, const void* slabs,
                                    const void* b_in, const void* bz, const void* b0,
                                    const void* b1, const void* w_last, float alpha,
                                    float b_last, float smoothing, void* out, int nb, int H,
                                    void* stream) {
  if (n <= 0 || nb <= 0 || d_in <= 0 || d_code <= 0 || d_in > d_in_p || d_code > d_code_p ||
      d_in_p % 16 || d_code_p % 16 || d_in_p > 128 || d_code_p > 128)
    return static_cast<int>(cudaErrorInvalidValue);
#define GENNERF_POINT_ARGS                                                                     \
  static_cast<const float*>(feat), static_cast<const float*>(code), n, d_in, d_in_p, d_code,  \
      d_code_p, static_cast<const bf16*>(slabs), static_cast<const float*>(b_in),             \
      static_cast<const float*>(bz), static_cast<const float*>(b0),                           \
      static_cast<const float*>(b1), static_cast<const bf16*>(w_last), alpha, b_last,         \
      smoothing, static_cast<float*>(out), nb, static_cast<cudaStream_t>(stream)
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
