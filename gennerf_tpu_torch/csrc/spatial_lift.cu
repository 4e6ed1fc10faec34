// The spatial encoder's lift (models/spatial_encoder.py, ops/spatial_lift.py):
// the ResNet's stem and stage maps, each resized to the stem's size
// (align-corners bilinear: the width pass, then the height pass),
// concatenated along channels and projected by the 1x1 `proj` conv with its
// bias, in bf16 with f32 accumulation; and, for its backward, the transpose
// of one map's resize.
//
// Replaces no TPU kernel: the JAX package leaves the resizes, the concat and
// the conv to XLA. It was added because the unfused chain writes the whole
// concatenated latent at full resolution (1,856 channels, 1.14 GB a 480x640
// image in bf16, for ResNet-50 at num_layers 4), reads it back through the
// resizes' products and a layout transpose before the conv, and its backward
// sums the resizes' gradients with atomic bf16 index_adds.
//
// What bounds the forward on this card: bytes, about as much as the
// products. At 12 images of 480x640 with maps of 64 x 480x640, 256 x
// 240x320, 512 x 120x160 and 1024 x 60x80 and proj 1856 -> 32, it reads
// 1.30 GB of maps once and writes 236 MB (0.46 ms at 3.35 TB/s) for 0.44
// TFLOP of products (0.44 ms at 989 TFLOP/s). Rebuilding each resized value
// (four texel loads, nine bf16 roundings) runs on the CUDA cores.
//
// What the design does about it: the latent never leaves the SM. A block
// (one warpgroup) owns 64 consecutive output pixels of one image and every
// output channel. It walks the latent channels in slabs of at most 64, each
// slab inside one map. Every thread rebuilds its pixel's values, 8 channels
// at a time, from the map's texels with _lerp_axis's per-element arithmetic
// (the weights w and 1 - w rounded to bf16 by the host's tables, each
// product and the sum rounded to bf16), so that they are bit-equal to the
// unfused latent: two channels at once in bf16x2 (mul.rn / add.rn round
// the exact product or sum once, which is what rounding torch's float32
// result to bf16 gives: a product of two bf16 values is exact in float32,
// and a sum is unless one term is below 2^-15 of the other, where both
// round to the larger), and stores them as one 16-byte row of the wgmma A operand
// in shared memory; the slab's weights, packed on the host in the same
// K-major layout, are copied beside it. wgmma (m64n32k16 per 32 output
// channels, f32 accumulators) runs on one slab while the threads build the
// next in the other buffer. The epilogue rounds to bf16, adds the bias in
// bf16 (the cast conv's order) and writes NCHW through a staging tile in
// shared memory, 128 bytes per output channel.
//
// The backward's gather (lift_resize_t_kernel) sums, for each texel of a
// map, the output gradient over the texel's footprint, rows outer and
// columns inner, in f32: a fixed order, no atomics, deterministic.
//
// Tap tables (int32, ops/spatial_lift.lerp_table), one per axis resized from
// `in` to `out` samples: i0[out] | i1[out] | w[out] | 1 - w[out] (f32 bits
// of the bf16 weights) | lo[in] | hi[in], where output samples lo..hi-1 are
// the only ones whose taps touch input sample i. A map's table is its x
// table followed by its y table.
#include "resnet_tile.cuh"

namespace {

using namespace gennerf;

constexpr int kMaxMaps = 5;
constexpr int kRows = 64;                 // output pixels a block: the wgmma M
constexpr int kSlab = 64;                 // latent channels a slab, at most
constexpr int kLiftThreads = 128;         // one warpgroup
constexpr int kABytes = kRows * kSlab * 2;
constexpr int kStageStride = kRows + 8;   // a staging tile's channel, padded (bank conflicts)
constexpr int kGatherThreads = 256;

struct LiftArgs {
  const bf16* map[kMaxMaps];
  const int* taps[kMaxMaps];  // nullptr: the map has the output's size and is read as it is
  int channels[kMaxMaps];
  int height[kMaxMaps];
  int width[kMaxMaps];
  int n_maps;
  const bf16* weight;  // packed: element (o, k) at ((k / 8) * NT + o) * 8 + k % 8, NT rows
  const bf16* bias;    // (cout,)
  bf16* out;           // (N, cout, H, W)
  int cout, H, W;
};

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(__ldg(p)); }

// the values of two channels, `plane` apart, at one texel
__device__ __forceinline__ __nv_bfloat162 ld2(const bf16* p, size_t plane) {
  return __halves2bfloat162(__ldg(p), __ldg(p + plane));
}

__device__ __forceinline__ void fence_acc16(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d(64x32, f32) = A(64x16, bf16, K-major) B(16x32, bf16, K-major) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// CH chunks of 32 output channels: NT = 32 * CH rows of packed weights
template <int CH>
__global__ void __launch_bounds__(kLiftThreads) spatial_lift_kernel(const LiftArgs a) {
  constexpr int NT = 32 * CH;
  constexpr int kBBytes = NT * kSlab * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int HW = a.H * a.W;
  const int tiles = (HW + kRows - 1) / kRows;  // blocks an image
  const int t = threadIdx.x, p = t & (kRows - 1), n = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - n * tiles) * kRows;
  // rows past the image's last pixel rebuild that pixel and are never stored
  const int q = min(q0 + p, HW - 1);
  const int y = q / a.W, x = q - y * a.W;
  unsigned char* const a_buf = smem;                // two A slabs
  unsigned char* const b_buf = smem + 2 * kABytes;  // two weight slabs
  const int a_row = (p / 8) * 128 + (p % 8) * 16;   // this pixel's 16-byte row of a core matrix

  float acc[CH][16];
  int slab = 0, k = 0;
  for (int l = 0; l < a.n_maps; ++l) {
    const int C = a.channels[l], w = a.width[l];
    const size_t plane = static_cast<size_t>(a.height[l]) * w;
    const bf16* f = a.map[l] + static_cast<size_t>(n) * C * plane;
    const int* tx = a.taps[l];
    const bool resized = tx != nullptr;
    // this pixel's four texels and its weights (a map read as it is: texel o00)
    int o00 = y * w + x, o01 = 0, o10 = 0, o11 = 0;
    __nv_bfloat162 wx{}, omx{}, wy{}, omy{};  // each weight in both halves (exact: bf16 values)
    if (resized) {
      const int* ty = tx + 4 * a.W + 2 * w;
      const int x0 = tx[x], x1 = tx[a.W + x], y0 = ty[y], y1 = ty[a.H + y];
      wx = __float2bfloat162_rn(__int_as_float(tx[2 * a.W + x]));
      omx = __float2bfloat162_rn(__int_as_float(tx[3 * a.W + x]));
      wy = __float2bfloat162_rn(__int_as_float(ty[2 * a.H + y]));
      omy = __float2bfloat162_rn(__int_as_float(ty[3 * a.H + y]));
      o00 = y0 * w + x0;
      o01 = y0 * w + x1;
      o10 = y1 * w + x0;
      o11 = y1 * w + x1;
    }
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += kSlab, ++slab) {
      const int ks = min(kSlab, C - c0);
      unsigned char* const A = a_buf + (slab & 1) * kABytes;
      unsigned char* const B = b_buf + (slab & 1) * kBBytes;
      // the buffers were last read by slab - 2's products, finished at slab - 1's wait
      const uint4* src = reinterpret_cast<const uint4*>(a.weight) + static_cast<size_t>(k) * NT / 8;
      for (int i = t; i < ks * NT / 8; i += kLiftThreads) {
        reinterpret_cast<uint4*>(B)[i] = __ldg(src + i);
      }
#pragma unroll 1
      for (int g = t / kRows; g < ks / 8; g += kLiftThreads / kRows) {
        const bf16* fc = f + static_cast<size_t>(c0 + 8 * g) * plane;
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          const bf16* fp = fc + i * plane;  // channels i and i + 1, paired in bf16x2
          __nv_bfloat162 e;
          if (resized) {
            // _lerp_axis: x[i0] * (1 - w) + x[i1] * w, each op rounded to bf16 once
            const __nv_bfloat162 r0 = __hadd2_rn(__hmul2_rn(ld2(fp + o00, plane), omx),
                                                 __hmul2_rn(ld2(fp + o01, plane), wx));
            const __nv_bfloat162 r1 = __hadd2_rn(__hmul2_rn(ld2(fp + o10, plane), omx),
                                                 __hmul2_rn(ld2(fp + o11, plane), wx));
            e = __hadd2_rn(__hmul2_rn(r0, omy), __hmul2_rn(r1, wy));
          } else {
            e = ld2(fp + o00, plane);
          }
          v[i / 2] = *reinterpret_cast<const uint32_t*>(&e);
        }
        *reinterpret_cast<uint4*>(A + g * (kRows * 16) + a_row) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
      fence_proxy_async();
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CH; ++c) fence_acc16(acc[c]);
#pragma unroll 1
      for (int kk = 0; kk < ks; kk += 16) {
        const uint64_t da = smem_desc(smem_u32(A) + (kk / 8) * (kRows * 16), kRows * 16, 128);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const uint64_t db = smem_desc(smem_u32(B) + (kk / 8) * (NT * 16) + c * 512, NT * 16, 128);
          wgmma_m64n32k16(acc[c], da, db, slab > 0 || kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      k += ks;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < CH; ++c) fence_acc16(acc[c]);
  __syncthreads();  // every product is done before the staging tile overwrites the slabs

  // epilogue: bf16(bf16(acc) + bias) into the staging tile (channel-major), then NCHW rows
  bf16* const stage = reinterpret_cast<bf16*>(smem);
  const int warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = 32 * c + 8 * j + 2 * (lane & 3) + e;
          if (o < a.cout) {
            const int r = 16 * warp + (lane >> 2) + 8 * rr;
            const float yv = rbf(acc[c][4 * j + 2 * rr + e]);
            stage[o * kStageStride + r] = __float2bfloat16_rn(yv + __bfloat162float(a.bias[o]));
          }
        }
      }
    }
  }
  __syncthreads();
  bf16* const out = a.out + static_cast<size_t>(n) * a.cout * HW + q0;
  const int rows = min(kRows, HW - q0);
  for (int i = t; i < a.cout * kRows; i += kLiftThreads) {
    const int o = i / kRows, r = i % kRows;
    if (r < rows) out[static_cast<size_t>(o) * HW + r] = stage[o * kStageStride + r];
  }
}

// the weight of output sample o's taps on input sample i along one axis
__device__ __forceinline__ float tap_weight(const int* __restrict__ tab, int out, int o, int i) {
  return (tab[o] == i ? __int_as_float(tab[3 * out + o]) : 0.0f) +
         (tab[out + o] == i ? __int_as_float(tab[2 * out + o]) : 0.0f);
}

// G (planes, h, w) f32 = the transpose of the (h, w) -> (H, W) resize applied
// to g (planes, H, W): each texel sums its footprint, rows outer, columns
// inner. `blocks` blocks a plane, plane after plane along the grid's x.
__global__ void __launch_bounds__(kGatherThreads)
lift_resize_t_kernel(const bf16* __restrict__ g, float* __restrict__ G, const int* __restrict__ tx,
                     const int* __restrict__ ty, int H, int W, int h, int w, int blocks) {
  const int plane = blockIdx.x / blocks;
  const int i = (blockIdx.x - plane * blocks) * kGatherThreads + threadIdx.x;
  if (i >= h * w) return;
  const int yi = i / w, xi = i - yi * w;
  const bf16* gp = g + static_cast<size_t>(plane) * H * W;
  const int xlo = tx[4 * W + xi], xhi = tx[4 * W + w + xi];
  const int ylo = ty[4 * H + yi], yhi = ty[4 * H + h + yi];
  float acc = 0.0f;
  for (int yo = ylo; yo < yhi; ++yo) {
    const float wy = tap_weight(ty, H, yo, yi);
    const bf16* row = gp + static_cast<size_t>(yo) * W;
    float s = 0.0f;
    for (int xo = xlo; xo < xhi; ++xo) s += tap_weight(tx, W, xo, xi) * ld(row + xo);
    acc += wy * s;
  }
  G[static_cast<size_t>(plane) * h * w + i] = acc;
}

template <int CH>
cudaError_t launch_lift(const LiftArgs& a, int N, cudaStream_t stream) {
  constexpr int smem = 2 * kABytes + 2 * (32 * CH) * kSlab * 2;
  static_assert((32 * CH) * kStageStride * 2 <= smem, "the staging tile fits the slabs");
  cudaError_t err = cudaFuncSetAttribute(spatial_lift_kernel<CH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.H * a.W + kRows - 1) / kRows) * N);  // image after image
  spatial_lift_kernel<CH><<<grid, kLiftThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// maps[l]: bf16 (N, channels[l], heights[l], widths[l]) contiguous, l < n_maps
// <= 5, channels a multiple of 16; taps[l]: the map's x and y tap tables, or
// null where the map has the output's size; weight: bf16 packed (K / 8, nt,
// 8), K the channels' sum, rows past cout zero; bias: bf16 (cout,); out: bf16
// (N, cout, H, W). cout a multiple of 8, nt (32, 64, 128 or 256) at least
// cout. Returns a cudaError_t (0 on success).
extern "C" int gennerf_spatial_lift(int n_maps, const void* const* maps, const void* const* taps,
                                    const int* channels, const int* heights, const int* widths,
                                    const void* weight, const void* bias, void* out, int N,
                                    int cout, int nt, int H, int W, void* stream) {
  if (n_maps < 1 || n_maps > kMaxMaps || N < 1 || H < 1 || W < 1 || cout < 8 ||
      cout % 8 != 0 || cout > nt || static_cast<long long>(H) * W > 0x7fffffffLL - kRows ||
      (static_cast<long long>(H) * W + kRows - 1) / kRows * N > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LiftArgs a{};
  for (int l = 0; l < n_maps; ++l) {
    if (channels[l] < 16 || channels[l] % 16 != 0 || heights[l] < 1 || widths[l] < 1 ||
        static_cast<long long>(heights[l]) * widths[l] > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.map[l] = static_cast<const bf16*>(maps[l]);
    a.taps[l] = static_cast<const int*>(taps[l]);
    a.channels[l] = channels[l];
    a.height[l] = heights[l];
    a.width[l] = widths[l];
  }
  a.n_maps = n_maps;
  a.weight = static_cast<const bf16*>(weight);
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  a.cout = cout;
  a.H = H;
  a.W = W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (nt) {
    case 32: err = launch_lift<1>(a, N, s); break;
    case 64: err = launch_lift<2>(a, N, s); break;
    case 128: err = launch_lift<4>(a, N, s); break;
    case 256: err = launch_lift<8>(a, N, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// g: bf16 (planes, H, W) contiguous; G: f32 (planes, h, w); tx, ty: the
// map's x and y tap tables; planes times the blocks a plane (h * w / 256,
// rounded up) at most 2^31 - 1. Returns a cudaError_t.
extern "C" int gennerf_lift_resize_t(const void* g, void* G, const void* tx, const void* ty,
                                     int planes, int H, int W, int h, int w, void* stream) {
  const long long blocks = (static_cast<long long>(h) * w + kGatherThreads - 1) / kGatherThreads;
  if (planes < 1 || H < 1 || W < 1 || h < 1 || w < 1 ||
      static_cast<long long>(h) * w > 0x7fffffffLL - kGatherThreads ||
      blocks * planes > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lift_resize_t_kernel<<<static_cast<unsigned>(blocks * planes), kGatherThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<float*>(G), static_cast<const int*>(tx),
      static_cast<const int*>(ty), H, W, h, w, static_cast<int>(blocks));
  return static_cast<int>(cudaGetLastError());
}
