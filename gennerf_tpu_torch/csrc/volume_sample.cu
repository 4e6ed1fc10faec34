// The feature volume's trilinear sample (ops/interpolation.py,
// trilinear_interpolation in bilinear mode): a channels-last (B, nx, ny, nz, C)
// volume, f32 or bf16, read at (B, N, 3) f32 world points -> (B, N, C) f32,
// border clamp, align corners.
//
// Replaces no TPU kernel: gennerf_tpu/ops/interpolation.py builds the sample
// from gathers and lerps, which XLA fuses into one pass on the TPU. In PyTorch
// the same composition runs as 8 gathers, 14 broadcast products and 7 adds,
// each writing a (points, C) f32 tensor: at the dense decode's chunk of
// 262,144 points of a 512-channel volume, ~35 GB of device traffic for 0.54 GB
// of output.
//
// What bounds it on this card: bytes. A point needs its 8 corner rows (C values
// each) and writes its C values once. On the decode grid, walked in the
// volume's own order, a point's corner rows are its neighbours' own rows, so
// the least traffic is each row read once and each output written once: 1.07
// GB a chunk of 262,144 x 512 f32, 0.32 ms at 3.35 TB/s. The arithmetic (7
// lerps, 21 operations a channel) is far below the card's rate.
//
// What the design does about it: a block of 128 threads takes a run of
// consecutive points. Its threads first compute each point's 8 row offsets
// and its weights once (one thread a point) into shared memory; then each
// thread takes 16-byte slices of a row's channels (4 f32 or 8 bf16 values):
// 128 threads cover 512 f32 channels, so each corner row is one coalesced
// 2 KB load. The corner slices come through the read-only path (ld.global.nc)
// and hit L1/L2 where neighbouring points share rows; the lerps stay in
// registers; the output leaves by streaming stores (st.global.cs) so that it
// does not push the volume's rows out of L2. A C whose rows are not a
// multiple of 16 bytes (C = 1, an odd C) takes one value a thread instead.
//
// Bit-equal to the composition on the same card: every step is the
// composition's f32 operation, rounded once (__fadd_rn / __fmul_rn /
// __fdiv_rn, so nvcc contracts nothing into an FMA), in its order:
//   norm = 2 * (xyz - origin) / extent - 1, with extent = f32(n) * f32(voxel)
//     rounded by the host as torch rounds it;
//   i = ((norm + 1) * 0.5) * (n - 1); w = i - floor(i), 1 - w;
//   corners at floor(i) and floor(i) + 1 (int64, torch's wrap-around),
//     clamped to [0, n - 1];
//   c00 = g000 * (1 - wz) + g001 * wz, ..., c0 = c00 * (1 - wy) + c01 * wy, ...,
//   out = c0 * (1 - wx) + c1 * wx.
// A bf16 corner value is widened exactly to f32 before its product, as torch's
// type promotion does. All 8 taps are loaded and multiplied, a zero weight too
// (a product of 0 with -0, inf or NaN is what the composition computes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
// A block's run of points: at least kMinPoints, and enough for
// kItemsPerThread (point, slice) items a thread. At the 512-channel decode
// chunk on the H100, 32 points a block took 0.55-0.57 ms in f32 and 0.37 in
// bf16, against 0.63 and 0.40 at 8 and 16 points, 0.75 and 0.45 at 64.
constexpr int kMinPoints = 32;
constexpr int kItemsPerThread = 8;
constexpr int kMaxPoints = 256;  // points a block, at most (22.5 KB of shared memory)

__device__ __forceinline__ float unnormalize(float c, int n) {
  return __fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f), static_cast<float>(n - 1));
}

__device__ __forceinline__ long long clamp_index(long long i, int n) {
  return min(max(i, 0LL), static_cast<long long>(n - 1));
}

// a * (1 - w) + b * w, each product and the sum rounded once
__device__ __forceinline__ float lerp(float a, float b, float om, float w) {
  return __fadd_rn(__fmul_rn(a, om), __fmul_rn(b, w));
}

__device__ __forceinline__ float bf16_bits(uint32_t hi16) { return __uint_as_float(hi16 << 16); }

// VEC consecutive channels of a row, widened to f32
template <typename T, int VEC>
__device__ __forceinline__ void load_slice(const T* p, float (&v)[VEC]);

template <>
__device__ __forceinline__ void load_slice<float, 4>(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

template <>
__device__ __forceinline__ void load_slice<float, 1>(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_slice<__nv_bfloat16, 8>(const __nv_bfloat16* p,
                                                             float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_bits(w[i] & 0xffffu);            // the lower address: the first channel
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void load_slice<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                             float (&v)[1]) {
  v[0] = bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

template <int VEC>
__device__ __forceinline__ void store_slice(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    __stcs(p, v[0]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      __stcs(reinterpret_cast<float4*>(p + i), make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
    }
  }
}

// Block b takes points [b * P, b * P + P) of the flattened (B * N) points.
// Shared memory: the points' 8 row offsets (elements from `vol`), then their
// weights wx, wy, wz, 1 - wx, 1 - wy, 1 - wz.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) volume_sample_kernel(
    const T* __restrict__ vol, const float* __restrict__ xyz, const float* __restrict__ origin,
    float* __restrict__ out, long long total, long long N, int nx, int ny, int nz, int C,
    float ex, float ey, float ez, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* const rows = reinterpret_cast<long long*>(smem);
  float* const wts = reinterpret_cast<float*>(rows + 8 * P);
  const long long p0 = static_cast<long long>(blockIdx.x) * P;
  const int np = static_cast<int>(min(static_cast<long long>(P), total - p0));
  const long long voxels = static_cast<long long>(nx) * ny * nz;

  for (int i = threadIdx.x; i < np; i += kThreads) {
    const long long p = p0 + i;
    const int n[3] = {nx, ny, nz};
    const float extent[3] = {ex, ey, ez};
    long long lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float d = __fsub_rn(__ldg(xyz + 3 * p + a), __ldg(origin + a));
      const float norm = __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, d), extent[a]), 1.0f);
      const float u = unnormalize(norm, n[a]);
      const float f = floorf(u);
      const float w = __fsub_rn(u, f);
      wts[6 * i + a] = w;
      wts[6 * i + 3 + a] = __fsub_rn(1.0f, w);
      const long long fi = static_cast<long long>(f);  // saturating, as torch's .to(int64)
      lo[a] = clamp_index(fi, n[a]);
      const long long next = static_cast<long long>(static_cast<unsigned long long>(fi) + 1ULL);
      hi[a] = clamp_index(next, n[a]);
    }
    const long long base = (p / N) * voxels;
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // k's bits: x, y, z; the composition's g000, g001, ... g111
      const long long xi = (k & 4) ? hi[0] : lo[0];
      const long long yi = (k & 2) ? hi[1] : lo[1];
      const long long zi = (k & 1) ? hi[2] : lo[2];
      rows[8 * i + k] = (base + (xi * ny + yi) * nz + zi) * C;
    }
  }
  __syncthreads();

  const int slices = C / VEC;
  const int items = np * slices;
#pragma unroll 2
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int i = it / slices;
    const int c = (it - i * slices) * VEC;
    const long long* r = rows + 8 * i;
    float g[8][VEC];
#pragma unroll
    for (int k = 0; k < 8; ++k) load_slice<T, VEC>(vol + r[k] + c, g[k]);
    const float* w = wts + 6 * i;
    const float wx = w[0], wy = w[1], wz = w[2], omx = w[3], omy = w[4], omz = w[5];
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float c00 = lerp(g[0][j], g[1][j], omz, wz);
      const float c01 = lerp(g[2][j], g[3][j], omz, wz);
      const float c10 = lerp(g[4][j], g[5][j], omz, wz);
      const float c11 = lerp(g[6][j], g[7][j], omz, wz);
      const float c0 = lerp(c00, c01, omy, wy);
      const float c1 = lerp(c10, c11, omy, wy);
      o[j] = lerp(c0, c1, omx, wx);
    }
    store_slice<VEC>(out + (p0 + i) * C + c, o);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* vol, const void* xyz, const void* origin, void* out,
                   long long total, long long N, int nx, int ny, int nz, int C, float ex,
                   float ey, float ez, int P, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((total + P - 1) / P);
  const size_t smem = static_cast<size_t>(P) * (8 * sizeof(long long) + 6 * sizeof(float));
  volume_sample_kernel<T, VEC><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(vol), static_cast<const float*>(xyz),
      static_cast<const float*>(origin), static_cast<float*>(out), total, N, nx, ny, nz, C, ex,
      ey, ez, P);
  return cudaGetLastError();
}

}  // namespace

// volume: (B, nx, ny, nz, C) contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1);
// xyz: (B, N, 3) f32 contiguous; origin: 3 f32 on the device; out: (B, N, C)
// f32; ex, ey, ez: the extents f32(n) * f32(voxel_size). Returns a CUDA error
// code (0: launched, or nothing to do).
extern "C" int gennerf_volume_sample(const void* volume, int bf16, const void* xyz,
                                     const void* origin, void* out, long long B, long long N,
                                     int nx, int ny, int nz, int C, float ex, float ey, float ez,
                                     void* stream) {
  if (B < 0 || N < 0 || nx < 1 || ny < 1 || nz < 1 || C < 1 || (bf16 != 0 && bf16 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = B * N;
  if (total == 0) return 0;
  const int itemsize = bf16 ? 2 : 4;
  const bool vector = (static_cast<long long>(C) * itemsize) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(volume) % 16 == 0;
  const int vec = vector ? 16 / itemsize : 1;
  const int slices = C / vec;
  const int P = std::min(kMaxPoints, std::max(kMinPoints, kThreads * kItemsPerThread / slices));
  if ((total + P - 1) / P > 0x7fffffffLL || static_cast<long long>(P) * slices > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = vector ? launch<__nv_bfloat16, 8>(volume, xyz, origin, out, total, N, nx, ny, nz, C, ex,
                                            ey, ez, P, s)
                 : launch<__nv_bfloat16, 1>(volume, xyz, origin, out, total, N, nx, ny, nz, C, ex,
                                            ey, ez, P, s);
  } else {
    err = vector ? launch<float, 4>(volume, xyz, origin, out, total, N, nx, ny, nz, C, ex, ey, ez,
                                    P, s)
                 : launch<float, 1>(volume, xyz, origin, out, total, N, nx, ny, nz, C, ex, ey, ez,
                                    P, s);
  }
  return static_cast<int>(err);
}
