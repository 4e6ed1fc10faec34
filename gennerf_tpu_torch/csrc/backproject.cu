// The feature volume's backprojection without an autograd graph
// (ops/projection.py, backproject_fold): the 2D features of T frames, f32 or
// bf16 and channels-last (B * T, Hf * Wf, C), read at each voxel's pixel in
// each frame and summed in f32 -> the (B, C, nx, ny, nz) sum and the
// (B, 1, nx, ny, nz) count of the frames that see the voxel. The wrapper
// (backproject_fold_cuda) gives channels-first features to torch's
// channels_last copy first.
//
// Replaces no TPU kernel: gennerf_tpu/ops/projection.py gathers each frame's
// features and sums them, which XLA fuses into one pass on the TPU. In
// PyTorch the composition runs frame by frame: an f32 copy of the features,
// an index_select writing a (C, V) tensor, a where against the valid mask
// and an add of two volumes. At the spatial benchmark cell (8 bf16 frames of
// 512 x 480 x 640 into 256 x 256 x 96) that is ~690 GB of device traffic a
// request for one 12.88 GB sum.
//
// What bounds it on this card: bytes. The least traffic is the features read
// once (2.52 GB in bf16), the (B, T, V) int32 pixel indices (0.20 GB), the
// sum written once (12.88 GB) and the count (0.025 GB): 15.6 GB, 4.7 ms at
// 3.35 TB/s. The arithmetic (one add a channel a frame) is far below the
// card's rate.
//
// What the design does about it: a block of 256 threads takes 32 consecutive
// voxels (the z column is innermost in V, so neighbouring voxels project onto
// a short segment of pixels) and a tile of 32 16-byte slices of the channel
// row (256 bf16 or 128 f32 channels). Each warp takes one voxel at a time, a
// slice a lane, so a voxel's row tile is one coalesced 512-byte load through
// the read-only path (ld.global.nc); a thread keeps the running sums of its 4
// voxels' slice in registers over the T frames. The block then stages its
// sums in shared memory, swizzled so that neither the lanes' writes (one
// voxel, 32 channel slices) nor their reads (one channel, 32 voxels) share a
// bank, and writes each channel's run of 32 voxels as one 128-byte streaming
// store (st.global.cs), so that the output does not push the features out of
// L2. A row that is not a multiple of 16 bytes (C = 1, an odd C) takes one
// value a lane instead. The channel tiles of a voxel run are neighbouring
// blocks, so they find the same rows in L2.
//
// Bit-equal to the composition on the same card: a voxel's sum starts from
// frame 0's value (its row where the frame sees the voxel, +0.0 where it does
// not) and adds frames 1 .. T-1 in order, each add rounded once (__fadd_rn,
// so nvcc contracts nothing); a bf16 value is widened exactly to f32 first,
// as torch's cast does. ±0, inf and NaN pass through the adds as through
// torch's. The count is the f32 sum of 0 and 1 in frame order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVoxels = 32;                  // a block's run of voxels: one store a channel
constexpr int kSlices = 32;                  // 16-byte slices of the row a block takes: one a lane
constexpr int kItems = kVoxels / kWarps;     // voxels a thread
// frames whose pixel indices a thread loads before their rows: at the spatial
// cell on the H100, 16.5 ms against 17.7 one frame at a time and 21.6 at 8
// (128 registers a thread)
constexpr int kChunk = 4;

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

// Frame t's value of the slice at pixel p: the row's where 0 <= p < HW, else
// +0.0 (the composition's where against the valid mask).
template <typename T, int VEC>
__device__ __forceinline__ void frame_slice(const T* frame, int p, int HW, int C, bool active,
                                            float (&x)[VEC]) {
  if (active && static_cast<unsigned>(p) < static_cast<unsigned>(HW)) {
    load_slice<T, VEC>(frame + static_cast<long long>(p) * C, x);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = 0.0f;
  }
}

// Block x takes voxel run x / ctiles and channel tile x % ctiles of item
// blockIdx.y. Lane l holds channels c0 + l * VEC .. + VEC - 1 of voxels
// warp, warp + 8, warp + 16 and warp + 24 of the run, and takes the frames
// kChunk at a time: their pixel indices first, then their rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) backproject_kernel(
    const T* __restrict__ feat, const int* __restrict__ pixel, float* __restrict__ volume,
    float* __restrict__ count, int frames, long long V, int HW, int C, int ctiles) {
  // channel row cl of the tile, voxel v at column v ^ (cl / VEC): the lanes'
  // writes (one v, cl / VEC = lane) and reads (one cl, v = lane) each fall
  // on 32 banks
  __shared__ float sums[kSlices * VEC][kVoxels];
  const int run = blockIdx.x / ctiles;
  const int c0 = (blockIdx.x - run * ctiles) * kSlices * VEC;
  const long long b = blockIdx.y;
  const long long v0 = static_cast<long long>(run) * kVoxels;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool active = c0 + lane * VEC < C;
  const T* const feat_b = feat + b * frames * HW * C + c0 + lane * VEC;
  const int* const pixel_b = pixel + b * frames * V;

  float s[kItems][VEC];  // frame 0 starts each sum: +0.0 where it does not see the voxel
  for (int t0 = 0; t0 < frames; t0 += kChunk) {
    int p[kChunk][kItems];
#pragma unroll
    for (int f = 0; f < kChunk; ++f) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const long long v = v0 + warp + i * kWarps;
        p[f][i] = (t0 + f < frames && v < V) ? __ldg(pixel_b + (t0 + f) * V + v) : -1;
      }
    }
#pragma unroll
    for (int f = 0; f < kChunk; ++f) {
      if (t0 + f >= frames) break;
      const T* const frame = feat_b + static_cast<long long>(t0 + f) * HW * C;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        float x[VEC];
        frame_slice<T, VEC>(frame, p[f][i], HW, C, active, x);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[i][j] = t0 + f == 0 ? x[j] : __fadd_rn(s[i][j], x[j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kItems; ++i) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) sums[lane * VEC + j][(warp + i * kWarps) ^ lane] = s[i][j];
  }
  __syncthreads();

  const long long v = v0 + lane;
  if (v >= V) return;
  for (int cl = warp; cl < kSlices * VEC && c0 + cl < C; cl += kWarps) {
    __stcs(volume + (b * C + c0 + cl) * V + v, sums[cl][lane ^ (cl / VEC)]);
  }
  if (c0 == 0 && warp == 0) {
    float n = 0.0f;
    for (int t = 0; t < frames; ++t) {
      const int q = __ldg(pixel_b + t * V + v);
      n = __fadd_rn(n, static_cast<unsigned>(q) < static_cast<unsigned>(HW) ? 1.0f : 0.0f);
    }
    __stcs(count + b * V + v, n);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* feat, const void* pixel, void* volume, void* count, long long B,
                   int frames, long long V, int HW, int C, cudaStream_t s) {
  const int ctiles = (C + kSlices * VEC - 1) / (kSlices * VEC);
  const long long blocks = (V + kVoxels - 1) / kVoxels * ctiles;
  if (blocks > 0x7fffffffLL || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  backproject_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(feat), static_cast<const int*>(pixel), static_cast<float*>(volume),
      static_cast<float*>(count), frames, V, HW, C, ctiles);
  return cudaGetLastError();
}

}  // namespace

// feat: (B * T, HW, C) contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1), the
// frames of item b at rows b * T .. b * T + T - 1; pixel: (B, T, V) int32
// contiguous, each pair's flat pixel index, outside [0, HW) (-1) where the
// frame does not see the voxel; volume: (B, C, V) f32; count: (B, V) f32.
// Returns a CUDA error code (0: launched, or nothing to do).
extern "C" int gennerf_backproject(const void* feat, int bf16, const void* pixel, void* volume,
                                   void* count, long long B, int T, long long V, int HW, int C,
                                   void* stream) {
  if (B < 0 || T < 1 || V < 0 || HW < 1 || C < 1 || (bf16 != 0 && bf16 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || V == 0) return 0;
  const int itemsize = bf16 ? 2 : 4;
  const bool vector = (static_cast<long long>(C) * itemsize) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = vector ? launch<__nv_bfloat16, 8>(feat, pixel, volume, count, B, T, V, HW, C, s)
                 : launch<__nv_bfloat16, 1>(feat, pixel, volume, count, B, T, V, HW, C, s);
  } else {
    err = vector ? launch<float, 4>(feat, pixel, volume, count, B, T, V, HW, C, s)
                 : launch<float, 1>(feat, pixel, volume, count, B, T, V, HW, C, s);
  }
  return static_cast<int>(err);
}
