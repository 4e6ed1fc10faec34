// Exact farthest-point sampling, one thread block per cloud.
//
// Replaces the TPU kernel gennerf_tpu/ops/pallas/fps.py::_fps_kernel
// (launched by fps_pallas). Semantics are the reference loop's
// (gennerf_tpu/ops/sampling.py farthest_point_sample): in each of npoint
// iterations record `far`, set dist = min(dist, dx*dx + dy*dy + dz*dz) in
// f32 starting from 1e10, and take `far` = the FIRST index of max(dist).
//
// What bounds it on this card: not bytes and not arithmetic, but latency.
// The npoint iterations are strictly dependent, and each ends in a
// block-wide argmax (a warp-shuffle tree, one __syncthreads, a second
// shuffle tree, another __syncthreads). At the predict shape (8 clouds of
// 16384 points, 256 samples) only 8 of the 132 SMs have work.
//
// What the design does about it: everything an iteration touches stays on
// the SM. Each of the 1024 threads keeps the running distances of its
// ceil(N/1024) points in registers (a template parameter, so the array is
// unrolled into registers); the cloud goes into dynamic shared memory when
// it fits (16384 x 3 x 4 B = 192 KB of the 227 KB a block may have; the
// distances would add 64 KB, which is why they live in registers), and is
// read through the cache from device memory for larger clouds (up to
// 32768 points). Bit-identical indices: the squared distance is computed
// with __fsub_rn/__fmul_rn/__fadd_rn in the reference's order, so no FMA
// contraction changes a rounding, and ties go to the lower index at every
// level of the reduction.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 32 * kThreads;
// dynamic shared memory a block may use, less room for the static arrays
constexpr size_t kMaxDynamicSmem = 232448 - 1024;

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint, int coords_in_smem) {
  extern __shared__ float smem_xyz[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_far;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* cloud = xyz + static_cast<size_t>(b) * N * 3;
  const float* pts = cloud;
  if (coords_in_smem) {
    for (int e = t; e < 3 * N; e += kThreads) smem_xyz[e] = cloud[e];
    pts = smem_xyz;
  }
  float dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) dist[k] = 1e10f;
  if (t == 0) s_far = start[b];
  __syncthreads();

  for (int it = 0; it < npoint; ++it) {
    const int far = s_far;
    if (t == 0) out[static_cast<size_t>(b) * npoint + it] = far;
    const float cx = pts[3 * far];
    const float cy = pts[3 * far + 1];
    const float cz = pts[3 * far + 2];
    float bv = -1.0f;  // every distance is >= 0, so any point beats it
    int bi = N;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = t + k * kThreads;
      if (i < N) {
        const float dx = __fsub_rn(pts[3 * i], cx);
        const float dy = __fsub_rn(pts[3 * i + 1], cy);
        const float dz = __fsub_rn(pts[3 * i + 2], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        dist[k] = fminf(dist[k], d);
        // k ascends with the index, so strict > keeps the first maximum
        if (dist[k] > bv) {
          bv = dist[k];
          bi = i;
        }
      }
    }
    warp_argmax(bv, bi);
    if ((t & 31) == 0) {
      red_v[t >> 5] = bv;
      red_i[t >> 5] = bi;
    }
    __syncthreads();
    if (t < 32) {
      bv = red_v[t];
      bi = red_i[t];
      warp_argmax(bv, bi);
      if (t == 0) s_far = bi;
    }
    __syncthreads();
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, const int* start, int* out, int B, int N,
                   int npoint, cudaStream_t stream) {
  const size_t need = static_cast<size_t>(3) * N * sizeof(float);
  const int in_smem = need <= kMaxDynamicSmem ? 1 : 0;
  const size_t smem = in_smem ? need : 0;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_kernel<PPT><<<B, kThreads, smem, stream>>>(xyz, start, out, N, npoint, in_smem);
  return cudaGetLastError();
}

}  // namespace

// xyz: (B, N, 3) f32 contiguous; start: (B,) int32; out: (B, npoint) int32.
// Returns a cudaError_t (0 on success).
extern "C" int gennerf_fps(const void* xyz, const void* start, void* out, int B, int N,
                           int npoint, void* stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || npoint > N || N > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* x = static_cast<const float*>(xyz);
  const int* s = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ppt = (N + kThreads - 1) / kThreads;
  cudaError_t err;
  if (ppt <= 1) err = launch<1>(x, s, o, B, N, npoint, st);
  else if (ppt <= 2) err = launch<2>(x, s, o, B, N, npoint, st);
  else if (ppt <= 4) err = launch<4>(x, s, o, B, N, npoint, st);
  else if (ppt <= 8) err = launch<8>(x, s, o, B, N, npoint, st);
  else if (ppt <= 16) err = launch<16>(x, s, o, B, N, npoint, st);
  else err = launch<32>(x, s, o, B, N, npoint, st);
  return static_cast<int>(err);
}
