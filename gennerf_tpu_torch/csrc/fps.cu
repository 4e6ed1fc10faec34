// Exact farthest-point sampling, one thread-block cluster per cloud.
//
// Replaces the TPU kernel gennerf_tpu/ops/pallas/fps.py::_fps_kernel
// (launched by fps_pallas). Semantics are the reference loop's
// (gennerf_tpu/ops/sampling.py farthest_point_sample): in each of npoint
// iterations record `far`, set dist = min(dist, dx*dx + dy*dy + dz*dz) in
// f32 starting from 1e10, and take `far` = the FIRST index of max(dist).
//
// What bounds it on this card: neither bytes nor arithmetic (10 f32
// operations per point and iteration are ~0.3 MFLOP an iteration at the
// predict shape) but the chain of npoint dependent cloud-wide argmaxes: no
// distance update can start before the previous iteration's winner, and its
// coordinates, are known to every thread that updates.
//
// What the design does about it: each cloud runs on a cluster of CL CTAs
// (CL in {1, 2, 4, 8, 16}; the caller picks it once per shape from
// gennerf_fps_plan's occupancy answer for each size), CTA rank r owning the contiguous slice
// [r*S, min((r+1)*S, N)) with S = ceil(N / CL). So CL SMs share the distance
// updates, and a slice small enough lives in registers: each thread keeps
// x, y, z and the running distance of its PPT points (local indices
// t + k*kThreads, a template parameter, so the arrays unroll into
// registers) and touches no memory in its update. One iteration:
//   1. distance update and in-thread argmax (k ascends with the index, so a
//      strict > keeps the first maximum);
//   2. warp argmax in two redux.sync instructions: the largest distance
//      (its bits, which order like the value for distances >= 0), then the
//      lowest index holding it;
//   3. one shared-memory step to a CTA candidate, whose distance, index and
//      x, y, z warp 0's lanes send into slot [parity][rank] of every peer
//      CTA's shared memory with st.async, which completes its bytes on the
//      peer's mbarrier for that parity;
//   4. every thread waits on its own CTA's mbarrier, whose phase completes
//      when all CL candidates have landed (one local arrive.expect_tx of
//      CL candidates' bytes): no fence and no cluster-wide barrier;
//   5. every warp reduces the CL slots of its own CTA's shared memory, so
//      every CTA agrees on the winner and already holds its coordinates: no
//      dependent load of the centroid sits on the critical path.
// The slots and mbarriers are double-buffered by iteration parity: a peer
// sends into buffer p again two iterations later, only after it has the
// next iteration's candidate of this CTA, which warp 0 sends after the
// block step that every warp reaches after reading buffer p. A first
// cluster barrier makes the initialised mbarriers visible to the peers; a
// last one keeps every CTA until all candidates have landed.
// Alternatives measured on the H100 as edits of this file: a
// cluster barrier in place of the mbarriers (~60% slower), every warp
// sending its own candidate (faster at CL <= 4, slower at the CL = 8 the
// launcher takes), other thread counts, no register tier.
//
// Slices larger than kThreads * kMaxRegPPT points take the loop tier: the
// same exchange, with the distances in a scratch buffer in device memory
// and the slice's coordinates in dynamic shared memory when they fit (12 B
// a point), else read through L1 from device memory. So any N runs.
//
// Bit-identical indices: the squared distance is computed with
// __fsub_rn/__fmul_rn/__fadd_rn in the reference's order, so no FMA
// contraction changes a rounding, and ties go to the lower index at every
// level of the reduction.
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// register tier: points a thread holds (x, y, z, distance: 4 registers each)
constexpr int kMaxRegPPT = kThreads <= 256 ? 32 : 16;
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // the index of no point
constexpr unsigned kCandBytes = 20;      // distance bits, index, x, y, z

// tiers of gennerf_fps_plan
enum Tier { kRegisters = 0, kShared = 1, kDeviceMemory = 2 };

struct Slots {
  uint4 cand[2][kMaxCluster];  // {distance bits, index, x, y} by parity and peer rank
  float cand_z[2][kMaxCluster];
  uint4 warp[kWarps];  // the CTA's per-warp candidates
  float warp_z[kWarps];
  uint64_t bar[2];  // by parity: complete when the CL candidates have landed
};

// dynamic shared memory a block may use beside the static slots
constexpr size_t kMaxDynamicSmem = (232448 - sizeof(Slots)) / 16 * 16;

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t peer_address(const void* local, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem_u32(local)), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT_%=;\n\t}" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// the candidate into slot `sender` of a peer, completing on its mbarrier
__device__ __forceinline__ void send(Slots& s, int parity, int sender, unsigned peer, uint4 c,
                                     float z) {
  const uint32_t slot = peer_address(&s.cand[parity][sender], peer);
  const uint32_t slot_z = peer_address(&s.cand_z[parity][sender], peer);
  const uint32_t bar = peer_address(&s.bar[parity], peer);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(slot), "r"(c.x), "r"(c.y), "r"(c.z), "r"(c.w), "r"(bar) : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(slot_z), "r"(__float_as_uint(z)), "r"(bar) : "memory");
}

// the lowest index holding the warp's largest distance bits, in every lane
__device__ __forceinline__ unsigned warp_argmax(unsigned v, unsigned i) {
  const unsigned best = __reduce_max_sync(kFull, v);
  return __reduce_min_sync(kFull, v == best ? i : kNone);
}

struct Winner {
  int far;
  float x, y, z;
};

// Steps 2-5 of an iteration: the thread's candidate (distance bits and
// index, 0 and kNone for none, with the coordinates of its point) in, the
// cloud's winner out, in every thread.
__device__ __forceinline__ Winner exchange(Slots& s, unsigned v, unsigned i, float x, float y,
                                           float z, int it, unsigned rank, int cl) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int parity = it & 1;
  const unsigned wi = warp_argmax(v, i);
  // the lowest lane holding the warp's winner has its coordinates
  const int own = __ffs(__ballot_sync(kFull, i == wi)) - 1;
  if (lane == own) {
    s.warp[warp] = make_uint4(v, i, __float_as_uint(x), __float_as_uint(y));
    s.warp_z[warp] = z;
  }
  __syncthreads();
  if (warp == 0) {
    const uint4 c = s.warp[lane & (kWarps - 1)];
    const float cz = s.warp_z[lane & (kWarps - 1)];
    const unsigned bi = warp_argmax(c.x, c.y);
    const int src = __ffs(__ballot_sync(kFull, c.y == bi)) - 1;
    const uint4 best = make_uint4(__shfl_sync(kFull, c.x, src), bi, __shfl_sync(kFull, c.z, src),
                                  __shfl_sync(kFull, c.w, src));
    const float bz = __shfl_sync(kFull, cz, src);
    if (lane == 0) mbar_expect(&s.bar[parity], cl * kCandBytes);
    if (lane < cl) send(s, parity, rank, lane, best, bz);
  }
  mbar_wait(&s.bar[parity], (it >> 1) & 1);
  // lane l takes slot l % CL: the CL <= 16 slots repeat in every group of CL lanes
  const uint4 c = s.cand[parity][lane & (cl - 1)];
  const float cz = s.cand_z[parity][lane & (cl - 1)];
  const unsigned bi = warp_argmax(c.x, c.y);
  const int src = __ffs(__ballot_sync(kFull, c.y == bi)) - 1;
  Winner w;
  w.far = static_cast<int>(bi);
  w.x = __uint_as_float(__shfl_sync(kFull, c.z, src));
  w.y = __uint_as_float(__shfl_sync(kFull, c.w, src));
  w.z = __shfl_sync(kFull, cz, src);
  return w;
}

// Sets up the exchange and returns the start point's winner record: the
// mbarriers initialised and, after a cluster barrier, visible to every peer.
__device__ __forceinline__ Winner begin(Slots& s, const float* cloud, int far) {
  if (threadIdx.x == 0) {
    mbar_init(&s.bar[0]);
    mbar_init(&s.bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  Winner w;
  w.far = far;
  w.x = cloud[3 * static_cast<size_t>(far)];
  w.y = cloud[3 * static_cast<size_t>(far) + 1];
  w.z = cloud[3 * static_cast<size_t>(far) + 2];
  cluster_sync();  // every peer has started and initialised before the first send
  return w;
}

using FpsKernel = void (*)(const float*, const int*, int*, float*, int, int, int);

// Register tier: the slice's coordinates and distances in registers.
template <int PPT>
__global__ void __launch_bounds__(kThreads, 1)
fps_reg_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int* __restrict__ out, float* /*scratch*/, int N, int npoint,
               int /*coords_in_smem*/) {
  __shared__ Slots s;
  const int t = threadIdx.x;
  const int cl = static_cast<int>(cluster_size());
  const unsigned rank = cluster_rank();
  const int b = blockIdx.x / cl;
  const int S = (N + cl - 1) / cl;
  const int lo = min(static_cast<int>(rank) * S, N);
  const int n_loc = min(S, N - lo);
  const float* cloud = xyz + static_cast<size_t>(b) * N * 3;
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int l = t + k * kThreads;
    const bool valid = l < n_loc;
    const size_t e = 3 * static_cast<size_t>(lo + (valid ? l : 0));
    px[k] = valid ? cloud[e] : 0.f;
    py[k] = valid ? cloud[e + 1] : 0.f;
    pz[k] = valid ? cloud[e + 2] : 0.f;
    // a point past the slice never wins: min(-inf, d) stays below every distance
    dist[k] = valid ? 1e10f : -__int_as_float(0x7f800000);
  }
  Winner w = begin(s, cloud, start[b]);

  int* row = out + static_cast<size_t>(b) * npoint;
  for (int it = 0;; ++it) {
    if (rank == 0 && t == 0) row[it] = w.far;
    if (it + 1 == npoint) break;
    float bv = -1.0f;  // every distance is >= 0, so any point of the slice beats it
    int bk = 0;
    float bx = 0.f, by = 0.f, bz = 0.f;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float dx = __fsub_rn(px[k], w.x);
      const float dy = __fsub_rn(py[k], w.y);
      const float dz = __fsub_rn(pz[k], w.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      dist[k] = fminf(dist[k], d);
      if (dist[k] > bv) {
        bv = dist[k];
        bk = k;
        bx = px[k];
        by = py[k];
        bz = pz[k];
      }
    }
    const bool none = bv < 0.f;
    w = exchange(s, none ? 0u : __float_as_uint(bv), none ? kNone : lo + t + bk * kThreads, bx,
                 by, bz, it, rank, cl);
  }
  cluster_sync();  // every candidate sent to this CTA has landed before any CTA exits
}

// Loop tier: any slice size, the distances in scratch, the coordinates where
// the plan puts them.
__global__ void __launch_bounds__(kThreads, 1)
fps_loop_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                int* __restrict__ out, float* scratch, int N, int npoint, int coords_in_smem) {
  __shared__ Slots s;
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
  const int t = threadIdx.x;
  const int cl = static_cast<int>(cluster_size());
  const unsigned rank = cluster_rank();
  const int b = blockIdx.x / cl;
  const int S = (N + cl - 1) / cl;
  const int lo = min(static_cast<int>(rank) * S, N);
  const int n_loc = min(S, N - lo);
  const float* cloud = xyz + static_cast<size_t>(b) * N * 3;
  const float* pts = cloud + 3 * static_cast<size_t>(lo);
  if (coords_in_smem) {
    for (size_t e = t; e < 3 * static_cast<size_t>(n_loc); e += kThreads) dyn[e] = pts[e];
    pts = dyn;
  }
  float* dist = scratch + static_cast<size_t>(b) * N + lo;
  for (int l = t; l < n_loc; l += kThreads) dist[l] = 1e10f;  // each thread its own points
  // the shared copy is complete after begin's cluster barrier
  Winner w = begin(s, cloud, start[b]);

  int* row = out + static_cast<size_t>(b) * npoint;
  for (int it = 0;; ++it) {
    if (rank == 0 && t == 0) row[it] = w.far;
    if (it + 1 == npoint) break;
    float bv = -1.0f;
    int bl = 0;
    float bx = 0.f, by = 0.f, bz = 0.f;
    for (int l = t; l < n_loc; l += kThreads) {
      const float x = pts[3 * static_cast<size_t>(l)];
      const float y = pts[3 * static_cast<size_t>(l) + 1];
      const float z = pts[3 * static_cast<size_t>(l) + 2];
      const float dx = __fsub_rn(x, w.x);
      const float dy = __fsub_rn(y, w.y);
      const float dz = __fsub_rn(z, w.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float dd = fminf(dist[l], d);
      dist[l] = dd;
      if (dd > bv) {
        bv = dd;
        bl = l;
        bx = x;
        by = y;
        bz = z;
      }
    }
    const bool none = bv < 0.f;
    w = exchange(s, none ? 0u : __float_as_uint(bv), none ? kNone : lo + bl, bx, by, bz, it,
                 rank, cl);
  }
  cluster_sync();
}

struct Plan {
  int tier = kRegisters;
  int ppt = 0;
  size_t smem = 0;
  int scratch_per_cloud = 0;
  FpsKernel kernel = nullptr;
};

FpsKernel reg_kernel(int ppt) {
  switch (ppt) {
    case 1: return fps_reg_kernel<1>;
    case 2: return fps_reg_kernel<2>;
    case 4: return fps_reg_kernel<4>;
    case 8: return fps_reg_kernel<8>;
    case 16: return fps_reg_kernel<16>;
    default: return fps_reg_kernel<(kMaxRegPPT > 16 ? 32 : 16)>;
  }
}

Plan make_plan(int N, int cl) {
  Plan p;
  const size_t S = (static_cast<size_t>(N) + cl - 1) / cl;
  const size_t need = (S + kThreads - 1) / kThreads;
  if (need <= static_cast<size_t>(kMaxRegPPT)) {
    p.ppt = 1;
    while (static_cast<size_t>(p.ppt) < need) p.ppt *= 2;
    p.kernel = reg_kernel(p.ppt);
    return p;
  }
  p.kernel = fps_loop_kernel;
  p.scratch_per_cloud = N;
  if (12 * S <= kMaxDynamicSmem) {
    p.tier = kShared;
    p.smem = 12 * S;
  } else {
    p.tier = kDeviceMemory;
  }
  return p;
}

bool valid_cluster(int cl) { return cl == 1 || cl == 2 || cl == 4 || cl == 8 || cl == 16; }

// Sets, once per device, what any launch may need: a non-portable cluster
// of 16 CTAs for every instance, all the dynamic shared memory for the loop
// tier. So a launch sets no attribute.
cudaError_t prepare_device() {
  static std::mutex mu;
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (done[dev]) return cudaSuccess;
  for (int ppt = 1; ppt <= kMaxRegPPT; ppt *= 2) {
    err = cudaFuncSetAttribute(reg_kernel(ppt), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(fps_loop_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fps_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxDynamicSmem));
  if (err != cudaSuccess) return err;
  done[dev] = true;
  return cudaSuccess;
}

void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, const Plan& p, int B,
                   int cl, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cl);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

}  // namespace

// The launcher's plan for clouds of N points on clusters of `cluster` CTAs,
// on the current device. info receives {clusters of this size the card runs
// at once (cudaOccupancyMaxActiveClusters), threads a CTA, tier (0
// registers; 1 coordinates in shared memory, distances in scratch; 2 both
// in device memory), points a thread in registers, dynamic shared memory
// bytes, scratch floats a cloud}. Returns a cudaError_t (0 on success).
extern "C" int gennerf_fps_plan(int N, int cluster, int* info) {
  if (N <= 0 || !valid_cluster(cluster)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(N, cluster);
  cudaError_t err = prepare_device();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, p, 1, cluster, nullptr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, reinterpret_cast<const void*>(p.kernel), &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = active;
  info[1] = kThreads;
  info[2] = p.tier;
  info[3] = p.ppt;
  info[4] = static_cast<int>(p.smem);
  info[5] = p.scratch_per_cloud;
  return 0;
}

// xyz: (B, N, 3) f32 contiguous; start: (B,) int32; out: (B, npoint) int32;
// scratch: B * (the plan's scratch floats a cloud) f32, or null when that is 0;
// cluster: CTAs a cloud, one of 1, 2, 4, 8, 16. Returns a cudaError_t (0 on
// success): a launch the card refuses is reported, never retried smaller.
extern "C" int gennerf_fps(const void* xyz, const void* start, void* out, void* scratch, int B,
                           int N, int npoint, int cluster, void* stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || npoint > N || !valid_cluster(cluster)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(N, cluster);
  if (p.scratch_per_cloud && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare_device();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, p, B, cluster, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, p.kernel, static_cast<const float*>(xyz),
                           static_cast<const int*>(start), static_cast<int*>(out),
                           static_cast<float*>(scratch), N, npoint,
                           static_cast<int>(p.tier == kShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
