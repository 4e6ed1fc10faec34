// Tile machinery shared by the two ResnetFC decode kernels (grid_decode.cu,
// point_decode.cu), written for Hopper (sm_90a).
//
// A block is three warpgroups. Warpgroups 0 and 1 are consumers: they run
// every product with wgmma (m64n64k16, bf16 operands read from shared
// memory, f32 accumulators in registers) and every epilogue. Warpgroup 2 is
// the producer: it gives its registers to the consumers (setmaxnreg), and
// one of its threads streams the weight matrices, in the order the
// consumers use them, through a ring of kStages shared-memory stages with
// 1D bulk copies (cp.async.bulk), each stage guarded by a full and an empty
// mbarrier.
//
// A block decodes a tile of R points. At H <= 256, R = 128 and each
// consumer takes 64 rows and all H columns; at H = 512, R = 64 and the two
// consumers split the columns, meeting at a named barrier whenever one
// writes an activation buffer the other reads. Each consumer keeps its part
// of the residual stream in registers, in the wgmma accumulator layout (at
// most 64 rows x 256 columns, 128 f32 a thread). Each product runs in
// N-chunks of NC = 64 columns; a chunk's epilogue (bias, relu, the bf16
// round into the next product's A buffer, the residual add) runs on the
// chunk's accumulators in registers.
//
// Shared-memory operand layout (no swizzle, K-major, 8x8 core matrices of
// 16-byte rows). An operand of `rows` rows and depth K holds element (r, k)
// at byte
//     (k / 8) * rows * 16 + (r / 8) * 128 + (r % 8) * 16 + (k % 8) * 2,
// so its wgmma descriptor has LBO = rows * 16 (the next 8 of K) and
// SBO = 128 (the next 8 rows). Activation buffers hold the R rows of the
// tile. A weight slab holds KS rows of K (fewer in the last slab of a
// product whose depth KS does not divide) for each of the G column groups,
// group g's NC output columns of the current chunk stored as the operand's
// rows, the groups one after another. The host packs each product's matrix
// as its slabs in consumption order: chunk by chunk, slab by slab
// (ops/weight_slabs.py, whose `slab_address` mirrors this layout).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace gennerf {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                        // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;     // + the producer warpgroup
constexpr int kStages = 4;                           // weight ring stages
constexpr int kSlabBytes = 16384;                    // one stage
constexpr int kNC = 64;                              // product N-chunk (wgmma n)
constexpr int kBarrierBytes = 1024;                  // mbarriers + head partials
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int H>
struct Tile {
  static_assert(H == 128 || H == 256 || H == 512, "H must be 128, 256 or 512");
  static constexpr int G = H > 256 ? 2 : 1;          // column groups
  static constexpr int R = H > 256 ? 64 : 128;       // points per block
  static constexpr int CW = H / G;                   // columns a consumer owns
  static constexpr int CHUNKS = CW / kNC;
  static constexpr int KS = kSlabBytes / (kNC * G * 2);  // slab depth
  static constexpr int XR = CW / 2;                  // residual registers a thread
  static constexpr uint32_t A_LBO = R * 16;
  static constexpr uint32_t B_LBO = kNC * 16;
  static constexpr int ACT_BYTES = R * H * 2;
  // shared memory: barriers, the ring, then two activation buffers
  static constexpr int RING_OFF = kBarrierBytes;
  static constexpr int A1_OFF = RING_OFF + kStages * kSlabBytes;
  static constexpr int A2_OFF = A1_OFF + ACT_BYTES;
  static constexpr int END = A2_OFF + ACT_BYTES;
};

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// makes this thread's shared-memory stores visible to later wgmma reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching accumulators across an async wgmma
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// no-swizzle shared-memory matrix descriptor (layout type 0)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d(64x64, f32) = A(64x16, bf16, K-major) B(16x64, bf16, K-major) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// a compile-time int usable in device code
template <int I>
struct CInt {
  __host__ __device__ constexpr operator int() const { return I; }
};

template <class F, int... Is>
__device__ __forceinline__ void static_for_impl(F&& f, std::integer_sequence<int, Is...>) {
  (f(CInt<Is>{}), ...);
}

// f(CInt<0>) ... f(CInt<N - 1>)
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// ---- the weight ring ---------------------------------------------------------

struct Ring {
  uint32_t full, empty, data;  // shared addresses of full[0], empty[0], stage 0
  int stage = 0;
  uint32_t phase = 0;

  __device__ explicit Ring(unsigned char* smem)
      : full(smem_u32(smem)), empty(smem_u32(smem) + 8 * kStages),
        data(smem_u32(smem) + kBarrierBytes) {}

  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// one thread, before the roles split
__device__ __forceinline__ void ring_init(const Ring& ring) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(ring.full + 8 * s, 1);
    mbar_init(ring.empty + 8 * s, kConsumers * 4);  // one arrive per consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer thread: streams `n_products` packed matrices, product p of
// depth depth(p), slab by slab into the ring.
template <int H, class Depth>
__device__ __forceinline__ void produce(Ring& ring, const bf16* __restrict__ slabs, int n_products,
                                        Depth depth) {
  using T = Tile<H>;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(slabs);
  for (int p = 0; p < n_products; ++p) {
    const int K = depth(p);
    for (int c = 0; c < T::CHUNKS; ++c) {
      for (int k0 = 0; k0 < K; k0 += T::KS) {
        const uint32_t bytes = static_cast<uint32_t>(min(T::KS, K - k0)) * kNC * T::G * 2;
        mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1);
        mbar_expect_tx(ring.full + 8 * ring.stage, bytes);
        bulk_copy_g2s(ring.data + ring.stage * kSlabBytes, src, bytes, ring.full + 8 * ring.stage);
        src += bytes;
        ring.advance();
      }
    }
  }
}

// ---- a consumer thread's place in the tile -----------------------------------

template <int H>
struct Frag {
  using T = Tile<H>;
  int wg, warp, lane;  // consumer warpgroup, warp in it, lane
  int row0, col0, cg;  // first tile row and column this warpgroup owns, column group
  int sbase;           // byte offset of this thread's bf16 pair in an activation buffer

  __device__ explicit Frag(int t) : wg(t >> 7), warp((t >> 5) & 3), lane(t & 31) {
    row0 = T::G == 1 ? 64 * wg : 0;
    cg = T::G == 1 ? 0 : wg;
    col0 = cg * T::CW;
    sbase = ((row0 + 16 * warp) / 8) * 128 + (lane >> 2) * 16 + (lane & 3) * 4;
  }
  // tile row of accumulator rows rr = 0, 1 (registers with (i / 2) % 2 == rr)
  __device__ __forceinline__ int row(int rr) const {
    return row0 + 16 * warp + (lane >> 2) + 8 * rr;
  }
  // column of accumulator registers 4 j + {0,1} (and 4 j + {2,3}) of chunk c
  __device__ __forceinline__ int col(int c, int j) const {
    return col0 + c * kNC + 8 * j + 2 * (lane & 3);
  }
  // stores bf16(v0), bf16(v1) at (row(rr), col(c, j)), (row(rr), col(c, j) + 1)
  // of an activation buffer
  __device__ __forceinline__ void store_pair(unsigned char* buf, int c, int j, int rr, float v0,
                                             float v1) const {
    const int off = sbase + ((col0 + c * kNC) / 8 + j) * (T::R * 16) + rr * 128;
    *reinterpret_cast<__nv_bfloat162*>(buf + off) = __floats2bfloat162_rn(v0, v1);
  }
};

// After this consumer's stores to an activation buffer: the stores are made
// visible to wgmma, and every consumer that reads the buffer waits for them.
template <int H>
__device__ __forceinline__ void sync_activations(int wg) {
  fence_proxy_async();
  if constexpr (Tile<H>::G == 1) {
    named_barrier(2 + wg, 128);
  } else {
    named_barrier(1, kConsumers * 128);
  }
}

__device__ __forceinline__ void sync_consumers() { named_barrier(1, kConsumers * 128); }

// One product over the ring's next slabs: for each N-chunk c (a compile-time
// constant), acc(64 x 64) = A(this warpgroup's 64 rows, K) @ W(K, the
// chunk's columns), then epi(c, acc). `a` is the A buffer's shared address
// (its rows at stride 128 per 8, its K at stride A_LBO per 8); K is a
// multiple of 16.
template <int H, class Epi>
__device__ __forceinline__ void tile_product(Ring& ring, const Frag<H>& f, uint32_t a, int K,
                                             Epi&& epi) {
  using T = Tile<H>;
  const uint32_t a_rows = a + (f.row0 / 8) * 128;
  static_for<T::CHUNKS>([&](auto c) {
    float acc[32];
    int last = -1;
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += T::KS) {
      const int ks = min(T::KS, K - k0);
      mbar_wait(ring.full + 8 * ring.stage, ring.phase);
      const uint32_t b = ring.data + ring.stage * kSlabBytes + f.cg * ks * kNC * 2;
      wgmma_fence();
      fence_acc(acc);
      for (int kk = 0; kk < ks; kk += 16) {
        wgmma_m64n64k16(acc, smem_desc(a_rows + ((k0 + kk) / 8) * T::A_LBO, T::A_LBO, 128),
                        smem_desc(b + (kk / 8) * T::B_LBO, T::B_LBO, 128), k0 + kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (last >= 0 && f.lane == 0) mbar_arrive(ring.empty + 8 * last);
      last = ring.stage;
      ring.advance();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (f.lane == 0) mbar_arrive(ring.empty + 8 * last);
    epi(c, acc);
  });
}

// The folded lin_out . head over the residual stream x held in registers:
// out[p0 + r] = tanh(bf16(relu(x_r)) . bf16 w_last + b_last) * smoothing,
// f32 sums; rows with valid(r) false are not stored. At G = 2 the second
// consumer's partial sums reach the first through shared memory.
template <int H, class Valid>
__device__ __forceinline__ void tile_head(const Frag<H>& f, const float (&x)[Tile<H>::XR],
                                          const bf16* __restrict__ w_last, float b_last,
                                          float smoothing, float* partial,
                                          float* __restrict__ out, long long p0, Valid valid) {
  using T = Tile<H>;
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < T::CHUNKS; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 w2 = *reinterpret_cast<const __nv_bfloat162*>(w_last + f.col(c, j));
      const float w0 = __low2float(w2), w1 = __high2float(w2);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = c * 32 + 4 * j + 2 * rr;
        s[rr] += __bfloat162float(__float2bfloat16_rn(fmaxf(x[i], 0.0f))) * w0;
        s[rr] += __bfloat162float(__float2bfloat16_rn(fmaxf(x[i + 1], 0.0f))) * w1;
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    s[rr] += __shfl_xor_sync(0xffffffffu, s[rr], 1);
    s[rr] += __shfl_xor_sync(0xffffffffu, s[rr], 2);
  }
  if constexpr (T::G == 2) {
    if (f.wg == 1 && (f.lane & 3) == 0) {
      partial[f.row(0)] = s[0];
      partial[f.row(1)] = s[1];
    }
    sync_consumers();
    if (f.wg == 1) return;
    s[0] += partial[f.row(0)];
    s[1] += partial[f.row(1)];
  }
  if ((f.lane & 3) == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = f.row(rr);
      if (valid(r)) out[p0 + r] = tanhf(s[rr] + b_last) * smoothing;
    }
  }
}

}  // namespace gennerf
