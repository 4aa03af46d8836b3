// flash_attn_fwd_tc: blockwise online-softmax attention on Hopper's tensor
// cores (sm_90a), fp16 and bf16, head dim 64 or 128.
//
// Replaces: brpc_tpu/ops/flash_attention.py:104 `_flash_pallas_2d` (inner
// `kernel` :116-156): softmax(q k^T * scale) v per batch*head, padding mask
// k_pos < sk, optional causal mask k_pos <= q_pos aligned top-left (with
// flash_attn_fwd's per-head q_offset), fp32 (m, l, o), masked scores NEG_INF = -1e30
// with probability 0, fully masked rows 0, output in q's dtype. It keeps
// the C signature of flash_attn_fwd (flash_attention.cu), which still takes
// fp32 and head dim 16/32 (ops/flash_attention.py `_plan` routes).
//
// What bounds it on an H100. At 8 heads x 2048 x 64 it does 4 sq sk d =
// 8.6 GFLOP (half under a causal mask) on 8.4 MB of bf16 q/k/v/o: bound by
// operations, 8.7 us at 989 TFLOP/s. A kernel that converts to fp32 and
// runs FMAs on the CUDA cores (flash_attention.cu) cannot get near that;
// only wgmma reaches the tensor cores' rate.
//
// Design (the warp-specialised shape of a Hopper GEMM):
// - A block owns 64 query rows of one head: one consumer warpgroup and one
//   producer warp. Small blocks let up to four share an SM, so one block's
//   softmax overlaps another's wgmma, and a grid of one wave or less (8
//   heads x 2048) still fills the SMs and balances under a causal mask.
//   BRPC_TC_WARPGROUPS=2 builds blocks of 128 rows (two warpgroups share
//   each K/V tile); ops/kernel_ab.py times the two shapes (128 rows
//   won only where the grid spans several waves, non-causal, by ~1%).
// - The producer's lane 0 issues TMA loads: the q tile once, then K and V
//   tiles of 64 keys into a ring of kStages shared-memory stages, each
//   stage guarded by a full/empty mbarrier pair. It waits on a stage's
//   empty barrier (all 4 consumer warps arrived) before it overwrites it.
// - The tensor maps are 3-D (d, s, batch*heads), so the ragged last tile
//   of a head is zero-filled by the TMA unit and never reads the next
//   head's rows. Tiles land with the 128-byte swizzle in panels of 64
//   columns (128-byte rows), the layout the wgmma descriptors name.
// - S = Q K^T: wgmma m64n64k16, A = the warpgroup's q panel and B = the K
//   tile, both K-major from shared memory, fp32 accumulators in registers.
// - Online softmax on the accumulator fragment: a thread holds two rows
//   (r, r+8) and a row is spread over a quad of lanes, so row max and row
//   sum take two __shfl_xor_sync steps. Scores are pre-scaled by log2 e and
//   exponentiated with exp2f. A masked score is NEG_INF; where a row has
//   seen nothing but masked keys its max is NEG_INF and exp2 is taken
//   against 0 instead, so those probabilities are 0, as the reference
//   forces them.
// - O += P V: P is converted to the input dtype in registers, where the
//   accumulator layout of S is the A-fragment layout of a register-A wgmma.
//   B is the V tile [keys, d]; d is contiguous, so B is MN-major and the
//   instruction's transpose bit for B reads it in place. Each 64-column
//   panel of O is its own m64n64 accumulator.
// - Causal: the block stops at the last K tile its last row can see
//   (exact: a fully masked tile leaves (m, l, o) unchanged). The q tiles
//   launch heaviest first (`causal_tile`, tile_order.cuh), which pays
//   where the grid spans several waves. batch*heads is gridDim.x.
// - Shared memory: the q tile (8/16 KB a warpgroup) and 2 stages of 16 KB
//   (d 64) or 32 KB (d 128): 42 or 81 KB with one warpgroup, so 4 (d 64)
//   or 2 (d 128) blocks fit on an SM, as many as the registers allow.
// - Output: a masked 4-byte store per pair of columns; rows >= sq are
//   never written.
// The tensor maps are encoded by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda. The
// kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_order.cuh"

namespace {

// Consumer warpgroups a block, 64 query rows each. The library is built
// with 1; ops/kernel_ab.py builds 2 beside it to time the two shapes.
#ifndef BRPC_TC_WARPGROUPS
#define BRPC_TC_WARPGROUPS 1
#endif
constexpr int kWarpgroups = BRPC_TC_WARPGROUPS;
constexpr int kBQ = 64 * kWarpgroups;     // query rows a block
constexpr int kBK = 64;                   // keys a K/V tile
constexpr int kConsumerWarps = 4 * kWarpgroups;
constexpr int kThreads = (kConsumerWarps + 1) * 32;   // + the producer warp
constexpr int kPanelBytes = 64 * 128;     // 64 rows of 64 16-bit columns
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = 2;
  static constexpr int kMinBlocks = (D == 64 ? 4 : 2) / kWarpgroups;
  static constexpr int kQBytes = kWarpgroups * kPanels * kPanelBytes;
  static constexpr int kTileBytes = kPanels * kPanelBytes;   // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarrierBytes = 8 * (1 + 2 * kStages);
  // + 1024 to align the tiles to the swizzle's 1024-byte period
  static constexpr int kSmemBytes =
      1024 + kQBytes + kStages * kStageBytes + kBarrierBytes;
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spins until the phase of `parity` has completed. A barrier that never
// completes (a lost load, a miscounted arrival) traps after about 4 s, so
// the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  uint64_t t0 = 0;
  do {
    if ((polls++ & 0xFFFFu) == 0xFFFFu) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 4000000000ull)
        __trap();
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a tile written by TMA with the
// 128-byte swizzle: start address >> 4 (bits 0-13); leading byte offset
// (bits 16-29), unused by a K-major operand within one 128-byte row and by
// an MN-major operand of 64 columns; stride byte offset 1024 (bits 32-45),
// from one group of 8 rows of 128 bytes to the next; layout 128-byte
// swizzle (bits 62-63 = 1). The tiles sit on 1024-byte boundaries, so the
// base offset (bits 49-51) is 0; a K step of 16 elements inside a row
// moves the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define BRPC_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define BRPC_D32_OPERANDS(d)                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// wgmma m64n64k16 with fp32 accumulators for one 16-bit input type:
// ss: A and B from shared memory, both K-major; scale_d = 0 overwrites d.
// rs: A from registers (4 x 2 elements a thread), B from shared memory
//     MN-major (transpose bit set); accumulates into d.
#define BRPC_DEFINE_MMA(TYPE, PTX)                                          \
  __device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,       \
                                         uint64_t db, int scale_d,          \
                                         const TYPE*) {                     \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " " BRPC_D32 \
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                   \
        : BRPC_D32_OPERANDS(d)                                              \
        : "l"(da), "l"(db), "r"(scale_d));                                  \
  }                                                                         \
  __device__ __forceinline__ void mma_rs(float (&d)[32],                    \
                                         const uint32_t (&a)[4],            \
                                         uint64_t db, const TYPE*) {        \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " " BRPC_D32 \
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                     \
        : BRPC_D32_OPERANDS(d)                                              \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));     \
  }

BRPC_DEFINE_MMA(__nv_bfloat16, "bf16")
BRPC_DEFINE_MMA(__half, "f16")
#undef BRPC_DEFINE_MMA

__device__ __forceinline__ uint32_t pack2(float lo, float hi,
                                          const __nv_bfloat16*) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, const __half*) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K tiles a row range can see: all of them, or under the causal mask up to
// the one holding key `last_pos`.
__device__ __forceinline__ int visible_tiles(int last_pos, int n_k,
                                             int causal) {
  if (!causal) return n_k;
  return last_pos < 0 ? 0 : min((last_pos + kBK) / kBK, n_k);
}

// ----------------------------------------------------------------- kernel

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
flash_attn_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         T* __restrict__ o, const int* __restrict__ q_offset,
                         int q_offset_add, int sq, int sk, float scale_log2,
                         int causal) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_smem = q_smem + C::kQBytes;
  const uint32_t q_bar = kv_smem + C::kStages * C::kStageBytes;
  const uint32_t full_bar0 = q_bar + 8;
  const uint32_t empty_bar0 = full_bar0 + 8 * C::kStages;

  const int bh = blockIdx.x;
  const int q0 = causal_tile(blockIdx.y, gridDim.y, causal) * kBQ;
  const int offset = (q_offset != nullptr ? q_offset[bh] : 0) + q_offset_add;
  const int n_k = (sk + kBK - 1) / kBK;
  const int n_vis =
      visible_tiles(offset + min(q0 + kBQ, sq) - 1, n_k, causal);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full_bar0 + 8 * s, 1);
      mbar_init(empty_bar0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one thread keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(q_bar, C::kQBytes);
      for (int g = 0; g < kWarpgroups; ++g)
        for (int p = 0; p < C::kPanels; ++p)
          tma_load_3d(q_smem + (g * C::kPanels + p) * kPanelBytes, &tm_q,
                      q_bar, p * 64, q0 + 64 * g, bh);
      for (int kt = 0; kt < n_vis; ++kt) {
        const int s = kt % C::kStages;
        if (kt >= C::kStages)
          mbar_wait(empty_bar0 + 8 * s, (kt / C::kStages - 1) & 1);
        const uint32_t full = full_bar0 + 8 * s;
        const uint32_t k_tile = kv_smem + s * C::kStageBytes;
        mbar_expect_tx(full, C::kStageBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_3d(k_tile + p * kPanelBytes, &tm_k, full, p * 64,
                      kt * kBK, bh);
          tma_load_3d(k_tile + C::kTileBytes + p * kPanelBytes, &tm_v, full,
                      p * 64, kt * kBK, bh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g owns query rows q0 + 64 g .. + 63
  const int g0 = 64 * (warp / 4);             // the warpgroup's first row
  const uint32_t q_wg = q_smem + (warp / 4) * C::kPanels * kPanelBytes;
  const int r = (warp % 4) * 16 + lane / 4;   // row in the warpgroup's 64
  const int quad = lane % 4;
  const int row_a = q0 + g0 + r;              // this thread's two rows
  const int row_b = row_a + 8;
  const int pos_a = offset + row_a;
  const int pos_b = offset + row_b;
  const int first_pos = offset + q0 + g0;
  const T* tag = nullptr;

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[C::kPanels][32];
#pragma unroll
  for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int kt = 0; kt < n_vis; ++kt) {
    const int s = kt % C::kStages;
    mbar_wait(full_bar0 + 8 * s, (kt / C::kStages) & 1);
    const uint32_t k_tile = kv_smem + s * C::kStageBytes;
    const uint32_t v_tile = k_tile + C::kTileBytes;

    // S = Q K^T over D/16 steps of 16 columns
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t off = (kc / 4) * kPanelBytes + (kc % 4) * 32;
      mma_ss(sc, desc_sw128(q_wg + off), desc_sw128(k_tile + off),
             kc > 0, tag);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale, mask, row max. sc[4i + e]: row (e < 2 ? a : b), key
    // k0 + 8 i + 2 quad + (e & 1)
    const int k0 = kt * kBK;
    const bool edge =
        k0 + kBK > sk || (causal && k0 + kBK - 1 > first_pos);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * i + 2 * quad + (e & 1);
          if (key >= sk || (causal && key > (e < 2 ? pos_a : pos_b)))
            x = kNegInf;
        }
        sc[4 * i + e] = x;
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_b = fmaxf(mx_b, x);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float corr_a = exp2f(m_a - mn_a);
    const float corr_b = exp2f(m_b - mn_b);
    // a row that has seen only masked keys: every probability is 0
    const float ref_a = mn_a == kNegInf ? 0.f : mn_a;
    const float ref_b = mn_b == kNegInf ? 0.f : mn_b;
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * i + e] - (e < 2 ? ref_a : ref_b));
        sc[4 * i + e] = p;
        if (e < 2)
          ps_a += p;
        else
          ps_b += p;
      }
    l_a = l_a * corr_a + ps_a;   // per-thread part; quads sum at the end
    l_b = l_b * corr_b + ps_b;
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= (i & 2) ? corr_b : corr_a;

    // P as the A fragment of keys 16 kc .. 16 kc + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      pa[kc][0] = pack2(sc[8 * kc + 0], sc[8 * kc + 1], tag);
      pa[kc][1] = pack2(sc[8 * kc + 2], sc[8 * kc + 3], tag);
      pa[kc][2] = pack2(sc[8 * kc + 4], sc[8 * kc + 5], tag);
      pa[kc][3] = pack2(sc[8 * kc + 6], sc[8 * kc + 7], tag);
    }

    // O += P V, one m64n64 accumulator per 64-column panel of V
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        mma_rs(acc[p], pa[kc],
               desc_sw128(v_tile + p * kPanelBytes + kc * 16 * 128), tag);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) fence_regs(acc[p]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar0 + 8 * s);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  T* out_a = o + (static_cast<long long>(bh) * sq + row_a) * D;
  T* out_b = out_a + 8 * D;
#pragma unroll
  for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = p * 64 + 8 * i + 2 * quad;
      if (row_a < sq)
        *reinterpret_cast<uint32_t*>(out_a + col) = pack2(
            acc[p][4 * i] * inv_a, acc[p][4 * i + 1] * inv_a, tag);
      if (row_b < sq)
        *reinterpret_cast<uint32_t*>(out_b + col) = pack2(
            acc[p][4 * i + 2] * inv_b, acc[p][4 * i + 3] * inv_b, tag);
    }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous [bh, rows, d] tensor, boxes of 64 columns x
// 64 rows x 1 head, 128-byte swizzle; reads past `rows` give zeros.
bool make_map(CUtensorMap* map, EncodeTiledFn encode, const void* ptr,
              CUtensorMapDataType type, int bh, int rows, int d) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, const int* q_offset,
                   int q_offset_add, int bh, int sq, int sk, float scale,
                   int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = flash_attn_fwd_tc_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<T*>(o), q_offset, q_offset_add, sq, sk,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace

// The C signature of flash_attn_fwd: q [bh, sq, d], k and v [bh, sk, d],
// o [bh, sq, d], contiguous, 16-byte aligned, of one dtype (1 fp16,
// 2 bf16; 0 fp32 is refused), d 64 or 128. q_offset: null, or int32 [bh] on
// the device; row r of head b sits at position q_offset[b] + q_offset_add
// + r. Returns 0 or the CUDA error of the launch.
extern "C" int flash_attn_fwd_tc(const void* q, const void* k, const void* v,
                                 void* o, const void* q_offset,
                                 int q_offset_add, int bh, int sq, int sk,
                                 int d, float scale, int causal, int dtype,
                                 void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || (sq + kBQ - 1) / kBQ > 65535 ||
      (d != 64 && d != 128) || (dtype != 1 && dtype != 2))
    return cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const CUtensorMapDataType type = dtype == 1
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, q, type, bh, sq, d) ||
      !make_map(&tk, encode, k, type, bh, sk, d) ||
      !make_map(&tv, encode, v, type, bh, sk, d))
    return cudaErrorInvalidValue;
  const int* qo = static_cast<const int*>(q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return d == 64 ? launch<__half, 64>(tq, tk, tv, o, qo, q_offset_add, bh,
                                        sq, sk, scale, causal, s)
                   : launch<__half, 128>(tq, tk, tv, o, qo, q_offset_add,
                                         bh, sq, sk, scale, causal, s);
  return d == 64 ? launch<__nv_bfloat16, 64>(tq, tk, tv, o, qo, q_offset_add,
                                             bh, sq, sk, scale, causal, s)
                 : launch<__nv_bfloat16, 128>(tq, tk, tv, o, qo,
                                              q_offset_add, bh, sq, sk, scale,
                                              causal, s);
}
