// flash_attn_fwd_tc: blockwise online-softmax attention on Hopper's tensor
// cores (sm_90a), fp16 and bf16, head dim 16, 32, 64 or 128.
//
// Replaces: brpc_tpu/ops/flash_attention.py:104 `_flash_pallas_2d` (inner
// `kernel` :116-156): softmax(q k^T * scale) v per batch*head, padding mask
// k_pos < sk, optional causal mask k_pos <= q_pos aligned top-left (with
// flash_attn_fwd's per-head q_offset), fp32 (m, l, o), masked scores
// NEG_INF = -1e30 with probability 0, fully masked rows 0, output in q's
// dtype. It keeps the C signature of flash_attn_fwd (flash_attention.cu),
// which takes fp32 (ops/flash_attention.py `_plan` routes).
//
// What bounds it on an H100. At 8 heads x 2048 it does 4 sq sk d FLOPs
// (half under a causal mask) on 4 sq d 16-bit values of q/k/v/o: at d 64
// 8.6 GFLOP on 8.4 MB, bound by operations (8.7 us at 989 TFLOP/s; the
// bytes 2.5 us). The softmax takes one exponential a score, 33.5 M: at
// the special-function rate of 3.9 T/s (FA3 paper, Shah et al. 2024) that
// is 8.6 us whatever d is, so at d 16/32 the exponentials, not the
// products, bound it, and at d 64 the two are equal. A design that runs
// the softmax and the products one after the other cannot reach half its
// bound at d <= 64; only wgmma reaches the tensor cores' rate.
//
// Design (the warp-specialised shape of a Hopper GEMM):
// - A block owns 64 query rows of one head: one consumer warpgroup and one
//   producer warp. Small blocks let two share an SM, so one block's
//   softmax also overlaps the other's wgmma, and a grid of about one wave
//   (8 heads x 2048) still fills the SMs and balances under a causal mask.
// - The producer's lane 0 issues TMA loads: the q tile once, then K and V
//   tiles of BK keys into rings of kStages stages (3, and 2 at d 128, so
//   that two blocks fit an SM). K and V have full and empty mbarriers of
//   their own: a K stage is free once S of its tile is done, a V stage once
//   P V is. Loads go out in the order the consumers take them (K0, K1, V0,
//   K2, V1, ...).
// - Tensor maps are 3-D (d, s, batch*heads), so the ragged last tile of a
//   head is zero-filled by the TMA unit and never reads the next head's
//   rows. A row of a tile is min(d, 64) columns: 32, 64 or 128 bytes, and
//   it lands with the swizzle of that width (d 128 is two panels of 64
//   columns), the layout the wgmma descriptors name (`desc`).
// - S = Q K^T: wgmma m64nBKk16, A = the q tile and B = the K tile, both
//   K-major from shared memory, d/16 steps, fp32 accumulators. BK is 128
//   (`tile_keys`): an n128 S reads 6 KB of shared memory a step for twice
//   the work of an n64 step's 4 KB.
// - Online softmax on the accumulator fragment: a thread holds two rows
//   (r, r+8) and a row is spread over a quad of lanes, so the row max takes
//   two __shfl_xor_sync steps; the row sum stays per thread until the end.
//   The max is taken on the raw scores and each probability is one FFMA
//   and one ex2.approx: exp2(s * scale log2 e - m * scale log2 e). A masked
//   score is NEG_INF; a row that has seen only masked keys takes its
//   exponentials against 0, so those probabilities are 0.
// - O += P V: P is rounded to the input dtype in registers, where the
//   accumulator layout of S is the A-fragment layout of a register-A wgmma
//   (m64nDk16, one per panel of 64 columns at d 128). B is the V tile
//   [keys, d], d contiguous, read MN-major through the transpose bit.
// - The overlap: tile kt's S is issued, then tile kt-1's P V, and the
//   warpgroup waits only for S (wgmma.wait_group 1); its softmax then runs
//   on the CUDA cores and the special-function unit while the tensor cores
//   do P V, and O is rescaled once P V has landed. P lives in two register
//   buffers used in turns (the loop is unrolled by two): had the softmax
//   written the registers an in-flight P V reads, ptxas would serialise
//   every wgmma (C7513), which cost more than the overlap gained.
// - Causal: the block stops at the last K tile its last row can see
//   (exact: a fully masked tile leaves (m, l, o) unchanged). The q tiles
//   launch heaviest first (`causal_tile`, tile_order.cuh), which pays
//   where the grid spans several waves. batch*heads is gridDim.x.
// - Output: a masked 4-byte store per pair of columns; rows >= sq are
//   never written.
// Variants timed against this design at chip_smoke.py's shapes, and lost
// (`python3 -m brpc_tpu_torch.ops.kernel_ab`, PERF.md section 6): the
// softmax between the two products with no overlap; 64-key S tiles; two
// or four stages; S of the next tile issued before the softmax (two S
// buffers of 64 keys); q in registers for S (ptxas caps the 5-warp block
// at 168 registers and spills); 128-row blocks of two consumer warpgroups
// sharing each K/V tile, in lockstep or ordered in turns on named
// barriers ("ping-pong", a producer warpgroup and setmaxnreg); no
// producer warp; 128-key tiles at d 128 without the causal mask.
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

constexpr int kBQ = 64;                   // query rows a block
constexpr int kConsumerWarps = 4;         // one warpgroup
constexpr int kThreads = (kConsumerWarps + 1) * 32;   // + the producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Keys a tile: 128 (S is m64n128) except at d 128 without the causal mask,
// where the 64-key tile's registers and shared memory let two blocks share
// an SM; under the mask, where the heaviest q tiles set the run's length,
// the 128-key tile wins (PERF.md section 6, kernel_ab).
template <int D>
constexpr int tile_keys(int causal) {
  return D == 128 && !causal ? 64 : 128;
}

template <int D, int BK>
struct Cfg {
  static constexpr int kCols = D < 64 ? D : 64;    // columns a panel
  static constexpr int kRowBytes = 2 * kCols;      // 32, 64 or 128
  static constexpr int kPanels = D / kCols;
  static constexpr int kQPanelBytes = 64 * kRowBytes;
  static constexpr int kKVPanelBytes = BK * kRowBytes;
  static constexpr int kQBytes = kPanels * kQPanelBytes;
  static constexpr int kTileBytes = kPanels * kKVPanelBytes;   // K or V
  // stages of the K and V rings: 3, and 2 at d 128 so that two blocks fit
  // an SM's shared memory (at d 128 with 128-key tiles the registers allow
  // one); 3 beat 4 at d 16/32 by 3-7% and 2 at d 64 (PERF.md section 6)
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kMinBlocks = D == 128 && BK == 128 ? 1 : 2;
  static constexpr int kBarrierBytes = 8 * (1 + 4 * kStages);
  // + 1024 to align the tiles to the swizzle's period
  static constexpr int kSmemBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + kBarrierBytes;
  static_assert(kQPanelBytes % 1024 == 0 && kKVPanelBytes % 1024 == 0,
                "tiles must stay on 1024-byte boundaries");
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

// Shared-memory matrix descriptor of a tile that TMA wrote with the swizzle
// of its row width (32, 64 or 128 bytes): start address >> 4 (bits 0-13);
// leading byte offset (bits 16-29), unused by a K-major operand whose K
// step stays inside a row and by an MN-major operand one swizzle row wide;
// stride byte offset (bits 32-45), from one group of 8 rows to the next,
// 8 x the row bytes; layout (bits 62-63) 1 for the 128-byte swizzle, 2
// for 64, 3 for 32 (CuTe's GmmaDescriptor, make_gmma_desc). The tiles sit
// on 1024-byte boundaries, so the base offset (bits 49-51) is 0; a K step
// of 16 elements inside a row moves the start address by 32 bytes.
template <int RowBytes>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t layout = RowBytes == 128 ? 1 : RowBytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * RowBytes) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operand
// registers across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define BRPC_ACC8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define BRPC_ACC16                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15}"
#define BRPC_ACC32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
  "%28, %29, %30, %31}"
#define BRPC_ACC64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "      \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "      \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define BRPC_F4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define BRPC_F8(c, i) BRPC_F4(c, i), BRPC_F4(c, i + 4)
#define BRPC_F16(c, i) BRPC_F8(c, i), BRPC_F8(c, i + 8)
#define BRPC_F32(c, i) BRPC_F16(c, i), BRPC_F16(c, i + 16)
#define BRPC_F64(c) BRPC_F32(c, 0), BRPC_F32(c, 32)

// wgmma with fp32 accumulators for one 16-bit input type, overloaded on
// the accumulator's size (N / 2 registers a thread for m64nN):
// mma_ss: S tiles, m64n64k16 or m64n128k16, A and B from shared memory,
//   both K-major, accumulating into d; mma_ss0 overwrites d, which is then
//   no input of the wgmma, so the softmax may rewrite S while another
//   wgmma is in flight.
// mma_rs: P V, m64n16k16, m64n32k16 or m64n64k16, A from registers (4 x 2
//   elements a thread), B from shared memory MN-major (transpose bit set);
//   accumulates into d.
#define BRPC_SS(NAME, NK, ACC, OPS, A, B, SD, SCALE, TYPE, PTX)             \
  __device__ __forceinline__ void NAME(float (&d)[NK / 2], uint64_t da,    \
                                       uint64_t db, const TYPE*) {         \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, " SD ", 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n" #NK "k16.f32." PTX "." PTX " "   \
        ACC ", " A ", " B ", p, 1, 1, 0, 0;\n}\n"                          \
        : OPS                                                              \
        : "l"(da), "l"(db), "n"(SCALE));                                   \
  }
#define BRPC_RS(NK, ACC, OPS, A, B, SD, TYPE, PTX)                         \
  __device__ __forceinline__ void mma_rs(float (&d)[NK / 2],               \
                                         const uint32_t (&a)[4],           \
                                         uint64_t db, const TYPE*) {       \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, " SD ", 0;\n"                     \
        "wgmma.mma_async.sync.aligned.m64n" #NK "k16.f32." PTX "." PTX " "   \
        ACC ", " A ", " B ", p, 1, 1, 1;\n}\n"                             \
        : OPS                                                              \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));    \
  }
#define BRPC_DEFINE_MMA(TYPE, PTX)                                          \
  BRPC_SS(mma_ss, 64, BRPC_ACC32, BRPC_F32("+f", 0), "%32", "%33", "%34",   \
          1, TYPE, PTX)                                                     \
  BRPC_SS(mma_ss0, 64, BRPC_ACC32, BRPC_F32("=f", 0), "%32", "%33", "%34",  \
          0, TYPE, PTX)                                                     \
  BRPC_SS(mma_ss, 128, BRPC_ACC64, BRPC_F64("+f"), "%64", "%65", "%66", 1,  \
          TYPE, PTX)                                                        \
  BRPC_SS(mma_ss0, 128, BRPC_ACC64, BRPC_F64("=f"), "%64", "%65", "%66", 0, \
          TYPE, PTX)                                                        \
  BRPC_RS(16, BRPC_ACC8, BRPC_F8("+f", 0), "{%8, %9, %10, %11}", "%12",     \
          "%13", TYPE, PTX)                                                 \
  BRPC_RS(32, BRPC_ACC16, BRPC_F16("+f", 0), "{%16, %17, %18, %19}", "%20", \
          "%21", TYPE, PTX)                                                 \
  BRPC_RS(64, BRPC_ACC32, BRPC_F32("+f", 0), "{%32, %33, %34, %35}", "%36", \
          "%37", TYPE, PTX)

BRPC_DEFINE_MMA(__nv_bfloat16, "bf16")
BRPC_DEFINE_MMA(__half, "f16")
#undef BRPC_DEFINE_MMA
#undef BRPC_SS
#undef BRPC_RS

__device__ __forceinline__ uint32_t pack2(float lo, float hi,
                                          const __nv_bfloat16*) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, const __half*) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K tiles of `bk` keys a row range can see: all of them, or under the
// causal mask up to the one holding key `last_pos`.
__device__ __forceinline__ int visible_tiles(int last_pos, int n_k, int bk,
                                             int causal) {
  if (!causal) return n_k;
  return last_pos < 0 ? 0 : min((last_pos + bk) / bk, n_k);
}

// One consumer thread's rows: (m, l) of rows a and b (m on raw scores),
// and what masks them.
struct Rows {
  float m_a, m_b, l_a, l_b;
  int pos_a, pos_b, first_pos, quad, sk, causal;
  float scale_log2;
};

// The online-softmax step of one S tile: masks, updates (m, l), writes P
// rounded to T as register A fragments (pa[kc]: keys 16 kc .. 16 kc + 15)
// and returns the factors that rescale O. sc[4i + e]: row (e < 2 ? a : b),
// key k0 + 8 i + 2 quad + (e & 1).
template <typename T, int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], int k0,
                                             Rows& w,
                                             uint32_t (&pa)[BK / 16][4],
                                             float& corr_a, float& corr_b) {
  const T* tag = nullptr;
  const bool edge =
      k0 + BK > w.sk || (w.causal && k0 + BK - 1 > w.first_pos);
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + 2 * w.quad + (e & 1);
        if (key >= w.sk || (w.causal && key > (e < 2 ? w.pos_a : w.pos_b)))
          sc[4 * i + e] = kNegInf;
      }
  }
  float mx_a = w.m_a, mx_b = w.m_b;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  corr_a = ex2((w.m_a - mx_a) * w.scale_log2);
  corr_b = ex2((w.m_b - mx_b) * w.scale_log2);
  // a row that has seen only masked keys: every probability is 0
  const float ref_a = mx_a == kNegInf ? 0.f : mx_a * w.scale_log2;
  const float ref_b = mx_b == kNegInf ? 0.f : mx_b * w.scale_log2;
  w.m_a = mx_a;
  w.m_b = mx_b;
  float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    float p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool a = (j & 2) == 0;
      p[j] = ex2(fmaf(sc[8 * kc + j], w.scale_log2, a ? -ref_a : -ref_b));
      if (a)
        ps_a += p[j];
      else
        ps_b += p[j];
    }
    pa[kc][0] = pack2(p[0], p[1], tag);
    pa[kc][1] = pack2(p[2], p[3], tag);
    pa[kc][2] = pack2(p[4], p[5], tag);
    pa[kc][3] = pack2(p[6], p[7], tag);
  }
  w.l_a = w.l_a * corr_a + ps_a;   // per-thread part; quads sum at the end
  w.l_b = w.l_b * corr_b + ps_b;
}

// ----------------------------------------------------------------- kernel

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads, (Cfg<D, BK>::kMinBlocks))
flash_attn_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         T* __restrict__ o, const int* __restrict__ q_offset,
                         int q_offset_add, int sq, int sk, float scale_log2,
                         int causal) {
  using C = Cfg<D, BK>;
  constexpr int S = C::kStages;
  constexpr int RB = C::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_smem = q_smem + C::kQBytes;
  const uint32_t v_smem = k_smem + S * C::kTileBytes;
  const uint32_t q_bar = v_smem + S * C::kTileBytes;
  const uint32_t k_full = q_bar + 8;           // + 8 s for stage s
  const uint32_t k_empty = k_full + 8 * S;
  const uint32_t v_full = k_empty + 8 * S;
  const uint32_t v_empty = v_full + 8 * S;

  const int bh = blockIdx.x;
  const int q0 = causal_tile(blockIdx.y, gridDim.y, causal) * kBQ;
  const int offset = (q_offset != nullptr ? q_offset[bh] : 0) + q_offset_add;
  const int n_k = (sk + BK - 1) / BK;
  const int n_vis =
      visible_tiles(offset + min(q0 + kBQ, sq) - 1, n_k, BK, causal);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumerWarps);
      mbar_init(v_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one thread keeps the ring full, in the order the
    // consumers take the tiles: K0, then K(i) and V(i-1)
    if (lane == 0) {
      mbar_expect_tx(q_bar, C::kQBytes);
      for (int p = 0; p < C::kPanels; ++p)
        tma_load_3d(q_smem + p * C::kQPanelBytes, &tm_q, q_bar, p * C::kCols,
                    q0, bh);
      auto load = [&](const CUtensorMap* map, uint32_t tiles, uint32_t full,
                      uint32_t empty, int t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + 8 * s, (t / S - 1) & 1);
        mbar_expect_tx(full + 8 * s, C::kTileBytes);
        for (int p = 0; p < C::kPanels; ++p)
          tma_load_3d(tiles + s * C::kTileBytes + p * C::kKVPanelBytes, map,
                      full + 8 * s, p * C::kCols, t * BK, bh);
      };
      for (int i = 0; i <= n_vis; ++i) {
        if (i < n_vis) load(&tm_k, k_smem, k_full, k_empty, i);
        if (i > 0) load(&tm_v, v_smem, v_full, v_empty, i - 1);
      }
    }
    return;
  }

  // ---- consumers: the warpgroup owns query rows q0 .. q0 + 63
  const int r = warp * 16 + lane / 4;         // row in the block's 64
  const int row_a = q0 + r;                   // this thread's two rows
  const int row_b = row_a + 8;
  Rows w{kNegInf, kNegInf, 0.f, 0.f, offset + row_a, offset + row_b,
         offset + q0, lane % 4, sk, causal, scale_log2};
  const T* tag = nullptr;

  float acc[C::kPanels][C::kCols / 2];
#pragma unroll
  for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < C::kCols / 2; ++i) acc[p][i] = 0.f;

  // S = Q K^T of tile t into sc, issued and committed
  float sc[BK / 2];
  auto issue_s = [&](int t) {
    const uint32_t k_tile = k_smem + (t % S) * C::kTileBytes;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      // columns 16 kc ..: panel 32 kc / RB, 32 kc % RB bytes into a row
      const int panel = kc * 32 / RB, in_row = kc * 32 % RB;
      const uint64_t da =
          desc<RB>(q_smem + panel * C::kQPanelBytes + in_row);
      const uint64_t db =
          desc<RB>(k_tile + panel * C::kKVPanelBytes + in_row);
      if (kc == 0)
        mma_ss0(sc, da, db, tag);
      else
        mma_ss(sc, da, db, tag);
    }
    wgmma_commit();
  };
  // O += P V of tile t, issued and committed
  auto issue_pv = [&](const uint32_t (&p_frag)[BK / 16][4], int t) {
    const uint32_t v_tile = v_smem + (t % S) * C::kTileBytes;
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        mma_rs(acc[p], p_frag[kc],
               desc<RB>(v_tile + p * C::kKVPanelBytes + kc * 16 * RB), tag);
    wgmma_commit();
  };
  auto release = [&](uint32_t empty, int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % S));
  };
  auto rescale = [&](float corr_a, float corr_b) {
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
      for (int i = 0; i < C::kCols / 2; ++i)
        acc[p][i] *= (i & 2) ? corr_b : corr_a;
  };

  // the last P V: O += P V of tile n_vis - 1
  auto last_pv = [&](uint32_t (&p_frag)[BK / 16][4]) {
    const int last = n_vis - 1;
    mbar_wait(v_full + 8 * (last % S), (last / S) & 1);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) fence_regs(acc[p]);
    fence_regs(p_frag);
    wgmma_fence();
    issue_pv(p_frag, last);
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) fence_regs(acc[p]);
    release(v_empty, last);
  };
  // one K tile: S of tile kt and P V of tile kt-1 (P in `cur`); the
  // softmax of tile kt writes its P to `nxt`
  auto step = [&](int kt, uint32_t (&cur)[BK / 16][4],
                  uint32_t (&nxt)[BK / 16][4]) {
    const int s = kt % S, sp = (kt - 1) % S;
    float corr_a, corr_b;
    mbar_wait(k_full + 8 * s, (kt / S) & 1);
    // S of tile kt, then P V of tile kt-1; wait for S alone
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) fence_regs(acc[p]);
    fence_regs(cur);
    wgmma_fence();
    issue_s(kt);
    mbar_wait(v_full + 8 * sp, ((kt - 1) / S) & 1);
    wgmma_fence();
    issue_pv(cur, kt - 1);
    wgmma_wait<1>();
    fence_regs(sc);
    release(k_empty, kt);
    // the softmax of tile kt runs while the tensor cores do P V
    softmax_tile<T, BK>(sc, kt * BK, w, nxt, corr_a, corr_b);
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) fence_regs(acc[p]);
    fence_regs(cur);
    release(v_empty, kt - 1);
    rescale(corr_a, corr_b);
  };

  mbar_wait(q_bar, 0);
  if (n_vis > 0) {
    // two P buffers, used in turns, so that the softmax never writes the
    // registers an in-flight P V reads
    uint32_t pa[BK / 16][4], pb[BK / 16][4];
    float corr_a, corr_b;
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    release(k_empty, 0);
    softmax_tile<T, BK>(sc, 0, w, pa, corr_a, corr_b);
    int kt = 1;
    for (; kt + 1 < n_vis; kt += 2) {
      step(kt, pa, pb);
      step(kt + 1, pb, pa);
    }
    if (kt < n_vis) {
      step(kt, pa, pb);
      last_pv(pb);
    } else {
      last_pv(pa);
    }
  }

  const float l_a = quad_sum(w.l_a);
  const float l_b = quad_sum(w.l_b);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  T* out_a = o + (static_cast<long long>(bh) * sq + row_a) * D;
  T* out_b = out_a + 8 * D;
#pragma unroll
  for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < C::kCols / 8; ++i) {
      const int col = p * 64 + 8 * i + 2 * w.quad;
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

// A 3-D map over a contiguous [bh, rows, D] tensor, boxes of min(D, 64)
// columns x `box_rows` rows x 1 head, swizzled by the box's row width (32,
// 64 or 128 bytes); reads past `rows` give zeros.
template <int D>
bool make_map(CUtensorMap* map, EncodeTiledFn encode, const void* ptr,
              CUtensorMapDataType type, int bh, int rows, int box_rows) {
  constexpr int kCols = D < 64 ? D : 64;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      kCols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : kCols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  EncodeTiledFn encode;
  CUtensorMapDataType type;
  const void *q, *k, *v;
  void* o;
  const int* q_offset;
  int q_offset_add, bh, sq, sk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, int BK>
cudaError_t launch(const Args& a) {
  using C = Cfg<D, BK>;
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, a.encode, a.q, a.type, a.bh, a.sq, kBQ) ||
      !make_map<D>(&tk, a.encode, a.k, a.type, a.bh, a.sk, BK) ||
      !make_map<D>(&tv, a.encode, a.v, a.type, a.bh, a.sk, BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_attn_fwd_tc_kernel<T, D, BK>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.bh, (a.sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, C::kSmemBytes, a.stream>>>(
      tq, tk, tv, static_cast<T*>(a.o), a.q_offset, a.q_offset_add, a.sq,
      a.sk, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const Args& a) {
  return a.causal ? launch<T, D, tile_keys<D>(1)>(a)
                  : launch<T, D, tile_keys<D>(0)>(a);
}

template <typename T>
cudaError_t launch_t(int d, const Args& a) {
  switch (d) {
    case 16:
      return launch_d<T, 16>(a);
    case 32:
      return launch_d<T, 32>(a);
    case 64:
      return launch_d<T, 64>(a);
    default:
      return launch_d<T, 128>(a);
  }
}

}  // namespace

// The C signature of flash_attn_fwd: q [bh, sq, d], k and v [bh, sk, d],
// o [bh, sq, d], contiguous, 16-byte aligned, of one dtype (1 fp16,
// 2 bf16; 0 fp32 is refused), d 16, 32, 64 or 128. q_offset: null, or
// int32 [bh] on the device; row r of head b sits at position q_offset[b]
// + q_offset_add + r. Returns 0 or the CUDA error of the launch.
extern "C" int flash_attn_fwd_tc(const void* q, const void* k, const void* v,
                                 void* o, const void* q_offset,
                                 int q_offset_add, int bh, int sq, int sk,
                                 int d, float scale, int causal, int dtype,
                                 void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || (sq + kBQ - 1) / kBQ > 65535 ||
      (d != 16 && d != 32 && d != 64 && d != 128) ||
      (dtype != 1 && dtype != 2))
    return cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const Args a{encode,
               dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               q, k, v, o, static_cast<const int*>(q_offset), q_offset_add,
               bh, sq, sk, scale, causal, static_cast<cudaStream_t>(stream)};
  return dtype == 1 ? launch_t<__half>(d, a) : launch_t<__nv_bfloat16>(d, a);
}
