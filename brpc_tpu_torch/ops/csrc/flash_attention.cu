// flash_attn_fwd: blockwise online-softmax attention on Hopper's CUDA cores
// (sm_90a), register-tiled.
//
// Replaces: brpc_tpu/ops/flash_attention.py:104 `_flash_pallas_2d` (the
// repo's one Pallas TPU kernel), generalised to the parameters its lax
// twin `_flash_lax` (:66) already has: a per-head query offset (0 for
// flash_attention; lengths - 1 gives decode's mask, rows 0 .. lengths-1),
// a causal flag and a scale.
// Numerics follow `_online_softmax_step` (:34) and `_finalize` (:58):
// fp32 (m, l, o) per row, masked scores set to NEG_INF = -1e30 (not -inf)
// and their probabilities forced to 0, rows with l == 0 written as 0.
// Scores are kept in base-2 units (scale * log2 e folded into one
// multiply, then exp2f), which changes only the fp32 rounding.
//
// What bounds it on an H100. At long sequences (8 heads x 2048 x 64) it is
// bound by operations: 4 * sq * sk * d FLOPs in fp32 on the CUDA cores
// (67 TFLOP/s); TF32 stays off, so fp32 never takes the tensor cores and
// this is an FFMA kernel by design. What keeps an FFMA kernel from that
// peak is feeding it: an SM issues four warp-FFMAs a clock but serves one
// 128-byte shared-memory wavefront a clock, so operands must come from
// registers, and each shared load must feed many FMAs.
//
// Design.
// - Blocks of 64 query rows. A head's K/V (512 KB at 2048 x 64 fp32)
//   exceeds a block's 227 KB of shared memory, so K and V stream through
//   shared memory in tiles of 64 keys (32 at d 128); a 64-row block reads
//   its head's K/V sq/64 times.
// - Two key groups of 128 threads (4 warps) a block. Group g takes K/V
//   tiles g, g+2, g+4, ... with its own (m, l, o), its own two-stage ring
//   and P tile, and its own named barrier; at the end the second group
//   hands its (m, l, o) to the first through shared memory and they merge
//   as two online-softmax partials. A 4-warp block is bound by its own
//   latency (one alone on an SM ran no faster than two sharing it), so a
//   q tile's key range is split over 8 warps: under a causal mask the
//   heaviest q tiles, which set the end of the run, finish twice as fast.
// - Register tiles. Thread (ty, tx) = (t / 8, t % 8) of a group owns query
//   rows ty + 16 i (i < 4) and keys tx + 8 j of each tile: a 4 x 8 block
//   of S (4 x 4 at d 128), and columns (tx + 8 c) * 4 .. + 3 of the same
//   rows of O, fp32 registers. Both products read 16-byte vectors from
//   shared memory: S from q and k rows (4 + 8 float4 per 128 FFMAs), O from
//   P and v rows (4 + 8 float4 per 128 FFMAs), about one load per 10
//   FFMAs. The rows of q and k are padded by 4 floats and those of P by 8,
//   so the rows a warp reads at one column fall in distinct banks; v rows
//   are read whole by 8 lanes and need no pad. The q tile stays in shared
//   memory for the block's life.
// - Softmax between the two products: row max and row sum reduce over the
//   8 lanes of a row with __shfl_xor_sync; P goes through a padded shared
//   tile, written and read by the warp that owns its rows (a __syncwarp,
//   no barrier).
// - K/V ring. fp32 K and V tiles are copied by cp.async (16 B, .cg, rows
//   past sk zero-filled) into two stages a group: the group's next tile is
//   in flight while this one is used, with one group barrier per tile.
//   fp16/bf16 inputs (head dim 16/32 on the routing table) are loaded
//   through registers and converted to fp32 on the way in.
// - Causal work. A block stops at the last tile its last row can see (a
//   fully masked tile leaves (m, l, o) unchanged in the reference, so the
//   cut is exact); blocks launch heaviest q tile first (`causal_tile`,
//   tile_order.cuh); the mask arithmetic runs only on tiles that cross
//   the diagonal or the ragged end of the keys.
// - 77-185 KB of dynamic shared memory a block (d 16 to 128), one block
//   (8 warps) an SM at d 64/128; no register spills.
// The grid is (batch*heads, q tiles): bh on gridDim.x has no 65,535
// limit. The kernel allocates nothing and launches on the caller's
// stream; the C entry returns cudaGetLastError().
//
// Routing (ops/flash_attention.py `_plan`): this kernel takes fp32, and
// fp16/bf16 at head dim 16/32. fp16/bf16 at head dim 64/128 go to the
// tensor-core kernel (flash_attention_tc.cu), decode to flash_decode.cu.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tile_order.cuh"

namespace {

constexpr int kGroups = 2;                          // key groups a block
constexpr int kGroupThreads = 128;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kBQ = 64;                             // query rows per block
constexpr int kRowThreads = 8;                      // lanes sharing a row
constexpr int kRowGroups = kGroupThreads / kRowThreads;  // 16
constexpr int kRows = kBQ / kRowGroups;             // rows a thread owns
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Tile shapes and the shared-memory layout (in floats) for head dim D.
template <int D>
struct Tile {
  static constexpr int kBK = D == 128 ? 32 : 64;     // keys per K/V tile
  static constexpr int kKeys = kBK / kRowThreads;    // keys a thread scores
  static constexpr int kCols = D / kRowThreads;      // O columns a thread owns
  static constexpr int kVec = kCols < 4 ? kCols : 4; // floats a V/O vector
  static constexpr int kChunks = kCols / kVec;
  static constexpr int kQStride = D + 4;
  static constexpr int kKStride = D + 4;
  static constexpr int kVStride = D;
  static constexpr int kPStride = kBK + 8;
  // the q tile, then each key group's region: K and V stages, P
  static constexpr int kQFloats = kBQ * kQStride;
  static constexpr int kV = 2 * kBK * kKStride;      // offsets in a region
  static constexpr int kP = kV + 2 * kBK * kVStride;
  static constexpr int kGroupFloats = kP + kBQ * kPStride;
  static constexpr size_t kBytes =
      (kQFloats + kGroups * kGroupFloats) * sizeof(float);
  // the second group hands its (m, l, o) to the first through its region
  static_assert(kGroupThreads * kRows * (2 + kCols) <= kGroupFloats,
                "merge scratch");
};

__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows first .. first+ROWS-1 of a [*, D] operand into shared rows of
// STRIDE floats, rows at or past `limit` as zeros. fp32 goes by cp.async
// (complete after cp_async_wait_all); 16-bit through registers, converted.
// NT threads share the copy; `tid` is this one's index among them.
template <int D, int ROWS, int STRIDE, int NT, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int first,
                                          int limit, int tid) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kChunks = D / 4;
#pragma unroll 4
    for (int e = tid; e < ROWS * kChunks; e += NT) {
      const int r = e / kChunks, c = (e % kChunks) * 4;
      const bool ok = first + r < limit;
      const float* g =
          src + (ok ? static_cast<long long>(first + r) * D + c : 0);
      cp_async16(dst + r * STRIDE + c, g, ok);
    }
  } else {
    constexpr int kChunks = D / 8;
#pragma unroll 4
    for (int e = tid; e < ROWS * kChunks; e += NT) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (first + r < limit)
        raw = *reinterpret_cast<const uint4*>(
            src + static_cast<long long>(first + r) * D + c);
      const T* h = reinterpret_cast<const T*>(&raw);
      float* out = dst + r * STRIDE + c;
      *reinterpret_cast<float4*>(out) = make_float4(
          to_float(h[0]), to_float(h[1]), to_float(h[2]), to_float(h[3]));
      *reinterpret_cast<float4*>(out + 4) = make_float4(
          to_float(h[4]), to_float(h[5]), to_float(h[6]), to_float(h[7]));
    }
  }
}

// Reductions over the 8 consecutive lanes that share a query row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kRowThreads / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kRowThreads / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A barrier over one key group's threads (named barrier 1 + group).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kGroupThreads)
               : "memory");
}

// One K/V tile: S = q k^T on the thread's kRows x kKeys block, the online
// softmax update of (m, l, acc), P to shared memory, acc += P v.
// kMasked: the tile crosses the diagonal or the end of the keys.
template <int D, bool kMasked>
__device__ __forceinline__ void tile_step(
    const float* __restrict__ qs, const float* __restrict__ ks,
    const float* __restrict__ vs, float* __restrict__ ps, float (&m)[kRows],
    float (&l)[kRows], float (&acc)[kRows][Tile<D>::kCols], int ty, int tx,
    int k0, int sk, int q_pos0, int causal, float scale_log2) {
  using TL = Tile<D>;
  constexpr int kKeys = TL::kKeys;

  float s[kRows][kKeys];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    float4 qv[kRows], kv[kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      qv[i] = *reinterpret_cast<const float4*>(
          qs + (ty + kRowGroups * i) * TL::kQStride + c);
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      kv[j] = *reinterpret_cast<const float4*>(
          ks + (tx + kRowThreads * j) * TL::kKStride + c);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
      }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q_pos = q_pos0 + ty + kRowGroups * i;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float x = s[i][j] * scale_log2;
      if (kMasked) {
        const int k_pos = k0 + tx + kRowThreads * j;
        if (k_pos >= sk || (causal && k_pos > q_pos)) x = kNegInf;
      }
      s[i][j] = x;
      tile_max = fmaxf(tile_max, x);
    }
    const float m_new = fmaxf(m[i], row_max(tile_max));
    const float corr = exp2f(m[i] - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float p = exp2f(s[i][j] - m_new);
      if (kMasked) {
        const int k_pos = k0 + tx + kRowThreads * j;
        if (k_pos >= sk || (causal && k_pos > q_pos)) p = 0.f;
      }
      ps[(ty + kRowGroups * i) * TL::kPStride + tx + kRowThreads * j] = p;
      p_sum += p;
    }
    l[i] = l[i] * corr + row_sum(p_sum);
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < TL::kCols; ++c) acc[i][c] *= corr;
  }
  __syncwarp();   // a row's P is written and read by its own warp

#pragma unroll
  for (int j0 = 0; j0 < TL::kBK; j0 += 4) {
    float4 pv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      pv[i] = *reinterpret_cast<const float4*>(
          ps + (ty + kRowGroups * i) * TL::kPStride + j0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* vrow = vs + (j0 + jj) * TL::kVStride;
      float vv[TL::kCols];
#pragma unroll
      for (int cc = 0; cc < TL::kChunks; ++cc) {
        const float* src = vrow + (tx + kRowThreads * cc) * TL::kVec;
        if constexpr (TL::kVec == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          vv[4 * cc] = t.x;
          vv[4 * cc + 1] = t.y;
          vv[4 * cc + 2] = t.z;
          vv[4 * cc + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(src);
          vv[2 * cc] = t.x;
          vv[2 * cc + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = jj == 0 ? pv[i].x
                      : jj == 1 ? pv[i].y
                      : jj == 2 ? pv[i].z
                                : pv[i].w;
#pragma unroll
        for (int c = 0; c < TL::kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)   // one block (8 warps) an SM
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      const int* __restrict__ q_offset, int q_offset_add,
                      int sq, int sk, float scale_log2, int causal) {
  using TL = Tile<D>;
  constexpr int kBK = TL::kBK;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int group = tid / kGroupThreads;   // takes K/V tiles group, +kGroups..
  const int gtid = tid % kGroupThreads;
  const int ty = gtid / kRowThreads;
  const int tx = gtid % kRowThreads;
  float* qs = smem;
  float* region = smem + TL::kQFloats + group * TL::kGroupFloats;
  float* ks = region;                      // two stages of kBK x kKStride
  float* vs = region + TL::kV;             // two stages of kBK x kVStride
  float* ps = region + TL::kP;

  const int bh = blockIdx.x;
  const int q0 = causal_tile(blockIdx.y, gridDim.y, causal) * kBQ;
  const T* qh = q + static_cast<long long>(bh) * sq * D;
  const T* kh = k + static_cast<long long>(bh) * sk * D;
  const T* vh = v + static_cast<long long>(bh) * sk * D;
  const int offset = (q_offset != nullptr ? q_offset[bh] : 0) + q_offset_add;
  const int q_pos0 = offset + q0;   // the block's first row's position

  const int n_k = (sk + kBK - 1) / kBK;
  int n_vis = n_k;
  if (causal) {
    // the last key any row of this block can see decides the last tile
    const int last_pos = offset + min(q0 + kBQ, sq) - 1;
    n_vis = last_pos < 0 ? 0 : min((last_pos + kBK) / kBK, n_k);
  }

  load_rows<D, kBQ, TL::kQStride, kThreads>(qs, qh, q0, sq, tid);
  if (group < n_vis) {
    load_rows<D, kBK, TL::kKStride, kGroupThreads>(ks, kh, group * kBK, sk,
                                                   gtid);
    load_rows<D, kBK, TL::kVStride, kGroupThreads>(vs, vh, group * kBK, sk,
                                                   gtid);
  }
  cp_async_commit();

  float m[kRows], l[kRows], acc[kRows][TL::kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TL::kCols; ++c) acc[i][c] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();   // q and each group's first tile have landed

  // Each group walks its own tiles with its own (m, l, acc) and its own
  // ring: it copies its next tile into the other stage, uses this one,
  // then waits for the copy and meets at its barrier, after which every
  // thread of the group is done with this stage.
  for (int kt = group, st = 0; kt < n_vis; kt += kGroups, st ^= 1) {
    if (kt + kGroups < n_vis) {
      const int next = (kt + kGroups) * kBK;
      load_rows<D, kBK, TL::kKStride, kGroupThreads>(
          ks + (st ^ 1) * kBK * TL::kKStride, kh, next, sk, gtid);
      load_rows<D, kBK, TL::kVStride, kGroupThreads>(
          vs + (st ^ 1) * kBK * TL::kVStride, vh, next, sk, gtid);
    }
    cp_async_commit();
    const int k0 = kt * kBK;
    const float* kst = ks + st * kBK * TL::kKStride;
    const float* vst = vs + st * kBK * TL::kVStride;
    if (k0 + kBK > sk || (causal && k0 + kBK - 1 > q_pos0))
      tile_step<D, true>(qs, kst, vst, ps, m, l, acc, ty, tx, k0, sk, q_pos0,
                         causal, scale_log2);
    else
      tile_step<D, false>(qs, kst, vst, ps, m, l, acc, ty, tx, k0, sk,
                          q_pos0, causal, scale_log2);
    cp_async_wait_all();
    group_sync(group);
  }

  // merge the second group's (m, l, acc) into the first's, as two
  // online-softmax partials: weights exp2(m_g - max); a group that saw
  // no key has l = 0 and acc = 0 and adds nothing
  __syncthreads();   // both groups are done with their regions
  float* x = smem + TL::kQFloats + TL::kGroupFloats;
  constexpr int kPer = 2 + TL::kCols;
  if (group == 1) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float* xi = x + i * kPer * kGroupThreads + gtid;
      xi[0] = m[i];
      xi[kGroupThreads] = l[i];
#pragma unroll
      for (int c = 0; c < TL::kCols; ++c)
        xi[(2 + c) * kGroupThreads] = acc[i][c];
    }
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float* xi = x + i * kPer * kGroupThreads + gtid;
    const float m_new = fmaxf(m[i], xi[0]);
    const float w0 = exp2f(m[i] - m_new);
    const float w1 = exp2f(xi[0] - m_new);
    l[i] = l[i] * w0 + xi[kGroupThreads] * w1;
#pragma unroll
    for (int c = 0; c < TL::kCols; ++c)
      acc[i][c] = acc[i][c] * w0 + xi[(2 + c) * kGroupThreads] * w1;
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kRowGroups * i;
    if (row >= sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* out = o + (static_cast<long long>(bh) * sq + row) * D;
#pragma unroll
    for (int cc = 0; cc < TL::kChunks; ++cc)
#pragma unroll
      for (int w = 0; w < TL::kVec; ++w)
        out[(tx + kRowThreads * cc) * TL::kVec + w] =
            from_float<T>(acc[i][cc * TL::kVec + w] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     const int* q_offset, int q_offset_add, int bh, int sq,
                     int sk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t kBytes = Tile<D>::kBytes;
  auto kernel = flash_attn_fwd_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), q_offset, q_offset_add,
      sq, sk, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* q_offset, int q_offset_add, int bh, int sq,
                   int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_d<T, 16>(q, k, v, o, q_offset, q_offset_add, bh, sq, sk,
                             scale, causal, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, o, q_offset, q_offset_add, bh, sq, sk,
                             scale, causal, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, o, q_offset, q_offset_add, bh, sq, sk,
                             scale, causal, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, q_offset, q_offset_add, bh, sq, sk,
                              scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [bh, sq, d], k and v [bh, sk, d], o [bh, sq, d], all contiguous,
// 16-byte aligned and of one dtype (0 fp32, 1 fp16, 2 bf16). q_offset:
// null, or int32 [bh] on the device; row r of head b sits at position
// q_offset[b] + q_offset_add + r. Returns 0 or the CUDA error of the launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, const void* q_offset, int q_offset_add,
                              int bh, int sq, int sk, int d, float scale,
                              int causal, int dtype, void* stream) {
  const int* qo = static_cast<const int*>(q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, qo, q_offset_add, bh, sq, sk, d, scale,
                           causal, s);
    case 1:
      return launch<__half>(q, k, v, o, qo, q_offset_add, bh, sq, sk, d, scale,
                            causal, s);
    case 2:
      return launch<__nv_bfloat16>(q, k, v, o, qo, q_offset_add, bh, sq, sk, d,
                                   scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
