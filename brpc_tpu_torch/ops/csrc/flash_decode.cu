// flash_decode: single-query attention over per-sequence KV caches, the
// decode step of the serving path, for Hopper (sm_90a). One launch for
// every decode call, split or not.
//
// Replaces: brpc_tpu/ops/flash_attention.py:104 `_flash_pallas_2d` on the
// path of `decode_attention` (:221), which runs the same online-softmax
// recurrence (`_flash_lax`, :66) with q_offset = lengths - 1: for sequence
// b only cache rows 0 .. lengths[b]-1 are visible, whatever the tail
// holds. Numerics follow `_online_softmax_step` (:34) and `_finalize`
// (:58): fp32 (m, l, o), masked scores NEG_INF = -1e30 with probability 0,
// a length-0 sequence gives zeros in q's dtype. Inputs fp32, fp16 or bf16;
// head dim 16, 32, 64 or 128. lengths are read here, on the device: no
// host sync.
//
// What bounds it on an H100. A decode step reads each valid K and V row
// once: 3.6 MB at the long-cache case (4 sequences of a 4096-row bf16 d 128
// cache, lengths 0/1/4096/3000), 1.1 us at 3.35 TB/s; at the serving shape
// (8 sequences, a 160-row fp32 cache, d 32) 0.1 us. Neither is reachable
// by one launch: an empty kernel takes 1.7-1.9 us back to back
// (`torch.cuda._sleep(0)`), and a block waits on dependent memory round
// trips, the length, then its rows, then, split, the merge's three. So the
// design cuts launches and round trips (times: ops/kernel_ab.py on an
// NVIDIA H100 80GB HBM3 at 700 W, L2 warm, against the two-launch version
// that this one replaces):
//
// 1. The merge is in the kernel. With more than one live block a block
//    writes its (m, l, o) to a small fp32 scratch; one thread publishes
//    it and takes a ticket on the sequence's int32 counter in one
//    acq_rel atomic. The block that draws the last ticket merges the
//    sequence's partials in block order 0..live-1 (never in arrival
//    order, so a result does not change from run to run), all its loads
//    in flight at once, writes out[b] and sets the counter back to 0, so
//    the next launch on the stream, or a graph replay, finds it zero. The
//    wrapper keeps scratch and counters per (device, stream), zeroed once
//    when made. With one live block (one block a sequence, the serving
//    shape; or a short sequence) the block writes out[b] itself: no
//    ticket, no scratch. The merge's round trips (the partial's stores
//    acknowledged, the ticket, the partials' loads) cost 1.3-2.3 us (a
//    build without the merge took 4.4-4.7 us at the long-cache case)
//    against the second launch's 3.2: the long-cache case takes 6.0-6.1
//    us against the two launches' 7.4-7.8.
// 2. The split follows the valid rows. The host picks `splits` blocks per
//    sequence from the shapes alone, about one block an SM over the grid
//    (two an SM, or a grid that is not a multiple of the SMs, measured
//    slower: 6.8-7.5 us); here sequence b uses only
//    live = min(splits, ceil(len / min_rows)) of them and cuts its rows
//    evenly among them (decode_rows.cuh). Blocks past `live` exit at once.
// 3. Each lane issues the 16-byte K and V loads of its 8 keys before it
//    uses any, so a block's whole share (at most 128 rows at the long-cache
//    case, 160 at the serving shape) is one burst of loads in flight. A
//    key row is scored by a group of D*sizeof(T)/16 lanes, a warp scores
//    32/group rows at a time, the block's 8 warps side by side; a lane
//    group keeps its (m, l, o) in registers in log2 units (exp2 of scores
//    pre-scaled by log2 e). Groups merge by warp shuffles and warps
//    through shared memory once, at the end. Staging the rows instead by
//    1-D bulk copies (cp.async.bulk onto an mbarrier, a two-stage ring of
//    16 KB of K and of V a stage) was slower at every shape measured with
//    one block an SM, by 0.04-0.3 us at the serving shape and 0.08-1.0 us
//    at the long-cache, full-cache and 128 KB ones, and is not used. With
//    one block a sequence the cut skips decode_rows' divisions, which
//    sit between the length's load and the first row's (0.3-0.5 us at
//    the serving shape).
//
// Every merge weights a partial by (l > 0 ? exp2(m - max) : 0), so
// exp(NEG_INF - NEG_INF) = 1 never reaches l. batch*heads is gridDim.x (no
// 65,535 limit). The kernel allocates nothing and launches on the caller's
// stream; the C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_rows.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;                 // keys a lane loads before use
constexpr int kMaxSplits = 128;            // blocks a sequence, at most
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Cfg {
  static constexpr int kVec = 16 / sizeof(T);          // elements a load
  static constexpr int kGroup = D / kVec;               // lanes a key row
  static constexpr int kKeysPerWarp = 32 / kGroup;
  static constexpr int kKeysPerStep = kWarps * kKeysPerWarp;
  static_assert(kGroup >= 2 && kGroup <= 32 && 32 % kGroup == 0,
                "a key row must span 2..32 lanes");
  static_assert((kMaxSplits * D / 4) % kThreads == 0,
                "the merge's float4 loads fill whole rounds");
};

// ------------------------------------------------------------ PTX helpers

// *p += 1 at gpu scope, acquire and release; returns the old value
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(reinterpret_cast<uint64_t>(p))
               : "memory");
  return old;
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// 16 loaded bytes as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4],
                                       const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8],
                                       const __half*) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8],
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
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

// Grid (batch*heads, splits), kThreads threads. Block (b, split) takes the
// rows decode_rows gives it. With one live block for b it writes out[b];
// otherwise it writes its (m, l) in log2 units to
// part[B*splits*D + 2*(b*splits + split)] and its unnormalised o to
// part[(b*splits + split)*D], and the last of b's live blocks to take a
// ticket on tickets[b] merges them into out[b].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ tickets, int L, int min_rows,
                    float scale_log2) {
  using C = Cfg<T, D>;
  __shared__ float warp_m[kWarps];
  __shared__ float warp_l[kWarps];
  __shared__ float warp_o[kWarps][D];
  __shared__ float weight[kMaxSplits];
  __shared__ float4 quad_sum[kThreads];
  __shared__ float merged_l;
  __shared__ int ticket;

  const int b = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = lane / C::kGroup;
  const int col = (lane % C::kGroup) * C::kVec;   // this lane's first column

  const int len = min(max(lengths[b], 0), L);
  float qv[C::kVec];
  unpack(load16(q + static_cast<long long>(b) * D + col), qv,
         static_cast<const T*>(nullptr));
  // one block a sequence (the serving shape): the cut without its
  // divisions, which are on the path to the first load
  const DecodeRows cut = splits == 1 ? DecodeRows{len > 0, 0, len}
                                     : decode_rows(len, splits, min_rows,
                                                   split);
  if (cut.rows == 0) {
    // a block past the live ones; with no row at all, block 0 writes zeros
    if (cut.live == 0 && split == 0)
      for (int c = tid; c < D; c += kThreads)
        out[static_cast<long long>(b) * D + c] = from_float<T>(0.f);
    return;
  }
#pragma unroll
  for (int e = 0; e < C::kVec; ++e) qv[e] *= scale_log2;

  const long long row0 = static_cast<long long>(b) * L + cut.first;
  float m = kNegInf, l = 0.f;
  float acc[C::kVec];
#pragma unroll
  for (int e = 0; e < C::kVec; ++e) acc[e] = 0.f;
  for (int base = warp * C::kKeysPerWarp; base < cut.rows;
       base += C::kKeysPerStep * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + group + u * C::kKeysPerStep;
      ok[u] = key < cut.rows;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        const long long off = (row0 + key) * D + col;
        kr[u] = load16(k + off);
        vr[u] = load16(v + off);
      }
    }
    float s[kUnroll];
    float tile_max = kNegInf;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[C::kVec];
      unpack(kr[u], kf, static_cast<const T*>(nullptr));
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < C::kVec; ++e) dot = fmaf(qv[e], kf[e], dot);
#pragma unroll
      for (int off = C::kGroup / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = ok[u] ? dot : kNegInf;
      tile_max = fmaxf(tile_max, s[u]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = exp2f(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < C::kVec; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = ok[u] ? exp2f(s[u] - m_new) : 0.f;
      float vf[C::kVec];
      unpack(vr[u], vf, static_cast<const T*>(nullptr));
      l += p;
#pragma unroll
      for (int e = 0; e < C::kVec; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    m = m_new;
  }

  // merge the lane groups of a warp: lanes `off` apart hold the same
  // columns of two groups
#pragma unroll
  for (int off = C::kGroup; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_n = fmaxf(m, m_o);
    const float a = l > 0.f ? exp2f(m - m_n) : 0.f;
    const float w = l_o > 0.f ? exp2f(m_o - m_n) : 0.f;
#pragma unroll
    for (int e = 0; e < C::kVec; ++e)
      acc[e] = acc[e] * a + __shfl_xor_sync(0xffffffffu, acc[e], off) * w;
    l = l * a + l_o * w;
    m = m_n;
  }
  if (group == 0) {
#pragma unroll
    for (int e = 0; e < C::kVec; ++e) warp_o[warp][col + e] = acc[e];
    if (col == 0) {
      warp_m[warp] = m;
      warp_l[warp] = l;
    }
  }
  __syncthreads();

  // merge the warps, one thread per column
  const long long slot = static_cast<long long>(b) * splits + split;
  float* part_ml = part + static_cast<long long>(gridDim.x) * splits * D;
  for (int c = tid; c < D; c += kThreads) {
    float m_max = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (warp_l[w] > 0.f) m_max = fmaxf(m_max, warp_m[w]);
    float l_sum = 0.f, o_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = warp_l[w] > 0.f ? exp2f(warp_m[w] - m_max) : 0.f;
      l_sum += wt * warp_l[w];
      o_sum += wt * warp_o[w][c];
    }
    if (cut.live == 1) {
      out[static_cast<long long>(b) * D + c] =
          from_float<T>(l_sum > 0.f ? o_sum / l_sum : 0.f);
    } else {
      part[slot * D + c] = o_sum;
      if (c == 0) {
        part_ml[slot * 2] = m_max;
        part_ml[slot * 2 + 1] = l_sum;
      }
    }
  }
  if (cut.live == 1) return;

  // the last of the sequence's live blocks to arrive merges. One thread
  // publishes the block's partial (written by the threads above, ordered
  // before it by the barrier) and takes a ticket in one acq_rel atomic,
  // which also makes the other blocks' partials visible to it
  __syncthreads();
  if (tid == 0) ticket = ticket_add(&tickets[b]);
  __syncthreads();
  if (ticket != cut.live - 1) return;

  // m and l of every live block (warp 0) and every thread's share of their
  // o, [live, D] as float4, all in flight at once; written by other SMs,
  // so read from L2 (__ldcg), not L1
  constexpr int kQuads = D / 4;                  // float4 columns
  constexpr int kLoads = kMaxSplits * kQuads / kThreads;
  const float2* ml = reinterpret_cast<const float2*>(
      part_ml + static_cast<long long>(b) * splits * 2);
  float2 mlj[kMaxSplits / 32];
  if (warp == 0) {
#pragma unroll
    for (int u = 0; u < kMaxSplits / 32; ++u) {
      const int j = lane + 32 * u;
      mlj[u] = j < cut.live ? __ldcg(ml + j) : make_float2(kNegInf, 0.f);
    }
  }
  const float4* src = reinterpret_cast<const float4*>(
      part + static_cast<long long>(b) * splits * D);
  const int n4 = cut.live * kQuads;
  float4 o4[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = u * kThreads + tid;
    o4[u] = i < n4 ? __ldcg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the weights: w_j = (l_j > 0 ? exp2(m_j - max m) : 0)
  if (warp == 0) {
    float m_max = kNegInf;
#pragma unroll
    for (int u = 0; u < kMaxSplits / 32; ++u)
      if (mlj[u].y > 0.f) m_max = fmaxf(m_max, mlj[u].x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, off));
    float l_sum = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxSplits / 32; ++u) {
      const float w = mlj[u].y > 0.f ? exp2f(mlj[u].x - m_max) : 0.f;
      if (lane + 32 * u < cut.live) weight[lane + 32 * u] = w;
      l_sum += w * mlj[u].y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l_sum += __shfl_xor_sync(0xffffffffu, l_sum, off);
    if (lane == 0) merged_l = l_sum;
  }
  __syncthreads();
  // thread tid holds column quad tid % kQuads of blocks tid / kQuads + u *
  // (kThreads / kQuads), u ascending: each sums its own in block order,
  // then the quad's kThreads / kQuads sums are added in order
  float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = u * kThreads + tid;
    if (i < n4) {
      const float w = weight[i / kQuads];
      acc4.x = fmaf(w, o4[u].x, acc4.x);
      acc4.y = fmaf(w, o4[u].y, acc4.y);
      acc4.z = fmaf(w, o4[u].z, acc4.z);
      acc4.w = fmaf(w, o4[u].w, acc4.w);
    }
  }
  quad_sum[tid] = acc4;
  __syncthreads();
  if (tid < kQuads) {
    float4 total = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int g = 0; g < kThreads / kQuads; ++g) {
      const float4 x = quad_sum[g * kQuads + tid];
      total.x += x.x;
      total.y += x.y;
      total.z += x.z;
      total.w += x.w;
    }
    const float inv = merged_l > 0.f ? 1.f / merged_l : 0.f;
    T* o = out + static_cast<long long>(b) * D + 4 * tid;
    o[0] = from_float<T>(total.x * inv);
    o[1] = from_float<T>(total.y * inv);
    o[2] = from_float<T>(total.z * inv);
    o[3] = from_float<T>(total.w * inv);
    if (tid == 0) tickets[b] = 0;
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* part,
                     int* tickets, int b, int L, int splits, int min_rows,
                     float scale, cudaStream_t stream) {
  flash_decode_kernel<T, D><<<dim3(b, splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part, tickets,
      L, min_rows, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int d, const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part, int* tickets,
                   int b, int L, int splits, int min_rows, float scale,
                   cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_d<T, 16>(q, k, v, lengths, out, part, tickets, b, L,
                             splits, min_rows, scale, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, lengths, out, part, tickets, b, L,
                             splits, min_rows, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, lengths, out, part, tickets, b, L,
                             splits, min_rows, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, lengths, out, part, tickets, b, L,
                              splits, min_rows, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [b, d], k and v [b, L, d], out [b, d]: contiguous, one dtype (0 fp32,
// 1 fp16, 2 bf16), 16-byte aligned; lengths int32 [b] on the device.
// `splits` blocks a sequence (1..128), each live one taking at least
// `min_rows` rows. With splits > 1, part holds at least b*splits*(d+2)
// fp32 and tickets b int32, all zero before the first launch on the
// stream (the kernel leaves them zero). Returns 0 or the CUDA error of the
// launch.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* part,
                            void* tickets, int b, int L, int d, int splits,
                            int min_rows, float scale, int dtype,
                            void* stream) {
  if (b <= 0 || L < 0 || splits < 1 || splits > kMaxSplits || min_rows < 1 ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  float* p = static_cast<float*>(part);
  int* t = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(d, q, k, v, len, out, p, t, b, L, splits,
                           min_rows, scale, s);
    case 1:
      return launch<__half>(d, q, k, v, len, out, p, t, b, L, splits,
                            min_rows, scale, s);
    case 2:
      return launch<__nv_bfloat16>(d, q, k, v, len, out, p, t, b, L, splits,
                                   min_rows, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
