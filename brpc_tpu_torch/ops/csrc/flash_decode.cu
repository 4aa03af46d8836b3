// flash_decode: single-query attention over per-sequence KV caches, the
// decode step of the serving path, for Hopper (sm_90a).
//
// Replaces: brpc_tpu/ops/flash_attention.py:104 `_flash_pallas_2d` on the
// path of `decode_attention` (:221), which runs the same online-softmax
// recurrence (`_flash_lax`, :66) with q_offset = lengths - 1: for sequence
// b only cache rows 0 .. lengths[b]-1 are visible, whatever the tail
// holds. Numerics follow `_online_softmax_step` (:34) and `_finalize`
// (:58): fp32 (m, l, o), masked scores NEG_INF = -1e30 with probability 0,
// a length-0 sequence gives zeros. Inputs fp32, fp16 or bf16; head dim 16,
// 32, 64 or 128. lengths are read here, on the device: no host sync.
//
// What bounds it on an H100. One decode step reads each valid K and V row
// once: at the serving shape (8 sequences, a 160-row fp32 cache, d 32) at
// most 327,680 bytes, 0.1 us at 3.35 TB/s. So the time is latency: the
// launch, and the chain of dependent loads inside a block. A design that
// walks the cache in tiles with a block-wide barrier between load and use
// pays one memory round trip per tile, in series.
//
// Design. No barrier inside the key loop. Each key row is read by a group
// of D*sizeof(T)/16 lanes with one 16-byte load each; a warp scores
// 32/group keys at a time, the block's 8 warps side by side, and each lane
// issues the loads of kUnroll keys before it uses any, so a block has
// kUnroll * 8 * 32/group rows in flight. A lane group keeps its own
// (m, l, o) in registers, in log2 units (exp2 of scores pre-scaled by
// log2 e). Groups merge by warp shuffles and warps through shared memory
// once, at the end. Where the cache is long and batch*heads small, the host
// (`_plan`) splits it over `splits` blocks per sequence (gridDim.y), from
// the shapes alone, so that the grid covers the 132 SMs; each split writes
// its (m, l, o) to scratch and flash_decode_combine merges them in a second
// launch. A split that lies past lengths[b] writes m = NEG_INF, l = 0,
// o = 0, and every merge weights a partial by (l > 0 ? exp(m - max) : 0),
// so exp(NEG_INF - NEG_INF) = 1 never reaches l. batch*heads is
// gridDim.x (no 65,535 limit). The kernel allocates nothing and launches
// on the caller's stream; the C entries return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;                 // keys a lane loads before use
constexpr int kCombineThreads = 256;
constexpr int kMaxSplits = 1024;           // combine's shared weights
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Grid (batch*heads, splits), kThreads threads. Split s covers cache rows
// [s*chunk, min((s+1)*chunk, lengths[b])). With splits == 1 the block
// writes out[b] itself; otherwise it writes its (m, l) in natural-log
// units to m_l[b][s] and its unnormalised o to o_part[b][s].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ m_l,
                    float* __restrict__ o_part, int L, int chunk,
                    float scale_log2) {
  constexpr int kVec = 16 / sizeof(T);          // elements per 16 bytes
  constexpr int kGroup = D / kVec;              // lanes per key row
  static_assert(kGroup >= 2 && kGroup <= 32 && 32 % kGroup == 0,
                "a key row must span 2..32 lanes");
  constexpr int kKeysPerWarp = 32 / kGroup;
  constexpr int kKeysPerStep = kWarps * kKeysPerWarp;

  __shared__ float warp_m[kWarps];
  __shared__ float warp_l[kWarps];
  __shared__ float warp_o[kWarps][D];

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = lane / kGroup;
  const int col = (lane % kGroup) * kVec;       // this lane's first column
  const int len = min(max(lengths[bh], 0), L);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const long long row0 = static_cast<long long>(bh) * L;

  float qv[kVec];
  unpack(load16(q + static_cast<long long>(bh) * D + col), qv,
         static_cast<const T*>(nullptr));
#pragma unroll
  for (int e = 0; e < kVec; ++e) qv[e] *= scale_log2;

  float m = kNegInf, l = 0.f;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  // the trip count depends on the warp only, so every shuffle below has
  // all 32 lanes
  for (int base = start + warp * kKeysPerWarp; base < end;
       base += kKeysPerStep * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + group + u * kKeysPerStep;
      ok[u] = key < end;
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
      float kf[kVec];
      unpack(kr[u], kf, static_cast<const T*>(nullptr));
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot = fmaf(qv[e], kf[e], dot);
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = ok[u] ? dot : kNegInf;
      tile_max = fmaxf(tile_max, s[u]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = exp2f(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = ok[u] ? exp2f(s[u] - m_new) : 0.f;
      float vf[kVec];
      unpack(vr[u], vf, static_cast<const T*>(nullptr));
      l += p;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    m = m_new;
  }

  // merge the lane groups of a warp: lanes `off` apart hold the same
  // columns of two groups
#pragma unroll
  for (int off = kGroup; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_n = fmaxf(m, m_o);
    const float a = l > 0.f ? exp2f(m - m_n) : 0.f;
    const float b = l_o > 0.f ? exp2f(m_o - m_n) : 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      acc[e] = acc[e] * a + __shfl_xor_sync(0xffffffffu, acc[e], off) * b;
    l = l * a + l_o * b;
    m = m_n;
  }
  if (group == 0) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) warp_o[warp][col + e] = acc[e];
    if (col == 0) {
      warp_m[warp] = m;
      warp_l[warp] = l;
    }
  }
  __syncthreads();

  // merge the warps, one thread per column
  for (int c = threadIdx.x; c < D; c += kThreads) {
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
    if (splits == 1) {
      out[static_cast<long long>(bh) * D + c] =
          from_float<T>(l_sum > 0.f ? o_sum / l_sum : 0.f);
    } else {
      const long long slot = static_cast<long long>(bh) * splits + split;
      o_part[slot * D + c] = o_sum;
      if (c == 0) {
        m_l[slot * 2] = l_sum > 0.f ? m_max * kLn2 : kNegInf;
        m_l[slot * 2 + 1] = l_sum;
      }
    }
  }
}

// Grid batch*heads: out[b] = sum_s w_s o_s / sum_s w_s l_s over the
// splits, w_s = (l_s > 0 ? exp(m_s - max m) : 0); 0 where nothing was seen.
// The splits are spread over the block's threads for the max and the
// weights, and kCombineThreads / d threads share a column of o, so no
// thread walks the splits alone.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const float* __restrict__ m_l,
                            const float* __restrict__ o_part,
                            T* __restrict__ out, int d, int splits) {
  constexpr int kWarpsC = kCombineThreads / 32;
  __shared__ float weight[kMaxSplits];
  __shared__ float red_m[kWarpsC];
  __shared__ float red_l[kWarpsC];
  const long long bh = blockIdx.x;
  const float* ml = m_l + bh * splits * 2;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  float m_max = kNegInf;
  for (int s = tid; s < splits; s += kCombineThreads)
    if (ml[2 * s + 1] > 0.f) m_max = fmaxf(m_max, ml[2 * s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, off));
  if (lane == 0) red_m[warp] = m_max;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarpsC; ++w) m_max = fmaxf(m_max, red_m[w]);

  float l_sum = 0.f;
  for (int s = tid; s < splits; s += kCombineThreads) {
    const float ls = ml[2 * s + 1];
    const float wt = ls > 0.f ? expf(ml[2 * s] - m_max) : 0.f;
    weight[s] = wt;
    l_sum += wt * ls;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l_sum += __shfl_xor_sync(0xffffffffu, l_sum, off);
  if (lane == 0) red_l[warp] = l_sum;
  __syncthreads();
  l_sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarpsC; ++w) l_sum += red_l[w];

  // d is a power of two <= 128: per_col lanes of one warp share column c
  const int per_col = kCombineThreads / d;
  const int c = tid / per_col;
  float o_sum = 0.f;
#pragma unroll 8
  for (int s = tid % per_col; s < splits; s += per_col)
    o_sum += weight[s] * o_part[(bh * splits + s) * d + c];
  for (int off = per_col / 2; off > 0; off >>= 1)
    o_sum += __shfl_xor_sync(0xffffffffu, o_sum, off);
  if (tid % per_col == 0)
    out[bh * d + c] = from_float<T>(l_sum > 0.f ? o_sum / l_sum : 0.f);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* m_l, float* o_part,
                   int b, int L, int d, int splits, int chunk, float scale,
                   cudaStream_t stream) {
  const dim3 grid(b, splits);
  const float sl = scale * kLog2e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define BRPC_DECODE_CASE(DIM)                                               \
  case DIM:                                                                 \
    flash_decode_kernel<T, DIM><<<grid, kThreads, 0, stream>>>(             \
        qt, kt, vt, lengths, ot, m_l, o_part, L, chunk, sl);                \
    break;
  switch (d) {
    BRPC_DECODE_CASE(16)
    BRPC_DECODE_CASE(32)
    BRPC_DECODE_CASE(64)
    BRPC_DECODE_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef BRPC_DECODE_CASE
  return cudaGetLastError();
}

}  // namespace

// q [b, d], k and v [b, L, d], out [b, d]: contiguous, one dtype (0 fp32,
// 1 fp16, 2 bf16), 16-byte aligned; lengths int32 [b] on the device. With
// splits > 1, m_l [b, splits, 2] and o_part [b, splits, d] (fp32) receive
// the per-split partials and out is not written. Returns 0 or the CUDA
// error of the launch.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* m_l,
                            void* o_part, int b, int L, int d, int splits,
                            int chunk, float scale, int dtype,
                            void* stream) {
  if (b <= 0 || splits < 1 || splits > kMaxSplits || chunk < 1 ||
      (splits > 1 && (m_l == nullptr || o_part == nullptr)))
    return cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  float* ml = static_cast<float*>(m_l);
  float* op = static_cast<float*>(o_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, len, out, ml, op, b, L, d, splits, chunk,
                           scale, s);
    case 1:
      return launch<__half>(q, k, v, len, out, ml, op, b, L, d, splits,
                            chunk, scale, s);
    case 2:
      return launch<__nv_bfloat16>(q, k, v, len, out, ml, op, b, L, d,
                                   splits, chunk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// m_l [b, splits, 2] and o_part [b, splits, d] from flash_decode -> out
// [b, d] in dtype. Returns 0 or the CUDA error of the launch.
extern "C" int flash_decode_combine(const void* m_l, const void* o_part,
                                    void* out, int b, int d, int splits,
                                    int dtype, void* stream) {
  if (b <= 0 || splits < 1 || splits > kMaxSplits ||
      (d != 16 && d != 32 && d != 64 && d != 128))
    return cudaErrorInvalidValue;
  const float* ml = static_cast<const float*>(m_l);
  const float* op = static_cast<const float*>(o_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      flash_decode_combine_kernel<float><<<b, kCombineThreads, 0, s>>>(
          ml, op, static_cast<float*>(out), d, splits);
      break;
    case 1:
      flash_decode_combine_kernel<__half><<<b, kCombineThreads, 0, s>>>(
          ml, op, static_cast<__half*>(out), d, splits);
      break;
    case 2:
      flash_decode_combine_kernel<__nv_bfloat16>
          <<<b, kCombineThreads, 0, s>>>(
              ml, op, static_cast<__nv_bfloat16*>(out), d, splits);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
