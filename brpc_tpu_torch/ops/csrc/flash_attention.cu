// flash_attn_fwd: blockwise online-softmax attention for Hopper (sm_90a).
//
// Replaces: brpc_tpu/ops/flash_attention.py:104 `_flash_pallas_2d` (the
// repo's one Pallas TPU kernel), generalised to the parameters its lax
// twin `_flash_lax` (:66) already has: a per-row-block query offset (0 for
// flash_attention; lengths - 1 gives decode's mask, rows 0 .. lengths-1,
// which decode_attention ran through this kernel before flash_decode.cu),
// a causal flag and a scale.
// Numerics follow `_online_softmax_step` (:34) and `_finalize` (:58):
// fp32 (m, l, o) per row, masked scores set to NEG_INF = -1e30 (not -inf)
// and their probabilities forced to 0, rows with l == 0 written as 0.
//
// What bounds it on an H100. At long sequences (8 heads x 2048 x 64) it is
// bound by operations: 4 * sq * sk * d FLOPs, done here in fp32 on the
// CUDA cores (67 TFLOP/s) with two shared-memory reads per FMA, which
// holds it near an eighth of that peak. TF32 stays off, so fp32 never
// takes the tensor cores.
//
// Design. The TPU kernel keeps the whole K/V of a head in VMEM; 2048 x 64
// fp32 is 512 KB, beyond one block's 227 KB of shared memory. So there is
// one block per 16 query rows of a head; it stages its q tile in shared
// memory once and streams K and V through shared memory in 32-row
// tiles, converted to fp32 on load (fp32, fp16 and bf16 inputs). Eight
// threads share a query row: each scores four keys of the tile and owns
// d/8 output columns, and row max and row sum are reduced with warp
// shuffles inside the 8-lane group. Shared arrays are padded by one float
// per row so that the q.k and p.v loops read distinct banks. Under a
// causal mask the loop stops at the last tile the block's last row can
// see: a fully masked tile leaves (m, l, o) unchanged in the reference, so
// the skip is exact. The grid is (batch*heads, q tiles): bh on gridDim.x
// has no 65,535 limit, and the blocks launch in `causal_tile` order
// (tile_order.cuh), heaviest q tile first under a causal mask, so the
// longest blocks do not trail the run. The kernel allocates nothing and
// launches on the caller's stream; the C entry returns cudaGetLastError().
//
// Routing (ops/flash_attention.py `_plan`): this kernel takes fp32, and
// fp16/bf16 at head dim 16/32. fp16/bf16 at head dim 64/128 go to the
// tensor-core kernel (flash_attention_tc.cu), decode to flash_decode.cu.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "tile_order.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 16;                       // query rows per block
constexpr int kBK = 32;                       // keys per K/V tile
constexpr int kRowThreads = kThreads / kBQ;   // 8 threads share one row
constexpr int kKeysPerThread = kBK / kRowThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      const int* __restrict__ q_offset, int q_offset_add,
                      int sq, int sk, float scale, int causal) {
  constexpr int kCols = D / kRowThreads;      // output columns per thread
  __shared__ float qs[kBQ][D + 1];
  __shared__ float ks[kBK][D + 1];
  __shared__ float vs[kBK][D];
  __shared__ float ps[kBQ][kBK + 1];

  const int bh = blockIdx.x;
  const int q0 = causal_tile(blockIdx.y, gridDim.y, causal) * kBQ;
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int lane8 = tid % kRowThreads;
  const long long q_base = static_cast<long long>(bh) * sq * D;
  const long long k_base = static_cast<long long>(bh) * sk * D;
  const int offset = (q_offset != nullptr ? q_offset[bh] : 0) + q_offset_add;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = q0 + r;
    qs[r][c] = gr < sq ? to_float(q[q_base + static_cast<long long>(gr) * D + c])
                       : 0.f;
  }

  const int q_row = q0 + row;
  const int q_pos = offset + q_row;
  const int n_k = (sk + kBK - 1) / kBK;
  int n_vis = n_k;
  if (causal) {
    // the last key any row of this block can see decides the last tile
    const int last_pos = offset + min(q0 + kBQ, sq) - 1;
    n_vis = last_pos < 0 ? 0 : min((last_pos + kBK) / kBK, n_k);
  }

  float m = kNegInf;
  float l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  __syncthreads();

  for (int kt = 0; kt < n_vis; ++kt) {
    const int k0 = kt * kBK;
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int gk = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (gk < sk) {
        const long long idx = k_base + static_cast<long long>(gk) * D + c;
        kv = to_float(k[idx]);
        vv = to_float(v[idx]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    float s[kKeysPerThread];
    bool ok[kKeysPerThread];
    float tile_max = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int j = lane8 + i * kRowThreads;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qs[row][c], ks[j][c], dot);
      const int k_pos = k0 + j;
      ok[i] = k_pos < sk && (!causal || k_pos <= q_pos);
      s[i] = ok[i] ? dot * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[i]);
    }
    const float m_new = fmaxf(m, row_max(tile_max));
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float p = ok[i] ? expf(s[i] - m_new) : 0.f;
      ps[row][lane8 + i * kRowThreads] = p;
      p_sum += p;
    }
    l = l * corr + row_sum(p_sum);
    m = m_new;
    __syncwarp();   // a row's 8 lanes sit in one warp

#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = lane8 + cc * kRowThreads;
      float a = acc[cc] * corr;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) a = fmaf(ps[row][j], vs[j][c], a);
      acc[cc] = a;
    }
    __syncthreads();   // ks/vs/ps are rewritten by the next tile
  }

  if (q_row < sq) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* out = o + q_base + static_cast<long long>(q_row) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = lane8 + cc * kRowThreads;
      out[c] = from_float<T>(acc[cc] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* q_offset, int q_offset_add, int bh, int sq,
                   int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (d) {
    case 16:
      flash_attn_fwd_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, q_offset, q_offset_add, sq, sk, scale, causal);
      break;
    case 32:
      flash_attn_fwd_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, q_offset, q_offset_add, sq, sk, scale, causal);
      break;
    case 64:
      flash_attn_fwd_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, q_offset, q_offset_add, sq, sk, scale, causal);
      break;
    case 128:
      flash_attn_fwd_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, q_offset, q_offset_add, sq, sk, scale, causal);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q [bh, sq, d], k and v [bh, sk, d], o [bh, sq, d], all contiguous and of
// one dtype (0 fp32, 1 fp16, 2 bf16). q_offset: null, or int32 [bh] on the
// device; row r of head b sits at position q_offset[b] + q_offset_add + r.
// Returns 0 or the CUDA error of the launch.
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
