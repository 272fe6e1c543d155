// Single-token decode attention over a ring KV cache for Hopper (sm_90a).
// Two entry points share one kernel template, which differs only in where
// a key's validity comes from:
//
// flash_decode_launch replaces the Pallas TPU kernel
// src/repro/kernels/flash_decode.py (flash_decode): q (B, H, D) against
// caches (B, W, KV, D) with an explicit (B, W) validity mask -> out
// (B, H, D).
//
// pool_flash_decode_launch replaces src/repro/kernels/flash_decode.py
// (pool_flash_decode), the slot-pool decode: validity comes from a
// per-stream ring position pos[b] (int32) and an optional per-stream
// live byte, as kvpos <= pos[b] && kvpos < W && live[b].  Those keys are
// the prefix [0, min(pos[b], W-1)] of the ring, so the key loop stops
// there: slots past a stream's depth are never read, where the Pallas
// kernel reads and masks every tile.  A dead stream (live[b] == 0) has
// no keys, reads no cache and writes exact zeros.
//
// In both, the rep = H / KV q-heads of a kv-head share one pass over its
// cache; int8 caches are dequantised in registers by kv_scale
// (device-memory traffic stays at the int8 byte count); logit softcap is
// supported.  A row that sees no key gives the guarded 0, never NaN
// (m_safe, denominator at least 1e-30), as the TPU kernels do.
//
// Bound: bytes.  Each cache element read feeds 2 * rep flops, far below
// the card's ridge point; the least time is reading both caches' valid
// slots once.
//
// Design: one block per (batch, kv-head), four warps splitting the cache
// positions in chunks of 4 keys.  Lanes split the head dimension (dim d
// belongs to lane d % 32), so every key row is one coalesced read per
// warp; scores are warp-reduced with shuffles, and each warp keeps its
// own fp32 running max, sum and accumulator for all rep rows.  The four
// partial softmaxes are merged through shared memory at the end.  The
// grid is B * KV blocks (352 at the main path's shapes on 132 SMs);
// splitting the cache across blocks (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kChunk = 4;        // keys a warp takes per step

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float load_kv(const float* p, float) { return *p; }
__device__ __forceinline__ float load_kv(const __nv_bfloat16* p, float) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_kv(const int8_t* p, float kv_scale) {
  return static_cast<float>(*p) / kv_scale;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Where a key's validity comes from: a (B, W) uint8 mask with row stride
// mask_stride (0 broadcasts one row), or, with kPool, the stream's ring
// position pos[b] and live byte (live == nullptr: every stream is live).
struct Validity {
  const uint8_t* mask;
  long long mask_stride;
  const int* pos;
  const uint8_t* live;
};

// T: type of q and out; C: type of the caches (T, or int8 with kv_scale);
// R: q-head rows handled per pass over the cache; kPool: validity from
// (pos, live) instead of the mask.
template <typename T, typename C, int D, int R, bool kPool>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                    const C* __restrict__ vc, Validity valid,
                    T* __restrict__ out, int width, int heads, int kv_heads,
                    float softcap, float scale, float kv_scale) {
  constexpr int kPer = D / 32;
  __shared__ float sm_m[kWarps][R];
  __shared__ float sm_l[kWarps][R];
  __shared__ float sm_acc[kWarps][R][D];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvh = blockIdx.x;
  const long long b = blockIdx.y;
  const int rep = heads / kv_heads;
  const uint8_t* mrow = kPool ? nullptr : valid.mask + b * valid.mask_stride;
  // keys [0, nkeys) are the only ones read; with kPool all of them are
  // valid, so a dead stream (nkeys = 0) writes 0 / max(0, 1e-30) = 0
  int nkeys = width;
  if (kPool) {
    const bool alive = valid.live == nullptr || valid.live[b] != 0;
    nkeys = alive ? max(0, min(valid.pos[b], width - 1) + 1) : 0;
  }

  for (int h0 = 0; h0 < rep; h0 += R) {
    const int rows = min(R, rep - h0);
    const long long head0 = b * heads + kvh * rep + h0;
    float qr[R][kPer], acc[R][kPer], m[R], l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        qr[r][j] = r < rows ? load_f32(q + (head0 + r) * D + lane + 32 * j) * scale : 0.f;
        acc[r][j] = 0.f;
      }
      m[r] = kNegInf;
      l[r] = 0.f;
    }

    for (int base = warp * kChunk; base < nkeys; base += kWarps * kChunk) {
      float sc[kChunk][R];
      bool ok[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int key = base + c;
        ok[c] = key < nkeys && (kPool || mrow[key] != 0);
        float kval[kPer];
        const C* kp = kc + ((b * width + min(key, nkeys - 1)) * kv_heads + kvh) * D;
#pragma unroll
        for (int j = 0; j < kPer; ++j) kval[j] = load_kv(kp + lane + 32 * j, kv_scale);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < kPer; ++j) dot = fmaf(qr[r][j], kval[j], dot);
          dot = warp_sum(dot);
          if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
          sc[c][r] = ok[c] ? dot : kNegInf;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float cmax = kNegInf;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) cmax = fmaxf(cmax, sc[c][r]);
        const float m_new = fmaxf(m[r], cmax);
        const float m_safe = m_new <= kNegInf ? 0.f : m_new;
        const float alpha = m[r] <= kNegInf ? 0.f : expf(m[r] - m_safe);
        float p_sum = 0.f;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float p = ok[c] ? expf(sc[c][r] - m_safe) : 0.f;
          sc[c][r] = p;
          p_sum += p;
        }
        l[r] = l[r] * alpha + p_sum;
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[r][j] *= alpha;
        m[r] = m_new;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int key = base + c;
        const C* vp = vc + ((b * width + min(key, nkeys - 1)) * kv_heads + kvh) * D;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float vval = load_kv(vp + lane + 32 * j, kv_scale);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][j] = fmaf(sc[c][r], vval, acc[r][j]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) sm_acc[warp][r][lane + 32 * j] = acc[r][j];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * D; idx += kWarps * 32) {
      const int r = idx / D, d = idx % D;
      float m_all = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w][r]);
      const float m_safe = m_all <= kNegInf ? 0.f : m_all;
      float l_all = 0.f, a_all = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = sm_m[w][r] <= kNegInf ? 0.f : expf(sm_m[w][r] - m_safe);
        l_all += sm_l[w][r] * f;
        a_all += sm_acc[w][r][d] * f;
      }
      store_from_f32(out + (head0 + r) * D + d, a_all / fmaxf(l_all, 1e-30f));
    }
    __syncthreads();                      // shared state is reused next pass
  }
}

template <typename T, typename C, int D, bool kPool>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        Validity valid, void* out, int batch, int width,
                        int heads, int kv_heads, float softcap, float scale,
                        float kv_scale, cudaStream_t s) {
  const dim3 grid(kv_heads, batch);
  const int rep = heads / kv_heads;
  if (rep <= 2) {
    flash_decode_kernel<T, C, D, 2, kPool><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const C*>(k),
        static_cast<const C*>(v), valid, static_cast<T*>(out), width, heads,
        kv_heads, softcap, scale, kv_scale);
  } else {
    flash_decode_kernel<T, C, D, 8, kPool><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const C*>(k),
        static_cast<const C*>(v), valid, static_cast<T*>(out), width, heads,
        kv_heads, softcap, scale, kv_scale);
  }
  return cudaGetLastError();
}

template <typename T, typename C, bool kPool>
cudaError_t launch_dims(const void* q, const void* k, const void* v,
                        Validity valid, void* out, int batch, int width,
                        int heads, int kv_heads, int head_dim, float softcap,
                        float scale, float kv_scale, cudaStream_t s) {
  switch (head_dim) {
    case 64:
      return launch_rows<T, C, 64, kPool>(q, k, v, valid, out, batch, width,
                                          heads, kv_heads, softcap, scale,
                                          kv_scale, s);
    case 128:
      return launch_rows<T, C, 128, kPool>(q, k, v, valid, out, batch, width,
                                           heads, kv_heads, softcap, scale,
                                           kv_scale, s);
    case 256:
      return launch_rows<T, C, 256, kPool>(q, k, v, valid, out, batch, width,
                                           heads, kv_heads, softcap, scale,
                                           kv_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kPool>
cudaError_t launch_types(const void* q, const void* k, const void* v,
                         Validity valid, void* out, int batch, int width,
                         int heads, int kv_heads, int head_dim, float softcap,
                         float scale, float kv_scale, int dtype,
                         int cache_dtype, cudaStream_t s) {
  if (dtype == 0 && cache_dtype == 0) {
    return launch_dims<float, float, kPool>(q, k, v, valid, out, batch,
                                            width, heads, kv_heads, head_dim,
                                            softcap, scale, kv_scale, s);
  }
  if (dtype == 1 && cache_dtype == 1) {
    return launch_dims<__nv_bfloat16, __nv_bfloat16, kPool>(
        q, k, v, valid, out, batch, width, heads, kv_heads, head_dim,
        softcap, scale, kv_scale, s);
  }
  if (dtype == 0 && cache_dtype == 2) {
    return launch_dims<float, int8_t, kPool>(q, k, v, valid, out, batch,
                                             width, heads, kv_heads,
                                             head_dim, softcap, scale,
                                             kv_scale, s);
  }
  if (dtype == 1 && cache_dtype == 2) {
    return launch_dims<__nv_bfloat16, int8_t, kPool>(
        q, k, v, valid, out, batch, width, heads, kv_heads, head_dim,
        softcap, scale, kv_scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  cache_dtype: the same
// code as dtype, or 2 = int8 dequantised by kv_scale.  Both entry points
// return cudaGetLastError() after the launch (0 on success).

// mask is uint8 (B, W) with row stride mask_stride (0 broadcasts one row).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   long long mask_stride, void* out,
                                   int batch, int width, int heads,
                                   int kv_heads, int head_dim, float softcap,
                                   float scale, float kv_scale, int dtype,
                                   int cache_dtype, void* stream) {
  const Validity valid{static_cast<const uint8_t*>(mask), mask_stride,
                       nullptr, nullptr};
  return static_cast<int>(launch_types<false>(
      q, k, v, valid, out, batch, width, heads, kv_heads, head_dim, softcap,
      scale, kv_scale, dtype, cache_dtype, static_cast<cudaStream_t>(stream)));
}

// pos is int32 (B,), the ring position of each stream's newest key; live
// is uint8 (B,) or null (every stream live).
extern "C" int pool_flash_decode_launch(const void* q, const void* k,
                                        const void* v, const void* pos,
                                        const void* live, void* out,
                                        int batch, int width, int heads,
                                        int kv_heads, int head_dim,
                                        float softcap, float scale,
                                        float kv_scale, int dtype,
                                        int cache_dtype, void* stream) {
  const Validity valid{nullptr, 0, static_cast<const int*>(pos),
                       static_cast<const uint8_t*>(live)};
  return static_cast<int>(launch_types<true>(
      q, k, v, valid, out, batch, width, heads, kv_heads, head_dim, softcap,
      scale, kv_scale, dtype, cache_dtype, static_cast<cudaStream_t>(stream)));
}
