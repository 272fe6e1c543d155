// Online-softmax prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention): q (B, S, H, D), k and v (B, L, KV, D) -> out
// (B, S, H, D); q-head h reads kv-head h / (H / KV) (GQA).  Causal,
// sliding-window, prefix-LM, logit softcap and q_offset visibility rules;
// keys at or beyond kv_len are masked; fp32 running max, sum and
// accumulator; a row that sees no key gives the guarded 0, never NaN
// (m_safe, denominator at least 1e-30), as the TPU kernel does.
//
// Bound: operations at the main path's shapes (S = L = 256, D = 128: the
// causal half of 4*S*L*D flops per head against q, k, v and out read or
// written once).  This kernel computes in fp32 on the CUDA cores (the
// model is fp32, and TF32 tensor cores would not match the reference);
// bf16 inputs are converted to fp32 on load.  wgmma tiles for bf16 are
// later work.
//
// Design: a block of 256 threads owns 64 query rows of one (batch,
// head) and walks 64-key tiles of K and V through shared memory, skipping
// tiles wholly outside the causal wedge or the window.  Like a register-
// tiled sgemm, each thread computes a 4 x 4 block of the score tile (rows
// ty*4.., keys tx + 16j) and a 4 x D/16 block of the output (dims
// tx*4 + 64j..), so every shared-memory word it reads feeds two or more
// FMAs.  Q is kept transposed and P is written transposed so that both
// are read as float4 along the rows; K rows are padded by one word so
// that the 16 key columns of a warp fall in distinct banks.  The row max
// is reduced across the 16 threads of a row with shuffles once per tile;
// the row sum stays per thread and is reduced once at the end.  Tiles are
// loaded with 16-byte (fp32) or 8-byte (bf16) vector loads, all of a
// thread's loads issued before its first shared-memory store, and the
// shared footprint (115 KB at D = 128) lets two blocks share an SM, so
// one block's loads overlap the other's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;           // query rows per block
constexpr int kKeys = 64;           // keys per shared-memory tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kLdT = kRows;         // row stride of the transposed Q and P
constexpr int kVec = 4;             // elements per vector load

// Four consecutive elements as fp32 (p 16-byte aligned for float, 8 for bf16).
__device__ __forceinline__ void load4(const float* p, float (&out)[kVec]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&out)[kVec]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_floats() {
  // Qt (D x kLdT) + K (kKeys x (D+1)) + V (kKeys x D) + Pt (kKeys x kLdT)
  return D * kLdT + kKeys * (D + 1) + kKeys * D + kKeys * kLdT;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s_len,
                       int kv_len, int heads, int kv_heads, bool causal,
                       int window, int prefix, float softcap, int q_offset,
                       float scale) {
  constexpr int kDims = D / 16;           // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                       // [D][kLdT]   Q^T, pre-scaled
  float* ks = qt + D * kLdT;              // [kKeys][D+1]
  float* vs = ks + kKeys * (D + 1);       // [kKeys][D]
  float* pt = vs + kKeys * D;             // [kKeys][kLdT] P^T

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int q_tile = blockIdx.x, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int row0 = q_tile * kRows;
  const int q_first = row0 + q_offset;
  const int q_last = min(row0 + kRows, s_len) - 1 + q_offset;

  constexpr int kIters = kRows * D / (kVec * kThreads);    // = D / 16
  {
    // Q^T: thread t takes row t % 64 and dims 4 * (t / 64 + 4 it) ..., so
    // that the transposed stores of a warp hit 32 distinct banks
    const int r = t % kRows, row = row0 + r;
    float qv[kIters][kVec];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int d = (t / kRows + 4 * it) * kVec;
#pragma unroll
      for (int x = 0; x < kVec; ++x) qv[it][x] = 0.f;
      if (row < s_len) {
        load4(q + ((b * s_len + row) * heads + h) * D + d, qv[it]);
      }
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int d = (t / kRows + 4 * it) * kVec;
#pragma unroll
      for (int x = 0; x < kVec; ++x) qt[(d + x) * kLdT + r] = qv[it][x] * scale;
    }
  }

  float acc[4][kDims];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (kv_len + kKeys - 1) / kKeys;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    // Tile-level visibility (uniform over the block).
    bool visible = true;
    if (causal) visible = k0 <= q_last || k0 < prefix;
    if (window >= 0) visible = visible && k0 + kKeys - 1 > q_first - window;
    if (!visible) continue;

    {
      // issue every load of this thread's share of the tile, then store
      float kv[kIters][kVec], vv[kIters][kVec];
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int e = (t + it * kThreads) * kVec;
        const int key = k0 + e / D;
#pragma unroll
        for (int x = 0; x < kVec; ++x) kv[it][x] = vv[it][x] = 0.f;
        if (key < kv_len) {
          const long long off =
              ((b * kv_len + key) * kv_heads + kvh) * D + e % D;
          load4(k + off, kv[it]);
          load4(v + off, vv[it]);
        }
      }
      __syncthreads();                    // the previous tile is consumed
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int e = (t + it * kThreads) * kVec;
        const int c = e / D, d = e % D;
#pragma unroll
        for (int x = 0; x < kVec; ++x) ks[c * (D + 1) + d + x] = kv[it][x];
        *reinterpret_cast<float4*>(vs + c * D + d) =
            make_float4(vv[it][0], vv[it][1], vv[it][2], vv[it][3]);
      }
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kLdT + ty * 4);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kval = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qr[i], kval, s[i][j]);
      }
    }

    float m_safe[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = row0 + ty * 4 + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float sc = s[i][j];
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        bool ok = key < kv_len;
        if (causal) ok = ok && (key <= qpos || key < prefix);
        if (window >= 0) ok = ok && key > qpos - window;
        s[i][j] = ok ? sc : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      // guard rows that have seen no visible key (exp of NEG_INF - NEG_INF)
      m_safe[i] = m_new <= kNegInf ? 0.f : m_new;
      const float alpha = m[i] <= kNegInf ? 0.f : expf(m[i] - m_safe[i]);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= kNegInf ? 0.f : expf(s[i][j] - m_safe[i]);
        s[i][j] = p;
        l[i] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * kLdT + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // out rows ty*4 + i, dims tx*4 + 64 j + e
#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + c * kLdT + ty * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int jd = 0; jd < D / 64; ++jd) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + c * D + tx * 4 + 64 * jd);
        const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][jd * 4 + e] = fmaf(pr[i], vr[e], acc[i][jd * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lsum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    }
    const int row = row0 + ty * 4 + i;
    if (row >= s_len) continue;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    T* op = out + ((b * s_len + row) * heads + h) * D;
#pragma unroll
    for (int jd = 0; jd < D / 64; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_from_f32(op + tx * 4 + 64 * jd + e, acc[i][jd * 4 + e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_dim(const T* q, const T* k, const T* v, T* out, int batch,
                       int s_len, int kv_len, int heads, int kv_heads,
                       bool causal, int window, int prefix, float softcap,
                       int q_offset, float scale, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // all of the SM's unified L1/shared storage as shared memory, so that two
  // blocks fit at D <= 128
  err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kRows - 1) / kRows, heads, batch);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, s>>>(
      q, k, v, out, s_len, kv_len, heads, kv_heads, causal, window, prefix,
      softcap, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int batch, int s_len, int kv_len,
                         int heads, int kv_heads, int head_dim, bool causal,
                         int window, int prefix, float softcap, int q_offset,
                         float scale, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (head_dim) {
    case 64:
      return launch_dim<T, 64>(qt, kt, vt, ot, batch, s_len, kv_len, heads,
                               kv_heads, causal, window, prefix, softcap,
                               q_offset, scale, s);
    case 128:
      return launch_dim<T, 128>(qt, kt, vt, ot, batch, s_len, kv_len, heads,
                                kv_heads, causal, window, prefix, softcap,
                                q_offset, scale, s);
    case 256:
      return launch_dim<T, 256>(qt, kt, vt, ot, batch, s_len, kv_len, heads,
                                kv_heads, causal, window, prefix, softcap,
                                q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window < 0 means no sliding window.
// Returns the launch's error code (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int s_len, int kv_len, int heads,
                                      int kv_heads, int head_dim, int causal,
                                      int window, int prefix, float softcap,
                                      int q_offset, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_typed<float>(
        q, k, v, out, batch, s_len, kv_len, heads, kv_heads, head_dim,
        causal != 0, window, prefix, softcap, q_offset, scale, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_typed<__nv_bfloat16>(
        q, k, v, out, batch, s_len, kv_len, heads, kv_heads, head_dim,
        causal != 0, window, prefix, softcap, q_offset, scale, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
