// Fused coded-round decode tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/berrut_decode.py
// (fused_group_decode): for each query group g it rebuilds the (K, N+1)
// survivor-weight Berrut decode matrix from that group's availability
// mask (rank-renumbered alternating signs, barycentric basis, one-hot
// rows at node hits within _NODE_HIT_TOL of an available node) and
// contracts the (N+1, V) coded logits to (K, V) in fp32.  With
// c_count > 0 it also writes the locator's strided vote columns
// votes[g, n, c] = float(x[g, n, c * stride]) from the same pass.
//
// Bound: bytes.  K and N+1 are at most 64, so the contraction does at
// most 2*K flops per coded logit read; the least time is reading the
// (G, N+1, V) block once and writing (G, K, V) once.
//
// Design: each block owns one group and a 128-wide vocab tile.  The
// decode matrix is rebuilt per block in shared memory (K*(N+1) tiny
// scalar ops next to the tile's N+1 x 128 loads), so per-group matrices
// never touch device memory; each thread reads its vocab column once
// and writes its K outputs once.  The vocab tail (V = 151936 is not a
// multiple of the tile on every width) is masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileV = 128;      // vocab columns per block, one per thread
constexpr int kMaxNodes = 64;    // N+1 and K are at most this
// Same fp32 threshold as the reference's _NODE_HIT_TOL comparison.
constexpr float kNodeHitTol = 1e-6f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void fused_group_decode_kernel(
    const T* __restrict__ x, const float* __restrict__ masks,
    int mask_stride, const float* __restrict__ alphas,
    const float* __restrict__ betas, T* __restrict__ out,
    float* __restrict__ votes, int k_dim, int n1, long long v, int c_count,
    long long stride) {
  extern __shared__ float smem[];
  float* dec = smem;                    // (K, N+1) decode matrix
  float* xs = smem + k_dim * n1;        // (N+1, kTileV)
  const int t = threadIdx.x;
  const long long g = blockIdx.y;
  const float* m = masks + g * mask_stride;

  if (t < k_dim) {
    // Row t of the decode matrix.  The survivor weight of node n is
    // (-1)^(rank of n among survivors) * m_n, the rank taken with a
    // floored modulo as survivor_weights takes it (the rank may be -1).
    const float a = alphas[t];
    float denom = 0.f, cum = 0.f;
    bool row_hit = false;
    for (int n = 0; n < n1; ++n) {
      cum += m[n];
      const float rank = cum - 1.f;
      const float sign = 1.f - 2.f * (rank - 2.f * floorf(rank * 0.5f));
      const float diff = a - betas[n];
      const bool raw_hit = fabsf(diff) < kNodeHitTol;
      const float term = sign * m[n] / (raw_hit ? 1.f : diff);
      row_hit = row_hit || (raw_hit && m[n] > 0.f);
      denom += term;
      dec[t * n1 + n] = term;
    }
    for (int n = 0; n < n1; ++n) {
      const bool hit = fabsf(a - betas[n]) < kNodeHitTol && m[n] > 0.f;
      dec[t * n1 + n] = row_hit ? (hit ? 1.f : 0.f) : dec[t * n1 + n] / denom;
    }
  }

  const long long col = static_cast<long long>(blockIdx.x) * kTileV + t;
  const bool active = col < v;
  const T* xg = x + g * n1 * v;
  const bool gather = votes != nullptr && active && col % stride == 0 &&
                      col / stride < c_count;
  for (int n = 0; n < n1; ++n) {
    const float val = active ? load_f32(xg + n * v + col) : 0.f;
    xs[n * kTileV + t] = val;
    if (gather) votes[(g * n1 + n) * c_count + col / stride] = val;
  }
  __syncthreads();
  if (!active) return;

  T* og = out + g * k_dim * v;
  for (int k = 0; k < k_dim; ++k) {
    float acc = 0.f;
    for (int n = 0; n < n1; ++n) {
      acc = fmaf(dec[k * n1 + n], xs[n * kTileV + t], acc);
    }
    store_from_f32(og + k * v + col, acc);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mask_stride is N+1 for per-group
// masks and 0 for one shared mask.  votes may be null (no gather).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_group_decode_launch(
    const void* x, const void* masks, int mask_stride, const void* alphas,
    const void* betas, void* out, void* votes, int groups, int k_dim, int n1,
    long long v, int c_count, long long stride, int dtype, void* stream) {
  if (k_dim > kMaxNodes || n1 > kMaxNodes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((v + kTileV - 1) / kTileV),
                  static_cast<unsigned>(groups));
  const size_t smem = sizeof(float) * (k_dim * n1 + n1 * kTileV);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fused_group_decode_kernel<float><<<grid, kTileV, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(masks),
        mask_stride, static_cast<const float*>(alphas),
        static_cast<const float*>(betas), static_cast<float*>(out),
        static_cast<float*>(votes), k_dim, n1, v, c_count, stride);
  } else if (dtype == 1) {
    fused_group_decode_kernel<__nv_bfloat16><<<grid, kTileV, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(masks), mask_stride,
        static_cast<const float*>(alphas), static_cast<const float*>(betas),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(votes), k_dim,
        n1, v, c_count, stride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
