// Berrut coded encode/decode contraction for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/berrut_matmul.py:
//   berrut_apply            out[g, o] = sum_i W[o, i] x[g, i]   (G, O, F)
//   berrut_encode_dispatch  out[o*G + g] = the same row, written in the
//                           worker-major (O*G, F) layout whose contiguous
//                           1/W slices are one worker rank's streams
// for W (O, I) fp32 and x (G, I, F), fp32 accumulation, output in x's
// type (fp32 or bf16).  Both run one kernel, templated on where a row is
// written, so the dispatch output is the contraction's output permuted,
// bit for bit (the same fmaf chain in the same i order).
//
// Bound: bytes.  O and I are at most 64 (encode: O = N+1, I = K), so the
// contraction does at most 2*O flops per element it reads and is far
// below the card's ridge point; the least time is moving x in and the
// output out once.
//
// Design: W lives in shared memory for the whole block.  Each block owns
// a 128-column feature tile of one group; every thread reads its column
// of x once (neighbouring threads on neighbouring addresses), keeps the
// I values in registers, and writes its O outputs once.  Ragged F is
// masked in the kernel, never padded in memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileF = 128;   // feature columns per block, one per thread
constexpr int kMaxI = 64;     // I bound: the largest register column

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// kCols >= I is the register column's compile-time length: the launcher
// picks the smallest of 4, 8, 16, 32, 64 that holds I, so the unrolled
// loops stay short and the column never leaves registers.  kWorkerMajor
// writes row (g, o) at o*G + g instead of g*O + o; either way a thread
// writes its O outputs along f, so a warp's stores stay coalesced.
template <typename T, int kCols, bool kWorkerMajor>
__global__ void berrut_apply_kernel(const float* __restrict__ w,
                                    const T* __restrict__ x,
                                    T* __restrict__ out, int o_dim, int i_dim,
                                    long long f) {
  extern __shared__ float ws[];          // (O, I)
  const int t = threadIdx.x;
  const long long g = blockIdx.y;
  const long long col = static_cast<long long>(blockIdx.x) * kTileF + t;

  for (int idx = t; idx < o_dim * i_dim; idx += blockDim.x) ws[idx] = w[idx];
  __syncthreads();
  if (col >= f) return;

  float xv[kCols];
  const T* xg = x + g * i_dim * f + col;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    xv[i] = i < i_dim ? load_f32(xg + i * f) : 0.f;
  }

  // row (g, o) of the output and the stride between o and o + 1
  const long long groups = gridDim.y;
  T* og = out + (kWorkerMajor ? g : g * o_dim) * f + col;
  const long long o_stride = (kWorkerMajor ? groups : 1) * f;
  for (int o = 0; o < o_dim; ++o) {
    const float* wo = ws + o * i_dim;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      if (i < i_dim) acc = fmaf(wo[i], xv[i], acc);
    }
    store_from_f32(og + o * o_stride, acc);
  }
}

template <typename T, bool kWorkerMajor>
void launch_cols(const dim3& grid, size_t smem, cudaStream_t s,
                 const float* w, const T* x, T* out, int o_dim, int i_dim,
                 long long f) {
  if (i_dim <= 4) {
    berrut_apply_kernel<T, 4, kWorkerMajor>
        <<<grid, kTileF, smem, s>>>(w, x, out, o_dim, i_dim, f);
  } else if (i_dim <= 8) {
    berrut_apply_kernel<T, 8, kWorkerMajor>
        <<<grid, kTileF, smem, s>>>(w, x, out, o_dim, i_dim, f);
  } else if (i_dim <= 16) {
    berrut_apply_kernel<T, 16, kWorkerMajor>
        <<<grid, kTileF, smem, s>>>(w, x, out, o_dim, i_dim, f);
  } else if (i_dim <= 32) {
    berrut_apply_kernel<T, 32, kWorkerMajor>
        <<<grid, kTileF, smem, s>>>(w, x, out, o_dim, i_dim, f);
  } else {
    berrut_apply_kernel<T, kMaxI, kWorkerMajor>
        <<<grid, kTileF, smem, s>>>(w, x, out, o_dim, i_dim, f);
  }
}

template <bool kWorkerMajor>
int launch_types(const void* w, const void* x, void* out, int o_dim,
                 int i_dim, long long f, int groups, int dtype,
                 void* stream) {
  const dim3 grid(static_cast<unsigned>((f + kTileF - 1) / kTileF),
                  static_cast<unsigned>(groups));
  if (i_dim > kMaxI || o_dim > kMaxI) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * o_dim * i_dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_cols<float, kWorkerMajor>(
        grid, smem, s, static_cast<const float*>(w),
        static_cast<const float*>(x), static_cast<float*>(out), o_dim, i_dim,
        f);
  } else if (dtype == 1) {
    launch_cols<__nv_bfloat16, kWorkerMajor>(
        grid, smem, s, static_cast<const float*>(w),
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), o_dim, i_dim, f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after
// the launch (0 on success).  out is (G, O, F).
extern "C" int berrut_apply_launch(const void* w, const void* x, void* out,
                                   int o_dim, int i_dim, long long f,
                                   int groups, int dtype, void* stream) {
  return launch_types<false>(w, x, out, o_dim, i_dim, f, groups, dtype,
                             stream);
}

// out is (O*G, F), row o*G + g.  W may be any row slice of the encode
// matrix: a worker rank encodes only its own streams.
extern "C" int berrut_encode_dispatch_launch(const void* w, const void* x,
                                             void* out, int o_dim, int i_dim,
                                             long long f, int groups,
                                             int dtype, void* stream) {
  return launch_types<true>(w, x, out, o_dim, i_dim, f, groups, dtype,
                            stream);
}
