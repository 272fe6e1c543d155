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
// (G, N+1, V) block once and writing (G, K, V) once (36.5 MB at the E=1
// fp32 serving shape (4, 11, 151936), 10.9 us at 3.35 TB/s).  A warp
// has to move 16 bytes a thread per access, and each SM needs tens of KB
// of loads in flight, to come near that.
//
// Design:
// - A thread owns VEC adjacent vocabulary columns, 16 bytes (4 fp32 or
//   8 bf16), reads each of the N+1 rows with one streaming 16-byte load
//   (ld.global.cs: every byte is read once), kUnroll rows in flight
//   before their FMAs, and writes each of its K outputs with one 16-byte
//   store.  The wrapper's plan_vector takes VEC = 1 when V, a stride or
//   a pointer does not allow 16 bytes (a ragged vocabulary, a view at an
//   odd offset): the same kernel, one column a thread.
// - Rows are read at x + g * group_stride + n * stream_stride, so the
//   worker-major tail's transposed (G, N+1, V) views need no copy.
// - The K x VEC accumulators live in registers (KB rows of them, KB = 4
//   or 8); K above KB is walked in chunks of KB rows, reading x again
//   from L1/L2 (right, not fast: the served K is 4, and 7 multihost).
// - At the served shapes a thread has one or two column chunks, so the
//   kernel's time is a chain (launch, masks, decode matrix, N+1 row
//   loads, stores) as much as a byte count.  The decode matrix is built
//   once per block into shared memory, one warp per row k: lane n holds
//   nodes n and n + 32, the survivor ranks are a warp prefix sum of the
//   masks, the row's denominator a warp sum and its node hits a warp
//   vote, and one barrier ends it; every FMA then reads it as a
//   broadcast.  The first kUnroll rows of each thread's first columns
//   are loaded before it, so it runs under their latency.  The grid is
//   one wave of blocks (the occupancy calculator's count) shared by the
//   groups, each block walking its group's vocabulary in steps of the
//   grid: the prologue runs a few hundred times a call.
// - The vote gather writes from the registers of the load, with 32-bit
//   column arithmetic, in the instantiation with votes only.
//
// Each output sums over n = 0..N in order; the denominators sum as a
// warp reduction, in another order than the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNodes = 64;    // N+1 and K are at most this
constexpr int kMaxGroups = 65535;  // the grid's second dimension
constexpr int kUnroll = 4;       // rows of x in flight per thread
// Same fp32 threshold as the reference's _NODE_HIT_TOL comparison.
constexpr float kNodeHitTol = 1e-6f;

// VEC columns of T: one load of their bits, unpacked to fp32, and one
// store from fp32 (round to nearest even for bf16).
template <typename T, int VEC>
struct Cols;

template <>
struct Cols<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Cols<float, 1> {
  using Raw = unsigned int;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldcs(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) {
    f[0] = __uint_as_float(r);
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[1]) {
    *p = f[0];
  }
};

__device__ __forceinline__ unsigned int bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}

template <>
struct Cols<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // little-endian: low half first
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[8]) {
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Cols<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) {
    f[0] = __uint_as_float(static_cast<unsigned int>(r) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[1]) {
    *p = __float2bfloat16(f[0]);
  }
};

struct Args {
  const void* x;
  long long group_stride, stream_stride;   // in elements
  const float* masks;
  int mask_stride;                         // 0: one mask for every group
  const float* alphas;
  const float* betas;
  void* out;
  float* votes;
  int groups, k_dim, n1, v, c_count, vote_stride;
};

template <typename T, int VEC, int KB, bool kVote>
__global__ void __launch_bounds__(kThreads)
fused_group_decode_kernel(const T* __restrict__ x, long long group_stride,
                          long long stream_stride,
                          const float* __restrict__ masks, int mask_stride,
                          const float* __restrict__ alphas,
                          const float* __restrict__ betas,
                          T* __restrict__ out, float* __restrict__ votes,
                          int k_dim, int n1, int v, int c_count,
                          int vote_stride) {
  using C = Cols<T, VEC>;
  extern __shared__ float dec[];        // (K, N+1) decode matrix
  const int t = threadIdx.x;
  const int g = blockIdx.y;
  const int nvec = v / VEC;             // VEC divides V (plan_vector)
  const int first = blockIdx.x * kThreads + t;
  const T* xg = x + g * group_stride;
  typename C::Raw raw[kUnroll] = {};
  auto load_rows = [&](const T* xp, int n0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (n0 + u < n1) raw[u] = C::load(xp + (n0 + u) * stream_stride);
    }
  };
  // the first rows of this thread's first columns are in flight while
  // the decode matrix is built
  if (first < nvec) load_rows(xg + first * VEC, 0);

  // Row k of the decode matrix, one warp a row, lane n holding nodes n
  // and n + 32.  The survivor weight of node n is (-1)^(rank of n among
  // survivors) * m_n, its rank a prefix sum of the masks taken with a
  // floored modulo as survivor_weights takes it (the rank may be -1);
  // the row's terms are normalised by their sum, or the row is one-hot
  // where alpha_k hits an available node.
  const int lane = t & 31;
  const float* m = masks + static_cast<long long>(g) * mask_stride;
  for (int k = t >> 5; k < k_dim; k += kThreads / 32) {
    const float a = alphas[k];
    float term[2], before = 0.f, sum = 0.f;
    bool hit[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = h * 32 + lane;
      const bool in = n < n1;
      const float mn = in ? m[n] : 0.f;
      float cum = mn;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, cum, d);
        if (lane >= d) cum += up;
      }
      cum += before;
      before = __shfl_sync(0xffffffffu, cum, 31);
      const float rank = cum - 1.f;
      const float sign = 1.f - 2.f * (rank - 2.f * floorf(rank * 0.5f));
      const float diff = a - (in ? betas[n] : 0.f);
      const bool raw_hit = fabsf(diff) < kNodeHitTol;
      term[h] = in ? sign * mn / (raw_hit ? 1.f : diff) : 0.f;
      hit[h] = in && raw_hit && mn > 0.f;
      sum += term[h];
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, d);
    }
    const bool row_hit = __any_sync(0xffffffffu, hit[0] || hit[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = h * 32 + lane;
      if (n < n1) {
        dec[k * n1 + n] = row_hit ? (hit[h] ? 1.f : 0.f) : term[h] / sum;
      }
    }
  }
  __syncthreads();

  T* og = static_cast<T*>(out) + static_cast<long long>(g) * k_dim * v;
  for (int i = first; i < nvec; i += gridDim.x * kThreads) {
    const int col = i * VEC;
    unsigned int vote_cols = 0;         // bit j: column col + j is voted
    if (kVote) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const unsigned int c = static_cast<unsigned int>(col + j);
        if (c % static_cast<unsigned int>(vote_stride) == 0 &&
            c / static_cast<unsigned int>(vote_stride) <
                static_cast<unsigned int>(c_count)) {
          vote_cols |= 1u << j;
        }
      }
    }
    const T* xp = xg + col;
    for (int k0 = 0; k0 < k_dim; k0 += KB) {
      float acc[KB][VEC];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[k][j] = 0.f;
      }
      for (int n0 = 0; n0 < n1; n0 += kUnroll) {
        if (i != first || k0 != 0 || n0 != 0) load_rows(xp, n0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int n = n0 + u;
          if (n >= n1) continue;
          float f[VEC];
          C::unpack(raw[u], f);
          if (kVote && k0 == 0 && vote_cols != 0) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              if (vote_cols >> j & 1u) {
                votes[(static_cast<long long>(g) * n1 + n) * c_count +
                      static_cast<unsigned int>(col + j) /
                          static_cast<unsigned int>(vote_stride)] = f[j];
              }
            }
          }
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (k0 + k < k_dim) {
              const float d = dec[(k0 + k) * n1 + n];
#pragma unroll
              for (int j = 0; j < VEC; ++j) {
                acc[k][j] = fmaf(d, f[j], acc[k][j]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k0 + k < k_dim) {
          C::store(og + static_cast<long long>(k0 + k) * v + col, acc[k]);
        }
      }
    }
  }
}

template <typename T, int VEC, int KB, bool kVote>
int launch(const Args& a, cudaStream_t s) {
  const size_t smem = sizeof(float) * a.k_dim * a.n1;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_group_decode_kernel<T, VEC, KB, kVote>, kThreads, smem);
  // one wave: the blocks the card holds at once, shared by the groups;
  // each block walks an even share of its group's columns
  const int need = (a.v / VEC + kThreads - 1) / kThreads;
  const int most = std::max(1, std::max(sms, 1) * std::max(per_sm, 1) /
                                    a.groups);
  const int rounds = (need + most - 1) / most;
  const dim3 grid(static_cast<unsigned>((need + rounds - 1) / rounds),
                  static_cast<unsigned>(a.groups));
  fused_group_decode_kernel<T, VEC, KB, kVote><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a.x), a.group_stride, a.stream_stride, a.masks,
      a.mask_stride, a.alphas, a.betas, static_cast<T*>(a.out), a.votes,
      a.k_dim, a.n1, a.v, a.c_count, a.vote_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int dispatch(const Args& a, cudaStream_t s) {
  const bool vote = a.votes != nullptr;
  if (a.k_dim <= 4) {
    return vote ? launch<T, VEC, 4, true>(a, s)
                : launch<T, VEC, 4, false>(a, s);
  }
  return vote ? launch<T, VEC, 8, true>(a, s) : launch<T, VEC, 8, false>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  group_stride and stream_stride are
// x's strides in elements (its last dimension has unit stride);
// mask_stride is the masks' group stride, 0 for one shared mask; out is
// a contiguous (G, K, V).  vec: columns a thread moves per access, 1 or
// 16 bytes' worth (then V, both strides and both pointers must allow
// 16-byte accesses).  votes may be null (no gather).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fused_group_decode_launch(
    const void* x, long long group_stride, long long stream_stride,
    const void* masks, int mask_stride, const void* alphas,
    const void* betas, void* out, void* votes, int groups, int k_dim,
    int n1, int v, int c_count, int vote_stride, int vec, int dtype,
    void* stream) {
  if (k_dim < 1 || n1 < 1 || k_dim > kMaxNodes || n1 > kMaxNodes ||
      groups < 1 || groups > kMaxGroups || v < 1 ||
      (votes != nullptr && (c_count < 1 || vote_stride < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0 && dtype != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int size = dtype == 0 ? 4 : 2;
  if (vec != 1) {
    const long long w = vec;
    if (vec * size != 16 || v % vec != 0 || group_stride % w != 0 ||
        stream_stride % w != 0 ||
        reinterpret_cast<unsigned long long>(x) % 16 != 0 ||
        reinterpret_cast<unsigned long long>(out) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  const Args a{x, group_stride, stream_stride,
               static_cast<const float*>(masks), mask_stride,
               static_cast<const float*>(alphas),
               static_cast<const float*>(betas), out,
               static_cast<float*>(votes), groups, k_dim, n1, v, c_count,
               vote_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec == 1 ? dispatch<float, 1>(a, s) : dispatch<float, 4>(a, s);
  }
  return vec == 1 ? dispatch<__nv_bfloat16, 1>(a, s)
                  : dispatch<__nv_bfloat16, 8>(a, s);
}
