// Online-softmax prefill attention for Hopper (sm_90a), on tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention): q (B, S, H, D), k and v (B, L, KV, D) -> out
// (B, S, H, D); q-head h reads kv-head h / (H / KV) (GQA).  Causal,
// sliding-window, prefix-LM, logit softcap and q_offset visibility rules;
// keys at or beyond kv_len are masked; fp32 running max, sum and
// accumulator; a row that sees no key gives the guarded 0, never NaN
// (m_safe, denominator at least 1e-30), as the TPU kernel does.  With a
// non-null lse pointer the kernel also writes each row's log-sum-exp
// (fp32, (B, H, S), natural log, in the scaled and softcapped score
// space it normalises in; -inf for a row that sees no key), which the
// backward kernel (flash_attention_bwd.cu) reads to rebuild P.  That
// write is a template choice (kLse): compiled into the serving instance,
// it made fp32 at D = 128 20% slower on an H100.
//
// Bound: operations at the main path's shapes (S = L = 256, D = 128: the
// causal half of 4*S*L*D flops per head against q, k, v and out read or
// written once).  Both products therefore run on the tensor cores:
//   * bf16: S = Q K^T and O += P V as mma.sync m16n8k16 bf16 products
//     with fp32 accumulators.  P is split into two bf16 terms, hi =
//     bf16(P) and lo = bf16(P - hi), each multiplied by V: P rounded to
//     bf16 alone misses the kernel's tolerance (two bf16 ulps of the
//     element) by up to 2x.
//   * fp32: 3xTF32.  Each operand x is split into two tf32 terms hi and
//     lo (`split` below), and each product accumulates lo*hi + hi*lo +
//     hi*hi in fp32 (m16n8k8 tf32), which keeps about fp32's precision
//     (what is dropped is about 2^-20 of the product).  Plain TF32 would
//     not: the reference computes in full fp32.
// mma.sync, not wgmma: its per-warp 16-row fragments take the online
// softmax, the masks and the P operand straight from the accumulator
// registers, and the fp32 path can permute keys so that P's accumulator
// layout is already the tf32 A layout (below); wgmma's tf32 form would
// also need V transposed in shared memory.  The warpgroup form is later
// work.
//
// Design: a block of 4 warps owns 64 query rows of one (batch, head), 16
// a warp, and walks tiles of 32 keys, skipping tiles wholly outside the
// causal wedge, the prefix and the window; blocks of the last query tiles,
// which see the most keys, start first.  (Measured on the card: 64-key
// tiles, or 32 rows a warp, were slower; a tile's time is its compute,
// not its loads.)  Q and a two-stage ring of K and V tiles live in shared memory,
// filled with 16-byte cp.async copies, so tile i+1 loads while tile i
// computes; rows are padded by 16 bytes so that the fragment loads are
// free of bank conflicts.  bf16 fragments come from ldmatrix (.trans for
// V); fp32 ones are 32-bit loads split in registers.  Each thread holds
// its rows' scores as accumulator fragments: the row max and sum reduce
// over the 4 threads of a row with two shuffles, and exponentials are
// exp2 of log2(e)-scaled scores.  Only tiles that cut the causal wedge,
// the window or kv_len test visibility element by element.  In fp32 the
// P V product reads keys in the order 2t, 2t+1 of each 8-key step, the
// order of the scores' accumulator, so P needs no shuffle; V's rows are
// read in that order.
//
// Head dims 64, 80, 128 and 256 are instantiated.  Each is a multiple of
// 16 (the bf16 k-step of Q K^T) with D / 8 even (the bf16 P V loop takes
// two 8-column output tiles a step), and its padded row of D + 16 bytes
// puts ldmatrix's eight rows, and the fp32 fragment loads, on distinct
// banks (at D = 80: a pitch of 44 words, 12 mod 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <typename T, int D>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRows = 16 * kWarps;         // query rows a block
  static constexpr int kKeys = 32;                  // keys a tile
  static constexpr int kLd = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  // Q, then the ring: K and V for each of two stages
  static constexpr size_t kSmem =
      sizeof(T) * static_cast<size_t>(kLd) * (kRows + 4 * kKeys);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + n) of a (rows, stride) global matrix whose row r starts
// at base + r * stride, into shared rows of kLd; rows >= limit are zeros
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* base,
                                          long long stride, int r0, int n,
                                          int limit) {
  using C = Cfg<T, D>;
  for (int i = threadIdx.x; i < n * C::kChunks; i += kThreads) {
    const int r = i / C::kChunks, c = i % C::kChunks;
    const int row = r0 + r;
    const bool ok = row < limit;
    const T* src = base + (ok ? row * stride : 0) + c * (16 / sizeof(T));
    cp_async16(dst + r * C::kLd + c * (16 / sizeof(T)), src, ok);
  }
}

// ---- bf16 fragments
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x0, x1) -> packed bf16 pairs hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---- 3xTF32
// hi = x with its low 13 mantissa bits cleared, an exact tf32 value, and
// lo = x - hi, exact in fp32.  The tensor cores read a tf32 operand from
// the register's upper 19 bits, so lo enters its product cut to tf32:
// an error of at most 2^-10 of lo, 2^-20 of x.  Clearing bits costs one
// integer op; cvt.rna.tf32.f32 is a slow conversion, and rounding both
// parts with it made the fp32 kernels a third slower on the card.
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b in 3xTF32; a as 4 fp32 values in the A fragment's order
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split (&a)[4],
                                           Split b0, Split b1) {
  const uint32_t ah[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  const uint32_t al[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
  mma_tf32(c, al, b0.hi, b1.hi);
  mma_tf32(c, ah, b0.lo, b1.lo);
  mma_tf32(c, ah, b0.hi, b1.hi);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int s_len,
                       int kv_len, int heads, int kv_heads, bool causal,
                       int window, int prefix, float softcap, int q_offset,
                       float scale) {
  using C = Cfg<T, D>;
  constexpr int kKeys = C::kKeys, kLd = C::kLd, kRows = C::kRows;
  constexpr int kNt = kKeys / 8;     // 8-key accumulator tiles of a row
  constexpr int kDt = D / 8;         // 8-dim output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ring = qs + kRows * kLd;        // stage i: K at 2i, V at 2i + 1

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  // the last query tiles see the most keys: start them first
  const int q_tile = gridDim.x - 1 - blockIdx.x, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int row0 = q_tile * kRows;
  const int q_first = row0 + q_offset;
  const int q_last = min(row0 + kRows, s_len) - 1 + q_offset;

  // the block's visible key tiles are [kt_begin, kt_end)
  const int n_tiles = (kv_len + kKeys - 1) / kKeys;
  int kt_end = n_tiles;
  if (causal) {
    const int seen = max(max(q_last + 1, prefix), 0);
    kt_end = min(n_tiles, (seen + kKeys - 1) / kKeys);
  }
  int kt_begin = 0;
  if (window >= 0) {
    const int first = q_first - window + 1;   // first key any row sees
    if (first > 0) kt_begin = first / kKeys;
  }

  const long long q_stride = static_cast<long long>(heads) * D;
  const long long kv_stride = static_cast<long long>(kv_heads) * D;
  const T* qb = q + (b * s_len * heads + h) * D;
  const T* kb = k + (b * kv_len * kv_heads + kvh) * D;
  const T* vb = v + (b * kv_len * kv_heads + kvh) * D;

  load_rows<T, D>(qs, qb, q_stride, row0, kRows, s_len);
  if (kt_begin < kt_end) {
    load_rows<T, D>(ring, kb, kv_stride, kt_begin * kKeys, kKeys, kv_len);
    load_rows<T, D>(ring + kKeys * kLd, vb, kv_stride, kt_begin * kKeys,
                    kKeys, kv_len);
  }
  cp_async_commit();

  float o[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g, g + 8
  const int wrow = warp * 16;        // the warp's first row in the tile

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      T* nxt = ring + (stage ^ 1) * 2 * kKeys * kLd;
      load_rows<T, D>(nxt, kb, kv_stride, (kt + 1) * kKeys, kKeys, kv_len);
      load_rows<T, D>(nxt + kKeys * kLd, vb, kv_stride, (kt + 1) * kKeys,
                      kKeys, kv_len);
    }
    cp_async_commit();
    cp_async_wait<1>();              // this tile (and Q) have landed
    __syncthreads();
    const T* ks = ring + stage * 2 * kKeys * kLd;
    const T* vs = ks + kKeys * kLd;

    // ---- S = Q K^T: s[j] holds keys 8j + 2t, 8j + 2t + 1 of rows g, g+8
    float s[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (C::kBf16) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qs + (wrow + lane % 8 + (lane / 8 % 2) * 8) * kLd +
                           kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < kNt; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4(bf, ks + (j * 8 + lane % 8 + (lane / 16) * 8) * kLd +
                              kk * 16 + (lane / 8 % 2) * 8);
          mma_bf16(s[j], a, bf[0], bf[1]);
          mma_bf16(s[j + 1], a, bf[2], bf[3]);
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < D / 8; ++kk) {
        const float* qr = qs + (wrow + g) * kLd + kk * 8 + t;
        const Split a[4] = {split(qr[0]), split(qr[8 * kLd]), split(qr[4]),
                            split(qr[8 * kLd + 4])};
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const float* kr = ks + (j * 8 + g) * kLd + kk * 8 + t;
          mma_3xtf32(s[j], a, split(kr[0]), split(kr[4]));
        }
      }
    }

    // ---- masks and the online softmax, in log2 units.  A tile that every
    // row of the warp sees whole skips the per-element visibility tests.
    const int k0 = kt * kKeys;
    const int qmin = row0 + wrow + q_offset, qmax = qmin + 15;
    const bool masked =
        k0 + kKeys > kv_len ||
        (causal && k0 + kKeys - 1 > qmin && k0 + kKeys > prefix) ||
        (window >= 0 && k0 <= qmax - window);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qpos = qmin + g + 8 * rr;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sc = s[j][2 * rr + e] * scale;
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          sc *= kLog2e;
          if (masked) {
            const int key = k0 + 8 * j + 2 * t + e;
            bool ok = key < kv_len;
            if (causal) ok = ok && (key <= qpos || key < prefix);
            if (window >= 0) ok = ok && key > qpos - window;
            if (!ok) sc = kNegInf;
          }
          s[j][2 * rr + e] = sc;
          mx = fmaxf(mx, sc);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      // guard rows that have seen no visible key (exp of NEG_INF - NEG_INF)
      const float m_safe = m_new <= kNegInf ? 0.f : m_new;
      const float alpha =
          m[rr] <= kNegInf ? 0.f : exp2_approx(m[rr] - m_safe);
      m[rr] = m_new;
      l[rr] *= alpha;
#pragma unroll
      for (int j = 0; j < kDt; ++j) {
        o[j][2 * rr] *= alpha;
        o[j][2 * rr + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * rr + e];
          const float p = x <= kNegInf ? 0.f : exp2_approx(x - m_safe);
          s[j][2 * rr + e] = p;
          l[rr] += p;
        }
      }
    }

    // ---- O += P V
    if constexpr (C::kBf16) {
      // P = hi + lo in two bf16 terms (16 bits of P), against V exact
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int j = 0; j < kDt; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vs + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) *
                                         kLd + j * 8 + (lane / 16) * 8);
          mma_bf16(o[j], lo, bf[0], bf[1]);
          mma_bf16(o[j + 1], lo, bf[2], bf[3]);
          mma_bf16(o[j], hi, bf[0], bf[1]);
          mma_bf16(o[j + 1], hi, bf[2], bf[3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kNt; ++kk) {
        // A column t is key 2t, column t + 4 key 2t + 1 of this 8-key step
        const Split a[4] = {split(s[kk][0]), split(s[kk][2]), split(s[kk][1]),
                            split(s[kk][3])};
        const float* vr = vs + (kk * 8 + 2 * t) * kLd + g;
#pragma unroll
        for (int j = 0; j < kDt; ++j) {
          mma_3xtf32(o[j], a, split(vr[j * 8]), split(vr[kLd + j * 8]));
        }
      }
    }
    __syncthreads();                 // this stage is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lsum = l[rr];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int row = row0 + wrow + g + 8 * rr;
    if (row >= s_len) continue;
    if (kLse && t == 0) {
      // m is in log2 units; a row that saw no key keeps m at kNegInf
      lse[(b * heads + h) * s_len + row] =
          m[rr] <= kNegInf ? __int_as_float(0xff800000)   // -inf
                          : (m[rr] + log2f(lsum)) * kLn2;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    T* op = out + ((b * s_len + row) * heads + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDt; ++j) {
      store2(op + 8 * j, o[j][2 * rr] * inv, o[j][2 * rr + 1] * inv);
    }
  }
}

template <typename T, int D, bool kLse>
cudaError_t launch_kernel(const T* q, const T* k, const T* v, T* out,
                          float* lse, int batch, int s_len, int kv_len,
                          int heads, int kv_heads, bool causal, int window,
                          int prefix, float softcap, int q_offset,
                          float scale, cudaStream_t s) {
  const size_t smem = Cfg<T, D>::kSmem;
  // above 48 KB only once raised; set before every launch, since the
  // attribute is per device and the current device may change
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_kernel<T, D, kLse>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  constexpr int kRows = Cfg<T, D>::kRows;
  const dim3 grid((s_len + kRows - 1) / kRows, heads, batch);
  flash_attention_kernel<T, D, kLse><<<grid, kThreads, smem, s>>>(
      q, k, v, out, lse, s_len, kv_len, heads, kv_heads, causal, window,
      prefix, softcap, q_offset, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dim(const T* q, const T* k, const T* v, T* out, float* lse,
                       int batch, int s_len, int kv_len, int heads,
                       int kv_heads, bool causal, int window, int prefix,
                       float softcap, int q_offset, float scale,
                       cudaStream_t s) {
  if (lse != nullptr) {
    return launch_kernel<T, D, true>(q, k, v, out, lse, batch, s_len, kv_len,
                                     heads, kv_heads, causal, window, prefix,
                                     softcap, q_offset, scale, s);
  }
  return launch_kernel<T, D, false>(q, k, v, out, lse, batch, s_len, kv_len,
                                    heads, kv_heads, causal, window, prefix,
                                    softcap, q_offset, scale, s);
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, float* lse, int batch, int s_len,
                         int kv_len, int heads, int kv_heads, int head_dim,
                         bool causal, int window, int prefix, float softcap,
                         int q_offset, float scale, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (head_dim) {
    case 64:
      return launch_dim<T, 64>(qt, kt, vt, ot, lse, batch, s_len, kv_len,
                               heads, kv_heads, causal, window, prefix,
                               softcap, q_offset, scale, s);
    case 80:
      return launch_dim<T, 80>(qt, kt, vt, ot, lse, batch, s_len, kv_len,
                               heads, kv_heads, causal, window, prefix,
                               softcap, q_offset, scale, s);
    case 128:
      return launch_dim<T, 128>(qt, kt, vt, ot, lse, batch, s_len, kv_len,
                                heads, kv_heads, causal, window, prefix,
                                softcap, q_offset, scale, s);
    case 256:
      return launch_dim<T, 256>(qt, kt, vt, ot, lse, batch, s_len, kv_len,
                                heads, kv_heads, causal, window, prefix,
                                softcap, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window < 0 means no sliding window.
// q, k, v and out must be 16-byte aligned.  lse: null, or a float32
// (B, H, S) output for the rows' log-sum-exp.  Returns the launch's error
// code (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int batch, int s_len, int kv_len,
                                      int heads, int kv_heads, int head_dim,
                                      int causal, int window, int prefix,
                                      float softcap, int q_offset,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0) {
    return static_cast<int>(launch_typed<float>(
        q, k, v, out, lse_f, batch, s_len, kv_len, heads, kv_heads, head_dim,
        causal != 0, window, prefix, softcap, q_offset, scale, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_typed<__nv_bfloat16>(
        q, k, v, out, lse_f, batch, s_len, kv_len, heads, kv_heads, head_dim,
        causal != 0, window, prefix, softcap, q_offset, scale, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
