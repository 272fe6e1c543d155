// Backward of the online-softmax prefill attention (flash_attention.cu) for
// Hopper (sm_90a), on tensor cores, in two passes and without atomics.
//
// The Pallas TPU kernel src/repro/kernels/flash_attention.py has no
// backward: the reference trains through XLA's autodiff of
// repro.kernels.ref.attention_ref (src/repro/kernels/ref.py:112), and that
// is the gradient computed here.  Given q (B, S, H, D), k and v
// (B, L, KV, D), the forward's output o (B, S, H, D), its rows' log-sum-exp
// lse (B, H, S) fp32 (natural log, in the scaled and softcapped score space
// the forward normalises in; -inf for a row that sees no key) and the
// output gradient dO, it writes dq, dk and dv in q's, k's and v's dtype,
// accumulated in fp32:
//   s = scale * q k^T,  c = softcap * tanh(s / softcap) (or s),
//   P = exp(c - lse) where the rule lets the row see the key, else 0,
//   dP = dO v^T,  Delta = rowsum(dO * o),  dC = P * (dP - Delta),
//   dS = dC * (1 - (c / softcap)^2) with a softcap, else dC,
//   dq = scale * dS k,  dk = scale * dS^T q,  dv = P^T dO.
// The visibility rules are the forward's, element for element: keys at or
// beyond kv_len, causal (key <= q_pos, or key < prefix: prefix-LM), the
// sliding window (key > q_pos - window), q_pos = row + q_offset.  A row
// that sees no key has P = 0: its dq is 0 and it adds nothing to dk or dv,
// as the forward's output for it is 0.
//
// Pass 1 (dq): a block owns 64 query rows of one (batch, head), 16 a warp,
// computes Delta for them (written to a (B, H, S) fp32 scratch for pass 2)
// and walks the 32-key tiles its rows can see: S = Q K^T and dP = dO V^T
// into accumulator fragments, dS in registers, dq += dS K.
// Pass 2 (dk, dv): a block owns 64 keys of one (batch, kv-head), 16 a warp,
// and walks the H / KV q-heads of that kv-head and the 32-row query tiles
// that can see its keys: S^T = K Q^T and dP^T = V dO^T, then dv += P^T dO
// and dk += dS^T Q.  The GQA sum stays inside the block: no atomics, and a
// run is deterministic.
//
// Bound: operations at the training shapes (five products of the
// forward's size, 10 * D flops a visible (row, key) pair).  Every product
// is the forward's mma.sync tile (flash_attention.cu): bf16 m16n8k16 with
// P and dS split into two bf16 terms (hi = bf16(x), lo = bf16(x - hi)), fp32
// by 3xTF32 m16n8k8 with the keys (or rows) read in the order that makes
// the score accumulator the next product's A fragment, each 32-wide tile's
// products summed in a fresh accumulator and added to the running one in
// fp32 (measured on an H100 at S = 2048, rep 2: chaining the mma
// accumulation over all 128 tiles put dk and dv at 2.2x the fp32
// tolerance, the fresh accumulators at 0.2x).  Both passes share
// two warp routines: ``warp_scores`` (a 16 x 32 tile of X Y^T over D) and
// ``warp_accumulate`` (acc += P Z for a 16 x 32 P held as that tile).  The
// block keeps its own 64 rows of two operands in shared memory and streams
// the other two through a ring of cp.async stages (two where two blocks of
// an SM still fit, else one).  At D = 256 two warps share each 16 rows, one
// half of D each, so that two D-wide accumulators (dk and dv) stay in
// registers; they repeat the score products, which cost less than the
// spills.  The warpgroup (wgmma / TMA) form is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockRows = 64;      // rows (pass 1) or keys (pass 2) a block
constexpr int kTile = 32;           // keys (pass 1) or rows (pass 2) a tile
constexpr int kNt = kTile / 8;      // 8-wide accumulator tiles of a score row

template <typename T, int D>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kLd = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kSplit = D > 128 ? 2 : 1;    // warps on one 16 rows
  static constexpr int kThreads = 128 * kSplit;
  static constexpr int kDt = D / 8 / kSplit;        // 8-column tiles a warp
  // the block's two resident 64-row operands and their rows' lse, Delta
  static constexpr size_t kFixed =
      sizeof(T) * 2 * kBlockRows * kLd + sizeof(float) * 2 * kBlockRows;
  // a ring stage: two 32-row operands and their rows' lse, Delta
  static constexpr size_t kStage =
      sizeof(T) * 2 * kTile * kLd + sizeof(float) * 2 * kTile;
  static constexpr int kStages = kFixed + 2 * kStage <= 116 * 1024 ? 2 : 1;
  static constexpr size_t kSmem = kFixed + kStages * kStage;
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;
  float* delta;
  T* dq;
  T* dk;
  T* dv;
  int s_len, kv_len, heads, kv_heads;
  bool causal;
  int window, prefix;
  float softcap;
  int q_offset;
  float scale;
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

// rows [r0, r0 + n) of a matrix whose row r starts at base + r * stride,
// into shared rows of kLd; rows >= limit are zeros
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* base,
                                          long long stride, int r0, int n,
                                          int limit) {
  using C = Cfg<T, D>;
  for (int i = threadIdx.x; i < n * C::kChunks; i += C::kThreads) {
    const int r = i / C::kChunks, c = i % C::kChunks;
    const int row = r0 + r;
    const bool ok = row < limit;
    const T* src = base + (ok ? row * stride : 0) + c * (16 / sizeof(T));
    cp_async16(dst + r * C::kLd + c * (16 / sizeof(T)), src, ok);
  }
}

// ---- bf16 fragments (as in flash_attention.cu)
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

// ---- 3xTF32: each product accumulates lo*hi + hi*lo + hi*hi, where hi
// is x rounded to the nearest tf32 value (its low 13 mantissa bits cleared
// after adding half of their range) and lo = x - hi, exact in fp32.  The
// forward (flash_attention.cu) truncates instead, which gives every lo
// x's sign, so that the dropped lo*lo terms (about 2^-22 of a product)
// all lean the product's way; rounded, lo's sign is random.  The integer
// add costs one instruction; cvt.rna.tf32.f32 would cost more.
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split (&a)[4],
                                           Split b0, Split b1) {
  const uint32_t ah[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  const uint32_t al[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
  mma_tf32(c, al, b0.hi, b1.hi);
  mma_tf32(c, ah, b0.lo, b1.lo);
  mma_tf32(c, ah, b0.hi, b1.hi);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// the forward's visibility of key ``key`` from query position ``qpos``
__device__ __forceinline__ bool visible(int qpos, int key, int kv_len,
                                        bool causal, int window, int prefix) {
  bool ok = key < kv_len;
  if (causal) ok = ok && (key <= qpos || key < prefix);
  if (window >= 0) ok = ok && key > qpos - window;
  return ok;
}

// s = X Y^T over D for a warp: X's 16 rows at xs, Y's 32 rows at ys (both
// of pitch kLd).  s[j] holds columns 8j + 2t, 8j + 2t + 1 of rows g, g + 8.
template <typename T, int D>
__device__ __forceinline__ void warp_scores(const T* xs, const T* ys,
                                            float (&s)[kNt][4]) {
  using C = Cfg<T, D>;
  constexpr int kLd = C::kLd;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kNt; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if constexpr (C::kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, xs + (lane % 8 + (lane / 8 % 2) * 8) * kLd + kk * 16 +
                         (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < kNt; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ys + (j * 8 + lane % 8 + (lane / 16) * 8) * kLd +
                            kk * 16 + (lane / 8 % 2) * 8);
        mma_bf16(s[j], a, bf[0], bf[1]);
        mma_bf16(s[j + 1], a, bf[2], bf[3]);
      }
    }
  } else {
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* xr = xs + g * kLd + kk * 8 + t;
      const Split a[4] = {split(xr[0]), split(xr[8 * kLd]), split(xr[4]),
                          split(xr[8 * kLd + 4])};
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const float* yr = ys + (j * 8 + g) * kLd + kk * 8 + t;
        mma_3xtf32(s[j], a, split(yr[0]), split(yr[4]));
      }
    }
  }
}

// acc += P Z for a warp: P (16 x 32) in warp_scores' layout, Z's 32 rows at
// zs (pitch kLd), output columns [col0, col0 + 8 kDt).  acc[j] holds columns
// col0 + 8j + 2t, + 1 of rows g, g + 8.
template <typename T, int D>
__device__ __forceinline__ void warp_accumulate(
    const float (&p)[kNt][4], const T* zs, int col0,
    float (&acc)[Cfg<T, D>::kDt][4]) {
  using C = Cfg<T, D>;
  constexpr int kLd = C::kLd, kDt = C::kDt;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (C::kBf16) {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
      split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
      split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < kDt; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, zs + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) *
                                       kLd + col0 + j * 8 + (lane / 16) * 8);
        mma_bf16(acc[j], lo, bf[0], bf[1]);
        mma_bf16(acc[j + 1], lo, bf[2], bf[3]);
        mma_bf16(acc[j], hi, bf[0], bf[1]);
        mma_bf16(acc[j + 1], hi, bf[2], bf[3]);
      }
    }
  } else {
    // A column t is Z row 2t, column t + 4 row 2t + 1 of each 8-row step
    Split a[kNt][4];
#pragma unroll
    for (int kk = 0; kk < kNt; ++kk) {
      a[kk][0] = split(p[kk][0]);
      a[kk][1] = split(p[kk][2]);
      a[kk][2] = split(p[kk][1]);
      a[kk][3] = split(p[kk][3]);
    }
    // The tile's products go to a fresh accumulator, which is then added
    // to acc in fp32: chained over every tile (1536 mma steps for dk and dv
    // at S = 2048, rep 2) the mma accumulation missed the fp32 tolerance by
    // 2x (see the top of the file).
#pragma unroll
    for (int j = 0; j < kDt; ++j) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kNt; ++kk) {
        const float* zr = zs + (kk * 8 + 2 * t) * kLd + col0 + g + j * 8;
        mma_3xtf32(c, a[kk], split(zr[0]), split(zr[kLd]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += c[i];
    }
  }
}

// P and dS of one score element: ``sc`` the raw dot product, ``dp`` dO . v
__device__ __forceinline__ void grad_element(float sc, float dp, float lse,
                                             float delta, bool ok,
                                             float scale, float softcap,
                                             float& prob, float& ds) {
  sc *= scale;
  float grad = 1.f;
  if (softcap > 0.f) {
    sc = softcap * tanhf(sc / softcap);
    const float u = sc / softcap;
    grad = 1.f - u * u;
  }
  prob = ok ? exp2f((sc - lse) * kLog2e) : 0.f;
  ds = prob * (dp - delta) * grad;
}

// Pass 1: dq and Delta of 64 query rows of one (batch, head)
template <typename T, int D>
__device__ __forceinline__ void dq_pass(const Params<T>& p,
                                        unsigned char* smem) {
  using C = Cfg<T, D>;
  constexpr int kLd = C::kLd, kDt = C::kDt;
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kBlockRows * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kBlockRows * kLd);
  float* delta_s = lse_s + kBlockRows;
  unsigned char* ring = smem + C::kFixed;   // stage i: K, then V

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = (warp % 4) * 16, col0 = (warp / 4) * (D / C::kSplit);
  // the last query tiles see the most keys: start them first
  const int q_tile = gridDim.x - 1 - blockIdx.x, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const int row0 = q_tile * kBlockRows;
  const long long q_stride = static_cast<long long>(p.heads) * D;
  const long long kv_stride = static_cast<long long>(p.kv_heads) * D;
  const long long q_base = (b * p.s_len * p.heads + h) * D;
  const T* kb = p.k + (b * p.kv_len * p.kv_heads + kvh) * D;
  const T* vb = p.v + (b * p.kv_len * p.kv_heads + kvh) * D;
  const long long row_stat = (b * p.heads + h) * p.s_len;

  // the visible key tiles [kt_begin, kt_end), as in the forward
  const int q_first = row0 + p.q_offset;
  const int q_last = min(row0 + kBlockRows, p.s_len) - 1 + p.q_offset;
  const int n_tiles = (p.kv_len + kTile - 1) / kTile;
  int kt_end = n_tiles;
  if (p.causal) {
    const int seen = max(max(q_last + 1, p.prefix), 0);
    kt_end = min(n_tiles, (seen + kTile - 1) / kTile);
  }
  int kt_begin = 0;
  if (p.window >= 0) {
    const int first = q_first - p.window + 1;
    if (first > 0) kt_begin = first / kTile;
  }

  auto load_keys = [&](int kt, int stage) {
    T* ks = reinterpret_cast<T*>(ring + stage * C::kStage);
    load_rows<T, D>(ks, kb, kv_stride, kt * kTile, kTile, p.kv_len);
    load_rows<T, D>(ks + kTile * kLd, vb, kv_stride, kt * kTile, kTile,
                    p.kv_len);
  };
  load_rows<T, D>(qs, p.q + q_base, q_stride, row0, kBlockRows, p.s_len);
  load_rows<T, D>(dos, p.dout + q_base, q_stride, row0, kBlockRows, p.s_len);
  if (kt_begin < kt_end) load_keys(kt_begin, 0);
  cp_async_commit();

  // Delta = rowsum(dO * o) and the lse of the block's rows, a warp a row
  for (int r = warp; r < kBlockRows; r += C::kThreads / 32) {
    const int row = row0 + r;
    float acc = 0.f;
    if (row < p.s_len) {
      const T* dor = p.dout + q_base + row * q_stride;
      const T* orow = p.o + q_base + row * q_stride;
      for (int d = lane; d < D; d += 32) acc += to_f(dor[d]) * to_f(orow[d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      lse_s[r] = row < p.s_len ? p.lse[row_stat + row] : 0.f;
      delta_s[r] = acc;
      if (row < p.s_len) p.delta[row_stat + row] = acc;
    }
  }

  float acc[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    int stage = 0;
    if constexpr (C::kStages == 2) {
      stage = (kt - kt_begin) & 1;
      if (kt + 1 < kt_end) load_keys(kt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();            // this tile (and Q, dO) have landed
    } else {
      if (kt > kt_begin) load_keys(kt, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();                 // also publishes lse_s and delta_s
    const T* ks = reinterpret_cast<const T*>(ring + stage * C::kStage);
    const T* vs = ks + kTile * kLd;

    float s[kNt][4], dp[kNt][4];
    warp_scores<T, D>(qs + wrow * kLd, ks, s);
    warp_scores<T, D>(dos + wrow * kLd, vs, dp);
    const int k0 = kt * kTile;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = wrow + g + 8 * rr, row = row0 + r;
      const int qpos = row + p.q_offset;
      const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = row < p.s_len &&
                          visible(qpos, k0 + 8 * j + 2 * t + e, p.kv_len,
                                  p.causal, p.window, p.prefix);
          float prob;
          grad_element(s[j][2 * rr + e], dp[j][2 * rr + e], lse, delta, ok,
                       p.scale, p.softcap, prob, s[j][2 * rr + e]);
        }
      }
    }
    warp_accumulate<T, D>(s, ks, col0, acc);     // dq += dS K
    __syncthreads();                 // this stage is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + wrow + g + 8 * rr;
    if (row >= p.s_len) continue;
    T* op = p.dq + q_base + row * q_stride + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < kDt; ++j) {
      store2(op + 8 * j, acc[j][2 * rr] * p.scale,
             acc[j][2 * rr + 1] * p.scale);
    }
  }
}

// Pass 2: dk and dv of 64 keys of one (batch, kv-head), summed over its
// H / KV q-heads
template <typename T, int D>
__device__ __forceinline__ void dkv_pass(const Params<T>& p,
                                         unsigned char* smem) {
  using C = Cfg<T, D>;
  constexpr int kLd = C::kLd, kDt = C::kDt;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kBlockRows * kLd;
  unsigned char* ring = smem + C::kFixed;   // stage i: Q, dO, lse, Delta

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = (warp % 4) * 16, col0 = (warp / 4) * (D / C::kSplit);
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int k0 = blockIdx.x * kBlockRows;
  const int k1 = min(k0 + kBlockRows, p.kv_len);
  const int rep = p.heads / p.kv_heads;
  const long long q_stride = static_cast<long long>(p.heads) * D;
  const long long kv_stride = static_cast<long long>(p.kv_heads) * D;
  const long long kv_base = (b * p.kv_len * p.kv_heads + kvh) * D;

  // the query rows [r_begin, r_end) that can see a key of [k0, k1)
  int r_begin = 0, r_end = p.s_len;
  if (p.causal && k0 >= p.prefix) r_begin = max(0, k0 - p.q_offset);
  if (p.window >= 0) r_end = min(r_end, k1 + p.window - 1 - p.q_offset);
  const int t_begin = min(r_begin, p.s_len) / kTile;
  const int n_t =
      r_end > r_begin ? (r_end + kTile - 1) / kTile - t_begin : 0;
  const int n_iter = rep * n_t;      // (q-head, query tile) pairs

  auto load_rows_of = [&](int it, int stage) {
    const int h = kvh * rep + it / n_t, q0 = (t_begin + it % n_t) * kTile;
    const long long q_base = (b * p.s_len * p.heads + h) * D;
    const long long row_stat = (b * p.heads + h) * p.s_len;
    T* qt = reinterpret_cast<T*>(ring + stage * C::kStage);
    T* dot = qt + kTile * kLd;
    load_rows<T, D>(qt, p.q + q_base, q_stride, q0, kTile, p.s_len);
    load_rows<T, D>(dot, p.dout + q_base, q_stride, q0, kTile, p.s_len);
    float* st = reinterpret_cast<float*>(dot + kTile * kLd);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < p.s_len;
      st[threadIdx.x] = ok ? p.lse[row_stat + row] : 0.f;
      st[kTile + threadIdx.x] = ok ? p.delta[row_stat + row] : 0.f;
    }
  };
  load_rows<T, D>(ks, p.k + kv_base, kv_stride, k0, kBlockRows, p.kv_len);
  load_rows<T, D>(vs, p.v + kv_base, kv_stride, k0, kBlockRows, p.kv_len);
  if (n_iter > 0) load_rows_of(0, 0);
  cp_async_commit();

  float dk[kDt][4], dv[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  for (int it = 0; it < n_iter; ++it) {
    int stage = 0;
    if constexpr (C::kStages == 2) {
      stage = it & 1;
      if (it + 1 < n_iter) load_rows_of(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (it > 0) load_rows_of(it, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qt = reinterpret_cast<const T*>(ring + stage * C::kStage);
    const T* dot = qt + kTile * kLd;
    const float* st = reinterpret_cast<const float*>(dot + kTile * kLd);
    const int q0 = (t_begin + it % n_t) * kTile;

    // rows of s and dp are the warp's keys, columns the tile's query rows
    float s[kNt][4], dp[kNt][4];
    warp_scores<T, D>(ks + wrow * kLd, qt, s);   // S^T = K Q^T
    warp_scores<T, D>(vs + wrow * kLd, dot, dp);  // dP^T = V dO^T
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = k0 + wrow + g + 8 * rr;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e, row = q0 + c;
          const bool ok = row < p.s_len &&
                          visible(row + p.q_offset, key, p.kv_len, p.causal,
                                  p.window, p.prefix);
          grad_element(s[j][2 * rr + e], dp[j][2 * rr + e], st[c],
                       st[kTile + c], ok, p.scale, p.softcap,
                       s[j][2 * rr + e], dp[j][2 * rr + e]);
        }
      }
    }
    warp_accumulate<T, D>(s, dot, col0, dv);     // dv += P^T dO
    warp_accumulate<T, D>(dp, qt, col0, dk);     // dk += dS^T Q
    __syncthreads();                 // this stage is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + wrow + g + 8 * rr;
    if (key >= p.kv_len) continue;
    T* kp = p.dk + kv_base + key * kv_stride + col0 + 2 * t;
    T* vp = p.dv + kv_base + key * kv_stride + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < kDt; ++j) {
      store2(kp + 8 * j, dk[j][2 * rr] * p.scale, dk[j][2 * rr + 1] * p.scale);
      store2(vp + 8 * j, dv[j][2 * rr], dv[j][2 * rr + 1]);
    }
  }
}

// one template for both passes: kDkv false is pass 1, true pass 2
template <typename T, int D, bool kDkv>
__global__ void __launch_bounds__(Cfg<T, D>::kThreads)
flash_attention_bwd_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (kDkv) {
    dkv_pass<T, D>(p, smem_raw);
  } else {
    dq_pass<T, D>(p, smem_raw);
  }
}

template <typename T, int D, bool kDkv>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_kernel<T, D, kDkv>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg<T, D>::kSmem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_attention_bwd_kernel<T, D, kDkv>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int D>
cudaError_t launch_dim(const Params<T>& p, int batch, cudaStream_t s) {
  using C = Cfg<T, D>;
  // above 48 KB only once raised; set before every launch, since the
  // attribute is per device and the current device may change
  cudaError_t err = set_smem<T, D, false>();
  if (err != cudaSuccess) return err;
  err = set_smem<T, D, true>();
  if (err != cudaSuccess) return err;
  if (p.s_len == 0 || batch == 0) return cudaSuccess;
  const dim3 rows((p.s_len + kBlockRows - 1) / kBlockRows, p.heads, batch);
  flash_attention_bwd_kernel<T, D, false>
      <<<rows, C::kThreads, C::kSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.kv_len == 0) return err;
  const dim3 keys((p.kv_len + kBlockRows - 1) / kBlockRows, p.kv_heads,
                  batch);
  flash_attention_bwd_kernel<T, D, true>
      <<<keys, C::kThreads, C::kSmem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv, int batch,
                         int s_len, int kv_len, int heads, int kv_heads,
                         int head_dim, bool causal, int window, int prefix,
                         float softcap, int q_offset, float scale,
                         cudaStream_t s) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  p.s_len = s_len;
  p.kv_len = kv_len;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.causal = causal;
  p.window = window;
  p.prefix = prefix;
  p.softcap = softcap;
  p.q_offset = q_offset;
  p.scale = scale;
  switch (head_dim) {
    case 64:
      return launch_dim<T, 64>(p, batch, s);
    case 80:
      return launch_dim<T, 80>(p, batch, s);
    case 128:
      return launch_dim<T, 128>(p, batch, s);
    case 256:
      return launch_dim<T, 256>(p, batch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv); lse and
// delta are float32 (B, H, S), delta a scratch the call fills.  Every
// tensor is contiguous in the forward's layout; q, k, v and dout are
// 16-byte aligned (the kernel copies 16-byte chunks).  window < 0 means no
// sliding window.  Two launches (the dq pass, then the dk / dv pass) on
// ``stream``; returns the first launch error (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int s_len, int kv_len, int heads, int kv_heads,
    int head_dim, int causal, int window, int prefix, float softcap,
    int q_offset, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_typed<float>(
        q, k, v, o, dout, lse, delta, dq, dk, dv, batch, s_len, kv_len, heads,
        kv_heads, head_dim, causal != 0, window, prefix, softcap, q_offset,
        scale, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_typed<__nv_bfloat16>(
        q, k, v, o, dout, lse, delta, dq, dk, dv, batch, s_len, kv_len, heads,
        kv_heads, head_dim, causal != 0, window, prefix, softcap, q_offset,
        scale, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
