// Backward of the online-softmax prefill attention (flash_attention.cu) for
// Hopper (sm_90a), on tensor cores, in one launch after a short Delta
// launch, without atomics.
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
// Launch 1 (flash_attention_bwd_delta_launch): Delta into a (B, H, S) fp32
// scratch, one row of o and dO a group of lanes, 16-byte loads (two or
// four rows a warp side by side where a row has 256 bytes or fewer).
// Launch 2 (flash_attention_bwd_launch): one grid of two kinds of blocks,
// which run side by side.  A dk/dv block owns kRows keys of one (batch,
// kv-head) and walks the H / KV q-heads of that kv-head and the query
// tiles of kTile rows that can see its keys: S^T = K Q^T and dP^T = V dO^T,
// then dv += P^T dO and dk += dS^T Q.  A dq block owns kRows query rows of
// one (batch, head) and walks the key tiles they can see: S = Q K^T,
// dP = dO V^T, dq += dS K.  The dk/dv blocks come first, those of the
// first keys (which see the most rows under the causal rule) first; then
// the dq blocks, those of the last rows first.  Each gradient element is
// summed by one warp (or two, added once in a fixed order): no atomics,
// and a run is bitwise deterministic.  dq recomputes S and dP: seven
// products a visible pair against the bound's five, the price of no
// atomics (one pass would add dq across the key blocks).
//
// Work structure (`tiles_of`; rows, tile, split_d, split_n).  A warp owns
// 16 of the block's rows.  kSplitN = 2 warps share them, each taking half
// of every streamed tile with partial accumulators of its own, summed
// through shared memory at the end; kSplitD = 2 warps share them at
// D = 256, each accumulating half of D (both compute the scores).
//   bf16, D <= 128: (64, 32, 1, 1), 4 warps, three cp.async stages (tiles
//     i + 1 and i + 2 land while tile i computes; one barrier a tile), two
//     blocks an SM.  A warp keeps its rows of the block's first operand (Q,
//     or K in a dk/dv block) as ldmatrix fragments for the whole walk; the
//     second's (dO, V) find no room beside a dk/dv warp's two D-wide
//     accumulators (128 registers).
//   fp32, D <= 128: (64, 32, 1, 2), 8 warps, two stages (three ran slower
//     at 8 x 128), one block an SM (170 KB at D = 128).  Each streamed tile
//     is split into its tf32 parts once, when it has landed: hi in place, lo
//     into a buffer of its own (a second barrier a tile).
//   D = 256: (32, 32 in bf16 or 16 in fp32, 2, 2), 8 warps, one block an SM.
// The two score products run in one loop as independent accumulator
// chains (in fp32 the lo*hi and hi*lo terms in accumulators of their own).
// A warp's part of a tile that sees no key skips its products; a part
// inside the rule skips the element-wise test.  exp is ex2.approx.ftz.
// `scripts/flash_bwd_variants.py` times the alternatives in turns.
//
// Shared-memory bytes a mma.  bf16 (m16n8k16): a 16 x 32 score tile reads
// each 16-deep B fragment (256 B) for one mma and its A fragment (512 B a
// k-step) for four, 384 B a mma, or 256 B with A in registers (S, and S^T
// in a dk/dv block); P Z reads 512 B of B for four mma, the hi and lo
// terms of two 8-column tiles: 128 B a mma, 256 a product (the old
// kernel's figures, but for S and S^T).  fp32 (m16n8k8, three tf32 mma a
// product): with 16 x 16 warp tiles A costs 512 B a k-step over 6 mma and
// B, split in shared memory, 512 B over 3: 256 B a mma, where the old
// kernel's 16 x 32 tiles of unsplit operands read 128 (and split every
// element in every warp that read it).  What the fp32 design buys is eight
// warps an SM and loads under the products.
//
// Bound: operations at 4 x 2048 (five products of the forward's size,
// 10 * D flops a visible (row, key) pair), bytes at qwen3-0.6b's training
// shape of 8 x 128 (q, k, v, o, dO and lse read once, dq, dk, dv written
// once).  Numerics: bf16 products are mma.sync m16n8k16 with P and dS as
// two bf16 terms (hi = bf16(x), lo = bf16(x - hi)): one term missed
// chip_smoke.py's bf16 rule by 5.0x at 8 x 128 and 8.7x at 4 x 2048.  fp32
// products are 3xTF32 m16n8k8 with the keys (or rows) read in the order
// that makes the score accumulator the next product's A fragment, each
// tile's P Z product summed in a fresh accumulator and added to the
// running one in fp32 (measured on an H100 at S = 2048, rep 2: chaining
// the mma accumulation over all 128 tiles put dk and dv at 2.2x the fp32
// tolerance, the fresh accumulators at 0.2x).  A wgmma form of the P Z
// products (a warpgroup a block, B read once from shared memory) checked
// right in a probe and ran slower than mma.sync; it was not kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct TileCfg {
  int rows, tile, split_d, split_n;
};
// the tiles of one (dtype, D): see the top of the file
constexpr TileCfg tiles_of(bool bf16, int d) {
  return d == 256 ? TileCfg{32, bf16 ? 32 : 16, 2, 2}
         : bf16   ? TileCfg{64, 32, 1, 1}
                  : TileCfg{64, 32, 1, 2};
}

template <typename T, int D>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr TileCfg kT = tiles_of(kBf16, D);
  static constexpr int kRows = kT.rows;         // a block's own rows
  static constexpr int kTile = kT.tile;         // streamed rows a stage
  static constexpr int kSplitD = kT.split_d;
  static constexpr int kSplitN = kT.split_n;
  static constexpr int kRowWarps = kRows / 16;
  static constexpr int kWarps = kRowWarps * kSplitD * kSplitN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kW = kTile / kSplitN;    // a warp's score columns
  static constexpr int kNt = kW / 8;            // its 8-wide score tiles
  static constexpr int kDw = D / kSplitD;       // its accumulator columns
  static constexpr int kDt = kDw / 8;
  static constexpr int kElem = static_cast<int>(sizeof(T));
  static constexpr int kLd = D + 16 / kElem;    // row pitch, in elements
  static constexpr int kChunks = D * kElem / 16;
  // three stages in bf16; two in fp32, whose lo buffer leaves less room
  // (three ran slower at 8 x 128)
  static constexpr int kStages = kBf16 ? 3 : 2;
  // the block's two operands of kRows rows and their rows' lse, Delta
  static constexpr int kFixed = 2 * kRows * kLd * kElem + 2 * kRows * 4;
  // a stage: two streamed operands of kTile rows and their lse, Delta
  static constexpr int kStage = 2 * kTile * kLd * kElem + 2 * kTile * 4;
  // fp32: the lo parts of the tile in use
  static constexpr int kLo = kBf16 ? 0 : 2 * kTile * kLd * 4;
  static constexpr int kSmem = kFixed + kStages * kStage + kLo;
  // the partial accumulators of the kSplitN > 1 warps (two in a dk/dv
  // block), summed through the ring once the walk is over
  static constexpr int kPartial =
      (kSplitN - 1) * kRowWarps * kSplitD * 32 * 2 * kDt * 4 * 4;
  // bf16 at D <= 128: a warp keeps its Q (or K) rows as register fragments
  static constexpr bool kFrag = kBf16 && kSplitD == 1;
  static constexpr int kMinBlocks = kWarps == 4 ? 2 : 1;
  static_assert(kRows % 16 == 0 && kW % (kBf16 ? 16 : 8) == 0, "tiles");
  static_assert(kDt % 2 == 0 || !kBf16, "bf16 P Z takes 8-column pairs");
  static_assert(kPartial <= kStages * kStage + kLo, "partials fit");
  static_assert(kSmem <= 227 * 1024, "shared memory");
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  T* dq;
  T* dk;
  T* dv;
  int batch, s_len, kv_len, heads, kv_heads;
  bool causal;
  int window, prefix;
  float softcap;
  int q_offset;
  float scale;
  int n_qb, n_dkv;   // row blocks a (b, head), dk/dv blocks in the grid
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
// 4 bytes global -> shared, or 4 zero bytes when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
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
  constexpr int kEl = 16 / C::kElem;
  for (int i = threadIdx.x; i < n * C::kChunks; i += C::kThreads) {
    const int r = i / C::kChunks, c = i % C::kChunks;
    const int row = r0 + r;
    const bool ok = row < limit;
    const T* src = base + (ok ? row * stride : 0) + c * kEl;
    cp_async16(dst + r * C::kLd + c * kEl, src, ok);
  }
}
// n floats from src + r0 on, zeros from index limit on
template <int kThreads>
__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           int r0, int n, int limit) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = r0 + i < limit;
    cp_async4(dst + i, src + (ok ? r0 + i : 0), ok);
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
// a B element already split in shared memory: hi at h, lo at l
__device__ __forceinline__ Split staged(const float* h, const float* l) {
  return {__float_as_uint(*h), __float_as_uint(*l)};
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the forward's visibility of key ``key`` from query position ``qpos``
__device__ __forceinline__ bool visible(int qpos, int key, int kv_len,
                                        bool causal, int window, int prefix) {
  bool ok = key < kv_len;
  if (causal) ok = ok && (key <= qpos || key < prefix);
  if (window >= 0) ok = ok && key > qpos - window;
  return ok;
}

// The 16 rows of a warp's A operand as register fragments (bf16), one
// ldmatrix.x4 a 16-deep k-step, or nothing (read at each use).
template <typename T, int D, bool kReg>
struct ResidentA {
  __device__ __forceinline__ void load(const T*) {}
};
template <int D>
struct ResidentA<__nv_bfloat16, D, true> {
  uint32_t f[D / 16][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* xs) {
    constexpr int kLd = Cfg<__nv_bfloat16, D>::kLd;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldmatrix_x4(f[kk], xs + (lane % 8 + (lane / 8 % 2) * 8) * kLd +
                             kk * 16 + (lane / 16) * 8);
    }
  }
};

// s0 = X0 Y0^T and s1 = X1 Y1^T over D for a warp, in one loop (the two
// products' accumulators are independent chains): Xi's 16 rows at xsi (X0's
// in ra0 with kReg0), Yi's kW rows at ysi (pitch kLd; in fp32 their tf32 hi
// parts, the lo parts at yli).  s[j] holds columns 8j + 2t, 8j + 2t + 1 of rows g,
// g + 8.  In fp32 the lo*hi and hi*lo terms go to accumulators of their
// own, added to the hi*hi ones at the end: two chains of two mma and one
// where one chain of three was.
template <typename T, int D, bool kReg0>
__device__ __forceinline__ void warp_scores2(
    const T* xs0, const ResidentA<T, D, kReg0>& ra0, const T* ys0,
    const float* yl0, const T* xs1, const T* ys1, const float* yl1,
    float (&s0)[Cfg<T, D>::kNt][4], float (&s1)[Cfg<T, D>::kNt][4]) {
  using C = Cfg<T, D>;
  constexpr int kLd = C::kLd, kNt = C::kNt;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s0[j][i] = s1[j][i] = 0.f;
  }
  if constexpr (C::kBf16) {
    const int arow = (lane % 8 + (lane / 8 % 2) * 8) * kLd + (lane / 16) * 8;
    const int brow = (lane % 8 + (lane / 16) * 8) * kLd + (lane / 8 % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0[4], a1[4];
      if constexpr (kReg0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a0[i] = ra0.f[kk][i];
      } else {
        ldmatrix_x4(a0, xs0 + arow + kk * 16);
      }
      ldmatrix_x4(a1, xs1 + arow + kk * 16);
#pragma unroll
      for (int j = 0; j < kNt; j += 2) {
        uint32_t b0[4], b1[4];
        ldmatrix_x4(b0, ys0 + j * 8 * kLd + brow + kk * 16);
        ldmatrix_x4(b1, ys1 + j * 8 * kLd + brow + kk * 16);
        mma_bf16(s0[j], a0, b0[0], b0[1]);
        mma_bf16(s1[j], a1, b1[0], b1[1]);
        mma_bf16(s0[j + 1], a0, b0[2], b0[3]);
        mma_bf16(s1[j + 1], a1, b1[2], b1[3]);
      }
    }
  } else {
    float l0[kNt][4], l1[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) l0[j][i] = l1[j][i] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* xr0 = xs0 + g * kLd + kk * 8 + t;
      const float* xr1 = xs1 + g * kLd + kk * 8 + t;
      const Split a0[4] = {split(xr0[0]), split(xr0[8 * kLd]), split(xr0[4]),
                           split(xr0[8 * kLd + 4])};
      const Split a1[4] = {split(xr1[0]), split(xr1[8 * kLd]), split(xr1[4]),
                           split(xr1[8 * kLd + 4])};
      const uint32_t h0[4] = {a0[0].hi, a0[1].hi, a0[2].hi, a0[3].hi};
      const uint32_t q0[4] = {a0[0].lo, a0[1].lo, a0[2].lo, a0[3].lo};
      const uint32_t h1[4] = {a1[0].hi, a1[1].hi, a1[2].hi, a1[3].hi};
      const uint32_t q1[4] = {a1[0].lo, a1[1].lo, a1[2].lo, a1[3].lo};
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const int o = (j * 8 + g) * kLd + kk * 8 + t;
        const Split b00 = staged(ys0 + o, yl0 + o);
        const Split b01 = staged(ys0 + o + 4, yl0 + o + 4);
        const Split b10 = staged(ys1 + o, yl1 + o);
        const Split b11 = staged(ys1 + o + 4, yl1 + o + 4);
        mma_tf32(s0[j], h0, b00.hi, b01.hi);
        mma_tf32(s1[j], h1, b10.hi, b11.hi);
        mma_tf32(l0[j], q0, b00.hi, b01.hi);
        mma_tf32(l1[j], q1, b10.hi, b11.hi);
        mma_tf32(l0[j], h0, b00.lo, b01.lo);
        mma_tf32(l1[j], h1, b10.lo, b11.lo);
      }
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s0[j][i] += l0[j][i];
        s1[j][i] += l1[j][i];
      }
    }
  }
}

// acc += P Z for a warp: P (16 x kW) in warp_scores' layout, Z's kW rows
// at zs (pitch kLd, from the warp's first output column; in fp32 their hi
// parts, the lo parts at zl).  acc[j] holds output columns 8j + 2t, + 1 of
// rows g, g + 8.
template <typename T, int D>
__device__ __forceinline__ void warp_accumulate(
    const float (&p)[Cfg<T, D>::kNt][4], const T* zs, const float* zl,
    float (&acc)[Cfg<T, D>::kDt][4]) {
  using C = Cfg<T, D>;
  constexpr int kLd = C::kLd, kNt = C::kNt, kDt = C::kDt;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (C::kBf16) {
#pragma unroll
    for (int kk = 0; kk < C::kW / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
      split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
      split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < kDt; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, zs + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) *
                                       kLd + j * 8 + (lane / 16) * 8);
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
        const int o = (kk * 8 + 2 * t) * kLd + g + j * 8;
        mma_3xtf32(c, a[kk], staged(zs + o, zl + o),
                   staged(zs + o + kLd, zl + o + kLd));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += c[i];
    }
  }
}

// 2^x, ex2.approx.ftz: about 2 ulp, results below 2^-126 flushed to 0
// (exp2f's range handling around it ran slower)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P and dS of one score element: ``sc`` the raw dot product, ``dp`` dO . v,
// ``lse2`` the row's log-sum-exp times log2(e), ``scale2`` the scale times
// log2(e)
__device__ __forceinline__ void grad_element(float sc, float dp, float lse2,
                                             float delta, bool ok,
                                             float scale, float scale2,
                                             float softcap, float& prob,
                                             float& ds) {
  if (softcap > 0.f) {
    const float u = tanhf(sc * scale / softcap);
    prob = ok ? ex2(softcap * kLog2e * u - lse2) : 0.f;
    ds = prob * (dp - delta) * (1.f - u * u);
  } else {
    prob = ok ? ex2(sc * scale2 - lse2) : 0.f;
    ds = prob * (dp - delta);
  }
}

// Whether every (row, key) of rows [row_lo, row_hi] and keys [key_lo,
// key_hi] is visible: such a tile skips the element-wise test.
template <typename T>
__device__ __forceinline__ bool all_visible(const Params<T>& p, int row_lo,
                                            int row_hi, int key_lo,
                                            int key_hi) {
  bool ok = row_hi < p.s_len && key_hi < p.kv_len;
  if (p.causal) ok = ok && (key_hi <= row_lo + p.q_offset || key_hi < p.prefix);
  if (p.window >= 0) ok = ok && key_lo > row_hi + p.q_offset - p.window;
  return ok;
}

// One block's walk.  kDkv: dk and dv of kRows keys of one (batch,
// kv-head), summed over its H / KV q-heads; else dq of kRows query rows of
// one (batch, head).  ``blk`` is the block's index among its kind.
template <typename T, int D, bool kDkv>
__device__ __forceinline__ void walk(const Params<T>& p, unsigned char* smem,
                                     int blk) {
  using C = Cfg<T, D>;
  constexpr int kLd = C::kLd, kRows = C::kRows, kTile = C::kTile;
  constexpr int kNt = C::kNt, kDt = C::kDt;
  T* x0 = reinterpret_cast<T*>(smem);      // dq: Q, dk/dv: K
  T* x1 = x0 + kRows * kLd;                // dq: dO, dk/dv: V
  float* rstat = reinterpret_cast<float*>(x1 + kRows * kLd);  // lse, Delta
  unsigned char* ring = smem + C::kFixed;  // stage: Y0, Y1, lse, Delta
  float* lo0 = reinterpret_cast<float*>(ring + C::kStages * C::kStage);
  float* lo1 = lo0 + kTile * kLd;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp % C::kRowWarps;
  const int wn = (warp / C::kRowWarps) % C::kSplitN;
  const int wd = warp / (C::kRowWarps * C::kSplitN);
  const int rrow = wr * 16, col0 = wn * C::kW, dcol = wd * C::kDw;
  const int rep = p.heads / p.kv_heads;
  const long long q_stride = static_cast<long long>(p.heads) * D;
  const long long kv_stride = static_cast<long long>(p.kv_heads) * D;

  long long b;
  int head, first;   // dq: q-head, first row; dk/dv: kv-head, first key
  int n_iter, t_begin = 0, n_t = 1;
  if constexpr (kDkv) {
    const int per = p.batch * p.kv_heads;
    b = (blk % per) / p.kv_heads;
    head = (blk % per) % p.kv_heads;
    first = (blk / per) * kRows;
    // the query rows [r_begin, r_end) that can see a key of the block
    const int k1 = min(first + kRows, p.kv_len);
    int r_begin = 0, r_end = p.s_len;
    if (p.causal && first >= p.prefix) r_begin = max(0, first - p.q_offset);
    if (p.window >= 0) r_end = min(r_end, k1 + p.window - 1 - p.q_offset);
    t_begin = min(r_begin, p.s_len) / kTile;
    n_t = r_end > r_begin ? (r_end + kTile - 1) / kTile - t_begin : 0;
    n_iter = rep * n_t;            // (q-head, query tile) pairs
  } else {
    const int per = p.batch * p.heads;
    b = (blk % per) / p.heads;
    head = (blk % per) % p.heads;
    first = (p.n_qb - 1 - blk / per) * kRows;
    // the visible key tiles [t_begin, t_begin + n_iter), as in the forward
    const int q_first = first + p.q_offset;
    const int q_last = min(first + kRows, p.s_len) - 1 + p.q_offset;
    const int n_tiles = (p.kv_len + kTile - 1) / kTile;
    int kt_end = n_tiles;
    if (p.causal) {
      const int seen = max(max(q_last + 1, p.prefix), 0);
      kt_end = min(n_tiles, (seen + kTile - 1) / kTile);
    }
    if (p.window >= 0) {
      const int w_first = q_first - p.window + 1;
      if (w_first > 0) t_begin = w_first / kTile;
    }
    n_iter = max(0, kt_end - t_begin);
  }
  const T* own0;
  const T* own1;
  long long own_stride;
  int own_limit;
  if constexpr (kDkv) {
    const long long base = (b * p.kv_len * p.kv_heads + head) * D;
    own0 = p.k + base;
    own1 = p.v + base;
    own_stride = kv_stride;
    own_limit = p.kv_len;
  } else {
    const long long base = (b * p.s_len * p.heads + head) * D;
    own0 = p.q + base;
    own1 = p.dout + base;
    own_stride = q_stride;
    own_limit = p.s_len;
  }

  // tile ``it`` into ring stage ``stage``; its first streamed row
  auto tile_row = [&](int it) {
    return kDkv ? (t_begin + it % n_t) * kTile : (t_begin + it) * kTile;
  };
  // the streamed operands' first rows (a dk/dv block: of its first q-head)
  const T* str0;
  const T* str1;
  if constexpr (kDkv) {
    const long long base = (b * p.s_len * p.heads + head * rep) * D;
    str0 = p.q + base;
    str1 = p.dout + base;
  } else {
    const long long base = (b * p.kv_len * p.kv_heads + head / rep) * D;
    str0 = p.k + base;
    str1 = p.v + base;
  }
  auto load_tile = [&](int it, int stage) {
    T* y0 = reinterpret_cast<T*>(ring + stage * C::kStage);
    T* y1 = y0 + kTile * kLd;
    const int r0 = tile_row(it);
    if constexpr (kDkv) {
      const int hq = it / n_t;
      const long long stat = (b * p.heads + head * rep + hq) * p.s_len;
      float* st = reinterpret_cast<float*>(y1 + kTile * kLd);
      load_rows<T, D>(y0, str0 + hq * D, q_stride, r0, kTile, p.s_len);
      load_rows<T, D>(y1, str1 + hq * D, q_stride, r0, kTile, p.s_len);
      load_stats<C::kThreads>(st, p.lse + stat, r0, kTile, p.s_len);
      load_stats<C::kThreads>(st + kTile, p.delta + stat, r0, kTile,
                              p.s_len);
    } else {
      load_rows<T, D>(y0, str0, kv_stride, r0, kTile, p.kv_len);
      load_rows<T, D>(y1, str1, kv_stride, r0, kTile, p.kv_len);
    }
  };

  load_rows<T, D>(x0, own0, own_stride, first, kRows, own_limit);
  load_rows<T, D>(x1, own1, own_stride, first, kRows, own_limit);
  if constexpr (!kDkv) {
    const long long stat = (b * p.heads + head) * p.s_len;
    load_stats<C::kThreads>(rstat, p.lse + stat, first, kRows, p.s_len);
    load_stats<C::kThreads>(rstat + kRows, p.delta + stat, first, kRows,
                            p.s_len);
  }
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < n_iter) load_tile(i, i);
    cp_async_commit();
  }

  float acc0[kDt][4], acc1[kDkv ? kDt : 1][4];   // dq or dk; dv
#pragma unroll
  for (int j = 0; j < kDt; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc0[j][i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < (kDkv ? kDt : 1); ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[j][i] = 0.f;
  }

  // bf16: the warp's rows of its block's first operand (Q, or K in a dk/dv
  // block) as register fragments for the whole walk
  constexpr bool kReg0 = C::kFrag;
  ResidentA<T, D, kReg0> ra0;
  const T* xr0 = x0 + rrow * kLd;
  const T* xr1 = x1 + rrow * kLd;
  if (n_iter > 0) {
    cp_async_wait<C::kStages - 2>();  // the own rows and tile 0 have landed
    __syncthreads();
    ra0.load(xr0);
  }

  const int own_lo = first + rrow;     // the warp's first own row
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % C::kStages;
    cp_async_wait<C::kStages - 2>();  // tile it has landed
    // every thread's copies of tile it are visible, and every warp is done
    // with tile it - 1, whose stage now takes tile it + kStages - 1
    __syncthreads();
    if (it + C::kStages - 1 < n_iter) {
      load_tile(it + C::kStages - 1, (it + C::kStages - 1) % C::kStages);
    }
    cp_async_commit();
    T* y0 = reinterpret_cast<T*>(ring + stage * C::kStage);
    T* y1 = y0 + kTile * kLd;
    const float* st = reinterpret_cast<const float*>(y1 + kTile * kLd);
    if constexpr (!C::kBf16) {
      // split the tile into tf32 parts once: hi in place, lo beside
      constexpr int kQuads = D / 4;
      for (int i = threadIdx.x; i < 2 * kTile * kQuads; i += C::kThreads) {
        const int row = i / kQuads, c = i % kQuads;
        float4* h = reinterpret_cast<float4*>(y0 + row * kLd) + c;
        float4* l = reinterpret_cast<float4*>(lo0 + row * kLd) + c;
        const float4 x = *h;
        const Split s0 = split(x.x), s1 = split(x.y), s2 = split(x.z),
                    s3 = split(x.w);
        *h = make_float4(__uint_as_float(s0.hi), __uint_as_float(s1.hi),
                         __uint_as_float(s2.hi), __uint_as_float(s3.hi));
        *l = make_float4(__uint_as_float(s0.lo), __uint_as_float(s1.lo),
                         __uint_as_float(s2.lo), __uint_as_float(s3.lo));
      }
      __syncthreads();
    }
    const int r0 = tile_row(it);

    // which elements of the warp's 16 x kW part the rule lets through:
    // all of them in a tile inside the rule, else tested one by one
    constexpr uint32_t kAll = (1u << (4 * kNt)) - 1u;
    const int other_lo = r0 + col0;
    uint32_t seen = kAll;
    if (!(kDkv ? all_visible(p, other_lo, other_lo + C::kW - 1, own_lo,
                             own_lo + 15)
               : all_visible(p, own_lo, own_lo + 15, other_lo,
                             other_lo + C::kW - 1))) {
      seen = 0;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int own = own_lo + g + 8 * rr;
            const int other = other_lo + 8 * j + 2 * t + e;
            const int row = kDkv ? other : own, key = kDkv ? own : other;
            const bool ok = row < p.s_len &&
                            visible(row + p.q_offset, key, p.kv_len,
                                    p.causal, p.window, p.prefix);
            seen |= static_cast<uint32_t>(ok) << ((rr * kNt + j) * 2 + e);
          }
        }
      }
    }
    if (__any_sync(0xffffffffu, seen != 0)) {
      float s[kNt][4], dp[kNt][4];
      warp_scores2<T, D, kReg0>(xr0, ra0, y0 + col0 * kLd, lo0 + col0 * kLd,
                                xr1, y1 + col0 * kLd, lo1 + col0 * kLd, s,
                                dp);
      const float scale2 = p.scale * kLog2e;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = rrow + g + 8 * rr;
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = col0 + 8 * j + 2 * t + e;
            const float lse2 = (kDkv ? st[c] : rstat[r]) * kLog2e;
            const float delta = kDkv ? st[kTile + c] : rstat[kRows + r];
            const bool ok = (seen >> ((rr * kNt + j) * 2 + e)) & 1u;
            grad_element(s[j][2 * rr + e], dp[j][2 * rr + e], lse2, delta,
                         ok, p.scale, scale2, p.softcap, s[j][2 * rr + e],
                         dp[j][2 * rr + e]);
          }
        }
      }
      const int zo = col0 * kLd + dcol;
      if constexpr (kDkv) {
        warp_accumulate<T, D>(s, y1 + zo, lo1 + zo, acc1);    // dv += P^T dO
        warp_accumulate<T, D>(dp, y0 + zo, lo0 + zo, acc0);   // dk += dS^T Q
      } else {
        warp_accumulate<T, D>(dp, y0 + zo, lo0 + zo, acc0);   // dq += dS K
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (C::kSplitN > 1) {
    // the kSplitN = 2 warps of one 16 rows and D range: the second hands
    // its partials to the first through the ring, which adds them to its
    // own in a fixed order
    static_assert(C::kSplitN == 2, "two column parts");
    constexpr int kVals = (kDkv ? 2 : 1) * kDt * 4;
    float* part = reinterpret_cast<float*>(ring) +
                  (wr + C::kRowWarps * wd) * kVals * 32 + lane;
    __syncthreads();                 // every warp is done with the ring
    if (wn == 1) {
#pragma unroll
      for (int j = 0; j < kDt; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          part[(j * 4 + i) * 32] = acc0[j][i];
          if constexpr (kDkv) part[((kDt + j) * 4 + i) * 32] = acc1[j][i];
        }
      }
    }
    __syncthreads();
    if (wn == 1) return;
#pragma unroll
    for (int j = 0; j < kDt; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc0[j][i] += part[(j * 4 + i) * 32];
        if constexpr (kDkv) acc1[j][i] += part[((kDt + j) * 4 + i) * 32];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = own_lo + g + 8 * rr;
    if (row >= own_limit) continue;
    const long long at = (kDkv ? (b * p.kv_len * p.kv_heads + head) * D
                               : (b * p.s_len * p.heads + head) * D) +
                         row * own_stride + dcol + 2 * t;
#pragma unroll
    for (int j = 0; j < kDt; ++j) {
      if constexpr (kDkv) {
        store2(p.dk + at + 8 * j, acc0[j][2 * rr] * p.scale,
               acc0[j][2 * rr + 1] * p.scale);
        store2(p.dv + at + 8 * j, acc1[j][2 * rr], acc1[j][2 * rr + 1]);
      } else {
        store2(p.dq + at + 8 * j, acc0[j][2 * rr] * p.scale,
               acc0[j][2 * rr + 1] * p.scale);
      }
    }
  }
}

// One grid, both kinds: the dk/dv blocks, then the dq blocks.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::kThreads, Cfg<T, D>::kMinBlocks)
flash_attention_bwd_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < p.n_dkv) {
    walk<T, D, true>(p, smem_raw, blk);
  } else {
    walk<T, D, false>(p, smem_raw, blk - p.n_dkv);
  }
}

// ---- Delta = rowsum(dO * o): a group of kLanes lanes a row, one 16-byte
// chunk of o and of dO a lane (two at fp32 D = 256), summed over the
// group by shuffles
constexpr int kDeltaThreads = 256;

template <typename T, int D>
struct DeltaCfg {
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kLanes = kChunks > 16 ? 32 : kChunks > 8 ? 16 : 8;
  static constexpr int kPer = (kChunks + kLanes - 1) / kLanes;
  static constexpr int kRowsWarp = 32 / kLanes;
};

__device__ __forceinline__ float dot16(uint4 a, uint4 b, float) {
  return __uint_as_float(a.x) * __uint_as_float(b.x) +
         __uint_as_float(a.y) * __uint_as_float(b.y) +
         __uint_as_float(a.z) * __uint_as_float(b.z) +
         __uint_as_float(a.w) * __uint_as_float(b.w);
}
__device__ __forceinline__ float dot16(uint4 a, uint4 b, __nv_bfloat16) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&av[i]));
    const float2 y = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
    acc += x.x * y.x + x.y * y.y;
  }
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_attention_bwd_delta_kernel(const T* o, const T* dout, float* delta,
                                 long long rows, int s_len, int heads) {
  using C = DeltaCfg<T, D>;
  const int lane = threadIdx.x % 32;
  const int sub = lane / C::kLanes, c = lane % C::kLanes;
  const long long warps =
      static_cast<long long>(gridDim.x) * (kDeltaThreads / 32);
  for (long long w = blockIdx.x * (kDeltaThreads / 32) + threadIdx.x / 32;
       w * C::kRowsWarp < rows; w += warps) {
    const long long row = w * C::kRowsWarp + sub;   // (b, s, h) of o
    float acc = 0.f;
    if (row < rows) {
      const T* orow = o + row * D;
      const T* drow = dout + row * D;
#pragma unroll
      for (int k = 0; k < C::kPer; ++k) {
        const int ch = c + k * C::kLanes;
        if (ch < C::kChunks) {
          acc += dot16(__ldg(reinterpret_cast<const uint4*>(orow) + ch),
                       __ldg(reinterpret_cast<const uint4*>(drow) + ch), T());
        }
      }
    }
#pragma unroll
    for (int m = C::kLanes / 2; m > 0; m >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, m);
    }
    if (row < rows && c == 0) {
      const long long h = row % heads, bs = row / heads;
      delta[(bs / s_len * heads + h) * s_len + bs % s_len] = acc;
    }
  }
}

// Launch (or, with info != null, describe without launching) the main
// kernel: info[0..9] = stages, dynamic shared bytes, registers a thread,
// local (spill) bytes a thread, blocks an SM by the occupancy calculator,
// threads a block, rows, tile, split_d, split_n.
template <typename T, int D>
int run(Params<T> p, cudaStream_t s, int* info) {
  using C = Cfg<T, D>;
  auto kernel = flash_attention_bwd_kernel<T, D>;
  // above 48 KB only once raised; set before every launch, since the
  // attribute is per device and the current device may change
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info != nullptr) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        C::kThreads, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int out[10] = {C::kStages, C::kSmem, attr.numRegs,
                         static_cast<int>(attr.localSizeBytes), blocks,
                         C::kThreads, C::kRows, C::kTile, C::kSplitD,
                         C::kSplitN};
    for (int i = 0; i < 10; ++i) info[i] = out[i];
    return 0;
  }
  if (p.s_len == 0 || p.kv_len == 0 || p.batch == 0) return 0;
  p.n_qb = (p.s_len + C::kRows - 1) / C::kRows;
  p.n_dkv = (p.kv_len + C::kRows - 1) / C::kRows * p.batch * p.kv_heads;
  const long long blocks =
      static_cast<long long>(p.n_dkv) + 1LL * p.n_qb * p.batch * p.heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The same for the Delta kernel: info[0..5] = stages (0: no ring), shared
// bytes (0), registers, local bytes, blocks an SM, threads a block.
template <typename T, int D>
int run_delta(const void* o, const void* dout, void* delta, long long rows,
              int s_len, int heads, cudaStream_t s, int* info) {
  auto kernel = flash_attention_bwd_delta_kernel<T, D>;
  if (info != nullptr) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kDeltaThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int out[6] = {0, 0, attr.numRegs,
                        static_cast<int>(attr.localSizeBytes), blocks,
                        kDeltaThreads};
    for (int i = 0; i < 6; ++i) info[i] = out[i];
    return 0;
  }
  if (rows == 0) return 0;
  constexpr int kRowsBlock = DeltaCfg<T, D>::kRowsWarp * (kDeltaThreads / 32);
  const long long want = (rows + kRowsBlock - 1) / kRowsBlock;
  const unsigned grid = static_cast<unsigned>(want < 65535 ? want : 65535);
  kernel<<<grid, kDeltaThreads, 0, s>>>(static_cast<const T*>(o),
                                        static_cast<const T*>(dout),
                                        static_cast<float*>(delta), rows,
                                        s_len, heads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_main(const Params<T>& p, int head_dim, cudaStream_t s, int* info) {
  switch (head_dim) {
    case 64:
      return run<T, 64>(p, s, info);
    case 80:
      return run<T, 80>(p, s, info);
    case 128:
      return run<T, 128>(p, s, info);
    case 256:
      return run<T, 256>(p, s, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int run_delta_dim(const void* o, const void* dout, void* delta,
                  long long rows, int s_len, int heads, int head_dim,
                  cudaStream_t s, int* info) {
  switch (head_dim) {
    case 64:
      return run_delta<T, 64>(o, dout, delta, rows, s_len, heads, s, info);
    case 80:
      return run_delta<T, 80>(o, dout, delta, rows, s_len, heads, s, info);
    case 128:
      return run_delta<T, 128>(o, dout, delta, rows, s_len, heads, s, info);
    case 256:
      return run_delta<T, 256>(o, dout, delta, rows, s_len, heads, s, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
Params<T> make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, void* dk, void* dv, int batch, int s_len,
                      int kv_len, int heads, int kv_heads, bool causal,
                      int window, int prefix, float softcap, int q_offset,
                      float scale) {
  Params<T> p = {};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  p.batch = batch;
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
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for o and dout; delta is a float32
// (B, H, S) scratch the call fills with rowsum(dO * o).  o and dout are
// contiguous (B, S, H, D) and 16-byte aligned.  One launch on ``stream``;
// returns cudaGetLastError() after it (0 on success).
extern "C" int flash_attention_bwd_delta_launch(const void* o,
                                                const void* dout, void* delta,
                                                int batch, int s_len,
                                                int heads, int head_dim,
                                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = 1LL * batch * s_len * heads;
  if (dtype == 0) {
    return run_delta_dim<float>(o, dout, delta, rows, s_len, heads, head_dim,
                                s, nullptr);
  }
  if (dtype == 1) {
    return run_delta_dim<__nv_bfloat16>(o, dout, delta, rows, s_len, heads,
                                        head_dim, s, nullptr);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv); lse and
// delta are float32 (B, H, S), delta as flash_attention_bwd_delta_launch
// wrote it.  Every tensor is contiguous in the forward's layout; q, k, v
// and dout are 16-byte aligned (the kernel copies 16-byte chunks).
// window < 0 means no sliding window.  One launch on ``stream``; returns
// cudaGetLastError() after it (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int batch, int s_len, int kv_len, int heads, int kv_heads, int head_dim,
    int causal, int window, int prefix, float softcap, int q_offset,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return run_main<float>(
        make_params<float>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                           s_len, kv_len, heads, kv_heads, causal != 0,
                           window, prefix, softcap, q_offset, scale),
        head_dim, s, nullptr);
  }
  if (dtype == 1) {
    return run_main<__nv_bfloat16>(
        make_params<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv,
                                   batch, s_len, kv_len, heads, kv_heads,
                                   causal != 0, window, prefix, softcap,
                                   q_offset, scale),
        head_dim, s, nullptr);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What the two launches run at (head_dim, dtype), without launching
// either: out[0..9] the main kernel's (see run), out[10..15] the Delta
// kernel's (see run_delta).  The stream, the last argument of every entry
// point here, is not used.  Returns a CUDA error code (0 on success).
extern "C" int flash_attention_bwd_info(int head_dim, int dtype, int* out,
                                        void* /*stream*/) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (dtype == 0) {
    Params<float> p = {};
    err = run_main<float>(p, head_dim, nullptr, out);
    if (err == 0) {
      err = run_delta_dim<float>(nullptr, nullptr, nullptr, 0, 1, 1,
                                 head_dim, nullptr, out + 10);
    }
  } else {
    Params<__nv_bfloat16> p = {};
    err = run_main<__nv_bfloat16>(p, head_dim, nullptr, out);
    if (err == 0) {
      err = run_delta_dim<__nv_bfloat16>(nullptr, nullptr, nullptr, 0, 1, 1,
                                         head_dim, nullptr, out + 10);
    }
  }
  return err;
}
