// Chunked Mamba2 SSD (state-space duality) scan for Hopper (sm_90a), on
// tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_chunked).  Per (stream b, head h), over the sequence in chunks of
// Q steps, with la_t = -exp(a_log[h]) * dt_t and L the in-chunk
// cumulative sum of la:
//
//   y_t   = sum_{tau <= t} (c_t . b_tau) exp(L_t - L_tau) dt_tau x_tau
//           + exp(L_t) (c_t . h_in) + D[h] x_t
//   h_out = exp(L_Q) h_in + sum_tau exp(L_Q - L_tau) dt_tau x_tau b_tau^T
//
// x (B, S, H, P) and b, c (B, S, N) in fp32 or bf16 (strided rows, unit
// last stride, 16-byte aligned), dt (B, S, H) fp32, a_log and D (H,)
// fp32, optional h0 (B, H, P, N) fp32.  y (B, S, H, P) contiguous in x's
// type; h_final (B, H, P, N) fp32.  All sums are fp32.
//
// Bound: operations.  Every step costs about 2 P N multiply-adds for the
// state update and 2 P N for c . h, against a few bytes of x, b and c.
// So the products run on the tensor cores (mma.sync m16n8k8 tf32) at
// fp32 accuracy by 3xTF32: an fp32 operand x is split into two tf32
// terms hi and lo (`split` below) and a product accumulates lo*hi +
// hi*lo + hi*hi (what is dropped is about 2^-20 of it).  A bf16 value is exact in tf32,
// so a product with a bf16 operand needs two of the three, and the
// scores of two bf16 operands one.
//
// Two kernels, one launch each:
//
// 1. ssd_scores_kernel: G = C B^T per (stream, chunk), a (Q, Q) fp32
//    block.  b and c have one group shared by every head, so this is
//    computed once, not once per head.  One block of two warps per
//    (chunk, stream); G is kept in device memory (B x S/Q x Q x Q fp32).
//
// 2. ssd_chunked_kernel: one block per (stream, head) walks the chunks in
//    order, so the state never leaves the chip.  The kernel tiles S by
//    its own Q = 32 (the last chunk may be short: its rows past S are
//    zero-filled and add nothing), which the chunked algebra allows and
//    which needs fewer operations than Q = 64 (the intra-chunk term grows
//    with Q, the state terms do not).  The (P, N) fp32 state IS the
//    accumulator of the state update: each warp owns 16 rows of P, N/8
//    fragments of 4 registers a thread.  Per chunk:
//      A. every warp scans la into L with shuffles, lane = step (dt
//         prefetched a chunk ahead), and keeps exp(L_t), the decay to the
//         end exp(L_Q - L_tau) dt_tau (a difference of L, never a
//         quotient of exponentials, which overflows at strong decay) and
//         exp(L_Q) in registers;
//      B. y^T (P x Q) = (H C^T) exp(L_t) + (dt x)^T Att^T, computed
//         transposed so that the state's accumulator registers are the
//         A operand as they are: the n sum takes, in each 8-column
//         fragment, column 2 t4 as the A layout's column t4 and 2 t4 + 1
//         as t4 + 4, and C is read as the matching pairs.  Att[t][tau] =
//         G[t][tau] exp(L_t - L_tau) is built in the B fragment's
//         registers; tau > t is masked before exp and its 8-step tiles
//         are skipped.  So the state goes through no shared memory and
//         no barrier, and each warp writes its own rows of y;
//      C. H = exp(L_Q) H + (w x)^T B in the state's accumulator, from the
//         same x fragments as B.
//    x, b, c and G of the chunks come through a ring of shared-memory
//    stages filled with 16-byte cp.async copies: with two stages chunk
//    i + 1 loads while chunk i computes; with one, other blocks on the SM
//    compute meanwhile (the wrapper picks, by dtype).  Shared rows are padded by 8 elements, so
//    that every fragment load hits distinct banks.
//
// The kernel takes P a multiple of 8 up to 128 (four warps up to P = 64,
// eight above; rows past P are zeros) and N in {16, 32, 64, 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kQ = 32;           // steps per chunk (the kernel's own tiling)
constexpr int kLdG = kQ + 4;     // G row stride in shared memory

template <typename T>
struct Elem {
  static constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  // the scores pass reads b and c rows as (row g, column t) fragments:
  // a 16-byte pad puts the 8 rows of a warp's load in distinct banks
  static constexpr int kPadA = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread)
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

// rows [r0, r0 + n) of a global matrix (row r at base + r * stride, `cols`
// elements) into shared rows of `ld` elements; rows >= limit are zeros
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* base,
                                          long long stride, int cols, int r0,
                                          int n, int limit) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  const int chunks = cols / kE;
  for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i - r * chunks;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * ld + c * kE, base + (ok ? (r0 + r) * stride : 0) +
                                          c * kE, ok);
  }
}

// ---- 3xTF32 on mma.sync m16n8k8
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
// a value known to be exact in tf32 (a bf16 input)
__device__ __forceinline__ Split exact(float x) {
  return {__float_as_uint(x), 0u};
}
template <bool kExactValue>
__device__ __forceinline__ Split operand(float x) {
  if constexpr (kExactValue) return exact(x);
  else return split(x);
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// c += a b; an operand known exact in tf32 has no lo part to multiply
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[4], const Split (&a)[4],
                                     Split b0, Split b1) {
  if constexpr (!kExactA) {
    mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  }
  if constexpr (!kExactB) {
    mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  }
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* d_skip;
  const float* h0;     // may be null
  float* scores;       // (B, S/Q, Q, Q) fp32: written by the pre-pass
  void* y;
  float* h_final;
  long long x_sb, x_ss, x_sh;   // x strides (elements), last stride 1
  long long b_sb, b_ss;         // b strides
  long long c_sb, c_ss;         // c strides
  int batch, seq, heads, p_dim, n_dim;
};

// ------------------------------------------------------------ pre-pass

template <typename T, int kN>
__global__ void __launch_bounds__(64) ssd_scores_kernel(const SsdArgs args) {
  using E = Elem<T>;
  constexpr int kLd = kN + E::kPadA;    // b and c both read as (row g, col t)
  extern __shared__ __align__(16) unsigned char smem[];
  T* c_s = reinterpret_cast<T*>(smem);
  T* b_s = c_s + kQ * kLd;
  const int ci = blockIdx.x, bi = blockIdx.y, n_chunks = gridDim.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  load_rows(c_s, kLd, static_cast<const T*>(args.c) + bi * args.c_sb,
            args.c_ss, kN, ci * kQ, kQ, args.seq);
  load_rows(b_s, kLd, static_cast<const T*>(args.b) + bi * args.b_sb,
            args.b_ss, kN, ci * kQ, kQ, args.seq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[kQ / 8][4];
#pragma unroll
  for (int j = 0; j < kQ / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int tr = warp * 16 + g;
#pragma unroll 4
  for (int ks = 0; ks < kN / 8; ++ks) {
    const T* cr = c_s + tr * kLd + ks * 8 + t4;
    const Split a[4] = {operand<E::kExact>(ld(cr)),
                        operand<E::kExact>(ld(cr + 8 * kLd)),
                        operand<E::kExact>(ld(cr + 4)),
                        operand<E::kExact>(ld(cr + 8 * kLd + 4))};
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
      const T* br = b_s + (j * 8 + g) * kLd + ks * 8 + t4;
      mma3<E::kExact, E::kExact>(acc[j], a, operand<E::kExact>(ld(br)),
                                 operand<E::kExact>(ld(br + 4)));
    }
  }
  float* out = args.scores +
               (static_cast<long long>(bi) * n_chunks + ci) * kQ * kQ;
#pragma unroll
  for (int j = 0; j < kQ / 8; ++j) {
    store2(out + tr * kQ + j * 8 + 2 * t4, acc[j][0], acc[j][1]);
    store2(out + (tr + 8) * kQ + j * 8 + 2 * t4, acc[j][2], acc[j][3]);
  }
}

// ------------------------------------------------------------ main scan

// Shared memory of the main kernel, in bytes: `stages` stages of x (Q,
// P + 8), b and c (Q, N + 8 each) and G (Q, Q + 4).  The x, b and c rows
// pad by 8 elements: their fragment loads (row t, column g) then hit
// distinct banks.
struct Layout {
  int ldx, ldn;
  int x_off, b_off, c_off, g_off, stage_bytes, total;
};

__host__ __device__ inline Layout make_layout(int elem, int p_dim, int n_dim,
                                              int stages) {
  Layout s;
  s.ldx = p_dim + 8;
  s.ldn = n_dim + 8;
  s.x_off = 0;
  s.b_off = s.x_off + kQ * s.ldx * elem;
  s.c_off = s.b_off + kQ * s.ldn * elem;
  s.g_off = s.c_off + kQ * s.ldn * elem;
  s.stage_bytes = s.g_off + kQ * kLdG * 4;
  s.total = stages * s.stage_bytes;
  return s;
}

// two consecutive elements of a shared row as fp32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// kWarps warps, one 16-row tile of the state's P rows each
template <typename T, int kN, int kWarps, int kStages>
__global__ void __launch_bounds__(32 * kWarps)
ssd_chunked_kernel(const SsdArgs args) {
  using E = Elem<T>;
  constexpr bool kX = E::kExact;       // x, b, c exact in tf32
  constexpr int kNt = kN / 8;          // 8-column fragments of a state row
  constexpr int kTt = kQ / 8;          // 8-step fragments of a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int p_dim = args.p_dim;
  const Layout lay = make_layout(static_cast<int>(sizeof(T)), p_dim, kN,
                                 kStages);
  const int ldx = lay.ldx, ldb = lay.ldn, ldc = lay.ldn;

  const int h = blockIdx.x, bi = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int heads = args.heads, seq = args.seq;
  const int n_chunks = (seq + kQ - 1) / kQ;

  const T* xg = static_cast<const T*>(args.x) + bi * args.x_sb + h * args.x_sh;
  const T* bg = static_cast<const T*>(args.b) + bi * args.b_sb;
  const T* cg = static_cast<const T*>(args.c) + bi * args.c_sb;
  const float* gg = args.scores +
                    static_cast<long long>(bi) * n_chunks * kQ * kQ;
  const float* dtg =
      args.dt + static_cast<long long>(bi) * seq * heads + h;
  T* yg = static_cast<T*>(args.y) +
          (static_cast<long long>(bi) * seq * heads + h) * p_dim;
  const float a = -expf(args.a_log[h]);
  const float d_skip = args.d_skip[h];

  auto load_chunk = [&](int ci, int stage) {
    unsigned char* st = smem + stage * lay.stage_bytes;
    const int t0 = ci * kQ;
    load_rows(reinterpret_cast<T*>(st + lay.x_off), ldx, xg + t0 * args.x_ss,
              args.x_ss, p_dim, 0, kQ, seq - t0);
    load_rows(reinterpret_cast<T*>(st + lay.b_off), ldb, bg + t0 * args.b_ss,
              args.b_ss, kN, 0, kQ, seq - t0);
    load_rows(reinterpret_cast<T*>(st + lay.c_off), ldc, cg + t0 * args.c_ss,
              args.c_ss, kN, 0, kQ, seq - t0);
    load_rows(reinterpret_cast<float*>(st + lay.g_off), kLdG,
              gg + static_cast<long long>(ci) * kQ * kQ, kQ, kQ, 0, kQ, kQ);
  };

  // ---- the state: rows p0 and p0 + 8, columns 8 j + 2 t4 (+1)
  const int p0 = warp * 16 + g;
  const bool row0 = p0 < p_dim, row1 = p0 + 8 < p_dim;
  const long long hbase =
      (static_cast<long long>(bi) * heads + h) * p_dim * kN;
  float hacc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 8 * (e / 2), n = 8 * j + 2 * t4 + e % 2;
      hacc[j][e] = (args.h0 != nullptr && p < p_dim)
                       ? args.h0[hbase + static_cast<long long>(p) * kN + n]
                       : 0.f;
    }
  }

  // dt of step `lane` of the next chunk (every warp scans for itself)
  float dt_next = lane < seq ? dtg[static_cast<long long>(lane) * heads] : 0.f;

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }

#pragma unroll 1
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int nxt = ci + kStages - 1;
    if (nxt < n_chunks) load_chunk(nxt, nxt % kStages);
    cp_async_commit();
    const int t0 = ci * kQ;
    const int rows = min(kQ, seq - t0);

    // ---- A. the log decay, lane = step of the chunk
    const float dtv = dt_next;
    if (ci + 1 < n_chunks) {
      const int tn = t0 + kQ + lane;
      dt_next = tn < seq ? dtg[static_cast<long long>(tn) * heads] : 0.f;
    }
    float l = a * dtv;                   // rows past S: no decay, no input
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, l, off);
      if (lane >= off) l += up;
    }
    const float l_end = __shfl_sync(0xffffffffu, l, kQ - 1);
    const float el = expf(l);                    // exp(L_t)
    const float wl = expf(l_end - l) * dtv;      // a difference: finite
    const float decay = expf(l_end);

    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* st = smem + (ci % kStages) * lay.stage_bytes;
    const T* x_s = reinterpret_cast<const T*>(st + lay.x_off);
    const T* b_s = reinterpret_cast<const T*>(st + lay.b_off);
    const T* c_s = reinterpret_cast<const T*>(st + lay.c_off);
    const float* g_s = reinterpret_cast<const float*>(st + lay.g_off);

    // x of the warp's rows as A fragments: (p0 (+8), tau = 8 ks + t4 (+4))
    float xv[kTt][4];
#pragma unroll
    for (int ks = 0; ks < kTt; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 8 * (e % 2), tau = 8 * ks + t4 + 4 * (e / 2);
        xv[ks][e] = p < p_dim ? ld(x_s + tau * ldx + p) : 0.f;
      }
    }

    // ---- B. y^T (P x Q) = H C^T scaled by exp(L_t), + (dt x)^T Att^T.
    // The state's accumulator is the A operand as it is: keys of the
    // n sum are taken in the order 2 t4, 2 t4 + 1 of each fragment, so
    // column t4 of A is n = 8 j + 2 t4 and column t4 + 4 is n + 1.
    float yacc[kTt][4];
#pragma unroll
    for (int jt = 0; jt < kTt; ++jt) {
      yacc[jt][0] = yacc[jt][1] = yacc[jt][2] = yacc[jt][3] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const Split av[4] = {split(hacc[j][0]), split(hacc[j][2]),
                           split(hacc[j][1]), split(hacc[j][3])};
#pragma unroll
      for (int jt = 0; jt < kTt; ++jt) {
        const float2 cv = ld2(c_s + (8 * jt + g) * ldc + 8 * j + 2 * t4);
        mma3<false, kX>(yacc[jt], av, operand<kX>(cv.x), operand<kX>(cv.y));
      }
    }
#pragma unroll
    for (int jt = 0; jt < kTt; ++jt) {
      const float e0 = __shfl_sync(0xffffffffu, el, 8 * jt + 2 * t4);
      const float e1 = __shfl_sync(0xffffffffu, el, 8 * jt + 2 * t4 + 1);
      yacc[jt][0] *= e0; yacc[jt][1] *= e1;
      yacc[jt][2] *= e0; yacc[jt][3] *= e1;
    }
#pragma unroll
    for (int ks = 0; ks < kTt; ++ks) {
      const float d0 = __shfl_sync(0xffffffffu, dtv, 8 * ks + t4);
      const float d1 = __shfl_sync(0xffffffffu, dtv, 8 * ks + t4 + 4);
      const Split av[4] = {split(xv[ks][0] * d0), split(xv[ks][1] * d0),
                           split(xv[ks][2] * d1), split(xv[ks][3] * d1)};
      const int tau0 = 8 * ks + t4, tau1 = tau0 + 4;
      const float lt0 = __shfl_sync(0xffffffffu, l, tau0);
      const float lt1 = __shfl_sync(0xffffffffu, l, tau1);
#pragma unroll
      for (int jt = 0; jt < kTt; ++jt) {
        const int t = 8 * jt + g;
        const float lt = __shfl_sync(0xffffffffu, l, t);
        if (jt < ks) continue;           // every tau of the step is > t
        // mask before exp: only tau <= t is ever exponentiated
        const float v0 = tau0 <= t ? g_s[t * kLdG + tau0] * expf(lt - lt0) : 0.f;
        const float v1 = tau1 <= t ? g_s[t * kLdG + tau1] * expf(lt - lt1) : 0.f;
        mma3<false, false>(yacc[jt], av, split(v0), split(v1));
      }
    }
#pragma unroll
    for (int jt = 0; jt < kTt; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 8 * (e / 2), t = 8 * jt + 2 * t4 + e % 2;
        if (p < p_dim && t < rows) {
          store1(yg + static_cast<long long>(t0 + t) * heads * p_dim + p,
                 yacc[jt][e] + d_skip * ld(x_s + t * ldx + p));
        }
      }
    }

    // ---- C. H = exp(L_Q) H + (w x)^T B, in the state's accumulator
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      hacc[j][0] *= decay; hacc[j][1] *= decay;
      hacc[j][2] *= decay; hacc[j][3] *= decay;
    }
#pragma unroll
    for (int ks = 0; ks < kTt; ++ks) {
      const float w0 = __shfl_sync(0xffffffffu, wl, 8 * ks + t4);
      const float w1 = __shfl_sync(0xffffffffu, wl, 8 * ks + t4 + 4);
      const Split av[4] = {split(xv[ks][0] * w0), split(xv[ks][1] * w0),
                           split(xv[ks][2] * w1), split(xv[ks][3] * w1)};
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const T* br = b_s + (8 * ks + t4) * ldb + 8 * j + g;
        mma3<false, kX>(hacc[j], av, operand<kX>(ld(br)),
                        operand<kX>(ld(br + 4 * ldb)));
      }
    }
    __syncthreads();                     // this stage is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    const int n = 8 * j + 2 * t4;
    if (row0) {
      store2(args.h_final + hbase + static_cast<long long>(p0) * kN + n,
             hacc[j][0], hacc[j][1]);
    }
    if (row1) {
      store2(args.h_final + hbase + static_cast<long long>(p0 + 8) * kN + n,
             hacc[j][2], hacc[j][3]);
    }
  }
}

// above 48 KB only once raised; set before every launch, since the
// attribute is per device and the current device may change
template <typename K>
cudaError_t raise_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int kN, int kWarps, int kStages>
int launch_main(const SsdArgs& args, cudaStream_t s) {
  auto kernel = ssd_chunked_kernel<T, kN, kWarps, kStages>;
  const int smem = make_layout(static_cast<int>(sizeof(T)), args.p_dim, kN,
                               kStages).total;
  cudaError_t err = raise_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(args.heads),
                  static_cast<unsigned>(args.batch));
  kernel<<<grid, 32 * kWarps, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kN>
int launch_n(const SsdArgs& args, bool scores, int stages, cudaStream_t s) {
  if (scores) {
    const int n_chunks = (args.seq + kQ - 1) / kQ;
    if (n_chunks == 0) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = ssd_scores_kernel<T, kN>;
    const int smem =
        2 * kQ * (kN + Elem<T>::kPadA) * static_cast<int>(sizeof(T));
    const cudaError_t err = raise_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(static_cast<unsigned>(n_chunks),
                  static_cast<unsigned>(args.batch)), 64, smem, s>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
  const bool wide = args.p_dim > 64;
  if (stages == 1) {
    return wide ? launch_main<T, kN, 8, 1>(args, s)
                : launch_main<T, kN, 4, 1>(args, s);
  }
  return wide ? launch_main<T, kN, 8, 2>(args, s)
              : launch_main<T, kN, 4, 2>(args, s);
}

template <typename T>
int launch_t(const SsdArgs& args, bool scores, int stages, cudaStream_t s) {
  switch (args.n_dim) {
    case 16: return launch_n<T, 16>(args, scores, stages, s);
    case 32: return launch_n<T, 32>(args, scores, stages, s);
    case 64: return launch_n<T, 64>(args, scores, stages, s);
    case 128: return launch_n<T, 128>(args, scores, stages, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, const void* d_skip, const void* h0, void* scores,
           void* y, void* h_final, long long x_sb, long long x_ss,
           long long x_sh, long long b_sb, long long b_ss, long long c_sb,
           long long c_ss, int batch, int seq, int heads, int p_dim,
           int n_dim, int dtype, bool scores_pass, int stages,
           void* stream) {
  if (p_dim % 8 != 0 || p_dim < 8 || p_dim > 128 || batch > 65535 ||
      seq < 0 || (stages != 1 && stages != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SsdArgs args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a_log = static_cast<const float*>(a_log);
  args.b = b;
  args.c = c;
  args.d_skip = static_cast<const float*>(d_skip);
  args.h0 = static_cast<const float*>(h0);
  args.scores = static_cast<float*>(scores);
  args.y = y;
  args.h_final = static_cast<float*>(h_final);
  args.x_sb = x_sb; args.x_ss = x_ss; args.x_sh = x_sh;
  args.b_sb = b_sb; args.b_ss = b_ss;
  args.c_sb = c_sb; args.c_ss = c_ss;
  args.batch = batch; args.seq = seq; args.heads = heads;
  args.p_dim = p_dim; args.n_dim = n_dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(args, scores_pass, stages, s);
  if (dtype == 1) {
    return launch_t<__nv_bfloat16>(args, scores_pass, stages, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both entry points take the same arguments.  dtype: 0 = float32, 1 =
// bfloat16 (x, b, c and y).  h0 may be null; scores is (B, ceil(S / 32),
// 32, 32) fp32, written by ssd_chunk_scores_launch and read by
// ssd_chunked_launch, which must follow it on the same stream.  stages:
// 1 or 2 shared-memory stages of the chunk ring (the scores pass ignores
// it).  Takes P a multiple of 8 up to 128 and N in {16, 32, 64,
// 128}.  Each returns cudaGetLastError() after its launch (0 on success); the scores pass needs S >= 1.
#define SSD_PARAMS                                                         \
  const void *x, const void *dt, const void *a_log, const void *b,         \
      const void *c, const void *d_skip, const void *h0, void *scores,     \
      void *y, void *h_final, long long x_sb, long long x_ss,              \
      long long x_sh, long long b_sb, long long b_ss, long long c_sb,      \
      long long c_ss, int batch, int seq, int heads, int p_dim, int n_dim, \
      int dtype, int stages, void *stream
#define SSD_ARGS                                                          \
  x, dt, a_log, b, c, d_skip, h0, scores, y, h_final, x_sb, x_ss, x_sh,   \
      b_sb, b_ss, c_sb, c_ss, batch, seq, heads, p_dim, n_dim, dtype

extern "C" int ssd_chunk_scores_launch(SSD_PARAMS) {
  return launch(SSD_ARGS, true, stages, stream);
}

extern "C" int ssd_chunked_launch(SSD_PARAMS) {
  return launch(SSD_ARGS, false, stages, stream);
}
