// The backward of the chunked Mamba2 SSD scan (csrc/ssd_scan.cu) for
// Hopper (sm_90a), on tensor cores.
//
// Replaces no Pallas kernel: the reference has no backward of
// src/repro/kernels/ssd_scan.py (ssd_chunked) and trains through XLA's
// autodiff of src/repro/kernels/ref.py ssd_chunked_ref, whose gradient
// this computes.  Per (stream b, head h), with a = -exp(a_log[h]),
// la_t = a dt_t, L the in-chunk cumulative sum of la, xbar_t = dt_t x_t,
// G[t][tau] = c_t . b_tau and A[t][tau] = G[t][tau] exp(L_t - L_tau) for
// tau <= t, the chunks are walked in reverse with the state gradient dH
// (P x N, fp32) starting at dh_final (or 0):
//
//   dH_in      = exp(L_Q) dH_out + sum_t exp(L_t) dy_t c_t^T   (-> dh0)
//   d xbar_tau = sum_t A[t][tau] dy_t + exp(L_Q - L_tau) dH_out b_tau
//   dx = dt d xbar + D dy,  dD = sum x . dy
//   dc_t   = sum_tau dG[t][tau] b_tau + exp(L_t) H_in^T dy_t
//   db_tau = sum_t dG[t][tau] c_t + exp(L_Q - L_tau) dH_out^T xbar_tau
//            with dG[t][tau] = exp(L_t - L_tau) (dy_t . xbar_tau)
//   d la_t = sum_{s >= t} exp(L_s) dy_s . (H_in c_s)
//            + exp(L_Q) <dH_out, H_in>
//            + sum_{tau < t} exp(L_Q - L_tau) xbar_tau . (dH_out b_tau)
//            + sum_{r >= t > c} A[r][c] dA[r][c],  dA = dy_r . xbar_c
//   ddt_t  = x_t . d xbar_t + a d la_t,  d a_log = sum d la_t la_t.
//
// d la_t is summed from the terms whose decay spans step t (a factor
// exp(L_r - L_c) depends on la_t exactly when c < t <= r), not as the
// reverse cumulative sum of dL: that sum adds each decay's +/- pair apart,
// and under strong decay their cancellation loses the small terms (the
// reference's fp32 autodiff of ssd_chunked_ref adds them apart too).
// Every decay is exp of a difference of L (<= 0), never a quotient of
// exponentials, and tau > t is set to 0 before any exp, so strong decay
// underflows to 0 and never gives 0 * inf.  The scores' term is a
// product too: with pm = A o dA, sum_{c < t} pm[r][c] is pm times the
// strictly upper triangle of ones, summed over the rows r >= t.
//
// Bound: operations.  About 5 Q P N + 3 Q^2 N + 2 Q^2 P multiply-adds a
// (stream, head, chunk) of Q steps against a few bytes a step.  So every
// product runs on the tensor cores, mma.sync m16n8k8 tf32 at fp32
// accuracy by 3xTF32 as in the forward (`split` / `mma3`): an fp32
// operand is a tf32 hi part plus a lo part, and a product adds lo*hi +
// hi*lo + hi*hi.  A bf16 input is exact in tf32, so a product of two bf16
// inputs (C B^T, dy xbar^T before its dt) is one mma and a product with
// one bf16 operand two.  Scales are applied to an output's rows where the
// algebra allows it (wt to dH b, exp(L_t) to dy H_in, wt dt to x dH), so
// that the bf16 input stays the exact operand.
//
// Two kernels, one launch each:
//
// 1. ssd_bwd_kernel: one block of 8 warps per (stream, head).  Shared
//    memory holds the chunk's x, dy, b and c (in their own type, copied
//    by 16-byte cp.async into one or two stages: with two, chunk i - 1
//    loads while chunk i computes), dH (fp32), and A, dG and dG^T of the
//    chunk (fp32).  The (P, N) state is updated transposed, as (16 n) x
//    (8 p) accumulator tiles spread over the warps (warp w: n tile w mod
//    N/16).  The first walk recomputes each chunk's entry state H_in in
//    those registers and writes each tile's fragment as it stands, 16
//    bytes a lane, to a scratch (B, H, S/Q, P, N) fp32 that the caller
//    frees after this layer's backward (nothing but the inputs is kept
//    from the forward); the first chunk's is not written without h0, nor
//    the last chunk's update computed.  Those fragments are the B operand
//    of dy H_in as they are (k = p taken in the order 2 t4, 2 t4 + 1), so
//    the reverse walk reads them straight into registers (prefetched to
//    the L2 at the start of a chunk, loaded where dy H_in needs them).
//    Per chunk of the reverse walk, each product tiled over all 8 warps:
//      A. G = C B^T and dA = dy xbar^T, a (16, 8) tile a warp (the two
//         tiles above the diagonal are all masked and skipped); A = G e,
//         dG = e dA built in the fragments (e = exp(L_t - L_tau), tau > t
//         set to 0 first), written to shared memory; pm = A o dA times the
//         triangle of ones on the tensor cores: the scores' part of d la;
//      B. d xbar = wt (b dH^T) + A^T dy, (16 tau, 8 p) tiles; dx written,
//         and x . d xbar and x . dy summed in the epilogue;
//      C. dc = exp(L_t) dy H_in + dG b: dy H_in first, its rows dotted with
//         c (the inter-chunk part of d la) before dG b joins it; and
//         <dH_out, H_in>;
//      D. db = wt dt (x dH) + dG^T c, likewise dotted with b first (the
//         state's part of d la);
//      E. dH = exp(L_Q) dH + (exp(L) c)^T dy in the registers of each
//         warp's tiles, back to shared memory; warp 0 adds the parts of
//         d la (each a per-warp partial, summed in warp order) and writes
//         ddt.
//    Between chunks dH stays in shared memory, not in registers: at 128
//    registers a thread (two blocks an SM) its 32 registers beside the 32
//    of the H_in fragments spilled, and a version that kept it there ran
//    no faster.  It writes dx, ddt and dh0, and per-head partials: db and dc
//    (B, H, S, N) fp32 (b and c are one group shared by every head) and d
//    a_log, dD (B, H) fp32.  The chunk is the forward kernel's Q = 32 (the
//    last chunk may be short: its rows past S are zeros and add nothing).
// 2. ssd_bwd_head_sum_kernel: db and dc = the per-head partials summed
//    over the heads in order, one thread an element.  No atomics: the
//    gradient is the same from run to run.  (The (B, H) -> (H,) sums of
//    d a_log and dD are left to the caller.)
//
// Instantiations: P = 64 (the head dim of mamba2-780m and zamba2-1.2b)
// is compiled; every other P (a multiple of 8 up to 128) reads P at run
// time with 16 p tiles and one stage.  P = 64 runs two blocks an SM (at
// most 128 registers a thread); the stages are two where two blocks
// still fit in shared memory, else one (mamba2's fp32 shape, P = 64,
// N = 128: one stage, 105 KB; its bf16 shape and zamba2's: two).
// ssd_chunked_bwd_info reports the stages, the registers, the local
// (spill) bytes and the blocks an SM that the occupancy calculator gives.
//
// What holds it back: at mamba2's 8 x 128 fp32 shape it issues about 7.5 M
// mma.sync m16n8k8 (4300 a (stream, head, chunk) and 770 a chunk of the
// first walk, reckoned from the tiling, not counted) at a quarter of the
// rate mma.sync tf32 sustains on an H100 (scripts/flash_decode_ab.py
// --mma-rate); no unit is saturated: each warp's k steps (shared loads,
// splits, three dependent mma) run in sequence and two blocks an SM do not
// hide them, and 384 blocks fill the 264 slots of two an SM in 1.45 waves.
// A second accumulator for the lo products, and one block an SM with no
// register cap, ran no faster.  Device memory a launch moves beyond its
// inputs and outputs: the states scratch, written once and read once (P N
// fp32 a chunk, without the first chunk's when there is no h0; 37.7 MB
// each way at mamba2's shape), and the db/dc partials, written once here
// and read once by the head sum (2 S N fp32 a (stream, head), 50.3 MB).
//
// Why H_in is read from the L2 inside the dy H_in loop, not staged in
// shared memory: staging it takes P N fp32 more a block (32 KB at
// mamba2's shape, where one stage already takes 105 KB), which leaves one
// block an SM; and the round trips are not what holds the kernel back.
// scripts/ssd_bwd_variants.py times variants of this file on one card: one
// that writes no states and reads H_in from shared memory at no cost of
// staging or space, one that writes no db/dc partials, and one with
// neither.  On an NVIDIA H100 80GB HBM3 at 700 W (fp32 graph ms at
// mamba2's shape) they took 0.202, 0.211 and 0.197 against this kernel's
// 0.213: 8% at most, for both round trips gone and H_in free.
//
// x (B, S, H, P), b and c (B, S, N) in fp32 or bf16 through their strides
// (unit last stride, 16-byte aligned rows), dy (B, S, H, P) contiguous in
// x's type (16-byte aligned), dt (B, S, H) fp32, a_log and D (H,) fp32,
// optional h0 and dh_final (B, H, P, N) fp32.  dx (B, S, H, P) in x's
// type, ddt (B, S, H) fp32, db and dc (B, S, N) in x's type, dh0 (B, H,
// P, N) fp32.  Takes P a multiple of 8 up to 128 and N in {16, 32, 64,
// 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kQ = 32;           // steps per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLdQ = kQ + 8;     // (Q, Q) rows in shared memory
// shared memory a block may take so that two share an SM (228 KB less
// 1 KB reserved a block, halved), and the most one block may take
constexpr int kTwoBlockSmem = 115712;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// two consecutive elements of a shared row as fp32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// the Q rows of a chunk (row r at src + r * stride, `cols` elements) into
// shared rows of `ld` elements; rows from `valid` on are zeros
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long stride, int cols,
                                          int valid) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  const int chunks = cols / kE;
  for (int i = threadIdx.x; i < kQ * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c * kE, src + (ok ? r * stride : 0) + c * kE,
               ok);
  }
}

// ---- 3xTF32 on mma.sync m16n8k8, as in csrc/ssd_scan.cu
// hi = x with its low 13 mantissa bits cleared, an exact tf32 value, and
// lo = x - hi, exact in fp32, which enters its product cut to tf32 (an
// error of at most 2^-20 of x).
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}
// a value known to be exact in tf32 (a bf16 input, 0 or 1)
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
// A fragment rows g and g + 8 from two (k 2 t4, 2 t4 + 1) pairs: k is taken
// in that order, column t4 of the fragment being 2 t4 and t4 + 4 being
// 2 t4 + 1
template <bool kExactValue>
__device__ __forceinline__ void pair_rows(Split (&a)[4], float2 r0,
                                          float2 r1) {
  a[0] = operand<kExactValue>(r0.x);
  a[1] = operand<kExactValue>(r1.x);
  a[2] = operand<kExactValue>(r0.y);
  a[3] = operand<kExactValue>(r1.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The block's sum of v, the same in every thread and from run to run.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();                  // red may still be read by a last call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* d_skip;
  const float* h0;         // may be null
  const void* dy;
  const float* dh_final;   // may be null
  float* states;           // (B, H, S/Q, P, N) scratch
  void* dx;
  float* ddt;
  float* db_part;          // (B, H, S, N)
  float* dc_part;
  float* dh0;              // may be null
  float* da_part;          // (B, H)
  float* dd_part;
  long long x_sb, x_ss, x_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  int batch, seq, heads, p_dim, n_dim;
};

// Shared memory, in bytes: `stages` stages of x and dy (Q, P + 8) and b and
// c (Q, N + 8) in the input type, dH (P, N + 8) fp32, A, dG and dG^T (Q,
// Q + 8) fp32, and the per-warp partials of d la's parts and x . d xbar
// (4 x 8 x Q) and of <dH, H_in> (8).  The pads put the rows a fragment
// load reads in distinct banks.
struct Layout {
  int ldx, ldn, ldh;
  int x_off, dy_off, b_off, c_off, stage_bytes;
  int dh_off, a_off, dg_off, dgt_off, red_off, total;
};

__host__ __device__ constexpr Layout make_layout(int elem, int p_dim,
                                                 int n_dim, int stages) {
  Layout s{};
  s.ldx = p_dim + 8;
  s.ldn = n_dim + 8;
  s.ldh = n_dim + 8;
  s.x_off = 0;
  s.dy_off = s.x_off + kQ * s.ldx * elem;
  s.b_off = s.dy_off + kQ * s.ldx * elem;
  s.c_off = s.b_off + kQ * s.ldn * elem;
  s.stage_bytes = s.c_off + kQ * s.ldn * elem;
  s.dh_off = stages * s.stage_bytes;
  s.a_off = s.dh_off + p_dim * s.ldh * 4;
  s.dg_off = s.a_off + kQ * kLdQ * 4;
  s.dgt_off = s.dg_off + kQ * kLdQ * 4;
  s.red_off = s.dgt_off + kQ * kLdQ * 4;
  s.total = s.red_off + (4 * kWarps * kQ + kWarps) * 4;
  return s;
}

// Two stages where two blocks still share an SM, else one stage where that
// lets two share it, else as many as one block may hold.
constexpr int pick_stages(int elem, int p_dim, int n_dim) {
  const int two = make_layout(elem, p_dim, n_dim, 2).total;
  const int one = make_layout(elem, p_dim, n_dim, 1).total;
  if (two <= kTwoBlockSmem) return 2;
  if (one <= kTwoBlockSmem) return 1;
  return two <= kMaxSmem ? 2 : 1;
}

// The per-warp partials of one (Q) quantity: lanes t4 == 0 hold rows
// 16 rt + g and 16 rt + g + 8 of row tile rt in v[rt][0..1].
__device__ __forceinline__ void put_rows(float* dst, const float (&v)[2][2],
                                         int g, int t4) {
  if (t4 == 0) {
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      dst[16 * rt + g] = v[rt][0];
      dst[16 * rt + g + 8] = v[rt][1];
    }
  }
}
// Rows tr and tr + 8 (those before `rows`) of a (16, 16) fp32 tile at
// columns n0 + 8 hh + 2 t4 (+1) into a (S, kN) per-head partial, from t0.
template <int kN>
__device__ __forceinline__ void store_rows_n(float* dst, const float (&acc)[2][4],
                                             int t0, int tr, int rows, int n0,
                                             int t4) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = n0 + 8 * hh + 2 * t4;
    if (tr < rows) {
      store2(dst + static_cast<long long>(t0 + tr) * kN + n, acc[hh][0],
             acc[hh][1]);
    }
    if (tr + 8 < rows) {
      store2(dst + static_cast<long long>(t0 + tr + 8) * kN + n, acc[hh][2],
             acc[hh][3]);
    }
  }
}
// the sum over the four lanes t4 of one row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int kN, int kP, int kStages>
__global__ void __launch_bounds__(kThreads, kP == 64 ? 2 : 1)
ssd_bwd_kernel(const BwdArgs args) {
  constexpr bool kX = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kNM = kN / 16;                 // 16-row n tiles of the state
  constexpr int kPT = kP == 64 ? 8 : 16;       // 8-column p tiles, at most
  constexpr int kOwn = (kNM * kPT + kWarps - 1) / kWarps;   // a warp's
  constexpr int kDx = 2 * kPT / kWarps;        // d xbar tiles a warp
  constexpr int kDc = kNM == 8 ? 2 : 1;        // dc / db row tiles a warp
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  const int p_dim = kP != 0 ? kP : args.p_dim, pts = p_dim / 8;
  const Layout lay = make_layout(static_cast<int>(sizeof(T)), p_dim, kN,
                                 kStages);
  const int ldx = lay.ldx, ldn = lay.ldn, ldh = lay.ldh;
  float* dh_s = reinterpret_cast<float*>(smem + lay.dh_off);
  float* a_s = reinterpret_cast<float*>(smem + lay.a_off);
  float* dg_s = reinterpret_cast<float*>(smem + lay.dg_off);
  float* dgt_s = reinterpret_cast<float*>(smem + lay.dgt_off);
  float* red = reinterpret_cast<float*>(smem + lay.red_off);
  float* red_quad = red;                    // the scores' part of d la
  float* red_inter = red + kWarps * kQ;     // exp(L_t) dy_t . (H_in c_t)
  float* red_st = red + 2 * kWarps * kQ;    // wt xbar_t . (dH b_t)
  float* red_xd = red + 3 * kWarps * kQ;    // x_t . d xbar_t
  float* red_inner = red + 4 * kWarps * kQ; // <dH_out, H_in>

  const int h = blockIdx.x, bi = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int heads = args.heads, seq = args.seq;
  const int n_chunks = (seq + kQ - 1) / kQ;
  const int tiles = kNM * pts;                 // state tiles of a chunk
  const long long bh = static_cast<long long>(bi) * heads + h;
  const long long pn = static_cast<long long>(p_dim) * kN;
  const long long step_hp = static_cast<long long>(heads) * p_dim;

  const T* xg = static_cast<const T*>(args.x) + bi * args.x_sb + h * args.x_sh;
  const T* bg = static_cast<const T*>(args.b) + bi * args.b_sb;
  const T* cg = static_cast<const T*>(args.c) + bi * args.c_sb;
  const T* dyg = static_cast<const T*>(args.dy) +
                 (static_cast<long long>(bi) * seq * heads + h) * p_dim;
  T* dxg = static_cast<T*>(args.dx) +
           (static_cast<long long>(bi) * seq * heads + h) * p_dim;
  const float* dtg = args.dt + static_cast<long long>(bi) * seq * heads + h;
  float* ddtg = args.ddt + static_cast<long long>(bi) * seq * heads + h;
  float4* stg = reinterpret_cast<float4*>(args.states) +
                bh * n_chunks * tiles * 32;
  float* dbg = args.db_part + bh * seq * kN;
  float* dcg = args.dc_part + bh * seq * kN;
  const float a = -expf(args.a_log[h]);
  const float d_skip = args.d_skip[h];
  const bool with_h0 = args.h0 != nullptr;

  auto stage = [&](int s, int off) {
    return reinterpret_cast<T*>(smem + s * lay.stage_bytes + off);
  };
  auto load_chunk = [&](int ci, int s, bool grads) {
    const int t0 = ci * kQ, valid = seq - t0;
    load_rows(stage(s, lay.x_off), ldx, xg + t0 * args.x_ss, args.x_ss,
              p_dim, valid);
    load_rows(stage(s, lay.b_off), ldn, bg + t0 * args.b_ss, args.b_ss, kN,
              valid);
    if (grads) {
      load_rows(stage(s, lay.dy_off), ldx, dyg + t0 * step_hp, step_hp,
                p_dim, valid);
      load_rows(stage(s, lay.c_off), ldn, cg + t0 * args.c_ss, args.c_ss,
                kN, valid);
    }
  };
  // dt of step `lane` of chunk ci (0 past S: no decay, no input)
  auto dt_at = [&](int ci) {
    const int t = ci * kQ + lane;
    return t < seq ? dtg[static_cast<long long>(t) * heads] : 0.f;
  };
  // every warp scans for itself, lane = step: L, exp(L), exp(L_Q - L) (a
  // difference: <= 1) and exp(L_Q)
  struct Decay {
    float dt, l, el, wt, end;
  };
  auto scan = [&](float dtv) {
    float l = a * dtv;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kAll, l, off);
      if (lane >= off) l += up;
    }
    const float l_end = __shfl_sync(kAll, l, kQ - 1);
    return Decay{dtv, l, expf(l), expf(l_end - l), expf(l_end)};
  };

  // ---- the state: tile j of this warp is (n tile m_own, p tile pt(j)),
  // tile index pt kNM + m_own = warp + 8 j; elements (n = 16 m + g (+8),
  // p = 8 pt + 2 t4 (+1)) in the accumulator order
  const int m_own = warp % kNM;
  auto tile_pt = [&](int j) { return (warp + kWarps * j) / kNM; };
  auto elem_p = [&](int pt, int e) { return 8 * pt + 2 * t4 + (e & 1); };
  auto elem_n = [&](int m, int e) { return 16 * m + g + 8 * (e >> 1); };
  float st[kOwn][4];
  auto state_from = [&](const float* src) {
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int pt = tile_pt(j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[j][e] = (src != nullptr && pt < pts)
                       ? src[bh * pn + static_cast<long long>(
                                           elem_p(pt, e)) * kN +
                             elem_n(m_own, e)]
                       : 0.f;
      }
    }
  };

  // ---- first walk: each chunk's entry state into the scratch
  state_from(args.h0);
  const int walk = n_chunks - 1;               // chunks whose update counts
  float dt_next = walk > 0 ? dt_at(0) : 0.f;
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < walk) load_chunk(s, s, false);
    cp_async_commit();
  }
#pragma unroll 1
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci > 0 || with_h0) {
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        if (tile_pt(j) < pts) {
          __stcg(stg + (static_cast<long long>(ci) * tiles + warp +
                        kWarps * j) * 32 + lane,
                 make_float4(st[j][0], st[j][1], st[j][2], st[j][3]));
        }
      }
    }
    if (ci == walk) break;
    const int nxt = ci + kStages - 1;
    if (nxt < walk) load_chunk(nxt, nxt % kStages, false);
    cp_async_commit();
    const Decay dk = scan(dt_next);
    if (ci + 1 < walk) dt_next = dt_at(ci + 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* x_s = stage(ci % kStages, lay.x_off);
    const T* b_s = stage(ci % kStages, lay.b_off);
    // H = exp(L_Q) H + b^T (exp(L_Q - L) dt x), transposed
    const float wl = dk.wt * dk.dt;
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= dk.end;
    }
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const float w0 = __shfl_sync(kAll, wl, 8 * ks + t4);
      const float w1 = __shfl_sync(kAll, wl, 8 * ks + t4 + 4);
      const T* br = b_s + (8 * ks + t4) * ldn + 16 * m_own + g;
      const Split av[4] = {operand<kX>(ld(br)), operand<kX>(ld(br + 8)),
                           operand<kX>(ld(br + 4 * ldn)),
                           operand<kX>(ld(br + 4 * ldn + 8))};
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const int pt = tile_pt(j);
        if (pt < pts) {
          const T* xr = x_s + (8 * ks + t4) * ldx + 8 * pt + g;
          mma3<kX, false>(st[j], av, split(ld(xr) * w0),
                          split(ld(xr + 4 * ldx) * w1));
        }
      }
    }
    __syncthreads();                           // this stage is consumed
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- second walk, chunks in reverse, dH from dh_final: in shared
  // memory (dh_s) between chunks, where every product reads it, and in the
  // registers of the warps' tiles while it is updated
  state_from(args.dh_final);
  auto snapshot = [&]() {
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int pt = tile_pt(j);
      if (pt < pts) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dh_s[elem_p(pt, e) * ldh + elem_n(m_own, e)] = st[j][e];
        }
      }
    }
  };
  snapshot();
  float dd_acc = 0.f, da_acc = 0.f;
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk(n_chunks - 1 - s, s, true);
    cp_async_commit();
  }
  dt_next = n_chunks > 0 ? dt_at(n_chunks - 1) : 0.f;
#pragma unroll 1
  for (int r = 0; r < n_chunks; ++r) {
    const int ci = n_chunks - 1 - r;
    const int t0 = ci * kQ, rows = min(kQ, seq - t0);
    const int nxt = r + kStages - 1;
    if (nxt < n_chunks) load_chunk(n_chunks - 1 - nxt, nxt % kStages, true);
    cp_async_commit();
    const Decay dk = scan(dt_next);
    if (r + 1 < n_chunks) dt_next = dt_at(ci - 1);
    // H_in of this warp's n tile, every p tile, on its way to the L2 (read
    // at C, a fragment at a time; none for the first chunk without h0)
    const bool have_hin = ci > 0 || with_h0;
    const float4* hin_g = stg + (static_cast<long long>(ci) * tiles + m_own) *
                                    32 + lane;
    if (have_hin) {
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt) {
        if (pt < pts) {
          asm volatile("prefetch.global.L2 [%0];" ::"l"(hin_g + pt * kNM * 32));
        }
      }
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int sg = r % kStages;
    const T* x_s = stage(sg, lay.x_off);
    const T* dy_s = stage(sg, lay.dy_off);
    const T* b_s = stage(sg, lay.b_off);
    const T* c_s = stage(sg, lay.c_off);

    // ---- A. G and dA, a (16 t, 8 tau) tile a warp; A, dG and
    // dG^T to shared memory; the scores' part of d la
    {
      const int rt = warp / 4, ct = warp % 4;
      const bool live = 8 * ct <= 16 * rt + 15;   // some tau <= t
      float ga[4] = {0.f, 0.f, 0.f, 0.f}, da[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
#pragma unroll 4
        for (int ks = 0; ks < kN / 8; ++ks) {
          const T* cr = c_s + (16 * rt + g) * ldn + 8 * ks + 2 * t4;
          Split av[4];
          pair_rows<kX>(av, ld2(cr), ld2(cr + 8 * ldn));
          const float2 bv = ld2(b_s + (8 * ct + g) * ldn + 8 * ks + 2 * t4);
          mma3<kX, kX>(ga, av, operand<kX>(bv.x), operand<kX>(bv.y));
        }
#pragma unroll 4
        for (int ks = 0; ks < pts; ++ks) {
          const T* yr = dy_s + (16 * rt + g) * ldx + 8 * ks + 2 * t4;
          Split av[4];
          pair_rows<kX>(av, ld2(yr), ld2(yr + 8 * ldx));
          const float2 xv = ld2(x_s + (8 * ct + g) * ldx + 8 * ks + 2 * t4);
          mma3<kX, kX>(da, av, operand<kX>(xv.x), operand<kX>(xv.y));
        }
      }
      float pm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * rt + g + 8 * (e >> 1);
        const int tau = 8 * ct + 2 * t4 + (e & 1);
        const float lt = __shfl_sync(kAll, dk.l, t);
        const float ltau = __shfl_sync(kAll, dk.l, tau);
        const float dtau = __shfl_sync(kAll, dk.dt, tau);
        // mask before exp: only tau <= t is ever exponentiated
        const float ex = tau <= t ? expf(lt - ltau) : 0.f;
        const float dav = da[e] * dtau;            // dy_t . xbar_tau
        const float av = ga[e] * ex;
        const float dg = ex * dav;
        pm[e] = av * dav;
        dg_s[t * kLdQ + tau] = dg;
        dgt_s[tau * kLdQ + t] = dg;
        a_s[t * kLdQ + tau] = av;
      }
      // sum_{c < t} pm[r][c] for every t (pm times the strict upper
      // triangle of ones), summed over this tile's rows r >= t
      const Split pa[4] = {split(pm[0]), split(pm[2]), split(pm[1]),
                           split(pm[3])};
      float q[4][2];
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        const int c0 = 8 * ct + 2 * t4, tcol = 8 * jt + g;
        mma3<false, true>(s, pa, exact(c0 < tcol ? 1.f : 0.f),
                          exact(c0 + 1 < tcol ? 1.f : 0.f));
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int t = 8 * jt + 2 * t4 + k;
          float v = (16 * rt + g >= t ? s[k] : 0.f) +
                    (16 * rt + g + 8 >= t ? s[k + 2] : 0.f);
          v += __shfl_xor_sync(kAll, v, 4);
          v += __shfl_xor_sync(kAll, v, 8);
          v += __shfl_xor_sync(kAll, v, 16);
          q[jt][k] = v;
        }
      }
      if (g == 0) {
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
          red_quad[warp * kQ + 8 * jt + 2 * t4] = q[jt][0];
          red_quad[warp * kQ + 8 * jt + 2 * t4 + 1] = q[jt][1];
        }
      }
    }
    __syncthreads();

    // ---- B. d xbar = wt (b dH^T) + A^T dy, (16 tau, 8 p) tiles; dx
    {
      const int rt = warp % 2;
      const int tau0 = 16 * rt + g, tau1 = tau0 + 8;
      float acc[kDx][4];
#pragma unroll
      for (int j = 0; j < kDx; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
#pragma unroll 4
      for (int ks = 0; ks < kN / 8; ++ks) {
        const T* br = b_s + tau0 * ldn + 8 * ks + 2 * t4;
        Split av[4];
        pair_rows<kX>(av, ld2(br), ld2(br + 8 * ldn));
#pragma unroll
        for (int j = 0; j < kDx; ++j) {
          const int pt = warp / 2 + 4 * j;
          if (pt < pts) {
            const float2 hv = ld2(dh_s + (8 * pt + g) * ldh + 8 * ks + 2 * t4);
            mma3<kX, false>(acc[j], av, split(hv.x), split(hv.y));
          }
        }
      }
      const float w0 = __shfl_sync(kAll, dk.wt, tau0);
      const float w1 = __shfl_sync(kAll, dk.wt, tau1);
#pragma unroll
      for (int j = 0; j < kDx; ++j) {
        acc[j][0] *= w0; acc[j][1] *= w0;
        acc[j][2] *= w1; acc[j][3] *= w1;
      }
#pragma unroll
      for (int ks = 0; ks < kQ / 8; ++ks) {
        if (ks < 2 * rt) continue;                 // every t < tau
        const float* ar = a_s + (8 * ks + t4) * kLdQ + tau0;
        const Split av[4] = {split(ar[0]), split(ar[8]), split(ar[4 * kLdQ]),
                             split(ar[4 * kLdQ + 8])};
#pragma unroll
        for (int j = 0; j < kDx; ++j) {
          const int pt = warp / 2 + 4 * j;
          if (pt < pts) {
            const T* yr = dy_s + (8 * ks + t4) * ldx + 8 * pt + g;
            mma3<false, kX>(acc[j], av, operand<kX>(ld(yr)),
                            operand<kX>(ld(yr + 4 * ldx)));
          }
        }
      }
      const float dt0 = __shfl_sync(kAll, dk.dt, tau0);
      const float dt1 = __shfl_sync(kAll, dk.dt, tau1);
      float xd0 = 0.f, xd1 = 0.f;
#pragma unroll
      for (int j = 0; j < kDx; ++j) {
        const int pt = warp / 2 + 4 * j;
        if (pt < pts) {
          const int p = 8 * pt + 2 * t4;
          const float2 x0 = ld2(x_s + tau0 * ldx + p);
          const float2 x1 = ld2(x_s + tau1 * ldx + p);
          const float2 y0 = ld2(dy_s + tau0 * ldx + p);
          const float2 y1 = ld2(dy_s + tau1 * ldx + p);
          xd0 += x0.x * acc[j][0] + x0.y * acc[j][1];
          xd1 += x1.x * acc[j][2] + x1.y * acc[j][3];
          dd_acc += x0.x * y0.x + x0.y * y0.y + x1.x * y1.x + x1.y * y1.y;
          if (tau0 < rows) {
            store2(dxg + (t0 + tau0) * step_hp + p,
                   fmaf(dt0, acc[j][0], d_skip * y0.x),
                   fmaf(dt0, acc[j][1], d_skip * y0.y));
          }
          if (tau1 < rows) {
            store2(dxg + (t0 + tau1) * step_hp + p,
                   fmaf(dt1, acc[j][2], d_skip * y1.x),
                   fmaf(dt1, acc[j][3], d_skip * y1.y));
          }
        }
      }
      xd0 = quad_sum(xd0);
      xd1 = quad_sum(xd1);
      const float xd[2][2] = {{rt == 0 ? xd0 : 0.f, rt == 0 ? xd1 : 0.f},
                              {rt == 1 ? xd0 : 0.f, rt == 1 ? xd1 : 0.f}};
      put_rows(red_xd + warp * kQ, xd, g, t4);
    }

    // ---- C. dc = exp(L_t) dy H_in + dG b, and <dH_out, H_in>; D. db =
    // wt dt (x dH) + dG^T c; (16 t, 16 n) tiles of n tile m_own, one row
    // tile at a time
    {
      const bool active = warp < 2 * kNM;
      const int n0 = 16 * m_own;
      float inner = 0.f;
      float inter[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float stv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      if (active) {
#pragma unroll
        for (int j = 0; j < kDc; ++j) {
          const int rt = (warp + kWarps * j) / kNM;
          const int tr = 16 * rt + g;
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          // C. dy H_in, k = p (skipped when H_in is zero); <dH_out, H_in>
          // once an n tile
          if (have_hin) {
#pragma unroll 2
            for (int pt = 0; pt < pts; ++pt) {
              {
                const float4 hv = __ldcg(hin_g + pt * kNM * 32);
                const T* yr = dy_s + tr * ldx + 8 * pt + 2 * t4;
                Split av[4];
                pair_rows<kX>(av, ld2(yr), ld2(yr + 8 * ldx));
                mma3<kX, false>(acc[0], av, split(hv.x), split(hv.y));
                mma3<kX, false>(acc[1], av, split(hv.z), split(hv.w));
                if (j == 0 && warp < kNM) {
                  const float* hr = dh_s + (8 * pt + 2 * t4) * ldh + n0 + g;
                  inner = fmaf(hr[0], hv.x, inner);
                  inner = fmaf(hr[ldh], hv.y, inner);
                  inner = fmaf(hr[8], hv.z, inner);
                  inner = fmaf(hr[ldh + 8], hv.w, inner);
                }
              }
            }
          }
          {
            // scaled by exp(L_t), dotted with c: the inter-chunk part of d la
            const float e0 = __shfl_sync(kAll, dk.el, tr);
            const float e1 = __shfl_sync(kAll, dk.el, tr + 8);
            float v0 = 0.f, v1 = 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float (&c4)[4] = acc[hh];
              c4[0] *= e0; c4[1] *= e0; c4[2] *= e1; c4[3] *= e1;
              const int n = n0 + 8 * hh + 2 * t4;
              const float2 cv0 = ld2(c_s + tr * ldn + n);
              const float2 cv1 = ld2(c_s + (tr + 8) * ldn + n);
              v0 += c4[0] * cv0.x + c4[1] * cv0.y;
              v1 += c4[2] * cv1.x + c4[3] * cv1.y;
            }
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              inter[k][0] += rt == k ? v0 : 0.f;
              inter[k][1] += rt == k ? v1 : 0.f;
            }
          }
          // + dG b, k = tau <= t
#pragma unroll
          for (int ks = 0; ks < kQ / 8; ++ks) {
            if (ks > 2 * rt + 1) continue;            // every tau > t
            const float* gr = dgt_s + (8 * ks + t4) * kLdQ + tr;
            const Split av[4] = {split(gr[0]), split(gr[8]),
                                 split(gr[4 * kLdQ]),
                                 split(gr[4 * kLdQ + 8])};
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const T* br = b_s + (8 * ks + t4) * ldn + n0 + 8 * hh + g;
              mma3<false, kX>(acc[hh], av, operand<kX>(ld(br)),
                              operand<kX>(ld(br + 4 * ldn)));
            }
          }
          store_rows_n<kN>(dcg, acc, t0, tr, rows, n0, t4);

          // D. x dH, k = p: dH[p][n] in the order 2 t4, 2 t4 + 1
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            acc[hh][0] = acc[hh][1] = acc[hh][2] = acc[hh][3] = 0.f;
          }
#pragma unroll 2
          for (int pt = 0; pt < pts; ++pt) {
            {
              const float* hr = dh_s + (8 * pt + 2 * t4) * ldh + n0 + g;
              const T* xr = x_s + tr * ldx + 8 * pt + 2 * t4;
              Split av[4];
              pair_rows<kX>(av, ld2(xr), ld2(xr + 8 * ldx));
              mma3<kX, false>(acc[0], av, split(hr[0]), split(hr[ldh]));
              mma3<kX, false>(acc[1], av, split(hr[8]), split(hr[ldh + 8]));
            }
          }
          {
            // scaled by wt dt, dotted with b: the state's part of d la
            const float s0 = __shfl_sync(kAll, dk.wt, tr) *
                             __shfl_sync(kAll, dk.dt, tr);
            const float s1 = __shfl_sync(kAll, dk.wt, tr + 8) *
                             __shfl_sync(kAll, dk.dt, tr + 8);
            float v0 = 0.f, v1 = 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float (&c4)[4] = acc[hh];
              c4[0] *= s0; c4[1] *= s0; c4[2] *= s1; c4[3] *= s1;
              const int n = n0 + 8 * hh + 2 * t4;
              const float2 bv0 = ld2(b_s + tr * ldn + n);
              const float2 bv1 = ld2(b_s + (tr + 8) * ldn + n);
              v0 += c4[0] * bv0.x + c4[1] * bv0.y;
              v1 += c4[2] * bv1.x + c4[3] * bv1.y;
            }
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              stv[k][0] += rt == k ? v0 : 0.f;
              stv[k][1] += rt == k ? v1 : 0.f;
            }
          }
          // + dG^T c, k = t >= tau
#pragma unroll
          for (int ks = 0; ks < kQ / 8; ++ks) {
            if (ks < 2 * rt) continue;                // every t < tau
            const float* gr = dg_s + (8 * ks + t4) * kLdQ + tr;
            const Split av[4] = {split(gr[0]), split(gr[8]),
                                 split(gr[4 * kLdQ]),
                                 split(gr[4 * kLdQ + 8])};
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const T* cr = c_s + (8 * ks + t4) * ldn + n0 + 8 * hh + g;
              mma3<false, kX>(acc[hh], av, operand<kX>(ld(cr)),
                              operand<kX>(ld(cr + 4 * ldn)));
            }
          }
          store_rows_n<kN>(dbg, acc, t0, tr, rows, n0, t4);
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        inter[k][0] = quad_sum(inter[k][0]);
        inter[k][1] = quad_sum(inter[k][1]);
        stv[k][0] = quad_sum(stv[k][0]);
        stv[k][1] = quad_sum(stv[k][1]);
      }
      put_rows(red_inter + warp * kQ, inter, g, t4);
      put_rows(red_st + warp * kQ, stv, g, t4);
      inner = warp_sum(inner);
      if (lane == 0) red_inner[warp] = inner;
    }
    __syncthreads();                           // dH's snapshot is read

    // ---- E. dH_in = exp(L_Q) dH_out + (exp(L) c)^T dy, transposed, in
    // the registers of this warp's tiles, from and back to the snapshot
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int pt = tile_pt(j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[j][e] = pt < pts ? dk.end * dh_s[elem_p(pt, e) * ldh +
                                            elem_n(m_own, e)]
                            : 0.f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const float e0 = __shfl_sync(kAll, dk.el, 8 * ks + t4);
      const float e1 = __shfl_sync(kAll, dk.el, 8 * ks + t4 + 4);
      const T* cr = c_s + (8 * ks + t4) * ldn + 16 * m_own + g;
      const Split av[4] = {split(ld(cr) * e0), split(ld(cr + 8) * e0),
                           split(ld(cr + 4 * ldn) * e1),
                           split(ld(cr + 4 * ldn + 8) * e1)};
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const int pt = tile_pt(j);
        if (pt < pts) {
          const T* yr = dy_s + (8 * ks + t4) * ldx + 8 * pt + g;
          mma3<false, kX>(st[j], av, operand<kX>(ld(yr)),
                          operand<kX>(ld(yr + 4 * ldx)));
        }
      }
    }
    if (r + 1 < n_chunks) snapshot();

    // d la (warp 0, lane = step): the inter-chunk terms of the steps at
    // and after it, the state's, those of the steps before it, and the
    // scores', each summed over the warps in order; ddt
    if (warp == 0) {
      float quad = 0.f, in = 0.f, stc = 0.f, xd = 0.f, inner = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        quad += red_quad[w * kQ + lane];
        in += red_inter[w * kQ + lane];
        stc += red_st[w * kQ + lane];
        xd += red_xd[w * kQ + lane];
        inner += red_inner[w];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float down = __shfl_down_sync(kAll, in, off);
        const float up = __shfl_up_sync(kAll, stc, off);
        if (lane + off < 32) in += down;
        if (lane >= off) stc += up;
      }
      const float st_before = __shfl_up_sync(kAll, stc, 1);
      const float dla = in + dk.end * inner + (lane > 0 ? st_before : 0.f) +
                        quad;
      da_acc = fmaf(dla, a * dk.dt, da_acc);
      if (lane < rows) {
        ddtg[static_cast<long long>(t0 + lane) * heads] = fmaf(a, dla, xd);
      }
    }
    __syncthreads();                           // this stage is consumed
  }
  cp_async_wait<0>();

  if (args.dh0 != nullptr) {
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int pt = tile_pt(j);
      if (pt < pts) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          args.dh0[bh * pn + static_cast<long long>(elem_p(pt, e)) * kN +
                   elem_n(m_own, e)] = st[j][e];
        }
      }
    }
  }
  const float dd = block_sum(dd_acc, red);
  const float da = block_sum(da_acc, red);
  if (threadIdx.x == 0) {
    args.dd_part[bh] = dd;
    args.da_part[bh] = da;
  }
}

// db and dc: the per-head partials (B, H, S, N) summed over the heads in
// order, one thread an element of (B, S, N)
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_head_sum_kernel(const float* db_part, const float* dc_part, T* db,
                        T* dc, int batch, int heads, int seq, int n_dim) {
  const long long per = static_cast<long long>(seq) * n_dim;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= batch * per) return;
  const long long bi = i / per, r = i - bi * per;
  const float* pb = db_part + bi * heads * per + r;
  const float* pc = dc_part + bi * heads * per + r;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < heads; ++h) {
    sb += pb[h * per];
    sc += pc[h * per];
  }
  put(db + i, sb);
  put(dc + i, sc);
}

// Launch the instantiation, or (info != null) report it without launching:
// info[0..5] = stages, dynamic shared bytes, registers a thread, local
// (spill) bytes a thread, blocks an SM, max threads a block.
template <typename T, int kN, int kP, int kStages>
int run(const BwdArgs& args, cudaStream_t s, int* info) {
  auto kernel = ssd_bwd_kernel<T, kN, kP, kStages>;
  const int smem = make_layout(static_cast<int>(sizeof(T)), args.p_dim, kN,
                               kStages).total;
  // above 48 KB only once raised; set before every launch, since the
  // attribute is per device and the current device may change
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info != nullptr) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[0] = kStages;
    info[1] = smem;
    info[2] = attr.numRegs;
    info[3] = static_cast<int>(attr.localSizeBytes);
    info[4] = blocks;
    info[5] = attr.maxThreadsPerBlock;
    return 0;
  }
  kernel<<<dim3(static_cast<unsigned>(args.heads),
                static_cast<unsigned>(args.batch)),
           kThreads, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// P = 64 (mamba2-780m's and zamba2-1.2b's head dim) compiles its P; any
// other P runs the P <= 128 kernel that reads it at run time, one stage.
template <typename T, int kN>
int run_n(const BwdArgs& args, cudaStream_t s, int* info) {
  constexpr int kElem = static_cast<int>(sizeof(T));
  if (args.p_dim == 64) {
    return run<T, kN, 64, pick_stages(kElem, 64, kN)>(args, s, info);
  }
  return run<T, kN, 0, 1>(args, s, info);
}

template <typename T>
int run_t(const BwdArgs& args, cudaStream_t s, int* info) {
  switch (args.n_dim) {
    case 16: return run_n<T, 16>(args, s, info);
    case 32: return run_n<T, 32>(args, s, info);
    case 64: return run_n<T, 64>(args, s, info);
    case 128: return run_n<T, 128>(args, s, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run_dtype(const BwdArgs& args, int dtype, cudaStream_t s, int* info) {
  if (args.p_dim % 8 != 0 || args.p_dim < 8 || args.p_dim > 128 ||
      args.batch < 1 || args.batch > 65535 || args.heads < 1 ||
      args.seq < 0 ||
      (args.n_dim != 16 && args.n_dim != 32 && args.n_dim != 64 &&
       args.n_dim != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return run_t<float>(args, s, info);
  if (dtype == 1) return run_t<__nv_bfloat16>(args, s, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_head_sum(const float* db_part, const float* dc_part, void* db,
                    void* dc, int batch, int heads, int seq, int n_dim,
                    cudaStream_t s) {
  const long long total = static_cast<long long>(batch) * seq * n_dim;
  const long long blocks = (total + 255) / 256;
  if (blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ssd_bwd_head_sum_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      db_part, dc_part, static_cast<T*>(db), static_cast<T*>(dc), batch,
      heads, seq, n_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c, dy, dx).  h0, dh_final and
// dh0 may be null (dh0 is written when not null).  states is (B, H,
// ceil(S / 32), P, N) fp32 scratch, db_part and dc_part (B, H, S, N) fp32,
// da_part and dd_part (B, H) fp32; all written by this launch (states only
// where it is read back), the last four read by ssd_bwd_head_sum_launch
// and the caller.  Takes P a multiple of 8 up to 128, N in {16, 32, 64,
// 128}, B up to 65535, H >= 1.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int ssd_chunked_bwd_launch(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, const void* d_skip, const void* h0, const void* dy,
    const void* dh_final, void* states, void* dx, void* ddt, void* db_part,
    void* dc_part, void* dh0, void* da_part, void* dd_part, long long x_sb,
    long long x_ss, long long x_sh, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int batch, int seq, int heads,
    int p_dim, int n_dim, int dtype, void* stream) {
  BwdArgs args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a_log = static_cast<const float*>(a_log);
  args.b = b;
  args.c = c;
  args.d_skip = static_cast<const float*>(d_skip);
  args.h0 = static_cast<const float*>(h0);
  args.dy = dy;
  args.dh_final = static_cast<const float*>(dh_final);
  args.states = static_cast<float*>(states);
  args.dx = dx;
  args.ddt = static_cast<float*>(ddt);
  args.db_part = static_cast<float*>(db_part);
  args.dc_part = static_cast<float*>(dc_part);
  args.dh0 = static_cast<float*>(dh0);
  args.da_part = static_cast<float*>(da_part);
  args.dd_part = static_cast<float*>(dd_part);
  args.x_sb = x_sb; args.x_ss = x_ss; args.x_sh = x_sh;
  args.b_sb = b_sb; args.b_ss = b_ss;
  args.c_sb = c_sb; args.c_ss = c_ss;
  args.batch = batch; args.seq = seq; args.heads = heads;
  args.p_dim = p_dim; args.n_dim = n_dim;
  return run_dtype(args, dtype, static_cast<cudaStream_t>(stream), nullptr);
}

// What ssd_chunked_bwd_launch runs at (P, N, dtype), without launching it:
// out[0..5] = stages, dynamic shared bytes, registers a thread, local
// (spill) bytes a thread, blocks an SM by the occupancy calculator, max
// threads a block.  The stream, the last argument of every entry point
// here, is not used.  Returns a CUDA error code (0 on success).
extern "C" int ssd_chunked_bwd_info(int p_dim, int n_dim, int dtype,
                                    int* out, void* /*stream*/) {
  BwdArgs args = {};
  args.batch = 1; args.seq = 0; args.heads = 1;
  args.p_dim = p_dim; args.n_dim = n_dim;
  return run_dtype(args, dtype, nullptr, out);
}

// db, dc (B, S, N) in the dtype's type from the partials above.  Needs
// B S N >= 1.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_bwd_head_sum_launch(const void* db_part,
                                       const void* dc_part, void* db,
                                       void* dc, int batch, int heads,
                                       int seq, int n_dim, int dtype,
                                       void* stream) {
  const float* pb = static_cast<const float*>(db_part);
  const float* pc = static_cast<const float*>(dc_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_head_sum<float>(pb, pc, db, dc, batch, heads, seq, n_dim,
                                  s);
  }
  if (dtype == 1) {
    return launch_head_sum<__nv_bfloat16>(pb, pc, db, dc, batch, heads, seq,
                                          n_dim, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
