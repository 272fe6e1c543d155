// The backward of the chunked Mamba2 SSD scan (csrc/ssd_scan.cu) for
// Hopper (sm_90a).
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
// underflows to 0 and never gives 0 * inf.
//
// Bound: operations.  About 5 Q P N + 3 Q^2 N + 2 Q^2 P multiply-adds a
// (stream, head, chunk) of Q steps against a few bytes a step.  This first
// version runs them on the CUDA cores in fp32 (4 x 4 register tiles a
// thread, operands in shared memory); the tensor cores (3xTF32, as the
// forward) are later work.
//
// Two kernels, one launch each:
//
// 1. ssd_bwd_kernel: one block of 256 threads per (stream, head).  It
//    walks the chunks forward once to recompute each chunk's entry state
//    H_in into a scratch (B, H, S/Q, P, N) fp32 that the caller frees
//    after this layer's backward (nothing but the inputs is kept from the
//    forward), then walks them in reverse with dH in shared memory.  It
//    writes dx, ddt and dh0, and per-head partials: db and dc (B, H, S,
//    N) fp32 (b and c are one group shared by every head) and d a_log, dD
//    (B, H) fp32.  The chunk is the forward kernel's Q = 32 (the last
//    chunk may be short: its rows past S are zeros and add nothing).
// 2. ssd_bwd_head_sum_kernel: db and dc = the per-head partials summed
//    over the heads in order, one thread an element.  No atomics: the
//    gradient is the same from run to run.  (The (B, H) -> (H,) sums of
//    d a_log and dD are left to the caller.)
//
// x (B, S, H, P), b and c (B, S, N) in fp32 or bf16 through their strides
// (unit last stride), dy (B, S, H, P) contiguous in x's type, dt (B, S, H)
// fp32, a_log and D (H,) fp32, optional h0 and dh_final (B, H, P, N) fp32.
// dx (B, S, H, P) in x's type, ddt (B, S, H) fp32, db and dc (B, S, N) in
// x's type, dh0 (B, H, P, N) fp32.  Takes P a multiple of 8 up to 128 and
// N in {16, 32, 64, 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 32;           // steps per chunk, one warp lane a step
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLdQ = kQ + 1;     // (Q, Q) rows in shared memory

__device__ __forceinline__ float to_f(const float* p) { return *p; }
__device__ __forceinline__ float to_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// Shared memory, in floats: (Q, P + 1) x, xbar, dy and u / d xbar; (Q,
// N + 1) b, c, M = dy H_in and V = xbar dH; (Q, Q + 1) G / A, dA / dG and
// A dA; (P, N + 1) dH (the state H in the first walk); 10 step vectors and
// 32 floats of block sums.  Rows pad by one float, so that a column read
// down the rows hits distinct banks.
__host__ __device__ inline int smem_floats(int p_dim, int n_dim) {
  return 4 * kQ * (p_dim + 1) + 4 * kQ * (n_dim + 1) + 3 * kQ * kLdQ +
         p_dim * (n_dim + 1) + 10 * kQ + 32;
}

// out(i, j) = sum_k fa(i, k) fb(k, j) over an m x n output (multiples of
// 4), in 4 x 4 register tiles; the tile (it, jt) holds rows it + u m/4
// and columns jt + v n/4, so that neighbouring threads read neighbouring
// columns.  `rot` shifts which threads take the first tiles, so that small
// products issued together land on different threads.
template <typename FA, typename FB, typename Epi>
__device__ __forceinline__ void product(int m, int n, int k, int rot, FA fa,
                                        FB fb, Epi epi) {
  const int mt = m / 4, nt = n / 4, tiles = mt * nt;
  for (int tile = (threadIdx.x + kThreads - rot) % kThreads; tile < tiles;
       tile += kThreads) {
    const int it = tile / nt, jt = tile - (tile / nt) * nt;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < k; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        av[u] = fa(it + u * mt, kk);
        bv[u] = fb(kk, jt + u * nt);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) epi(it + u * mt, jt + v * nt, acc[u][v]);
    }
  }
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

// rows [0, rows) of a chunk (row r at src + r * stride, `cols` elements)
// into shared rows of `ld` floats; rows past `rows` up to Q are zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long stride, int cols,
                                          int rows) {
  for (int i = threadIdx.x; i < kQ * cols; i += kThreads) {
    const int r = i / cols, col = i - r * cols;
    dst[r * ld + col] = r < rows ? to_f(src + r * stride + col) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel(const BwdArgs args) {
  extern __shared__ __align__(16) float sm[];
  const int p_dim = args.p_dim, n_dim = args.n_dim;
  const int ldp = p_dim + 1, ldn = n_dim + 1;
  float* xs = sm;                       // x
  float* xbs = xs + kQ * ldp;           // xbar = dt x
  float* dys = xbs + kQ * ldp;          // dy
  float* us = dys + kQ * ldp;           // u = dH_out b, then d xbar
  float* bs = us + kQ * ldp;
  float* cs = bs + kQ * ldn;
  float* ms = cs + kQ * ldn;            // M = dy H_in
  float* vs = ms + kQ * ldn;            // V = xbar dH_out
  float* gs = vs + kQ * ldn;            // G, then A
  float* dgs = gs + kQ * kLdQ;          // dA, then dG
  float* pms = dgs + kQ * kLdQ;         // A dA
  float* hs = pms + kQ * kLdQ;          // H (first walk), dH (second)
  float* dts = hs + p_dim * ldn;        // dt
  float* ls = dts + kQ;                 // L
  float* els = ls + kQ;                 // exp(L_t)
  float* wts = els + kQ;                // exp(L_Q - L_t)
  float* wdts = wts + kQ;               // exp(L_Q - L_t) dt_t
  float* dls = wdts + kQ;               // the scores' part of d la
  float* ins = dls + kQ;                // exp(L_t) dy_t . (H_in c_t)
  float* sts = ins + kQ;                // exp(L_Q - L_t) xbar_t . u_t
  float* xds = sts + kQ;                // x_t . d xbar_t
  float* dlas = xds + kQ;               // d la
  float* red = dlas + kQ;               // block sums

  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int heads = args.heads, seq = args.seq;
  const int n_chunks = (seq + kQ - 1) / kQ;
  const int pn = p_dim * n_dim;
  const long long bh = static_cast<long long>(bi) * heads + h;
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
  float* stg = args.states + bh * n_chunks * pn;
  float* dbg = args.db_part + bh * seq * n_dim;
  float* dcg = args.dc_part + bh * seq * n_dim;
  const float a = -expf(args.a_log[h]);
  const float d_skip = args.d_skip[h];

  // the chunk's dt, then (warp 0, lane = step) L by a scan of a dt, and
  // the decays; rows past S have dt = 0: no decay, no input
  auto load_dt = [&](int t0, int rows) {
    if (tid < kQ) {
      dts[tid] = tid < rows ? dtg[static_cast<long long>(t0 + tid) * heads]
                            : 0.f;
    }
  };
  auto scan = [&]() {
    if (warp == 0) {
      float l = a * dts[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, l, off);
        if (lane >= off) l += up;
      }
      const float l_end = __shfl_sync(0xffffffffu, l, kQ - 1);
      ls[lane] = l;
      els[lane] = expf(l);
      wts[lane] = expf(l_end - l);          // a difference: <= 1
      wdts[lane] = wts[lane] * dts[lane];
    }
  };

  // ---- first walk: each chunk's entry state into the scratch
  for (int i = tid; i < pn; i += kThreads) {
    const int p = i / n_dim, n = i - p * n_dim;
    hs[p * ldn + n] = args.h0 != nullptr ? args.h0[bh * pn + i] : 0.f;
  }
#pragma unroll 1
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kQ, rows = min(kQ, seq - t0);
    load_rows(xs, ldp, xg + t0 * args.x_ss, args.x_ss, p_dim, rows);
    load_rows(bs, ldn, bg + t0 * args.b_ss, args.b_ss, n_dim, rows);
    load_dt(t0, rows);
    __syncthreads();
    scan();
    __syncthreads();
    const float decay = expf(ls[kQ - 1]);
    float* out = stg + static_cast<long long>(ci) * pn;
    // H = exp(L_Q) H + sum_tau exp(L_Q - L_tau) dt_tau x_tau b_tau^T
    product(p_dim, n_dim, kQ, 0,
            [&](int p, int t) { return xs[t * ldp + p] * wdts[t]; },
            [&](int t, int n) { return bs[t * ldn + n]; },
            [&](int p, int n, float acc) {
              const float old = hs[p * ldn + n];
              out[p * n_dim + n] = old;
              hs[p * ldn + n] = fmaf(decay, old, acc);
            });
    __syncthreads();
  }

  // ---- second walk, chunks in reverse, dH from dh_final
  for (int i = tid; i < pn; i += kThreads) {
    const int p = i / n_dim, n = i - p * n_dim;
    hs[p * ldn + n] =
        args.dh_final != nullptr ? args.dh_final[bh * pn + i] : 0.f;
  }
  float dd_acc = 0.f, da_acc = 0.f;
#pragma unroll 1
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * kQ, rows = min(kQ, seq - t0);
    // written by this block's first walk: plain loads, not the read-only
    // cache
    const float* h_in = stg + static_cast<long long>(ci) * pn;
    load_rows(xs, ldp, xg + t0 * args.x_ss, args.x_ss, p_dim, rows);
    load_rows(dys, ldp, dyg + t0 * step_hp, step_hp, p_dim, rows);
    load_rows(bs, ldn, bg + t0 * args.b_ss, args.b_ss, n_dim, rows);
    load_rows(cs, ldn, cg + t0 * args.c_ss, args.c_ss, n_dim, rows);
    load_dt(t0, rows);
    __syncthreads();
    scan();
    for (int i = tid; i < kQ * p_dim; i += kThreads) {
      const int t = i / p_dim, p = i - t * p_dim;
      const float xv = xs[t * ldp + p];
      xbs[t * ldp + p] = dts[t] * xv;
      dd_acc = fmaf(xv, dys[t * ldp + p], dd_acc);
    }
    __syncthreads();

    // G = C B^T, dA = dy xbar^T, u = B dH^T, M = dy H_in, V = xbar dH,
    // and <dH_out, H_in>
    product(kQ, kQ, n_dim, 0,
            [&](int t, int n) { return cs[t * ldn + n]; },
            [&](int n, int tau) { return bs[tau * ldn + n]; },
            [&](int t, int tau, float acc) { gs[t * kLdQ + tau] = acc; });
    product(kQ, kQ, p_dim, 64,
            [&](int t, int p) { return dys[t * ldp + p]; },
            [&](int p, int tau) { return xbs[tau * ldp + p]; },
            [&](int t, int tau, float acc) { dgs[t * kLdQ + tau] = acc; });
    product(kQ, p_dim, n_dim, 128,
            [&](int tau, int n) { return bs[tau * ldn + n]; },
            [&](int n, int p) { return hs[p * ldn + n]; },
            [&](int tau, int p, float acc) { us[tau * ldp + p] = acc; });
    product(kQ, n_dim, p_dim, 0,
            [&](int t, int p) { return dys[t * ldp + p]; },
            [&](int p, int n) { return h_in[p * n_dim + n]; },
            [&](int t, int n, float acc) { ms[t * ldn + n] = acc; });
    product(kQ, n_dim, p_dim, 0,
            [&](int tau, int p) { return xbs[tau * ldp + p]; },
            [&](int p, int n) { return hs[p * ldn + n]; },
            [&](int tau, int n, float acc) { vs[tau * ldn + n] = acc; });
    float part = 0.f;
    for (int i = tid; i < pn; i += kThreads) {
      const int p = i / n_dim, n = i - p * n_dim;
      part = fmaf(hs[p * ldn + n], h_in[i], part);
    }
    const float inner = block_sum(part, red);   // syncs the block

    // A = G e, dG = e dA, A dA, with e = exp(L_t - L_tau), 0 for tau > t
    for (int i = tid; i < kQ * kQ; i += kThreads) {
      const int t = i / kQ, tau = i - t * kQ;
      float av = 0.f, dg = 0.f, pm = 0.f;
      if (tau <= t) {
        const float e = expf(ls[t] - ls[tau]);
        const float da = dgs[t * kLdQ + tau];
        av = gs[t * kLdQ + tau] * e;
        dg = e * da;
        pm = av * da;
      }
      gs[t * kLdQ + tau] = av;
      dgs[t * kLdQ + tau] = dg;
      pms[t * kLdQ + tau] = pm;
    }
    __syncthreads();

    // per step t, the parts of d la_t (see the top): the scores' pairs
    // r >= t > c (lane = r), the inter-chunk term and the state term; a
    // warp a step
    for (int t = warp; t < kQ; t += kWarps) {
      float quad = 0.f, inter = 0.f, sv = 0.f;
      if (lane >= t) {
        for (int c = 0; c < t; ++c) quad += pms[lane * kLdQ + c];
      }
      for (int n = lane; n < n_dim; n += 32) {
        inter = fmaf(ms[t * ldn + n], cs[t * ldn + n], inter);
      }
      for (int p = lane; p < p_dim; p += 32) {
        sv = fmaf(xbs[t * ldp + p], us[t * ldp + p], sv);
      }
      quad = warp_sum(quad);
      inter = warp_sum(inter);
      sv = warp_sum(sv);
      if (lane == 0) {
        dls[t] = quad;
        ins[t] = els[t] * inter;
        sts[t] = wts[t] * sv;
      }
    }
    __syncthreads();

    // d xbar = A^T dy + exp(L_Q - L_tau) u (in place of u), dc, db, and
    // dH_in = exp(L_Q) dH_out + (exp(L_t) dy)^T C (in place of dH)
    const float e_end = expf(ls[kQ - 1]);
    product(kQ, p_dim, kQ, 128,
            [&](int tau, int t) { return gs[t * kLdQ + tau]; },
            [&](int t, int p) { return dys[t * ldp + p]; },
            [&](int tau, int p, float acc) {
              us[tau * ldp + p] = fmaf(wts[tau], us[tau * ldp + p], acc);
            });
    product(kQ, n_dim, kQ, 0,
            [&](int t, int tau) { return dgs[t * kLdQ + tau]; },
            [&](int tau, int n) { return bs[tau * ldn + n]; },
            [&](int t, int n, float acc) {
              if (t < rows) {
                dcg[static_cast<long long>(t0 + t) * n_dim + n] =
                    fmaf(els[t], ms[t * ldn + n], acc);
              }
            });
    product(kQ, n_dim, kQ, 0,
            [&](int tau, int t) { return dgs[t * kLdQ + tau]; },
            [&](int t, int n) { return cs[t * ldn + n]; },
            [&](int tau, int n, float acc) {
              if (tau < rows) {
                dbg[static_cast<long long>(t0 + tau) * n_dim + n] =
                    fmaf(wts[tau], vs[tau * ldn + n], acc);
              }
            });
    product(p_dim, n_dim, kQ, 0,
            [&](int p, int t) { return dys[t * ldp + p] * els[t]; },
            [&](int t, int n) { return cs[t * ldn + n]; },
            [&](int p, int n, float acc) {
              hs[p * ldn + n] = fmaf(e_end, hs[p * ldn + n], acc);
            });
    __syncthreads();

    // warp 0: d la (lane = step): the inter-chunk terms of the steps at
    // and after it, the state's, those of the steps before it, and the
    // scores'; every warp: x . d xbar; dx
    if (warp == 0) {
      float in = ins[lane], st = sts[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float down = __shfl_down_sync(0xffffffffu, in, off);
        const float up = __shfl_up_sync(0xffffffffu, st, off);
        if (lane + off < 32) in += down;
        if (lane >= off) st += up;
      }
      const float st_before = __shfl_up_sync(0xffffffffu, st, 1);
      const float dla = in + e_end * inner + (lane > 0 ? st_before : 0.f) +
                        dls[lane];
      dlas[lane] = dla;
      da_acc = fmaf(dla, a * dts[lane], da_acc);
    }
    for (int t = warp; t < kQ; t += kWarps) {
      float xd = 0.f;
      for (int p = lane; p < p_dim; p += 32) {
        xd = fmaf(xs[t * ldp + p], us[t * ldp + p], xd);
      }
      xd = warp_sum(xd);
      if (lane == 0) xds[t] = xd;
    }
    for (int i = tid; i < rows * p_dim; i += kThreads) {
      const int t = i / p_dim, p = i - t * p_dim;
      put(dxg + (t0 + t) * step_hp + p,
          fmaf(dts[t], us[t * ldp + p], d_skip * dys[t * ldp + p]));
    }
    __syncthreads();
    if (tid < rows) {
      ddtg[static_cast<long long>(t0 + tid) * heads] =
          fmaf(a, dlas[tid], xds[tid]);
    }
  }

  if (args.dh0 != nullptr) {
    for (int i = tid; i < pn; i += kThreads) {
      const int p = i / n_dim, n = i - p * n_dim;
      args.dh0[bh * pn + i] = hs[p * ldn + n];
    }
  }
  const float dd = block_sum(dd_acc, red);
  const float da = block_sum(da_acc, red);
  if (tid == 0) {
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

template <typename T>
int launch_bwd(const BwdArgs& args, cudaStream_t s) {
  auto kernel = ssd_bwd_kernel<T>;
  const int smem = smem_floats(args.p_dim, args.n_dim) *
                   static_cast<int>(sizeof(float));
  // above 48 KB only once raised; set before every launch, since the
  // attribute is per device and the current device may change
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(args.heads),
                static_cast<unsigned>(args.batch)),
           kThreads, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
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
// da_part and dd_part (B, H) fp32; all written by this launch, the last
// four read by ssd_bwd_head_sum_launch and the caller.  Takes P a
// multiple of 8 up to 128, N in {16, 32, 64, 128}, B up to 65535, H >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_chunked_bwd_launch(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, const void* d_skip, const void* h0, const void* dy,
    const void* dh_final, void* states, void* dx, void* ddt, void* db_part,
    void* dc_part, void* dh0, void* da_part, void* dd_part, long long x_sb,
    long long x_ss, long long x_sh, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int batch, int seq, int heads,
    int p_dim, int n_dim, int dtype, void* stream) {
  if (p_dim % 8 != 0 || p_dim < 8 || p_dim > 128 || batch < 1 ||
      batch > 65535 || heads < 1 || seq < 0 ||
      (n_dim != 16 && n_dim != 32 && n_dim != 64 && n_dim != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(args, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(args, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
