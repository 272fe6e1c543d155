// Chunked Mamba2 SSD (state-space duality) scan for Hopper (sm_90a).
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
// last stride), dt (B, S, H) fp32, a_log and D (H,) fp32, optional h0
// (B, H, P, N) fp32.  y (B, S, H, P) contiguous in x's type; h_final
// (B, H, P, N) fp32.  All arithmetic is fp32.
//
// Bound: operations, in fp32 on CUDA cores (the model is fp32 and TF32
// would lose the reference's precision).  Every step costs 2 P N
// multiply-adds for the state update and 2 P N for c . h, against a few
// bytes of x, b and c, so the scan is far above the ridge point.
//
// Design.  The TPU kernel walks chunks as the innermost, sequential grid
// axis with the state in VMEM.  Here one block owns one (b, h) and loops
// over the chunks itself; the (P, N) fp32 state never leaves registers:
// the block has 4 P threads and thread (p, q4) keeps state row p at the
// columns n = 16 j + 4 q4 + u (u < 4, j < N / 16).  The kernel tiles S
// by its own Q = 32 (the last chunk may be short; its rows past S are
// zeros and add nothing), which the chunked algebra allows.  Per chunk:
//   A. stage b, c and x of the chunk in shared memory as fp32; warp 0
//      scans la into L with shuffles and writes exp(L_t), the decay to the
//      end exp(L_Q - L_tau) dt_tau (written as a difference of L, never
//      as exp(L_Q) / exp(L_tau), which overflows at strong decay) and
//      exp(L_Q);
//   B. the causal scores att[t][tau] = (c_t . b_tau) exp(L_t - L_tau)
//      dt_tau, 2 x 2 per thread with float4 loads.  The upper triangle
//      is never exponentiated: its gaps are positive and would overflow;
//   C. y: each thread sums c_t . h_in over its columns and, for its
//      quarter of tau, att[t][tau] x[tau][p]; two shuffles add the four
//      quarters; one lane adds D x and writes y;
//   D. the state update in registers.
// Shared memory rows are padded so that the loads of B, C and D are free
// of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 32;           // steps per chunk (the kernel's own tiling)
constexpr int kQPad = kQ + 1;    // att row stride
constexpr int kXPad = 8;         // x row padding: conflict-free in C

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* d_skip;
  const float* h0;     // may be null
  void* y;
  float* h_final;
  long long x_sb, x_ss, x_sh;   // x strides (elements), last stride 1
  long long b_sb, b_ss;         // b strides
  long long c_sb, c_ss;         // c strides
  int batch, seq, heads, p_dim, n_dim;
};

// Shared memory of one block, in floats: b and c (kQ, N + 4), x (kQ,
// P + kXPad), att (kQ, kQ + 1), then L, exp(L), the decay to the end and
// dt (kQ each) and exp(L_Q).
__host__ __device__ inline int smem_floats(int p_dim, int n_dim) {
  return 2 * kQ * (n_dim + 4) + kQ * (p_dim + kXPad) + kQ * kQPad + 4 * kQ +
         4;
}

// Global loads in flight per thread in phase A: four for fp32, which
// made the fp32 kernel faster on the card; one for bf16, which four made
// slower there.
template <typename T> struct Staging { static constexpr int kLoads = 4; };
template <> struct Staging<__nv_bfloat16> {
  static constexpr int kLoads = 1;
};

// kNJ = N / 16: the state columns of one thread are kNJ float4 groups.
template <typename T, int kNJ>
__global__ void __launch_bounds__(512)
ssd_chunked_kernel(const SsdArgs args) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLoads = Staging<T>::kLoads;
  const int n_dim = kNJ * 16;
  const int nb = n_dim + 4;                  // b, c row stride
  const int p_dim = args.p_dim;
  const int xp = p_dim + kXPad;              // x row stride
  float* b_s = smem;
  float* c_s = b_s + kQ * nb;
  float* x_s = c_s + kQ * nb;
  float* att_s = x_s + kQ * xp;
  float* l_s = att_s + kQ * kQPad;           // L_t
  float* el_s = l_s + kQ;                    // exp(L_t)
  float* w_s = el_s + kQ;                    // exp(L_Q - L_tau) dt_tau
  float* dt_s = w_s + kQ;                    // dt_tau
  float* decay_s = dt_s + kQ;                // exp(L_Q)

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;           // 4 P
  const int p = tid >> 2;
  const int q4 = tid & 3;
  const int lane = tid & 31;
  const int heads = args.heads;

  const T* x = static_cast<const T*>(args.x) + bi * args.x_sb + h * args.x_sh;
  const T* bg = static_cast<const T*>(args.b) + bi * args.b_sb;
  const T* cg = static_cast<const T*>(args.c) + bi * args.c_sb;
  const float* dtg = args.dt + static_cast<long long>(bi) * args.seq * heads + h;
  T* y = static_cast<T*>(args.y) +
         (static_cast<long long>(bi) * args.seq * heads + h) * p_dim;
  const float a = -expf(args.a_log[h]);
  const float d_skip = args.d_skip[h];

  // state row p, columns 16 j + 4 q4 + u
  float st[kNJ][4];
  const long long hoff =
      ((static_cast<long long>(bi) * heads + h) * p_dim + p) * n_dim;
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    if (args.h0 != nullptr) {
      const float4 v = *reinterpret_cast<const float4*>(
          args.h0 + hoff + 16 * j + 4 * q4);
      st[j][0] = v.x; st[j][1] = v.y; st[j][2] = v.z; st[j][3] = v.w;
    } else {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
    }
  }

  for (int t0 = 0; t0 < args.seq; t0 += kQ) {
    const int rows = min(kQ, args.seq - t0);

    // ---- A. stage the chunk (kLoads loads in flight per thread before
    // the first store); warp 0 scans the log decay
    for (int base = tid; base < kQ * n_dim; base += kLoads * nthreads) {
      float bv[kLoads], cv[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int idx = base + k * nthreads;
        const int t = idx / n_dim, n = idx - t * n_dim;
        const bool in = idx < kQ * n_dim && t < rows;
        bv[k] = in ? load_f32(bg + (t0 + t) * args.b_ss + n) : 0.f;
        cv[k] = in ? load_f32(cg + (t0 + t) * args.c_ss + n) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int idx = base + k * nthreads;
        if (idx < kQ * n_dim) {
          const int t = idx / n_dim, n = idx - t * n_dim;
          b_s[t * nb + n] = bv[k];
          c_s[t * nb + n] = cv[k];
        }
      }
    }
    for (int base = tid; base < kQ * p_dim; base += kLoads * nthreads) {
      float xv[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int idx = base + k * nthreads;
        const int t = idx / p_dim, pp = idx - t * p_dim;
        xv[k] = idx < kQ * p_dim && t < rows
                    ? load_f32(x + (t0 + t) * args.x_ss + pp) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int idx = base + k * nthreads;
        if (idx < kQ * p_dim) {
          const int t = idx / p_dim;
          x_s[t * xp + idx - t * p_dim] = xv[k];
        }
      }
    }
    if (tid < 32) {
      const float dtv =
          lane < rows ? dtg[static_cast<long long>(t0 + lane) * heads] : 0.f;
      float l = a * dtv;                     // rows past S: no decay, no input
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, l, off);
        if (lane >= off) l += up;
      }
      const float l_end = __shfl_sync(0xffffffffu, l, kQ - 1);
      el_s[lane] = expf(l);
      w_s[lane] = expf(l_end - l) * dtv;     // a difference: never overflows
      dt_s[lane] = dtv;
      l_s[lane] = l;
      if (lane == 0) decay_s[0] = expf(l_end);
    }
    __syncthreads();

    // ---- B. causal scores, a 2 x 2 tile per thread
    for (int tile = tid; tile < (kQ / 2) * (kQ / 2); tile += nthreads) {
      const int ti = tile / (kQ / 2), ui = tile - ti * (kQ / 2);
      const int t_a = 2 * ti, t_b = 2 * ti + 1;
      const int u_a = ui, u_b = ui + kQ / 2;
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
      if (u_a <= t_b) {                      // else the tile is all masked
        const float* ca = c_s + t_a * nb;
        const float* cb = c_s + t_b * nb;
        const float* ba = b_s + u_a * nb;
        const float* bb = b_s + u_b * nb;
        for (int n = 0; n < n_dim; n += 4) {
          const float4 c0 = *reinterpret_cast<const float4*>(ca + n);
          const float4 c1 = *reinterpret_cast<const float4*>(cb + n);
          const float4 b0 = *reinterpret_cast<const float4*>(ba + n);
          const float4 b1 = *reinterpret_cast<const float4*>(bb + n);
          s00 += c0.x * b0.x + c0.y * b0.y + c0.z * b0.z + c0.w * b0.w;
          s01 += c0.x * b1.x + c0.y * b1.y + c0.z * b1.z + c0.w * b1.w;
          s10 += c1.x * b0.x + c1.y * b0.y + c1.z * b0.z + c1.w * b0.w;
          s11 += c1.x * b1.x + c1.y * b1.y + c1.z * b1.z + c1.w * b1.w;
        }
      }
      const float l_ta = l_s[t_a], l_tb = l_s[t_b];
      const float l_ua = l_s[u_a], l_ub = l_s[u_b];
      // mask before exp: only tau <= t is ever exponentiated
      att_s[t_a * kQPad + u_a] =
          u_a <= t_a ? s00 * expf(l_ta - l_ua) * dt_s[u_a] : 0.f;
      att_s[t_a * kQPad + u_b] =
          u_b <= t_a ? s01 * expf(l_ta - l_ub) * dt_s[u_b] : 0.f;
      att_s[t_b * kQPad + u_a] =
          u_a <= t_b ? s10 * expf(l_tb - l_ua) * dt_s[u_a] : 0.f;
      att_s[t_b * kQPad + u_b] =
          u_b <= t_b ? s11 * expf(l_tb - l_ub) * dt_s[u_b] : 0.f;
    }
    __syncthreads();

    // ---- C. y over the chunk's rows
    for (int t = 0; t < rows; ++t) {
      const float* ct = c_s + t * nb + 4 * q4;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;   // four short chains
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float4 cv = *reinterpret_cast<const float4*>(ct + 16 * j);
        a0 = fmaf(cv.x, st[j][0], a0);
        a1 = fmaf(cv.y, st[j][1], a1);
        a2 = fmaf(cv.z, st[j][2], a2);
        a3 = fmaf(cv.w, st[j][3], a3);
      }
      float acc = ((a0 + a1) + (a2 + a3)) * el_s[t];
      const float* att_t = att_s + t * kQPad;
      for (int u = q4; u <= t; u += 4) acc += att_t[u] * x_s[u * xp + p];
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q4 == (t & 3)) {
        store_from_f32(y + static_cast<long long>(t0 + t) * heads * p_dim + p,
                       acc + d_skip * x_s[t * xp + p]);
      }
    }

    // ---- D. state update: h = exp(L_Q) h + sum_tau w_tau x_tau b_tau^T
    const float decay = decay_s[0];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      st[j][0] *= decay; st[j][1] *= decay; st[j][2] *= decay;
      st[j][3] *= decay;
    }
    for (int u = 0; u < rows; ++u) {
      const float xw = w_s[u] * x_s[u * xp + p];
      const float* bu = b_s + u * nb + 4 * q4;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(bu + 16 * j);
        st[j][0] += xw * bv.x; st[j][1] += xw * bv.y;
        st[j][2] += xw * bv.z; st[j][3] += xw * bv.w;
      }
    }
    __syncthreads();                         // before the next chunk's loads
  }

#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    *reinterpret_cast<float4*>(args.h_final + hoff + 16 * j + 4 * q4) =
        make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
  }
}

template <typename T, int kNJ>
int launch_nj(const SsdArgs& args, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(args.p_dim, kNJ * 16);
  // above 48 KB only once raised; set before every launch, since the
  // attribute is per device and the current device may change
  const cudaError_t raised = cudaFuncSetAttribute(
      ssd_chunked_kernel<T, kNJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const dim3 grid(static_cast<unsigned>(args.heads),
                  static_cast<unsigned>(args.batch));
  ssd_chunked_kernel<T, kNJ><<<grid, 4 * args.p_dim, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const SsdArgs& args, cudaStream_t s) {
  switch (args.n_dim) {
    case 16: return launch_nj<T, 1>(args, s);
    case 32: return launch_nj<T, 2>(args, s);
    case 64: return launch_nj<T, 4>(args, s);
    case 128: return launch_nj<T, 8>(args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y).  h0 may be null.
// Takes P a multiple of 8 up to 128 and N in {16, 32, 64, 128}.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_chunked_launch(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, const void* d_skip, const void* h0, void* y,
    void* h_final, long long x_sb, long long x_ss, long long x_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    int batch, int seq, int heads, int p_dim, int n_dim, int dtype,
    void* stream) {
  if (p_dim % 8 != 0 || p_dim < 8 || p_dim > 128 || batch > 65535) {
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
  args.y = y;
  args.h_final = static_cast<float*>(h_final);
  args.x_sb = x_sb; args.x_ss = x_ss; args.x_sh = x_sh;
  args.b_sb = b_sb; args.b_ss = b_ss;
  args.c_sb = c_sb; args.c_ss = c_ss;
  args.batch = batch; args.seq = seq; args.heads = heads;
  args.p_dim = p_dim; args.n_dim = n_dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(args, s);
  if (dtype == 1) return launch_t<__nv_bfloat16>(args, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
