// Single-token decode attention over a ring KV cache for Hopper (sm_90a).
// Two entry points share one kernel template, which differs only in where
// a key's validity comes from:
//
// flash_decode_launch replaces the Pallas TPU kernel
// src/repro/kernels/flash_decode.py (flash_decode): q (B, H, D) against
// caches (B, W, KV, D) with an explicit (B, W) validity mask -> out
// (B, H, D).
//
// pool_flash_decode_launch replaces src/repro/kernels/flash_decode.py
// (pool_flash_decode), the slot-pool decode: validity comes from a
// per-stream ring position pos[b] (int32) and an optional per-stream
// live byte, as kvpos <= pos[b] && kvpos < W && live[b].  Those keys are
// the prefix [0, nkeys) of the ring, nkeys = min(pos[b], W-1) + 1 (0 for
// a dead stream), so only that prefix is read, where the Pallas kernel
// reads and masks every tile.  A dead stream reads no cache and writes
// exact zeros.
//
// Block form (both entry points): with lse != nullptr the call writes,
// beside an fp32 output, each (stream, q-head) row's log-sum-exp of its
// valid scores (lse, (B, H) fp32; -inf for a row that sees no key), so
// that the partial results of the blocks of one ring can be merged
// outside the kernel.  A model-axis rank whose cache holds a block of the
// ring slots (kv_seq split over "model", where the axis does not divide
// the kv-heads) calls it on its block: the mask entry point with the
// block's mask, the pool one with slot0, the ring slot of the block's
// first slot, so that slot j of it is valid when slot0 + j <= pos[b]
// (nkeys = clamp(pos[b] - slot0 + 1, 0, W)).  lse == nullptr and
// slot0 = 0 are the whole-ring call, unchanged.
//
// In both, the rep = H / KV q-heads of a kv-head share one pass over its
// cache; int8 caches are dequantised in registers by kv_scale
// (device-memory traffic stays at the int8 byte count); logit softcap is
// supported.  A row that sees no key gives the guarded 0, never NaN
// (m_safe, denominator at least 1e-30), as the TPU kernels do.
//
// Bound: bytes.  Each cache byte feeds 2 * rep / sizeof(element) flops,
// far below the card's ridge point, so the tensor cores buy nothing; the
// least time is reading both caches' valid slots once.  The design is
// about keeping enough bytes in flight on every SM:
//
// - Vector async loads.  Each warp streams its own stages (2 KB of K and
//   2 KB of V) through a ring of two in shared memory with 16-byte
//   cp.async copies, so the next stage loads while one is scored.  A
//   stage is sized in bytes, not keys, so bf16 and int8 keep as many
//   bytes in flight as fp32.  A lane reads back exactly the 16-byte
//   chunks it copied, so the ring needs no barrier between the warp's
//   lanes.  32 KB of shared memory and at most 96 registers a thread
//   let five blocks share an SM: 660 blocks run in one wave.
// - A warp-load of 512 bytes is one fp32 D=128 key row, two bf16 rows or
//   four int8 rows: the lanes of one row reduce its dot product with
//   log2(lanes per row) shuffles, and each row group of lanes keeps its
//   own running max, sum and accumulator for the rep rows, merged once at
//   the end (row groups by shuffles, warps through shared memory, splits
//   in the combine) with the guarded rule above.
// - Split-KV (flash-decoding).  The grid is (kv-head, stream, split):
//   split s of a (stream, kv-head) takes the even share
//   [s * n / S, (s + 1) * n / S) of its n keys (n = W with a mask, nkeys
//   in the pool), so the work balances for every pos and a dead stream's
//   blocks exit at once.  The host picks S from the shapes and the SM
//   count only (kernels/flash_decode.py plan_splits), so a call needs no
//   host sync and can be captured in a CUDA graph.  With S > 1 each
//   block writes its fp32 (m, l, acc) to a workspace and a second kernel,
//   launched by the same entry point, merges the splits; with S = 1 the
//   block writes the output itself.  Splits pay only when the blocks are
//   too few to cover the SMs: with the loads above, one block streams its
//   keys fast enough that the second launch and the extra blocks cost
//   more than they balance once there are 1.5 blocks an SM.
// - Head dims 64, 128 and 256 make rows of 2^k bytes: a row divides a
//   warp-load or is a whole number of them.  D = 80 (h2o-danube,
//   hubert) makes rows of 320, 160 or 80 bytes, which straddle
//   warp-loads, so it keeps the same lane geometry at a padded width:
//   each row is laid out in shared memory and over the lanes as a row of
//   kDp = 128 elements (D rounded up to a power of two), 32 lanes a row
//   in fp32 (20 of them holding data), 16 in bf16 (10), 8 in int8 (5).
//   A lane whose chunk lies past D copies nothing (cp.async of source
//   size 0 fills its 16 bytes with zeros), holds q = 0 and adds 0 to the
//   dot product.  Device-memory traffic stays at the real row bytes;
//   shared memory and lanes are used at D / kDp = 62.5%.  With kDp = D
//   the checks against D fold away and the code is that of the other
//   head dims.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStageBytes = 2048;          // of K, and as much of V
constexpr int kDepth = 2;                  // stages in each warp's ring
constexpr int kLoads = kStageBytes / 512;  // 16-byte copies a lane makes
constexpr int kSmem = kWarps * kDepth * 2 * kStageBytes;
// Five blocks an SM (at most 96 registers a thread, 32 KB of shared
// memory each), so up to 660 blocks run in one wave on 132 SMs.
constexpr int kBlocksPerSm = 5;

constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// Where a lane's chunks fall, for caches of type C and head dim D: a row
// is laid out as kDp elements (the pitch in shared memory and over the
// lanes), of which the first D hold data.
template <typename C, int D>
struct Geo {
  static constexpr int kDp = pow2_at_least(D);
  static constexpr int kRowBytes = kDp * static_cast<int>(sizeof(C));
  static constexpr int kEpc = 16 / static_cast<int>(sizeof(C));  // per chunk
  // chunks of one key row a lane holds (2 for a 1 KB row), lanes per row
  static constexpr int kQch = kRowBytes > 512 ? kRowBytes / 512 : 1;
  static constexpr int kLpr = kRowBytes >= 512 ? 32 : kRowBytes / 16;
  static constexpr int kNu = kLoads / kQch;          // keys a lane scores
  static constexpr int kQel = kQch * kEpc;           // q elements a lane
  static constexpr int kStageKeys = kStageBytes / kRowBytes;
  // q-head rows per pass over the cache when rep > 2 (q and acc in regs)
  static constexpr int kRowsBig = 16 / kQel >= 2 ? 16 / kQel : 2;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// one 16-byte chunk of a cache row -> its elements as floats
__device__ __forceinline__ void unpack(const uint4& c, float (&x)[4]) {
  x[0] = __uint_as_float(c.x);
  x[1] = __uint_as_float(c.y);
  x[2] = __uint_as_float(c.z);
  x[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void unpack(const uint4& c, float (&x)[8]) {
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& c, float (&x)[16]) {
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (m, l) and factor pair of the guarded merge of two partial softmaxes:
// a side whose max is -inf (no key) contributes nothing.
__device__ __forceinline__ void merge_factors(float m_a, float m_b,
                                              float& m_new, float& f_a,
                                              float& f_b) {
  m_new = fmaxf(m_a, m_b);
  const float m_safe = m_new <= kNegInf ? 0.f : m_new;
  f_a = m_a <= kNegInf ? 0.f : expf(m_a - m_safe);
  f_b = m_b <= kNegInf ? 0.f : expf(m_b - m_safe);
}

// Where a key's validity comes from: a (B, W) uint8 mask with row stride
// mask_stride (0 broadcasts one row), or, with kPool, the stream's ring
// position pos[b] and live byte (live == nullptr: every stream is live),
// the cache holding the ring slots from slot0 on.
struct Validity {
  const uint8_t* mask;
  long long mask_stride;
  const int* pos;
  const uint8_t* live;
  int slot0;
};

// The output row of a (stream, head): in T, or with lse (the block form)
// in fp32 beside the row's log-sum-exp (-inf when it saw no key).
template <typename T>
__device__ __forceinline__ void store_row(void* out, float* lse,
                                          long long row, int dim, int d,
                                          float a_all, float l_all,
                                          float m_all) {
  const float o = a_all / fmaxf(l_all, 1e-30f);
  if (lse == nullptr) {
    store_from_f32(static_cast<T*>(out) + row * dim + d, o);
    return;
  }
  static_cast<float*>(out)[row * dim + d] = o;
  if (d == 0) {
    lse[row] = m_all <= kNegInf ? -__int_as_float(0x7f800000)  // -inf
                                : m_all + logf(l_all);
  }
}

// T: type of q and out; C: type of the caches (T, or int8 with kv_scale);
// R: q-head rows handled per pass over the cache; kPool: validity from
// (pos, live) instead of the mask.  Grid (KV, B, S).  ws == nullptr
// (S = 1): write out (and lse, when asked for); else write this split's
// (m, l, acc) to ws.
template <typename T, typename C, int D, int R, bool kPool>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
flash_decode_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                    const C* __restrict__ vc, Validity valid,
                    void* __restrict__ out, float* __restrict__ lse,
                    float* __restrict__ ws, int width, int heads,
                    int kv_heads, float softcap, float scale,
                    float kv_scale) {
  using G = Geo<C, D>;
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvh = blockIdx.x, split = blockIdx.z, splits = gridDim.z;
  const long long b = blockIdx.y;
  const int rep = heads / kv_heads;
  int nkeys = width;
  if (kPool) {
    const bool alive = valid.live == nullptr || valid.live[b] != 0;
    nkeys = alive ? min(max(valid.pos[b] - valid.slot0 + 1, 0), width) : 0;
  }
  const int lo = static_cast<int>(static_cast<long long>(split) * nkeys /
                                  splits);
  const int hi = static_cast<int>(static_cast<long long>(split + 1) * nkeys /
                                  splits);
  const int stages = (hi - lo + G::kStageKeys - 1) / G::kStageKeys;
  const uint8_t* mrow = kPool ? nullptr : valid.mask + b * valid.mask_stride;
  const long long key_stride = static_cast<long long>(kv_heads) * D;
  const C* kbase = kc + (b * width * kv_heads + kvh) * D;
  const C* vbase = vc + (b * width * kv_heads + kvh) * D;
  unsigned char* ring = smem + warp * (kDepth * 2 * kStageBytes);
  // workspace: acc (B*H, S, D), then (m, l) (B*H, S, 2)
  float* ws_acc = ws;
  float* ws_ml = ws == nullptr ? nullptr
      : ws + static_cast<long long>(gridDim.y) * heads * splits * D;

  // element of a (padded) row where this lane's chunk qc starts, and
  // whether it holds data (always, unless D is padded)
  auto elem = [&](int qc) {
    return ((qc * 512 + 16 * lane) % G::kRowBytes) /
           static_cast<int>(sizeof(C));
  };
  auto in_row = [&](int e0) { return G::kDp == D || e0 < D; };

  for (int h0 = 0; h0 < rep; h0 += R) {
    const int rows = min(R, rep - h0);
    const long long head0 = b * heads + kvh * rep + h0;
    // the warp's it-th stage is stage warp + kWarps * it of the block's
    auto issue = [&](int it) {
      const int t = warp + kWarps * it;
      if (t < stages) {
        unsigned char* st = ring + (it % kDepth) * (2 * kStageBytes);
        const int key0 = lo + t * G::kStageKeys;
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int o = 512 * i + 16 * lane;
          const int key = key0 + o / G::kRowBytes;
          const int e0 = (o % G::kRowBytes) / static_cast<int>(sizeof(C));
          const bool ok = key < hi && in_row(e0);
          const long long off = ok ? key * key_stride + e0 : 0;
          cp_async16(st + o, kbase + off, ok);
          cp_async16(st + kStageBytes + o, vbase + off, ok);
        }
      }
      cp_async_commit();                 // empty groups keep the count
    };
#pragma unroll
    for (int it = 0; it < kDepth; ++it) issue(it);  // before q's loads

    float qf[R][G::kQel], acc[R][G::kQel], m[R], l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int qc = 0; qc < G::kQch; ++qc) {
#pragma unroll
        for (int e = 0; e < G::kEpc; ++e) {
          float x = r < rows && in_row(elem(qc))
                        ? load_f32(q + (head0 + r) * D + elem(qc) + e) * scale
                        : 0.f;
          if (kInt8) x /= kv_scale;      // scores of the integer keys
          qf[r][qc * G::kEpc + e] = x;
          acc[r][qc * G::kEpc + e] = 0.f;
        }
      }
      m[r] = kNegInf;
      l[r] = 0.f;
    }

    for (int it = 0; warp + kWarps * it < stages; ++it) {
      const int key0 = lo + (warp + kWarps * it) * G::kStageKeys;
      bool ok[G::kNu];
#pragma unroll
      for (int u = 0; u < G::kNu; ++u) {
        const int key = key0 + (u * G::kQch * 512 + 16 * lane) / G::kRowBytes;
        ok[u] = key < hi && (kPool || mrow[key] != 0);
      }
      cp_async_wait<kDepth - 1>();       // this stage has landed
      const unsigned char* st = ring + (it % kDepth) * (2 * kStageBytes);
      float sc[G::kNu][R];
#pragma unroll
      for (int u = 0; u < G::kNu; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) sc[u][r] = 0.f;
#pragma unroll
        for (int qc = 0; qc < G::kQch; ++qc) {
          float x[G::kEpc];
          unpack(*reinterpret_cast<const uint4*>(
                     st + (u * G::kQch + qc) * 512 + 16 * lane), x);
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int e = 0; e < G::kEpc; ++e)
              sc[u][r] = fmaf(qf[r][qc * G::kEpc + e], x[e], sc[u][r]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < G::kNu; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = sc[u][r];
#pragma unroll
          for (int off = 1; off < G::kLpr; off <<= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          sc[u][r] = ok[u] ? s : kNegInf;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float cmax = kNegInf;
#pragma unroll
        for (int u = 0; u < G::kNu; ++u) cmax = fmaxf(cmax, sc[u][r]);
        const float m_new = fmaxf(m[r], cmax);
        const float m_safe = m_new <= kNegInf ? 0.f : m_new;
        const float alpha = m[r] <= kNegInf ? 0.f : expf(m[r] - m_safe);
        float p_sum = 0.f;
#pragma unroll
        for (int u = 0; u < G::kNu; ++u) {
          const float p = ok[u] ? expf(sc[u][r] - m_safe) : 0.f;
          sc[u][r] = p;
          p_sum += p;
        }
        l[r] = l[r] * alpha + p_sum;
#pragma unroll
        for (int j = 0; j < G::kQel; ++j) acc[r][j] *= alpha;
        m[r] = m_new;
      }
#pragma unroll
      for (int u = 0; u < G::kNu; ++u) {
#pragma unroll
        for (int qc = 0; qc < G::kQch; ++qc) {
          float y[G::kEpc];
          unpack(*reinterpret_cast<const uint4*>(
                     st + kStageBytes + (u * G::kQch + qc) * 512 + 16 * lane),
                 y);
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int e = 0; e < G::kEpc; ++e)
              acc[r][qc * G::kEpc + e] =
                  fmaf(sc[u][r], y[e], acc[r][qc * G::kEpc + e]);
          }
        }
      }
      __syncwarp();                      // reads of this slot are done
      issue(it + kDepth);
    }
    cp_async_wait<0>();

    // row groups of the warp: lanes l and l ^ off hold the same elements
#pragma unroll
    for (int off = G::kLpr; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[r], off);
        float m_new, f, f_o;
        merge_factors(m[r], m_o, m_new, f, f_o);
        l[r] = l[r] * f + l_o * f_o;
#pragma unroll
        for (int j = 0; j < G::kQel; ++j) {
          const float a_o = __shfl_xor_sync(0xffffffffu, acc[r][j], off);
          acc[r][j] = acc[r][j] * f + a_o * f_o;
        }
        m[r] = m_new;
      }
    }

    // warps, through the (now idle) ring
    __syncthreads();
    float* sm_m = reinterpret_cast<float*>(smem);
    float* sm_l = sm_m + kWarps * R;
    float* sm_acc = sm_l + kWarps * R;   // (kWarps, R, D)
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sm_m[warp * R + r] = m[r];
        sm_l[warp * R + r] = l[r];
      }
    }
    if (lane < G::kLpr) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int qc = 0; qc < G::kQch; ++qc) {
          if (!in_row(elem(qc))) continue;
#pragma unroll
          for (int e = 0; e < G::kEpc; ++e)
            sm_acc[(warp * R + r) * D + elem(qc) + e] =
                acc[r][qc * G::kEpc + e];
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      float m_all = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w * R + r]);
      const float m_safe = m_all <= kNegInf ? 0.f : m_all;
      float l_all = 0.f, a_all = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = sm_m[w * R + r];
        if (mw > kNegInf) {
          const float f = expf(mw - m_safe);
          l_all += sm_l[w * R + r] * f;
          a_all += sm_acc[(w * R + r) * D + d] * f;
        }
      }
      if (kInt8) a_all /= kv_scale;      // values of the integer caches
      if (ws == nullptr) {
        store_row<T>(out, lse, head0 + r, D, d, a_all, l_all, m_all);
      } else {
        const long long slot = (head0 + r) * splits + split;
        ws_acc[slot * D + d] = a_all;    // exact 0 for a split with no key
        if (d == 0) {
          ws_ml[2 * slot] = m_all;
          ws_ml[2 * slot + 1] = l_all;
        }
      }
    }
    __syncthreads();                     // shared state is reused next pass
  }
}

// Merge the S splits of every (stream, head) row: grid (H, B), D threads.
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ ws,
                                            void* __restrict__ out,
                                            float* __restrict__ lse,
                                            int heads, int splits, int dim) {
  const long long row = static_cast<long long>(blockIdx.y) * heads +
                        blockIdx.x;
  const float* acc = ws + row * splits * dim;
  const float* ml = ws + static_cast<long long>(gridDim.y) * heads * splits *
                             dim + row * splits * 2;
  float m_all = kNegInf;
  for (int s = 0; s < splits; ++s) m_all = fmaxf(m_all, ml[2 * s]);
  const float m_safe = m_all <= kNegInf ? 0.f : m_all;
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    float l_all = 0.f, a_all = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ms = ml[2 * s];
      if (ms > kNegInf) {                // a split with no key adds nothing
        const float f = expf(ms - m_safe);
        l_all += ml[2 * s + 1] * f;
        a_all += acc[s * dim + d] * f;
      }
    }
    store_row<T>(out, lse, row, dim, d, a_all, l_all, m_all);
  }
}

template <typename T, typename C, int D, int R, bool kPool>
cudaError_t launch_kernel(const void* q, const void* k, const void* v,
                          Validity valid, void* out, float* lse, float* ws,
                          int batch, int width, int heads, int kv_heads,
                          int splits, float softcap, float scale,
                          float kv_scale, cudaStream_t s) {
  auto kernel = flash_decode_kernel<T, C, D, R, kPool>;
  // set before every launch: the attribute is per device, and the current
  // device may change
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(kv_heads, batch, splits);
  kernel<<<grid, kThreads, kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), valid, out, lse, ws, width, heads, kv_heads,
      softcap, scale, kv_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return err;
  flash_decode_combine_kernel<T><<<dim3(heads, batch), D, 0, s>>>(
      ws, out, lse, heads, splits, D);
  return cudaGetLastError();
}

template <typename T, typename C, int D, bool kPool>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        Validity valid, void* out, float* lse, float* ws,
                        int batch, int width, int heads, int kv_heads,
                        int splits, float softcap, float scale,
                        float kv_scale, cudaStream_t s) {
  constexpr int kBig = Geo<C, D>::kRowsBig;
  if (heads / kv_heads <= 2 || kBig == 2) {
    return launch_kernel<T, C, D, 2, kPool>(q, k, v, valid, out, lse, ws,
                                            batch, width, heads, kv_heads,
                                            splits, softcap, scale, kv_scale,
                                            s);
  }
  return launch_kernel<T, C, D, kBig, kPool>(q, k, v, valid, out, lse, ws,
                                             batch, width, heads, kv_heads,
                                             splits, softcap, scale,
                                             kv_scale, s);
}

template <typename T, typename C, bool kPool>
cudaError_t launch_dims(const void* q, const void* k, const void* v,
                        Validity valid, void* out, float* lse, float* ws,
                        int batch, int width, int heads, int kv_heads,
                        int head_dim, int splits, float softcap, float scale,
                        float kv_scale, cudaStream_t s) {
  switch (head_dim) {
    case 64:
      return launch_rows<T, C, 64, kPool>(q, k, v, valid, out, lse, ws,
                                          batch, width, heads, kv_heads,
                                          splits, softcap, scale, kv_scale,
                                          s);
    case 80:
      return launch_rows<T, C, 80, kPool>(q, k, v, valid, out, lse, ws,
                                          batch, width, heads, kv_heads,
                                          splits, softcap, scale, kv_scale,
                                          s);
    case 128:
      return launch_rows<T, C, 128, kPool>(q, k, v, valid, out, lse, ws,
                                           batch, width, heads, kv_heads,
                                           splits, softcap, scale, kv_scale,
                                           s);
    case 256:
      return launch_rows<T, C, 256, kPool>(q, k, v, valid, out, lse, ws,
                                           batch, width, heads, kv_heads,
                                           splits, softcap, scale, kv_scale,
                                           s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kPool>
cudaError_t launch_types(const void* q, const void* k, const void* v,
                         Validity valid, void* out, float* lse, int batch,
                         int width, int heads, int kv_heads, int head_dim,
                         float softcap, float scale, float kv_scale,
                         int dtype, int cache_dtype, int splits,
                         void* workspace, cudaStream_t s) {
  if (splits < 1 || (splits > 1) != (workspace != nullptr)) {
    return cudaErrorInvalidValue;
  }
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0 && cache_dtype == 0) {
    return launch_dims<float, float, kPool>(q, k, v, valid, out, lse, ws,
                                            batch, width, heads, kv_heads,
                                            head_dim, splits, softcap, scale,
                                            kv_scale, s);
  }
  if (dtype == 1 && cache_dtype == 1) {
    return launch_dims<__nv_bfloat16, __nv_bfloat16, kPool>(
        q, k, v, valid, out, lse, ws, batch, width, heads, kv_heads,
        head_dim, splits, softcap, scale, kv_scale, s);
  }
  if (dtype == 0 && cache_dtype == 2) {
    return launch_dims<float, int8_t, kPool>(q, k, v, valid, out, lse, ws,
                                             batch, width, heads, kv_heads,
                                             head_dim, splits, softcap, scale,
                                             kv_scale, s);
  }
  if (dtype == 1 && cache_dtype == 2) {
    return launch_dims<__nv_bfloat16, int8_t, kPool>(
        q, k, v, valid, out, lse, ws, batch, width, heads, kv_heads,
        head_dim, splits, softcap, scale, kv_scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  cache_dtype: the same
// code as dtype, or 2 = int8 dequantised by kv_scale.  splits: S >= 1
// key splits per (stream, kv-head); with S > 1, workspace is fp32 scratch
// of B * H * S * (D + 2) floats (any contents), else null.  lse: null, or
// the block form's (B, H) fp32 log-sum-exps, and then out is fp32 whatever
// dtype says.  Both entry points return cudaGetLastError() after their
// launches (0 on success).

// mask is uint8 (B, W) with row stride mask_stride (0 broadcasts one row).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   long long mask_stride, void* out,
                                   int batch, int width, int heads,
                                   int kv_heads, int head_dim, float softcap,
                                   float scale, float kv_scale, int dtype,
                                   int cache_dtype, int splits,
                                   void* workspace, void* lse, void* stream) {
  const Validity valid{static_cast<const uint8_t*>(mask), mask_stride,
                       nullptr, nullptr, 0};
  return static_cast<int>(launch_types<false>(
      q, k, v, valid, out, static_cast<float*>(lse), batch, width, heads,
      kv_heads, head_dim, softcap, scale, kv_scale, dtype, cache_dtype,
      splits, workspace, static_cast<cudaStream_t>(stream)));
}

// pos is int32 (B,), the ring position of each stream's newest key; live
// is uint8 (B,) or null (every stream live); slot0 is the ring slot of the
// cache's first slot (0 for a whole ring).
extern "C" int pool_flash_decode_launch(const void* q, const void* k,
                                        const void* v, const void* pos,
                                        const void* live, int slot0,
                                        void* out, int batch, int width,
                                        int heads, int kv_heads,
                                        int head_dim, float softcap,
                                        float scale, float kv_scale,
                                        int dtype, int cache_dtype,
                                        int splits, void* workspace,
                                        void* lse, void* stream) {
  const Validity valid{nullptr, 0, static_cast<const int*>(pos),
                       static_cast<const uint8_t*>(live), slot0};
  return static_cast<int>(launch_types<true>(
      q, k, v, valid, out, static_cast<float*>(lse), batch, width, heads,
      kv_heads, head_dim, softcap, scale, kv_scale, dtype, cache_dtype,
      splits, workspace, static_cast<cudaStream_t>(stream)));
}
