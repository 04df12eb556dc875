// Training attention for Hopper (sm_90a): the forward with its base-2
// log-sum-exp (B14) and the backward (B18).
//
// Replaces tpp_mlir_tpu/xsmm/flash_train.py:146 build_flash_train_fwd and
// :190 build_flash_train_bwd. Operands are read and written on the
// (B, S, H, D) layout through its strides (row stride H*D), so the training
// forward needs no transposes; lse2 and delta are (B, H, S) f32.
//   forward:  s2 = (Q K^T) * scale*log2(e) [causal], O = (P' V) / l with
//             P = exp2(s2 - m2), l = rowsum(P); lse2 = m2 + log2(l)
//   backward: P = exp2(s2 - lse2), dV = P'^T dO, dP = dO V^T,
//             dS = (P (dP - delta) scale)', dQ = dS K, dK = dS^T Q
// where ' rounds to bf16 for bf16 operands (the TPU kernels' `_pv_dtype`)
// and every product sums in f32. Outputs are in the operand dtype.
//
// Each kernel takes one of two routes, which xsmm/reference.py
// flash_train_fwd_route and flash_train_bwd_route choose from the key:
//   "wgmma" (bf16 operands): B14 runs attention.cu's wgmma kernel in its
//   training mode (tpp_attention_train_fwd); B18 runs the two wgmma
//   kernels below;
//   "fma" (f32 operands, which the TPU runs in true f32): the f32-FMA
//   kernels below, no tensor cores.
// The TPU kernels hold whole (S, S) slabs of one head in VMEM; a Hopper
// block has at most 227 KB of shared memory, so no (S, S) array exists
// anywhere here. B18 keeps two passes, both deterministic (no atomics, so
// two runs give bit-equal gradients): pass 1 owns a K/V tile and loops over
// the Q tiles at or below the diagonal, recomputing P from lse2, for dK and
// dV; pass 2 owns a Q tile and loops over the K/V tiles for dQ, repeating
// two of pass 1's products so that dQ needs no cross-block reduction.
//
// What bounds B18 on the H100: at the GPT-2 training key (B 8, S 512, H 12,
// D 64, causal, bf16) its seven 64x64xD products a tile pair are 11 GFLOP
// of tensor-core work (0.011 ms at 989 TFLOP/s) over 44 MB (0.013 ms at
// 3.35 TB/s): both floors are near, so the tensor cores must be fed from
// shared memory that copies fill in the background, with nothing else on
// their path. The "wgmma" design:
//   - pass 1: one block per (64 NCW K/V rows, head, batch row), NCW
//     consumer warpgroups of 64 K/V rows and one producer warp. K and V are
//     resident in swizzled shared memory (TMA, 3D maps over (H*D, S, B)).
//     A 3-stage ring brings each Q tile and dO tile (64 query rows) by TMA,
//     with the tile's lse2 and delta rows by 1D TMA over the flat (B*H*S)
//     statistics. For each Q tile at or below its diagonal a warpgroup
//     computes S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both
//     operands K-major from shared memory), forms P^T and dS^T in
//     registers (lse2 and delta read by column from the staged rows), and
//     accumulates dV += P'^T dO and dK += dS'^T Q on wgmma with the rounded
//     P^T / dS^T accumulators as register A fragments and dO / Q read
//     MN-major from the same tiles (trans-b). dK and dV stay in registers
//     and are stored once, masked past S.
//   - pass 2: one block per (128 query rows, head, batch row), two consumer
//     warpgroups and a producer warp; Q and dO resident, a 3-stage K/V
//     ring: S = Q K^T and dP = dO V^T (SS), P and dS in registers (each
//     thread's two rows' lse2 and delta read once), dQ += dS' K with K
//     MN-major (RS). attention.cu's forward loop with one more product.
//   - causal keys load no tile wholly above the block's diagonal, a
//     warpgroup skips (but still releases) the tiles above its own, and the
//     longest blocks are issued first. TMA's zero fill covers rows past S;
//     the statistics past S, the causal triangle and rows or columns past S
//     are masked in registers.
//   - registers: at D 128, dK and dV take 128 f32 a thread on top of S^T,
//     dP^T and the fragments, so pass 1 runs one consumer warpgroup a block
//     there (255 registers a thread at 160 threads) and two at D 32/64
//     (a producer warp, not a warpgroup: 224 registers at 288 threads).
// The "fma" route: one block of 4 warps per 64-row tile (B14: a Q tile
// with an online softmax; B18: the same two passes), tiles staged through
// shared memory with scalar loads, f32 FMA, accumulators in shared memory.
// D 32, 64, 128.
#include <math.h>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace {

namespace hw = tpp::hopper;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // backward only
  void* o;            // forward: O; backward: dQ
  void* dk;
  void* dv;
  float* lse;         // (B, H, S) base-2 log-sum-exp
  const float* delta;  // (B, H, S) rowsum(dO * O), backward only
  int seq, heads, ld, causal;
  float qscale;        // scale * log2(e)
  float scale;
};

// ====================================== "fma": f32 operands, f32 FMA

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;

// Row stride of the shared f32 tiles: N + 1, so that neighbouring threads
// reading along a row of the other operand hit distinct banks.
template <int N>
constexpr int ld_of() { return N + 1; }

constexpr size_t up(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C (ACC ? += : =) op(A) op(B) for an M x N tile of C with inner size K
// over shared memory, one element of C per thread in turn:
//   op(A)(m, k) = TA ? A[k * lda + m] : A[m * lda + k]
//   op(B)(k, n) = TB ? B[n * ldb + k] : B[k * ldb + n]
// The caller synchronizes before and after.
template <bool TA, bool TB, bool ACC>
__device__ __forceinline__ void block_gemm(float* C, int ldc, const float* A,
                                           int lda, const float* B, int ldb,
                                           int M, int N, int K) {
  for (int i = threadIdx.x; i < M * N; i += THREADS) {
    const int m = i / N, n = i % N;
    float s = ACC ? C[m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k)
      s = fmaf(TA ? A[k * lda + m] : A[m * lda + k],
               TB ? B[n * ldb + k] : B[k * ldb + n], s);
    C[m * ldc + n] = s;
  }
}

// dst[r][c] = src[(row0 + r) * ld + c] for the 64 rows of a tile, zero for
// rows at or past `rows`.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ldd,
                                          const float* src, int ld, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * ldd + c] = row0 + r < rows ? src[(size_t)(row0 + r) * ld + c]
                                       : 0.f;
  }
}

// f32 tile -> rows of the (B, S, H, D) output, divided per row.
template <int D>
__device__ __forceinline__ void store_tile(float* dst, int ld,
                                           const float* src, int lds,
                                           int row0, int rows,
                                           const float* row_div) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    if (row0 + r >= rows) continue;
    float x = src[r * lds + c];
    if (row_div) x /= row_div[r];
    dst[(size_t)(row0 + r) * ld + c] = x;
  }
}

// ---------------------------------------------------------------- forward

template <int D>
struct FwdPlan {
  static constexpr int QLD = ld_of<D>();      // Q, K, V tiles
  static constexpr int SLD = ld_of<BKV>();    // scores, then P
  static constexpr int OLD = ld_of<D>();      // output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = up(q_off + BQ * QLD * sizeof(float));
  static constexpr size_t v_off = up(k_off + BKV * QLD * sizeof(float));
  static constexpr size_t s_off = up(v_off + BKV * QLD * sizeof(float));
  static constexpr size_t o_off = up(s_off + BQ * SLD * sizeof(float));
  static constexpr size_t r_off = up(o_off + BQ * OLD * sizeof(float));
  static constexpr size_t bytes = up(r_off + 2 * BQ * sizeof(float));
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Args a) {
  using L = FwdPlan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* Ms = reinterpret_cast<float*>(smem + L::r_off);  // running max
  float* Ls = Ms + BQ;                                     // running sum

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * a.seq * a.ld + (size_t)h * D;
  const float* K = static_cast<const float*>(a.k) + base;
  const float* V = static_cast<const float*>(a.v) + base;

  load_tile<D>(Qs, L::QLD, static_cast<const float*>(a.q) + base, a.ld, q0,
               a.seq);
  for (int i = tid; i < BQ * D; i += THREADS) Os[i / D * L::OLD + i % D] = 0.f;
  if (tid < BQ) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  const int kv_end = a.causal ? min(a.seq, q0 + BQ) : a.seq;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D>(Ks, L::QLD, K, a.ld, kv0, a.seq);
    load_tile<D>(Vs, L::QLD, V, a.ld, kv0, a.seq);
    __syncthreads();
    block_gemm<false, true, false>(Ss, L::SLD, Qs, L::QLD, Ks, L::QLD, BQ,
                                   BKV, D);
    __syncthreads();

    // online softmax in the exp2 domain: warp w owns rows 16w..16w+15, a
    // lane the columns lane and lane + 32; P replaces S in place
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr, qi = q0 + r;
      float s[2], mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int kj = kv0 + lane + 32 * t;
        float x = Ss[r * L::SLD + lane + 32 * t] * a.qscale;
        if (kj >= a.seq || (a.causal && kj > qi)) x = -INFINITY;
        s[t] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p = m_new == -INFINITY ? 0.f : exp2f(s[t] - m_new);
        sum += p;
        Ss[r * L::SLD + lane + 32 * t] = p;
      }
      sum = warp_sum(sum);
      const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
      for (int c = lane; c < D; c += 32) Os[r * L::OLD + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        Ls[r] = Ls[r] * alpha + sum;
        Ms[r] = m_new;
      }
    }
    __syncthreads();
    block_gemm<false, false, true>(Os, L::OLD, Ss, L::SLD, Vs, L::QLD, BQ, D,
                                   BKV);
  }
  __syncthreads();

  store_tile<D>(static_cast<float*>(a.o) + base, a.ld, Os, L::OLD, q0, a.seq,
                Ls);
  if (tid < BQ && q0 + tid < a.seq)
    a.lse[((size_t)b * a.heads + h) * a.seq + q0 + tid] =
        Ms[tid] + log2f(Ls[tid]);
}

// --------------------------------------------------------------- backward

// One plan for both passes. P, then dS, replaces S in place (rounding is
// the identity in f32), which keeps the D 128 key within the 232,448 bytes
// a block may opt into.
template <int D>
struct BwdPlan {
  static constexpr int QLD = ld_of<D>();      // Q, dO, K, V tiles
  static constexpr int SLD = ld_of<BKV>();    // S / P, dP / dS
  static constexpr int ALD = ld_of<D>();      // accumulators
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = up(q_off + BQ * QLD * sizeof(float));
  static constexpr size_t k_off = up(do_off + BQ * QLD * sizeof(float));
  static constexpr size_t v_off = up(k_off + BKV * QLD * sizeof(float));
  static constexpr size_t s_off = up(v_off + BKV * QLD * sizeof(float));
  static constexpr size_t dp_off = up(s_off + BQ * SLD * sizeof(float));
  static constexpr size_t a0_off = up(dp_off + BQ * SLD * sizeof(float));
  static constexpr size_t a1_off = up(a0_off + 64 * ALD * sizeof(float));
  static constexpr size_t r_off = up(a1_off + 64 * ALD * sizeof(float));
  static constexpr size_t bytes = up(r_off + 2 * BQ * sizeof(float));
};

// S = Q K^T and dP = dO V^T for one (Q tile, K/V tile) pair, then from
// them, element by element: Ss = P = exp2(S scale log2(e) - lse2) (0 where
// masked) and dPs = dS = P (dP - delta) scale.
template <int D>
__device__ __forceinline__ void bwd_tile_pd(const Args& a, int q0, int kv0,
                                            const float* Qs,
                                            const float* dOs,
                                            const float* Ks,
                                            const float* Vs, float* Ss,
                                            float* dPs, const float* Lse,
                                            const float* Dlt) {
  using L = BwdPlan<D>;
  block_gemm<false, true, false>(Ss, L::SLD, Qs, L::QLD, Ks, L::QLD, BQ, BKV,
                                 D);
  block_gemm<false, true, false>(dPs, L::SLD, dOs, L::QLD, Vs, L::QLD, BQ,
                                 BKV, D);
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * BKV; i += THREADS) {
    const int r = i / BKV, c = i % BKV, qi = q0 + r, kj = kv0 + c;
    const bool live = qi < a.seq && kj < a.seq && !(a.causal && kj > qi);
    const float p = live ? exp2f(Ss[r * L::SLD + c] * a.qscale - Lse[r])
                         : 0.f;
    Ss[r * L::SLD + c] = p;
    dPs[r * L::SLD + c] = p * (dPs[r * L::SLD + c] - Dlt[r]) * a.scale;
  }
}

__device__ __forceinline__ void load_stats(const Args& a, size_t row_base,
                                           int q0, float* Lse, float* Dlt) {
  const int tid = threadIdx.x;
  if (tid < BQ) {
    const bool in = q0 + tid < a.seq;
    Lse[tid] = in ? a.lse[row_base + q0 + tid] : 0.f;
    Dlt[tid] = in ? a.delta[row_base + q0 + tid] : 0.f;
  }
}

// pass 1: dK and dV of one K/V tile
template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_kv_kernel(Args a) {
  using L = BwdPlan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* dOs = reinterpret_cast<float*>(smem + L::do_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  float* dKs = reinterpret_cast<float*>(smem + L::a0_off);
  float* dVs = reinterpret_cast<float*>(smem + L::a1_off);
  float* Lse = reinterpret_cast<float*>(smem + L::r_off);
  float* Dlt = Lse + BQ;

  const int tid = threadIdx.x;
  const int kv0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * a.seq * a.ld + (size_t)h * D;
  const size_t row_base = ((size_t)b * a.heads + h) * a.seq;
  const float* Q = static_cast<const float*>(a.q) + base;
  const float* dO = static_cast<const float*>(a.dout) + base;

  load_tile<D>(Ks, L::QLD, static_cast<const float*>(a.k) + base, a.ld, kv0,
               a.seq);
  load_tile<D>(Vs, L::QLD, static_cast<const float*>(a.v) + base, a.ld, kv0,
               a.seq);
  for (int i = tid; i < BKV * D; i += THREADS) {
    dKs[i / D * L::ALD + i % D] = 0.f;
    dVs[i / D * L::ALD + i % D] = 0.f;
  }

  // causal: the Q tiles at or below the diagonal (the tiles line up, BQ ==
  // BKV)
  for (int q0 = a.causal ? kv0 : 0; q0 < a.seq; q0 += BQ) {
    __syncthreads();  // the previous Q tile's Q, dO and P / dS no longer read
    load_tile<D>(Qs, L::QLD, Q, a.ld, q0, a.seq);
    load_tile<D>(dOs, L::QLD, dO, a.ld, q0, a.seq);
    load_stats(a, row_base, q0, Lse, Dlt);
    __syncthreads();
    bwd_tile_pd<D>(a, q0, kv0, Qs, dOs, Ks, Vs, Ss, dPs, Lse, Dlt);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q
    block_gemm<true, false, true>(dVs, L::ALD, Ss, L::SLD, dOs, L::QLD, BKV,
                                  D, BQ);
    block_gemm<true, false, true>(dKs, L::ALD, dPs, L::SLD, Qs, L::QLD, BKV,
                                  D, BQ);
  }
  __syncthreads();
  store_tile<D>(static_cast<float*>(a.dk) + base, a.ld, dKs, L::ALD, kv0,
                a.seq, nullptr);
  store_tile<D>(static_cast<float*>(a.dv) + base, a.ld, dVs, L::ALD, kv0,
                a.seq, nullptr);
}

// pass 2: dQ of one Q tile
template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_q_kernel(Args a) {
  using L = BwdPlan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* dOs = reinterpret_cast<float*>(smem + L::do_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  float* dQs = reinterpret_cast<float*>(smem + L::a0_off);
  float* Lse = reinterpret_cast<float*>(smem + L::r_off);
  float* Dlt = Lse + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * a.seq * a.ld + (size_t)h * D;
  const size_t row_base = ((size_t)b * a.heads + h) * a.seq;
  const float* K = static_cast<const float*>(a.k) + base;
  const float* V = static_cast<const float*>(a.v) + base;

  load_tile<D>(Qs, L::QLD, static_cast<const float*>(a.q) + base, a.ld, q0,
               a.seq);
  load_tile<D>(dOs, L::QLD, static_cast<const float*>(a.dout) + base, a.ld,
               q0, a.seq);
  load_stats(a, row_base, q0, Lse, Dlt);
  for (int i = tid; i < BQ * D; i += THREADS)
    dQs[i / D * L::ALD + i % D] = 0.f;

  const int kv_end = a.causal ? min(a.seq, q0 + BQ) : a.seq;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's K and dS are no longer read
    load_tile<D>(Ks, L::QLD, K, a.ld, kv0, a.seq);
    load_tile<D>(Vs, L::QLD, V, a.ld, kv0, a.seq);
    __syncthreads();
    bwd_tile_pd<D>(a, q0, kv0, Qs, dOs, Ks, Vs, Ss, dPs, Lse, Dlt);
    __syncthreads();
    // dQ += dS K
    block_gemm<false, false, true>(dQs, L::ALD, dPs, L::SLD, Ks, L::QLD, BQ,
                                   D, BKV);
  }
  __syncthreads();
  store_tile<D>(static_cast<float*>(a.o) + base, a.ld, dQs, L::ALD, q0, a.seq,
                nullptr);
}

template <typename Kernel>
int launch_fma(Kernel kernel, size_t bytes, const Args& a, int batch,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + 63) / 64, a.heads, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_fma(bool backward, const Args& a, int batch, cudaStream_t st) {
  if (!backward)
    return launch_fma(flash_fwd_kernel<D>, FwdPlan<D>::bytes, a, batch, st);
  const size_t bytes = BwdPlan<D>::bytes;
  const int rc = launch_fma(flash_bwd_kv_kernel<D>, bytes, a, batch, st);
  if (rc) return rc;
  return launch_fma(flash_bwd_q_kernel<D>, bytes, a, batch, st);
}

// ===================================== "wgmma": B18, bf16 operands

constexpr int WG = 128;       // threads of a warpgroup
constexpr int TR = 64;        // rows of a streamed tile
constexpr int STAGES = 3;     // ring depth
static_assert(TR == 64, "hopper.cuh's ss_abt / rs_ab: 64-row B tiles");

// A bf16 tile of rows x D is kept as D / CW chunks [rows][SW bytes], each
// swizzled as TMA writes it (hopper.cuh's layout, as attention.cu's).
template <int D>
struct WTile : hw::Chunks<D> {
  static constexpr int BYTES = TR * D * 2;        // a 64-row tile
};

// consumer warpgroups of pass 1: one at D 128 (registers), else two
template <int D>
constexpr int kv_wgs() { return D == 128 ? 1 : 2; }

// keeps register A fragments live until the products reading them are done
__device__ __forceinline__ void fence_frags(uint32_t (&p)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(p[i][j])::"memory");
}

// acc (rows `row` and row + 8, columns col0 + 8 (i / 4) + 2 (lane % 4)),
// rounded to bf16 once, rows at or past seq dropped
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           void* out, size_t row_base,
                                           int row, int seq, int ld,
                                           int col0) {
  const int cq = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = row + 8 * ((i / 2) & 1);
    if (r >= seq) continue;
    const size_t at = (row_base + r) * ld + col0 + 8 * (i / 4) + cq;
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       at) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

template <int D, int NCW>
struct Pass1 {
  using T = WTile<D>;
  static constexpr int R = 64 * NCW;                 // K/V rows a block
  static constexpr int KV = R * D * 2;               // bytes of K (or V)
  static constexpr int STAT = 2 * T::BYTES;          // lse2, then delta
  static constexpr int STAGE = STAT + 1024;          // Q, dO, statistics
  static constexpr int ring_off = 2 * KV;
  static constexpr int bar_off = ring_off + STAGES * STAGE;
  static constexpr int bytes = bar_off + (1 + 2 * STAGES) * 8;
};

// pass 1: dK and dV of 64 NCW K/V rows
template <int D, int NCW>
__global__ void __launch_bounds__(WG * NCW + 32, 1)
bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap lmap,
                    const __grid_constant__ CUtensorMap dmap, Args a) {
  using T = WTile<D>;
  using L = Pass1<D, NCW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024)
                                    % 1024);
  unsigned char* ks = smem;
  unsigned char* vs = smem + L::KV;
  unsigned char* ring = smem + L::ring_off;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid / WG;
  const int h = blockIdx.x, b = blockIdx.y, kv0 = blockIdx.z * L::R;
  const int col0 = h * D;
  const int q_begin = a.causal ? kv0 : 0;   // the Q tiles line up with kv0
  const int tiles = (a.seq - q_begin + TR - 1) / TR;

  if (tid == 0) {
    hw::mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], NCW * WG);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NCW) {  // ---- producer warp: one thread issues every copy ----
    if (tid != NCW * WG) return;
    hw::mbar_arrive_tx(kvbar, 2 * L::KV);
#pragma unroll
    for (int c = 0; c < D / T::CW; ++c)
#pragma unroll
      for (int r = 0; r < NCW; ++r) {
        const int at = c * L::R * T::SW + r * TR * T::SW;
        hw::tma_load_3d(ks + at, &kmap, kvbar, col0 + c * T::CW,
                        kv0 + r * TR, b);
        hw::tma_load_3d(vs + at, &vmap, kvbar, col0 + c * T::CW,
                        kv0 + r * TR, b);
      }
    const int stat0 = (b * a.heads + h) * a.seq;
    int stage = 0, phase = 0;
    for (int t = 0; t < tiles; ++t) {
      const int q0 = q_begin + t * TR;
      hw::mbar_wait(&empty[stage], phase ^ 1);
      hw::mbar_arrive_tx(&full[stage], 2 * T::BYTES + 2 * TR * 4);
      unsigned char* st = ring + stage * L::STAGE;
#pragma unroll
      for (int c = 0; c < D / T::CW; ++c) {
        hw::tma_load_3d(st + c * TR * T::SW, &qmap, &full[stage],
                        col0 + c * T::CW, q0, b);
        hw::tma_load_3d(st + T::BYTES + c * TR * T::SW, &domap, &full[stage],
                        col0 + c * T::CW, q0, b);
      }
      hw::tma_load_1d(st + L::STAT, &lmap, &full[stage], stat0 + q0);
      hw::tma_load_1d(st + L::STAT + TR * 4, &dmap, &full[stage], stat0 + q0);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- consumer warpgroup wg: K/V rows kv_wg .. kv_wg + 63 ----
  const int warp = (tid % WG) / 32, lane = tid % 32;
  const int kv_wg = kv0 + 64 * wg;
  const int rowk = kv_wg + 16 * warp + lane / 4;   // and rowk + 8
  const int cq = 2 * (lane % 4);
  const unsigned char* ka = ks + wg * TR * T::SW;
  const unsigned char* va = vs + wg * TR * T::SW;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  hw::mbar_wait(kvbar, 0);

  int stage = 0, phase = 0;
  for (int t = 0; t < tiles; ++t) {
    const int q0 = q_begin + t * TR;
    hw::mbar_wait(&full[stage], phase);
    // causal: skip a tile wholly above this warpgroup's diagonal
    if (kv_wg < a.seq && (!a.causal || q0 + TR - 1 >= kv_wg)) {
      const unsigned char* qt = ring + stage * L::STAGE;
      const unsigned char* dot = qt + T::BYTES;
      const float* lse = reinterpret_cast<const float*>(qt + L::STAT);
      const float* dlt = lse + TR;
      float s[32], dp[32];
      hw::wgmma_fence();
      hw::ss_abt<D, L::R>(s, ka, qt);     // S^T = K Q^T
      hw::ss_abt<D, L::R>(dp, va, dot);   // dP^T = V dO^T
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(s);
      hw::fence_regs(dp);
      const bool edge = q0 + TR > a.seq || kv_wg + 64 > a.seq ||
                        (a.causal && q0 < kv_wg + 63);
      // P^T and dS^T: rows are keys (rowk, rowk + 8), columns queries,
      // whose lse2 and delta come from the staged rows
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = 8 * (i / 4) + cq;
        const float2 l2 = *reinterpret_cast<const float2*>(lse + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + c);
        float p0 = exp2f(s[i] * a.qscale - l2.x);
        float p1 = exp2f(s[i + 1] * a.qscale - l2.y);
        if (edge) {
          const int kv = rowk + 8 * ((i / 2) & 1), qi = q0 + c;
          if (kv >= a.seq || qi >= a.seq || (a.causal && kv > qi)) p0 = 0.f;
          if (kv >= a.seq || qi + 1 >= a.seq || (a.causal && kv > qi + 1))
            p1 = 0.f;
        }
        pf[i / 8][(i % 8) / 2] = hw::pack_bf16(p0, p1);
        df[i / 8][(i % 8) / 2] =
            hw::pack_bf16(p0 * (dp[i] - d2.x) * a.scale,
                          p1 * (dp[i + 1] - d2.y) * a.scale);
      }
      hw::fence_regs(dv);
      hw::fence_regs(dk);
      hw::wgmma_fence();
      hw::rs_ab<D>(dv, pf, dot);   // dV += P'^T dO
      hw::rs_ab<D>(dk, df, qt);    // dK += dS'^T Q
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      fence_frags(pf);
      fence_frags(df);
      hw::fence_regs(dv);
      hw::fence_regs(dk);
    }
    hw::mbar_arrive(&empty[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  const size_t row_base = (size_t)b * a.seq;
  store_rows<D>(dk, a.dk, row_base, rowk, a.seq, a.ld, col0);
  store_rows<D>(dv, a.dv, row_base, rowk, a.seq, a.ld, col0);
}

template <int D>
struct Pass2 {
  using T = WTile<D>;
  static constexpr int QB = 2 * TR;                  // query rows a block
  static constexpr int Q = QB * D * 2;               // bytes of Q (or dO)
  static constexpr int ring_off = 2 * Q;             // K then V a stage
  static constexpr int bar_off = ring_off + STAGES * 2 * T::BYTES;
  static constexpr int bytes = bar_off + (1 + 2 * STAGES) * 8;
};

// pass 2: dQ of 128 query rows
template <int D>
__global__ void __launch_bounds__(2 * WG + 32, 1)
bwd_q_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap, Args a) {
  using T = WTile<D>;
  using L = Pass2<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024)
                                    % 1024);
  unsigned char* qs = smem;
  unsigned char* dos = smem + L::Q;
  unsigned char* ring = smem + L::ring_off;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid / WG;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * L::QB;   // longest first
  const int col0 = h * D;
  const int kv_end = a.causal ? min(a.seq, q0 + L::QB) : a.seq;
  const int tiles = (kv_end + TR - 1) / TR;

  if (tid == 0) {
    hw::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 2 * WG);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer warp: one thread issues every copy ----
    if (tid != 2 * WG) return;
    hw::mbar_arrive_tx(qbar, 2 * L::Q);
#pragma unroll
    for (int c = 0; c < D / T::CW; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = c * L::QB * T::SW + r * TR * T::SW;
        hw::tma_load_3d(qs + at, &qmap, qbar, col0 + c * T::CW, q0 + r * TR,
                        b);
        hw::tma_load_3d(dos + at, &domap, qbar, col0 + c * T::CW,
                        q0 + r * TR, b);
      }
    int stage = 0, phase = 0;
    for (int t = 0; t < tiles; ++t) {
      hw::mbar_wait(&empty[stage], phase ^ 1);
      hw::mbar_arrive_tx(&full[stage], 2 * T::BYTES);
      unsigned char* st = ring + stage * 2 * T::BYTES;
#pragma unroll
      for (int c = 0; c < D / T::CW; ++c) {
        hw::tma_load_3d(st + c * TR * T::SW, &kmap, &full[stage],
                        col0 + c * T::CW, t * TR, b);
        hw::tma_load_3d(st + T::BYTES + c * TR * T::SW, &vmap, &full[stage],
                        col0 + c * T::CW, t * TR, b);
      }
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q_wg .. q_wg + 63 ----
  const int warp = (tid % WG) / 32, lane = tid % 32;
  const int q_wg = q0 + 64 * wg;
  const int rowq = q_wg + 16 * warp + lane / 4;    // and rowq + 8
  const int cq = 2 * (lane % 4);
  const size_t stat0 = ((size_t)b * a.heads + h) * a.seq;
  float lr[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rowq + 8 * hh;
    lr[hh] = r < a.seq ? a.lse[stat0 + r] : 0.f;
    dr[hh] = r < a.seq ? a.delta[stat0 + r] : 0.f;
  }
  const unsigned char* qa = qs + wg * TR * T::SW;
  const unsigned char* doa = dos + wg * TR * T::SW;
  const int kv_end_wg = a.causal ? min(a.seq, q_wg + 64) : a.seq;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  hw::mbar_wait(qbar, 0);

  int stage = 0, phase = 0;
  for (int t = 0; t < tiles; ++t) {
    const int kv0 = t * TR;
    hw::mbar_wait(&full[stage], phase);
    if (q_wg < a.seq && kv0 < kv_end_wg) {
      const unsigned char* kt = ring + stage * 2 * T::BYTES;
      const unsigned char* vt = kt + T::BYTES;
      float s[32], dp[32];
      hw::wgmma_fence();
      hw::ss_abt<D, L::QB>(s, qa, kt);     // S = Q K^T
      hw::ss_abt<D, L::QB>(dp, doa, vt);   // dP = dO V^T
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(s);
      hw::fence_regs(dp);
      const bool edge = kv0 + TR > a.seq || q_wg + 64 > a.seq ||
                        (a.causal && kv0 + TR - 1 > q_wg);
      uint32_t df[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int hh = (i / 2) & 1;
        float p0 = exp2f(s[i] * a.qscale - lr[hh]);
        float p1 = exp2f(s[i + 1] * a.qscale - lr[hh]);
        if (edge) {
          const int r = rowq + 8 * hh, kj = kv0 + 8 * (i / 4) + cq;
          if (r >= a.seq || kj >= a.seq || (a.causal && kj > r)) p0 = 0.f;
          if (r >= a.seq || kj + 1 >= a.seq || (a.causal && kj + 1 > r))
            p1 = 0.f;
        }
        df[i / 8][(i % 8) / 2] =
            hw::pack_bf16(p0 * (dp[i] - dr[hh]) * a.scale,
                          p1 * (dp[i + 1] - dr[hh]) * a.scale);
      }
      hw::fence_regs(dq);
      hw::wgmma_fence();
      hw::rs_ab<D>(dq, df, kt);   // dQ += dS' K
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      fence_frags(df);
      hw::fence_regs(dq);
    }
    hw::mbar_arrive(&empty[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  store_rows<D>(dq, a.o, (size_t)b * a.seq, rowq, a.seq, a.ld, col0);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// B18 "wgmma": the tensor maps of one call (Q, K, V, dO as (H*D, S, B)
// boxes of (CW, 64, 1); lse2 and delta as flat (B*H*S) f32 boxes of 64),
// then pass 1 and pass 2 on the stream.
template <int D>
int run_wgmma(const Args& a, int batch, cudaStream_t st) {
  using T = WTile<D>;
  constexpr int NCW = kv_wgs<D>();
  const uint64_t dims[3] = {static_cast<uint64_t>(a.heads) * D,
                            static_cast<uint64_t>(a.seq),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[2] = {static_cast<uint64_t>(a.ld) * 2,
                               static_cast<uint64_t>(a.seq) * a.ld * 2};
  const uint32_t box[3] = {T::CW, TR, 1};
  CUtensorMap qm{}, km{}, vm{}, dom{}, lm{}, dm{};
  int rc = hw::make_map(&qm, a.q, 3, dims, strides, box, T::SW);
  if (rc == 0) rc = hw::make_map(&km, a.k, 3, dims, strides, box, T::SW);
  if (rc == 0) rc = hw::make_map(&vm, a.v, 3, dims, strides, box, T::SW);
  if (rc == 0) rc = hw::make_map(&dom, a.dout, 3, dims, strides, box, T::SW);
  const uint64_t sdims[1] = {static_cast<uint64_t>(batch) * a.heads * a.seq};
  const uint32_t sbox[1] = {TR};
  if (rc == 0)
    rc = hw::make_map(&lm, a.lse, 1, sdims, nullptr, sbox, 0, true);
  if (rc == 0)
    rc = hw::make_map(&dm, a.delta, 1, sdims, nullptr, sbox, 0, true);
  if (rc) return rc;

  auto kv_kernel = bwd_kv_wgmma_kernel<D, NCW>;
  const int kv_smem = Pass1<D, NCW>::bytes + 1024;   // + the alignment
  rc = set_smem(kv_kernel, kv_smem);
  if (rc) return rc;
  const dim3 kv_grid(a.heads, batch, (a.seq + 64 * NCW - 1) / (64 * NCW));
  kv_kernel<<<kv_grid, WG * NCW + 32, kv_smem, st>>>(qm, km, vm, dom, lm, dm,
                                                      a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;

  auto q_kernel = bwd_q_wgmma_kernel<D>;
  const int q_smem = Pass2<D>::bytes + 1024;
  rc = set_smem(q_kernel, q_smem);
  if (rc) return rc;
  const dim3 q_grid(a.heads, batch, (a.seq + 2 * TR - 1) / (2 * TR));
  q_kernel<<<q_grid, 2 * WG + 32, q_smem, st>>>(qm, km, vm, dom, a);
  return static_cast<int>(cudaGetLastError());
}

enum Route : int { kFma = 0, kWgmma = 1 };

int dispatch(bool backward, const Args& a, int batch, int head_dim,
             int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return route == kWgmma ? run_wgmma<32>(a, batch, st)
                             : run_fma<32>(backward, a, batch, st);
    case 64:
      return route == kWgmma ? run_wgmma<64>(a, batch, st)
                             : run_fma<64>(backward, a, batch, st);
    case 128:
      return route == kWgmma ? run_wgmma<128>(a, batch, st)
                             : run_fma<128>(backward, a, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// attention.cu's training mode
extern "C" int tpp_attention_train_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse2,
                                       int batch, int seq, int heads,
                                       int head_dim, int causal,
                                       float qscale, void* stream);

// B14. q/k/v/o are (B, S, H, D) in the operand dtype, lse2 (B, H, S) f32.
// route is xsmm/reference.py flash_train_fwd_route's choice: 1 "wgmma"
// (bf16), 0 "fma" (f32). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int tpp_flash_train_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse2,
                                   int batch, int seq, int heads,
                                   int head_dim, int dtype, int causal,
                                   float qscale, int route, void* stream) {
  if (route != (dtype == tpp::kBF16 ? kWgmma : kFma))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kWgmma)
    return tpp_attention_train_fwd(q, k, v, o, static_cast<float*>(lse2),
                                   batch, seq, heads, head_dim, causal,
                                   qscale, stream);
  const Args a{q, k, v, nullptr, o, nullptr, nullptr,
               static_cast<float*>(lse2), nullptr, seq, heads,
               heads * head_dim, causal, qscale, 0.f};
  return dispatch(false, a, batch, head_dim, kFma, stream);
}

// B18: both passes, one after the other on the stream. q/k/v/dout and
// dq/dk/dv are (B, S, H, D) in the operand dtype; lse2 and delta (B, H, S)
// f32. route is xsmm/reference.py flash_train_bwd_route's choice: 1
// "wgmma" (bf16; TMA needs 16-byte aligned operands, the batch goes in
// gridDim.y), 0 "fma" (f32).
extern "C" int tpp_flash_train_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse2, const void* delta,
                                   void* dq, void* dk, void* dv, int batch,
                                   int seq, int heads, int head_dim,
                                   int dtype, int causal, float qscale,
                                   float scale, int route, void* stream) {
  if (route != (dtype == tpp::kBF16 ? kWgmma : kFma))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, dq, dk, dv,
               const_cast<float*>(static_cast<const float*>(lse2)),
               static_cast<const float*>(delta), seq, heads,
               heads * head_dim, causal, qscale, scale};
  return dispatch(true, a, batch, head_dim, route, stream);
}
