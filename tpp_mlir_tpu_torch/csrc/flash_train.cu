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
// The TPU kernels hold whole (S, S) slabs of one head in VMEM; a Hopper
// block has at most 227 KB of shared memory, so both kernels are tiled in
// 64 x 64 blocks and no (S, S) array exists anywhere:
//   * B14: one block per (64-row Q tile, head, batch row), looping over the
//     K/V tiles with an online softmax (running max m, running sum l, the
//     f32 output accumulator rescaled per tile and divided by l once at the
//     end). Causal keys skip the K/V tiles above the diagonal.
//   * B18: two passes, both deterministic (no atomics, so two runs give
//     bit-equal gradients). Pass 1, one block per (64-row K/V tile, head,
//     batch row), keeps K_j, V_j and the f32 dK_j, dV_j accumulators and
//     loops over the Q tiles at or below the diagonal, recomputing P from
//     lse2. Pass 2, one block per Q tile, recomputes S and dP over the
//     K/V tiles and accumulates dQ_i; it repeats two of pass 1's products
//     so that dQ needs no cross-block reduction.
// Products: WMMA bf16 16x16x16 with f32 accumulators for bf16 operands; f32
// FMA (no TF32) for f32 operands. Accumulators live in shared memory so
// that the row-wise softmax and rescale need no fragment layout.
//
// What bounds it on the H100: at the GPT-2 training key (B 8, S 512, H 12,
// D 64, causal, bf16) B14 does 3.2 GFLOP over 25 MB and B18 8.1 GFLOP over
// 44 MB, both below the 295 FLOP/byte ridge, so the floor is bytes (7.6 and
// 13.3 us at 3.35 TB/s). This first version is bound by its own
// shared-memory traffic and unpipelined scalar tile loads instead; wgmma,
// TMA and register-resident accumulators are later work. D 32, 64, 128.
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kTensor = std::is_same<T, bf16>::value;

// Row strides of the shared tiles: for WMMA a multiple of 8 elements for
// bf16 tiles (`v`) and of 4 for f32 ones (`f`), keeping every fragment
// pointer 32-byte aligned; on the FMA path N + 1, so that neighbouring
// threads reading along a row of the other operand hit distinct banks.
template <typename T, int N>
struct Ld {
  static constexpr int v = kTensor<T> ? N + 8 : N + 1;
  static constexpr int f = kTensor<T> ? N + 4 : N + 1;
};

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

// C (ACC ? += : =) op(A) op(B) for an M x N tile of C with inner size K,
// all multiples of 16, over shared memory:
//   op(A)(m, k) = TA ? A[k * lda + m] : A[m * lda + k]
//   op(B)(k, n) = TB ? B[n * ldb + k] : B[k * ldb + n]
// bf16: the 16x16 tiles of C dealt to the warps in turn, WMMA with f32
// accumulators loaded from and stored to C. f32: one element of C per
// thread in turn, f32 FMA. The caller synchronizes before and after.
template <typename T, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void block_gemm(float* C, int ldc, const T* A,
                                           int lda, const T* B, int ldb,
                                           int M, int N, int K) {
  if constexpr (kTensor<T>) {
    using LA = typename std::conditional<TA, wmma::col_major,
                                         wmma::row_major>::type;
    using LB = typename std::conditional<TB, wmma::col_major,
                                         wmma::row_major>::type;
    const int warp = threadIdx.x / 32, tn = N / 16;
    for (int t = warp; t < (M / 16) * tn; t += WARPS) {
      const int m0 = t / tn * 16, n0 = t % tn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (ACC)
        wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc,
                               wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
        wmma::load_matrix_sync(fa, TA ? A + k0 * lda + m0 : A + m0 * lda + k0,
                               lda);
        wmma::load_matrix_sync(fb, TB ? B + n0 * ldb + k0 : B + k0 * ldb + n0,
                               ldb);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < M * N; i += THREADS) {
      const int m = i / N, n = i % N;
      float s = ACC ? C[m * ldc + n] : 0.f;
      for (int k = 0; k < K; ++k)
        s = fmaf(TA ? A[k * lda + m] : A[m * lda + k],
                 TB ? B[n * ldb + k] : B[k * ldb + n], s);
      C[m * ldc + n] = s;
    }
  }
}

// dst[r][c] = src[(row0 + r) * ld + c] for the 64 rows of a tile, zero for
// rows at or past `rows`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src,
                                          int ld, int row0, int rows) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * ldd + c] = row0 + r < rows ? src[(size_t)(row0 + r) * ld + c]
                                       : tpp::from_f32<T>(0.f);
  }
}

// f32 tile -> rows of the (B, S, H, D) output, scaled per row, cast to T.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* dst, int ld, const float* src,
                                           int lds, int row0, int rows,
                                           const float* row_div) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    if (row0 + r >= rows) continue;
    float x = src[r * lds + c];
    if (row_div) x /= row_div[r];
    dst[(size_t)(row0 + r) * ld + c] = tpp::from_f32<T>(x);
  }
}

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

// ---------------------------------------------------------------- forward

template <typename T, int D>
struct FwdPlan {
  static constexpr int QLD = Ld<T, D>::v;     // Q, K, V tiles
  static constexpr int SLD = Ld<T, BKV>::f;   // f32 scores
  static constexpr int PLD = Ld<T, BKV>::v;   // P' in T
  static constexpr int OLD = Ld<T, D>::f;     // f32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = up(q_off + BQ * QLD * sizeof(T));
  static constexpr size_t v_off = up(k_off + BKV * QLD * sizeof(T));
  static constexpr size_t s_off = up(v_off + BKV * QLD * sizeof(T));
  static constexpr size_t p_off = up(s_off + BQ * SLD * sizeof(float));
  static constexpr size_t o_off = up(p_off + BQ * PLD * sizeof(T));
  static constexpr size_t r_off = up(o_off + BQ * OLD * sizeof(float));
  static constexpr size_t bytes = up(r_off + 2 * BQ * sizeof(float));
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Args a) {
  using L = FwdPlan<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* Ms = reinterpret_cast<float*>(smem + L::r_off);  // running max
  float* Ls = Ms + BQ;                                     // running sum

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * a.seq * a.ld + (size_t)h * D;
  const T* K = static_cast<const T*>(a.k) + base;
  const T* V = static_cast<const T*>(a.v) + base;

  load_tile<T, D>(Qs, L::QLD, static_cast<const T*>(a.q) + base, a.ld, q0,
                  a.seq);
  for (int i = tid; i < BQ * D; i += THREADS) Os[i / D * L::OLD + i % D] = 0.f;
  if (tid < BQ) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  const int kv_end = a.causal ? min(a.seq, q0 + BQ) : a.seq;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's K, V and P' are no longer read
    load_tile<T, D>(Ks, L::QLD, K, a.ld, kv0, a.seq);
    load_tile<T, D>(Vs, L::QLD, V, a.ld, kv0, a.seq);
    __syncthreads();
    block_gemm<T, false, true, false>(Ss, L::SLD, Qs, L::QLD, Ks, L::QLD, BQ,
                                      BKV, D);
    __syncthreads();

    // online softmax in the exp2 domain: warp w owns rows 16w..16w+15, a
    // lane the columns lane and lane + 32
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
        Ps[r * L::PLD + lane + 32 * t] = tpp::from_f32<T>(p);
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
    block_gemm<T, false, false, true>(Os, L::OLD, Ps, L::PLD, Vs, L::QLD, BQ,
                                      D, BKV);
  }
  __syncthreads();

  store_tile<T, D>(static_cast<T*>(a.o) + base, a.ld, Os, L::OLD, q0, a.seq,
                   Ls);
  if (tid < BQ && q0 + tid < a.seq)
    a.lse[((size_t)b * a.heads + h) * a.seq + q0 + tid] =
        Ms[tid] + log2f(Ls[tid]);
}

// --------------------------------------------------------------- backward

// One plan for both passes. X holds P' then dS' in T; on the f32 path
// rounding is the identity, so X is the f32 score tile itself (the f32
// key at D 128 needs 231,936 bytes with the alias, within the 232,448 a
// block may opt into).
template <typename T, int D>
struct BwdPlan {
  static constexpr int QLD = Ld<T, D>::v;     // Q, dO, K, V tiles
  static constexpr int SLD = Ld<T, BKV>::f;   // f32 S / P, dP / dS
  static constexpr int XLD = kTensor<T> ? Ld<T, BKV>::v : SLD;
  static constexpr int ALD = Ld<T, D>::f;     // f32 accumulators
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = up(q_off + BQ * QLD * sizeof(T));
  static constexpr size_t k_off = up(do_off + BQ * QLD * sizeof(T));
  static constexpr size_t v_off = up(k_off + BKV * QLD * sizeof(T));
  static constexpr size_t s_off = up(v_off + BKV * QLD * sizeof(T));
  static constexpr size_t dp_off = up(s_off + BQ * SLD * sizeof(float));
  static constexpr size_t x_end = up(dp_off + BQ * SLD * sizeof(float));
  static constexpr size_t x_off = kTensor<T> ? x_end : s_off;
  static constexpr size_t a0_off =
      kTensor<T> ? up(x_end + BQ * XLD * sizeof(T)) : x_end;
  static constexpr size_t a1_off = up(a0_off + 64 * ALD * sizeof(float));
  static constexpr size_t r_off = up(a1_off + 64 * ALD * sizeof(float));
  static constexpr size_t bytes = up(r_off + 2 * BQ * sizeof(float));
};

// S = Q K^T and dP = dO V^T for one (Q tile, K/V tile) pair, then from
// them, element by element: P = exp2(S scale log2(e) - lse2) (0 where
// masked), X = P' and dPs = dS = P (dP - delta) scale, in f32.
template <typename T, int D>
__device__ __forceinline__ void bwd_tile_pd(const Args& a, int q0, int kv0,
                                            const T* Qs, const T* dOs,
                                            const T* Ks, const T* Vs,
                                            float* Ss, float* dPs, T* Xs,
                                            const float* Lse,
                                            const float* Dlt) {
  using L = BwdPlan<T, D>;
  block_gemm<T, false, true, false>(Ss, L::SLD, Qs, L::QLD, Ks, L::QLD, BQ,
                                    BKV, D);
  block_gemm<T, false, true, false>(dPs, L::SLD, dOs, L::QLD, Vs, L::QLD, BQ,
                                    BKV, D);
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * BKV; i += THREADS) {
    const int r = i / BKV, c = i % BKV, qi = q0 + r, kj = kv0 + c;
    const bool live = qi < a.seq && kj < a.seq && !(a.causal && kj > qi);
    const float s = Ss[r * L::SLD + c];  // read before X (may alias S)
    const float p = live ? exp2f(s * a.qscale - Lse[r]) : 0.f;
    Xs[r * L::XLD + c] = tpp::from_f32<T>(p);
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
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_kv_kernel(Args a) {
  using L = BwdPlan<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* dOs = reinterpret_cast<T*>(smem + L::do_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  T* Xs = reinterpret_cast<T*>(smem + L::x_off);
  float* dKs = reinterpret_cast<float*>(smem + L::a0_off);
  float* dVs = reinterpret_cast<float*>(smem + L::a1_off);
  float* Lse = reinterpret_cast<float*>(smem + L::r_off);
  float* Dlt = Lse + BQ;

  const int tid = threadIdx.x;
  const int kv0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * a.seq * a.ld + (size_t)h * D;
  const size_t row_base = ((size_t)b * a.heads + h) * a.seq;
  const T* Q = static_cast<const T*>(a.q) + base;
  const T* dO = static_cast<const T*>(a.dout) + base;

  load_tile<T, D>(Ks, L::QLD, static_cast<const T*>(a.k) + base, a.ld, kv0,
                  a.seq);
  load_tile<T, D>(Vs, L::QLD, static_cast<const T*>(a.v) + base, a.ld, kv0,
                  a.seq);
  for (int i = tid; i < BKV * D; i += THREADS) {
    dKs[i / D * L::ALD + i % D] = 0.f;
    dVs[i / D * L::ALD + i % D] = 0.f;
  }

  // causal: the Q tiles at or below the diagonal (the tiles line up, BQ ==
  // BKV)
  for (int q0 = a.causal ? kv0 : 0; q0 < a.seq; q0 += BQ) {
    __syncthreads();  // the previous Q tile's Q, dO and X are no longer read
    load_tile<T, D>(Qs, L::QLD, Q, a.ld, q0, a.seq);
    load_tile<T, D>(dOs, L::QLD, dO, a.ld, q0, a.seq);
    load_stats(a, row_base, q0, Lse, Dlt);
    __syncthreads();
    bwd_tile_pd<T, D>(a, q0, kv0, Qs, dOs, Ks, Vs, Ss, dPs, Xs, Lse, Dlt);
    __syncthreads();
    // dV += P'^T dO
    block_gemm<T, true, false, true>(dVs, L::ALD, Xs, L::XLD, dOs, L::QLD,
                                     BKV, D, BQ);
    __syncthreads();
    for (int i = tid; i < BQ * BKV; i += THREADS)
      Xs[i / BKV * L::XLD + i % BKV] =
          tpp::from_f32<T>(dPs[i / BKV * L::SLD + i % BKV]);
    __syncthreads();
    // dK += dS'^T Q
    block_gemm<T, true, false, true>(dKs, L::ALD, Xs, L::XLD, Qs, L::QLD,
                                     BKV, D, BQ);
  }
  __syncthreads();
  store_tile<T, D>(static_cast<T*>(a.dk) + base, a.ld, dKs, L::ALD, kv0,
                   a.seq, nullptr);
  store_tile<T, D>(static_cast<T*>(a.dv) + base, a.ld, dVs, L::ALD, kv0,
                   a.seq, nullptr);
}

// pass 2: dQ of one Q tile
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_q_kernel(Args a) {
  using L = BwdPlan<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* dOs = reinterpret_cast<T*>(smem + L::do_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  T* Xs = reinterpret_cast<T*>(smem + L::x_off);
  float* dQs = reinterpret_cast<float*>(smem + L::a0_off);
  float* Lse = reinterpret_cast<float*>(smem + L::r_off);
  float* Dlt = Lse + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * a.seq * a.ld + (size_t)h * D;
  const size_t row_base = ((size_t)b * a.heads + h) * a.seq;
  const T* K = static_cast<const T*>(a.k) + base;
  const T* V = static_cast<const T*>(a.v) + base;

  load_tile<T, D>(Qs, L::QLD, static_cast<const T*>(a.q) + base, a.ld, q0,
                  a.seq);
  load_tile<T, D>(dOs, L::QLD, static_cast<const T*>(a.dout) + base, a.ld,
                  q0, a.seq);
  load_stats(a, row_base, q0, Lse, Dlt);
  for (int i = tid; i < BQ * D; i += THREADS)
    dQs[i / D * L::ALD + i % D] = 0.f;

  const int kv_end = a.causal ? min(a.seq, q0 + BQ) : a.seq;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's K and X are no longer read
    load_tile<T, D>(Ks, L::QLD, K, a.ld, kv0, a.seq);
    load_tile<T, D>(Vs, L::QLD, V, a.ld, kv0, a.seq);
    __syncthreads();
    bwd_tile_pd<T, D>(a, q0, kv0, Qs, dOs, Ks, Vs, Ss, dPs, Xs, Lse, Dlt);
    __syncthreads();
    for (int i = tid; i < BQ * BKV; i += THREADS)
      Xs[i / BKV * L::XLD + i % BKV] =
          tpp::from_f32<T>(dPs[i / BKV * L::SLD + i % BKV]);
    __syncthreads();
    // dQ += dS' K
    block_gemm<T, false, false, true>(dQs, L::ALD, Xs, L::XLD, Ks, L::QLD, BQ,
                                      D, BKV);
  }
  __syncthreads();
  store_tile<T, D>(static_cast<T*>(a.o) + base, a.ld, dQs, L::ALD, q0, a.seq,
                   nullptr);
}

// ----------------------------------------------------------------- launch

template <typename Kernel>
int launch(Kernel kernel, size_t bytes, const Args& a, int batch,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + 63) / 64, a.heads, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run(bool backward, const Args& a, int batch, cudaStream_t st) {
  if (!backward)
    return launch(flash_fwd_kernel<T, D>, FwdPlan<T, D>::bytes, a, batch, st);
  const size_t bytes = BwdPlan<T, D>::bytes;
  const int rc = launch(flash_bwd_kv_kernel<T, D>, bytes, a, batch, st);
  if (rc) return rc;
  return launch(flash_bwd_q_kernel<T, D>, bytes, a, batch, st);
}

template <typename T>
int run_d(bool backward, const Args& a, int batch, int d, cudaStream_t st) {
  switch (d) {
    case 32: return run<T, 32>(backward, a, batch, st);
    case 64: return run<T, 64>(backward, a, batch, st);
    case 128: return run<T, 128>(backward, a, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(bool backward, const Args& a, int batch, int head_dim,
             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tpp::kBF16)
    return run_d<bf16>(backward, a, batch, head_dim, st);
  if (dtype == tpp::kF32)
    return run_d<float>(backward, a, batch, head_dim, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// B14. q/k/v/o are (B, S, H, D) in the operand dtype, lse2 (B, H, S) f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tpp_flash_train_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse2,
                                   int batch, int seq, int heads,
                                   int head_dim, int dtype, int causal,
                                   float qscale, void* stream) {
  const Args a{q, k, v, nullptr, o, nullptr, nullptr,
               static_cast<float*>(lse2), nullptr, seq, heads,
               heads * head_dim, causal, qscale, 0.f};
  return dispatch(false, a, batch, head_dim, dtype, stream);
}

// B18: both passes, one after the other on the stream. q/k/v/dout and
// dq/dk/dv are (B, S, H, D) in the operand dtype; lse2 and delta (B, H, S)
// f32.
extern "C" int tpp_flash_train_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse2, const void* delta,
                                   void* dq, void* dk, void* dv, int batch,
                                   int seq, int heads, int head_dim,
                                   int dtype, int causal, float qscale,
                                   float scale, void* stream) {
  const Args a{q, k, v, dout, dq, dk, dv,
               const_cast<float*>(static_cast<const float*>(lse2)),
               static_cast<const float*>(delta), seq, heads,
               heads * head_dim, causal, qscale, scale};
  return dispatch(true, a, batch, head_dim, dtype, stream);
}
