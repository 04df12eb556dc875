// Attention for Hopper (sm_90a), token and flat layouts, with an in-kernel
// warm bench.
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:2232 _build_flash_mha_tokens (B7):
//   out[b, s, h*D:(h+1)*D] = softmax(Q_h K_h^T * scale [causal]) V_h
// on the token layout (B, S, H*D). Q/K/V are read by strides: split
// operands have row stride E = H*D; one packed (B, S, 3E) [Q|K|V] operand is
// read at column offsets 0, E, 2E with row stride 3E, so no slice is ever
// copied. The flat layout (B*H, S, D) is the same stride set with one head
// and row stride D, and so this kernel also replaces the five flat TPU
// kernels, which compute one function and differ only in how they schedule
// the TPU's VMEM: :1660 _build_flash_mha (B6, blocked online softmax),
// :2395 _build_flash_mha_qblock (B8), :2721 _build_flash_mha_grouped (B9),
// :2496 _build_flash_causal_twocall (B10a) and :2618
// _build_flash_causal_fold2 (B10b). Their causal mask keeps rows >= cols,
// aligned top-left, as kv_end and the mask below do.
//
// Warm bench (replaces :2091 _build_flash_bench, B11): with repeats > 0 a
// block loops over the repeats on its own Q tile. A tile's output rows
// depend only on its Q rows and on all of K/V, so no grid-wide sync is
// needed: O/l is rounded to the MXU dtype (the TPU's hbuf), scaled by
// qscale back into the Q tile in shared memory, the K/V loop runs again,
// and the output (still rounded to the MXU dtype) is written once, after
// the last repeat. Only the first Q comes from device memory (from the
// packed columns, for a packed operand).
//
// The math follows B7: Q (in the MXU dtype) is scaled by scale*log2(e) in
// f32 and rounded to the MXU dtype again, the softmax is in the exp2
// domain, P is rounded to the MXU dtype before P.V, sums are f32. Unlike
// B7, which normalizes P over the whole row before P.V, this kernel runs
// the online softmax over K/V tiles and divides by the row sum once at the
// end (as B6, B8, B9 and B11 do), so the (S x S) scores never exist
// anywhere.
//
// What bounds it on the H100: at the GPT-2 shape (B 2, S 1024, H 12, D 64,
// causal) it is 26 GFLOP of tensor-core work over 19 MB of Q/K/V, so it
// could be compute-bound; this first version is bound by its shared-memory
// traffic instead: one block per (q-tile of 64 rows, head, batch), 4 warps
// of 16 query rows each, K/V tiles of 64 rows staged through shared memory
// without pipelining, products by WMMA (mma.sync 16x16x16 bf16, f32
// accumulators), and the f32 output accumulator kept in shared memory so
// that the per-row online-softmax rescale needs no fragment layout. Causal
// keys skip every K/V tile above the diagonal. MXU dtype: bf16 for bf16 and
// f32 "default"; f32 FMA (no TF32) for f32 "highest". D 32, 64 and 128.
// Register-resident accumulators (mma.sync with a known fragment layout),
// wgmma and TMA are later work.
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int seq, seq_kv;
  int ld_in;    // row stride of Q/K/V in elements: E, or 3E when packed
  int ld_out;   // row stride of out: E
  float qscale;  // scale * log2(e)
  int causal, out_dtype;
  int repeats;   // 0: one pass; > 0: the warm bench (B11)
};

// Shared-memory plan of one block. Row pads keep WMMA pointers 32-byte
// aligned (bf16 rows a multiple of 8, f32 rows of 4) and, on the FMA path,
// give K an odd row stride so lanes reading K[lane][d] hit distinct banks.
template <typename Tmma, int D>
struct Plan {
  static constexpr bool kTensor = std::is_same<Tmma, __nv_bfloat16>::value;
  static constexpr int QLD = kTensor ? D + 8 : D + 1;  // Q and K rows
  static constexpr int VLD = kTensor ? D + 8 : D + 4;
  static constexpr int SLD = BKV + 4;                  // f32 scores
  static constexpr int PLD = kTensor ? BKV + 8 : BKV + 4;
  static constexpr int OLD = D + 4;                    // f32 output acc
  static constexpr size_t up(size_t x) { return (x + 127) / 128 * 128; }
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = up(q_off + BQ * QLD * sizeof(Tmma));
  static constexpr size_t v_off = up(k_off + BKV * QLD * sizeof(Tmma));
  static constexpr size_t s_off = up(v_off + BKV * VLD * sizeof(Tmma));
  static constexpr size_t p_off = up(s_off + BQ * SLD * sizeof(float));
  static constexpr size_t o_off = up(p_off + BQ * PLD * sizeof(Tmma));
  static constexpr size_t r_off = up(o_off + BQ * OLD * sizeof(float));
  static constexpr size_t bytes = up(r_off + 3 * BQ * sizeof(float));
};

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

template <typename Tin, typename Tmma, int D>
__global__ void __launch_bounds__(THREADS) attention_kernel(Args a) {
  using L = Plan<Tmma, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Tmma* Qs = reinterpret_cast<Tmma*>(smem + L::q_off);
  Tmma* Ks = reinterpret_cast<Tmma*>(smem + L::k_off);
  Tmma* Vs = reinterpret_cast<Tmma*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  Tmma* Ps = reinterpret_cast<Tmma*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* Ms = reinterpret_cast<float*>(smem + L::r_off);  // running max
  float* Ls = Ms + BQ;                                     // running sum
  float* As = Ls + BQ;                                     // tile rescale

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)h * D;
  const Tin* Q = static_cast<const Tin*>(a.q) + (size_t)b * a.seq * a.ld_in
                 + head;
  const Tin* K = static_cast<const Tin*>(a.k)
                 + (size_t)b * a.seq_kv * a.ld_in + head;
  const Tin* V = static_cast<const Tin*>(a.v)
                 + (size_t)b * a.seq_kv * a.ld_in + head;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < a.seq)
      x = tpp::to_f32(tpp::from_f32<Tmma>(
          tpp::to_f32(Q[(size_t)(q0 + r) * a.ld_in + c])));
    Qs[r * L::QLD + c] = tpp::from_f32<Tmma>(x * a.qscale);
  }

  const int r0 = warp * 16;  // this warp's 16 query rows of the tile
  const int kv_end = a.causal ? min(a.seq_kv, q0 + BQ) : a.seq_kv;
  const int passes = a.repeats > 0 ? a.repeats : 1;
  for (int rep = 0; rep < passes; ++rep) {
    for (int i = tid; i < BQ * D; i += THREADS)
      Os[(i / D) * L::OLD + i % D] = 0.f;
    if (tid < BQ) {
      Ms[tid] = -INFINITY;
      Ls[tid] = 0.f;
    }
    for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
      __syncthreads();  // Q staged; the previous tile's K/V no longer read
      for (int i = tid; i < BKV * D; i += THREADS) {
        const int r = i / D, c = i % D;
        const bool in = kv0 + r < a.seq_kv;
        const size_t g = (size_t)(kv0 + r) * a.ld_in + c;
        Ks[r * L::QLD + c] =
            tpp::from_f32<Tmma>(in ? tpp::to_f32(K[g]) : 0.f);
        Vs[r * L::VLD + c] =
            tpp::from_f32<Tmma>(in ? tpp::to_f32(V[g]) : 0.f);
      }
      __syncthreads();

      // S = Q K^T for the warp's rows (already in the exp2 domain)
      if constexpr (L::kTensor) {
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
          wmma::fill_fragment(s, 0.f);
#pragma unroll
          for (int kk = 0; kk < D; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> fb;
            wmma::load_matrix_sync(fa, Qs + r0 * L::QLD + kk, L::QLD);
            wmma::load_matrix_sync(fb, Ks + j * 16 * L::QLD + kk, L::QLD);
            wmma::mma_sync(s, fa, fb, s);
          }
          wmma::store_matrix_sync(Ss + r0 * L::SLD + j * 16, s, L::SLD,
                                  wmma::mem_row_major);
        }
      } else {
        float acc[16][2];
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) acc[rr][0] = acc[rr][1] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float k0 = tpp::to_f32(Ks[lane * L::QLD + d]);
          const float k1 = tpp::to_f32(Ks[(lane + 32) * L::QLD + d]);
#pragma unroll
          for (int rr = 0; rr < 16; ++rr) {
            const float qv = tpp::to_f32(Qs[(r0 + rr) * L::QLD + d]);
            acc[rr][0] = fmaf(qv, k0, acc[rr][0]);
            acc[rr][1] = fmaf(qv, k1, acc[rr][1]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          Ss[(r0 + rr) * L::SLD + lane] = acc[rr][0];
          Ss[(r0 + rr) * L::SLD + lane + 32] = acc[rr][1];
        }
      }
      __syncwarp();

      // online softmax of the tile, row by row: lane owns columns lane and
      // lane + 32
      for (int rr = 0; rr < 16; ++rr) {
        const int r = r0 + rr, qi = q0 + r;
        float s[2], mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int kj = kv0 + lane + 32 * t;
          float v = Ss[r * L::SLD + lane + 32 * t];
          if (kj >= a.seq_kv || (a.causal && kj > qi)) v = -INFINITY;
          s[t] = v;
          mx = fmaxf(mx, v);
        }
        mx = warp_max(mx);
        const float m_old = Ms[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float p = m_new == -INFINITY ? 0.f : exp2f(s[t] - m_new);
          sum += p;
          Ps[r * L::PLD + lane + 32 * t] = tpp::from_f32<Tmma>(p);
        }
        sum = warp_sum(sum);
        __syncwarp();
        if (lane == 0) {
          const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
          Ls[r] = Ls[r] * alpha + sum;
          Ms[r] = m_new;
          As[r] = alpha;
        }
      }
      __syncwarp();

      // O = alpha * O + P V for the warp's rows
      if constexpr (L::kTensor) {
        for (int rr = 0; rr < 16; ++rr) {
          const float alpha = As[r0 + rr];
          for (int c = lane; c < D; c += 32)
            Os[(r0 + rr) * L::OLD + c] *= alpha;
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < D / 16; ++t) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
          wmma::load_matrix_sync(o, Os + r0 * L::OLD + t * 16, L::OLD,
                                 wmma::mem_row_major);
#pragma unroll
          for (int kk = 0; kk < BKV; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(fa, Ps + r0 * L::PLD + kk, L::PLD);
            wmma::load_matrix_sync(fb, Vs + kk * L::VLD + t * 16, L::VLD);
            wmma::mma_sync(o, fa, fb, o);
          }
          wmma::store_matrix_sync(Os + r0 * L::OLD + t * 16, o, L::OLD,
                                  wmma::mem_row_major);
        }
      } else {
        constexpr int NT = D / 32;  // output columns lane + 32 t
        float acc[16][NT];
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const float alpha = As[r0 + rr];
#pragma unroll
          for (int t = 0; t < NT; ++t)
            acc[rr][t] = Os[(r0 + rr) * L::OLD + lane + 32 * t] * alpha;
        }
        for (int j = 0; j < BKV; ++j) {
          float vv[NT];
#pragma unroll
          for (int t = 0; t < NT; ++t)
            vv[t] = tpp::to_f32(Vs[j * L::VLD + lane + 32 * t]);
#pragma unroll
          for (int rr = 0; rr < 16; ++rr) {
            const float p = tpp::to_f32(Ps[(r0 + rr) * L::PLD + j]);
#pragma unroll
            for (int t = 0; t < NT; ++t)
              acc[rr][t] = fmaf(p, vv[t], acc[rr][t]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 16; ++rr)
#pragma unroll
          for (int t = 0; t < NT; ++t)
            Os[(r0 + rr) * L::OLD + lane + 32 * t] = acc[rr][t];
      }
    }
    __syncthreads();
    if (rep + 1 == passes) break;
    // warm bench: the output, rounded to the MXU dtype, is the next Q
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const float o = Os[r * L::OLD + c] / Ls[r];
      const float x = q0 + r < a.seq ? tpp::to_f32(tpp::from_f32<Tmma>(o))
                                     : 0.f;
      Qs[r * L::QLD + c] = tpp::from_f32<Tmma>(x * a.qscale);
    }
    __syncthreads();
  }  // repeats

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, qi = q0 + r;
    if (qi >= a.seq) continue;
    float o = Os[r * L::OLD + c] / Ls[r];
    if (a.repeats > 0) o = tpp::to_f32(tpp::from_f32<Tmma>(o));
    tpp::store_out(a.out, ((size_t)b * a.seq + qi) * a.ld_out + head + c,
                   a.out_dtype, o);
  }
}

template <typename Tin, typename Tmma, int D>
int launch(const Args& a, int batch, int heads, cudaStream_t stream) {
  using L = Plan<Tmma, D>;
  auto kernel = attention_kernel<Tin, Tmma, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + BQ - 1) / BQ, heads, batch);
  kernel<<<grid, THREADS, L::bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tmma>
int launch_d(const Args& a, int batch, int heads, int d, cudaStream_t st) {
  switch (d) {
    case 32: return launch<Tin, Tmma, 32>(a, batch, heads, st);
    case 64: return launch<Tin, Tmma, 64>(a, batch, heads, st);
    case 128: return launch<Tin, Tmma, 128>(a, batch, heads, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). q/k/v/out point at
// the first element of head 0 of Q/K/V and of the output; ld_in is their row
// stride in elements (E, or 3E for one packed operand), the output's is E.
// The flat layout is heads = 1 with ld_in = D. The batch goes in gridDim.z,
// so it is at most 65535.
extern "C" int tpp_attention(const void* q, const void* k, const void* v,
                             void* out, int batch, int seq, int seq_kv,
                             int heads, int head_dim, int ld_in,
                             int in_dtype, int mma_dtype, int out_dtype,
                             int causal, int repeats, float qscale,
                             void* stream) {
  const Args a{q,     k,      v,      out,    seq,      seq_kv,
               ld_in, heads * head_dim, qscale, causal, out_dtype, repeats};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kF32)
    return launch_d<float, float>(a, batch, heads, head_dim, st);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kBF16)
    return launch_d<float, __nv_bfloat16>(a, batch, heads, head_dim, st);
  if (in_dtype == tpp::kBF16 && mma_dtype == tpp::kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(a, batch, heads, head_dim,
                                                   st);
  return static_cast<int>(cudaErrorInvalidValue);
}
