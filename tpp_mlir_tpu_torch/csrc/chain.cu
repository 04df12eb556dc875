// Whole-chain fused MLP for Hopper (sm_90a): act(...act(x@W1+b1)@W2...)
// in one launch, optionally `repeats` times with the output fed back.
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:1475 _build_chain (B3),
// :2001 _build_chain_bench (B4) and :1919 _build_chain_bench_pingpong (B5).
// Rows of an MLP are independent, so a row panel is carried through every
// layer and every repeat inside one launch, the output written once: no
// grid-wide sync, and B4 and B5 are loops inside B3 rather than kernels of
// their own.
//
// Numerics of the references:
//   * B3: f32 between layers; only each product's input is rounded to the
//     MXU dtype (bf16, f16 for an f16 key, or f32 at precision "highest").
//   * B4 (repeats > 1): the state fed back is held in the MXU dtype, and the
//     output is that state, converted to the output dtype.
//   * B5 (pingpong, one layer k -> n, repeats > 1): even repeats run the fc,
//     hn = act(h W + b); odd repeats contract hn with the same W on its n
//     axis, h = hn W^T (W^T read in place: col-major fragment loads), no
//     bias, no activation; both states in the MXU dtype. The output is hn
//     after the last forward repeat, written when that repeat ends (the
//     engine stops there: a later backward repeat is dead). The panel is
//     sized for max(k, n).
//
// What bounds it on the H100: the flagship (256 x 1024x4, bf16) is 1.61
// GFLOP and 6 MB of weights an iteration; one block cannot hold the weights
// nor fill the card's 132 SMs. 16-bit products (bf16, and f32 at
// "default"; f16 for an f16 key, ROADMAP A14) run on the warm-panel engine (csrc/warm_panel.cuh): a cluster of blocks
// shares a row panel, each block owns a share of every layer's output
// columns (wgmma with the batch rows as N), and the layer's output is
// exchanged through distributed shared memory; weights stream from the 50
// MB L2 by TMA, or stay resident where a block's slices fit. The plan is
// xsmm/reference.py warm_plan's, the route chain_route's. The first design
// below (one block per 16-row block, the layer input in the MXU dtype and
// its f32 output in shared memory, WMMA tiles with B straight from device
// memory, or f32 FMA) serves f32 "highest" (route "fma") and any key the
// engine's plan cannot take (route "wmma"); the chain-fusion gate,
// chain_fits_smem, still sizes that body (tpp_chain_smem_bytes), so the
// engine admits no key the gate did not.
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"
#include "warm_panel.cuh"

using namespace nvcuda;

namespace {

constexpr int CBM = 16, THREADS = 256, MAXL = 32;
constexpr int HPAD = 8, ZPAD = 4;

struct ChainParams {
  const void* w[MAXL];      // [dims[i], dims[i+1]] row-major, in Tmma
  const void* bias[MAXL];   // [dims[i+1]] in bias_dtype[i], or null
  int bias_dtype[MAXL];     // f32, bf16 or f16 (epilogue.cuh)
  int dims[MAXL + 1];
  int L, dmax, unary, last_unary, repeats, round_out, out_dtype, pingpong;
  int m;
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <typename Tmma>
__host__ __device__ inline size_t smem_bytes(int dmax) {
  return align128((size_t)CBM * (dmax + HPAD) * sizeof(Tmma)) +
         (size_t)CBM * (dmax + ZPAD) * sizeof(float);
}

// Z[:, :N] = H[:, :K] @ W for the block's CBM rows, W (K x N) row-major
// in the MXU dtype, or with `transposed` H[:, :K] @ W^T for W (N x K).
template <typename Tmma>
__device__ void block_product(const Tmma* H, int ldh, float* Z, int ldz,
                              const Tmma* W, int K, int N, bool transposed) {
  // WMMA tiles for 16-bit products (bf16 or f16), FMA for f32
  constexpr bool kTensor = !std::is_same<Tmma, float>::value;
  const int tid = threadIdx.x, warp = tid / 32;
  if constexpr (kTensor) {
    // one 16x16 output tile per warp step; A from shared memory, B
    // straight from device memory (L2-resident), f32 accumulators
    for (int nt = warp; nt < N / 16; nt += THREADS / 32) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, Tmma, wmma::row_major>
            fa;
        wmma::load_matrix_sync(fa, H + k0, ldh);
        if (transposed) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, Tmma, wmma::col_major>
              fb;
          wmma::load_matrix_sync(fb, W + (size_t)nt * 16 * K + k0, K);
          wmma::mma_sync(acc, fa, fb, acc);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, Tmma, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, W + (size_t)k0 * N + nt * 16, N);
          wmma::mma_sync(acc, fa, fb, acc);
        }
      }
      wmma::store_matrix_sync(Z + nt * 16, acc, ldz, wmma::mem_row_major);
    }
  } else {
    // f32 FMA: each thread owns 4 rows x 4 columns of a 256-column slab
    const int ty = tid / 64, tx = tid % 64;
    for (int c0 = 0; c0 < N; c0 += 256) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = tpp::to_f32(H[(ty * 4 + i) * ldh + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 64 * j;
          const size_t w = transposed ? (size_t)col * K + kk
                                      : (size_t)kk * N + col;
          b[j] = col < N ? tpp::to_f32(W[w]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 64 * j;
          if (col < N) Z[(ty * 4 + i) * ldz + col] = acc[i][j];
        }
    }
  }
}

template <typename Tin, typename Tmma>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const Tin* __restrict__ x, void* __restrict__ out, int m,
             ChainParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = p.dmax + HPAD, ldz = p.dmax + ZPAD;
  Tmma* H = reinterpret_cast<Tmma*>(smem);  // layer input, MXU dtype
  float* Z = reinterpret_cast<float*>(
      smem + align128((size_t)CBM * ldh * sizeof(Tmma)));  // layer output
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * CBM;

  const int d0 = p.dims[0];
  for (int i = tid; i < CBM * d0; i += THREADS) {
    const int r = i / d0, c = i % d0;
    const float v =
        (r0 + r < m) ? tpp::to_f32(x[(size_t)(r0 + r) * d0 + c]) : 0.f;
    H[r * ldh + c] = tpp::from_f32<Tmma>(v);
  }
  __syncthreads();

  const int dl = p.dims[p.L];
  // B5: the repeat whose forward state is the output
  const int last_fwd = (p.repeats - 1) % 2 ? p.repeats - 2 : p.repeats - 1;
  for (int rep = 0; rep < p.repeats; ++rep) {
    if (p.pingpong && rep % 2) {
      // B5's backward step: h = hn W^T, no bias, no activation
      const int K = p.dims[0], N = p.dims[1];
      block_product(H, ldh, Z, ldz, static_cast<const Tmma*>(p.w[0]), N, K,
                    true);
      __syncthreads();
      for (int i = tid; i < CBM * K; i += THREADS) {
        const int r = i / K, c = i % K;
        H[r * ldh + c] = tpp::from_f32<Tmma>(Z[r * ldz + c]);
      }
      __syncthreads();
      continue;
    }
    for (int li = 0; li < p.L; ++li) {
      const int K = p.dims[li], N = p.dims[li + 1];
      block_product(H, ldh, Z, ldz, static_cast<const Tmma*>(p.w[li]), K, N,
                    false);
      __syncthreads();
      // bias + activation in f32; the next layer's input in the MXU dtype
      const void* bias = p.bias[li];
      const int act = li < p.L - 1 ? p.unary : p.last_unary;
      for (int i = tid; i < CBM * N; i += THREADS) {
        const int r = i / N, c = i % N;
        float v = Z[r * ldz + c];
        if (bias) v += tpp::load_any(bias, c, p.bias_dtype[li]);
        v = tpp::apply_unary(act, v);
        Z[r * ldz + c] = v;
        H[r * ldh + c] = tpp::from_f32<Tmma>(v);
      }
      __syncthreads();
    }
    if (p.pingpong && rep == last_fwd) {
      for (int i = tid; i < CBM * dl; i += THREADS) {
        const int r = i / dl, c = i % dl;
        if (r0 + r < m)
          tpp::store_any(out, (size_t)(r0 + r) * dl + c, p.out_dtype,
                         tpp::to_f32(H[r * ldh + c]));
      }
    }
  }
  if (p.pingpong) return;

  for (int i = tid; i < CBM * dl; i += THREADS) {
    const int r = i / dl, c = i % dl;
    if (r0 + r >= m) continue;
    const float v = p.round_out ? tpp::to_f32(H[r * ldh + c]) : Z[r * ldz + c];
    tpp::store_any(out, (size_t)(r0 + r) * dl + c, p.out_dtype, v);
  }
}

template <typename Tin, typename Tmma>
int launch(const void* x, void* out, int m, const ChainParams& p,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<Tmma>(p.dmax);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<Tin, Tmma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + CBM - 1) / CBM);
  chain_kernel<Tin, Tmma><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), out, m, p);
  return static_cast<int>(cudaGetLastError());
}

// The chain on the warm-panel engine: one step a layer (B3, B4), or B5's
// forward (hn = act(h W + b)) and backward (h = hn W^T) steps; B5 stops at
// its last forward step, whose hn is the output (the steps after it are
// dead).
int run_panel(const void* x, void* out, const ChainParams& c, int in_dtype,
              int mma_dtype, const int* plan, cudaStream_t st) {
  namespace wm = tpp::warm;
  wm::Params p{};
  const int L = c.L;
  if (c.pingpong) {
    const int K = c.dims[0], N = c.dims[1];
    p.steps[0] = {c.bias[0], K, N, 1, 0, 0,
                  c.bias[0] ? tpp::kAdd : tpp::kBinNone, c.last_unary,
                  c.bias_dtype[0]};
    p.steps[1] = {nullptr, N, K, 0, 0, 0, tpp::kBinNone, tpp::kIdentity,
                  tpp::kF32};
    p.period = 2;
    p.total = (c.repeats - 1) % 2 ? c.repeats - 1 : c.repeats;
    p.onb = N;
  } else {
    for (int i = 0; i < L; ++i)
      p.steps[i] = {c.bias[i], c.dims[i], c.dims[i + 1], 1, i, 0,
                    c.bias[i] ? tpp::kAdd : tpp::kBinNone,
                    i < L - 1 ? c.unary : c.last_unary, c.bias_dtype[i]};
    p.period = L;
    p.total = c.repeats * L;
    p.onb = c.dims[L];
  }
  for (int i = 0; i < L; ++i) p.w[i] = c.w[i];
  p.x = x;
  p.out = out;
  p.groups = 1;
  p.mb = c.m;
  p.xkb = c.dims[0];
  p.x_dtype = in_dtype;
  p.w_dtype = mma_dtype;     // the wrapper casts the weights to it
  p.out_dtype = c.out_dtype;
  p.round_out = c.pingpong ? 1 : c.round_out;
  const wm::Plan pl{plan[0], plan[1], plan[2], plan[3]};
  return mma_dtype == tpp::kF16 ? wm::run_f16(p, pl, st)
                                : wm::run(p, pl, st);
}

}  // namespace

// Shared-memory bytes the kernel asks for at width dmax; the pipeline's
// chain_fits_smem gate mirrors this formula.
extern "C" long long tpp_chain_smem_bytes(int dmax, int mma_dtype) {
  return mma_dtype == tpp::kBF16
             ? static_cast<long long>(smem_bytes<__nv_bfloat16>(dmax))
         : mma_dtype == tpp::kF16
             ? static_cast<long long>(smem_bytes<__half>(dmax))
             : static_cast<long long>(smem_bytes<float>(dmax));
}

// Returns the cudaError_t of the launch (0 on success). w_ptrs/b_ptrs are
// host arrays of L device pointers (weights in the MXU dtype, biases in
// the types of the host array b_dtypes: f32, bf16 or f16); dims is a host
// array of L+1 ints. out is out_dtype (f32, bf16 or f16: one rounding of
// the f32 output, or of the state in the MXU dtype where round_out is set,
// B4 and B5, as the reference's bodies cast). Every dim must be a multiple of 16.
// pingpong (B5) needs L == 1 and repeats > 1. plan, when not null, is
// reference.warm_plan's (rows, cluster, resident, shared-memory bytes):
// the warm-panel engine runs the chain (16-bit products: bf16, or f16 for
// f16 x and weights; 16-byte aligned weights where they stream); null runs
// the first design.
extern "C" int tpp_chain(const void* x, void* out, const void* const* w_ptrs,
                         const void* const* b_ptrs, const int* b_dtypes,
                         const int* dims, int L,
                         int m, int in_dtype, int mma_dtype, int out_dtype,
                         int has_bias, int unary, int last_unary, int repeats,
                         int round_out, int pingpong, const int* plan,
                         void* stream) {
  if (L < 1 || L > MAXL || (pingpong && (L != 1 || repeats < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  ChainParams p{};
  p.L = L;
  p.dmax = 0;
  for (int i = 0; i <= L; ++i) {
    if (dims[i] <= 0 || dims[i] % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    p.dims[i] = dims[i];
    p.dmax = dims[i] > p.dmax ? dims[i] : p.dmax;
  }
  for (int i = 0; i < L; ++i) {
    p.w[i] = w_ptrs[i];
    p.bias[i] = has_bias ? b_ptrs[i] : nullptr;
    p.bias_dtype[i] = has_bias ? b_dtypes[i] : tpp::kF32;
    if (!tpp::epilogue_dtypes_ok(p.bias_dtype[i]))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!tpp::epilogue_dtypes_ok(out_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  p.unary = unary;
  p.last_unary = last_unary;
  p.repeats = repeats < 1 ? 1 : repeats;
  p.round_out = round_out;
  p.out_dtype = out_dtype;
  p.pingpong = pingpong;
  p.m = m;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan != nullptr)
    return mma_dtype == tpp::kBF16 ||
                   (mma_dtype == tpp::kF16 && in_dtype == tpp::kF16)
               ? run_panel(x, out, p, in_dtype, mma_dtype, plan, st)
               : static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kF32)
    return launch<float, float>(x, out, m, p, st);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kBF16)
    return launch<float, __nv_bfloat16>(x, out, m, p, st);
  if (in_dtype == tpp::kBF16 && mma_dtype == tpp::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, out, m, p, st);
  if (in_dtype == tpp::kF16 && mma_dtype == tpp::kF16)
    return launch<__half, __half>(x, out, m, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaOccupancyMaxActiveClusters for the warm-panel engine (csrc/
// warm_panel.cuh) at rows x cluster with `smem` bytes of dynamic shared
// memory a block: the clusters the card holds at once, into *n
extern "C" int tpp_warm_max_clusters(int rows, int cluster, int smem,
                                     int* n) {
  return tpp::warm::max_clusters(rows, cluster, smem, n);
}
