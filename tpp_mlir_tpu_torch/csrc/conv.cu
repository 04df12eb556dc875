// Convolution as an implicit GEMM with fused zero padding and a fused
// epilogue, for Hopper (sm_90a), in two layouts.
//
// NHWC (tpp_conv_nhwc) replaces tpp_mlir_tpu/xsmm/kernels.py:2919
// _build_conv_nhwc (B24, the "window" strategy) and :3117
// _build_conv_nhwc_fullrow (B25): the two compute one function and differ
// only in how they lay taps over the TPU's sublanes, so one kernel serves
// both.
//   out[n,p,q,k] = unary( (C if has_c) + sum_{r,s,c} I[n,p+r-pt,q+s-pl,c]
//                                              * W[r,s,c,k]  OP  D )
// stride 1; D is a channel bias [K] (bcast_col) or a full residual
// [N,P,Q,K] (none); every input pixel outside [0,H) x [0,W) reads as zero.
//
// Channel-blocked (tpp_conv_blocked, packed parity mode) replaces :2778
// _build_conv_brgemm (B23): the same function in the NCHW channel-blocked
// layout, I [N,Cb,H,W,c], W [Kb,Cb,R,S,c,k], C and out [N,Kb,P,Q,k], the
// bias [Kb,k]; stride 1 and no padding (packed mode keeps tl.pad as its
// own op). It is the same kernel: the NHWC layout is the blocked one with
// Cb = Kb = 1, so the reduction runs over (cb, r, s, channel tile) and
// each block's output columns lie inside one Kb block.
//
// What bounds it on the H100: at the conv suite's shapes (N 8, C = K = 128
// or 256, 3x3 over 14..30 pixels) the work is 0.4-3.7 GFLOP over a few MB,
// so the tensor cores (989 TFLOP/s bf16) bound it, not HBM. This first
// version reaches neither: it is the GEMM M = N*P*Q output pixels, n = k
// per Kb block, reduced over (cb, r, s, channel tile), one 64-pixel x
// 64-channel output tile per block, staged through shared memory with no
// pipelining (the design of csrc/brgemm.cu). The A tile is gathered from
// the input per tap:
// each of its 64 rows is one output pixel whose input coordinates are
// computed once per block, and the bounds check on (h, w) is the fused
// padding, so no padded copy of the input is ever written (the TPU wrapper
// pads outside its kernel, kernels.py:2937-2952). Neighbouring threads read
// neighbouring channels: coalesced. bf16 products go through WMMA
// (mma.sync 16x16x16, f32 accumulators); f32 at precision "highest" uses
// f32 FMA, so no TF32 is ever involved. The epilogue runs once per output
// element in f32 before the single store. wgmma, TMA and an input tile
// reused across taps are later PRs' work.
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int APAD = 8, BPAD = 8, CPAD = 4;

// Cb/c and Kb/k: the channel blocks and their sizes (NHWC: Cb = Kb = 1)
struct Geometry {
  int N, H, W, Cb, c, Kb, k, R, S, pt, pl, P, Q;
};

struct Epilogue {
  int has_c, binary, bcast, unary, out_dtype;
};

// Tin: dtype of I/W in device memory; Tmma: dtype the products see
// (bf16 -> tensor cores, float -> f32 FMA).
template <typename Tin, typename Tmma>
__global__ void __launch_bounds__(THREADS)
conv_nhwc_kernel(const Tin* __restrict__ I, const Tin* __restrict__ Wt,
                 const float* __restrict__ Cacc, const float* __restrict__ D,
                 void* __restrict__ out, Geometry g, Epilogue epi) {
  constexpr bool kTensor = std::is_same<Tmma, __nv_bfloat16>::value;
  __shared__ __align__(128) Tmma As[BM][BK + APAD];
  __shared__ __align__(128) Tmma Bs[BK][BN + BPAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];
  // per output pixel of the tile: its image and the input coordinates of
  // tap (0, 0); n = -1 past the last pixel
  __shared__ int row_n[BM], row_h[BM], row_w[BM];

  const int tid = threadIdx.x;
  const long long M = (long long)g.N * g.P * g.Q;
  const long long m0 = (long long)blockIdx.x * BM;
  const int tiles_k = (g.k + BN - 1) / BN;
  const int kb = blockIdx.y / tiles_k, n0 = (blockIdx.y % tiles_k) * BN;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;  // tensor path: 16x32 per warp
  const int ty = tid / 16, tx = tid % 16;  // FMA path: 4x4 per thread

  for (int r = tid; r < BM; r += THREADS) {
    const long long gm = m0 + r;
    if (gm < M) {
      const int q = (int)(gm % g.Q);
      const long long t = gm / g.Q;
      row_n[r] = (int)(t / g.P);
      row_h[r] = (int)(t % g.P) - g.pt;
      row_w[r] = q - g.pl;
    } else {
      row_n[r] = -1;
      row_h[r] = row_w[r] = 0;
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  float facc[4][4];
  if constexpr (kTensor) {
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;
  }

  for (int cb = 0; cb < g.Cb; ++cb) {
  for (int rr = 0; rr < g.R; ++rr) {
    for (int ss = 0; ss < g.S; ++ss) {
      const Tin* Wrs =
          Wt + ((((size_t)kb * g.Cb + cb) * g.R + rr) * g.S + ss) * g.c * g.k;
      for (int c0 = 0; c0 < g.c; c0 += BK) {
        // stage the tap's A tile (pixels x channels), zero where the input
        // pixel is padding or the channel is past c, and W[kb, cb, rr,
        // ss]'s tile
        for (int i = tid; i < BM * BK; i += THREADS) {
          const int r = i / BK, c = i % BK;
          const int h = row_h[r] + rr, w = row_w[r] + ss, gc = c0 + c;
          float v = 0.f;
          if (row_n[r] >= 0 && h >= 0 && h < g.H && w >= 0 && w < g.W &&
              gc < g.c)
            v = tpp::to_f32(
                I[((((size_t)row_n[r] * g.Cb + cb) * g.H + h) * g.W + w) *
                      g.c +
                  gc]);
          As[r][c] = tpp::from_f32<Tmma>(v);
        }
        for (int i = tid; i < BK * BN; i += THREADS) {
          const int r = i / BN, c = i % BN;
          const int gc = c0 + r, gn = n0 + c;
          const float v = (gc < g.c && gn < g.k)
                              ? tpp::to_f32(Wrs[(size_t)gc * g.k + gn])
                              : 0.f;
          Bs[r][c] = tpp::from_f32<Tmma>(v);
        }
        __syncthreads();
        if constexpr (kTensor) {
#pragma unroll
          for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa;
            wmma::load_matrix_sync(fa, &As[wr * 16][kk], BK + APAD);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major> fb;
              wmma::load_matrix_sync(fb, &Bs[kk][wc * 32 + j * 16],
                                     BN + BPAD);
              wmma::mma_sync(acc[j], fa, fb, acc[j]);
            }
          }
        } else {
#pragma unroll 8
          for (int kk = 0; kk < BK; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[i] = tpp::to_f32(As[ty + 16 * i][kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              b[j] = tpp::to_f32(Bs[kk][tx + 16 * j]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
          }
        }
        __syncthreads();
      }
    }
  }
  }

  // accumulators -> shared tile, then the epilogue once per element
  if constexpr (kTensor) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wr * 16][wc * 32 + j * 16], acc[j],
                              BN + CPAD, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[ty + 16 * i][tx + 16 * j] = facc[i][j];
  }
  __syncthreads();

  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gn = n0 + c;
    if (row_n[r] < 0 || gn >= g.k) continue;
    const int p = row_h[r] + g.pt, q = row_w[r] + g.pl;
    const size_t o =
        ((((size_t)row_n[r] * g.Kb + kb) * g.P + p) * g.Q + q) * g.k + gn;
    float v = Cs[r][c];
    if (epi.has_c) v += Cacc[o];
    if (epi.binary != tpp::kBinNone)
      v = tpp::apply_binary(
          epi.binary, v,
          epi.bcast == tpp::kBcastCol ? D[(size_t)kb * g.k + gn] : D[o]);
    tpp::store_out(out, o, epi.out_dtype, tpp::apply_unary(epi.unary, v));
  }
}

template <typename Tin, typename Tmma>
void launch(const void* in, const void* w, const float* c, const float* d,
            void* out, Geometry g, Epilogue epi, cudaStream_t stream) {
  const long long M = (long long)g.N * g.P * g.Q;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  g.Kb * ((g.k + BN - 1) / BN));
  conv_nhwc_kernel<Tin, Tmma><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(in), static_cast<const Tin*>(w), c, d, out, g,
      epi);
}

int run(const void* in, const void* w, const void* c, const void* d,
        void* out, const Geometry& g, int in_dtype, int mma_dtype,
        int out_dtype, int has_c, int binary, int bcast, int unary,
        void* stream) {
  if (binary != tpp::kBinNone && bcast != tpp::kBcastCol &&
      bcast != tpp::kBcastNone)
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue epi{has_c, binary, bcast, unary, out_dtype};
  const float* cf = static_cast<const float*>(c);
  const float* df = static_cast<const float*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kF32)
    launch<float, float>(in, w, cf, df, out, g, epi, st);
  else if (in_dtype == tpp::kF32 && mma_dtype == tpp::kBF16)
    launch<float, __nv_bfloat16>(in, w, cf, df, out, g, epi, st);
  else if (in_dtype == tpp::kBF16 && mma_dtype == tpp::kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(in, w, cf, df, out, g, epi, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). I [N,H,W,C] and
// W [R,S,C,K] are in_dtype; C [N,P,Q,K] and D ([K] for bcast 0, bcast_col;
// [N,P,Q,K] for bcast 3, none) are f32 (the wrapper converts them); out
// [N,P,Q,K] is out_dtype. pt/pl are the top and left zero padding; P and Q
// carry the bottom and right padding (P = H + pt + pb - R + 1).
extern "C" int tpp_conv_nhwc(const void* in, const void* w, const void* c,
                             const void* d, void* out, int N, int H, int W,
                             int C, int K, int R, int S, int pt, int pl,
                             int P, int Q, int in_dtype, int mma_dtype,
                             int out_dtype, int has_c, int binary, int bcast,
                             int unary, void* stream) {
  return run(in, w, c, d, out,
             Geometry{N, H, W, 1, C, 1, K, R, S, pt, pl, P, Q}, in_dtype,
             mma_dtype, out_dtype, has_c, binary, bcast, unary, stream);
}

// The channel-blocked layout (B23): I [N,Cb,H,W,cblk] and
// W [Kb,Cb,R,S,cblk,kblk] are in_dtype; C and out are [N,Kb,P,Q,kblk] (C
// f32, out out_dtype); D is the bias [Kb,kblk] (bcast 0) in f32. Stride 1,
// no padding: P = H - R + 1, Q = W - S + 1.
extern "C" int tpp_conv_blocked(const void* in, const void* w,
                                const void* c, const void* d, void* out,
                                int N, int H, int W, int Cb, int cblk,
                                int Kb, int kblk, int R, int S, int P, int Q,
                                int in_dtype, int mma_dtype, int out_dtype,
                                int has_c, int binary, int bcast, int unary,
                                void* stream) {
  if (P != H - R + 1 || Q != W - S + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(in, w, c, d, out,
             Geometry{N, H, W, Cb, cblk, Kb, kblk, R, S, 0, 0, P, Q},
             in_dtype, mma_dtype, out_dtype, has_c, binary, bcast, unary,
             stream);
}
