// Packed-layout (blocked) matmul for Hopper (sm_90a), packed parity mode.
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:763 _build_blocked_matmul (B19) and
// :870 _build_blocked_matmul_warm (B20):
//   B19: out[i,j] = unary( (C[i,j] if has_c) + sum_{r<Kb} A[i,r] @ B[j,r]
//                          OP bias[j] )
//   with A [Mb,Kb,mb,kb], B [Nb,Kb,kb,nb] (or VNNI [Nb,Kb,kb/v,nb,v]),
//   C and out [Mb,Nb,mb,nb], bias [Nb,nb] added along the columns;
//   B20: `repeats` applications of B19 (beta_0, Nb == Kb, nb == kb), each
//   output held in the MXU dtype and fed back as the next packed
//   activation; the output is written once, after the last repeat.
//
// VNNI: element (k, n) of a packed B block lives at
// (k - k % v) * nb + n * v + k % v, so a VNNI2 operand is read in place,
// the two k values of one n that VNNI pairs next to each other; no
// un-VNNI pass runs (the TPU wrapper un-VNNIs outside its kernel,
// kernels.py:772-779).
//
// What bounds them on the H100: at the fc rows' key (Mb 1, Nb = Kb = 2,
// mb 256, nb = kb = 512) B19 is a 256 x 1024 x 1024 GEMM: 0.54 GFLOP over
// 6 MB in f32, so the bytes bound it (1.8 us at 3.35 TB/s against 0.54 us
// of tensor-core work at 989 TFLOP/s bf16). B19 is the packed GEMM of
// csrc/gemm_sm90.cuh, the mainloop B1 runs: 4D tensor maps (k within the
// block, row, r, block) whose out-of-bounds zero fill masks a partial
// block such as mb 8, or the convert loader (f32 "default", VNNI B re-laid
// in registers as an MN-major tile, strides TMA cannot take), wgmma with
// register accumulators, the output and C addressed through the packed
// layout from registers, and a deterministic k split where the tiles do not
// fill the card (xsmm/reference.py blocked_matmul_route names the loader).
// f32 at precision "highest" keeps the f32-FMA body below, never TF32.
//
// B20: rows are independent (next[i,:] needs only act[i,:], the
// reference's note at kernels.py:917-918), so a row panel of one Mb tile is
// carried through every repeat inside one launch, with no grid-wide sync.
// bf16 products run on the warm-panel engine (csrc/warm_panel.cuh), the
// same code as csrc/chain.cu's B3/B4/B5: a cluster of blocks shares the
// panel (P rows), each block owns 64-column tiles of the output (wgmma with
// the batch rows as N) and the repeat's output is exchanged through
// distributed shared memory. The weight stays resident, as the TPU kernel
// holds it in VMEM: each block loads its columns' slices once, through
// registers, read in place through the packed (or VNNI) layout and rounded
// to bf16 there, so no conversion runs on the repeat loop. At the fc key
// (K = N = 1024) a block's 64 columns are 128 KB beside a 32-row panel of
// 64 KB. The plan is xsmm/reference.py warm_plan's, the route warm_route's.
// The first design below (one block per 16-row panel, ping-ponged between
// two buffers in the MXU dtype, the weight re-read from L2 every repeat
// through each warp's staging, WMMA, or f32 FMA) serves f32 "highest"
// (route "fma") and any key the plan cannot take (route "wmma");
// blocked_warm_fits_smem in xsmm/kernels.py mirrors its warm_smem_bytes()
// below: chain.cu's panel (16 rows of K + 8) and WARM_STAGING_BYTES, which
// the static_asserts pin, so the engine admits no key the gate did not.
// The VNNI factor (1 or 2) is a template argument, so the packed offsets
// compile to shifts.
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"
#include "gemm_sm90.cuh"
#include "warm_panel.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int APAD = 8, BPAD = 8, CPAD = 4;
// B20: panel rows, panel row padding, the k rows a warp stages at once,
// per-warp staging strides
constexpr int WBM = 16, WARPS = THREADS / 32, HPAD = 8, WKS = 64, BSLD = 24,
              CSLD = 20;
static_assert(WBM == 16 && HPAD == 8,
              "xsmm/kernels.py sizes B20's panel as chain.cu's CBM/HPAD");
static_assert(WARPS * (WKS * BSLD * 2 + 16 * CSLD * 4) == 34816,
              "xsmm/kernels.py WARM_STAGING_BYTES mirrors the staging");

struct Blocked {
  int Mb, Nb, Kb, mb, nb, kb;
};

struct Epilogue {
  int has_c, c_dtype, binary, d_dtype, unary, out_dtype;
};

// offset of element (k, n) inside one packed B block [kb/V, nb, V]; with
// V | kb it is also the offset inside a whole Nb slab [Kb, kb/V, nb, V]
template <int V>
__device__ __forceinline__ size_t b_off(int k, int n, int nb) {
  return (size_t)(k - k % V) * nb + (size_t)n * V + k % V;
}

// B19 at f32 "highest": f32 FMA, one 64 x 64 output tile of one (i, j)
// block per block, reduced over (r, 32-deep k steps) through shared memory
template <int V>
__global__ void __launch_bounds__(THREADS)
blocked_matmul_fma_kernel(const float* __restrict__ A,
                          const float* __restrict__ B,
                          const void* __restrict__ C,
                          const void* __restrict__ D, void* __restrict__ out,
                          Blocked g, Epilogue epi) {
  __shared__ __align__(128) float As[BM][BK + APAD];
  __shared__ __align__(128) float Bs[BK][BN + BPAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];

  const int tid = threadIdx.x;
  const int tiles_n = (g.nb + BN - 1) / BN, tiles_m = (g.mb + BM - 1) / BM;
  const int j = blockIdx.x / tiles_n, n0 = (blockIdx.x % tiles_n) * BN;
  const int i = blockIdx.y / tiles_m, m0 = (blockIdx.y % tiles_m) * BM;
  const int ty = tid / 16, tx = tid % 16;  // 4x4 outputs per thread

  float facc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) facc[a][b] = 0.f;

  for (int r = 0; r < g.Kb; ++r) {
    const float* Ar = A + ((size_t)i * g.Kb + r) * g.mb * g.kb;
    const float* Br = B + ((size_t)j * g.Kb + r) * g.kb * g.nb;
    for (int k0 = 0; k0 < g.kb; k0 += BK) {
      // stage A[i,r][m0:, k0:] and B[j,r][k0:, n0:], zero past the block's
      // edges
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int rr = e / BK, cc = e % BK;
        const int gm = m0 + rr, gk = k0 + cc;
        As[rr][cc] = (gm < g.mb && gk < g.kb) ? Ar[(size_t)gm * g.kb + gk]
                                              : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int rr = e / BN, cc = e % BN;
        const int gk = k0 + rr, gn = n0 + cc;
        Bs[rr][cc] = (gk < g.kb && gn < g.nb) ? Br[b_off<V>(gk, gn, g.nb)]
                                              : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] = As[ty + 16 * q][kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = Bs[kk][tx + 16 * q];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) facc[p][q] = fmaf(a[p], b[q], facc[p][q]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) Cs[ty + 16 * p][tx + 16 * q] = facc[p][q];
  __syncthreads();

  for (int e = tid; e < BM * BN; e += THREADS) {
    const int rr = e / BN, cc = e % BN;
    const int gm = m0 + rr, gn = n0 + cc;
    if (gm >= g.mb || gn >= g.nb) continue;
    const size_t o = (((size_t)i * g.Nb + j) * g.mb + gm) * g.nb + gn;
    float v = Cs[rr][cc];
    if (epi.has_c) v += tpp::sm90::ld_f32(C, o, epi.c_dtype);
    if (epi.binary != tpp::kBinNone)
      v = tpp::apply_binary(
          epi.binary, v,
          tpp::sm90::ld_f32(D, (size_t)j * g.nb + gn, epi.d_dtype));
    tpp::store_out(out, o, epi.out_dtype, tpp::apply_unary(epi.unary, v));
  }
}

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// B20's dynamic shared memory: two panels of WBM x (K + HPAD) in the MXU
// dtype, plus each warp's weight tile and f32 output tile on the tensor
// path
template <typename Tmma>
__host__ __device__ inline size_t warm_smem_bytes(int K) {
  const size_t panels = align128(2 * (size_t)WBM * (K + HPAD) * sizeof(Tmma));
  if (std::is_same<Tmma, __nv_bfloat16>::value)
    return panels + (size_t)WARPS * (WKS * BSLD * sizeof(Tmma) +
                                     16 * CSLD * sizeof(float));
  return panels;
}

// nxt[:, :N] = epilogue(cur[:, :K] @ W) for the block's WBM rows, W read
// through the packed layout: element (k, n) of B is at
// (n / nb) * K * nb + b_off<V>(k, n % nb) (V | kb)
template <typename Tin, typename Tmma, int V>
__device__ void warm_step(const Tmma* cur, Tmma* nxt, int ldh,
                          const Tin* __restrict__ W,
                          const float* __restrict__ D, const Blocked& g,
                          int binary, int unary, unsigned char* scratch) {
  constexpr bool kTensor = std::is_same<Tmma, __nv_bfloat16>::value;
  const int K = g.Kb * g.kb, N = g.Nb * g.nb;
  const size_t jstride = (size_t)K * g.nb;  // elements of one Nb slab
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if constexpr (kTensor) {
    Tmma* Bw = reinterpret_cast<Tmma*>(scratch) + (size_t)warp * WKS * BSLD;
    float* Cw = reinterpret_cast<float*>(scratch +
                                         (size_t)WARPS * WKS * BSLD *
                                             sizeof(Tmma)) +
                (size_t)warp * 16 * CSLD;
    // the strip of k rows [k0, k0 + WKS) x the warp's 16 columns is WKS / V
    // memory rows of 16 * V contiguous elements (a VNNI row holds a k pair
    // side by side), read as 16-byte vectors: VE elements each, 32 / VE a
    // lane, all in flight before the first product (nb % 16 == 0 keeps the
    // 16 columns inside one Nb block and the vectors aligned)
    constexpr int VE = 16 / sizeof(Tin), L = 16 * V, PER_LANE = 32 / VE;
    for (int nt = warp; nt < N / 16; nt += WARPS) {
      const int n = nt * 16, jb = n / g.nb;
      const Tin* col = W + jb * jstride + (size_t)(n - jb * g.nb) * V;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < K; k0 += WKS) {
        const int kn = min(WKS, K - k0);  // a multiple of 16
        uint4 vec[PER_LANE];
#pragma unroll
        for (int u = 0; u < PER_LANE; ++u) {
          const int id = lane + 32 * u, mr = id / (L / VE);
          if (mr * V < kn)
            vec[u] = *reinterpret_cast<const uint4*>(
                col + (size_t)(k0 + mr * V) * g.nb + (id % (L / VE)) * VE);
        }
#pragma unroll
        for (int u = 0; u < PER_LANE; ++u) {
          const int id = lane + 32 * u, mr = id / (L / VE);
          if (mr * V >= kn) continue;
          const Tin* x = reinterpret_cast<const Tin*>(&vec[u]);
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            const int el = (id % (L / VE)) * VE + e;  // element of the row
            Bw[(mr * V + el % V) * BSLD + el / V] =
                tpp::from_f32<Tmma>(tpp::to_f32(x[e]));
          }
        }
        __syncwarp();
        for (int kk = 0; kk < kn; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fa, cur + k0 + kk, ldh);
          wmma::load_matrix_sync(fb, Bw + kk * BSLD, BSLD);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        __syncwarp();
      }
      wmma::store_matrix_sync(Cw, acc, CSLD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane + 32 * t, rr = e / 16, c = e % 16;
        const int col_n = nt * 16 + c;
        float v = Cw[rr * CSLD + c];
        if (binary != tpp::kBinNone)
          v = tpp::apply_binary(binary, v, D[col_n]);
        nxt[rr * ldh + col_n] =
            tpp::from_f32<Tmma>(tpp::apply_unary(unary, v));
      }
      __syncwarp();
    }
  } else {
    // f32 FMA: each thread owns 4 rows x 4 columns of a 256-column slab
    const int ty = tid / 64, tx = tid % 64;
    for (int c0 = 0; c0 < N; c0 += 256) {
      float acc[4][4];
      size_t base[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = min(c0 + tx + 64 * q, N - 1), jb = n / g.nb;
        base[q] = jb * jstride + (size_t)(n - jb * g.nb) * V;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      for (int k = 0; k < K; ++k) {
        const size_t koff = (size_t)(k - k % V) * g.nb + k % V;
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = tpp::to_f32(cur[(ty * 4 + r) * ldh + k]);
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = tpp::to_f32(W[base[q] + koff]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = c0 + tx + 64 * q;
        if (n >= N) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = acc[r][q];
          if (binary != tpp::kBinNone) v = tpp::apply_binary(binary, v, D[n]);
          nxt[(ty * 4 + r) * ldh + n] =
              tpp::from_f32<Tmma>(tpp::apply_unary(unary, v));
        }
      }
    }
  }
}

template <typename Tin, typename Tmma, int V>
__global__ void __launch_bounds__(THREADS)
blocked_warm_kernel(const Tin* __restrict__ A, const Tin* __restrict__ W,
                    const float* __restrict__ D, void* __restrict__ out,
                    Blocked g, int binary, int unary, int repeats,
                    int out_dtype) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = g.Kb * g.kb, N = g.Nb * g.nb;
  const int ldh = K + HPAD;
  Tmma* cur = reinterpret_cast<Tmma*>(smem);
  Tmma* nxt = cur + (size_t)WBM * ldh;
  unsigned char* scratch =
      smem + align128(2 * (size_t)WBM * ldh * sizeof(Tmma));
  const int panels = (g.mb + WBM - 1) / WBM;
  const int i = blockIdx.x / panels, r0 = (blockIdx.x % panels) * WBM;
  const int tid = threadIdx.x;

  // the panel's rows of A[i, :], all K columns, in the MXU dtype
  for (int e = tid; e < WBM * K; e += THREADS) {
    const int rr = e / K, k = e % K, rb = k / g.kb, gm = r0 + rr;
    const float v =
        gm < g.mb ? tpp::to_f32(A[(((size_t)i * g.Kb + rb) * g.mb + gm) *
                                      g.kb +
                                  (k - rb * g.kb)])
                  : 0.f;
    cur[rr * ldh + k] = tpp::from_f32<Tmma>(v);
  }
  __syncthreads();

  for (int rep = 0; rep < repeats; ++rep) {
    warm_step<Tin, Tmma, V>(cur, nxt, ldh, W, D, g, binary, unary, scratch);
    __syncthreads();
    Tmma* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int e = tid; e < WBM * N; e += THREADS) {
    const int rr = e / N, n = e % N, gm = r0 + rr;
    if (gm >= g.mb) continue;
    const int jb = n / g.nb;
    tpp::store_out(out,
                   (((size_t)i * g.Nb + jb) * g.mb + gm) * g.nb +
                       (n - jb * g.nb),
                   out_dtype, tpp::to_f32(cur[rr * ldh + n]));
  }
}

template <typename Tin, typename Tmma, int V>
int launch_warm(const void* a, const void* b, const float* d, void* out,
                Blocked g, int binary, int unary, int repeats, int out_dtype,
                cudaStream_t stream) {
  const size_t smem = warm_smem_bytes<Tmma>(g.Kb * g.kb);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_warm_kernel<Tin, Tmma, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.Mb * ((g.mb + WBM - 1) / WBM));
  blocked_warm_kernel<Tin, Tmma, V><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b), d, out, g,
      binary, unary, repeats, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

// B20 for one dtype pair, the VNNI factor made a template argument so the
// packed offsets compile to shifts
template <typename Tin, typename Tmma>
int run_warm(const void* a, const void* b, const float* d, void* out,
             const Blocked& g, const Epilogue& epi, int vnni, int repeats,
             cudaStream_t st) {
  return vnni == 2
             ? launch_warm<Tin, Tmma, 2>(a, b, d, out, g, epi.binary,
                                         epi.unary, repeats, epi.out_dtype, st)
             : launch_warm<Tin, Tmma, 1>(a, b, d, out, g, epi.binary,
                                         epi.unary, repeats, epi.out_dtype,
                                         st);
}

// B19 on the packed mainloop of csrc/gemm_sm90.cuh
int run_sm90(const void* a, const void* b, const void* c, const void* d,
             void* out, void* work, const Blocked& bl, const Epilogue& epi,
             int vnni, int in_dtype, int route, const long long* plan,
             cudaStream_t st) {
  namespace sm = tpp::sm90;
  sm::Plan p;
  if (!sm::launch_plan_ok(plan, bl.Mb, bl.Nb, bl.Kb, bl.mb, bl.nb, bl.kb, 0,
                          &p) ||
      (plan[3] > 0 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  sm::Gemm g{};
  g.a = a;
  g.b = b;
  g.c = c;
  g.d = d;
  g.out = out;
  g.work = static_cast<float*>(work);
  g.Mb = bl.Mb;
  g.Nb = bl.Nb;
  g.Kb = bl.Kb;
  g.mb = bl.mb;
  g.nb = bl.nb;
  g.kb = bl.kb;
  g.in_f32 = in_dtype == tpp::kF32;
  const int es = g.in_f32 ? 4 : 2;
  g.vec_a = sm::vec_ok(a, bl.kb, es);
  g.vec_b = sm::vec_ok(b, vnni ? 2LL * bl.nb : bl.nb, es);
  g.vec_c = reinterpret_cast<uintptr_t>(c) % 16 == 0;
  g.vec_d = reinterpret_cast<uintptr_t>(d) % 16 == 0;
  g.has_c = epi.has_c;
  g.c_dtype = epi.c_dtype;
  g.binary = epi.binary;
  g.bcast = tpp::kBcastCol;
  g.d_dtype = epi.d_dtype;
  g.unary = epi.unary;
  g.out_dtype = epi.out_dtype;
  g.split = p.split;
  CUtensorMap amap = {}, bmap = {};
  if (route == tpp::sm90::kRouteTma) {
    if (vnni || in_dtype != tpp::kBF16)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rc = sm::make_maps(&amap, &bmap, g, p, sm::kBMn);
    if (rc) return rc;
    return sm::launch_plan<sm::kBMn, sm::kTma, sm::kLnNone>(p, g, amap, bmap,
                                                            st);
  }
  return vnni ? sm::launch_plan<sm::kBVnni, sm::kConvert, sm::kLnNone>(
                    p, g, amap, bmap, st)
              : sm::launch_plan<sm::kBMn, sm::kConvert, sm::kLnNone>(
                    p, g, amap, bmap, st);
}

// B20 on the warm-panel engine: one step a repeat, the packed operands
// addressed in place, the weight resident
int run_warm_panel(const void* a, const void* b, const float* d, void* out,
                   const Blocked& g, const Epilogue& epi, int vnni,
                   int in_dtype, int repeats, const int* plan,
                   cudaStream_t st) {
  namespace wm = tpp::warm;
  wm::Params p{};
  const int K = g.Kb * g.kb;
  p.steps[0] = {epi.binary ? d : nullptr, K, g.Nb * g.nb, 1, 0, 0,
                epi.binary, epi.unary};
  p.period = 1;
  p.total = repeats;
  p.w[0] = b;
  p.x = a;
  p.out = out;
  p.groups = g.Mb;
  p.mb = g.mb;
  p.xkb = g.kb;
  p.onb = g.nb;
  p.wkb = g.kb;
  p.wnb = g.nb;
  p.wv = vnni ? vnni : 1;
  p.x_dtype = in_dtype;
  p.w_dtype = in_dtype;
  p.out_dtype = epi.out_dtype;
  p.round_out = 1;
  return wm::run(p, wm::Plan{plan[0], plan[1], plan[2], plan[3]}, st);
}

}  // namespace

// Shared-memory bytes B20 asks for at K = Kb * kb; the executor's
// blocked_warm_fits_smem gate mirrors this formula.
extern "C" long long tpp_blocked_warm_smem_bytes(int K, int mma_dtype) {
  return mma_dtype == tpp::kBF16
             ? static_cast<long long>(warm_smem_bytes<__nv_bfloat16>(K))
             : static_cast<long long>(warm_smem_bytes<float>(K));
}

// B19 when repeats == 0, else B20. Returns the cudaError_t of the launch
// (0 on success). A and B are in_dtype (B in VNNI layout when vnni is 2);
// C [Mb,Nb,mb,nb] is c_dtype and the bias D [Nb,nb] d_dtype (f32 or bf16,
// widened in registers; B20 takes an f32 D); out [Mb,Nb,mb,nb] is
// out_dtype. B19's route is xsmm/reference.py blocked_matmul_route's
// choice: 0 "fma" (f32 "highest"), 1 "tma" (bf16, not VNNI; 16-byte
// aligned base pointers and row strides), 2 "convert"; plan is
// tpp_gemm_plan's {bm, bn, split, bytes} for B19 (flags kPlanFma on the
// "fma" route: 64 x 64, no split; gemm_sm90.cuh launch_plan_ok) and work
// its workspace. B20 needs has_c 0, Nb == Kb, nb == kb and, on
// the tensor path, Kb * kb and nb multiples of 16 and B 16-byte aligned;
// warm_plan, when not null, is reference.warm_plan's (rows, cluster,
// resident, shared-memory bytes): B20 runs on the warm-panel engine (bf16
// products), else on the first design.
extern "C" int tpp_blocked_matmul(const void* a, const void* b,
                                  const void* c, const void* d, void* out,
                                  void* work, int Mb, int Nb, int Kb, int mb,
                                  int nb, int kb, int vnni, int in_dtype,
                                  int mma_dtype, int out_dtype, int c_dtype,
                                  int d_dtype, int has_c, int binary,
                                  int unary, int repeats, int route,
                                  const long long* plan,
                                  const int* warm_plan, void* stream) {
  if ((vnni != 0 && vnni != 2) || (vnni && kb % vnni))
    return static_cast<int>(cudaErrorInvalidValue);
  if (repeats > 0 && (has_c || Nb != Kb || nb != kb ||
                      (binary && d_dtype != tpp::kF32) ||
                      (mma_dtype == tpp::kBF16 && ((Kb * kb) % 16 || nb % 16))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Blocked g{Mb, Nb, Kb, mb, nb, kb};
  const Epilogue epi{has_c, c_dtype, binary, d_dtype, unary, out_dtype};
  const float* df = static_cast<const float*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (repeats > 0 && warm_plan != nullptr)
    return mma_dtype == tpp::kBF16
               ? run_warm_panel(a, b, df, out, g, epi, vnni, in_dtype,
                                repeats, warm_plan, st)
               : static_cast<int>(cudaErrorInvalidValue);
  if (repeats > 0) {
    if (in_dtype == tpp::kF32 && mma_dtype == tpp::kF32)
      return run_warm<float, float>(a, b, df, out, g, epi, vnni, repeats, st);
    if (in_dtype == tpp::kF32 && mma_dtype == tpp::kBF16)
      return run_warm<float, __nv_bfloat16>(a, b, df, out, g, epi, vnni,
                                            repeats, st);
    if (in_dtype == tpp::kBF16 && mma_dtype == tpp::kBF16)
      return run_warm<__nv_bfloat16, __nv_bfloat16>(a, b, df, out, g, epi,
                                                    vnni, repeats, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == tpp::sm90::kRouteFma) {
    tpp::sm90::Plan p;
    static_assert(BM == tpp::sm90::kFmaTile && BN == tpp::sm90::kFmaTile,
                  "the FMA body's tile is the plan's");
    if (in_dtype != tpp::kF32 || mma_dtype != tpp::kF32 ||
        !tpp::sm90::launch_plan_ok(plan, Mb, Nb, Kb, mb, nb, kb,
                                   tpp::sm90::kPlanFma, &p))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(g.Nb * ((g.nb + BN - 1) / BN),
                    g.Mb * ((g.mb + BM - 1) / BM));
    const float* af = static_cast<const float*>(a);
    const float* bf = static_cast<const float*>(b);
    if (vnni == 2)
      blocked_matmul_fma_kernel<2><<<grid, THREADS, 0, st>>>(af, bf, c, d,
                                                            out, g, epi);
    else
      blocked_matmul_fma_kernel<1><<<grid, THREADS, 0, st>>>(af, bf, c, d,
                                                            out, g, epi);
    return static_cast<int>(cudaGetLastError());
  }
  if (mma_dtype != tpp::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  return run_sm90(a, b, c, d, out, work, g, epi, vnni, in_dtype, route, plan,
                  st);
}
