// Batch-reduce GEMM with a fused epilogue and an optional LayerNorm prologue,
// for Hopper (sm_90a).
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:580 _build_brgemm (B1) and its
// weights-resident variant :243 _build_brgemm_wres (B2), with B2's
// LayerNorm-statistics pair:
//   out = unary( (C if not beta0) + sum_b A'[b] @ B[b]  OP  D )
// with B given as [b,k,n] or, under transpose_b, as [b,n,k]. A VNNI B is
// flattened by the wrapper, as _unvnni does outside the Pallas kernel.
// A' is A, or under the layer_norm prologue (batch 1) each A row normalized
// in f32 with the TPU kernels' one-pass statistics (mean, E[x^2] - mean^2
// over the whole k; kernels.py:688-699), then gamma/beta, then one rounding
// to the MXU dtype -- the LayerNorm output never goes to device memory.
// Under the ln_stats prologue (the consumer; kernels.py:563-572) the
// statistics are operands, a producer's per-row (mean, var), and only
// rstd = 1/sqrt(var + eps) is taken from them (ln_stats_rstd, m values)
// before the same normalization. ln_stats_out (the producer;
// kernels.py:456-467) adds two (m, 1) f32 results, the mean and the one-pass
// variance (s2/n - mean^2) of each row of the stored (cast) output: each
// output tile's epilogue writes its rows' (sum, sum of squares) over its
// columns to a workspace (gemm_sm90.cuh epilogue_rows; the FMA body below),
// and ln_stats_finish adds a row's tile partials in column-tile order. No
// atomics, and no k split under ln_stats_out (the split's epilogue is an
// elementwise pass), so the statistics are the same bits at every launch.
// Both forms are batch 1, flat, no transpose_b, as the TPU's
// weights-resident kernel takes them (the wrapper refuses the rest).
//
// What bounds it on the H100: at the slice's shapes (m = 256..2048,
// n = 352..50304, k = 352..4096) a GEMM is compute-bound on the tensor
// cores (989 TFLOP/s bf16) once its operands are re-read from shared memory
// enough; at the MLP's fc key (256 x 1024 x 1024 f32, 0.54 GFLOP over 6 MB)
// the bytes bound it (0.0019 ms). The kernel is the packed GEMM of
// csrc/gemm_sm90.cuh with Mb = Nb = 1 (Kb = the batch): a ring of TMA (bf16)
// or register-converted (f32 "default", strides TMA cannot take) stages,
// wgmma with register accumulators, the epilogue from registers, and a
// deterministic k split where the output tiles do not fill the card
// (xsmm/reference.py brgemm_route names the loader; gemm_plan the tile).
// The LayerNorm prologue's row statistics come from a small pass once a
// row (ln_stats below), not from each block: a block's own pass would read
// its A rows once for every column tile (18 times at GPT-2's QKV, 55 MB
// from L2 against 3 MB once). Each consumer warpgroup then normalizes its
// raw A rows of a stage in place before the stage's products (the convert
// loader normalizes as it loads). f32 at precision "highest"
// keeps the f32-FMA body below (no TF32 anywhere).
#include "epilogue.cuh"
#include "gemm_sm90.cuh"

namespace {

namespace sm = tpp::sm90;

// ---- f32 "highest": f32 FMA, one 64 x 64 tile per block ----------------

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int APAD = 8, BPAD = 8, CPAD = 4;

struct Epilogue {
  int has_c, c_dtype, binary, bcast, d_dtype, unary, out_dtype;
};

// LayerNorm prologue: ln = 0 (none) or 1; gamma/beta f32 [k] or null;
// stats: the rows' (mean, rstd), or null to take them from A here.
struct Prologue {
  int ln;
  float eps;
  const float* gamma;
  const float* beta;
  const float2* stats;
};

__global__ void __launch_bounds__(THREADS)
brgemm_fma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const void* __restrict__ C, const void* __restrict__ D,
                  void* __restrict__ out, int batch, int m, int n, int k,
                  int transpose_b, Epilogue epi, Prologue pro,
                  float2* __restrict__ rowpart) {
  __shared__ __align__(128) float As[BM][BK + APAD];
  __shared__ __align__(128) float Bs[BK][BN + BPAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];
  __shared__ float mu_s[BM], rstd_s[BM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = tid / 32;
  const int ty = tid / 16, tx = tid % 16;  // 4x4 outputs per thread

  const int lane = tid % 32;
  if (pro.ln && pro.stats != nullptr) {
    for (int r = tid; r < BM; r += THREADS) {
      const float2 st =
          m0 + r < m ? pro.stats[m0 + r] : make_float2(0.f, 0.f);
      mu_s[r] = st.x;
      rstd_s[r] = st.y;
    }
    __syncthreads();
  } else if (pro.ln) {
    // per-row mean and 1/sqrt(var + eps) over the whole k (batch is 1):
    // one warp per row, f32 sums of x and x^2
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int gm = m0 + r;
      float s = 0.f, s2 = 0.f;
      if (gm < m)
        for (int c = lane; c < k; c += 32) {
          const float v = A[(size_t)gm * k + c];
          s += v;
          s2 += v * v;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (lane == 0) {
        const float mu = s / k;
        mu_s[r] = mu;
        rstd_s[r] = 1.f / sqrtf(s2 / k - mu * mu + pro.eps);
      }
    }
    __syncthreads();
  }

  float facc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;

  for (int bi = 0; bi < batch; ++bi) {
    const float* Ab = A + (size_t)bi * m * k;
    const float* Bb = B + (size_t)bi * k * n;
    for (int k0 = 0; k0 < k; k0 += BK) {
      // stage A[m0:m0+BM, k0:k0+BK] and B[k0:k0+BK, n0:n0+BN], zero outside
      // the matrix (ragged edges)
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i % BK;
        const int gm = m0 + r, gk = k0 + c;
        float v = (gm < m && gk < k) ? Ab[(size_t)gm * k + gk] : 0.f;
        if (pro.ln && gm < m && gk < k) {
          v = (v - mu_s[r]) * rstd_s[r];
          if (pro.gamma != nullptr) v = v * pro.gamma[gk] + pro.beta[gk];
        }
        As[r][c] = v;
      }
      if (transpose_b) {  // B[b] is [n, k]: walk k fastest
        for (int i = tid; i < BK * BN; i += THREADS) {
          const int c = i / BK, r = i % BK;
          const int gk = k0 + r, gn = n0 + c;
          Bs[r][c] = (gk < k && gn < n) ? Bb[(size_t)gn * k + gk] : 0.f;
        }
      } else {
        for (int i = tid; i < BK * BN; i += THREADS) {
          const int r = i / BN, c = i % BN;
          const int gk = k0 + r, gn = n0 + c;
          Bs[r][c] = (gk < k && gn < n) ? Bb[(size_t)gk * n + gn] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[ty + 16 * i][tx + 16 * j] = facc[i][j];
  __syncthreads();

  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= m || gn >= n) {
      if (rowpart != nullptr) Cs[r][c] = 0.f;
      continue;
    }
    const size_t o = (size_t)gm * n + gn;
    float v = Cs[r][c];
    if (epi.has_c) v += sm::ld_f32(C, o, epi.c_dtype);
    if (epi.binary != tpp::kBinNone) {
      size_t di;
      switch (epi.bcast) {
        case tpp::kBcastCol: di = gn; break;
        case tpp::kBcastRow: di = gm; break;
        case tpp::kBcastScalar: di = 0; break;
        default: di = o; break;
      }
      v = tpp::apply_binary(epi.binary, v, sm::ld_f32(D, di, epi.d_dtype));
    }
    v = tpp::apply_unary(epi.unary, v);
    tpp::store_out(out, o, epi.out_dtype, v);
    // each element of Cs is this thread's alone: it keeps the stored value
    if (rowpart != nullptr) Cs[r][c] = tpp::round_out(epi.out_dtype, v);
  }
  if (rowpart == nullptr) return;
  // ln_stats_out: each row's (sum, sum of squares) over this tile's 64
  // columns, one warp a row, in a fixed order
  __syncthreads();
  for (int r = warp; r < BM; r += THREADS / 32) {
    const float a = Cs[r][lane], b = Cs[r][lane + 32];
    float s1 = a + b, s2 = a * a + b * b;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0 && m0 + r < m)
      rowpart[(size_t)blockIdx.x * m + m0 + r] = make_float2(s1, s2);
  }
}

// ---- the LayerNorm prologue's statistics -------------------------------

// (mean, 1/sqrt(E[x^2] - mean^2 + eps)) of each of the m rows of A (m x k,
// f32 or bf16), f32 sums: one warp a row
__global__ void __launch_bounds__(256)
ln_stats(const void* __restrict__ A, float2* __restrict__ stats, int m, int k,
         int in_f32, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= m) return;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < k; c += 32) {
    const float v =
        sm::ld_f32(A, (size_t)row * k + c, in_f32 ? tpp::kF32 : tpp::kBF16);
    s += v;
    s2 += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (lane == 0) {
    const float mu = s / k;
    stats[row] = make_float2(mu, 1.f / sqrtf(s2 / k - mu * mu + eps));
  }
}

// The ln_stats prologue's (mean, rstd) of each of the m rows from the
// producer's (mean, var): rstd = 1/sqrt(var + eps), as ln_stats takes it
__global__ void __launch_bounds__(256)
ln_stats_rstd(const float* __restrict__ mu, const float* __restrict__ var,
              float2* __restrict__ stats, int m, float eps) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < m) stats[row] = make_float2(mu[row], 1.f / sqrtf(var[row] + eps));
}

// ln_stats_out's results from the tile partials [tiles][m] (sum, sum of
// squares of a row's stored values): added in tile order, then mean = s1/n
// and var = s2/n - mean^2 (kernels.py:456-467)
__global__ void __launch_bounds__(256)
ln_stats_finish(const float2* __restrict__ part, int tiles, int m, int n,
                float* __restrict__ mu, float* __restrict__ var) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  float s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const float2 v = part[(size_t)t * m + row];
    s1 += v.x;
    s2 += v.y;
  }
  const float u = s1 / n;
  mu[row] = u;
  var[row] = s2 / n - u * u;
}

// ---- the packed mainloop at Mb = Nb = 1 ---------------------------------

int run_sm90(const sm::Plan& p, const sm::Gemm& g, int transpose_b,
             int route, int ln, cudaStream_t st) {
  CUtensorMap amap = {}, bmap = {};
  if (route == sm::kRouteTma) {
    const int rc = sm::make_maps(&amap, &bmap, g, p,
                                 transpose_b ? sm::kBK : sm::kBMn);
    if (rc) return rc;
    if (ln) return sm::launch_plan<sm::kBMn, sm::kTma, sm::kLnSmem>(
        p, g, amap, bmap, st);
    return transpose_b
               ? sm::launch_plan<sm::kBK, sm::kTma, sm::kLnNone>(p, g, amap,
                                                                 bmap, st)
               : sm::launch_plan<sm::kBMn, sm::kTma, sm::kLnNone>(p, g, amap,
                                                                  bmap, st);
  }
  if (ln)
    return sm::launch_plan<sm::kBMn, sm::kConvert, sm::kLnLoad>(p, g, amap,
                                                                bmap, st);
  return transpose_b
             ? sm::launch_plan<sm::kBK, sm::kConvert, sm::kLnNone>(
                   p, g, amap, bmap, st)
             : sm::launch_plan<sm::kBMn, sm::kConvert, sm::kLnNone>(
                   p, g, amap, bmap, st);
}

}  // namespace

// The plan of the packed mainloop (csrc/gemm_sm90.cuh gemm_plan) for A
// [Mb, Kb, mb, kb] x B [Nb, Kb, kb, nb] on the current device, and the
// workspace its launch needs: plan = {tile rows, tile columns, k split,
// workspace bytes}. flags (a brgemm's, Mb = Nb = 1): kPlanLn, a LayerNorm
// prologue of either kind (the (mean, rstd) of the mb rows); kPlanStatsOut,
// ln_stats_out (no k split, and the rows' partials of each column tile);
// kPlanFma, the f32-FMA body (64 x 64 tiles, no split). Returns 0.
enum PlanFlag : int { kPlanLn = 1, kPlanStatsOut = 2, kPlanFma = 4 };

namespace {

sm::Plan brgemm_plan(int Mb, int Nb, int Kb, int mb, int nb, int kb,
                     int flags) {
  if (flags & kPlanFma) return sm::Plan{BM, BN, 1};
  return sm::gemm_plan(Mb, Nb, Kb, mb, nb, kb, (flags & kPlanStatsOut) != 0);
}

size_t brgemm_work(const sm::Plan& p, int Mb, int Nb, int mb, int nb,
                   int flags) {
  return sm::work_bytes(p, Mb, Nb, mb, nb, (flags & kPlanLn) ? Mb * mb : 0,
                        (flags & kPlanStatsOut) ? Mb * mb : 0);
}

}  // namespace

extern "C" int tpp_gemm_plan(int Mb, int Nb, int Kb, int mb, int nb, int kb,
                             int flags, long long* plan) {
  const sm::Plan p = brgemm_plan(Mb, Nb, Kb, mb, nb, kb, flags);
  plan[0] = p.bm;
  plan[1] = p.bn;
  plan[2] = p.split;
  plan[3] = static_cast<long long>(brgemm_work(p, Mb, Nb, mb, nb, flags));
  return 0;
}

// Returns the cudaError_t of the launch (0 on success). A and B are
// in_dtype; C is c_dtype and D d_dtype (f32 or bf16, widened in
// registers); gamma and beta f32; out out_dtype. route is
// xsmm/reference.py brgemm_route's choice: 0 "fma" (f32 "highest"), 1
// "tma" (bf16; 16-byte aligned base pointers and row strides), 2
// "convert". work is tpp_gemm_plan's workspace (null where it is 0 bytes).
// ln = 1 runs the LayerNorm prologue, ln = 2 the ln_stats prologue on the
// f32 (m) mean and var; gamma and beta are null when it has no affine.
// stats_out = 1 also writes the f32 (m) mean_out and var_out of the
// output rows. ln and stats_out need batch 1.
extern "C" int tpp_brgemm(const void* a, const void* b, const void* c,
                          const void* d, void* out, void* work, int batch,
                          int m, int n, int k, int in_dtype, int mma_dtype,
                          int out_dtype, int c_dtype, int d_dtype,
                          int transpose_b, int has_c, int binary, int bcast,
                          int unary, int ln, int route, float eps,
                          const void* gamma, const void* beta,
                          const void* mean, const void* var, int stats_out,
                          void* mean_out, void* var_out, void* stream) {
  if ((ln || stats_out) && batch != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((ln == 2 && (mean == nullptr || var == nullptr)) ||
      (stats_out && (mean_out == nullptr || var_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fma = route == sm::kRouteFma;
  const int flags = (ln ? kPlanLn : 0) | (stats_out ? kPlanStatsOut : 0) |
                    (fma ? kPlanFma : 0);
  const sm::Plan p = brgemm_plan(1, 1, batch, m, n, k, flags);
  if (brgemm_work(p, 1, 1, m, n, flags) > 0 && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // the workspace: split partials, then the rows' (mean, rstd), then the
  // rows' tile partials (brgemm_work's order)
  float2* const ln_rows = reinterpret_cast<float2*>(
      static_cast<unsigned char*>(work) + sm::work_bytes(p, 1, 1, m, n, 0));
  float2* const rowpart = stats_out ? ln_rows + (ln ? m : 0) : nullptr;
  if (ln == 2 || (ln && !fma)) {
    if (ln == 2)
      ln_stats_rstd<<<(m + 255) / 256, 256, 0, st>>>(
          static_cast<const float*>(mean), static_cast<const float*>(var),
          ln_rows, m, eps);
    else
      ln_stats<<<(m + 7) / 8, 256, 0, st>>>(a, ln_rows, m, k,
                                            in_dtype == tpp::kF32, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int rc;
  if (fma) {
    if (in_dtype != tpp::kF32 || mma_dtype != tpp::kF32)
      return static_cast<int>(cudaErrorInvalidValue);
    const Epilogue epi{has_c, c_dtype, binary, bcast, d_dtype, unary,
                       out_dtype};
    const Prologue pro{ln, eps, static_cast<const float*>(gamma),
                       static_cast<const float*>(beta),
                       ln == 2 ? ln_rows : nullptr};
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    brgemm_fma_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), c, d,
        out, batch, m, n, k, transpose_b, epi, pro, rowpart);
    rc = static_cast<int>(cudaGetLastError());
  } else {
    if (mma_dtype != tpp::kBF16 ||
        (route == sm::kRouteTma && in_dtype != tpp::kBF16))
      return static_cast<int>(cudaErrorInvalidValue);
    sm::Gemm g{};
    g.a = a;
    g.b = b;
    g.c = c;
    g.d = d;
    g.out = out;
    g.work = static_cast<float*>(work);
    g.stats = ln ? ln_rows : nullptr;
    g.rowpart = rowpart;
    g.gamma = static_cast<const float*>(gamma);
    g.beta = static_cast<const float*>(beta);
    g.Mb = 1;
    g.Nb = 1;
    g.Kb = batch;
    g.mb = m;
    g.nb = n;
    g.kb = k;
    g.in_f32 = in_dtype == tpp::kF32;
    const int es = g.in_f32 ? 4 : 2;
    g.vec_a = sm::vec_ok(a, k, es);
    g.vec_b = sm::vec_ok(b, transpose_b ? k : n, es);
    g.vec_c = reinterpret_cast<uintptr_t>(c) % 16 == 0;
    g.vec_d = reinterpret_cast<uintptr_t>(d) % 16 == 0;
    g.has_c = has_c;
    g.c_dtype = c_dtype;
    g.binary = binary;
    g.bcast = bcast;
    g.d_dtype = d_dtype;
    g.unary = unary;
    g.out_dtype = out_dtype;
    g.split = p.split;
    rc = run_sm90(p, g, transpose_b, route, ln != 0, st);
  }
  if (rc != 0 || !stats_out) return rc;
  ln_stats_finish<<<(m + 255) / 256, 256, 0, st>>>(
      rowpart, (n + p.bn - 1) / p.bn, m, n, static_cast<float*>(mean_out),
      static_cast<float*>(var_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
