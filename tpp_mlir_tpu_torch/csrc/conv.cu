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
// Cb = Kb = 1.
//
// What bounds it on the H100: at the conv suite's shapes (N 8, C = K = 128
// or 256, 3x3 over 14..30 pixels) the work is 0.4-3.7 GFLOP over a few MB,
// so the tensor cores (989 TFLOP/s bf16) bound it, not HBM; in practice
// the L2 traffic of re-read operand tiles comes first. The kernel is the
// GEMM M = N*P*Q output pixels x n = k (inside one Kb block), reduced over
// (cb, r, s, 64-channel slice), on csrc/gemm_sm90.cuh's pieces:
//   - its consumer loop (consume_ring: 128-byte swizzled stages, wgmma
//     m64n64 / m64n128 with register accumulators, NCW warpgroups of 64
//     rows) and its epilogue (store_tile: through shared memory, C and D
//     read in their stored dtype, one rounding), and its deterministic k
//     split (split_reduce); the tile and split are xsmm/reference.py
//     conv_plan's: one wave of the largest tiles that fill it (L2 re-reads
//     of the operand tiles, not the tensor cores, set the pace);
//   - one producer warpgroup. A stage of A is BM pixel rows x 64 channels
//     of one (cb, tap): each row is one input pixel's contiguous channels,
//     its coordinates computed once per block, and a row outside the image
//     is zeros: that is the fused padding (no padded copy of the input is
//     ever written). Route "tma" (bf16, c and k multiples of 8): A by
//     16-byte cp.async straight into the swizzled layout, a zero source
//     size for padding, and W's [64 c x BN] MN-major tile by TMA (a 3D map
//     whose zero fill masks c and k); STAGES - 2 stages in flight, each
//     made visible to wgmma (wait, proxy fence, arrive) in order. Route
//     "convert" (f32 "default": bf16 products, f32 sums; c and k multiples
//     of 4): A and B by 16-byte cp.async into a staging ring of raw f32
//     stages, RAW - 1 stages in flight while the producer rounds the
//     oldest to bf16 into the swizzled stage (each thread converts what it
//     copied, so its own cp.async wait suffices); no PyTorch conversion of
//     I or W runs per call. TMA's im2col mode is not used: its box walks
//     whole output rows, while a 64-row tile of N*P*Q pixels straddles rows
//     and images, and cp.async's zero fill gives the padding for free.
// The first version's body stays for what the routes above do not take:
// route "fma" (f32 at precision "highest": f32 FMA, no TF32 anywhere) and
// route "wmma" (bf16 products at channel counts the loaders cannot take,
// or forced to time it): one 64 x 64 tile a block staged through shared
// memory with no pipelining, WMMA 16x16x16 or f32 FMA.
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"
#include "gemm_sm90.cuh"

using namespace nvcuda;

namespace {

namespace sm = tpp::sm90;
namespace hw = tpp::hopper;

// the wrappers' route codes (xsmm/kernels.py _CONV_ROUTE_CODE)
enum ConvRoute : int { kRouteFma = 0, kRouteTma = 1, kRouteConvert = 2,
                       kRouteWmma = 3 };

// Cb/c and Kb/k: the channel blocks and their sizes (NHWC: Cb = Kb = 1)
struct Geometry {
  int N, H, W, Cb, c, Kb, k, R, S, pt, pl, P, Q;
};

// ---- the wgmma implicit GEMM -------------------------------------------

// The GEMM's rows are the output pixels i * mb + p (Mb = N images of mb =
// P Q pixels when Kb > 1, so a tile stays in one output block; else one
// block of N P Q pixels); `epi` is the packed GEMM's epilogue over
// [Mb, Nb = Kb, mb, nb = k], which is the output's own layout in both.
struct Conv {
  const void* in;
  const void* w;
  Geometry geo;
  int cpb;           // 64-channel slices of c
  int KT;            // slices of the reduction: Cb R S cpb
  sm::Gemm epi;
};

template <int NCW, int BN, int LOADER>
struct ConvTile {
  static constexpr int BM = 64 * NCW;
  static constexpr int STAGES = LOADER == sm::kTma ? 4 : 3;
  // raw f32 staging slots of the convert route (two where shared memory
  // is short: 128 x 128)
  static constexpr int RAW =
      LOADER == sm::kTma ? 0 : (NCW == 2 && BN == 128 ? 2 : 3);
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = sm::BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // 16-byte bf16 units a producer thread fills a stage
  static constexpr int A_UNITS = BM * 8 / sm::WG;
  static constexpr int B_UNITS = sm::BK * (BN / 8) / sm::WG;
  static constexpr int RAW_STAGE = (A_UNITS + B_UNITS) * sm::WG * 32;
  static constexpr int raw_off = STAGES * STAGE;
  static constexpr int bar_off = raw_off + RAW * RAW_STAGE;
  static constexpr int bytes = bar_off + 2 * STAGES * 8;
  static_assert(BM * (BN + 8) * 4 <= raw_off, "the output tile fits");
};

// slice kt of the reduction: channel block, tap and first channel
struct Slice {
  int cb, r, s, c0;
  __device__ __forceinline__ Slice(const Conv& cv, int kt) {
    const int taps = cv.geo.R * cv.geo.S;
    const int tap = (kt / cv.cpb) % taps;
    cb = kt / (cv.cpb * taps);
    r = tap / cv.geo.S;
    s = tap % cv.geo.S;
    c0 = (kt % cv.cpb) * sm::BK;
  }
};

// The A rows a producer thread fills: rows ptid / 8 + 16 e of the tile,
// 16-byte unit ptid % 8 of each (8 channels). Per row, the image's first
// input pixel and the input coordinates of tap (0, 0); a row past the
// block's pixels gets coordinates no tap brings inside the image.
template <int E>
struct Rows {
  int img[E], h[E], w[E];
  __device__ __forceinline__ Rows(const Conv& cv, int i, int p0, int ptid) {
    const Geometry& g = cv.geo;
    const int PQ = g.P * g.Q;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = p0 + ptid / 8 + 16 * e;
      if (p < cv.epi.mb) {
        const long long pix = (long long)i * cv.epi.mb + p;
        const int n = static_cast<int>(pix / PQ);
        const int pq = static_cast<int>(pix % PQ);
        img[e] = n * g.Cb * g.H * g.W;
        h[e] = pq / g.Q - g.pt;
        w[e] = pq % g.Q - g.pl;
      } else {
        img[e] = 0;
        h[e] = w[e] = -(1 << 28);
      }
    }
  }
  // element offset of the row's channels c0 .. in I for slice sl, or -1
  // where the pixel is padding
  __device__ __forceinline__ long long at(const Geometry& g, const Slice& sl,
                                          int e, int ch) const {
    const int hh = h[e] + sl.r, ww = w[e] + sl.s;
    if ((unsigned)hh >= (unsigned)g.H || (unsigned)ww >= (unsigned)g.W ||
        ch >= g.c)
      return -1;
    return ((long long)img[e] + ((long long)sl.cb * g.H + hh) * g.W + ww) *
               g.c + ch;
  }
};

// element offset of W[kb, cb, r, s, ch, col] (ch < c, col < k) or -1
__device__ __forceinline__ long long w_at(const Geometry& g, int kb,
                                          const Slice& sl, int ch, int col) {
  if (ch >= g.c || col >= g.k) return -1;
  return ((((long long)kb * g.Cb + sl.cb) * g.R + sl.r) * g.S + sl.s) * g.c *
             g.k + (long long)ch * g.k + col;
}

// Route "tma": the producer warpgroup (thread ptid) keeps STAGES - 2
// stages in flight: A by cp.async into the swizzled stage (zeros for
// padding), B by TMA (thread 0); a stage is handed to the consumers once
// this thread's copies of it have landed and are fenced for wgmma. Not
// STAGES - 1: a consumer frees slice n's stage only once slice n + 1's
// products are issued, so the stage slice n + STAGES waits for is freed
// by slice n + 1's hand-over, which must come before that wait.
template <int NCW, int BN>
__device__ __forceinline__ void produce_tma(const Conv& cv,
                                            const CUtensorMap* wmap,
                                            unsigned char* smem,
                                            uint64_t* full, uint64_t* empty,
                                            int ptid, int i, int j, int p0,
                                            int t0, int s_lo, int s_hi) {
  using T = ConvTile<NCW, BN, sm::kTma>;
  constexpr int LAG = T::STAGES - 2;
  const Rows<T::A_UNITS> rows(cv, i, p0, ptid);
  const __nv_bfloat16* I = static_cast<const __nv_bfloat16*>(cv.in);
  const Geometry& g = cv.geo;
  const int u = ptid % 8;
  for (int kt = s_lo; kt < s_hi + LAG; ++kt) {
    if (kt < s_hi) {
      const int n = kt - s_lo, stage = n % T::STAGES;
      hw::mbar_wait(&empty[stage], ((n / T::STAGES) & 1) ^ 1);
      unsigned char* sa = smem + stage * T::STAGE;
      const Slice sl(cv, kt);
      if (ptid == 0) {
        hw::mbar_arrive_tx(&full[stage], T::B_BYTES);
        const int z = ((j * g.Cb + sl.cb) * g.R + sl.r) * g.S + sl.s;
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          hw::tma_load_3d(sa + T::A_BYTES + c * sm::BK * 128, wmap,
                          &full[stage], t0 + 64 * c, sl.c0, z);
      }
#pragma unroll
      for (int e = 0; e < T::A_UNITS; ++e) {
        const long long o = rows.at(g, sl, e, sl.c0 + 8 * u);
        hw::cp_async16(sa + sm::unit_at(ptid / 8 + 16 * e, u),
                       o < 0 ? cv.in : I + o, o < 0 ? 0 : 16);
      }
    }
    hw::cp_async_commit();
    const int kd = kt - LAG;
    if (kd >= s_lo) {
      hw::cp_async_wait<LAG>();
      hw::fence_proxy_async();
      hw::mbar_arrive(&full[(kd - s_lo) % T::STAGES]);
    }
  }
}

// Route "convert": the producer warpgroup copies each stage's f32 A and B
// by cp.async into a raw staging slot (RAW - 1 stages in flight), then
// rounds the oldest slot to bf16 into the swizzled stage, fences and
// hands it over. A thread converts exactly the units it copied.
template <int NCW, int BN>
__device__ __forceinline__ void produce_convert(const Conv& cv,
                                                unsigned char* smem,
                                                uint64_t* full,
                                                uint64_t* empty, int ptid,
                                                int i, int j, int p0, int t0,
                                                int s_lo, int s_hi) {
  using T = ConvTile<NCW, BN, sm::kConvert>;
  constexpr int LAG = T::RAW - 1, ROW = BN / 8;   // B units a k-row
  const Rows<T::A_UNITS> rows(cv, i, p0, ptid);
  const float* I = static_cast<const float*>(cv.in);
  const float* W = static_cast<const float*>(cv.w);
  const Geometry& g = cv.geo;
  const int ua = ptid % 8, ub = ptid % ROW;
  auto raw = [&](int n, int e) {   // thread's unit e of staging slot n
    return smem + T::raw_off + (n % T::RAW) * T::RAW_STAGE +
           (e * sm::WG + ptid) * 32;
  };
  for (int kt = s_lo; kt < s_hi + LAG; ++kt) {
    if (kt < s_hi) {
      const int n = kt - s_lo;
      const Slice sl(cv, kt);
#pragma unroll
      for (int e = 0; e < T::A_UNITS; ++e) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const long long o = rows.at(g, sl, e, sl.c0 + 8 * ua + 4 * x);
          hw::cp_async16(raw(n, e) + 16 * x, o < 0 ? cv.in : I + o,
                         o < 0 ? 0 : 16);
        }
      }
#pragma unroll
      for (int e = 0; e < T::B_UNITS; ++e) {
        const int q = ptid / ROW + e * (sm::WG / ROW);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const long long o = w_at(g, j, sl, sl.c0 + q, t0 + 8 * ub + 4 * x);
          hw::cp_async16(raw(n, T::A_UNITS + e) + 16 * x,
                         o < 0 ? cv.w : W + o, o < 0 ? 0 : 16);
        }
      }
    }
    hw::cp_async_commit();
    const int kd = kt - LAG;
    if (kd < s_lo) continue;
    const int n = kd - s_lo, stage = n % T::STAGES;
    hw::cp_async_wait<LAG>();
    hw::mbar_wait(&empty[stage], ((n / T::STAGES) & 1) ^ 1);
    unsigned char* sa = smem + stage * T::STAGE;
    unsigned char* sb = sa + T::A_BYTES;
#pragma unroll
    for (int e = 0; e < T::A_UNITS + T::B_UNITS; ++e) {
      const float4* x = reinterpret_cast<const float4*>(raw(n, e));
      const float4 lo = x[0], hi = x[1];
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint4* dst;
      if (e < T::A_UNITS) {
        dst = reinterpret_cast<uint4*>(sa + sm::unit_at(ptid / 8 + 16 * e,
                                                        ua));
      } else {
        const int q = ptid / ROW + (e - T::A_UNITS) * (sm::WG / ROW);
        dst = reinterpret_cast<uint4*>(sb + (ub / 8) * sm::BK * 128 +
                                       sm::unit_at(q, ub % 8));
      }
      *dst = sm::pack8(v);
    }
    hw::fence_proxy_async();
    hw::mbar_arrive(&full[stage]);
  }
}

template <int NCW, int BN, int LOADER>
__global__ void __launch_bounds__((NCW + 1) * sm::WG, NCW == 1 ? 2 : 1)
conv_kernel(const __grid_constant__ CUtensorMap wmap,
            const __grid_constant__ Conv cv) {
  using T = ConvTile<NCW, BN, LOADER>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024)
                                    % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bar_off);
  uint64_t* empty = full + T::STAGES;
  const sm::Gemm& g = cv.epi;

  const int tid = threadIdx.x, wg = tid / sm::WG;
  const int mt = (g.mb + T::BM - 1) / T::BM, nt = (g.nb + BN - 1) / BN;
  const int i = blockIdx.x / mt, p0 = (blockIdx.x % mt) * T::BM;
  const int j = blockIdx.y / nt, t0 = (blockIdx.y % nt) * BN;
  const int ks = blockIdx.z;
  const int s_lo = static_cast<int>((long long)ks * cv.KT / g.split);
  const int s_hi = static_cast<int>((long long)(ks + 1) * cv.KT / g.split);

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hw::mbar_init(&full[s], LOADER == sm::kTma ? sm::WG + 1 : sm::WG);
      hw::mbar_init(&empty[s], NCW * sm::WG);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NCW) {  // ---- producer warpgroup ----
    const int ptid = tid - NCW * sm::WG;
    if constexpr (LOADER == sm::kTma)
      produce_tma<NCW, BN>(cv, &wmap, smem, full, empty, ptid, i, j, p0, t0,
                           s_lo, s_hi);
    else
      produce_convert<NCW, BN>(cv, smem, full, empty, ptid, i, j, p0, t0,
                               s_lo, s_hi);
    return;
  }

  // ---- consumer warpgroup wg: rows p0 + 64 wg .. + 63 ----
  float acc[BN / 2];
#pragma unroll
  for (int x = 0; x < BN / 2; ++x) acc[x] = 0.f;
  sm::consume_ring<0, 1, T::A_BYTES, BN, T::STAGES>(acc, smem, full, empty,
                                                    s_hi - s_lo, wg);
  sm::store_tile<NCW, BN>(acc, smem, g, i, j, p0, t0, ks);
}

template <int NCW, int BN, int LOADER>
int launch_wgmma(const Conv& cv, const CUtensorMap& wmap, cudaStream_t st) {
  using T = ConvTile<NCW, BN, LOADER>;
  auto kernel = conv_kernel<NCW, BN, LOADER>;
  constexpr int smem = T::bytes + 1024;  // + the 1024-byte alignment
  static unsigned long long opted = 0;   // devices the attribute is set on
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(opted >> (dev & 63) & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted |= 1ull << (dev & 63);
  }
  const sm::Gemm& g = cv.epi;
  const dim3 grid(g.Mb * ((g.mb + T::BM - 1) / T::BM),
                  g.Nb * ((g.nb + BN - 1) / BN), g.split);
  kernel<<<grid, (NCW + 1) * sm::WG, smem, st>>>(wmap, cv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.split == 1) return static_cast<int>(err);
  const size_t total = (size_t)g.Mb * g.Nb * g.mb * g.nb;
  const int blocks = static_cast<int>(
      std::min<size_t>((total + 255) / 256, (size_t)sm::sm_count() * 8));
  sm::split_reduce<<<blocks, 256, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// the plan's tile: 128 x 128 on the convert route only (the tma route's
// plan keeps two 64-row blocks an SM)
template <int LOADER>
int launch_plan(int bm, int bn, const Conv& cv, const CUtensorMap& wmap,
                cudaStream_t st) {
  if constexpr (LOADER == sm::kConvert)
    if (bm == 128) return launch_wgmma<2, 128, LOADER>(cv, wmap, st);
  if (bm == 128) return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 128) return launch_wgmma<1, 128, LOADER>(cv, wmap, st);
  return launch_wgmma<1, 64, LOADER>(cv, wmap, st);
}

// ---- the first version's body: f32 FMA ("fma") or WMMA ("wmma") ---------

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int APAD = 8, BPAD = 8, CPAD = 4;

struct Epilogue {
  int has_c, c_dtype, binary, bcast, d_dtype, unary, out_dtype;
};

// Tin: dtype of I/W in device memory; Tmma: dtype the products see
// (bf16 -> tensor cores, float -> f32 FMA).
template <typename Tin, typename Tmma>
__global__ void __launch_bounds__(THREADS)
conv_tile_kernel(const Tin* __restrict__ I, const Tin* __restrict__ Wt,
                 const void* __restrict__ Cacc, const void* __restrict__ D,
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
    if (epi.has_c) v += sm::ld_f32(Cacc, o, epi.c_dtype);
    if (epi.binary != tpp::kBinNone)
      v = tpp::apply_binary(
          epi.binary, v,
          sm::ld_f32(D, epi.bcast == tpp::kBcastCol ? (size_t)kb * g.k + gn
                                                    : o,
                     epi.d_dtype));
    tpp::store_out(out, o, epi.out_dtype, tpp::apply_unary(epi.unary, v));
  }
}

template <typename Tin, typename Tmma>
void launch_tile(const void* in, const void* w, const void* c, const void* d,
                 void* out, Geometry g, Epilogue epi, cudaStream_t stream) {
  const long long M = (long long)g.N * g.P * g.Q;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  g.Kb * ((g.k + BN - 1) / BN));
  conv_tile_kernel<Tin, Tmma><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(in), static_cast<const Tin*>(w), c, d, out, g,
      epi);
}

// The launch of one route: "fma" and "wmma" on the tile body; "tma" and
// "convert" on the wgmma kernel at the plan's tile (bm x bn) and k split,
// with the split partials in `work`.
int run(const void* in, const void* w, const void* c, const void* d,
        void* out, void* work, const Geometry& g, int in_dtype,
        int mma_dtype, int out_dtype, int c_dtype, int d_dtype, int has_c,
        int binary, int bcast, int unary, int route, int bm, int bn,
        int split, void* stream) {
  if (binary != tpp::kBinNone && bcast != tpp::kBcastCol &&
      bcast != tpp::kBcastNone)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteFma || route == kRouteWmma) {
    const Epilogue epi{has_c, c_dtype, binary, bcast, d_dtype, unary,
                       out_dtype};
    if (route == kRouteFma && in_dtype == tpp::kF32 &&
        mma_dtype == tpp::kF32)
      launch_tile<float, float>(in, w, c, d, out, g, epi, st);
    else if (route == kRouteWmma && in_dtype == tpp::kF32 &&
             mma_dtype == tpp::kBF16)
      launch_tile<float, __nv_bfloat16>(in, w, c, d, out, g, epi, st);
    else if (route == kRouteWmma && in_dtype == tpp::kBF16 &&
             mma_dtype == tpp::kBF16)
      launch_tile<__nv_bfloat16, __nv_bfloat16>(in, w, c, d, out, g, epi,
                                                st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  // the wgmma routes: bf16 products; "tma" reads bf16, "convert" f32, at
  // the channel alignments xsmm/reference.py conv_kernel_route checks
  const int vec = route == kRouteTma ? 8 : 4;
  if (mma_dtype != tpp::kBF16 ||
      (route == kRouteTma) != (in_dtype == tpp::kBF16) ||
      (route != kRouteTma && route != kRouteConvert) || g.c % vec ||
      g.k % vec || reinterpret_cast<uintptr_t>(in) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || !(bm == 64 || bm == 128) ||
      !(bn == 64 || bn == 128) || (bm == 128 && bn != 128) || split < 1 ||
      (split > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Conv cv{};
  cv.in = in;
  cv.w = w;
  cv.geo = g;
  cv.cpb = (g.c + sm::BK - 1) / sm::BK;
  cv.KT = g.Cb * g.R * g.S * cv.cpb;
  if (split > cv.KT) return static_cast<int>(cudaErrorInvalidValue);
  sm::Gemm& e = cv.epi;
  const bool per_image = g.Kb > 1;
  e.c = c;
  e.d = d;
  e.out = out;
  e.work = static_cast<float*>(work);
  e.Mb = per_image ? g.N : 1;
  e.Nb = g.Kb;
  e.mb = per_image ? g.P * g.Q : g.N * g.P * g.Q;
  e.nb = g.k;
  e.vec_c = reinterpret_cast<uintptr_t>(c) % 16 == 0;
  e.vec_d = reinterpret_cast<uintptr_t>(d) % 16 == 0;
  e.has_c = has_c;
  e.c_dtype = c_dtype;
  e.binary = binary;
  e.bcast = bcast;
  e.d_dtype = d_dtype;
  e.unary = unary;
  e.out_dtype = out_dtype;
  e.split = split;
  CUtensorMap wmap = {};
  if (route == kRouteTma) {
    // W [Kb, Cb, R, S, c, k] as (k, c, Kb Cb R S) in (64 k x 64 c) boxes
    const uint64_t dims[3] = {(uint64_t)g.k, (uint64_t)g.c,
                              (uint64_t)g.Kb * g.Cb * g.R * g.S};
    const uint64_t strides[2] = {(uint64_t)g.k * 2, (uint64_t)g.c * g.k * 2};
    const uint32_t box[3] = {64, sm::BK, 1};
    const int rc = hw::make_map(&wmap, w, 3, dims, strides, box, 128);
    if (rc) return rc;
    return launch_plan<sm::kTma>(bm, bn, cv, wmap, st);
  }
  return launch_plan<sm::kConvert>(bm, bn, cv, wmap, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). I [N,H,W,C] and
// W [R,S,C,K] are in_dtype; C [N,P,Q,K] is c_dtype and D ([K] for bcast 0,
// bcast_col; [N,P,Q,K] for bcast 3, none) d_dtype (f32 or bf16, read as
// stored and widened in registers); out [N,P,Q,K] is out_dtype. pt/pl are
// the top and left zero padding; P and Q carry the bottom and right
// padding (P = H + pt + pb - R + 1). route is xsmm/reference.py
// conv_kernel_route's (0 fma, 1 tma, 2 convert, 3 wmma); bm, bn and split
// conv_plan's (the wgmma routes; work holds split > 1's f32 partials).
extern "C" int tpp_conv_nhwc(const void* in, const void* w, const void* c,
                             const void* d, void* out, void* work, int N,
                             int H, int W, int C, int K, int R, int S, int pt,
                             int pl, int P, int Q, int in_dtype,
                             int mma_dtype, int out_dtype, int c_dtype,
                             int d_dtype, int has_c, int binary, int bcast,
                             int unary, int route, int bm, int bn, int split,
                             void* stream) {
  return run(in, w, c, d, out, work,
             Geometry{N, H, W, 1, C, 1, K, R, S, pt, pl, P, Q}, in_dtype,
             mma_dtype, out_dtype, c_dtype, d_dtype, has_c, binary, bcast,
             unary, route, bm, bn, split, stream);
}

// The channel-blocked layout (B23): I [N,Cb,H,W,cblk] and
// W [Kb,Cb,R,S,cblk,kblk] are in_dtype; C and out are [N,Kb,P,Q,kblk] (C
// c_dtype, out out_dtype); D is the bias [Kb,kblk] (bcast 0) in d_dtype.
// Stride 1, no padding: P = H - R + 1, Q = W - S + 1. route, bm, bn,
// split and work as for tpp_conv_nhwc.
extern "C" int tpp_conv_blocked(const void* in, const void* w,
                                const void* c, const void* d, void* out,
                                void* work, int N, int H, int W, int Cb,
                                int cblk, int Kb, int kblk, int R, int S,
                                int P, int Q, int in_dtype, int mma_dtype,
                                int out_dtype, int c_dtype, int d_dtype,
                                int has_c, int binary, int bcast, int unary,
                                int route, int bm, int bn, int split,
                                void* stream) {
  if (P != H - R + 1 || Q != W - S + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(in, w, c, d, out, work,
             Geometry{N, H, W, Cb, cblk, Kb, kblk, R, S, 0, 0, P, Q},
             in_dtype, mma_dtype, out_dtype, c_dtype, d_dtype, has_c, binary,
             bcast, unary, route, bm, bn, split, stream);
}
