// Batched matmul with an optional row-softmax prologue, for Hopper (sm_90a).
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:963 _build_batch_matmul (B21) and
// :1065 _build_batch_matmul_grouped (B22):
//   O[b] = f(A[b]) @ B[b] (+ C[b]),   A (m, k), B (k, n), C and O (m, n)
// with f the row softmax over k (softmax_lhs, the softmax(scores) @ V kernel
// of the MHA suite) or the identity. A has batch stride 0 when it is one
// (m, k) matrix shared by every b (lhs_shared). B22 is B21 with G whole
// problems in one TPU program, a grid choice for tiny problems.
//
// Numerics: operands rounded to the MXU dtype (bf16 for bf16 and f32
// "default", f32 for "highest"), products and sums in f32, C added in f32,
// one rounding to the output dtype. The softmax takes each row's max and
// sum over the whole k in f32 from A's values, then P = exp(a - max) / sum
// is rounded to the MXU dtype before the product.
//
// Two routes, which xsmm/reference.py batch_matmul_route chooses from the
// key:
//   "multi" (MXU dtype bf16, m, n and k at most 64, k and n multiples of 8:
//   every MHA-suite key, 1024 problems of 32x32x64 or 32x64x32). Such a
//   problem is ~4-16 KB of operands and a few hundred thousand operations,
//   so the work is bytes and latency: at 1024 problems the bound is 6 us
//   at 3.35 TB/s. A 64x64 block tile (the tiled route) wastes 3/4 or 1/2 of
//   its rows on padding and stages operands one scalar at a time. Here a
//   persistent grid of warps (a few per block, as many blocks as fit the
//   SMs) walks the batch, each warp owning one whole problem at a time:
//   its operands (A, B and C, f32 or bf16 as they are) arrive by cp.async
//   16-byte copies into the warp's own shared memory, and the warp's next
//   problem is issued into the same slot as soon as this one's operands
//   are read, so its loads overlap this problem's stores (at the MHA keys
//   every problem has a warp of its own, all loads in flight at once; a
//   2-stage ring, which doubles a warp's shared memory and so holds fewer
//   warps an SM, read slower there); the m x n output is
//   (m/16) x (n/8) mma.sync m16n8k16 bf16 tiles with f32 accumulators in
//   registers. A problem this small cannot fill wgmma's 64-row M without
//   mixing problems whose B differ, so mma.sync is the tensor-core
//   instruction here. f32 operands are rounded to bf16 as the fragments
//   are built from shared memory; softmax_lhs takes each row's max and sum
//   from the staged tile (a quad of lanes shares a row) and forms P in the
//   A fragment, exp as exp2 of a log2(e)-scaled argument and the division
//   as a product with the sum's reciprocal: a few f32 ulps from the plain
//   version, below P's bf16 rounding. lhs_shared loads A once per block.
//   The accumulators, plus C, go through the warp's output tile in shared
//   memory and leave as 16-byte vector stores. Pad rows and columns are
//   zeroed once and never copied. The launch plan (warps a block, shared
//   bytes, resident blocks) is worked out once per shape and device.
//   "tiled" (f32 "highest", and problems larger than that): one block of
//   4 warps per 64x64 output tile, A and B staged through shared memory
//   without pipelining, WMMA (mma.sync 16x16x16 bf16, f32 accumulators in
//   registers) or f32 FMA at "highest"; a block takes `group` problems in
//   turn when a problem fits one tile. Its keys (lhs_shared 64x256x196x128,
//   +C 16x256x256x512 "highest") are larger and rarer; a wgmma tile for
//   them is later work.
#include <math.h>

#include <algorithm>
#include <array>
#include <map>
#include <mma.h>
#include <mutex>
#include <type_traits>

#include "epilogue.cuh"
#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, WARPS = 4, THREADS = WARPS * 32;

struct Args {
  const void* a;
  const void* b;
  const float* c;  // f32 (batch, m, n), or null (beta0)
  void* out;
  int batch, m, n, k;
  int group;             // problems a block takes in turn
  long long a_stride;    // elements between A's problems; 0: lhs_shared
  int softmax, out_dtype;
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

template <typename Tin, typename Tmma>
__global__ void __launch_bounds__(THREADS) batch_matmul_kernel(Args a) {
  constexpr bool kTensor = std::is_same<Tmma, __nv_bfloat16>::value;
  // row pads keep WMMA pointers 32-byte aligned (bf16 rows a multiple of 8
  // elements) and spread the FMA path's column reads over the banks
  constexpr int ALD = kTensor ? BK + 8 : BK + 1;
  constexpr int BLD = kTensor ? BN + 8 : BN + 4;
  constexpr int CLD = BN + 4;
  __shared__ __align__(128) Tmma As[BM * ALD];
  __shared__ __align__(128) Tmma Bs[BK * BLD];
  __shared__ __align__(128) float Cs[BM * CLD];
  __shared__ float row_max[BM], row_sum[BM];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  for (int g = 0; g < a.group; ++g) {
    const int bi = blockIdx.z * a.group + g;
    if (bi >= a.batch) break;  // the same for every thread of the block
    const Tin* A = static_cast<const Tin*>(a.a) + bi * a.a_stride;
    const Tin* B = static_cast<const Tin*>(a.b) + (size_t)bi * a.k * a.n;

    if (a.softmax) {  // each row's max and sum over the whole k, in f32
      for (int r = warp; r < BM; r += WARPS) {
        float mx = -INFINITY, sum = 0.f;
        if (m0 + r < a.m) {
          const Tin* row = A + (size_t)(m0 + r) * a.k;
          for (int c = lane; c < a.k; c += 32)
            mx = fmaxf(mx, tpp::to_f32(row[c]));
          mx = warp_max(mx);
          for (int c = lane; c < a.k; c += 32)
            sum += expf(tpp::to_f32(row[c]) - mx);
          sum = warp_sum(sum);
        }
        if (lane == 0) {
          row_max[r] = mx;
          row_sum[r] = sum;
        }
      }
    }

    // kTensor: warp w owns the 16x16 output tiles (w, j), j = 0..3, of
    // the 64x64 block tile, as register fragments
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
    float facc[8][4];  // FMA: rows ty*8 + i, columns tx + 16 j
    const int ty = tid / 16, tx = tid % 16;
    if constexpr (kTensor) {
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < a.k; k0 += BK) {
      __syncthreads();  // statistics ready; the previous tiles no longer read
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i % BK;
        float x = 0.f;
        if (m0 + r < a.m && k0 + c < a.k) {
          x = tpp::to_f32(A[(size_t)(m0 + r) * a.k + k0 + c]);
          if (a.softmax) x = expf(x - row_max[r]) / row_sum[r];
        }
        As[r * ALD + c] = tpp::from_f32<Tmma>(x);
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const bool in = k0 + r < a.k && n0 + c < a.n;
        Bs[r * BLD + c] = tpp::from_f32<Tmma>(
            in ? tpp::to_f32(B[(size_t)(k0 + r) * a.n + n0 + c]) : 0.f);
      }
      __syncthreads();
      if constexpr (kTensor) {
        if (m0 + warp * 16 < a.m) {
#pragma unroll
          for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa;
            wmma::load_matrix_sync(fa, As + warp * 16 * ALD + kk, ALD);
#pragma unroll
            for (int j = 0; j < BN / 16; ++j) {
              if (n0 + j * 16 >= a.n) break;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major> fb;
              wmma::load_matrix_sync(fb, Bs + kk * BLD + j * 16, BLD);
              wmma::mma_sync(acc[j], fa, fb, acc[j]);
            }
          }
        }
      } else {
        for (int kk = 0; kk < BK; ++kk) {
          float av[8], bv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            av[i] = tpp::to_f32(As[(ty * 8 + i) * ALD + kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = tpp::to_f32(Bs[kk * BLD + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
        }
      }
    }

    if constexpr (kTensor) {
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wmma::store_matrix_sync(Cs + warp * 16 * CLD + j * 16, acc[j], CLD,
                                wmma::mem_row_major);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Cs[(ty * 8 + i) * CLD + tx + 16 * j] = facc[i][j];
    }
    __syncthreads();
    const size_t base = (size_t)bi * a.m * a.n;
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      if (m0 + r >= a.m || n0 + c >= a.n) continue;
      const size_t o = base + (size_t)(m0 + r) * a.n + n0 + c;
      float v = Cs[r * CLD + c];
      if (a.c) v += a.c[o];
      tpp::store_out(a.out, o, a.out_dtype, v);
    }
    __syncthreads();  // Cs and the statistics are free for the next problem
  }
}

template <typename Tin, typename Tmma>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM,
                  (a.batch + a.group - 1) / a.group);
  batch_matmul_kernel<Tin, Tmma><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- "multi": one warp per whole problem, mma.sync m16n8k16 ----------

namespace hw = tpp::hopper;

constexpr int MULTI_MAX = 64;     // m, n, k of the route
constexpr int MWARPS = 8;         // warps a block, fewer where memory binds
constexpr int MSMEM = 227 * 1024; // shared memory a block may opt into
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory plan of one block of the multi route, the same on the host
// and the card. Row strides (elements) pad each row by 16 or 32 bytes so
// that the fragment reads of a warp hit distinct banks: A (k_pad + 8) in
// its input dtype, B (NP + 4) f32 or (NP + 8) bf16, C and the output tile
// (NP + 8) f32. Every region is a multiple of 16 bytes. A warp holds one
// problem's operands (its slot) and its output tile.
struct MPlan {
  int k_pad, a_ld, b_ld, o_ld;
  int a_bytes, b_bytes, c_bytes, slot, warp, shared_a, warps, bytes;
  __host__ __device__ MPlan(int mp, int np, int k, int in_size,
                            bool lhs_shared, bool has_c, int warps_)
      : k_pad((k + 15) / 16 * 16),
        a_ld(k_pad + 8),
        b_ld(np + (in_size == 4 ? 4 : 8)),
        o_ld(np + 8),
        a_bytes(mp * a_ld * in_size),
        b_bytes(k_pad * b_ld * in_size),
        c_bytes(has_c ? mp * o_ld * 4 : 0),
        slot((lhs_shared ? 0 : a_bytes) + b_bytes + c_bytes),
        warp(slot + mp * o_ld * 4),
        shared_a(lhs_shared ? a_bytes : 0),
        warps(warps_),
        bytes(shared_a + warps_ * warp) {}
};

struct MArgs {
  const void* a;
  const void* b;
  const float* c;   // f32 (batch, m, n), or null
  void* out;
  int batch, m, n, k;
  int lhs_shared, softmax, out_dtype;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive elements as f32, and as a bf16 pair
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ uint32_t pair(const float* p) {
  const float2 x = ld2(p);
  return hw::pack_bf16(x.x, x.y);
}
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// B(r, c) and B(r + 1, c), rounded to bf16, as a pair
__device__ __forceinline__ uint32_t col_pair(const float* p, int ld) {
  return hw::pack_bf16(p[0], p[ld]);
}
__device__ __forceinline__ uint32_t col_pair(const __nv_bfloat16* p, int ld) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(p[0])) |
         static_cast<uint32_t>(__bfloat16_as_ushort(p[ld])) << 16;
}

// cp.async the `rows` x `units` 16-byte units of a row-major source (row
// stride `units` units) into a tile of row stride `ld_bytes`, by one warp
// (or, with `threads` > 32, by a block)
__device__ __forceinline__ void copy_rows(unsigned char* dst, int ld_bytes,
                                          const void* src, int rows,
                                          int units, int tid, int threads) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int i = tid; i < rows * units; i += threads) {
    const int r = i / units, u = i % units;
    hw::cp_async16(dst + r * ld_bytes + u * 16, s + (size_t)i * 16, 16);
  }
}

template <typename Tin, int MP, int NP>
__global__ void __launch_bounds__(MWARPS * 32)
batch_matmul_multi_kernel(MArgs a) {
  constexpr int MT = MP / 16, NT = NP / 8, IS = sizeof(Tin);
  const MPlan L(MP, NP, a.k, IS, a.lhs_shared, a.c != nullptr,
                blockDim.x / 32);
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* shared_a = smem;
  unsigned char* mine = smem + L.shared_a + warp * L.warp;
  float* otile = reinterpret_cast<float*>(mine + L.slot);

  // zero the whole block's memory once: pad rows and columns are never
  // copied, so they stay zero for every problem
  for (int i = threadIdx.x; i < L.bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int ku = a.k * IS / 16, nu = a.n * IS / 16, cu = a.n / 4;
  if (a.lhs_shared) {     // one A for every problem: loaded once a block
    copy_rows(shared_a, L.a_ld * IS, a.a, a.m, ku, threadIdx.x, blockDim.x);
    hw::cp_async_commit();
    hw::cp_async_wait<0>();
    __syncthreads();
  }

  const int nwarps = gridDim.x * L.warps;
  const int first = blockIdx.x * L.warps + warp;
  // a problem's A, B and C into the warp's slot; one commit group a call,
  // empty past the batch
  auto issue = [&](int p) {
    if (p < a.batch) {
      unsigned char* slot = mine;
      if (!a.lhs_shared) {
        copy_rows(slot, L.a_ld * IS,
                  static_cast<const Tin*>(a.a) + (size_t)p * a.m * a.k, a.m,
                  ku, lane, 32);
        slot += L.a_bytes;
      }
      copy_rows(slot, L.b_ld * IS,
                static_cast<const Tin*>(a.b) + (size_t)p * a.k * a.n, a.k, nu,
                lane, 32);
      if (a.c)
        copy_rows(slot + L.b_bytes, L.o_ld * 4, a.c + (size_t)p * a.m * a.n,
                  a.m, cu, lane, 32);
    }
    hw::cp_async_commit();
  };
  issue(first);

  const int g = lane / 4, t = lane % 4;
  for (int p = first; p < a.batch; p += nwarps) {
    hw::cp_async_wait<0>();
    __syncwarp();
    const Tin* A = reinterpret_cast<const Tin*>(a.lhs_shared ? shared_a
                                                             : mine);
    const unsigned char* bslot = mine + (a.lhs_shared ? 0 : L.a_bytes);
    const Tin* B = reinterpret_cast<const Tin*>(bslot);
    const float* C = reinterpret_cast<const float*>(bslot + L.b_bytes);

    // softmax_lhs: each of the lane's rows' max (times log2(e)) and the
    // reciprocal of its sum over k, in f32; the four lanes of a quad share
    // a row and cover the columns its A fragments hold
    float mx[MT][2], sm[MT][2];
    if (a.softmax) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const Tin* row = A + (mt * 16 + g + 8 * hh) * L.a_ld;
          float m_ = -INFINITY, s_ = 0.f;
          for (int c = 2 * t; c < a.k; c += 8) {
            const float2 x = ld2(row + c);
            m_ = fmaxf(m_, fmaxf(x.x, x.y));
          }
          m_ = fmaxf(m_, __shfl_xor_sync(0xffffffffu, m_, 1));
          m_ = fmaxf(m_, __shfl_xor_sync(0xffffffffu, m_, 2));
          m_ *= LOG2E;   // exp(x - m) as exp2(x log2(e) - m log2(e))
          for (int c = 2 * t; c < a.k; c += 8) {
            const float2 x = ld2(row + c);
            s_ += exp2f(fmaf(x.x, LOG2E, -m_)) + exp2f(fmaf(x.y, LOG2E, -m_));
          }
          s_ += __shfl_xor_sync(0xffffffffu, s_, 1);
          s_ += __shfl_xor_sync(0xffffffffu, s_, 2);
          mx[mt][hh] = m_;
          sm[mt][hh] = 1.f / s_;
        }
    }

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll 1
    for (int k0 = 0; k0 < L.k_pad; k0 += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8), a3 (g + 8, 2t + 8)
          const int hh = q & 1, c = k0 + 2 * t + 8 * (q >> 1);
          const Tin* at = A + (mt * 16 + g + 8 * hh) * L.a_ld + c;
          if (a.softmax) {
            const float2 x = ld2(at);
            const bool in = c < a.k;     // k is a multiple of 8
            const float m_ = mx[mt][hh], r_ = sm[mt][hh];
            af[mt][q] = hw::pack_bf16(
                in ? exp2f(fmaf(x.x, LOG2E, -m_)) * r_ : 0.f,
                in ? exp2f(fmaf(x.y, LOG2E, -m_)) * r_ : 0.f);
          } else {
            af[mt][q] = pair(at);
          }
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const Tin* bt = B + (k0 + 2 * t) * L.b_ld + nt * 8 + g;
        const uint32_t b0 = col_pair(bt, L.b_ld);
        const uint32_t b1 = col_pair(bt + 8 * L.b_ld, L.b_ld);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }

    // acc (+ C) into the output tile: c0, c1 row g, c2, c3 row g + 8,
    // columns 2t, 2t + 1
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = (mt * 16 + g + 8 * hh) * L.o_ld + nt * 8 + 2 * t;
          float2 x = make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
          if (a.c) {
            const float2 cc = ld2(C + at);
            x.x += cc.x;
            x.y += cc.y;
          }
          *reinterpret_cast<float2*>(otile + at) = x;
        }
    __syncwarp();   // the slot is read: refill it; the tile is written
    issue(p + nwarps);

    // 16-byte vector stores of the m x n result, one rounding
    const size_t base = (size_t)p * a.m * a.n;
    if (a.out_dtype == tpp::kBF16) {
      const int units = a.n / 8;
      for (int i = lane; i < a.m * units; i += 32) {
        const int r = i / units, c = (i % units) * 8;
        const float4 x0 = *reinterpret_cast<const float4*>(otile + r * L.o_ld + c);
        const float4 x1 =
            *reinterpret_cast<const float4*>(otile + r * L.o_ld + c + 4);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) + base +
                                  (size_t)r * a.n + c) =
            make_uint4(hw::pack_bf16(x0.x, x0.y), hw::pack_bf16(x0.z, x0.w),
                       hw::pack_bf16(x1.x, x1.y), hw::pack_bf16(x1.z, x1.w));
      }
    } else {
      const int units = a.n / 4;
      for (int i = lane; i < a.m * units; i += 32) {
        const int r = i / units, c = (i % units) * 4;
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + base +
                                   (size_t)r * a.n + c) =
            *reinterpret_cast<const float4*>(otile + r * L.o_ld + c);
      }
    }
    __syncwarp();   // the output tile is free for the next problem
  }
  hw::cp_async_wait<0>();
}

// How a key runs: warps a block, dynamic shared bytes, and the most blocks
// resident on the card at once
struct MLaunch {
  int warps, bytes, blocks;
};

// the most warps a block whose plan fits, and the blocks resident at that
template <typename Kernel>
cudaError_t plan_multi(Kernel kernel, int mp, int np, const MArgs& a,
                       int in_size, int dev, MLaunch* out) {
  int sms = 0, per_sm = 0, warps = MWARPS;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto bytes = [&](int w) {
    return MPlan(mp, np, a.k, in_size, a.lhs_shared, a.c != nullptr, w)
        .bytes;
  };
  while (warps > 1 && bytes(warps) > MSMEM) --warps;
  // the largest opt-in, so that no key's plan lowers another's
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MSMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      warps * 32,
                                                      bytes(warps));
  *out = MLaunch{warps, bytes(warps), std::max(per_sm, 1) * sms};
  return e;
}

template <typename Tin, int MP, int NP>
int launch_multi_tile(const MArgs& a, cudaStream_t stream) {
  auto kernel = batch_matmul_multi_kernel<Tin, MP, NP>;
  // plans by (device, k, lhs_shared, C): worked out on a key's first launch
  static std::mutex mu;
  static std::map<std::array<int, 4>, MLaunch> plans;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const std::array<int, 4> id{dev, a.k, a.lhs_shared, a.c != nullptr};
  MLaunch pl;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = plans.find(id);
    if (it == plans.end()) {
      err = plan_multi(kernel, MP, NP, a, sizeof(Tin), dev, &pl);
      if (err != cudaSuccess) return static_cast<int>(err);
      it = plans.emplace(id, pl).first;
    }
    pl = it->second;
  }
  // persistent: as many blocks as are resident at once, or fewer where the
  // batch has fewer problems than warps
  const int need = (a.batch + pl.warps - 1) / pl.warps;
  const int blocks = std::max(1, std::min(need, pl.blocks));
  kernel<<<blocks, pl.warps * 32, pl.bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int launch_multi(const MArgs& a, cudaStream_t stream) {
  if (a.m <= 32)
    return a.n <= 32 ? launch_multi_tile<Tin, 32, 32>(a, stream)
                     : launch_multi_tile<Tin, 32, 64>(a, stream);
  return a.n <= 32 ? launch_multi_tile<Tin, 64, 32>(a, stream)
                   : launch_multi_tile<Tin, 64, 64>(a, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). a is (batch, m, k),
// or (m, k) when lhs_shared; b (batch, k, n); c null or f32 (batch, m, n);
// out (batch, m, n). route is xsmm/reference.py batch_matmul_route's
// choice: 1 "multi" (MXU dtype bf16, m, n, k at most 64, k and n multiples
// of 8, every pointer 16-byte aligned), 0 "tiled", whose ceil(batch /
// group) goes in gridDim.z, so it is at most 65535.
extern "C" int tpp_batch_matmul(const void* a, const void* b, const void* c,
                                void* out, int batch, int m, int n, int k,
                                int group, int lhs_shared, int softmax,
                                int in_dtype, int mma_dtype, int out_dtype,
                                int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (mma_dtype != tpp::kBF16 || m > MULTI_MAX || n > MULTI_MAX ||
        k > MULTI_MAX || m < 1 || n % 8 || k % 8 || k < 8 || n < 8)
      return static_cast<int>(cudaErrorInvalidValue);
    const MArgs args{a,     b,          static_cast<const float*>(c),
                     out,   batch,      m,
                     n,     k,          lhs_shared,
                     softmax, out_dtype};
    if (in_dtype == tpp::kF32) return launch_multi<float>(args, st);
    if (in_dtype == tpp::kBF16) return launch_multi<__nv_bfloat16>(args, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != 0 || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{a,     b,     static_cast<const float*>(c), out,
                  batch, m,     n,
                  k,     group, lhs_shared ? 0LL : (long long)m * k,
                  softmax, out_dtype};
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kF32)
    return launch<float, float>(args, st);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kBF16)
    return launch<float, __nv_bfloat16>(args, st);
  if (in_dtype == tpp::kBF16 && mma_dtype == tpp::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(args, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
