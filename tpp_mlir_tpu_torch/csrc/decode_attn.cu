// Single-token decode attention over the stacked KV cache, for Hopper
// (sm_90a), as a split-sequence kernel.
//
// Replaces tpp_mlir_tpu/xsmm/decode_attn.py:101 build_decode_attn (B13):
//   out[b, h, g] = sum_{s <= pos} softmax_s(K[li,b,h,s] . q[b,h,g] * D^-0.5
//                                           [* ks[li,b,h,s]]) [* vs] V[..s]
// with the cache as the engine keeps it: (L, B, H, S, D) per-head contiguous
// (bf16, f16, f32, or int8 with (L, B, H, S) f32 scales), or pack2's
// (L, B, H/2, S, 2D) head pairs, which are the same rows read at column
// offset (h % 2) * D with a row stride of 2D. q is (B, H, G, D) in the
// activation dtype (G query heads share KV head h); the output is f32.
//
// What bounds it on the H100: a batch of matvecs, two FLOPs per cache byte,
// so device memory (3.35 TB/s). At the serving geometry (B 8, H 12, D 64,
// bf16, 640 live rows) one layer reads 15.7 MB of K/V; the floor is ~5 us.
// Reaching it takes enough blocks (a block per (KV head, batch row) is 96
// on 132 SMs, 32 at 4 KV heads) and enough bytes in flight on every SM.
// Design:
//   - the grid is (split, KV head, batch row): the live rows of a head are
//     cut into chunks of `chunk` rows (xsmm/reference.py decode_attn_plan,
//     from the key alone: 128 rows at the serving keys). pos
//     is read on the device, so one captured CUDA graph stays right at
//     every position; a split whose first row is past the live rows exits
//     at once;
//   - the whole chunk goes in flight at once: per 64-row tile one bulk
//     copy of K and one of V (cp.async.bulk: the rows are contiguous),
//     issued by thread 0 as soon as the tile's mbarrier exists; pack2's
//     strided rows by every thread's 16-byte cp.async, arriving on the
//     same barriers. The scores of a tile start as soon as it lands; the
//     int8 cache's scales of the chunk's rows go to shared memory in the
//     same round (read per row in the passes, they cost a round trip a
//     row group);
//   - the chunk is computed in passes on CUDA cores (G is 1-8 query heads
//     a KV head: an mma.sync tile would be at least half padding, and the
//     products are two FLOPs a byte, far under the card's FMA rate): the
//     scores of the chunk's rows x G (f32, each row's D columns over D/8
//     lanes, shuffle sums), one max and one exp per (row, g), then P.V
//     from shared memory, the block's 8 warps' partial sums added in warp
//     order;
//   - the splits merge deterministically: a head with one live split
//     writes its output directly; otherwise each split writes (m, l,
//     acc[G][D]) to an f32 workspace, and the last split of the head to
//     arrive (a counter in the workspace, reset by that block, so a graph
//     replays right) merges them in split order. The output is
//     bit-repeatable whatever order the blocks run in.
// Rows past pos are never read: B13 gives them exp(-1e30 - m) = 0 exactly,
// so the function is the same.
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace {

namespace hw = tpp::hopper;

constexpr int WARPS = 8, THREADS = WARPS * 32, CPL = 8;  // columns per lane
constexpr int TILE = 64, MAX_TILES = 2;   // rows a bulk copy, tiles a chunk

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_s;
  const float* v_s;
  const int* pos;
  float* out;
  float* part;     // [B H splits][G][D] partial P.V sums
  float2* ml;      // [B H splits][G] (max, sum of exp) of each split
  int* count;      // [B H] splits arrived; zero between launches
  int batch, heads, seq;  // heads: KV heads (H, also with pack2)
  int li, slotted, pack2;
  int chunk, splits;
  float scale;
};

// The block's shared memory: K and V of the chunk, the scores [G][chunk],
// the int8 cache's K and V scales of the chunk's rows, the warps' P.V
// partials [WARPS][G][D], (m, l) per g, the tile barriers and the
// last-arrival flag. Offsets in bytes.
struct Layout {
  int k, v, sc, ks, red, ml, bar, flag, bytes;
  __host__ __device__ Layout(int chunk, int G, int D, int es) {
    k = 0;
    v = chunk * D * es;
    sc = 2 * chunk * D * es;
    ks = sc + G * chunk * 4;
    red = ks + 2 * chunk * 4;
    ml = red + WARPS * G * D * 4;
    bar = (ml + 2 * G * 4 + 7) / 8 * 8;
    flag = bar + MAX_TILES * 8;
    bytes = flag + 16;
  }
};

__device__ __forceinline__ void load8(const float* p, float (&x)[CPL]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[CPL]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __half* p, float (&x)[CPL]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[CPL]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < CPL; ++i) x[i] = static_cast<float>(c[i]);
}

// D: head dim; GMAX: G rounded up to 1, 4 or 8 (loops run to G).
template <typename Tq, typename Tkv, int D, int GMAX>
__global__ void __launch_bounds__(THREADS, 1)
decode_attn_kernel(Args a, int G) {
  constexpr int LPR = D / CPL;     // lanes holding one row
  constexpr int RPW = 32 / LPR;    // rows a warp reads at once
  constexpr int RPB = WARPS * RPW; // rows the block reads at once
  static_assert(TILE % RPB == 0, "a warp's rows lie in one tile");
  static_assert(MAX_TILES * TILE <= THREADS, "a thread a row's scales");
  extern __shared__ __align__(16) unsigned char smem[];

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = a.seq, H = a.heads, CH = a.chunk;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int sub = lane / LPR, c0 = (lane % LPR) * CPL;

  const int p = a.slotted ? a.pos[b] : a.pos[0];
  const int live = min(p + 1, S);  // p == S (free slot): every row
  const int s0 = sp * CH;
  if (s0 >= live) return;          // no live row in this split
  const int n = min(CH, live - s0), tiles = (n + TILE - 1) / TILE;
  const int nsplit = (live + CH - 1) / CH;

  const Layout L(CH, G, D, sizeof(Tkv));
  Tkv* Ks = reinterpret_cast<Tkv*>(smem + L.k);
  Tkv* Vs = reinterpret_cast<Tkv*>(smem + L.v);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* kss = reinterpret_cast<float*>(smem + L.ks);   // [chunk] K scales
  float* vss = kss + CH;                                 // [chunk] V scales
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* ml = reinterpret_cast<float*>(smem + L.ml);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  // cache rows of (li, b, h) from s0: pack2 keeps head h in slot h/2 at
  // column offset (h % 2) * D, rows 2D apart
  const int rs = a.pack2 ? 2 * D : D;
  const size_t lb = (size_t)a.li * a.batch + b;
  const size_t head = a.pack2
      ? (lb * (H / 2) + h / 2) * (size_t)S * rs + (h % 2) * D
      : (lb * H + h) * (size_t)S * D;
  const Tkv* K = static_cast<const Tkv*>(a.k) + head + (size_t)s0 * rs;
  const Tkv* V = static_cast<const Tkv*>(a.v) + head + (size_t)s0 * rs;
  const bool quant = a.k_s != nullptr;

  // the chunk's rows in flight at once, a barrier a tile: thread 0's bulk
  // copies as soon as the barriers exist; pack2's strided rows by every
  // thread's 16-byte cp.async, each arriving on the tile's barrier once
  // its copies have landed
  constexpr uint32_t row_bytes = D * sizeof(Tkv);
  if (tid == 0) {
    for (int t = 0; t < tiles; ++t)
      hw::mbar_init(&bar[t], a.pack2 ? THREADS : 1);
    hw::mbar_fence_init();
    for (int t = 0; t < tiles && !a.pack2; ++t) {
      const int r0 = t * TILE, nr = min(TILE, n - r0);
      hw::mbar_arrive_tx(&bar[t], 2 * nr * row_bytes);
      hw::bulk_load(Ks + (size_t)r0 * D, K + (size_t)r0 * D, nr * row_bytes,
                    &bar[t]);
      hw::bulk_load(Vs + (size_t)r0 * D, V + (size_t)r0 * D, nr * row_bytes,
                    &bar[t]);
    }
  }
  if (quant && tid < n) {   // the rows' scales, one load each, in flight
    const size_t o = (lb * H + h) * (size_t)S + s0 + tid;   // with K/V's
    kss[tid] = a.k_s[o];
    vss[tid] = a.v_s[o];
  }
  __syncthreads();
  if (a.pack2) {
    constexpr int UPR = row_bytes / 16, EPU = 16 / sizeof(Tkv);
    for (int t = 0; t < tiles; ++t) {
      const int r0 = t * TILE, nr = min(TILE, n - r0);
      for (int u = tid; u < 2 * nr * UPR; u += THREADS) {
        const int r = r0 + (u / UPR) % nr, x = (u % UPR) * EPU;
        const bool is_v = u >= nr * UPR;
        hw::cp_async16((is_v ? Vs : Ks) + (size_t)r * D + x,
                       (is_v ? V : K) + (size_t)r * rs + x, 16);
      }
      hw::cp_async_arrive(&bar[t]);
    }
  }

  // pass 1: the scores of the chunk's rows, sc[g][r] (scaled, x ks)
  {
    float q[GMAX][CPL];
    const Tq* Q = static_cast<const Tq*>(a.q) + ((size_t)b * H + h) * G * D;
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        q[g][c] = g < G ? tpp::to_f32(Q[(size_t)g * D + c0 + c]) : 0.f;
    int ready = -1;
    for (int base = warp * RPW; base < n; base += RPB) {
      const int r = base + sub, t = base / TILE;
      const bool in = r < n;
      if (t > ready) {
        hw::mbar_wait(&bar[t], 0);
        ready = t;
      }
      float kx[CPL];
      if (in) {
        load8(Ks + (size_t)r * D + c0, kx);
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) kx[c] = 0.f;
      }
      const float ks = in && quant ? kss[r] : 1.f;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) d = fmaf(kx[c], q[g][c], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        if (in && lane % LPR == 0) {
          float s = d * a.scale;
          if (quant) s *= ks;
          sc[g * CH + r] = s;
        }
      }
    }
  }
  // every thread reads V rows below: each sees every tile land
  for (int t = 0; t < tiles; ++t) hw::mbar_wait(&bar[t], 0);
  __syncthreads();

  // pass 2: one max and one exp per (row, g); warp g takes query head g.
  // sc becomes exp(s - m) [x vs], the weight of V's row
  if (warp < G) {
    float* sg = sc + warp * CH;
    float m = -INFINITY;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, sg[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float e = expf(sg[r] - m);
      l += e;
      sg[r] = quant ? e * vss[r] : e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      ml[2 * warp] = m;
      ml[2 * warp + 1] = l;
    }
  }
  __syncthreads();

  // pass 3: P.V over the chunk's rows, lanes as in pass 1
  {
    float acc[GMAX][CPL];
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[g][c] = 0.f;
    for (int base = warp * RPW; base < n; base += RPB) {
      const int r = base + sub;
      if (r >= n) continue;
      float vx[CPL];
      load8(Vs + (size_t)r * D + c0, vx);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        const float w = sc[g * CH + r];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[g][c] = fmaf(w, vx[c], acc[g][c]);
      }
    }
    // the warp's row groups (lanes lane % LPR hold the same columns)
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], o);
      }
      if (lane < LPR) {
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          red[(warp * G + g) * D + c0 + c] = acc[g][c];
      }
    }
  }
  __syncthreads();

  // the block's sums, warps in order: the output, or this split's partial
  const size_t bh = (size_t)b * H + h;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[(w * G + g) * D + i % D];
    if (nsplit == 1)
      a.out[bh * G * D + i] = s / ml[2 * g + 1];
    else
      a.part[(bh * a.splits + sp) * G * D + i] = s;
  }
  if (nsplit == 1) return;
  if (tid < G)
    a.ml[(bh * a.splits + sp) * G + tid] =
        make_float2(ml[2 * tid], ml[2 * tid + 1]);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int before = atomicAdd(&a.count[bh], 1);
    *flag = before == nsplit - 1;
    if (*flag) atomicExch(&a.count[bh], 0);   // every live split is in
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last split to arrive merges all of them, in split order
  const float2* M2 = a.ml + bh * a.splits * G;
  const float* P = a.part + bh * a.splits * G * D;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, __ldcg(&M2[s * G + g]).x);
    float Lsum = 0.f, acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float2 f = __ldcg(&M2[s * G + g]);
      const float e = expf(f.x - M);
      Lsum = fmaf(f.y, e, Lsum);
      acc = fmaf(__ldcg(&P[(size_t)s * G * D + i]), e, acc);
    }
    a.out[bh * G * D + i] = acc / Lsum;
  }
}

template <typename Tq, typename Tkv, int D, int GMAX>
int launch_kernel(const Args& a, int G, cudaStream_t st) {
  auto kernel = decode_attn_kernel<Tq, Tkv, D, GMAX>;
  const int smem = Layout(a.chunk, G, D, sizeof(Tkv)).bytes;
  if (smem > 48 * 1024) {
    static int opted[64] = {};   // the bytes set on each device so far
    int dev = 0;
    cudaGetDevice(&dev);
    if (opted[dev & 63] < smem) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted[dev & 63] = smem;
    }
  }
  const dim3 grid(a.splits, a.heads, a.batch);
  kernel<<<grid, THREADS, smem, st>>>(a, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tq, typename Tkv, int D>
int launch_g(const Args& a, int G, cudaStream_t st) {
  if (G == 1) return launch_kernel<Tq, Tkv, D, 1>(a, G, st);
  if (G <= 4) return launch_kernel<Tq, Tkv, D, 4>(a, G, st);
  if (G <= 8) return launch_kernel<Tq, Tkv, D, 8>(a, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Tq, typename Tkv>
int launch_d(const Args& a, int d, int G, cudaStream_t st) {
  switch (d) {
    case 32: return launch_g<Tq, Tkv, 32>(a, G, st);
    case 64: return launch_g<Tq, Tkv, 64>(a, G, st);
    case 128: return launch_g<Tq, Tkv, 128>(a, G, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). q: (B, H, G, D) in
// q_dtype (f32, bf16 or f16, epilogue.cuh's codes); k/v: the stacked cache
// in kv_dtype (epilogue.cuh's codes: f32, bf16, f16 or int8),
// (L, B, H, S, D), or (L, B, H/2, S, 2D) with pack2, 16-byte aligned;
// k_s/v_s: (L, B, H, S) f32 or null; pos: int32 on the device, one value or
// B (slotted); out: (B, H, G, D) f32. li selects the layer. chunk and
// splits are xsmm/reference.py decode_attn_plan's (chunk a multiple of 64
// up to 128, splits * chunk >= S). With splits > 1, work holds
// B H splits G (D + 2) f32 partials and count B H int32 that are zero
// before the launch and zero again after it.
extern "C" int tpp_decode_attn(const void* q, const void* k, const void* v,
                               const void* k_s, const void* v_s,
                               const void* pos, void* out, void* work,
                               void* count, int batch, int heads, int seq,
                               int head_dim, int groups, int li, int slotted,
                               int pack2, int q_dtype, int kv_dtype,
                               int chunk, int splits, float scale,
                               void* stream) {
  if (chunk % TILE || chunk > MAX_TILES * TILE || chunk <= 0 ||
      (long long)chunk * splits < seq ||
      (long long)chunk * (splits - 1) >= seq ||
      (splits > 1 && (work == nullptr || count == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(work);
  float2* ml = reinterpret_cast<float2*>(
      part + (size_t)batch * heads * splits * groups * head_dim);
  const Args a{q, k, v, static_cast<const float*>(k_s),
               static_cast<const float*>(v_s), static_cast<const int*>(pos),
               static_cast<float*>(out), part, ml, static_cast<int*>(count),
               batch, heads, seq, li, slotted, pack2, chunk, splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == tpp::kF32 && kv_dtype == tpp::kF32)
    return launch_d<float, float>(a, head_dim, groups, st);
  if (q_dtype == tpp::kBF16 && kv_dtype == tpp::kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(a, head_dim, groups, st);
  if (q_dtype == tpp::kF32 && kv_dtype == tpp::kI8)
    return launch_d<float, int8_t>(a, head_dim, groups, st);
  if (q_dtype == tpp::kBF16 && kv_dtype == tpp::kI8)
    return launch_d<__nv_bfloat16, int8_t>(a, head_dim, groups, st);
  if (q_dtype == tpp::kF16 && kv_dtype == tpp::kF16)
    return launch_d<__half, __half>(a, head_dim, groups, st);
  if (q_dtype == tpp::kF16 && kv_dtype == tpp::kI8)
    return launch_d<__half, int8_t>(a, head_dim, groups, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
