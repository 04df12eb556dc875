// Single-token decode attention over the stacked KV cache, for Hopper
// (sm_90a).
//
// Replaces tpp_mlir_tpu/xsmm/decode_attn.py:101 build_decode_attn (B13):
//   out[b, h, g] = sum_{s <= pos} softmax_s(K[li,b,h,s] . q[b,h,g] * D^-0.5
//                                           [* ks[li,b,h,s]]) [* vs] V[..s]
// with the cache as the engine keeps it: (L, B, H, S, D) per-head contiguous
// (bf16, f32, or int8 with (L, B, H, S) f32 scales), or pack2's
// (L, B, H/2, S, 2D) head pairs, which are the same rows read at column
// offset (h % 2) * D with a row stride of 2D. q is (B, H, G, D) in the
// activation dtype (G query heads share KV head h); the output is f32.
//
// What bounds it on the H100: a batch of matvecs, two FLOPs per cache byte,
// so device memory (3.35 TB/s). At the serving geometry (B 8, H 12, D 64,
// bf16, 640 live rows) one layer reads 15.7 MB of K/V; the floor is ~5 us.
// Design: one block per (KV head, batch row), so all G query heads of a KV
// head share one read of its rows. The live rows (s <= pos; pos read from
// device memory, so a captured CUDA graph replays right at every position)
// are split across the block's 8 warps; D/8 lanes hold one row, each lane 8
// columns (16-byte loads for bf16, two for f32, 8 bytes for int8). Scores
// are f32, reduced over the row's lanes by shuffles, and each lane keeps an
// online softmax (running max, sum and its 8 P.V columns) for the rows it
// visits; the row groups of a warp are merged by shuffles and the warps in
// shared memory. Rows past pos are never read: B13 gives them
// exp(-1e30 - m) = 0 exactly, so the function is the same.
// Known gaps: B 8 x H 12 is 96 blocks for 132 SMs and B 8 x 4 KV heads only
// 32; splitting S across blocks (a second merge pass) is later work.
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32, CPL = 8;  // columns per lane

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_s;
  const float* v_s;
  const int* pos;
  float* out;
  int batch, heads, seq;  // heads: KV heads (H, also with pack2)
  int li, slotted, pack2;
  float scale;
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

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[CPL]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < CPL; ++i) x[i] = static_cast<float>(c[i]);
}

// Online-softmax state of one query head: max, sum, 8 output columns.
template <int GMAX>
struct State {
  float m[GMAX], l[GMAX], acc[GMAX][CPL];
};

// Merge another state (m2, l2, acc2) into (m, l, acc).
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float m2, float l2, const float* acc2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  const float a = m == -INFINITY ? 0.f : expf(m - mn);
  const float b = m2 == -INFINITY ? 0.f : expf(m2 - mn);
  l = l * a + l2 * b;
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = acc[c] * a + acc2[c] * b;
  m = mn;
}

// D: head dim; GMAX: G rounded up to 1, 4 or 8 (loops run to G).
template <typename Tq, typename Tkv, int D, int GMAX>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(Args a, int G) {
  constexpr int LPR = D / CPL;     // lanes holding one row
  constexpr int RPW = 32 / LPR;    // rows a warp reads at once
  __shared__ float red_m[WARPS][GMAX], red_l[WARPS][GMAX];
  __shared__ float red_acc[WARPS][GMAX][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane / LPR, c0 = (lane % LPR) * CPL;
  const int S = a.seq, H = a.heads;

  // cache rows of (li, b, h): pack2 keeps head h in slot h/2 at column
  // offset (h % 2) * D, rows 2D apart
  const int rs = a.pack2 ? 2 * D : D;
  const size_t lb = (size_t)a.li * a.batch + b;
  const size_t head = a.pack2
      ? (lb * (H / 2) + h / 2) * (size_t)S * rs + (h % 2) * D
      : (lb * H + h) * (size_t)S * D;
  const Tkv* K = static_cast<const Tkv*>(a.k) + head + c0;
  const Tkv* V = static_cast<const Tkv*>(a.v) + head + c0;
  const float* KS = a.k_s ? a.k_s + (lb * H + h) * (size_t)S : nullptr;
  const float* VS = a.v_s ? a.v_s + (lb * H + h) * (size_t)S : nullptr;
  const int p = a.slotted ? a.pos[b] : a.pos[0];
  const int live = min(p + 1, S);  // p == S (free slot): every row

  float q[GMAX][CPL];
  const Tq* Q = static_cast<const Tq*>(a.q) + ((size_t)b * H + h) * G * D;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      q[g][c] = g < G ? tpp::to_f32(Q[(size_t)g * D + c0 + c]) : 0.f;

  State<GMAX> st;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    st.m[g] = -INFINITY;
    st.l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) st.acc[g][c] = 0.f;
  }

  for (int s = warp * RPW + sub; s - sub < live; s += WARPS * RPW) {
    const bool in = s < live;
    float kx[CPL], vx[CPL];
    if (in) {
      load8(K + (size_t)s * rs, kx);
      load8(V + (size_t)s * rs, vx);
    }
    const float ks = in && KS ? KS[s] : 1.f;
    const float vs = in && VS ? VS[s] : 1.f;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float d = 0.f;
      if (in) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) d = fmaf(kx[c], q[g][c], d);
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if (!in) continue;
      float sc = d * a.scale;
      if (KS) sc *= ks;
      const float mn = fmaxf(st.m[g], sc);
      const float al = expf(st.m[g] - mn);  // 0 while m is -inf
      const float e = expf(sc - mn);
      st.l[g] = st.l[g] * al + e;
      const float ev = e * vs;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        st.acc[g][c] = fmaf(ev, vx[c], st.acc[g][c] * al);
      st.m[g] = mn;
    }
  }

  // merge the warp's row groups (lanes lane % LPR hold the same columns)
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, st.m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, st.l[g], o);
      float acc2[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        acc2[c] = __shfl_xor_sync(0xffffffffu, st.acc[g][c], o);
      merge(st.m[g], st.l[g], st.acc[g], m2, l2, acc2);
    }
    if (lane < LPR) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) red_acc[warp][g][c0 + c] = st.acc[g][c];
      if (lane == 0) {
        red_m[warp][g] = st.m[g];
        red_l[warp][g] = st.l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps: one thread per (g, column)
  float* O = a.out + ((size_t)b * H + h) * G * D;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, c = i % D;
    float M = -INFINITY;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, red_m[w][g]);
    float L = 0.f, acc = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      if (red_m[w][g] == -INFINITY) continue;
      const float f = expf(red_m[w][g] - M);
      L += red_l[w][g] * f;
      acc += red_acc[w][g][c] * f;
    }
    O[(size_t)g * D + c] = acc / L;
  }
}

template <typename Tq, typename Tkv, int D>
int launch_g(const Args& a, int G, cudaStream_t st) {
  const dim3 grid(a.heads, a.batch);
  if (G == 1)
    decode_attn_kernel<Tq, Tkv, D, 1><<<grid, THREADS, 0, st>>>(a, G);
  else if (G <= 4)
    decode_attn_kernel<Tq, Tkv, D, 4><<<grid, THREADS, 0, st>>>(a, G);
  else if (G <= 8)
    decode_attn_kernel<Tq, Tkv, D, 8><<<grid, THREADS, 0, st>>>(a, G);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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
// q_dtype; k/v: the stacked cache in kv_dtype (0 f32, 1 bf16, 2 int8),
// (L, B, H, S, D), or (L, B, H/2, S, 2D) with pack2; k_s/v_s: (L, B, H, S)
// f32 or null; pos: int32 on the device, one value or B (slotted); out:
// (B, H, G, D) f32. li selects the layer.
extern "C" int tpp_decode_attn(const void* q, const void* k, const void* v,
                               const void* k_s, const void* v_s,
                               const void* pos, void* out, int batch,
                               int heads, int seq, int head_dim, int groups,
                               int li, int slotted, int pack2, int q_dtype,
                               int kv_dtype, float scale, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(k_s),
               static_cast<const float*>(v_s), static_cast<const int*>(pos),
               static_cast<float*>(out), batch, heads, seq, li, slotted,
               pack2, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == tpp::kF32 && kv_dtype == tpp::kF32)
    return launch_d<float, float>(a, head_dim, groups, st);
  if (q_dtype == tpp::kBF16 && kv_dtype == tpp::kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(a, head_dim, groups, st);
  if (q_dtype == tpp::kF32 && kv_dtype == 2)
    return launch_d<float, int8_t>(a, head_dim, groups, st);
  if (q_dtype == tpp::kBF16 && kv_dtype == 2)
    return launch_d<__nv_bfloat16, int8_t>(a, head_dim, groups, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
