// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` of
// deeplearning4j_tpu/ops/pallas_kernels.py (reached through `_flash_fwd`
// and `flash_attention`): blockwise online-softmax attention that never
// writes the [Tq, Tk] score matrix to device memory.
//
// What bounds it on this card: at the serving path's prefill shapes
// (q, k, v [1, Tb, 6, 128] bf16, causal) the work is 2*Tb^2*D*H flops
// against 8*Tb*H*D bytes of q, k, v and output, Tb/4 flops per byte:
// below the H100's ~295 bf16 flops per byte (Tb < ~1200) the bound is
// bytes, above it the tensor cores. This first version does its
// products on the CUDA cores in f32 (no wgmma, no TMA), so in practice
// it is bound by the shared-memory traffic of those scalar products,
// well above either bound. Its design answers the bytes side: each K/V
// tile is read from device memory once per 64-row query tile and staged
// in shared memory, scores and probabilities never leave the chip, and
// causal tiles above the diagonal are never loaded (the tile loop stops
// at the diagonal). Tensor cores (wgmma) and TMA come in a later change.
//
// Semantics carried from the TPU kernel:
//  - layout [B, T, H, D] read through strides (D contiguous), so no
//    [B*H, T, D] fold and no 128-lane padding;
//  - grouped-query attention: query head h reads kv head h / groups;
//  - causal masking against the end-aligned diagonal: query row i sees
//    keys j <= i + q_off, q_off = Tk - Tq;
//  - key-masked keys and keys past Tk fold into the scores as -inf;
//  - the softmax denominator is clamped at 1e-30, so a row with no live
//    key returns 0;
//  - lse = m + log(den) per row, written only when asked for (f32,
//    [B, H, Tq]; -inf for a row with no live key).
// Math is f32 throughout (inputs are upcast on load); the output is
// rounded once to the storage type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 256;  // 8 warps
constexpr int RPT = 4;         // query rows per thread
constexpr int CPT = BK / 16;   // score columns per thread

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// Thread t owns query rows 4*(t/16) .. 4*(t/16)+3 of the tile; for those
// rows it computes score columns (t%16) + 16*c and output channels
// (t%16) + 16*j. The 16 threads sharing a row group are one half-warp,
// so row max and row sum reduce with xor shuffles of offset < 16.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ km,
                 T* __restrict__ o, float* __restrict__ lse, int Tq,
                 int Tk, int H, int groups, long long sqb, long long sqt,
                 long long sqh, long long skb, long long skt,
                 long long skh, long long svb, long long svt,
                 long long svh, int causal, int q_off, float scale) {
  constexpr int DPT = D / 16;  // output channels per thread
  constexpr int LD = D + 1;    // padded row: conflict-free column reads
  constexpr int LP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* Ks = Qs + BQ * LD;    // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][LP]
  float* Ms = Ps + BQ * LP;    // [BK] 1 = live key

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / groups;
  const int r0 = (tid / 16) * RPT;
  const int lane = tid % 16;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[r * LD + d] = t < Tq ? to_f(qb[t * sqt + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[rr][j] = 0.f;
  }

  int nkt = (Tk + BK - 1) / BK;
  if (causal) {
    // the last key any row of this tile may see
    const int k_last = min(q0 + BQ, Tq) - 1 + q_off;
    nkt = min(nkt, k_last < 0 ? 0 : k_last / BK + 1);
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Qs staged; previous tile's Ks/Vs/Ps reads done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const int t = k0 + r;
      const bool in = t < Tk;
      Ks[r * LD + d] = in ? to_f(kb[t * skt + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[t * svt + d]) : 0.f;
    }
    for (int i = tid; i < BK; i += NTHREADS) {
      const int t = k0 + i;
      Ms[i] = (t < Tk && (km == nullptr || km[(long long)b * Tk + t] > 0.f))
                  ? 1.f
                  : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[rr][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) qv[rr] = Qs[(r0 + rr) * LD + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[(lane + 16 * c) * LD + d];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[rr][c] = fmaf(qv[rr], kv[c], s[rr][c]);
    }

#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int qi = q0 + r0 + rr;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = lane + 16 * c;
        const bool live =
            Ms[col] > 0.f && (!causal || k0 + col <= qi + q_off);
        s[rr][c] = live ? s[rr][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[rr][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[rr], mx);
      // rows with no live key so far keep m = -inf and p = 0
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[rr] == -INFINITY ? 0.f : __expf(m[rr] - safe);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = __expf(s[rr][c] - safe);  // exp(-inf) = 0
        Ps[(r0 + rr) * LP + lane + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[rr] = l[rr] * alpha + rs;
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[rr][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) pv[rr] = Ps[(r0 + rr) * LP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = Vs[c * D + lane + 16 * j];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr)
          acc[rr][j] = fmaf(pv[rr], vv, acc[rr][j]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= Tq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    T* orow = o + (((long long)b * Tq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      orow[lane + 16 * j] = from_f<T>(acc[rr][j] / den);
    if (lse != nullptr && lane == 0)
      lse[((long long)b * H + h) * Tq + qi] = m[rr] + logf(den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* km,
           void* o, void* lse, int B, int Tq, int Tk, int H, int Hkv,
           const long long* sq, const long long* sk, const long long* sv,
           int causal, int q_off, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D +
                       BQ * (BK + 1) + BK);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)km, (T*)o,
      (float*)lse, Tq, Tk, H, H / Hkv, sq[0], sq[1], sq[2], sk[0], sk[1],
      sk[2], sv[0], sv[1], sv[2], causal, q_off, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* km, void* o, void* lse, int B, int Tq, int Tk,
               int H, int Hkv, const long long* sq, const long long* sk,
               const long long* sv, int causal, int q_off, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, km, o, lse, B, Tq, Tk, H, Hkv, sq, sk,
                           sv, causal, q_off, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, km, o, lse, B, Tq, Tk, H, Hkv, sq, sk,
                           sv, causal, q_off, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, km, o, lse, B, Tq, Tk, H, Hkv, sq, sk,
                           sv, causal, q_off, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, km, o, lse, B, Tq, Tk, H, Hkv, sq, sk,
                            sv, causal, q_off, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, ordered
// (batch, time, head); the head dim is contiguous. km is a float32
// [B, Tk] key mask (> 0 = attend) or null; lse is float32 [B, H, Tq] or
// null. Returns 0, a cudaError_t code, or -1 for an unsupported dtype or
// head dim.
int dl4j_flash_attention_fwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const void* km,
                             void* o, void* lse, int B, int Tq, int Tk,
                             int H, int Hkv, long long sqb, long long sqt,
                             long long sqh, long long skb, long long skt,
                             long long skh, long long svb, long long svt,
                             long long svh, int causal, int q_off,
                             float scale, void* stream) {
  const long long sq[3] = {sqb, sqt, sqh};
  const long long sk[3] = {skb, skt, skh};
  const long long sv[3] = {svb, svt, svh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(head_dim, q, k, v, km, o, lse, B, Tq, Tk, H,
                             Hkv, sq, sk, sv, causal, q_off, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(head_dim, q, k, v, km, o, lse, B, Tq,
                                     Tk, H, Hkv, sq, sk, sv, causal, q_off,
                                     scale, st);
  return -1;
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
