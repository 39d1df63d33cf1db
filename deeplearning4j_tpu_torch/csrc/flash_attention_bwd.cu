// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_flash_bwd_fused_kernel` of
// deeplearning4j_tpu/ops/pallas_kernels.py (reached through `_flash_bwd`
// from the custom vjp of `flash_attention`): the single-pass
// FlashAttention-2 backward that recomputes each probability tile from
// the saved row logsumexp and feeds dq, dk and dv from it, never writing
// the [Tq, Tk] score or probability matrix to device memory.
//
// What bounds it on this card: at the training path's shapes (q, k, v,
// o, dO [16, 1024, 6, 128] bf16, causal) the work is 5 products of
// 2*D flops per live (query, key) pair and head (s, dp, dv, dk, dq),
// about 64 GFLOP, against ~126 MB of operands read and written once: the
// bound is the tensor cores (~0.065 ms at 989 TFLOP/s). This first
// version does its products on the CUDA cores in f32 (no wgmma, no TMA),
// so in practice it is bound by the shared-memory traffic of those
// scalar products, far above either bound; tensor cores come in a later
// change. Its design answers the bytes side and the TPU kernel's
// sequential grid:
//  - one block per (batch, kv head, 64-key tile) keeps the tile's K, V
//    and its dk/dv accumulators on the chip while it loops over the q
//    tiles, starting at the causal diagonal (dead tiles are never read);
//  - the loop runs over every query head of the kv head's group inside
//    the block, so dk/dv come out already reduced onto the kv head (the
//    TPU path's `_reduce_kv_rows`) with no atomics;
//  - dq gathers contributions from every key tile, which Hopper runs in
//    no order: they go by atomicAdd into an f32 [B, Tq, H, D] buffer
//    (the TPU kernel's full-length VMEM scratch), scaled and cast to the
//    storage type by a last small kernel. The order of those atomics
//    changes from run to run, so dq may differ in its last bits.
//
// Semantics carried from the TPU kernel (`_flash_bwd_p_ds`):
//  - Delta = rowsum(dO * O) in f32, computed once per row by a pre-pass;
//  - p = exp(s * scale - lse) with lse taken as 0 where it is not finite
//    (a row with no live key has lse = -inf and p = 0 everywhere);
//  - masked, padded and causal entries fold in as -inf (p = 0), causal
//    against the end-aligned diagonal (row i sees keys j <= i + q_off);
//  - ds = p * (dp - Delta) carries no scale; dq and dk are scaled once at
//    write-out, dv is not.
// Layout [B, T, H, D] read through strides (D contiguous), GQA query head
// h reads kv head h / groups. Math is f32 throughout (inputs are upcast
// on load); each output is rounded once to its storage type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per block
constexpr int NTHREADS = 256;  // 8 warps
constexpr int RPT = 4;         // rows per thread
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

// Delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] (f32, [B, H, Tq]);
// one warp per row.
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, int Tq, int H, int D,
                             long long sob, long long sot, long long soh,
                             long long sdb, long long sdt, long long sdh,
                             long long rows) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp leaves together
  const int t = (int)(row % Tq);
  const long long bh = row / Tq;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const T* orow = o + b * sob + t * sot + h * soh;
  const T* drow = dout + b * sdb + t * sdt + h * sdh;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Thread t owns rows 4*(t/16) .. 4*(t/16)+3 of a tile (query rows for s,
// dp and dq; key rows for dk and dv) and columns (t%16) + 16*c of it.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ km, float* __restrict__ dq_acc,
                 T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,
                 int H, int Hkv, int groups, long long sqb, long long sqt,
                 long long sqh, long long skb, long long skt, long long skh,
                 long long svb, long long svt, long long svh, long long sdb,
                 long long sdt, long long sdh, int causal, int q_off,
                 float scale) {
  constexpr int DPT = D / 16;  // channels per thread
  constexpr int LD = D + 1;    // padded rows: conflict-free column reads
  constexpr int LP = BK + 1;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* Qs = Vs + BK * LD;      // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* Ps = dOs + BQ * LD;     // [BQ][LP]
  float* dSs = Ps + BQ * LP;     // [BQ][LP]
  float* Ls = dSs + BQ * LP;     // [BQ] lse, 0 where not finite
  float* Ds = Ls + BQ;           // [BQ] Delta
  float* Ms = Ds + BQ;           // [BK] 1 = live key

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = (tid / 16) * RPT;
  const int lane = tid % 16;

  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;
  for (int i = tid; i < BK * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int t = k0 + r;
    const bool in = t < Tk;
    Ks[r * LD + d] = in ? to_f(kb[t * skt + d]) : 0.f;
    Vs[r * LD + d] = in ? to_f(vb[t * svt + d]) : 0.f;
  }
  for (int i = tid; i < BK; i += NTHREADS) {
    const int t = k0 + i;
    Ms[i] = (t < Tk && (km == nullptr || km[(long long)b * Tk + t] > 0.f))
                ? 1.f
                : 0.f;
  }

  float adk[RPT][DPT], adv[RPT][DPT];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adk[rr][j] = adv[rr][j] = 0.f;

  // causal: the first query row that sees key k0 is k0 - q_off
  int qt_first = 0;
  if (causal && k0 - q_off > 0) qt_first = (k0 - q_off) / BQ;
  const int nqt = (Tq + BQ - 1) / BQ;

  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const T* qb = q + b * sqb + h * sqh;
    const T* db = dout + b * sdb + h * sdh;
    const float* lrow = lse + ((long long)b * H + h) * Tq;
    const float* drow = delta + ((long long)b * H + h) * Tq;
    // dq_acc is contiguous [B, Tq, H, D]
    float* dqb = dq_acc + ((long long)b * Tq * H + h) * D;
    for (int qt = qt_first; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // K/V/M staged; the previous tile's reads done
      for (int i = tid; i < BQ * D; i += NTHREADS) {
        const int r = i / D, d = i % D;
        const int t = q0 + r;
        const bool in = t < Tq;
        Qs[r * LD + d] = in ? to_f(qb[t * sqt + d]) : 0.f;
        dOs[r * LD + d] = in ? to_f(db[t * sdt + d]) : 0.f;
      }
      for (int i = tid; i < BQ; i += NTHREADS) {
        const int t = q0 + i;
        const float l = t < Tq ? lrow[t] : 0.f;
        Ls[i] = isfinite(l) ? l : 0.f;
        Ds[i] = t < Tq ? drow[t] : 0.f;
      }
      __syncthreads();

      // s = q k^T and dp = dO v^T for 4 rows x 4 columns
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[rr][c] = dp[rr][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          qv[rr] = Qs[(r0 + rr) * LD + d];
          ov[rr] = dOs[(r0 + rr) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          kv[c] = Ks[(lane + 16 * c) * LD + d];
          vv[c] = Vs[(lane + 16 * c) * LD + d];
        }
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            s[rr][c] = fmaf(qv[rr], kv[c], s[rr][c]);
            dp[rr][c] = fmaf(ov[rr], vv[c], dp[rr][c]);
          }
      }
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        const int qi = q0 + r0 + rr;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = lane + 16 * c;
          const bool live = qi < Tq && Ms[col] > 0.f &&
                            (!causal || k0 + col <= qi + q_off);
          const float p = live ? expf(s[rr][c] * scale - Ls[r0 + rr]) : 0.f;
          Ps[(r0 + rr) * LP + col] = p;
          dSs[(r0 + rr) * LP + col] = p * (dp[rr][c] - Ds[r0 + rr]);
        }
      }
      __syncthreads();

      // dv += p^T dO and dk += ds^T q (4 key rows x DPT channels)
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pv[RPT], sv[RPT];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          pv[rr] = Ps[i * LP + r0 + rr];
          sv[rr] = dSs[i * LP + r0 + rr];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float o = dOs[i * LD + lane + 16 * j];
          const float qq = Qs[i * LD + lane + 16 * j];
#pragma unroll
          for (int rr = 0; rr < RPT; ++rr) {
            adv[rr][j] = fmaf(pv[rr], o, adv[rr][j]);
            adk[rr][j] = fmaf(sv[rr], qq, adk[rr][j]);
          }
        }
      }

      // dq += ds k (4 query rows x DPT channels), into the f32 buffer
      float aq[RPT][DPT];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
        for (int j = 0; j < DPT; ++j) aq[rr][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float sv[RPT];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) sv[rr] = dSs[(r0 + rr) * LP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float kk = Ks[c * LD + lane + 16 * j];
#pragma unroll
          for (int rr = 0; rr < RPT; ++rr)
            aq[rr][j] = fmaf(sv[rr], kk, aq[rr][j]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        const int qi = q0 + r0 + rr;
        if (qi >= Tq) continue;
        float* dst = dqb + (long long)qi * H * D;
#pragma unroll
        for (int j = 0; j < DPT; ++j) atomicAdd(dst + lane + 16 * j, aq[rr][j]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int t = k0 + r0 + rr;
    if (t >= Tk) continue;
    const long long row = (((long long)b * Tk + t) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[row + lane + 16 * j] = from_f<T>(adk[rr][j] * scale);
      dv[row + lane + 16 * j] = from_f<T>(adv[rr][j]);
    }
  }
}

// dq = dq_acc * scale, rounded to the storage type.
template <typename T>
__global__ void dq_cast_kernel(const float* __restrict__ acc,
                               T* __restrict__ dq, long long n, float scale) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dq[i] = from_f<T>(acc[i] * scale);
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse, *km;
  void *dq, *dk, *dv, *dq_acc, *delta;
  int B, Tq, Tk, H, Hkv;
  long long sq[3], sk[3], sv[3], so[3], sd[3];
  int causal, q_off;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(const Args& a) {
  const long long n = (long long)a.B * a.Tq * a.H * D;
  cudaError_t e = cudaMemsetAsync(a.dq_acc, 0, n * sizeof(float), a.stream);
  if (e != cudaSuccess) return (int)e;

  const long long rows = (long long)a.B * a.H * a.Tq;
  const int warps = NTHREADS / 32;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), NTHREADS, 0,
                    a.stream>>>(
      (const T*)a.o, (const T*)a.dout, (float*)a.delta, a.Tq, a.H, D,
      a.so[0], a.so[1], a.so[2], a.sd[0], a.sd[1], a.sd[2], rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem =
      sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                       2 * BQ * (BK + 1) + 2 * BQ + BK);
  auto kern = flash_bwd_kernel<T, D>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Tk + BK - 1) / BK, a.Hkv, a.B);
  kern<<<grid, NTHREADS, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (const float*)a.km,
      (float*)a.dq_acc, (T*)a.dk, (T*)a.dv, a.Tq, a.Tk, a.H, a.Hkv,
      a.H / a.Hkv, a.sq[0], a.sq[1], a.sq[2], a.sk[0], a.sk[1], a.sk[2],
      a.sv[0], a.sv[1], a.sv[2], a.sd[0], a.sd[1], a.sd[2], a.causal,
      a.q_off, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  long long blocks = (n + NTHREADS - 1) / NTHREADS;
  if (blocks > 4096) blocks = 4096;
  dq_cast_kernel<T><<<(unsigned)blocks, NTHREADS, 0, a.stream>>>(
      (const float*)a.dq_acc, (T*)a.dq, n, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16:
      return launch<T, 16>(a);
    case 32:
      return launch<T, 32>(a);
    case 64:
      return launch<T, 64>(a);
    case 128:
      return launch<T, 128>(a);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, o, dout: [B, Tq, H, D]; k, v:
// [B, Tk, Hkv, D]; strides in elements, ordered (batch, time, head), the
// head dim contiguous. lse: float32 [B, H, Tq]; km: float32 [B, Tk] key
// mask (> 0 = attend) or null. Outputs, contiguous: dq [B, Tq, H, D], dk
// and dv [B, Tk, Hkv, D] in the storage type. Scratch: dq_acc float32
// [B, Tq, H, D] (zeroed here), delta float32 [B, H, Tq]. Returns 0, a
// cudaError_t code, or -1 for an unsupported dtype or head dim.
int dl4j_flash_attention_bwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, const void* km,
    void* dq, void* dk, void* dv, void* dq_acc, void* delta, int B, int Tq,
    int Tk, int H, int Hkv, long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh, long long svb, long long svt,
    long long svh, long long sob, long long sot, long long soh, long long sdb,
    long long sdt, long long sdh, int causal, int q_off, float scale,
    void* stream) {
  const Args a = {q,      k,      v,      o,     dout,  lse,   km,
                  dq,     dk,     dv,     dq_acc, delta, B,     Tq,
                  Tk,     H,      Hkv,    {sqb, sqt, sqh}, {skb, skt, skh},
                  {svb, svt, svh}, {sob, sot, soh}, {sdb, sdt, sdh},
                  causal, q_off,  scale,  (cudaStream_t)stream};
  if (dtype == 0) return dispatch_d<float>(head_dim, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(head_dim, a);
  return -1;
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
