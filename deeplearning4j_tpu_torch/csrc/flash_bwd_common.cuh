// Pieces shared by the flash-attention backward kernels: the fused K3
// (flash_attention_bwd.cu) and the split pair K4, K5
// (flash_attention_bwd_split.cu): the Delta pre-pass, and the f32
// CUDA-core key-side pass that K3 and K5 run on f32 inputs (bf16 inputs
// take the tensor-core loops of flash_mma.cuh). ops/cuda_build.py hashes
// this header into the key of every library, so an edit rebuilds both.
//
// Semantics carried from the TPU kernels (`_flash_bwd_p_ds` of
// deeplearning4j_tpu/ops/pallas_kernels.py):
//  - Delta = rowsum(dO * O) in f32, computed once per row by a pre-pass;
//  - p = exp(s * scale - lse) with lse taken as 0 where it is not finite
//    (a row with no live key has lse = -inf and p = 0 everywhere);
//  - masked, padded and causal entries fold in as -inf (p = 0), causal
//    against the offset diagonal: query row i sees key j when
//    k_off + j <= q_off + i (the end-aligned path passes q_off = Tk - Tq,
//    k_off = 0; the ring entries pass global offsets);
//  - a key tile whose mask is all zero is skipped (`jnp.any(km > 0)`);
//  - ds = p * (dp - Delta) carries no scale; dq and dk are scaled once at
//    write-out, dv is not.
// Layout [B, T, H, D] read through strides (D contiguous), GQA query head
// h reads kv head h / groups. The kernels here are f32 throughout (the
// pre-pass upcasts bf16 on load); the bf16 kernels of flash_mma.cuh keep
// the same semantics with bf16 operands and f32 sums. Each output is
// rounded once to its storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
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

template <typename T>
int launch_delta(const void* o, const void* dout, void* delta, int B, int Tq,
                 int H, int D, const long long* so, const long long* sd,
                 cudaStream_t stream) {
  const long long rows = (long long)B * H * Tq;
  const int warps = NTHREADS / 32;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), NTHREADS, 0,
                    stream>>>((const T*)o, (const T*)dout, (float*)delta, Tq,
                              H, D, so[0], so[1], so[2], sd[0], sd[1], sd[2],
                              rows);
  return (int)cudaGetLastError();
}

// Keys a tile of the f32 kernels that keep a [keys][D] K and V tile
// beside [64][D] query-side tiles (flash_bwd_kv_kernel, the split file's
// dq pass): 64, or 32 above D = 128, where 64 keys would pass the 227 KB
// of shared memory a block may take.
template <int D>
__host__ __device__ constexpr int kv_tile() {
  return D > 128 ? 32 : BK;
}

// Shared memory of flash_bwd_kv_kernel at KT keys a tile, in bytes.
template <int D, int KT>
constexpr size_t kv_smem_bytes() {
  return sizeof(float) * (2 * KT * (D + 1) + 2 * BQ * (D + 1) +
                          2 * BQ * (KT + 1) + 2 * BQ + KT);
}

// The f32 key-side pass: one block per (batch, kv head, 64-key tile) keeps
// the tile's K, V and its dk/dv accumulators on the chip while it loops
// over every query head of the kv head's group and, for each, over the
// live query tiles from the causal diagonal on. dk/dv come out already
// reduced onto the kv head, summed in a fixed order, with no atomics.
// With DQ (K3) each tile pair also adds its dq share by atomicAdd into
// the f32 buffer dq_acc [B, Tq, H, D]; without it (K5) dq_acc is unused.
//
// Thread t owns rows 4*(t/16) .. 4*(t/16)+3 of a tile (query rows for s,
// dp and dq; key rows for dk and dv) and columns (t%16) + 16*c of it. At
// KT = 32 keys a tile (kv_tile) the threads past the 32 key rows take no
// dk/dv rows.
template <typename T, int D, bool DQ, int KT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ km, float* __restrict__ dq_acc,
                    T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,
                    int H, int Hkv, int groups, long long sqb, long long sqt,
                    long long sqh, long long skb, long long skt,
                    long long skh, long long svb, long long svt,
                    long long svh, long long sdb, long long sdt,
                    long long sdh, int causal, int q_off, int k_off,
                    float scale) {
  constexpr int DPT = D / 16;  // channels per thread
  constexpr int LD = D + 1;    // padded rows: conflict-free column reads
  constexpr int CP = KT / 16;   // score columns per thread
  constexpr int LP = KT + 1;
  extern __shared__ float smem[];
  float* Ks = smem;              // [KT][LD]
  float* Vs = Ks + KT * LD;      // [KT][LD]
  float* Qs = Vs + KT * LD;      // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* Ps = dOs + BQ * LD;     // [BQ][LP]
  float* dSs = Ps + BQ * LP;     // [BQ][LP]
  float* Ls = dSs + BQ * LP;     // [BQ] lse, 0 where not finite
  float* Ds = Ls + BQ;           // [BQ] Delta
  float* Ms = Ds + BQ;           // [KT] 1 = live key

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * KT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = (tid / 16) * RPT;
  const int lane = tid % 16;

  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;
  for (int i = tid; i < KT * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int t = k0 + r;
    const bool in = t < Tk;
    Ks[r * LD + d] = in ? to_f(kb[t * skt + d]) : 0.f;
    Vs[r * LD + d] = in ? to_f(vb[t * svt + d]) : 0.f;
  }
  int live_key = 0;
  for (int i = tid; i < KT; i += NTHREADS) {
    const int t = k0 + i;
    const bool m =
        t < Tk && (km == nullptr || km[(long long)b * Tk + t] > 0.f);
    Ms[i] = m ? 1.f : 0.f;
    live_key |= (int)m;
  }
  // block-uniform: a tile of dead keys gets zero gradients, no work
  const bool tile_live = __syncthreads_or(live_key) != 0;

  float adk[RPT][DPT], adv[RPT][DPT];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adk[rr][j] = adv[rr][j] = 0.f;

  // causal: the first query row that sees key k0 is k0 + k_off - q_off
  int qt_first = 0;
  if (causal && k0 + k_off - q_off > 0) qt_first = (k0 + k_off - q_off) / BQ;
  const int nqt = tile_live ? (Tq + BQ - 1) / BQ : 0;

  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const T* qb = q + b * sqb + h * sqh;
    const T* db = dout + b * sdb + h * sdh;
    const float* lrow = lse + ((long long)b * H + h) * Tq;
    const float* drow = delta + ((long long)b * H + h) * Tq;
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

      // s = q k^T and dp = dO v^T for 4 rows x CP columns
      float s[RPT][CP], dp[RPT][CP];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
        for (int c = 0; c < CP; ++c) s[rr][c] = dp[rr][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[RPT], ov[RPT], kv[CP], vv[CP];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          qv[rr] = Qs[(r0 + rr) * LD + d];
          ov[rr] = dOs[(r0 + rr) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          kv[c] = Ks[(lane + 16 * c) * LD + d];
          vv[c] = Vs[(lane + 16 * c) * LD + d];
        }
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
          for (int c = 0; c < CP; ++c) {
            s[rr][c] = fmaf(qv[rr], kv[c], s[rr][c]);
            dp[rr][c] = fmaf(ov[rr], vv[c], dp[rr][c]);
          }
      }
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        const int qi = q0 + r0 + rr;
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const int col = lane + 16 * c;
          const bool live = qi < Tq && Ms[col] > 0.f &&
                            (!causal || k_off + k0 + col <= qi + q_off);
          const float p = live ? expf(s[rr][c] * scale - Ls[r0 + rr]) : 0.f;
          Ps[(r0 + rr) * LP + col] = p;
          dSs[(r0 + rr) * LP + col] = p * (dp[rr][c] - Ds[r0 + rr]);
        }
      }
      __syncthreads();

      // dv += p^T dO and dk += ds^T q (4 key rows x DPT channels);
      // warp-uniform: a warp's key rows all inside the tile, or none
#pragma unroll 4
      for (int i = 0; i < (r0 < KT ? BQ : 0); ++i) {
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

      if constexpr (DQ) {
        // dq += ds k (4 query rows x DPT channels), into the f32 buffer
        // (contiguous [B, Tq, H, D])
        float* dqb = dq_acc + ((long long)b * Tq * H + h) * D;
        float aq[RPT][DPT];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
          for (int j = 0; j < DPT; ++j) aq[rr][j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < KT; ++c) {
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
          for (int j = 0; j < DPT; ++j)
            atomicAdd(dst + lane + 16 * j, aq[rr][j]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int t = k0 + r0 + rr;
    if (r0 >= KT || t >= Tk) continue;
    const long long row = (((long long)b * Tk + t) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[row + lane + 16 * j] = from_f<T>(adk[rr][j] * scale);
      dv[row + lane + 16 * j] = from_f<T>(adv[rr][j]);
    }
  }
}

}  // namespace
