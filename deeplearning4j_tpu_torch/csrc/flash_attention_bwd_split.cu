// Split flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` (K4) and
// `_flash_bwd_dkv_kernel` (K5) of deeplearning4j_tpu/ops/pallas_kernels.py,
// which `_flash_bwd` takes instead of the fused K3 once the fused
// kernel's full-length dq scratch (tq * dp * 4 bytes) passes 12 MiB: at
// head dim 128, past 24 576 tokens. Each pass recomputes the probability
// tile from the saved row logsumexp; neither writes the [Tq, Tk] score
// matrix to device memory.
//
// What bounds them on this card: at the long-context path's shape (q, k,
// v, o, dO [1, 32768, 6, 128] bf16, causal; 3.2e9 live (query, key) pairs
// over the heads) K4 does 3 products of 2*D flops a pair (s, dp, dq) and
// K5 4 (s, dp, dv, dk), about 7.7 and 10.3 TFLOP, against ~0.3 GB of
// operands: the bound is the tensor cores (~2.5 and ~3.3 ms at 989
// TFLOP/s). This first version does its products on the CUDA cores in
// f32 (no wgmma, no TMA), like K1 and K3, so in practice it is bound by
// the shared-memory traffic of those scalar products, far above either
// bound; tensor cores come in a later change. The design answers the
// TPU kernels' sequential grids and K3's atomics:
//  - K4 gives a block one (batch, query head, 64-row query tile), keeps
//    Q, dO and the tile's dq accumulator on the chip, and loops over the
//    key tiles up to the causal diagonal (tiles past it are never read),
//    skipping tiles whose keys are all masked. dq gathers every key
//    tile's share inside one block, in a fixed order: no atomics, so dq
//    is the same to the bit from run to run (K3's is not);
//  - K5 is K3's key-side pass without dq (flash_bwd_kv_kernel with DQ
//    off, flash_bwd_common.cuh): one block per (batch, kv head, 64-key
//    tile), looping over the group's query heads and the live query
//    tiles, so dk/dv come out already summed onto the kv head (the TPU
//    path's per-head outputs and `_reduce_kv_rows`, in a fixed order);
//  - Delta = rowsum(dO * O) is computed once per call by the pre-pass
//    (`dl4j_flash_attention_bwd_delta`) and read by both.
// Both take the TPU kernels' two causal offsets (q_off, k_off): the
// single-device path passes (Tk - Tq, 0), the ring entries global ones.
#include "flash_bwd_common.cuh"

namespace {

// Thread t owns query rows 4*(t/16) .. 4*(t/16)+3 of the tile; for those
// rows it computes score columns (t%16) + 16*c and dq channels
// (t%16) + 16*j.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ km, T* __restrict__ dq,
                    int Tq, int Tk, int H, int groups, long long sqb,
                    long long sqt, long long sqh, long long skb,
                    long long skt, long long skh, long long svb,
                    long long svt, long long svh, long long sdb,
                    long long sdt, long long sdh, int causal, int q_off,
                    int k_off, float scale) {
  constexpr int DPT = D / 16;  // dq channels per thread
  constexpr int LD = D + 1;    // padded rows: conflict-free column reads
  constexpr int LP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* Ks = dOs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* dSs = Vs + BK * LD;     // [BQ][LP]
  float* Ls = dSs + BQ * LP;     // [BQ] lse, 0 where not finite
  float* Ds = Ls + BQ;           // [BQ] Delta
  float* Ms = Ds + BQ;           // [BK] 1 = live key

  const int tid = threadIdx.x;
  // the last query tile first: under causal masking it has the most key
  // tiles, and the light ones then fill the last wave
  const int q0 = (int)(gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / groups;
  const int r0 = (tid / 16) * RPT;
  const int lane = tid % 16;

  const T* qb = q + b * sqb + h * sqh;
  const T* db = dout + b * sdb + h * sdh;
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;
  const float* lrow = lse + ((long long)b * H + h) * Tq;
  const float* drow = delta + ((long long)b * H + h) * Tq;
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

  float acc[RPT][DPT];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[rr][j] = 0.f;

  int nkt = (Tk + BK - 1) / BK;
  if (causal) {
    // the last key any row of this tile may see
    const int k_last = min(q0 + BQ, Tq) - 1 + q_off - k_off;
    nkt = min(nkt, k_last < 0 ? 0 : k_last / BK + 1);
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q/dO staged; the previous tile's reads done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const int t = k0 + r;
      const bool in = t < Tk;
      Ks[r * LD + d] = in ? to_f(kb[t * skt + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f(vb[t * svt + d]) : 0.f;
    }
    int live_key = 0;
    for (int i = tid; i < BK; i += NTHREADS) {
      const int t = k0 + i;
      const bool m =
          t < Tk && (km == nullptr || km[(long long)b * Tk + t] > 0.f);
      Ms[i] = m ? 1.f : 0.f;
      live_key |= (int)m;
    }
    // block-uniform: a tile of dead keys adds nothing to dq
    if (!__syncthreads_or(live_key)) continue;

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
                          (!causal || k_off + k0 + col <= qi + q_off);
        const float p = live ? expf(s[rr][c] * scale - Ls[r0 + rr]) : 0.f;
        dSs[(r0 + rr) * LP + col] = p * (dp[rr][c] - Ds[r0 + rr]);
      }
    }
    __syncthreads();

    // dq += ds k (4 query rows x DPT channels)
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
          acc[rr][j] = fmaf(sv[rr], kk, acc[rr][j]);
      }
    }
  }

  // dS carries no scale: applied once here
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= Tq) continue;
    T* row = dq + (((long long)b * Tq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      row[lane + 16 * j] = from_f<T>(acc[rr][j] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *km;
  void *dq, *dk, *dv;
  int B, Tq, Tk, H, Hkv;
  long long sq[3], sk[3], sv[3], sd[3];
  int causal, q_off, k_off;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  constexpr size_t smem = sizeof(float) * (2 * BQ * (D + 1) +
                                           2 * BK * (D + 1) +
                                           BQ * (BK + 1) + 2 * BQ + BK);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NTHREADS, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (const float*)a.km,
      (T*)a.dq, a.Tq, a.Tk, a.H, a.H / a.Hkv, a.sq[0], a.sq[1], a.sq[2],
      a.sk[0], a.sk[1], a.sk[2], a.sv[0], a.sv[1], a.sv[2], a.sd[0],
      a.sd[1], a.sd[2], a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t smem = kv_smem_bytes<D>();
  auto kern = flash_bwd_kv_kernel<T, D, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Tk + BK - 1) / BK, a.Hkv, a.B);
  kern<<<grid, NTHREADS, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (const float*)a.km,
      nullptr, (T*)a.dk, (T*)a.dv, a.Tq, a.Tk, a.H, a.Hkv, a.H / a.Hkv,
      a.sq[0], a.sq[1], a.sq[2], a.sk[0], a.sk[1], a.sk[2], a.sv[0],
      a.sv[1], a.sv[2], a.sd[0], a.sd[1], a.sd[2], a.causal, a.q_off,
      a.k_off, a.scale);
  return (int)cudaGetLastError();
}

// K5 (DKV) or K4, by head dim and dtype.
template <bool DKV, typename T>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16:
      return DKV ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32:
      return DKV ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64:
      return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128:
      return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default:
      return -1;
  }
}

template <bool DKV>
int dispatch(int dtype, int D, const Args& a) {
  if (dtype == 0) return dispatch_d<DKV, float>(D, a);
  if (dtype == 1) return dispatch_d<DKV, __nv_bfloat16>(D, a);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. o, dout: [B, Tq, H, D], strides in
// elements ordered (batch, time, head), the head dim contiguous. Writes
// delta, float32 [B, H, Tq]. Returns 0, a cudaError_t code, or -1 for an
// unsupported dtype.
int dl4j_flash_attention_bwd_delta(int dtype, int head_dim, const void* o,
                                   const void* dout, void* delta, int B,
                                   int Tq, int H, long long sob,
                                   long long sot, long long soh,
                                   long long sdb, long long sdt,
                                   long long sdh, void* stream) {
  const long long so[3] = {sob, sot, soh};
  const long long sd[3] = {sdb, sdt, sdh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_delta<float>(o, dout, delta, B, Tq, H, head_dim, so, sd,
                               st);
  if (dtype == 1)
    return launch_delta<__nv_bfloat16>(o, dout, delta, B, Tq, H, head_dim,
                                       so, sd, st);
  return -1;
}

// K4. q, dout: [B, Tq, H, D]; k, v: [B, Tk, Hkv, D]; strides in elements,
// ordered (batch, time, head), the head dim contiguous. lse, delta:
// float32 [B, H, Tq]; km: float32 [B, Tk] key mask (> 0 = attend) or
// null. Causal: row i sees key j when k_off + j <= q_off + i. Writes dq,
// contiguous [B, Tq, H, D] in the storage type. Returns 0, a cudaError_t
// code, or -1 for an unsupported dtype or head dim.
int dl4j_flash_attention_bwd_dq(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, const void* km,
    void* dq, int B, int Tq, int Tk, int H, int Hkv, long long sqb,
    long long sqt, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh,
    long long sdb, long long sdt, long long sdh, int causal, int q_off,
    int k_off, float scale, void* stream) {
  const Args a = {q,     k,     v,     dout,  lse,  delta,
                  km,    dq,    nullptr, nullptr, B,  Tq,
                  Tk,    H,     Hkv,   {sqb, sqt, sqh}, {skb, skt, skh},
                  {svb, svt, svh}, {sdb, sdt, sdh}, causal, q_off, k_off,
                  scale, (cudaStream_t)stream};
  return dispatch<false>(dtype, head_dim, a);
}

// K5. The same arguments as K4; writes dk and dv, contiguous
// [B, Tk, Hkv, D] in the storage type, summed over each kv head's query
// heads.
int dl4j_flash_attention_bwd_dkv(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, const void* km,
    void* dk, void* dv, int B, int Tq, int Tk, int H, int Hkv, long long sqb,
    long long sqt, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh,
    long long sdb, long long sdt, long long sdh, int causal, int q_off,
    int k_off, float scale, void* stream) {
  const Args a = {q,     k,     v,     dout,  lse,  delta,
                  km,    nullptr, dk,  dv,    B,    Tq,
                  Tk,    H,     Hkv,   {sqb, sqt, sqh}, {skb, skt, skh},
                  {svb, svt, svh}, {sdb, sdt, sdh}, causal, q_off, k_off,
                  scale, (cudaStream_t)stream};
  return dispatch<true>(dtype, head_dim, a);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
