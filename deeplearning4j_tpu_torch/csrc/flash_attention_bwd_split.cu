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
// K5 4 (s, dp, dv, dk), about 2.5 and 3.3 TFLOP, against ~0.3 GB of
// operands: the bound is the tensor cores (~2.5 and ~3.3 ms at 989
// TFLOP/s).
//  - K4 in bf16 is flash_bwd_dq_mma_kernel, the tensor-core loop of
//    flash_mma.cuh: one block per (batch, query head, 64-row query
//    tile), Q and dO resident in swizzled shared memory, lse and Delta
//    in registers, K/V tiles of 64 keys streamed through a two-stage
//    cp.async ring up to the causal diagonal (tiles past it never read,
//    tiles of dead keys skipped), one barrier a tile. Each tile: S =
//    Q.K^T and dP = dO.V^T on mma.sync, P = exp2(S * scale * log2 e -
//    lse * log2 e) by one FFMA and ex2, dS = P * (dP - Delta) rounded to
//    bf16 in registers (the TPU kernel's rounding), dq += dS.K with K
//    read transposed; dq is scaled once at the end. dq gathers every key
//    tile's share inside one block in a fixed order: no atomics, so dq
//    is the same to the bit from run to run (K3's is not). 98 KB of
//    shared memory at D = 128: two blocks an SM.
//  - K4 in f32 (the long-context agree phase, card vs CPU, whose 1e-3
//    gradient band a TF32 product would not hold) keeps the CUDA-core
//    flash_bwd_dq_kernel below, f32 throughout.
//  - K5 in bf16 is flash_bwd_kv_mma_kernel<D, false>, the key-stationary
//    tensor-core loop of flash_mma.cuh: one block per (batch, kv head,
//    64-key tile), key tile 0 of every head first (under causal masking
//    it walks the most query tiles), K and V resident in swizzled shared
//    memory, each warp owning 16 keys and their dk and dv (f32) in
//    registers. It walks the kv head's query heads and, for each, the
//    query tiles from the causal diagonal on, streaming Q, dO, lse and
//    Delta through a two-stage cp.async ring, one barrier a tile. Each
//    tile, in passes of 32 query columns at D = 128 (registers): S^T =
//    K.Q^T and dP^T = V.dO^T on mma.sync, P^T = exp2 by one FFMA, dS^T
//    = P^T (dP^T - Delta), both rounded to bf16 in registers (the TPU
//    kernel's rounding), dv += P^T.dO and dk += dS^T.Q with dO and Q
//    read transposed. dk/dv come out summed onto the kv head in a fixed
//    order (the TPU path's per-head outputs and `_reduce_kv_rows`), dk
//    scaled once, with no atomics: the same to the bit run to run. 97 KB
//    of shared memory at D = 128: two blocks an SM.
//  - K5 in f32 keeps K3's CUDA-core key-side pass without dq
//    (flash_bwd_kv_kernel with DQ off, flash_bwd_common.cuh).
//  - Delta = rowsum(dO * O) is computed once per call by the pre-pass
//    (`dl4j_flash_attention_bwd_delta`) and read by both.
// wgmma, TMA and warp specialisation are what is left beyond mma.sync.
// Both take the TPU kernels' two causal offsets (q_off, k_off): the
// single-device path passes (Tk - Tq, 0), the ring entries global ones.
#include "flash_bwd_common.cuh"
#include "flash_mma.cuh"

#include <type_traits>

namespace {

// The CUDA-core dq pass (f32). Thread t owns query rows 4*(t/16) ..
// 4*(t/16)+3 of the tile; for those rows it computes score columns
// (t%16) + 16*c and dq channels (t%16) + 16*j. KT keys a tile
// (dq_kv_tile: 32 above D = 128, where 64 would not fit shared memory).
template <typename T, int D, int KT>
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
  constexpr int CP = KT / 16;   // score columns per thread
  constexpr int LP = KT + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* Ks = dOs + BQ * LD;     // [KT][LD]
  float* Vs = Ks + KT * LD;      // [KT][LD]
  float* dSs = Vs + KT * LD;     // [BQ][LP]
  float* Ls = dSs + BQ * LP;     // [BQ] lse, 0 where not finite
  float* Ds = Ls + BQ;           // [BQ] Delta
  float* Ms = Ds + BQ;           // [KT] 1 = live key

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

  int nkt = (Tk + KT - 1) / KT;
  if (causal) {
    // the last key any row of this tile may see
    const int k_last = min(q0 + BQ, Tq) - 1 + q_off - k_off;
    nkt = min(nkt, k_last < 0 ? 0 : k_last / KT + 1);
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * KT;
    __syncthreads();  // Q/dO staged; the previous tile's reads done
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
    // block-uniform: a tile of dead keys adds nothing to dq
    if (!__syncthreads_or(live_key)) continue;

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
        dSs[(r0 + rr) * LP + col] = p * (dp[rr][c] - Ds[r0 + rr]);
      }
    }
    __syncthreads();

    // dq += ds k (4 query rows x DPT channels)
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

}  // namespace

namespace fmma {

// The bf16 tensor-core dq pass (flash_mma.cuh). Warp w owns rows 16w ..
// 16w + 15 of the 64-row query tile; lane (g = lane / 4, t4 = lane % 4)
// holds rows g and g + 8 of them, for every 8-key n-tile keys 2*t4,
// 2*t4 + 1, and for every 8-channel tile of dq the same columns.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ km, bf16* __restrict__ dq,
                        int Tq, int Tk, int H, int groups, long long sqb,
                        long long sqt, long long sqh, long long skb,
                        long long skt, long long skh, long long svb,
                        long long svt, long long svh, long long sdb,
                        long long sdt, long long sdh, int causal, int q_off,
                        int k_off, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][D]
  bf16* dOs = Qs + BQ * D;                        // [BQ][D]
  bf16* Ks = dOs + BQ * D;                        // [2][BK][D]
  bf16* Vs = Ks + 2 * BK * D;                     // [2][BK][D]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BK * D);   // [2][BK]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  // the last query tile first: under causal masking it has the most key
  // tiles, and the light ones then fill the last wave
  const int q0 = (int)(gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / groups;
  const int rw = warp * 16;              // the warp's first row in the tile
  const int row0 = q0 + rw + (lane >> 2);   // this thread's rows: +0, +8
  const float scale_log2 = scale * LOG2E;

  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* db = dout + b * sdb + h * sdh;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;
  const float* kmb = km == nullptr ? nullptr : km + (long long)b * Tk;
  const int nkt = key_tiles(q0, Tq, Tk, causal, q_off, k_off);

  load_tile<D, BQ>(Qs, qb, sqt, q0, Tq, vec);
  load_tile<D, BQ>(dOs, db, sdt, q0, Tq, vec);
  if (nkt > 0) {
    load_tile<D, BK>(Ks, kb, skt, 0, Tk, vec);
    load_tile<D, BK>(Vs, vb, svt, 0, Tk, vec);
    load_mask(Ms, kmb, 0, Tk);
  }
  cp_async_commit();

  // this thread's rows' lse (0 where not finite) in log2 units, and Delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long at = ((long long)b * H + h) * Tq + row;
    const float lv = row < Tq ? lse[at] : 0.f;
    lse2[i] = isfinite(lv) ? lv * LOG2E : 0.f;
    dlt[i] = row < Tq ? delta[at] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    cp_async_wait<0>();   // this tile (and, at kt = 0, Q and dO) landed
    const float* ms = Ms + st * BK;
    // one barrier a tile: this tile visible to all, and every warp done
    // with the previous tile, whose stage the next tile then refills
    const bool any =
        __syncthreads_or(threadIdx.x < BK && ms[threadIdx.x] > 0.f) != 0;
    if (kt + 1 < nkt) {   // the next tile into the other stage
      load_tile<D, BK>(Ks + (st ^ 1) * BK * D, kb, skt, k0 + BK, Tk, vec);
      load_tile<D, BK>(Vs + (st ^ 1) * BK * D, vb, svt, k0 + BK, Tk, vec);
      load_mask(Ms + (st ^ 1) * BK, kmb, k0 + BK, Tk);
    }
    cp_async_commit();
    // block-uniform: a tile of dead keys adds nothing to dq
    if (any) {
      const bf16* kt_s = Ks + st * BK * D;
      const bf16* vt_s = Vs + st * BK * D;
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4];
        load_a<D>(a, Qs, rw, kk);
        mma_abt_kstep<D, BK>(s, a, kt_s, 0, kk);
        load_a<D>(a, dOs, rw, kk);
        mma_abt_kstep<D, BK>(dp, a, vt_s, 0, kk);
      }
      // warp-uniform: every key of the tile live for every row of the warp
      const bool full = kmb == nullptr && k0 + BK <= Tk &&
                        (!causal || k_off + k0 + BK - 1 <= q_off + q0 + rw);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const bool live =
              full || live_key(ms, n * 8 + 2 * t4 + (e & 1), k0,
                               row0 + 8 * i, causal, q_off, k_off);
          const float p =
              live ? ex2(fmaf(s[n][e], scale_log2, -lse2[i])) : 0.f;
          s[n][e] = p * (dp[n][e] - dlt[i]);   // dS, without the scale
        }
      uint32_t ds[BK / 16][4];
      to_a_frags<BK>(ds, s);
      mma_ab<D, BK>(acc, ds, kt_s, 0);
    }
  }
  cp_async_wait<0>();   // no copy left in flight (nkt = 0: Q's and dO's)
  const float mul[2] = {scale, scale};   // dS carries no scale: once here
  store_rows<D>(dq, acc, mul, b, row0, Tq, H, h);
}

}  // namespace fmma

namespace {

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
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t smem = fmma::smem_bytes<D>(2);
    static const cudaError_t attr =
        fmma::set_smem_attr(fmma::flash_bwd_dq_mma_kernel<D>, smem);
    if (attr != cudaSuccess) return (int)attr;
    const int vec = fmma::vec_ok(a.q, a.sq[0], a.sq[1], a.sq[2]) &&
                    fmma::vec_ok(a.k, a.sk[0], a.sk[1], a.sk[2]) &&
                    fmma::vec_ok(a.v, a.sv[0], a.sv[1], a.sv[2]) &&
                    fmma::vec_ok(a.dout, a.sd[0], a.sd[1], a.sd[2]);
    fmma::flash_bwd_dq_mma_kernel<D><<<grid, fmma::NTHREADS, smem,
                                       a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (const float*)a.km,
        (T*)a.dq, a.Tq, a.Tk, a.H, a.H / a.Hkv, a.sq[0], a.sq[1], a.sq[2],
        a.sk[0], a.sk[1], a.sk[2], a.sv[0], a.sv[1], a.sv[2], a.sd[0],
        a.sd[1], a.sd[2], a.causal, a.q_off, a.k_off, a.scale, vec);
  } else {
    constexpr int KT = kv_tile<D>();
    constexpr size_t smem = sizeof(float) * (2 * BQ * (D + 1) +
                                             2 * KT * (D + 1) +
                                             BQ * (KT + 1) + 2 * BQ + KT);
    static const cudaError_t attr =
        fmma::set_smem_attr(flash_bwd_dq_kernel<T, D, KT>, smem);
    if (attr != cudaSuccess) return (int)attr;
    flash_bwd_dq_kernel<T, D, KT><<<grid, NTHREADS, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (const float*)a.km,
        (T*)a.dq, a.Tq, a.Tk, a.H, a.H / a.Hkv, a.sq[0], a.sq[1], a.sq[2],
        a.sk[0], a.sk[1], a.sk[2], a.sv[0], a.sv[1], a.sv[2], a.sd[0],
        a.sd[1], a.sd[2], a.causal, a.q_off, a.k_off, a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return (int)fmma::launch_bwd_kv_mma<D, false>(
        a.q, a.k, a.v, a.dout, (const float*)a.lse, (const float*)a.delta,
        (const float*)a.km, nullptr, a.dk, a.dv, a.B, a.Tq, a.Tk, a.H,
        a.Hkv, a.sq, a.sk, a.sv, a.sd, a.causal, a.q_off, a.k_off, a.scale,
        a.stream);
  } else {
    constexpr int KT = kv_tile<D>();
    constexpr size_t smem = kv_smem_bytes<D, KT>();
    static const cudaError_t attr =
        fmma::set_smem_attr(flash_bwd_kv_kernel<T, D, false, KT>, smem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((a.Tk + KT - 1) / KT, a.Hkv, a.B);
    flash_bwd_kv_kernel<T, D, false, KT><<<grid, NTHREADS, smem,
                                           a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (const float*)a.km,
        nullptr, (T*)a.dk, (T*)a.dv, a.Tq, a.Tk, a.H, a.Hkv, a.H / a.Hkv,
        a.sq[0], a.sq[1], a.sq[2], a.sk[0], a.sk[1], a.sk[2], a.sv[0],
        a.sv[1], a.sv[2], a.sd[0], a.sd[1], a.sd[2], a.causal, a.q_off,
        a.k_off, a.scale);
    return (int)cudaGetLastError();
  }
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
    case 256:
      return DKV ? launch_dkv<T, 256>(a) : launch_dq<T, 256>(a);
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
