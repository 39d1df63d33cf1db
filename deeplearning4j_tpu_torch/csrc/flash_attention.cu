// Flash-attention forward for Hopper (sm_90a), plain C interface (K1).
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
// bytes, above it the tensor cores (the train, fine-tune and
// long-context shapes).
//
// Two kernels behind one entry, picked by dtype:
//  - bf16, the model's paths: flash_fwd_mma_kernel, the tensor-core
//    loop of flash_mma.cuh. A block owns a 64-row query tile, loads it
//    once into swizzled shared memory and keeps its A fragments in
//    registers; K/V tiles of 64 keys stream through a two-stage cp.async
//    ring up to the causal diagonal (tiles past it are never loaded,
//    tiles of dead keys are skipped), one barrier a tile; S = Q.K^T and
//    O += P.V run on mma.sync with f32 sums, the online softmax stays in
//    the accumulator registers (ex2 of scores scaled by one FFMA, the
//    rescale skipped once a warp's row maxima settle), and P is rounded
//    to bf16 as the TPU kernel rounds it. Shared memory 82 KB at D =
//    128. A grid that fills the card runs 4 warps a block, two blocks
//    an SM. A short grid (fewer blocks than two an SM, as a single
//    prompt's prefill) runs 8: two groups of 4 warps split each key
//    tile, halving the serial walk of the longest query tile, and merge
//    their softmax states at the end. Tensor cores are the bound it
//    answers; wgmma, TMA and warp specialisation are what is left
//    beyond it.
//  - f32, the agree phases' card-vs-CPU checks: flash_fwd_kernel, the
//    CUDA-core kernel, f32 throughout (inputs upcast on load). A TF32
//    tensor-core product keeps ~3 decimal digits and would not hold
//    those checks' 1e-5 loss and 1e-3 gradient bands.
//
// Semantics carried from the TPU kernel, by both:
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
// The output is rounded once to the storage type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 256;  // 8 warps
constexpr int RPT = 4;         // query rows per thread
constexpr int CPT = BK / 16;   // score columns per thread

// Thread t owns query rows 4*(t/16) .. 4*(t/16)+3 of the tile; for those
// rows it computes score columns (t%16) + 16*c and output channels
// (t%16) + 16*j. The 16 threads sharing a row group are one half-warp,
// so row max and row sum reduce with xor shuffles of offset < 16.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ km,
                 float* __restrict__ o, float* __restrict__ lse, int Tq,
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

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + hk * skh;
  const float* vb = v + b * svb + hk * svh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[r * LD + d] = t < Tq ? qb[t * sqt + d] : 0.f;
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
      Ks[r * LD + d] = in ? kb[t * skt + d] : 0.f;
      Vs[r * D + d] = in ? vb[t * svt + d] : 0.f;
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
    float* orow = o + (((long long)b * Tq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      orow[lane + 16 * j] = acc[rr][j] / den;
    if (lse != nullptr && lane == 0)
      lse[((long long)b * H + h) * Tq + qi] = m[rr] + logf(den);
  }
}

}  // namespace

namespace fmma {

// The bf16 tensor-core kernel (flash_mma.cuh), G key groups of 4 warps.
// Warp w of group g owns rows 16w .. 16w + 15 of the 64-row query tile
// and keys 64/G*g .. 64/G*(g+1) - 1 of every key tile; lane (r = lane /
// 4, t4 = lane % 4) holds rows r and r + 8, for every 8-key n-tile keys
// 2*t4, 2*t4 + 1, and for every 8-channel tile of the output the same
// columns. Each group keeps its own online softmax over its keys; at the
// end group 1 hands (m, l, acc) to group 0 through shared memory, which
// merges them. The running max m is kept on the raw scores; p =
// exp2(s * scale_log2 - m * scale_log2), scale_log2 = scale * log2 e.
template <int D, int G>
__global__ void __launch_bounds__(NTHREADS * G)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ km, bf16* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int H,
                     int groups, long long sqb, long long sqt, long long sqh,
                     long long skb, long long skt, long long skh,
                     long long svb, long long svt, long long svh, int causal,
                     int q_off, float scale_log2, int vec) {
  constexpr int NTHR = NTHREADS * G;
  constexpr int KW = BK / G;             // keys of a tile a warp takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][D]
  bf16* Ks = Qs + BQ * D;                         // [2][BK][D]
  bf16* Vs = Ks + 2 * BK * D;                     // [2][BK][D]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BK * D);   // [2][BK]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int grp = warp / 4, key0 = grp * KW;
  // the last query tile first: under causal masking it has the most key
  // tiles, and the light ones then fill the last wave
  const int q0 = (int)(gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / groups;
  const int rw = (warp % 4) * 16;        // the warp's first row in the tile
  const int row0 = q0 + rw + (lane >> 2);   // this thread's rows: +0, +8

  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;
  const float* kmb = km == nullptr ? nullptr : km + (long long)b * Tk;
  const int nkt = key_tiles(q0, Tq, Tk, causal, q_off, 0);

  load_tile<D, BQ, NTHR>(Qs, qb, sqt, q0, Tq, vec);
  if (nkt > 0) {
    load_tile<D, BK, NTHR>(Ks, kb, skt, 0, Tk, vec);
    load_tile<D, BK, NTHR>(Vs, vb, svt, 0, Tk, vec);
    load_mask<NTHR>(Ms, kmb, 0, Tk);
  }
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // the warp's Q fragments stay in registers up to D = 128; above, the
  // 16 x D accumulator leaves no room and each tile reads them again
  constexpr bool QREG = D <= 128;
  uint32_t qf[QREG ? D / 16 : 1][4];

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    cp_async_wait<0>();   // this tile (and, at kt = 0, Q) has landed
    const float* ms = Ms + st * BK;
    // one barrier a tile: this tile visible to all, and every warp done
    // with the previous tile, whose stage the next tile then refills
    const bool any =
        __syncthreads_or(threadIdx.x < BK && ms[threadIdx.x] > 0.f) != 0;
    if (QREG && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D; kk += 16)
        load_a<D>(qf[QREG ? kk / 16 : 0], Qs, rw, kk);
    }
    if (kt + 1 < nkt) {   // the next tile into the other stage
      load_tile<D, BK, NTHR>(Ks + (st ^ 1) * BK * D, kb, skt, k0 + BK, Tk,
                             vec);
      load_tile<D, BK, NTHR>(Vs + (st ^ 1) * BK * D, vb, svt, k0 + BK, Tk,
                             vec);
      load_mask<NTHR>(Ms + (st ^ 1) * BK, kmb, k0 + BK, Tk);
    }
    cp_async_commit();
    // block-uniform: a tile of dead keys adds nothing; warp-uniform: the
    // warp's keys all past Tk or past its rows' diagonal add nothing
    const int kw0 = k0 + key0;
    if (any && kw0 < Tk && (!causal || kw0 <= q0 + rw + 15 + q_off)) {
      const bf16* kt_s = Ks + st * BK * D;
      float s[KW / 8][4];
#pragma unroll
      for (int n = 0; n < KW / 8; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        if (!QREG) load_a<D>(qf[0], Qs, rw, kk);
        mma_abt_kstep<D, KW>(s, qf[QREG ? kk / 16 : 0], kt_s, key0, kk);
      }
      // every key of the warp's share live for every row of the warp
      const bool full = kmb == nullptr && kw0 + KW <= Tk &&
                        (!causal || kw0 + KW - 1 <= q0 + rw + q_off);
      if (!full) {
#pragma unroll
        for (int n = 0; n < KW / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!live_key(ms, key0 + n * 8 + 2 * t4 + (e & 1), k0,
                          row0 + 8 * (e >> 1), causal, q_off, 0))
              s[n][e] = -INFINITY;
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < KW / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // rows with no live key so far keep m = -inf and p = 0
        const float safe = m_new == -INFINITY ? 0.f : m_new;
        const float shift = safe * scale_log2;
        // from the raw difference: exactly 1 while the max holds (m *
        // scale_log2 - shift would contract to an FMA and leave a
        // rounding residual that compounds over the tiles)
        alpha[i] = m[i] == -INFINITY ? 0.f : ex2((m[i] - safe) * scale_log2);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < KW / 8; ++n) {
          // p = exp2(s * scale * log2 e - m * scale * log2 e); ex2(-inf) = 0
          s[n][2 * i] = ex2(fmaf(s[n][2 * i], scale_log2, -shift));
          s[n][2 * i + 1] = ex2(fmaf(s[n][2 * i + 1], scale_log2, -shift));
          rs += s[n][2 * i] + s[n][2 * i + 1];
        }
        l[i] = l[i] * alpha[i] + rs;   // this thread's share of the row sum
        m[i] = m_new;
      }
      // warp-uniform: once the rows' maxima settle (most tiles of a long
      // row), alpha is 1 for the whole warp and the rescale is skipped
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[j][0] *= alpha[0];
          acc[j][1] *= alpha[0];
          acc[j][2] *= alpha[1];
          acc[j][3] *= alpha[1];
        }
      }
      uint32_t pf[KW / 16][4];
      to_a_frags<KW>(pf, s);
      mma_ab<D, KW>(acc, pf, Vs + st * BK * D, key0);
    }
  }
  cp_async_wait<0>();   // no copy left in flight (nkt = 0: Q's)

#pragma unroll
  for (int i = 0; i < 2; ++i) {   // the row sums over the quad
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (G == 2) {
    // group 1's (acc, m, l) through the K/V ring, once every warp is done
    // with it, laid out [value][thread] so that the accesses coalesce
    float* red = reinterpret_cast<float*>(Ks);
    const int tg = threadIdx.x % NTHREADS;
    __syncthreads();
    if (grp == 1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(j * 4 + e) * NTHREADS + tg] = acc[j][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        red[(D / 2 + i) * NTHREADS + tg] = m[i];
        red[(D / 2 + 2 + i) * NTHREADS + tg] = l[i];
      }
    }
    __syncthreads();
    if (grp == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = red[(D / 2 + i) * NTHREADS + tg];
      const float l1 = red[(D / 2 + 2 + i) * NTHREADS + tg];
      const float mm = fmaxf(m[i], m1);
      const float safe = mm == -INFINITY ? 0.f : mm;
      a0[i] = m[i] == -INFINITY ? 0.f : ex2((m[i] - safe) * scale_log2);
      a1[i] = m1 == -INFINITY ? 0.f : ex2((m1 - safe) * scale_log2);
      l[i] = l[i] * a0[i] + l1 * a1[i];
      m[i] = mm;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = acc[j][e] * a0[e >> 1] +
                    red[(j * 4 + e) * NTHREADS + tg] * a1[e >> 1];
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / den;
    const int row = row0 + 8 * i;
    if (lse != nullptr && t4 == 0 && row < Tq)
      lse[((long long)b * H + h) * Tq + row] =
          m[i] * scale_log2 * LN2 + logf(den);
  }
  store_rows<D>(o, acc, inv, b, row0, Tq, H, h);
}

}  // namespace fmma

namespace {

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* km,
               void* o, void* lse, int B, int Tq, int Tk, int H, int Hkv,
               const long long* sq, const long long* sk, const long long* sv,
               int causal, int q_off, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D +
                       BQ * (BK + 1) + BK);
  static const cudaError_t attr =
      fmma::set_smem_attr(flash_fwd_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)km,
      (float*)o, (float*)lse, Tq, Tk, H, H / Hkv, sq[0], sq[1], sq[2], sk[0],
      sk[1], sk[2], sv[0], sv[1], sv[2], causal, q_off, scale);
  return (int)cudaGetLastError();
}

template <int D, int G>
int launch_mma_g(const void* q, const void* k, const void* v, const void* km,
                 void* o, void* lse, int B, int Tq, int Tk, int H, int Hkv,
                 const long long* sq, const long long* sk,
                 const long long* sv, int causal, int q_off, float scale,
                 cudaStream_t stream) {
  constexpr size_t smem = fmma::smem_bytes<D>(1);
  static const cudaError_t attr =
      fmma::set_smem_attr(fmma::flash_fwd_mma_kernel<D, G>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int vec = fmma::vec_ok(q, sq[0], sq[1], sq[2]) &&
                  fmma::vec_ok(k, sk[0], sk[1], sk[2]) &&
                  fmma::vec_ok(v, sv[0], sv[1], sv[2]);
  const dim3 grid((Tq + fmma::BQ - 1) / fmma::BQ, H, B);
  fmma::flash_fwd_mma_kernel<D, G>
      <<<grid, fmma::NTHREADS * G, smem, stream>>>(
          (const fmma::bf16*)q, (const fmma::bf16*)k, (const fmma::bf16*)v,
          (const float*)km, (fmma::bf16*)o, (float*)lse, Tq, Tk, H,
          H / Hkv, sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1],
          sv[2], causal, q_off, scale * fmma::LOG2E, vec);
  return (int)cudaGetLastError();
}

// Two key groups (8 warps) when one group's grid would leave block slots
// of the card empty (fewer blocks than two an SM): each query tile's walk
// over the keys is then halved, the critical path of a short grid. A full
// grid keeps one group, whose 4-warp blocks pack two an SM.
template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* km,
               void* o, void* lse, int B, int Tq, int Tk, int H, int Hkv,
               const long long* sq, const long long* sk, const long long* sv,
               int causal, int q_off, float scale, cudaStream_t stream) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long blocks =
      (long long)((Tq + fmma::BQ - 1) / fmma::BQ) * H * B;
  return blocks < 2LL * sms
             ? launch_mma_g<D, 2>(q, k, v, km, o, lse, B, Tq, Tk, H, Hkv, sq,
                                  sk, sv, causal, q_off, scale, stream)
             : launch_mma_g<D, 1>(q, k, v, km, o, lse, B, Tq, Tk, H, Hkv, sq,
                                  sk, sv, causal, q_off, scale, stream);
}

// f32 (dtype 0) or bf16 (dtype 1), by head dim.
template <bool MMA>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* km, void* o, void* lse, int B, int Tq, int Tk,
               int H, int Hkv, const long long* sq, const long long* sk,
               const long long* sv, int causal, int q_off, float scale,
               cudaStream_t stream) {
#define DL4J_FWD_CASE(DIM)                                                   \
  case DIM:                                                                  \
    return MMA ? launch_mma<DIM>(q, k, v, km, o, lse, B, Tq, Tk, H, Hkv, sq, \
                                 sk, sv, causal, q_off, scale, stream)       \
               : launch_f32<DIM>(q, k, v, km, o, lse, B, Tq, Tk, H, Hkv, sq, \
                                 sk, sv, causal, q_off, scale, stream);
  switch (D) {
    DL4J_FWD_CASE(16)
    DL4J_FWD_CASE(32)
    DL4J_FWD_CASE(64)
    DL4J_FWD_CASE(128)
    DL4J_FWD_CASE(256)
    default:
      return -1;
  }
#undef DL4J_FWD_CASE
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
    return dispatch_d<false>(head_dim, q, k, v, km, o, lse, B, Tq, Tk, H,
                             Hkv, sq, sk, sv, causal, q_off, scale, st);
  if (dtype == 1)
    return dispatch_d<true>(head_dim, q, k, v, km, o, lse, B, Tq, Tk, H,
                            Hkv, sq, sk, sv, causal, q_off, scale, st);
  return -1;
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
