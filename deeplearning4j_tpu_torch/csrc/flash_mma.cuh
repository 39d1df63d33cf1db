// The bf16 tensor-core loops shared by the flash-attention kernels:
// query-stationary for the forward K1 (flash_attention.cu) and the dq
// pass K4 (flash_attention_bwd_split.cu), key-stationary for the dk/dv
// pass K5 (the same file) and the fused backward K3
// (flash_attention_bwd.cu). ops/cuda_build.py hashes every header under
// csrc/ into the key of every library, so an edit rebuilds all three.
//
// The design is FlashAttention-2's, written for sm_90a with mma.sync:
//  - query-stationary (K1, K4): a block of 4 warps owns 64 query rows,
//    16 a warp; its query-side operands (Q; for K4 also dO) stay in
//    shared memory for the whole walk over the key tiles (K1 on a short
//    grid runs two such groups, each taking half the keys of every tile:
//    the helpers below take a key sub-range);
//  - key-stationary (K5, K3; flash_bwd_kv_mma_kernel below): a block of
//    4 warps owns 64 keys, 16 a warp, with K and V resident, and walks
//    the query tiles; the roles of the two sides swap, and the same
//    helpers serve;
//  - the streamed tiles (K/V, or Q/dO) of 64 rows move by 16-byte
//    cp.async.cg copies into a ring of two stages (commit_group /
//    wait_group), so tile j + 1 loads while tile j is multiplied, with
//    one barrier a tile;
//  - every tile is bf16 in shared memory, rows of D elements with the
//    16-byte chunks XOR-swizzled by row, so that the 8 row addresses of
//    an ldmatrix phase fall in 8 distinct bank groups (no f32 staging,
//    no padding);
//  - products are mma.sync.m16n8k16 bf16 x bf16 -> f32: S = A.B^T reads
//    both operands with plain ldmatrix (B's rows are keys, or queries
//    for S^T = K.Q^T), O += P.V, dq += dS.K, dv += P^T.dO and dk +=
//    dS^T.Q read the row-major right operand with ldmatrix.trans;
//  - a score tile lives in the accumulator fragments: a thread holds 2
//    rows (g, g + 8) x 16 columns of its warp's 16 x 64 tile, so a row's
//    max and sum reduce inside a quad by two shuffles, and P (or dS) is
//    rounded to bf16 and repacked in registers as the A operand of the
//    next mma, never through shared memory (K3's dq alone reads dS^T
//    back from a shared tile, transposed).
// Rounding follows the TPU kernels (pallas_kernels.py): operands in the
// storage type, sums in f32, P cast to bf16 before P.V (:175-177) and
// P^T.dO (:477, :532), dS before dS.K (:442-443, :537) and dS^T.Q (:479,
// :534). The softmax scale stays an f32 factor on the scores rather
// than being folded into the bf16 q tile.
//
// Operands are [B, T, H, D] read through strides, the head dim
// contiguous. When a base pointer is not 16-byte aligned or a stride is
// not a multiple of 8 elements, the same kernels fill the tiles by
// element copies instead (`vec` = 0, chosen on the host per launch);
// the model's paths pass projections viewed as [B, T, H, D] (strides
// T*H*D, H*D, D), which take the 16-byte copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fmma {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;            // query rows a block: 16 a warp
constexpr int BK = 64;            // keys a tile
constexpr int NTHREADS = 128;     // 4 warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of a kernel holding `resident` query-side [BQ][D] tiles,
// two ring stages of K and V, and the two stages' key masks.
template <int D>
constexpr size_t smem_bytes(int resident) {
  return sizeof(bf16) * ((size_t)resident * BQ * D + 4 * BK * D) +
         sizeof(float) * 2 * BK;
}

// Element offset of (row, col) in a swizzled [rows][D] tile: chunk
// col / 8 of the row is stored at chunk (col / 8) ^ f(row), where f
// spreads any 8 consecutive rows over the 8 16-byte bank groups of a
// 128-byte line (rows of D = 16 or 32 share a line).
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int CPR = D / 8;                    // chunks a row
  constexpr int RPL = CPR >= 8 ? 1 : 8 / CPR;   // rows a 128-byte line
  constexpr int MASK = (CPR >= 8 ? 8 : CPR) - 1;
  return row * D + (((col >> 3) ^ ((row / RPL) & MASK)) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes = 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one 4-byte word (a row's lse or Delta); src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b for one m16n8k16 tile, bf16 operands, f32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (ex2.approx, ~2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x: low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// Whether [B, T, H, D] operand x can be copied by 16-byte cp.async: its
// base 16-byte aligned and its strides whole 16-byte chunks.
inline bool vec_ok(const void* x, long long sb, long long st, long long sh) {
  return ((uintptr_t)x & 15) == 0 && sb % 8 == 0 && st % 8 == 0 &&
         sh % 8 == 0;
}

// Copy rows t0 .. t0 + R - 1 of one head (src points at row 0 of it, row
// stride st elements) into the swizzled tile dst[R][D] with the block's
// NTHR threads; rows at or past T (>= 1) become zeros. vec: asynchronous
// 16-byte copies, to be committed by the caller; else element copies,
// stored at once.
template <int D, int R, int NTHR = NTHREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int t0, int T,
                                          bool vec) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < R * CPR; i += NTHR) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int t = t0 + r;
    const bf16* s = src + (long long)min(t, T - 1) * st + c;
    bf16* d = dst + swz<D>(r, c);
    if (vec) {
      cp_async16(smem_u32(d), s, t < T ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (t < T) {
        const unsigned short* se = reinterpret_cast<const unsigned short*>(s);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = (uint32_t)se[2 * j] | ((uint32_t)se[2 * j + 1] << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// ms[i] = 1 for a live key k0 + i (inside Tk, key mask > 0), else 0; km
// points at the batch row's [Tk] mask, or is null (every key live).
template <int NTHR = NTHREADS>
__device__ __forceinline__ void load_mask(float* ms, const float* km, int k0,
                                          int Tk) {
  for (int i = threadIdx.x; i < BK; i += NTHR) {
    const int t = k0 + i;
    ms[i] = (t < Tk && (km == nullptr || km[t] > 0.f)) ? 1.f : 0.f;
  }
}

// A fragment (16 rows from r0, 16 columns from kk) of a swizzled tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int kk) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, smem_u32(tile + swz<D>(r0 + (l & 15), kk + (l >> 4) * 8)));
}

// acc += A . B^T over the k columns kk .. kk + 15: A the warp's 16 rows,
// B the KW rows (keys) key0 .. key0 + KW - 1 of a swizzled [BK][D] tile.
template <int D, int KW>
__device__ __forceinline__ void mma_abt_kstep(float (&acc)[KW / 8][4],
                                              const uint32_t (&a)[4],
                                              const bf16* tile, int key0,
                                              int kk) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < KW / 8; n += 2) {
    uint32_t b[4];
    ldsm_x4(b, smem_u32(tile + swz<D>(key0 + n * 8 + (l & 7) +
                                          ((l >> 4) << 3),
                                      kk + ((l >> 3) & 1) * 8)));
    mma16816(acc[n], a, b[0], b[1]);
    mma16816(acc[n + 1], a, b[2], b[3]);
  }
}

// acc += P . X[:, col0 : col0 + NW]: P the warp's 16 x KW bf16 A
// fragments (rows key0 .. key0 + KW - 1 of X along k), X a swizzled
// [rows][D] row-major tile read transposed (V or K for a query-side
// product; dO or Q for dv and dk).
template <int D, int KW, int NW>
__device__ __forceinline__ void mma_ab_cols(float (&acc)[NW / 8][4],
                                            const uint32_t (&p)[KW / 16][4],
                                            const bf16* tile, int key0,
                                            int col0) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < KW / 16; ++ks)
#pragma unroll
    for (int n = 0; n < NW / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(tile + swz<D>(key0 + ks * 16 + (l & 7) +
                                              ((l >> 3) & 1) * 8,
                                          col0 + n * 8 + (l >> 4) * 8)));
      mma16816(acc[n], p[ks], b[0], b[1]);
      mma16816(acc[n + 1], p[ks], b[2], b[3]);
    }
}

// acc += P . X over all D columns of X.
template <int D, int KW>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const uint32_t (&p)[KW / 16][4],
                                       const bf16* tile, int key0) {
  mma_ab_cols<D, KW, D>(acc, p, tile, key0, 0);
}

// The accumulator fragments of a 16 x KW score tile, rounded to bf16 and
// repacked as the A fragments of a product over its keys.
template <int KW>
__device__ __forceinline__ void to_a_frags(uint32_t (&p)[KW / 16][4],
                                           const float (&s)[KW / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < KW / 16; ++ks) {
    p[ks][0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
    p[ks][1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
    p[ks][2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
    p[ks][3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
  }
}

// Whether key column `col` of the tile at k0 is live for query row
// `row`: unmasked inside Tk and, causal, k_off + key <= q_off + row.
__device__ __forceinline__ bool live_key(const float* ms, int col, int k0,
                                         int row, bool causal, int q_off,
                                         int k_off) {
  return ms[col] > 0.f && (!causal || k_off + k0 + col <= q_off + row);
}

// The number of key tiles a query tile at q0 walks: all of them, or,
// causal, up to the tile holding the diagonal of its last row.
__device__ __forceinline__ int key_tiles(int q0, int Tq, int Tk, bool causal,
                                         int q_off, int k_off) {
  int nkt = (Tk + BK - 1) / BK;
  if (causal) {
    const int k_last = min(q0 + BQ, Tq) - 1 + q_off - k_off;
    nkt = min(nkt, k_last < 0 ? 0 : k_last / BK + 1);
  }
  return nkt;
}

// Write the warp's 16 x NC f32 accumulator, times `mul` (per row), as
// bf16 columns col0 .. col0 + NC - 1 of the rows of a contiguous
// [B, T, H, D] output (rows at or past T skipped).
template <int D, int NC = D>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[NC / 8][4],
                                           const float (&mul)[2], int b,
                                           int row0, int T, int H, int h,
                                           int col0 = 0) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= T) continue;
    bf16* dst =
        out + (((long long)b * T + row) * H + h) * D + col0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(acc[j][2 * i] * mul[i], acc[j][2 * i + 1] * mul[i]);
  }
}

// Set a kernel's dynamic shared memory limit and ask for the largest
// shared-memory carveout, so that two blocks fit on an SM. A launcher
// calls it once per instantiation, into a function-local static.
template <typename K>
cudaError_t set_smem_attr(K kern, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}


// The dk/dv (and dq) columns one block of flash_bwd_kv_mma_kernel owns:
// all of them up to D = 128; above, D / 128 blocks share a key tile,
// each recomputing S^T and dP^T over all D and keeping its 128 columns
// of dk and dv in registers (a warp's 16 x 256 f32 pair would take 256
// registers a thread).
template <int D>
__host__ __device__ constexpr int kv_cols() {
  return D > 128 ? 128 : D;
}

// Shared memory of flash_bwd_kv_mma_kernel: K and V resident, two ring
// stages of Q and dO, (DQ) the dS^T tile, two stages of lse and Delta.
template <int D, bool DQ>
constexpr size_t kv_mma_smem_bytes() {
  return sizeof(bf16) * (6 * BK * D + (DQ ? BK * BQ : 0)) +
         sizeof(float) * 4 * BQ;
}

// The key-stationary backward (K5; with DQ, K3). One block per (batch,
// kv head, 64-key tile), key tile 0 of every (batch, kv head) first:
// under causal masking it walks the most query tiles. K and V stay in
// swizzled shared memory; warp w owns keys 16w .. 16w + 15 of the tile
// and keeps their dk and dv (16 x D f32 each) in registers. The walk
// goes over the kv head's query heads g and, for each, the query tiles
// from the causal diagonal on, streaming Q, dO, lse and Delta through a
// two-stage cp.async ring. Per tile and per pass of QW query columns
// (rows are keys, columns queries):
//   S^T = K.Q^T, dP^T = V.dO^T                      (ldmatrix on Q, dO)
//   P^T = exp2(S^T * scale * log2 e - lse2[col]), dS^T = P^T (dP^T - D)
//   dv += P^T.dO, dk += dS^T.Q       (P^T, dS^T rounded to bf16 in regs)
// With DQ the block also adds dq = dS.K for its 64 keys: every warp
// writes its bf16 dS^T rows to a shared [BK][BQ] tile, and after a
// barrier warp w takes query rows 16w .. 16w + 15 over all 64 keys
// (ldmatrix.trans on dS^T and on K) and adds them into the f32 dq_acc
// [B, Tq, H, D] by float4 atomics (a quad's lane pairs swap halves by
// one shuffle pair so each lane holds 4 adjacent columns). dk and dv
// are summed over the group in a fixed order inside the block, dk
// scaled once at write-out, dv not: the same to the bit run to run.
template <int D, bool DQ>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_kv_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ km,
                        float* __restrict__ dq_acc, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int B, int Tq, int Tk, int H,
                        int Hkv, int groups, long long sqb, long long sqt,
                        long long sqh, long long skb, long long skt,
                        long long skh, long long svb, long long svt,
                        long long svh, long long sdb, long long sdt,
                        long long sdh, int causal, int q_off, int k_off,
                        float scale, int vec) {
  // query columns a pass: at D = 128 two passes of 32 keep S^T and dP^T
  // at 16 + 16 f32 a thread beside dk and dv's 128
  constexpr int QW = D >= 128 ? 32 : BQ;
  constexpr int DW = D >= 128 ? 64 : D;   // dq columns a pass
  constexpr int DC = kv_cols<D>();        // dk/dv/dq columns of the block
  constexpr int NS = D / DC;              // blocks sharing a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][D]
  bf16* Vs = Ks + BK * D;                         // [BK][D]
  bf16* Qs = Vs + BK * D;                         // [2][BQ][D]
  bf16* dOs = Qs + 2 * BQ * D;                    // [2][BQ][D]
  bf16* dSs = dOs + 2 * BQ * D;                   // [BK][BQ] (DQ)
  float* Ls = reinterpret_cast<float*>(dSs + (DQ ? BK * BQ : 0));  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                          // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int c_base = (int)(blockIdx.x % NS) * DC;   // the block's columns
  const int bx = (int)(blockIdx.x / NS);
  const int kt = bx / (Hkv * B), bh = bx % (Hkv * B);
  const int hk = bh % Hkv, b = bh / Hkv;
  const int k0 = kt * BK;
  const int kw = warp * 16;                 // the warp's first key
  const int krow0 = k0 + kw + (lane >> 2);  // this thread's keys: +0, +8
  const float scale_log2 = scale * LOG2E;

  load_tile<D, BK>(Ks, k + b * skb + hk * skh, skt, k0, Tk, vec);
  load_tile<D, BK>(Vs, v + b * svb + hk * svh, svt, k0, Tk, vec);
  bool live_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = krow0 + 8 * i;
    live_row[i] =
        t < Tk && (km == nullptr || km[(long long)b * Tk + t] > 0.f);
  }
  // warp-uniform: every key of the warp live
  const bool warp_live = __all_sync(0xffffffffu, live_row[0] && live_row[1]);
  // block-uniform: a tile of dead keys does no work, zero gradients
  const bool tile_live = __syncthreads_or(live_row[0] || live_row[1]) != 0;

  // causal: the first query row that sees key k0 is k0 + k_off - q_off
  int qt_first = 0;
  if (causal && k0 + k_off - q_off > 0) qt_first = (k0 + k_off - q_off) / BQ;
  const int nqt = (Tq + BQ - 1) / BQ;
  const int per_head = tile_live && qt_first < nqt ? nqt - qt_first : 0;
  const int items = per_head * groups;   // (query head, query tile) pairs

  // item it: query head hk * groups + it / per_head, query tile
  // qt_first + it % per_head, into ring stage st
  auto load_item = [&](int it, int st) {
    const int h = hk * groups + it / per_head;
    const int q0 = (qt_first + it % per_head) * BQ;
    load_tile<D, BQ>(Qs + st * BQ * D, q + b * sqb + h * sqh, sqt, q0, Tq,
                     vec);
    load_tile<D, BQ>(dOs + st * BQ * D, dout + b * sdb + h * sdh, sdt, q0,
                     Tq, vec);
    const long long at = ((long long)b * H + h) * Tq;
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const int t = q0 + i;
      const long long src = at + min(t, Tq - 1);
      cp_async4(smem_u32(Ls + st * BQ + i), lse + src, t < Tq ? 4 : 0);
      cp_async4(smem_u32(Ds + st * BQ + i), delta + src, t < Tq ? 4 : 0);
    }
  };

  if (items > 0) load_item(0, 0);
  cp_async_commit();

  float adk[DC / 8][4], adv[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int it = 0; it < items; ++it) {
    const int st = it & 1;
    const int h = hk * groups + it / per_head;
    const int q0 = (qt_first + it % per_head) * BQ;
    cp_async_wait<0>();   // this item (and, at it = 0, K and V) landed
    // one barrier an item: this stage visible to all, and every warp
    // done with the previous item, whose stage the next item refills
    __syncthreads();
    if (it + 1 < items) load_item(it + 1, st ^ 1);
    cp_async_commit();
    const bf16* qs = Qs + st * BQ * D;
    const bf16* dos = dOs + st * BQ * D;
    const float* ls = Ls + st * BQ;
    const float* ds = Ds + st * BQ;

#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += QW) {
      const int qc = q0 + c0;   // the pass's first query
      uint32_t pa[QW / 16][4];
      // warp-uniform: no query of the pass sees a key of the warp
      const bool dead =
          qc >= Tq ||
          (causal && q_off + min(qc + QW, Tq) - 1 < k_off + k0 + kw);
      if (!dead) {
        float s[QW / 8][4], dp[QW / 8][4];
#pragma unroll
        for (int n = 0; n < QW / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t a[4];
          load_a<D>(a, Ks, kw, kk);
          mma_abt_kstep<D, QW>(s, a, qs, c0, kk);
          load_a<D>(a, Vs, kw, kk);
          mma_abt_kstep<D, QW>(dp, a, dos, c0, kk);
        }
        // warp-uniform: every (key, query) pair of the pass live
        const bool full =
            warp_live && qc + QW <= Tq &&
            (!causal || k_off + k0 + kw + 15 <= q_off + qc);
#pragma unroll
        for (int n = 0; n < QW / 8; ++n) {
          const int col = c0 + n * 8 + 2 * t4;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, j = e & 1;
            const float lv = j ? l2.y : l2.x;
            const float lse2 = isfinite(lv) ? lv * LOG2E : 0.f;
            const int qi = q0 + col + j, kj = krow0 + 8 * i;
            const bool live =
                full || (live_row[i] && qi < Tq &&
                         (!causal || k_off + kj <= q_off + qi));
            const float p =
                live ? ex2(fmaf(s[n][e], scale_log2, -lse2)) : 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - (j ? d2.y : d2.x));   // dS^T
          }
        }
        to_a_frags<QW>(pa, s);
        mma_ab_cols<D, QW, DC>(adv, pa, dos, c0, c_base);
        to_a_frags<QW>(pa, dp);
        mma_ab_cols<D, QW, DC>(adk, pa, qs, c0, c_base);
      } else if constexpr (DQ) {
#pragma unroll
        for (int ks = 0; ks < QW / 16; ++ks)
          pa[ks][0] = pa[ks][1] = pa[ks][2] = pa[ks][3] = 0u;
      }
      if constexpr (DQ) {
        // the warp's bf16 dS^T rows (keys) into the shared tile
        const int r = kw + (lane >> 2);
#pragma unroll
        for (int ks = 0; ks < QW / 16; ++ks) {
          const int c = c0 + ks * 16 + 2 * t4;
          *reinterpret_cast<uint32_t*>(dSs + swz<BQ>(r, c)) = pa[ks][0];
          *reinterpret_cast<uint32_t*>(dSs + swz<BQ>(r + 8, c)) = pa[ks][1];
          *reinterpret_cast<uint32_t*>(dSs + swz<BQ>(r, c + 8)) = pa[ks][2];
          *reinterpret_cast<uint32_t*>(dSs + swz<BQ>(r + 8, c + 8)) =
              pa[ks][3];
        }
      }
    }

    if constexpr (DQ) {
      __syncthreads();   // the dS^T tile complete
      const int qw = q0 + kw;   // the warp's first query row for dq
      // warp-uniform: skip rows past Tq, or that see no key of the tile
      if (qw < Tq && (!causal || q_off + min(qw + 16, Tq) - 1 >= k_off + k0)) {
        // A fragments of dS (16 query rows x 64 keys) from dS^T,
        // transposed
        uint32_t da[BK / 16][4];
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          ldsm_x4_t(da[ks],
                    smem_u32(dSs + swz<BQ>(ks * 16 + (lane & 7) +
                                               ((lane >> 4) & 1) * 8,
                                           kw + ((lane >> 3) & 1) * 8)));
        const bool odd = t4 & 1;
        const int row = qw + (lane >> 2) + (odd ? 8 : 0);
        float* dst = dq_acc + (((long long)b * Tq + row) * H + h) * D +
                     2 * (t4 & ~1);
#pragma unroll
        for (int d0 = c_base; d0 < c_base + DC; d0 += DW) {
          float acc[DW / 8][4];
#pragma unroll
          for (int n = 0; n < DW / 8; ++n)
            acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
          mma_ab_cols<D, BK, DW>(acc, da, Ks, 0, d0);
          // lanes t4 = 2m, 2m + 1 swap halves: the even one takes row g,
          // columns 4m .. 4m + 3, the odd one row g + 8
#pragma unroll
          for (int n = 0; n < DW / 8; ++n) {
            const float r0 = __shfl_xor_sync(0xffffffffu,
                                             odd ? acc[n][0] : acc[n][2], 1);
            const float r1 = __shfl_xor_sync(0xffffffffu,
                                             odd ? acc[n][1] : acc[n][3], 1);
            const float4 val =
                odd ? make_float4(r0, r1, acc[n][2], acc[n][3])
                    : make_float4(acc[n][0], acc[n][1], r0, r1);
            if (row < Tq)
              atomicAdd(reinterpret_cast<float4*>(dst + d0 + n * 8), val);
          }
        }
      }
    }
  }
  cp_async_wait<0>();   // no copy left in flight (items = 0: K's and V's)
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
  store_rows<D, DC>(dk, adk, mul_k, b, krow0, Tk, Hkv, hk, c_base);
  store_rows<D, DC>(dv, adv, mul_v, b, krow0, Tk, Hkv, hk, c_base);
}

// Launch flash_bwd_kv_mma_kernel on [B, T, H, D] bf16 operands (strides
// in elements, ordered batch, time, head); dq_acc is read only with DQ.
template <int D, bool DQ>
cudaError_t launch_bwd_kv_mma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, const float* km,
                              float* dq_acc, void* dk, void* dv, int B,
                              int Tq, int Tk, int H, int Hkv,
                              const long long* sq, const long long* sk,
                              const long long* sv, const long long* sd,
                              int causal, int q_off, int k_off, float scale,
                              cudaStream_t stream) {
  constexpr size_t smem = kv_mma_smem_bytes<D, DQ>();
  static const cudaError_t attr =
      set_smem_attr(flash_bwd_kv_mma_kernel<D, DQ>, smem);
  if (attr != cudaSuccess) return attr;
  const int vec = vec_ok(q, sq[0], sq[1], sq[2]) &&
                  vec_ok(k, sk[0], sk[1], sk[2]) &&
                  vec_ok(v, sv[0], sv[1], sv[2]) &&
                  vec_ok(dout, sd[0], sd[1], sd[2]);
  const long long blocks =
      (long long)((Tk + BK - 1) / BK) * Hkv * B * (D / kv_cols<D>());
  flash_bwd_kv_mma_kernel<D, DQ><<<(unsigned)blocks, NTHREADS, smem,
                                   stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, km, dq_acc, (bf16*)dk, (bf16*)dv, B, Tq, Tk, H, Hkv, H / Hkv,
      sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2], sd[0],
      sd[1], sd[2], causal, q_off, k_off, scale, vec);
  return cudaGetLastError();
}

}  // namespace fmma
