// The bf16 tensor-core loop shared by the query-stationary attention
// kernels: the forward K1 (flash_attention.cu) and the dq pass K4
// (flash_attention_bwd_split.cu). ops/cuda_build.py hashes every header
// under csrc/ into the key of every library, so an edit rebuilds both.
//
// The design is FlashAttention-2's, written for sm_90a with mma.sync:
//  - a block of 4 warps owns 64 query rows, 16 a warp; its query-side
//    operands (Q; for K4 also dO) stay in shared memory for the whole
//    walk over the key tiles (K1 on a short grid runs two such groups,
//    each taking half the keys of every tile: the helpers below take a
//    key sub-range);
//  - K/V tiles of 64 keys move by 16-byte cp.async.cg copies into a
//    ring of two stages (commit_group / wait_group), so tile j + 1
//    loads while tile j is multiplied, with one barrier a tile;
//  - every tile is bf16 in shared memory, rows of D elements with the
//    16-byte chunks XOR-swizzled by row, so that the 8 row addresses of
//    an ldmatrix phase fall in 8 distinct bank groups (no f32 staging,
//    no padding);
//  - products are mma.sync.m16n8k16 bf16 x bf16 -> f32: S = A.B^T reads
//    both operands with plain ldmatrix (B's rows are keys), O += P.V and
//    dq += dS.K read the key-major operand with ldmatrix.trans;
//  - a score tile lives in the accumulator fragments: a thread holds 2
//    rows (g, g + 8) x 16 keys of its warp's 16 x 64 tile, so a row's
//    max and sum reduce inside a quad by two shuffles, and P (or dS) is
//    rounded to bf16 and repacked in registers as the A operand of the
//    next mma, never through shared memory.
// Rounding follows the TPU kernels (pallas_kernels.py): operands in the
// storage type, sums in f32, P cast to bf16 before P.V (:175-177) and dS
// before dS.K (:442-443). The softmax scale stays an f32 factor on the
// scores rather than being folded into the bf16 q tile.
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

// acc += P . X: P the warp's 16 x KW bf16 A fragments (keys key0 ..
// key0 + KW - 1 along k), X a swizzled [BK][D] key-major tile read
// transposed (V, or K for dq).
template <int D, int KW>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const uint32_t (&p)[KW / 16][4],
                                       const bf16* tile, int key0) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < KW / 16; ++ks)
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(tile + swz<D>(key0 + ks * 16 + (l & 7) +
                                              ((l >> 3) & 1) * 8,
                                          n * 8 + (l >> 4) * 8)));
      mma16816(acc[n], p[ks], b[0], b[1]);
      mma16816(acc[n + 1], p[ks], b[2], b[3]);
    }
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

// Write the warp's 16 x D f32 accumulator, times `mul` (per row), as bf16
// rows of a contiguous [B, T, H, D] output (rows at or past T skipped).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[D / 8][4],
                                           const float (&mul)[2], int b,
                                           int row0, int T, int H, int h) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= T) continue;
    bf16* dst = out + (((long long)b * T + row) * H + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
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

}  // namespace fmma
