// RMSNorm and LayerNorm backward for Hopper (sm_90a), plain C interface:
// K6 (RMSNorm: dx, dgamma) and K9 (LayerNorm: dx, dgamma, dbeta), one
// kernel body in two instantiations each.
//
// Replaces the TPU kernels `_rms_bwd_kernel` and `_ln_bwd_kernel` of
// deeplearning4j_tpu/ops/fused_norms.py (reached through `_rms_bwd_call`
// and `_ln_bwd_call`). The formulas are theirs, in f32, rounded once to
// x's dtype; the row statistics are recomputed from x (only x and gamma
// are saved by the forward):
//   K6: rstd = rsqrt(mean(x^2) + eps), c = mean(dy*gamma*x),
//       dx = (dy*gamma - x*c*rstd^2)*rstd, dgamma = sum_rows dy*x*rstd;
//   K9: mu = mean(x), rstd = rsqrt(mean((x - mu)^2) + eps), gh = dy*gamma,
//       xhat = (x - mu)*rstd, dx = (gh - mean(gh) - xhat*mean(gh*xhat))*rstd
//       (mean(gh*xhat) taken as rstd*mean(gh*(x - mu)), one reduction
//       round fewer), dgamma = sum_rows dy*xhat, dbeta = sum_rows dy.
//
// What bounds them on this card: bytes. A row costs ~15 f32 operations
// an element against 6 bytes read and written (bf16 x, dy, dx), far
// below the card's ~20 operations a byte. At the train path's [16384,
// 768] bf16 K6 moves 75.5 MB, 22.5 us at 3.35 TB/s; K9 at the fine-tune
// path's [8192, 768] 37.7 MB, 11.3 us. The design moves those bytes once
// and keeps everything else on chip, in one launch:
//  - A persistent grid: as many blocks as fit on the card at once (the
//    occupancy API, read once per configuration by the wrapper), each
//    taking one contiguous run of rows, block b rows [b*R/G, (b+1)*R/G)
//    (the wrapper's `_row_partition`). No block waits for another.
//  - Up to 1024 features a warp owns a row (PATH_WARP*): lane l holds
//    slots l, l+32, ... of x and dy in registers, every row statistic is
//    a warp shuffle reduction (no block barrier a row), and gamma sits
//    in shared memory lane-major (no bank conflicts). Rows of whole
//    16-byte chunks on 16-byte bases (the main paths' rows) arrive by
//    1-D TMA (`cp.async.bulk`, PATH_WARP_TMA) into a ring of 2
//    shared-memory stages per warp, one x row and one dy row a stage,
//    completing on the stage's mbarrier; lane 0 of each warp refills the
//    stage it has just read with the row `stages` rows ahead, so each
//    warp keeps that many rows in flight while it reduces (the issuing
//    thread is per warp, so that no warp waits on another's progress: a
//    ring shared by the block would need empty barriers across warps).
//    The wrapper takes the ring for LayerNorm rows from 2 rows a warp on
//    a full grid, and otherwise 16-byte loads straight into registers
//    (PATH_WARP_VEC): with fewer rows a ring has nothing to fetch ahead,
//    and on the H100 the two came within a few per cent of each other at
//    the main shapes, the ring ahead on LayerNorm's rows (three
//    reductions a row) and behind on RMSNorm's (one). A slot is then a
//    16-byte chunk (3 a lane at F = 768 bf16) and dx goes out in 16-byte
//    stores. Other rows load an element a slot (PATH_WARP). dgamma (and
//    dbeta) accumulate in each lane's registers over its warp's rows.
//  - Wider rows (up to 16384 features, too wide for a warp's registers;
//    PATH_BLOCK_VEC, PATH_BLOCK): a block owns a row, read in passes by
//    16-byte or element accesses, reduced through shared memory, with
//    dgamma and dbeta accumulated per column in shared memory. Right,
//    not fast.
//  - dgamma and dbeta on chip, in a fixed order: the warps of a block
//    summed in warp order in shared memory; the blocks of a thread-block
//    cluster (1, 2, 4 or 8) summed in rank order through distributed
//    shared memory, rank r a slice r of the columns, so that one f32 row
//    per cluster reaches device memory. On the warp path each block
//    pushes its values of slice r into rank r's inbox (`st.async`, each
//    store counted on r's inbox barrier), so a rank waits only for its
//    own slice's data, with no cluster barrier between the rows and the
//    sums (at a few hundred rows a block's finish is most of its launch;
//    tools/torch_norm_bwd_timing.py times it). The block path reads the
//    peers' partials after a cluster barrier. The last of the blocks of
//    rank r to take rank r's ticket (an atomic counter, reset by that
//    block so a replayed CUDA graph starts from 0) sums slice r over the
//    clusters' rows in cluster order and writes it in gamma's dtype. The
//    order of every sum depends on (rows, grid) alone: dgamma and dbeta
//    are the same to the bit from run to run, as the TPU kernel's
//    sequential accumulation over its grid is. There is no grid-wide
//    barrier.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;            // threads a block
constexpr int NW = NT / 32;        // warps a block
constexpr int TMA_STAGES = 2;      // TMA ring stages a warp (4 were slower)
constexpr int SMEM_MAX = 232448;   // dynamic shared memory of one block
constexpr int MAX_F = 16384;       // widest row taken
constexpr int WARP_MAX_F = 1024;   // widest row of the warp path

// how the rows are read (the wrapper's `_norm_path`)
enum {
  PATH_BLOCK = 0,       // a block a row, element loads
  PATH_BLOCK_VEC = 1,   // a block a row, 16-byte loads and stores
  PATH_WARP = 2,        // a warp a row, element loads into registers
  PATH_WARP_VEC = 3,    // a warp a row, 16-byte loads into registers
  PATH_WARP_TMA = 4,    // a warp a row, rows by TMA into a ring
};
// how a warp-path kernel reads its rows
enum { LOAD_ELEM = 0, LOAD_VEC = 1, LOAD_TMA = 2 };

enum { F32 = 0, BF16 = 1, F16 = 2 };

// 16-byte chunks of T and their f32 values
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // element 2i in the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Pack<__half> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ T from_f(float v);
template <> __device__ float from_f<float>(float v) { return v; }
template <> __device__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// gamma and the dgamma/dbeta output in gamma's own dtype (a runtime code)
__device__ __forceinline__ float load_any(const void* p, int i, int code) {
  if (code == BF16) return __bfloat162float(((const __nv_bfloat16*)p)[i]);
  if (code == F16) return __half2float(((const __half*)p)[i]);
  return ((const float*)p)[i];
}
__device__ __forceinline__ void store_any(void* p, int i, int code,
                                          float v) {
  if (code == BF16)
    ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(v);
  else if (code == F16)
    ((__half*)p)[i] = __float2half_rn(v);
  else
    ((float*)p)[i] = v;
}

// a butterfly: every lane ends with the same sum (each add's operands
// are the same pair on both lanes, so the same bits)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// the same, acquiring at cluster scope what peers' `st.async` wrote
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1],"
        " %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// 1-D TMA: `bytes` (a multiple of 16) from global to this block's
// shared memory, counted against `bar`'s transaction bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// `v` into block rank q's shared memory at the offset of `local` in this
// block (every block of a launch has the same layout), its 4 bytes
// counted against rank q's barrier at the offset of `bar`
__device__ __forceinline__ void push_f32(const float* local, int q,
                                         float v, uint64_t* bar) {
  uint32_t ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra) : "r"(smem_u32(local)), "r"(q));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rb) : "r"(smem_u32(bar)), "r"(q));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
      " [%0], %1, [%2];"
      :: "r"(ra), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}
// rank q's slice of ncol columns among a cluster of 2^sh blocks:
// [lo(q), lo(q + 1))
__device__ __forceinline__ int slice_lo(int ncol, int q, int sh) {
  return (ncol * q) >> sh;
}
// the rank whose slice holds column j: the largest q with lo(q) <= j
__device__ __forceinline__ int slice_owner(int j, int ncol, int sh) {
  return (((j + 1) << sh) + ncol - 1) / ncol - 1;
}

__host__ __device__ constexpr int align_up(int v, int a) {
  return (v + a - 1) / a * a;
}

// Shared-memory layout (byte offsets). Both kernels: gamma as f32, the
// finisher's scratch [NT] and its flag. The warp kernel: gamma
// lane-major (element e of lane l at e*32 + l: gam_n = 32 * E,
// conflict-free), the stages' mbarriers, the inbox's mbarrier and the
// inbox (the cluster's partials of this rank's slice of the columns, [cs]
// rows of the slice's width, at most ncol + 8 floats) and, 128-aligned,
// the TMA ring [warp][stage][x | dy][F] of T, which after the rows holds
// the warps' partials, lane-major as gamma ([NW][gam_n] of dgamma, then
// as many of dbeta). The block kernel: gamma [F], the block's partial
// [ncol] (dgamma, then dbeta) and the reduction scratch [2][NW][4].
struct Layout {
  int bars, gam, blk, fin, flag, ibar, inbox, red, ring, total;
};
__host__ __device__ inline Layout layout(int f, int esize, bool ln,
                                         bool warp_rows, int gam_n,
                                         int stages) {
  const int ncol = ln ? 2 * f : f;
  Layout L;
  int off = 0;
  L.bars = off;
  off = align_up(off + 8 * NW * stages, 16);
  L.gam = off;
  off = align_up(off + 4 * gam_n, 16);
  L.blk = off;
  off = align_up(off + (warp_rows ? 0 : 4 * ncol), 16);
  L.fin = off;
  off += 4 * NT;
  L.flag = off;
  L.ibar = off + 8;
  off += 16;
  L.inbox = off;
  off += warp_rows ? 4 * (ncol + 8) : 0;
  L.red = off;
  off += warp_rows ? 0 : 4 * 2 * NW * 4;
  L.ring = align_up(off, 128);
  const int ring = NW * stages * 2 * f * esize;
  const int wpart = warp_rows ? NW * gam_n * 4 * (ln ? 2 : 1) : 0;
  L.total = L.ring + (ring > wpart ? ring : wpart);
  return L;
}

// Rank r's slice of the columns, summed over its cluster's blocks into
// the cluster's row of `part` → `out`: the last of the n_clusters blocks
// of rank r to take rank r's ticket sums that slice over the clusters
// (cluster order) into `out` and resets the ticket. Every sum runs in a
// fixed order.
__device__ void grid_finish(int ncol, float* __restrict__ part,
                            int* tickets, void* out, int gcode, float* fin,
                            int* flag) {
  const int cs = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();
  const int sh = __ffs(cs) - 1;
  const int tid = threadIdx.x;
  const int n_clusters = gridDim.x / cs;
  const int c0 = slice_lo(ncol, rank, sh), c1 = slice_lo(ncol, rank + 1, sh);
  __syncthreads();                    // the block's slice is written
  if (tid == 0) {
    // release: the block's slice (ordered before by the barrier) is
    // visible before the ticket; acquire: the last block sees every slice
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(prev) : "l"(&tickets[rank]) : "memory");
    const int last = prev == n_clusters - 1;
    if (last)   // every block of this rank has taken its ticket
      *reinterpret_cast<volatile int*>(&tickets[rank]) = 0;
    *flag = last;
  }
  __syncthreads();
  const int nc = c1 - c0;
  if (*flag && nc > 0) {
    // p threads a column, each over a contiguous range of clusters read
    // 16 rows at a time, their p sums then added in order (p = 1: over
    // all the clusters, 4 columns at a time)
    const int p = nc >= NT ? 1 : min(NT / nc, n_clusters);
    if (p == 1) {
      // a thread's columns t, t + NT, ...: 4 of them at a time, 4
      // clusters' rows each, 16 loads in flight
      for (int j = c0 + tid; j < c1; j += 4 * NT) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < n_clusters; c += 4) {
          float v[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              v[k][u] = c + u < n_clusters && j + k * NT < c1
                            ? __ldcg(part + (long long)(c + u) * ncol + j +
                                     k * NT)
                            : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (c + u < n_clusters) s[k] += v[k][u];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j + k * NT < c1) store_any(out, j + k * NT, gcode, s[k]);
      }
    }
    for (int t = tid; p > 1 && t < p * nc; t += NT) {
      const int h = t / nc, jj = t % nc;
      const int a = n_clusters * h / p, b = n_clusters * (h + 1) / p;
      const float* col = part + c0 + jj;
      float s = 0.f;
      for (int c = a; c < b; c += 16) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u)
          v[u] = c + u < b ? __ldcg(col + (long long)(c + u) * ncol) : 0.f;
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (c + u < b) s += v[u];
      }
      fin[h * nc + jj] = s;
    }
    if (p > 1) {
      __syncthreads();
      if (tid < nc) {
        float s = 0.f;
        for (int h = 0; h < p; ++h) s += fin[h * nc + tid];
        store_any(out, c0 + tid, gcode, s);
      }
    }
  }
}

// The block kernel's finish: the block's partial [ncol] in `blk`; rank r
// reads its slice from the cluster's blocks (distributed shared memory,
// rank order), then grid_finish.
__device__ void cluster_finish(const float* blk, int ncol,
                               float* __restrict__ part, int* tickets,
                               void* out, int gcode, float* fin,
                               int* flag) {
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int sh = __ffs(cs) - 1;
  const long long cid = blockIdx.x / cs;
  cl.sync();                          // every block's partial complete
  for (int j = slice_lo(ncol, rank, sh) + threadIdx.x;
       j < slice_lo(ncol, rank + 1, sh); j += NT) {
    float v[8];                       // the peers' values, all in flight
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = q < cs ? cl.map_shared_rank(blk, q)[j] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < cs) s += v[q];
    part[cid * ncol + j] = s;
  }
  cluster_arrive();                   // done reading the peers' partials
  grid_finish(ncol, part, tickets, out, gcode, fin, flag);
  cluster_wait();   // no block leaves while a peer may read its partial
}

// A lane's unit of a row on the warp path: a 16-byte chunk of V
// elements (raw bits in registers, unpacked at each use), or with
// LOAD_ELEM one element, loaded from device memory and kept as f32.
template <typename T, int LOAD> struct Slot {
  using Raw = uint4;
  static constexpr int V = Pack<T>::N;
  __device__ static void unpack(const uint4& r, float* v) {
    Pack<T>::unpack(r, v);
  }
};
template <typename T> struct Slot<T, LOAD_ELEM> {
  using Raw = float;
  static constexpr int V = 1;
  __device__ static void unpack(const float& r, float* v) { v[0] = r; }
};

template <typename T, bool LN, int LOAD, int C>
struct WarpTraits {
  static constexpr int V = Slot<T, LOAD>::V;
  static constexpr int E = C * V;            // elements a lane holds
  // registers of the row and of the accumulators: two blocks an SM while
  // they fit in 128 registers a thread
  static constexpr int MIN_BLOCKS =
      2 * C * (LOAD == LOAD_ELEM ? 1 : 4) + E * (LN ? 2 : 1) <= 80 ? 2 : 1;
};

// The warp path: a warp a row, lane l holding slots l, l + 32, ...; the
// rows by TMA into a per-warp ring of `stages` stages, or by plain loads
// (16-byte or element) straight into registers.
template <typename T, bool LN, int LOAD, int C>
__global__ void __launch_bounds__(NT, (WarpTraits<T, LN, LOAD, C>::MIN_BLOCKS))
norm_bwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const void* __restrict__ gamma, int gcode,
                     T* __restrict__ dx, float* __restrict__ part,
                     int* tickets, void* out, long long rows, int f,
                     float eps, int stages) {
  using S = Slot<T, LOAD>;
  constexpr bool TMA = LOAD == LOAD_TMA;
  constexpr int V = S::V;
  constexpr int E = C * V;
  extern __shared__ __align__(128) unsigned char smem[];
  if (!TMA) stages = 0;
  const Layout L = layout(f, (int)sizeof(T), LN, true, 32 * E, stages);
  const int ncol = LN ? 2 * f : f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nslot = f / V;                  // slots a row
  const long long r0 = rows * blockIdx.x / gridDim.x;
  const long long r1 = rows * (blockIdx.x + 1) / gridDim.x;
  // this warp's rows: r0 + warp + k*NW, k = 0 .. n_mine-1; with TMA its
  // k-th row lands in stage k % stages, whose barrier completes phase
  // k / stages
  const long long n_mine = r1 - r0 > warp ? (r1 - r0 - warp + NW - 1) / NW
                                          : 0;
  const uint32_t row_bytes = (uint32_t)f * sizeof(T);
  T* ring = reinterpret_cast<T*>(smem + L.ring) +
            (size_t)warp * stages * 2 * f;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + L.bars) +
                   warp * stages;
  // the cluster: rank r sums columns [c0, c1) over the cluster's blocks,
  // each of which pushes its values of them into row `its rank` of r's
  // inbox
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int sh = __ffs(cs) - 1;
  const int c0 = slice_lo(ncol, rank, sh), c1 = slice_lo(ncol, rank + 1, sh);
  uint64_t* ibar = reinterpret_cast<uint64_t*>(smem + L.ibar);
  float* inbox = reinterpret_cast<float*>(smem + L.inbox);
  if (tid == 0) {   // the inbox's barrier, before any peer may push
    mbar_init(ibar, 1);
    mbar_expect_tx(ibar, (uint32_t)(4 * cs * (c1 - c0)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // gamma's entries of this thread's share of the lane-major table, read
  // first, ahead of the rows' traffic
  constexpr int GPT = (32 * E + NT - 1) / NT;
  float gv[GPT];
#pragma unroll
  for (int u = 0; u < GPT; ++u) {
    const int i = tid + u * NT, e = i >> 5, l = i & 31;
    const int col = (l + 32 * (e / V)) * V + e % V;
    gv[u] = i < 32 * E && col < f ? load_any(gamma, col, gcode) : 0.f;
  }
  typename S::Raw xr[C], dr[C];
  // VEC and ELEM: row r's slots into xr, dr
  auto load_row = [&](long long r) {
    if constexpr (LOAD == LOAD_VEC) {
      const uint4* xg = reinterpret_cast<const uint4*>(x + r * f);
      const uint4* dg = reinterpret_cast<const uint4*>(dy + r * f);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int q = lane + 32 * c;
        xr[c] = q < nslot ? __ldg(xg + q) : make_uint4(0u, 0u, 0u, 0u);
        dr[c] = q < nslot ? __ldg(dg + q) : make_uint4(0u, 0u, 0u, 0u);
      }
    } else if constexpr (LOAD == LOAD_ELEM) {
      const T* xg = x + r * f;
      const T* dg = dy + r * f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int q = lane + 32 * c;
        xr[c] = q < nslot ? to_f(xg[q]) : 0.f;
        dr[c] = q < nslot ? to_f(dg[q]) : 0.f;
      }
    }
  };
  if constexpr (TMA) {
    // the warp's own barriers and first rows, before the block's first
    // barrier: the copies fly while gamma is staged
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(&wbar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int s = 0; s < stages && s < n_mine; ++s) {
        const long long r = r0 + warp + (long long)s * NW;
        mbar_expect_tx(&wbar[s], 2 * row_bytes);
        bulk_load(ring + (size_t)s * 2 * f, x + r * f, row_bytes, &wbar[s]);
        bulk_load(ring + (size_t)s * 2 * f + f, dy + r * f, row_bytes,
                  &wbar[s]);
      }
    }
    __syncwarp();
  } else if (n_mine > 0) {
    load_row(r0 + warp);       // the first row flies while gamma is staged
  }
  // gamma as f32, lane-major: element e of lane l at gam[e * 32 + l]
  float* gam = reinterpret_cast<float*>(smem + L.gam);
#pragma unroll
  for (int u = 0; u < GPT; ++u)
    if (tid + u * NT < 32 * E) gam[tid + u * NT] = gv[u];
  __syncthreads();
  cluster_arrive_relaxed();   // this block's inbox is ready

  float acc_g[E], acc_b[LN ? E : 1];
#pragma unroll
  for (int i = 0; i < E; ++i) acc_g[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (LN ? E : 1); ++i) acc_b[i] = 0.f;
  const float inv_f = 1.f / (float)f;
  const float* gl = gam + lane;             // this lane's gamma, stride 32

  for (long long k = 0; k < n_mine; ++k) {
    const long long r = r0 + warp + k * NW;
    if constexpr (TMA) {
      const int s = (int)(k % stages);
      mbar_wait(&wbar[s], (uint32_t)((k / stages) & 1));
      const uint4* sx =
          reinterpret_cast<const uint4*>(ring + (size_t)s * 2 * f);
      const uint4* sd = sx + nslot;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int q = lane + 32 * c;
        xr[c] = q < nslot ? sx[q] : make_uint4(0u, 0u, 0u, 0u);
        dr[c] = q < nslot ? sd[q] : make_uint4(0u, 0u, 0u, 0u);
      }
      __syncwarp();
      if (lane == 0 && k + stages < n_mine) {
        // the warp has read stage s: refill it with its row `stages` ahead
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const long long rn = r + (long long)stages * NW;
        mbar_expect_tx(&wbar[s], 2 * row_bytes);
        bulk_load(ring + (size_t)s * 2 * f, x + rn * f, row_bytes,
                  &wbar[s]);
        bulk_load(ring + (size_t)s * 2 * f + f, dy + rn * f, row_bytes,
                  &wbar[s]);
      }
    }
    // slot c's dx values out: one 16-byte store, or one element
    auto put = [&](int c, const float* o) {
      const int q = lane + 32 * c;
      if constexpr (LOAD == LOAD_ELEM)
        dx[r * f + q] = from_f<T>(o[0]);
      else
        reinterpret_cast<uint4*>(dx + r * f)[q] = Pack<T>::pack(o);
    };
    if constexpr (!LN) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (lane + 32 * c < nslot) {
          float xv[V], dv[V];
          S::unpack(xr[c], xv);
          S::unpack(dr[c], dv);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            s1 += xv[i] * xv[i];
            s2 += (dv[i] * gl[(c * V + i) * 32]) * xv[i];
          }
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      const float rstd = rsqrtf(s1 * inv_f + eps);
      const float kk = (s2 * inv_f) * rstd * rstd;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (lane + 32 * c < nslot) {
          float xv[V], dv[V], o[V];
          S::unpack(xr[c], xv);
          S::unpack(dr[c], dv);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            o[i] = (dv[i] * gl[(c * V + i) * 32] - xv[i] * kk) * rstd;
            acc_g[c * V + i] += dv[i] * xv[i] * rstd;
          }
          put(c, o);
        }
      }
    } else {
      float s0 = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float xv[V];
        S::unpack(xr[c], xv);
#pragma unroll
        for (int i = 0; i < V; ++i) s0 += xv[i];
      }
      const float mu = warp_sum(s0) * inv_f;
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (lane + 32 * c < nslot) {
          float xv[V], dv[V];
          S::unpack(xr[c], xv);
          S::unpack(dr[c], dv);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float xc = xv[i] - mu;
            const float gh = dv[i] * gl[(c * V + i) * 32];
            s1 += xc * xc;
            s2 += gh;
            s3 += gh * xc;
          }
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      s3 = warp_sum(s3);
      const float rstd = rsqrtf(s1 * inv_f + eps);
      const float m1 = s2 * inv_f;
      const float m2 = s3 * rstd * inv_f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (lane + 32 * c < nslot) {
          float xv[V], dv[V], o[V];
          S::unpack(xr[c], xv);
          S::unpack(dr[c], dv);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float xhat = (xv[i] - mu) * rstd;
            o[i] = (dv[i] * gl[(c * V + i) * 32] - m1 - xhat * m2) * rstd;
            acc_g[c * V + i] += dv[i] * xhat;
            acc_b[c * V + i] += dv[i];
          }
          put(c, o);
        }
      }
    }
    if (!TMA && k + 1 < n_mine) load_row(r + NW);   // the next row
  }

  // every warp is past its rows and no copy is in flight (a warp only
  // asks for rows it reads): the ring becomes the warps' partials
  __syncthreads();
  float* wg = reinterpret_cast<float*>(smem + L.ring);   // [NW][32 * E]
  float* wb = wg + NW * 32 * E;                          // LN: dbeta's
#pragma unroll
  for (int e = 0; e < E; ++e) {
    wg[(warp * E + e) * 32 + lane] = acc_g[e];
    if constexpr (LN) wb[(warp * E + e) * 32 + lane] = acc_b[e];
  }
  __syncthreads();
  cluster_wait();   // every peer's inbox is ready (long since, as a rule)
  // the warps summed in warp order, lane-major entry i to its column,
  // pushed to the column's owner as this rank's row of its inbox
  auto push = [&](int j, float v) {
    const int q = slice_owner(j, ncol, sh);
    const int lo = slice_lo(ncol, q, sh);
    const int w = slice_lo(ncol, q + 1, sh) - lo;
    push_f32(inbox + rank * w + (j - lo), q, v, ibar);
  };
  for (int i = tid; i < 32 * E; i += NT) {
    const int e = i >> 5, l = i & 31;
    const int col = (l + 32 * (e / V)) * V + e % V;
    if (col < f) {
      float s = 0.f, sb = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        s += wg[w * 32 * E + i];
        if constexpr (LN) sb += wb[w * 32 * E + i];
      }
      push(col, s);
      if constexpr (LN) push(f + col, sb);
    }
  }
  cluster_arrive_relaxed();   // this block's pushes are issued
  // this rank's slice over the cluster's blocks, in rank order
  mbar_wait_cluster(ibar, 0);
  const long long cid = blockIdx.x / cs;
  const int nc = c1 - c0;
  for (int j = tid; j < nc; j += NT) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < cs) s += inbox[q * nc + j];
    part[cid * ncol + c0 + j] = s;
  }
  grid_finish(ncol, part, tickets, out, gcode,
              reinterpret_cast<float*>(smem + L.fin),
              reinterpret_cast<int*>(smem + L.flag));
  cluster_wait();   // no block leaves while its pushes may be in flight
}

// K sums over the block, the same bits in every thread: per warp by
// shuffles, then the warps' sums in warp order. `red` alternates between
// two buffers from call to call (one barrier a call suffices).
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * 4 + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[w * 4 + k];
    v[k] = s;
  }
}

// fn(column, x, dy) over this thread's elements of a row: with `vec` its
// 16-byte chunks t, t + NT, ... (V columns each), else its columns t,
// t + NT, ...
template <typename T, typename Fn>
__device__ __forceinline__ void row_each(const T* xr, const T* dr, int f,
                                         bool vec, Fn fn) {
  constexpr int V = Pack<T>::N;
  if (vec) {
    const uint4* x4 = reinterpret_cast<const uint4*>(xr);
    const uint4* d4 = reinterpret_cast<const uint4*>(dr);
#pragma unroll 4
    for (int q = threadIdx.x; q < f / V; q += NT) {
      float xv[V], dv[V];
      Pack<T>::unpack(__ldg(x4 + q), xv);
      Pack<T>::unpack(__ldg(d4 + q), dv);
#pragma unroll
      for (int i = 0; i < V; ++i) fn(q * V + i, xv[i], dv[i]);
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < f; j += NT) fn(j, to_f(xr[j]), to_f(dr[j]));
  }
}

// row_each whose fn returns dx's value, stored (16-byte stores with vec)
template <typename T, typename Fn>
__device__ __forceinline__ void row_map(const T* xr, const T* dr, T* o,
                                        int f, bool vec, Fn fn) {
  constexpr int V = Pack<T>::N;
  if (vec) {
    const uint4* x4 = reinterpret_cast<const uint4*>(xr);
    const uint4* d4 = reinterpret_cast<const uint4*>(dr);
#pragma unroll 4
    for (int q = threadIdx.x; q < f / V; q += NT) {
      float xv[V], dv[V], ov[V];
      Pack<T>::unpack(__ldg(x4 + q), xv);
      Pack<T>::unpack(__ldg(d4 + q), dv);
#pragma unroll
      for (int i = 0; i < V; ++i) ov[i] = fn(q * V + i, xv[i], dv[i]);
      reinterpret_cast<uint4*>(o)[q] = Pack<T>::pack(ov);
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < f; j += NT)
      o[j] = from_f<T>(fn(j, to_f(xr[j]), to_f(dr[j])));
  }
}

// The block path (rows wider than a warp's registers): a block a row;
// thread t owns the same columns in every row and their dgamma/dbeta
// sums in shared memory. `vec`: rows of whole 16-byte chunks on 16-byte
// bases, read and written 16 bytes at a time.
template <typename T, bool LN>
__global__ void __launch_bounds__(NT, 1)   // (NT) alone: 64 registers, a spill
norm_bwd_block_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const void* __restrict__ gamma, int gcode,
                      T* __restrict__ dx, float* __restrict__ part,
                      int* tickets, void* out, long long rows, int f,
                      float eps, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(f, (int)sizeof(T), LN, false, f, 0);
  const int ncol = LN ? 2 * f : f;
  const int tid = threadIdx.x;
  float* gam = reinterpret_cast<float*>(smem + L.gam);
  float* acc = reinterpret_cast<float*>(smem + L.blk);
  float* red = reinterpret_cast<float*>(smem + L.red);
  for (int j0 = tid; j0 < f; j0 += 8 * NT) {   // 8 loads in flight
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = j0 + u * NT < f ? load_any(gamma, j0 + u * NT, gcode) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u * NT < f) gam[j0 + u * NT] = v[u];
  }
  for (int j = tid; j < ncol; j += NT) acc[j] = 0.f;
  __syncthreads();
  const float inv_f = 1.f / (float)f;
  const long long r0 = rows * blockIdx.x / gridDim.x;
  const long long r1 = rows * (blockIdx.x + 1) / gridDim.x;
  int par = 0;
  for (long long r = r0; r < r1; ++r) {
    const T* xr = x + r * f;
    const T* dr = dy + r * f;
    if constexpr (!LN) {
      float v[2] = {0.f, 0.f};
      row_each(xr, dr, f, vec, [&](int j, float xv, float dv) {
        v[0] += xv * xv;
        v[1] += (dv * gam[j]) * xv;
      });
      block_sum<2>(v, red + par * NW * 4);
      par ^= 1;
      const float rstd = rsqrtf(v[0] * inv_f + eps);
      const float kk = (v[1] * inv_f) * rstd * rstd;
      row_map(xr, dr, dx + r * f, f, vec, [&](int j, float xv, float dv) {
        acc[j] += dv * xv * rstd;
        return (dv * gam[j] - xv * kk) * rstd;
      });
    } else {
      float m[1] = {0.f};
      row_each(xr, dr, f, vec, [&](int, float xv, float) { m[0] += xv; });
      block_sum<1>(m, red + par * NW * 4);
      par ^= 1;
      const float mu = m[0] * inv_f;
      float v[3] = {0.f, 0.f, 0.f};
      row_each(xr, dr, f, vec, [&](int j, float xv, float dv) {
        const float xc = xv - mu;
        const float gh = dv * gam[j];
        v[0] += xc * xc;
        v[1] += gh;
        v[2] += gh * xc;
      });
      block_sum<3>(v, red + par * NW * 4);
      par ^= 1;
      const float rstd = rsqrtf(v[0] * inv_f + eps);
      const float m1 = v[1] * inv_f;
      const float m2 = v[2] * rstd * inv_f;
      row_map(xr, dr, dx + r * f, f, vec, [&](int j, float xv, float dv) {
        const float xhat = (xv - mu) * rstd;
        acc[j] += dv * xhat;
        acc[f + j] += dv;
        return (dv * gam[j] - m1 - xhat * m2) * rstd;
      });
    }
  }
  __syncthreads();
  cluster_finish(acc, ncol, part, tickets, out, gcode,
                 reinterpret_cast<float*>(smem + L.fin),
                 reinterpret_cast<int*>(smem + L.flag));
}

struct Args {
  const void *x, *dy, *gamma;
  void *dx, *part, *tickets, *out;
  long long rows;
  int f, gcode;
  float eps;
  int grid, cluster;
  cudaStream_t stream;
};

// Query (result != nullptr: the co-resident blocks and the cluster size,
// the largest of 8, 4, 2, 1 the card can hold, in result[0..1]) or launch.
template <typename T>
int go(void (*kernel)(const T*, const T*, const void*, int, T*, float*,
                      int*, void*, long long, int, float, int),
       int smem, int last_arg, const Args& a, int* result) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (result) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    for (int cs = 8; cs >= 1; cs /= 2) {
      attr[0].val.clusterDim.x = cs;
      cfg.gridDim = dim3(cs, 1, 1);
      int n = 0;
      e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
      if (e != cudaSuccess) {
        cudaGetLastError();
        continue;
      }
      if (n > 0) {
        result[0] = n * cs;
        result[1] = cs;
        return 0;
      }
    }
    return e != cudaSuccess ? (int)e : -1;
  }
  attr[0].val.clusterDim.x = a.cluster;
  cfg.gridDim = dim3(a.grid, 1, 1);
  cfg.stream = a.stream;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)a.x, (const T*)a.dy, a.gamma, a.gcode,
      (T*)a.dx, (float*)a.part, (int*)a.tickets, a.out, a.rows, a.f,
      a.eps, last_arg);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, bool LN, int LOAD, int C>
int run_warp(const Args& a, int* result) {
  constexpr int E = WarpTraits<T, LN, LOAD, C>::E;
  const int stages = LOAD == LOAD_TMA ? TMA_STAGES : 0;
  return go<T>(norm_bwd_warp_kernel<T, LN, LOAD, C>,
               layout(a.f, (int)sizeof(T), LN, true, 32 * E, stages).total,
               stages, a, result);
}

// the warp kernel whose slots a lane fit a row of 16-byte chunks
template <typename T, bool LN, int LOAD>
int run_chunks(const Args& a, int* result) {
  const int c = (a.f / Pack<T>::N + 31) / 32;   // chunks a lane
  if constexpr (Pack<T>::N == 8) {
    if (c <= 1) return run_warp<T, LN, LOAD, 1>(a, result);
    if (c <= 2) return run_warp<T, LN, LOAD, 2>(a, result);
    if (c <= 3) return run_warp<T, LN, LOAD, 3>(a, result);
    return run_warp<T, LN, LOAD, 4>(a, result);
  } else {
    if (c <= 2) return run_warp<T, LN, LOAD, 2>(a, result);
    if (c <= 4) return run_warp<T, LN, LOAD, 4>(a, result);
    if (c <= 6) return run_warp<T, LN, LOAD, 6>(a, result);
    return run_warp<T, LN, LOAD, 8>(a, result);
  }
}

template <typename T, bool LN>
int run(const Args& a, int path, int* result) {
  if (path <= PATH_BLOCK_VEC)
    return go<T>(norm_bwd_block_kernel<T, LN>,
                 layout(a.f, (int)sizeof(T), LN, false, a.f, 0).total,
                 path == PATH_BLOCK_VEC, a, result);
  if (path == PATH_WARP) {   // one element a slot
    const int c = (a.f + 31) / 32;
    if (c <= 8) return run_warp<T, LN, LOAD_ELEM, 8>(a, result);
    if (c <= 16) return run_warp<T, LN, LOAD_ELEM, 16>(a, result);
    return run_warp<T, LN, LOAD_ELEM, 32>(a, result);
  }
  return path == PATH_WARP_TMA ? run_chunks<T, LN, LOAD_TMA>(a, result)
                               : run_chunks<T, LN, LOAD_VEC>(a, result);
}

template <typename T>
int by_mode(const Args& a, bool ln, int path, int* result) {
  return ln ? run<T, true>(a, path, result) : run<T, false>(a, path, result);
}

int dispatch(int dtype, const Args& a, bool ln, int path, int* result) {
  if (a.f < 1 || a.f > MAX_F || path < PATH_BLOCK || path > PATH_WARP_TMA)
    return -1;
  const int esize = dtype == F32 ? 4 : 2;
  const bool chunks = (a.f * esize) % 16 == 0;
  if ((path >= PATH_WARP && a.f > WARP_MAX_F) ||
      (path != PATH_BLOCK && path != PATH_WARP && !chunks))
    return -1;
  if (dtype == F32) return by_mode<float>(a, ln, path, result);
  if (dtype == BF16) return by_mode<__nv_bfloat16>(a, ln, path, result);
  if (dtype == F16) return by_mode<__half>(a, ln, path, result);
  return -1;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// The grid limits of one configuration on the current device: writes the
// co-resident blocks and the cluster size into result (int[2]); also
// raises the kernel's dynamic shared-memory limit, which every launch of
// the configuration needs first. dtype: x's (0 f32, 1 bf16, 2 f16); ln:
// LayerNorm (else RMSNorm); path: 0 a block a row, 1 the same with
// 16-byte accesses, 2 a warp a row (F <= 1024), 3 the same with 16-byte
// loads, 4 the same with rows by TMA (1, 3 and 4: rows of whole 16-byte
// chunks on 16-byte bases). Returns 0, a cudaError_t code, or -1 for a
// configuration it does not take.
int dl4j_norm_bwd_grid(int dtype, int ln, int path, int f, void* result) {
  Args a = {};
  a.f = f;
  return dispatch(dtype, a, ln != 0, path, (int*)result);
}

// K6 (ln = 0) or K9 (ln = 1): x, dy, dx [rows, f] of dtype, contiguous;
// gamma [f] of gdtype; out [f] (K6: dgamma) or [2f] (K9: dgamma then
// dbeta) of gdtype; part: f32 [grid / cluster, f or 2f] scratch;
// tickets: int32 [cluster] in device memory, 0 before the launch and 0
// after it. cluster 1, 2, 4 or 8, as dl4j_norm_bwd_grid gives it; grid a
// multiple of cluster, at most what dl4j_norm_bwd_grid
// gave (which must have run first for this configuration on this
// device). Returns 0, a cudaError_t code, or -1 for arguments it does
// not take.
int dl4j_norm_bwd(int dtype, int gdtype, int ln, int path, const void* x,
                  const void* dy, const void* gamma, void* dx, void* part,
                  void* tickets, void* out, long long rows, int f,
                  float eps, int grid, int cluster, void* stream) {
  if (rows < 1 || grid < 1 || cluster < 1 || cluster > 8 ||
      (cluster & (cluster - 1)) || grid % cluster || gdtype < F32 ||
      gdtype > F16)
    return -1;
  if (path != PATH_BLOCK && path != PATH_WARP &&
      !(aligned16(x) && aligned16(dy) && aligned16(dx)))
    return -1;
  Args a = {x, dy, gamma, dx, part, tickets, out, rows, f, gdtype, eps,
            grid, cluster, (cudaStream_t)stream};
  return dispatch(dtype, a, ln != 0, path, nullptr);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
