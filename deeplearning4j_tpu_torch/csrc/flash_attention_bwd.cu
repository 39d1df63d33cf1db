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
// bound is the tensor cores (~0.065 ms at 989 TFLOP/s). Two kernels
// behind one entry, picked by dtype:
//  - bf16, the model's paths: flash_bwd_kv_mma_kernel<D, true>, the
//    key-stationary tensor-core loop of flash_mma.cuh shared with K5.
//    One block per (batch, kv head, 64-key tile), key tile 0 of every
//    head first; K and V resident in swizzled shared memory, each warp
//    owning 16 keys and their dk and dv (f32) in registers; Q, dO, lse
//    and Delta of each query tile from the causal diagonal on stream
//    through a two-stage cp.async ring, one barrier a tile. S^T, dP^T,
//    dv and dk run on mma.sync as in K5, with P^T and dS^T rounded to
//    bf16 in registers (the TPU kernel's rounding). The loop runs over
//    every query head of the kv head's group inside the block, so dk/dv
//    come out already summed onto the kv head (the TPU path's
//    `_reduce_kv_rows`) in a fixed order, with no atomics.
//  - dq gathers contributions from every key tile, which Hopper runs in
//    no order. Each tile the warps write their bf16 dS^T rows to a
//    shared 64 x 64 tile; after a barrier each warp multiplies 16 query
//    rows of dS (read transposed) by K on mma.sync and adds them into an
//    f32 [B, Tq, H, D] buffer (the TPU kernel's full-length VMEM
//    scratch) by float4 atomics, four adjacent columns a lane; a last
//    small kernel scales it and casts it to the storage type. The order
//    of those atomics changes from run to run, so dq may differ in its
//    last bits; dk and dv do not. 105 KB of shared memory at D = 128:
//    two blocks an SM. wgmma, TMA and warp specialisation are what is
//    left beyond mma.sync.
//  - f32, the agree phases' card-vs-CPU checks: the CUDA-core
//    flash_bwd_kv_kernel<float, D, true> of flash_bwd_common.cuh, f32
//    throughout, with scalar dq atomics. A TF32 tensor-core product
//    keeps ~3 decimal digits and would not hold those checks' 1e-5 loss
//    and 1e-3 gradient bands.
//
// The Delta pre-pass, the f32 kernel and the semantics carried from the
// TPU kernel live in flash_bwd_common.cuh, shared with the split pair
// K4, K5.
#include "flash_bwd_common.cuh"
#include "flash_mma.cuh"

#include <type_traits>

namespace {

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

  e = (cudaError_t)launch_delta<T>(a.o, a.dout, a.delta, a.B, a.Tq, a.H, D,
                                   a.so, a.sd, a.stream);
  if (e != cudaSuccess) return (int)e;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    e = fmma::launch_bwd_kv_mma<D, true>(
        a.q, a.k, a.v, a.dout, (const float*)a.lse, (const float*)a.delta,
        (const float*)a.km, (float*)a.dq_acc, a.dk, a.dv, a.B, a.Tq, a.Tk,
        a.H, a.Hkv, a.sq, a.sk, a.sv, a.sd, a.causal, a.q_off, 0, a.scale,
        a.stream);
  } else {
    constexpr size_t smem = kv_smem_bytes<D>();
    static const cudaError_t attr =
        fmma::set_smem_attr(flash_bwd_kv_kernel<T, D, true>, smem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((a.Tk + BK - 1) / BK, a.Hkv, a.B);
    flash_bwd_kv_kernel<T, D, true><<<grid, NTHREADS, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (const float*)a.km,
        (float*)a.dq_acc, (T*)a.dk, (T*)a.dv, a.Tq, a.Tk, a.H, a.Hkv,
        a.H / a.Hkv, a.sq[0], a.sq[1], a.sq[2], a.sk[0], a.sk[1], a.sk[2],
        a.sv[0], a.sv[1], a.sv[2], a.sd[0], a.sd[1], a.sd[2], a.causal,
        a.q_off, 0, a.scale);
    e = cudaGetLastError();
  }
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
