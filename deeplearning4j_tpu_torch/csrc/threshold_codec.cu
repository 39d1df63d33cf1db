// Threshold codec for Hopper (sm_90a), plain C interface: the encode
// (K10) and decode (K11) of the packed gradient exchange.
//
// Replaces the TPU kernels `_encode_kernel` and `_decode_kernel` of
// deeplearning4j_tpu/ops/pallas_kernels.py (reached through
// `threshold_encode` and `threshold_decode`, called per gradient leaf by
// `EncodedGradientsAccumulator.exchange_packed`).
//
// Wire format (the JAX entry's, bit for bit): word c holds the flat
// elements 16c .. 16c+15, element 16c+j at bits 2j and 2j+1; code 1 for
// g > tau, 2 for g < -tau, else 0 (strict comparisons, so NaN and +-tau
// give 0). A word is built as uint32 (code 2 at j = 15 sets bit 31) and
// stored as the same bits in int32. Elements past the leaf's size encode
// as 0.0 does, as the JAX entry's zero padding does. The residual is
// g - q in f32, q = +-tau or 0. tau is read from device memory, as the
// TPU kernel reads it from SMEM: the accumulator's tau is device state
// that adapts every step, and passing it by value would need a host read.
//
// What bounds it on this card: bytes. Both kernels do a few integer and
// compare operations per element: the encode reads 4 bytes of gradient
// and writes 4 bytes of residual and 2 bits of code an element (~8.25 B),
// the decode reads 2 bits and writes 4 bytes (~4.25 B). At 3.35 TB/s the
// full-width LM's 123.6 M gradients take ~0.30 ms to encode and ~0.16 ms
// to decode. The design moves each byte once: one thread owns one word,
// reads its 16 contiguous floats with four 16-byte loads (or writes its
// 16 floats with four 16-byte stores) and writes its word; neighbouring
// threads own neighbouring 64-byte runs, so a warp's four loads cover
// 2 KB of contiguous memory. The JAX kernel's (16, C) transpose, a
// layout for the TPU's vector unit, is never materialised. A ragged last
// word, or an operand not 16-byte aligned, takes scalar accesses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 16;      // two-bit codes per word
constexpr int NTHREADS = 256;  // one word per thread

__global__ void __launch_bounds__(NTHREADS)
threshold_encode_kernel(const float* __restrict__ g,
                        const float* __restrict__ tau_p,
                        int32_t* __restrict__ packed,
                        float* __restrict__ resid, long long size,
                        long long n_words, int vec) {
  const long long c = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= n_words) return;
  const float tau = __ldg(tau_p);
  const long long base = c * GROUP;
  const bool full = base + GROUP <= size;
  float x[GROUP];
  if (full && vec) {
    const float4* g4 = reinterpret_cast<const float4*>(g + base);
#pragma unroll
    for (int i = 0; i < GROUP / 4; ++i) {
      const float4 t = __ldg(g4 + i);
      x[4 * i] = t.x;
      x[4 * i + 1] = t.y;
      x[4 * i + 2] = t.z;
      x[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      x[j] = base + j < size ? g[base + j] : 0.0f;
  }
  uint32_t word = 0u;
  float r[GROUP];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const bool pos = x[j] > tau;
    const bool neg = x[j] < -tau;
    const uint32_t code = pos ? 1u : (neg ? 2u : 0u);
    r[j] = x[j] - (pos ? tau : (neg ? -tau : 0.0f));
    word |= code << (2 * j);
  }
  packed[c] = (int32_t)word;
  if (full && vec) {
    float4* r4 = reinterpret_cast<float4*>(resid + base);
#pragma unroll
    for (int i = 0; i < GROUP / 4; ++i)
      r4[i] = make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2],
                          r[4 * i + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (base + j < size) resid[base + j] = r[j];
  }
}

__global__ void __launch_bounds__(NTHREADS)
threshold_decode_kernel(const int32_t* __restrict__ packed,
                        const float* __restrict__ tau_p,
                        float* __restrict__ out, long long size,
                        long long n_words, int vec) {
  const long long c = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= n_words) return;
  const float tau = __ldg(tau_p);
  const uint32_t word = (uint32_t)__ldg(packed + c);
  const long long base = c * GROUP;
  float v[GROUP];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const uint32_t code = (word >> (2 * j)) & 3u;
    v[j] = code == 1u ? tau : (code == 2u ? -tau : 0.0f);
  }
  if (base + GROUP <= size && vec) {
    float4* o4 = reinterpret_cast<float4*>(out + base);
#pragma unroll
    for (int i = 0; i < GROUP / 4; ++i)
      o4[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                          v[4 * i + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (base + j < size) out[base + j] = v[j];
  }
}

bool aligned16(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15u) == 0;
}

}  // namespace

extern "C" {

// g: float32 [size]; tau: float32 [1] in device memory; packed: int32
// [n_words] (n_words >= ceil(size / 16): the words past the leaf encode
// zeros); resid: float32 [size]. Returns 0, a cudaError_t code, or -1
// for a grid too large.
int dl4j_threshold_encode(const void* g, const void* tau, void* packed,
                          void* resid, long long size, long long n_words,
                          void* stream) {
  if (n_words <= 0) return 0;
  const long long blocks = (n_words + NTHREADS - 1) / NTHREADS;
  if (blocks > 2147483647LL) return -1;
  threshold_encode_kernel<<<(unsigned)blocks, NTHREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float*)g, (const float*)tau, (int32_t*)packed, (float*)resid,
      size, n_words, (int)aligned16(g, resid));
  return (int)cudaGetLastError();
}

// packed: int32 [>= ceil(size / 16)]; tau: float32 [1] in device memory;
// out: float32 [size]. Returns 0, a cudaError_t code, or -1 for a grid
// too large.
int dl4j_threshold_decode(const void* packed, const void* tau, void* out,
                          long long size, void* stream) {
  const long long n_words = (size + GROUP - 1) / GROUP;
  if (n_words <= 0) return 0;
  const long long blocks = (n_words + NTHREADS - 1) / NTHREADS;
  if (blocks > 2147483647LL) return -1;
  threshold_decode_kernel<<<(unsigned)blocks, NTHREADS, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)packed, (const float*)tau, (float*)out, size,
      n_words, (int)aligned16(out, out));
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
