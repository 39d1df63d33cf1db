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
// to decode.
//
// K10 moves each byte once: one thread owns one word, reads its 16
// contiguous floats with four 16-byte loads and writes its word and its
// 16 residuals with four 16-byte stores; neighbouring threads own
// neighbouring 64-byte runs, so a warp's four loads cover 2 KB of
// contiguous memory. The JAX kernel's (16, C) transpose, a layout for
// the TPU's vector unit, is never materialised. A ragged last word, or
// an operand not 16-byte aligned, takes scalar accesses.
//
// K11 writes 64 bytes (16 floats) for every 4-byte word it reads, so
// its time is its stores. The first design took K10's layout (one
// thread a word, four float4 stores at a 64-byte lane stride): one warp
// store instruction then filled 32 sectors by half each, ~0.42 of the
// bound at the embedding leaf on an H100 SXM at 700 W. This design
// gives a warp a span of 512 elements (32 words, 2 KB of output): lane
// l loads word l of the span (one 128-byte load for the warp), and for
// j = 0..3 writes float4 number 32j + l of the span from byte l % 4 of
// word 8j + l / 4, fetched by __shfl_sync, so every store instruction
// covers 512 contiguous bytes (16 whole sectors). The grid is the
// wrapper's (`decode_grid` in ops/cuda_kernels.py): a warp a span over
// the whole leaf, 4 warps a block, so that a [768, 768] leaf spreads
// over every SM. On that card this measured faster at every leaf of the
// packed step than a persistent grid from the occupancy API with the
// next span's load ahead of the stores, and the default write-back
// stores than `st.global.cs` once the exchange's sum that reads the
// decoded leaf is counted. A ragged last span takes scalar stores in a
// coalesced lane order (element 32i + l of the span from lane l),
// masked at the leaf's end. The output is the wrapper's own
// allocation, always 16-byte aligned; the C entry refuses any other.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 16;      // two-bit codes per word
constexpr int NTHREADS = 256;  // one word per thread
// K11: a warp decodes a span of SPAN_WORDS words (SPAN elements, 2 KB of
// f32), DEC_WARPS warps a block
constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int SPAN_WORDS = 32;
constexpr int SPAN = SPAN_WORDS * GROUP;

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

__device__ __forceinline__ float decode_code(uint32_t bits, float tau) {
  const uint32_t code = bits & 3u;
  return code == 1u ? tau : (code == 2u ? -tau : 0.0f);
}

// One warp a span of SPAN elements: span blockIdx.x * DEC_WARPS + warp.
// out is 16-byte aligned: the spans that lie wholly inside the leaf take
// float4 stores.
__global__ void __launch_bounds__(DEC_THREADS)
threshold_decode_kernel(const int32_t* __restrict__ packed,
                        const float* __restrict__ tau_p,
                        float* __restrict__ out, long long size) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * DEC_WARPS + (threadIdx.x >> 5);
  const long long left = size - s * SPAN;  // elements from the span on
  if (left <= 0) return;
  const float tau = __ldg(tau_p);
  const long long c = s * SPAN_WORDS + lane;
  const uint32_t word =
      c < (size + GROUP - 1) / GROUP ? (uint32_t)__ldg(packed + c) : 0u;
  float* o = out + s * SPAN;
  if (left >= SPAN) {
    // float4 number 32j + l: elements 4(32j + l) .. +3, byte l % 4 of
    // word 8j + l / 4; each instruction stores 512 contiguous bytes
    float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
    for (int j = 0; j < SPAN / 128; ++j) {
      const uint32_t w = __shfl_sync(0xffffffffu, word, 8 * j + (lane >> 2));
      const uint32_t b = w >> (8 * (lane & 3));
      o4[32 * j + lane] =
          make_float4(decode_code(b, tau), decode_code(b >> 2, tau),
                      decode_code(b >> 4, tau), decode_code(b >> 6, tau));
    }
  } else {
    // element 32i + l: word 2i + l / 16, bits 2(l % 16); 128 contiguous
    // bytes an instruction, masked at the leaf's end
#pragma unroll
    for (int i = 0; i < SPAN / 32; ++i) {
      const uint32_t w = __shfl_sync(0xffffffffu, word, 2 * i + (lane >> 4));
      const int e = 32 * i + lane;
      if (e < left) o[e] = decode_code(w >> (2 * (lane & 15)), tau);
    }
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
// out: float32 [size], 16-byte aligned; grid: blocks of DEC_THREADS,
// one warp a span of SPAN elements, at least ceil(size / SPAN) warps.
// Returns 0, a cudaError_t code, or -1 for a grid or an out it does not
// take (nothing launched).
int dl4j_threshold_decode(const void* packed, const void* tau, void* out,
                          long long size, long long grid, void* stream) {
  if (size <= 0) return 0;
  if (grid < 1 || grid > 2147483647LL || grid * DEC_WARPS * SPAN < size ||
      !aligned16(out, out))
    return -1;
  threshold_decode_kernel<<<(unsigned)grid, DEC_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)packed, (const float*)tau, (float*)out, size);
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
