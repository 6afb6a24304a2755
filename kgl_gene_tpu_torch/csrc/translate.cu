// Kernel B2: codon translation through a 65-entry LUT.
//
// Replaces the TPU kernel _translate_kernel (kgl_gene_tpu/ops/
// variant_apply.py:95, launched by translate_batch_pallas) and fuses the
// codon indexing that ran before it in XLA (_codon_index): (B, S) uint8
// base codes -> (B, S/3) uint8 amino codes. A codon holding a code >= 4
// (N) takes the sentinel entry 64.
//
// Bound on the card: bytes. Each output byte reads three input bytes and
// does a handful of integer operations, far below the card's
// operations-per-byte balance, so the least time is (B*S + B*S/3) bytes
// over the memory rate: 0.3 us at (256, 3000), 4.9 us at (4096, 3000). At
// the first shape the device work is smaller than the launch itself, so
// what a caller sees is the host cost of the launch (kernels/__init__.py
// keeps that small); the kernel's own design shows at the second.
//
// Design. When S = 3k and the rows are contiguous, (B, S) -> (B, k) is one
// flat stream of codons and rows do not matter: the vector body gives each
// thread 16 consecutive codons, 48 bytes as three 16-byte loads and one
// 16-byte store, neighbouring threads on neighbouring addresses, no
// division, one thread per group (the grid is sized to the data). The
// ragged end of the stream (n % 16 codons) is done byte by byte by the
// thread that owns it. The scalar body takes everything else (S % 3 != 0
// leaves 1-2 bytes a row to skip; a view's pointer need not be 16-byte
// aligned): one thread per codon, three 1-byte loads, a division to find
// the row. pick_body chooses; kgt_translate_body tells which it chose, so
// that a check can show both bodies ran. The LUT is a device tensor
// argument staged in shared memory, never a compiled-in constant, so all
// five NCBI tables stay data.
#include "common.cuh"

constexpr int GROUP = 16;  // codons per thread in the vector body

__device__ __forceinline__ uint32_t amino(const uint8_t* s_lut, uint32_t c0,
                                          uint32_t c1, uint32_t c2) {
  // (c0 | c1 | c2) >= 4 iff one of them is: bases are 0..3.
  return s_lut[(c0 | c1 | c2) >= 4 ? 64 : c0 * 16 + c1 * 4 + c2];
}

__device__ __forceinline__ void stage_lut(uint8_t* s_lut,
                                          const uint8_t* __restrict__ lut) {
  for (int t = threadIdx.x; t < 65; t += blockDim.x) s_lut[t] = lut[t];
  __syncthreads();
}

// Four codons from twelve bytes held in three little-endian words.
__device__ __forceinline__ uint32_t amino4(const uint8_t* s_lut, uint32_t x,
                                           uint32_t y, uint32_t z) {
  return amino(s_lut, x & 255, (x >> 8) & 255, (x >> 16) & 255) |
         amino(s_lut, x >> 24, y & 255, (y >> 8) & 255) << 8 |
         amino(s_lut, (y >> 16) & 255, y >> 24, z & 255) << 16 |
         amino(s_lut, (z >> 8) & 255, (z >> 16) & 255, z >> 24) << 24;
}

// coding: 3n contiguous bytes, 16-byte aligned; out: n bytes, 16-byte aligned.
__global__ void translate_vector_kernel(const uint8_t* __restrict__ coding,
                                        const uint8_t* __restrict__ lut,
                                        uint8_t* __restrict__ out, int64_t n) {
  __shared__ uint8_t s_lut[65];
  stage_lut(s_lut, lut);
  const int64_t first =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * GROUP;
  if (first >= n) return;
  if (first + GROUP <= n) {
    const uint4* src = (const uint4*)(coding + 3 * first);
    const uint4 v0 = __ldg(src), v1 = __ldg(src + 1), v2 = __ldg(src + 2);
    uint4 o;
    o.x = amino4(s_lut, v0.x, v0.y, v0.z);
    o.y = amino4(s_lut, v0.w, v1.x, v1.y);
    o.z = amino4(s_lut, v1.z, v1.w, v2.x);
    o.w = amino4(s_lut, v2.y, v2.z, v2.w);
    *(uint4*)(out + first) = o;
  } else {  // the ragged end of the stream
    for (int64_t i = first; i < n; ++i) {
      const uint8_t* p = coding + 3 * i;
      out[i] = (uint8_t)amino(s_lut, p[0], p[1], p[2]);
    }
  }
}

// coding: (B, >= 3k) rows `row_stride` bytes apart, any alignment.
__global__ void translate_scalar_kernel(const uint8_t* __restrict__ coding,
                                        int64_t row_stride, int64_t k,
                                        const uint8_t* __restrict__ lut,
                                        uint8_t* __restrict__ out, int64_t n) {
  __shared__ uint8_t s_lut[65];
  stage_lut(s_lut, lut);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int64_t row = i / k;
    const uint8_t* p = coding + row * row_stride + 3 * (i - row * k);
    out[i] = (uint8_t)amino(s_lut, p[0], p[1], p[2]);
  }
}

// 1: the vector body (a flat codon stream, both pointers 16-byte aligned);
// 0: the scalar body.
static int pick_body(const void* coding, int64_t row_stride, int64_t k,
                     const void* out) {
  const bool flat = row_stride == 3 * k;
  const bool aligned = ((uintptr_t)coding | (uintptr_t)out) % 16 == 0;
  return flat && aligned ? 1 : 0;
}

KGT_API int kgt_translate_body(const void* coding, int64_t row_stride,
                               int64_t k, const void* out) {
  return pick_body(coding, row_stride, k, out);
}

// coding: (B, >= 3k) uint8 rows `row_stride` bytes apart; lut: (65,)
// uint8; out: (B, k) uint8, contiguous.
KGT_API int kgt_translate(const void* coding, int64_t row_stride, int64_t B,
                          int64_t k, const void* lut, void* out,
                          void* stream) {
  const int64_t n = B * k;
  if (n == 0) return 0;
  const int threads = 256;
  if (pick_body(coding, row_stride, k, out)) {
    const int64_t groups = (n + GROUP - 1) / GROUP;
    translate_vector_kernel<<<(unsigned)((groups + threads - 1) / threads),
                              threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)coding, (const uint8_t*)lut, (uint8_t*)out, n);
  } else {
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // then threads stride on
    translate_scalar_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
        (const uint8_t*)coding, row_stride, k, (const uint8_t*)lut,
        (uint8_t*)out, n);
  }
  return kgt_launch_status();
}
