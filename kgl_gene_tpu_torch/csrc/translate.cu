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
// over the memory rate. The design moves each byte once: one thread per
// codon, neighbouring threads on neighbouring codons (3-byte loads that
// coalesce across the warp), the LUT staged once per block in shared
// memory. The LUT is a device tensor argument, never a compiled-in
// constant, so all five NCBI tables stay data.
#include "common.cuh"

__global__ void translate_kernel(const uint8_t* __restrict__ coding,
                                 int64_t row_stride, int64_t k,
                                 const uint8_t* __restrict__ lut,
                                 uint8_t* __restrict__ out, int64_t n) {
  __shared__ uint8_t s_lut[65];
  for (int t = threadIdx.x; t < 65; t += blockDim.x) s_lut[t] = lut[t];
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int64_t row = i / k;
    const int64_t col = i - row * k;
    const uint8_t* p = coding + row * row_stride + 3 * col;
    const int c0 = p[0], c1 = p[1], c2 = p[2];
    const int idx = (c0 >= 4 || c1 >= 4 || c2 >= 4) ? 64 : c0 * 16 + c1 * 4 + c2;
    out[i] = s_lut[idx];
  }
}

// coding: (B, >= 3k) uint8 rows `row_stride` bytes apart; lut: (65,)
// uint8; out: (B, k) uint8, contiguous.
KGT_API int kgt_translate(const void* coding, int64_t row_stride, int64_t B,
                          int64_t k, const void* lut, void* out,
                          void* stream) {
  const int64_t n = B * k;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  translate_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)coding, row_stride, k, (const uint8_t*)lut,
      (uint8_t*)out, n);
  return kgt_launch_status();
}
