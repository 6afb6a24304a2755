// FWS statistics over codes resident on the card: the two passes of
// stats/fws.py fws_statistics, a kernel each.
//
// Replaces no Pallas kernel: the JAX package's FWS (kgl_gene_tpu/stats/
// fws.py CalcFWS) is numpy on the host over a dense (G, V) matrix, a loop
// over genomes and bins. The port's plain versions (stats/fws.py
// _variant_counts_plain, _genome_partials_plain) are the same passes in
// eager PyTorch, each writing and reading again temporaries of every cell.
//
// Codes (V, G) uint8, a variant's row `stride` bytes after the last, rows
// 16-byte aligned (stride a multiple of 16), the storage holding each row's
// last 16-byte chunk whole (variant/columnar.py resident_codes). A code is
// heterozygous when it is 1 and homozygous when it is 2 (its two low bits:
// the resident codes are 0, 1 or 2, and a 3 is neither).
//
// Pass one, `fws_variants`: a warp a row, its lanes the row's 16-byte
// chunks in turn, FV_UNROLL chunks of a lane in flight; a chunk's codes
// are ANDed with the same chunk of the subset's mask (a byte a genome, 1 in
// the subset) and counted by popcount; the warp's sums are reduced in one
// instruction and written as the row's (het, hom). Integer sums: the result
// does not depend on the order.
//
// Pass two, `fws_genomes`: rows ordered by AF bin (`order`) are cut into
// segments, each inside one bin; block (tile, segment) sums the segment's
// rows for a tile of FG_TILE genomes, a thread FG_VEC neighbouring genomes
// in one 8-byte load a row, FG_ROWS rows' loads in flight while the last
// ones are computed. The block stages FG_BATCH rows' indices and hs in
// shared memory at a time; within a batch a thread counts its genomes'
// codes 1 and 2 in byte lanes of a word (a batch is under 256 rows, so no
// lane overflows) and widens them after it; each genome's hs sum over the
// rows it carries is a float64 add a cell, in row order. Each block writes
// its own partials, (het, hom) int32 and hs float64 of (segment, genome):
// no atomics, so the host's sums over segments in their order give the
// same hs_sum at every call.
//
// Bound on the card (H100 SXM, 700 W): each pass reads every code once, V x
// G bytes; at the Pf7 cell's 16,203 genomes x 2,000,000 variants that is
// 32.4 GB, 9.7 ms a pass at 3.35 TB/s. A cell of pass two is about four
// lane instructions (its share of a load, the two class bits, a byte-lane
// add, the select and float64 add of hs), under the byte floor's time at
// the issue rate.
#include "common.cuh"

constexpr int FV_WARPS = 8;            // pass one: warps a block, a row a warp at a time
constexpr int FV_THREADS = 32 * FV_WARPS;
constexpr int FV_UNROLL = 4;           // 16-byte chunks of a lane in flight
constexpr int FG_THREADS = 128;        // pass two: threads a block
constexpr int FG_VEC = 8;              // genomes a thread: one 8-byte load a row
constexpr int FG_TILE = FG_THREADS * FG_VEC;  // genomes a block (stats/fws.py GENOME_TILE)
constexpr int FG_ROWS = 4;             // rows of a thread whose loads are in flight at once
constexpr int FG_BATCH = 252;          // rows staged at a time: under 256, a multiple of FG_ROWS
constexpr unsigned LOW_BITS = 0x01010101u;
static_assert(FG_BATCH % FG_ROWS == 0 && FG_BATCH < 256, "a byte lane counts a batch");

// A word of four codes and its mask bytes (0 or 1): the lanes that are 1 (het)
// and 2 (hom) in the subset, a bit at the bottom of each byte.
__device__ __forceinline__ void classes(unsigned w, unsigned m, unsigned& het, unsigned& hom) {
  const unsigned b0 = w & m, b1 = (w >> 1) & m;
  het = b0 & ~b1;
  hom = b1 & ~b0;
}

// Pass one: counts[v] and counts[V + v], row v's codes 1 and 2 over the
// genomes whose mask byte is 1. mask (chunks x 16,) bytes, 0 past G.
__global__ void __launch_bounds__(FV_THREADS)
fws_variant_kernel(const uint8_t* __restrict__ codes, int64_t V, int64_t G, int64_t stride,
                   const uint8_t* __restrict__ mask, int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t chunks = (G + 15) / 16;
  const uint4* m = (const uint4*)mask;
  const int64_t warps = (int64_t)gridDim.x * FV_WARPS;
  for (int64_t v = (int64_t)blockIdx.x * FV_WARPS + (threadIdx.x >> 5); v < V; v += warps) {
    const uint4* row = (const uint4*)(codes + v * stride);
    unsigned het = 0, hom = 0;
    for (int64_t j0 = lane; j0 < chunks; j0 += 32 * FV_UNROLL) {
      uint4 c[FV_UNROLL], k[FV_UNROLL];
#pragma unroll
      for (int u = 0; u < FV_UNROLL; ++u) {
        const int64_t j = j0 + 32 * u;
        c[u] = j < chunks ? __ldcs(row + j) : make_uint4(0, 0, 0, 0);
        k[u] = j < chunks ? __ldg(m + j) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < FV_UNROLL; ++u) {
        const unsigned w[4] = {c[u].x, c[u].y, c[u].z, c[u].w};
        const unsigned s[4] = {k[u].x, k[u].y, k[u].z, k[u].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          unsigned one, two;
          classes(w[q], s[q], one, two);
          het += __popc(one);
          hom += __popc(two);
        }
      }
    }
    het = __reduce_add_sync(0xffffffffu, het);
    hom = __reduce_add_sync(0xffffffffu, hom);
    if (lane == 0) {
      counts[v] = (int)het;
      counts[V + v] = (int)hom;
    }
  }
}

// FG_ROWS rows of a batch from row i on: their codes at the thread's
// genomes (0 past the batch's n rows).
__device__ __forceinline__ void load_group(const uint8_t* __restrict__ codes, int64_t stride,
                                           int64_t g0, const int* s_row, int i, int n,
                                           uint2 (&c)[FG_ROWS]) {
#pragma unroll
  for (int u = 0; u < FG_ROWS; ++u)
    c[u] = i + u < n ? __ldcs((const uint2*)(codes + (int64_t)s_row[i + u] * stride + g0))
                     : make_uint2(0, 0);
}

// Pass two, block (tile, segment s): for the tile's genomes, het_part[s, g]
// and hom_part[s, g], the codes 1 and 2 over rows order[bounds[s]:bounds[s
// + 1]], and hs_part[s, g], the sum of those rows' hs where the code is 1
// or 2 (hs (V,) is of order's rows). The partials are (S, Gp); a genome
// past G reads its row's padding and its sums are not used.
__global__ void __launch_bounds__(FG_THREADS)
fws_genome_kernel(const uint8_t* __restrict__ codes, int64_t G, int64_t stride,
                  const int* __restrict__ order, const double* __restrict__ hs,
                  const int64_t* __restrict__ bounds, int64_t Gp, int* __restrict__ het_part,
                  int* __restrict__ hom_part, double* __restrict__ hs_part) {
  __shared__ int s_row[FG_BATCH];
  __shared__ double s_hs[FG_BATCH];
  const int tid = threadIdx.x;
  const int64_t s = blockIdx.y;
  const int64_t g0 = (int64_t)blockIdx.x * FG_TILE + (int64_t)tid * FG_VEC;
  const bool live = g0 < G;
  const int64_t r0 = bounds[s], r1 = bounds[s + 1];

  double acc[FG_VEC];
  unsigned het[FG_VEC], hom[FG_VEC];
#pragma unroll
  for (int k = 0; k < FG_VEC; ++k) {
    acc[k] = 0.0;
    het[k] = hom[k] = 0;
  }
  for (int64_t b0 = r0; b0 < r1; b0 += FG_BATCH) {
    const int n = (int)min((int64_t)FG_BATCH, r1 - b0);
    __syncthreads();  // the last batch's rows are read
    for (int i = tid; i < n; i += FG_THREADS) {
      s_row[i] = __ldg(order + b0 + i);
      s_hs[i] = __ldg(hs + b0 + i);
    }
    __syncthreads();
    if (!live) continue;
    unsigned lanes_het[2] = {0, 0}, lanes_hom[2] = {0, 0};
    uint2 next[FG_ROWS];
    load_group(codes, stride, g0, s_row, 0, n, next);
    for (int i = 0; i < n; i += FG_ROWS) {
      uint2 c[FG_ROWS];
#pragma unroll
      for (int u = 0; u < FG_ROWS; ++u) c[u] = next[u];
      if (i + FG_ROWS < n) load_group(codes, stride, g0, s_row, i + FG_ROWS, n, next);
#pragma unroll
      for (int u = 0; u < FG_ROWS; ++u) {
        const double h = i + u < n ? s_hs[i + u] : 0.0;
        const unsigned w[2] = {c[u].x, c[u].y};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          unsigned one, two;
          classes(w[q], LOW_BITS, one, two);
          lanes_het[q] += one;
          lanes_hom[q] += two;
          const unsigned carried = one | two;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if ((carried >> (8 * b)) & 1u) acc[4 * q + b] += h;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        het[4 * q + b] += (lanes_het[q] >> (8 * b)) & 0xFFu;
        hom[4 * q + b] += (lanes_hom[q] >> (8 * b)) & 0xFFu;
      }
  }

  const int64_t at = s * Gp + g0;
  int4* h4 = (int4*)(het_part + at);
  int4* m4 = (int4*)(hom_part + at);
  h4[0] = make_int4((int)het[0], (int)het[1], (int)het[2], (int)het[3]);
  h4[1] = make_int4((int)het[4], (int)het[5], (int)het[6], (int)het[7]);
  m4[0] = make_int4((int)hom[0], (int)hom[1], (int)hom[2], (int)hom[3]);
  m4[1] = make_int4((int)hom[4], (int)hom[5], (int)hom[6], (int)hom[7]);
  double2* a2 = (double2*)(hs_part + at);
#pragma unroll
  for (int k = 0; k < FG_VEC / 2; ++k) a2[k] = make_double2(acc[2 * k], acc[2 * k + 1]);
}

static bool rows_readable(const void* codes, int64_t G, int64_t stride) {
  return G >= 1 && stride % 16 == 0 && stride >= (G + 15) / 16 * 16 && (uintptr_t)codes % 16 == 0;
}

// Pass one over V rows of codes (G genomes, rows `stride` bytes apart):
// counts (2, V) int32, each row's codes 1 and 2 over the genomes whose
// mask byte is 1; mask ((G + 15) / 16 x 16,) bytes at least, 16-byte
// aligned, 0 past G. A grid of as many blocks as the card holds at once.
KGT_API int kgt_fws_variants(const void* codes, int64_t V, int64_t G, int64_t stride,
                             const void* mask, void* counts, cudaStream_t stream) {
  if (V < 1 || !rows_readable(codes, G, stride) || (uintptr_t)mask % 16)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fws_variant_kernel, FV_THREADS, 0);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t needed = (V + FV_WARPS - 1) / FV_WARPS;
  const int64_t blocks = resident < needed ? resident : needed;
  fws_variant_kernel<<<(unsigned)blocks, FV_THREADS, 0, stream>>>(
      (const uint8_t*)codes, V, G, stride, (const uint8_t*)mask, (int*)counts);
  return kgt_launch_status();
}

// Pass two: S segments of rows (bounds (S + 1,) int64 into order (V,)
// int32, each segment's rows in one AF bin) for G genomes of codes (rows
// `stride` bytes apart); hs (V,) float64 of order's rows; het_part,
// hom_part (S, Gp) int32 and hs_part (S, Gp) float64 out, Gp a multiple of
// FG_TILE at least G, each 16-byte aligned. A block a tile and segment.
KGT_API int kgt_fws_genomes(const void* codes, int64_t G, int64_t stride, const void* order,
                            const void* hs, const void* bounds, int64_t S, int64_t Gp,
                            void* het_part, void* hom_part, void* hs_part, cudaStream_t stream) {
  if (!rows_readable(codes, G, stride) || S < 1 || S > 65535 || Gp < G || Gp % FG_TILE ||
      (uintptr_t)het_part % 16 || (uintptr_t)hom_part % 16 || (uintptr_t)hs_part % 16)
    return (int)cudaErrorInvalidValue;
  fws_genome_kernel<<<dim3((unsigned)(Gp / FG_TILE), (unsigned)S), FG_THREADS, 0, stream>>>(
      (const uint8_t*)codes, G, stride, (const int*)order, (const double*)hs,
      (const int64_t*)bounds, Gp, (int*)het_part, (int*)hom_part, (double*)hs_part);
  return kgt_launch_status();
}
