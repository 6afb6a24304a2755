// Loglikelihood: the maximum-likelihood inbreeding coefficient of every genome.
//
// Replaces no Pallas kernel: the JAX package's objective, _loglik_row
// (kgl_gene_tpu/stats/inbreeding.py:128), is XLA under vmap. It takes the
// place of the eager float64 evaluations of the port's plain version,
// stats/inbreeding.py::_loglik_rows_plain, which runs the same search as
// about 14 elementwise kernels a block of loci and f point, each writing
// and reading again a float64 temporary of every cell.
//
// For genome g over loci l, with codes z (L, G) uint8 (locus-major), p_l
// the float32 AF promoted to float64 and q_l = 1 - p_l, the objective is
//
//   ll_g(f) = sum over l of log(clamp(prob(f, z_lg, p_l), 1e-10, 1))
//
// prob = f a + (1 - f) a^2 for a homozygous code (a = q for code 0, p for
// code 2), 2 (1 - f) p q for code 1 and 2 (1 - f) p^2 for any other code.
// Each is written fma(f, D, S) with per-locus terms of the class (hom:
// S = a^2, D = a - a^2; het: S = 2pq, D = -S); a cell masked out is class
// 4 (D = 0, S = 1: probability 1, log 0). The search: the 65-point grid
// linspace(-1, 1, 65), its first best point k, then 40 golden-section
// steps on [grid[k] - 0.04, grid[k] + 0.04] clamped to [-1, 1], each
// keeping [a, hi] where ll(a) < ll(b), else [lo, b]; F is the midpoint of
// the last bracket, in float32. Every probability, log, product and sum is
// float64.
//
// Design: 41 passes over the codes, one launch each; a block owns a tile
// of LL_THREADS neighbouring genomes (a thread a genome, so a warp reads 32
// neighbouring bytes of one locus row) and one chunk of loci, and the
// chunks of a tile are sized so that all blocks fit on the card at once.
//   - kgt_loglik_grid: the grid's log-probabilities depend on the locus,
//     the class and the point only. A first kernel tabulates them once a
//     call (L x 4 classes x 65 points, a log each) beside the per-locus
//     (D, S) of every class; the pass then stages its loci's rows in
//     shared memory, LL_TABLE_LOCI loci at a time, and each genome adds
//     the entries its code selects, no log per cell. A third of the points
//     a block keeps a thread's sums to 44 registers, two blocks an SM.
//   - kgt_loglik_step: one golden-section step. Both points of a genome
//     are evaluated in the pass, a cell's two probabilities each an fma;
//     LL_GROUP of them are multiplied before one log (each factor >= 1e-10,
//     so a product stays >= 1e-160, far above float64's least normal). The
//     clamp is the identity on a factor in [2^-32, 1), which one integer
//     test of its high word shows; a group with any factor outside is
//     multiplied again with the clamps, so the result is the clamped one.
//     Each group's codes are loaded while the group before is computed.
//   Each block writes its per-genome partial sums; the last block of a
//   tile to finish (a ticket counter a tile, reset by that block) adds the
//   tile's partials in chunk order, so the sums do not depend on the order
//   the blocks ran in, and updates the bracket: the grid pass takes the
//   argmax and sets the first bracket, each step moves it, the last writes F.
//
// Bound on the card (H100 SXM, 700 W): at 2,504 genomes x 25,000 loci the
// codes are 62.6 MB, 41 passes 2.57 GB, 0.77 ms at 3.35 TB/s; the float64
// arithmetic is an add a cell and point in the grid and an fma and a
// multiply a cell and point in the steps, 225 instructions a cell, 0.84 ms
// at 64 lanes an SM a cycle. Measured there (chip_smoke.py phase 3j): the
// grid pass ~1.45 ms, bound by its shared-memory loads (a 16-byte load of
// 32 lanes takes four cycles whatever the addresses), a step ~0.10 ms, bound
// by the latency of each group's loads, products and log at 16 warps an SM.
#include "common.cuh"

constexpr int LL_THREADS = 256;       // genomes a block: a tile
constexpr int LL_POINTS = 65;         // the grid's points
constexpr int LL_POINT_GROUPS = 3;    // grid blocks a tile and chunk, a third of the points each
constexpr int LL_GROUP_PAIRS = 11;    // a grid block's points in pairs (16-byte loads)
constexpr int LL_CLASSES = 5;         // codes 0, 1, 2, any other code, masked out
constexpr int LL_TABLE_LOCI = 16;     // loci whose log table a grid block stages at a time
constexpr int LL_GROUP = 16;          // probabilities a step multiplies before one log
constexpr double LL_SMALL = 1e-10;    // the probabilities' clamp
constexpr double LL_HALF_WIDTH = 0.04;
constexpr double LL_GOLDEN = 0.618033988749895;
// High words of 2^-32 and of 1.0: a double whose high word lies in
// [LL_SAFE_LOW, LL_SAFE_LOW + LL_SAFE_SPAN) lies in [2^-32, 1), where the
// clamp to [1e-10, 1] leaves it as it is.
constexpr unsigned LL_SAFE_LOW = 0x3DF00000u, LL_SAFE_SPAN = 0x3FF00000u - LL_SAFE_LOW;
static_assert((LL_SAFE_SPAN & (LL_SAFE_SPAN - 1)) == 0, "an OR of in-range offsets stays in range");
constexpr int LL_GROUP_POINTS = 2 * LL_GROUP_PAIRS;
constexpr int LL_TABLE_POINTS = LL_POINT_GROUPS * LL_GROUP_POINTS;  // a table row, padded
static_assert(LL_POINT_GROUPS * LL_GROUP_POINTS >= LL_POINTS, "every point in a group");

// The grid's point k: linspace(-1, 1, 65) is -1 + k / 32, every point exact.
__device__ __forceinline__ double grid_point(int k) {
  return -1.0 + k * (2.0 / (LL_POINTS - 1));
}

// (D, S) of class c at AF p: the probability at f is fma(f, D, S).
__device__ __forceinline__ double2 class_terms(double p, int c) {
  const double q = 1.0 - p;
  double s;
  switch (c) {
    case 0: s = q * q; return make_double2(q - s, s);
    case 1: s = 2.0 * p * q; return make_double2(-s, s);
    case 2: s = p * p; return make_double2(p - s, s);
    case 3: s = 2.0 * p * p; return make_double2(-s, s);
    default: return make_double2(0.0, 1.0);
  }
}

__device__ __forceinline__ double clamped(double f, double2 t) {
  return fmin(fmax(fma(f, t.x, t.y), LL_SMALL), 1.0);
}

// Below LL_SAFE_SPAN where x lies in [2^-32, 1), else at or above it: ORed
// over a group's factors, it says whether the clamp may have moved any.
__device__ __forceinline__ unsigned outside_safe(double x) {
  return (unsigned)__double2hiint(x) - LL_SAFE_LOW;
}

// The class of a cell from its code (any code past 2 is class 3) and, with
// a per-genome mask, its valid byte (class 4 where it is left out).
template <bool PER_GENOME>
__device__ __forceinline__ int cell_class(unsigned code, unsigned valid) {
  const int c = min(code, 3u);
  return PER_GENOME && !valid ? 4 : c;
}

// Whether this block is the last of its tile to finish: every thread has
// written its partials before the call. The ticket goes back to 0 for the
// next launch.
__device__ __forceinline__ bool last_of_tile(unsigned* __restrict__ tickets) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y * gridDim.z - 1;
    if (s_last) tickets[blockIdx.x] = 0;
  }
  __syncthreads();
  return s_last;
}

// The call's per-locus tables, an entry a thread: terms (L, 5), each
// class's (D, S); logs (L, 4, LL_TABLE_POINTS), the log of each class's
// clamped probability at each grid point (0 past the last point and at a
// locus a per-locus mask leaves out, whose classes all read as class 4).
template <bool PER_LOCUS>
__global__ void __launch_bounds__(LL_THREADS)
loglik_table_kernel(int64_t L, const float* __restrict__ af,
                    const uint8_t* __restrict__ locus_valid, double2* __restrict__ terms,
                    double* __restrict__ logs) {
  const int64_t e = (int64_t)blockIdx.x * LL_THREADS + threadIdx.x;
  if (e >= L * 4 * LL_TABLE_POINTS) return;
  const int64_t l = e / (4 * LL_TABLE_POINTS);
  const int c = (int)(e / LL_TABLE_POINTS % 4), k = (int)(e % LL_TABLE_POINTS);
  const bool on = !PER_LOCUS || locus_valid[l];
  const double p = (double)af[l];
  const double2 t = class_terms(p, on ? c : 4);
  logs[e] = on && k < LL_POINTS ? log(clamped(grid_point(k), t)) : 0.0;
  if (k == 0) terms[l * LL_CLASSES + c] = t;
  if (k == 0 && c == 3) terms[l * LL_CLASSES + 4] = class_terms(p, 4);
}

// The grid pass: block (tile, chunk, z) adds, for its tile's genomes over
// its chunk of loci, the log-probabilities of points 22 z .. 22 z + 21
// (a third of the grid, so that a thread's sums fit two blocks an SM).
template <bool PER_GENOME>
__global__ void __launch_bounds__(LL_THREADS, 2)
loglik_grid_kernel(const uint8_t* __restrict__ codes, int64_t G, int64_t L,
                   const uint8_t* __restrict__ valid, int64_t chunk_loci,
                   const double2* __restrict__ logs, double* __restrict__ partial,
                   unsigned* __restrict__ tickets, double* __restrict__ lo,
                   double* __restrict__ hi) {
  // the block's points of the staged loci's logs, class 4 all zeros
  __shared__ double2 s_tab[LL_TABLE_LOCI][LL_CLASSES][LL_GROUP_PAIRS];
  const int tid = threadIdx.x, k0 = blockIdx.z * LL_GROUP_POINTS;
  const int64_t g = (int64_t)blockIdx.x * LL_THREADS + tid;
  const bool live = g < G;
  const int64_t l0 = (int64_t)blockIdx.y * chunk_loci;
  const int64_t l1 = min(L, l0 + chunk_loci);

  for (int e = tid; e < LL_TABLE_LOCI * LL_GROUP_PAIRS; e += LL_THREADS)
    s_tab[e / LL_GROUP_PAIRS][4][e % LL_GROUP_PAIRS] = make_double2(0.0, 0.0);
  double acc[LL_GROUP_POINTS];
#pragma unroll
  for (int k = 0; k < LL_GROUP_POINTS; ++k) acc[k] = 0.0;

  for (int64_t s = l0; s < l1; s += LL_TABLE_LOCI) {
    const int n = (int)min((int64_t)LL_TABLE_LOCI, l1 - s);
    int cls[LL_TABLE_LOCI];  // loaded ahead of the table, class 4 past the chunk
#pragma unroll
    for (int li = 0; li < LL_TABLE_LOCI; ++li) {
      const int64_t at = (s + li) * G + g;
      cls[li] = live && li < n
                    ? cell_class<PER_GENOME>(__ldg(codes + at), PER_GENOME ? __ldg(valid + at) : 1)
                    : 4;
    }
    __syncthreads();  // the last loci's table has been read
    for (int e = tid; e < LL_TABLE_LOCI * 4 * LL_GROUP_PAIRS; e += LL_THREADS) {
      const int li = e / (4 * LL_GROUP_PAIRS), c = (e / LL_GROUP_PAIRS) % 4;
      const int k = e % LL_GROUP_PAIRS;
      s_tab[li][c][k] = li < n ? __ldg(logs + ((s + li) * 4 + c) * (LL_TABLE_POINTS / 2) +
                                       k0 / 2 + k)
                               : make_double2(0.0, 0.0);
    }
    __syncthreads();
#pragma unroll
    for (int li = 0; li < LL_TABLE_LOCI; ++li) {
      if (li >= n) break;  // n is the block's own: no divergence
      const double2* t = s_tab[li][cls[li]];
#pragma unroll
      for (int k = 0; k < LL_GROUP_PAIRS; ++k) {
        const double2 v = t[k];
        acc[2 * k] += v.x;
        acc[2 * k + 1] += v.y;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < LL_GROUP_POINTS; ++k)
      if (k0 + k < LL_POINTS) partial[((int64_t)blockIdx.y * LL_POINTS + k0 + k) * G + g] = acc[k];
  }
  if (!last_of_tile(tickets) || !live) return;
  // The tile's last block: each point's sum over the chunks in their
  // order, the first best point, the first bracket.
  double best = 0.0;
  int kb = 0;
  for (int k = 0; k < LL_POINTS; ++k) {
    double v = 0.0;
#pragma unroll 4
    for (unsigned c = 0; c < gridDim.y; ++c)
      v += __ldcg(partial + ((int64_t)c * LL_POINTS + k) * G + g);
    if (k == 0 || v > best) {
      best = v;
      kb = k;
    }
  }
  lo[g] = fmin(fmax(grid_point(kb) - LL_HALF_WIDTH, -1.0), 1.0);
  hi[g] = fmin(fmax(grid_point(kb) + LL_HALF_WIDTH, -1.0), 1.0);
}

// The codes of LL_GROUP loci of one genome from the row at `at`, rows G
// bytes apart, and with a per-genome mask their valid bytes.
template <bool PER_GENOME>
__device__ __forceinline__ void load_group(const uint8_t* __restrict__ codes,
                                           const uint8_t* __restrict__ valid, int64_t at,
                                           int64_t G, unsigned (&c)[LL_GROUP],
                                           unsigned (&v)[LL_GROUP]) {
#pragma unroll
  for (int i = 0; i < LL_GROUP; ++i) {
    c[i] = __ldg(codes + at + i * G);
    v[i] = PER_GENOME ? __ldg(valid + at + i * G) : 1;
  }
}

template <bool PER_GENOME>
__global__ void __launch_bounds__(LL_THREADS, 2)
loglik_step_kernel(const uint8_t* __restrict__ codes, int64_t G, int64_t L,
                   const uint8_t* __restrict__ valid, int64_t chunk_loci,
                   const double2* __restrict__ terms, double* __restrict__ partial,
                   unsigned* __restrict__ tickets, double* __restrict__ lo,
                   double* __restrict__ hi, float* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * LL_THREADS + threadIdx.x;
  const bool live = g < G;
  const int64_t l0 = (int64_t)blockIdx.y * chunk_loci;
  const int64_t l1 = min(L, l0 + chunk_loci);
  double a = 0.0, b = 0.0, sa = 0.0, sb = 0.0;
  if (live) {
    // the step's two points, rounded as the plain version rounds them
    const double x = lo[g], y = hi[g], w = __dmul_rn(LL_GOLDEN, __dsub_rn(y, x));
    a = __dsub_rn(y, w);
    b = __dadd_rn(x, w);
    const int64_t full = l0 + (l1 - l0) / LL_GROUP * LL_GROUP;
    // whole groups, each group's codes loaded while the one before is computed
    unsigned next_c[LL_GROUP], next_v[LL_GROUP];
    if (l0 < full) load_group<PER_GENOME>(codes, valid, l0 * G + g, G, next_c, next_v);
    for (int64_t s = l0; s < full; s += LL_GROUP) {
      unsigned c[LL_GROUP], v[LL_GROUP];
#pragma unroll
      for (int i = 0; i < LL_GROUP; ++i) {
        c[i] = next_c[i];
        v[i] = next_v[i];
      }
      if (s + LL_GROUP < full)
        load_group<PER_GENOME>(codes, valid, (s + LL_GROUP) * G + g, G, next_c, next_v);
      const double2* tp = terms + s * LL_CLASSES;
      // The factors unclamped, and whether any left [2^-32, 1); only then
      // the group again with the clamps, which leave the rest unchanged.
      double pa = 1.0, pb = 1.0;
      unsigned off = 0;
#pragma unroll
      for (int i = 0; i < LL_GROUP; ++i) {
        const double2 t = __ldg(tp + i * LL_CLASSES + cell_class<PER_GENOME>(c[i], v[i]));
        const double xa = fma(a, t.x, t.y), xb = fma(b, t.x, t.y);
        off |= outside_safe(xa) | outside_safe(xb);
        pa *= xa;
        pb *= xb;
      }
      if (off >= LL_SAFE_SPAN) {
        pa = pb = 1.0;
#pragma unroll
        for (int i = 0; i < LL_GROUP; ++i) {
          const double2 t = __ldg(tp + i * LL_CLASSES + cell_class<PER_GENOME>(c[i], v[i]));
          pa *= clamped(a, t);
          pb *= clamped(b, t);
        }
      }
      sa += log(pa);
      sb += log(pb);
    }
    if (full < l1) {  // the chunk's last, partial group
      double pa = 1.0, pb = 1.0;
      for (int64_t l = full; l < l1; ++l) {
        const int64_t at = l * G + g;
        const int c = cell_class<PER_GENOME>(__ldg(codes + at), PER_GENOME ? __ldg(valid + at) : 1);
        const double2 t = __ldg(terms + l * LL_CLASSES + c);
        pa *= clamped(a, t);
        pb *= clamped(b, t);
      }
      sa += log(pa);
      sb += log(pb);
    }
    partial[(int64_t)blockIdx.y * 2 * G + g] = sa;
    partial[((int64_t)blockIdx.y * 2 + 1) * G + g] = sb;
  }
  if (!last_of_tile(tickets) || !live) return;
  double la = 0.0, lb = 0.0;
#pragma unroll 4
  for (unsigned c = 0; c < gridDim.y; ++c) {
    la += __ldcg(partial + (int64_t)c * 2 * G + g);
    lb += __ldcg(partial + ((int64_t)c * 2 + 1) * G + g);
  }
  const bool b_better = la < lb;
  const double x = b_better ? a : lo[g], y = b_better ? hi[g] : b;
  lo[g] = x;
  hi[g] = y;
  if (out != nullptr) out[g] = (float)(__dadd_rn(x, y) / 2.0);
}

static int grid_dims(int64_t G, int64_t L, int64_t chunk_loci, int groups, dim3* grid) {
  if (G < 1 || L < 0 || chunk_loci < 1) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (G + LL_THREADS - 1) / LL_THREADS;
  const int64_t chunks = L > 0 ? (L + chunk_loci - 1) / chunk_loci : 1;
  if (tiles > INT32_MAX || chunks > 65535) return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)tiles, (unsigned)chunks, groups);
  return 0;
}

// The 65-point grid over every genome, and the first bracket: two
// kernels, the tables, then the pass. codes (L, G) uint8; af (L,) float32;
// valid null (every cell), (L,) per locus (mask 1) or (L, G) per genome
// (mask 2), 0 or 1 a byte; terms (L, 5) double2 and logs (L, 4, 66)
// double, out; partial (chunks, 65, G) double scratch; tickets (tiles,)
// unsigned, 0 on entry and on return; lo, hi (G,) double out. A block for
// each tile of LL_THREADS genomes, chunk of chunk_loci loci and third of
// the points.
KGT_API int kgt_loglik_grid(const void* codes, int64_t G, int64_t L, const void* af,
                            const void* valid, int64_t mask, int64_t chunk_loci, void* terms,
                            void* logs, void* partial, void* tickets, void* lo, void* hi,
                            cudaStream_t stream) {
  dim3 grid;
  if (const int rc = grid_dims(G, L, chunk_loci, LL_POINT_GROUPS, &grid)) return rc;
  if (mask < 0 || mask > 2 || (mask > 0 && valid == nullptr)) return (int)cudaErrorInvalidValue;
  const int64_t entries = L * 4 * LL_TABLE_POINTS;
  if (entries > 0) {
    auto table = mask == 1 ? loglik_table_kernel<true> : loglik_table_kernel<false>;
    table<<<(unsigned)((entries + LL_THREADS - 1) / LL_THREADS), LL_THREADS, 0, stream>>>(
        L, (const float*)af, (const uint8_t*)valid, (double2*)terms, (double*)logs);
    if (const int rc = kgt_launch_status()) return rc;
  }
  auto kernel = mask == 2 ? loglik_grid_kernel<true> : loglik_grid_kernel<false>;
  kernel<<<grid, LL_THREADS, 0, stream>>>(
      (const uint8_t*)codes, G, L, mask == 2 ? (const uint8_t*)valid : nullptr, chunk_loci,
      (const double2*)logs, (double*)partial, (unsigned*)tickets, (double*)lo, (double*)hi);
  return kgt_launch_status();
}

// One golden-section step from the bracket in lo, hi, moved in place; out
// (G,) float32 gets F when not null (the last step). partial (chunks, 2, G)
// double scratch; the other arguments as kgt_loglik_grid's.
KGT_API int kgt_loglik_step(const void* codes, int64_t G, int64_t L, const void* valid,
                            int64_t mask, int64_t chunk_loci, const void* terms, void* partial,
                            void* tickets, void* lo, void* hi, void* out, cudaStream_t stream) {
  dim3 grid;
  if (const int rc = grid_dims(G, L, chunk_loci, 1, &grid)) return rc;
  if (mask < 0 || mask > 2 || (mask > 0 && valid == nullptr)) return (int)cudaErrorInvalidValue;
  auto kernel = mask == 2 ? loglik_step_kernel<true> : loglik_step_kernel<false>;
  kernel<<<grid, LL_THREADS, 0, stream>>>(
      (const uint8_t*)codes, G, L, mask == 2 ? (const uint8_t*)valid : nullptr, chunk_loci,
      (const double2*)terms, (double*)partial, (unsigned*)tickets, (double*)lo, (double*)hi,
      (float*)out);
  return kgt_launch_status();
}

// Blocks an SM of the current device holds at once of the grid pass (kind
// 0) or a step (kind 1) for this mask (0 when it cannot launch); no launch.
KGT_API int kgt_loglik_blocks(int64_t kind, int64_t mask) {
  const bool per_genome = mask == 2;
  const void* kernel =
      kind == 0 ? (per_genome ? (const void*)loglik_grid_kernel<true> : (const void*)loglik_grid_kernel<false>)
                : (per_genome ? (const void*)loglik_step_kernel<true> : (const void*)loglik_step_kernel<false>);
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, LL_THREADS, 0) != cudaSuccess)
    return 0;
  return blocks;
}
