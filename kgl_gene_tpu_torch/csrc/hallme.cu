// HallME: the EM inbreeding coefficient of every genome, one step a launch.
//
// Replaces no Pallas kernel: the JAX package's HallME
// (kgl_gene_tpu/stats/inbreeding.py) is a while_loop under vmap. It takes
// the place of the port's eager step, stats/inbreeding.py::
// _hall_me_rows_plain, which runs a step as about ten float32 elementwise
// kernels a block of loci, each writing and reading again a temporary of
// every cell.
//
// For genome g over loci l, with codes z (L, G) uint8 (locus-major) and
// p_l the float32 AF, one step is
//
//   term_g = sum over l of [valid] [z_lg in {0, 2}] f_g / (f_g + (1 - f_g) a_lg)
//   new_f  = term_g / n_g where n_g > 0, else 0
//
// a_lg = 1 - p_l (in float32) for code 0 and p_l for code 2; a cell whose
// denominator is 0 adds 0; a code past 2 is not homozygous but counts in
// n_g, the genome's valid loci. Then, as the plain version: prev = f and
// f = new_f and one more step for a running genome; a genome runs while
// |f - prev| > 1e-4 and it has taken fewer than 1,000 steps, from f = 0.25.
// Every term, f, prev and the division by n are float32, each product, sum
// and quotient rounded as the plain version rounds it (no contraction to
// an fma, the IEEE division); the sums over loci are kept wider: a float32
// sum a thread over its rows of a chunk, then float64.
//
// Design: a step is one pass over the codes. A block owns a tile of
// HM_TILE neighbouring genomes and one chunk of loci; its HM_WARPS warps
// take the chunk's rows in turn (warp w rows l0 + w, l0 + w + HM_WARPS,
// ...), a thread HM_VEC neighbouring genomes of a row in one 4-byte load
// where the rows allow it (G a multiple of 4, the tensors 4-byte aligned),
// so a warp reads a 128-byte line a row; the next HM_ROWS rows' loads are
// in flight while the current ones are computed. The chunks of a tile are
// sized so that one step's blocks fit on the card at once (one wave). A
// block adds its warps' sums in warp order and writes per-genome partial
// sums; the last block of a tile to finish (a ticket counter a tile, reset
// by that block) adds the tile's partials in chunk order, so F does not
// depend on the order the blocks ran in, updates the tile's genomes and
// writes how many of them still run. A block whose tile has no running
// genome returns before it reads a code: a stopped genome's update would
// leave it as it is. The first step takes its state from the start values
// and counts each genome's valid loci in the same pass.
//
// Bound on the card (H100 SXM, 700 W): at 2,504 genomes x 25,000 loci a
// step reads 62.6 MB of codes, 18.7 us at 3.35 TB/s. Measured there
// (chip_smoke.py phase 3k): a step 65 us, bound by issue: a cell is its
// byte, its class, the denominator, the IEEE division (a reciprocal, its
// refinement and the check for the slow path), the select and the add,
// and the rate reads ~35 lane instructions a cell. Rows in flight and
// blocks an SM were chosen by timing: 8 rows at 4 blocks spilled and took
// 80 us; 4 rows at up to 128 registers a thread spill nothing.
#include "common.cuh"

constexpr int HM_WARPS = 8;          // warps a block, each a row of the chunk in turn
constexpr int HM_THREADS = 256;      // HM_WARPS warps
constexpr int HM_VEC = 4;            // neighbouring genomes a thread: a 4-byte load a row
constexpr int HM_TILE = 128;         // genomes a tile: a warp's 32 threads of HM_VEC
constexpr int HM_ROWS = 4;           // rows of a warp whose loads are in flight at once
constexpr int HM_MAX_STEPS = 1000;   // a genome's steps at most
constexpr float HM_TOL = 1e-4f;      // a genome runs while |f - prev| is above this
constexpr float HM_START = 0.25f;    // f before the first step
static_assert(HM_THREADS == 32 * HM_WARPS && HM_TILE == 32 * HM_VEC, "a tile a warp's width");
// A row of padding: every code heterozygous (adds nothing), no cell valid.
constexpr unsigned HM_HET = 0x01010101u;

// Whether this block is the last of its tile to finish, as loglik.cu's:
// every thread has written its partials before the call; the ticket goes
// back to 0 for the next launch.
__device__ __forceinline__ bool hallme_last_of_tile(unsigned* __restrict__ tickets) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
    if (s_last) tickets[blockIdx.x] = 0;
  }
  __syncthreads();
  return s_last;
}

// HM_VEC bytes of row l from genome g on, rows G bytes apart: one 4-byte
// load (WIDE), else byte by byte, `pad` for a genome past G.
template <bool WIDE>
__device__ __forceinline__ unsigned load_word(const uint8_t* __restrict__ rows, int64_t l,
                                              int64_t G, int64_t g, unsigned pad) {
  if (WIDE) return g < G ? __ldg((const unsigned*)(rows + l * G + g)) : pad;
  unsigned w = 0;
#pragma unroll
  for (int k = 0; k < HM_VEC; ++k)
    w |= (g + k < G ? (unsigned)__ldg(rows + l * G + g + k) : (pad & 0xFFu)) << (8 * k);
  return w;
}

// The codes, valid bytes and AF of a warp's HM_ROWS rows from row s on
// (rows HM_WARPS apart): rows at or past l1 are padding.
template <int MASK, bool WIDE>
__device__ __forceinline__ void load_rows(const uint8_t* __restrict__ codes,
                                          const uint8_t* __restrict__ valid,
                                          const float* __restrict__ af, int64_t s, int64_t l1,
                                          int64_t G, int64_t g, unsigned (&c)[HM_ROWS],
                                          unsigned (&v)[HM_ROWS], float (&p)[HM_ROWS]) {
#pragma unroll
  for (int r = 0; r < HM_ROWS; ++r) {
    const int64_t l = s + (int64_t)r * HM_WARPS;
    const bool in = l < l1;
    c[r] = in ? load_word<WIDE>(codes, l, G, g, HM_HET) : HM_HET;
    p[r] = in ? __ldg(af + l) : 0.5f;
    if (MASK == 0) v[r] = HM_HET;
    if (MASK == 1) v[r] = in && __ldg(valid + l) ? HM_HET : 0u;
    if (MASK == 2) v[r] = in ? load_word<WIDE>(valid, l, G, g, 0u) : 0u;
  }
}

// One step of every genome of a running tile, block (tile, chunk). codes
// (L, G); af (L,); valid null (MASK 0), (L,) (1) or (L, G) (2), 0 or 1 a
// byte; state (4, Gp) float32: f, prev, n, steps taken, Gp = tiles x
// HM_TILE; partial (chunks, 2, Gp) double scratch (the term's sums, and
// in the first step the valid loci's); tickets (tiles,) 0 on entry and on
// return; running (tiles,) the tile's running genomes after the step;
// skipped, tile passes saved, added to.
template <int MASK, bool WIDE, bool FIRST>
__global__ void __launch_bounds__(HM_THREADS, 2)
hallme_step_kernel(const uint8_t* __restrict__ codes, int64_t G, int64_t L,
                   const float* __restrict__ af, const uint8_t* __restrict__ valid,
                   int64_t chunk_loci, float* __restrict__ state, int64_t Gp,
                   double* __restrict__ partial, unsigned* __restrict__ tickets,
                   int* __restrict__ running, int* __restrict__ skipped) {
  constexpr bool COUNT = FIRST && MASK != 0;  // n from the pass, else L or the state
  __shared__ double s_sum[HM_WARPS][HM_TILE];
  __shared__ int s_count[COUNT ? HM_WARPS : 1][HM_TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t tile0 = (int64_t)blockIdx.x * HM_TILE;
  if (!FIRST && running[blockIdx.x] == 0) {  // every genome of the tile has stopped
    if (blockIdx.y == 0 && tid == 0) atomicAdd(skipped, 1);
    return;
  }
  const int64_t g = tile0 + lane * HM_VEC;  // the thread's first genome
  const int64_t l0 = (int64_t)blockIdx.y * chunk_loci;
  const int64_t l1 = min(L, l0 + chunk_loci);

  float f[HM_VEC], omf[HM_VEC], acc[HM_VEC];
  int count[HM_VEC];
  if (!FIRST) {
    const float4 v = *(const float4*)(state + g);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < HM_VEC; ++k) {
    if (FIRST) f[k] = HM_START;
    omf[k] = __fsub_rn(1.0f, f[k]);
    acc[k] = 0.0f;
    count[k] = 0;
  }

  constexpr int64_t SPAN = (int64_t)HM_WARPS * HM_ROWS;
  unsigned next_c[HM_ROWS], next_v[HM_ROWS];
  float next_p[HM_ROWS];
  const int64_t first = l0 + warp;
  if (first < l1)
    load_rows<MASK, WIDE>(codes, valid, af, first, l1, G, g, next_c, next_v, next_p);
  for (int64_t s = first; s < l1; s += SPAN) {
    unsigned c[HM_ROWS], v[HM_ROWS];
    float p[HM_ROWS];
#pragma unroll
    for (int r = 0; r < HM_ROWS; ++r) {
      c[r] = next_c[r];
      v[r] = next_v[r];
      p[r] = next_p[r];
    }
    if (s + SPAN < l1)
      load_rows<MASK, WIDE>(codes, valid, af, s + SPAN, l1, G, g, next_c, next_v, next_p);
#pragma unroll
    for (int r = 0; r < HM_ROWS; ++r) {
      const float q = __fsub_rn(1.0f, p[r]);
#pragma unroll
      for (int k = 0; k < HM_VEC; ++k) {
        const unsigned code = (c[r] >> (8 * k)) & 0xFFu;
        const bool ok = (v[r] >> (8 * k)) & 1u;
        const float a = code == 0 ? q : p[r];
        const float den = __fadd_rn(f[k], __fmul_rn(omf[k], a));
        const float t = __fdiv_rn(f[k], den);
        const bool hom = (code & ~2u) == 0 && ok && den != 0.0f;
        acc[k] = __fadd_rn(acc[k], hom ? t : 0.0f);
        if (COUNT) count[k] += ok;
      }
    }
  }

  // The block's sums: each genome's warps in warp order, in float64.
#pragma unroll
  for (int k = 0; k < HM_VEC; ++k) {
    s_sum[warp][lane * HM_VEC + k] = acc[k];
    if (COUNT) s_count[warp][lane * HM_VEC + k] = count[k];
  }
  __syncthreads();
  double* own = partial + (int64_t)blockIdx.y * 2 * Gp + tile0;
  if (tid < HM_TILE) {
    double sum = 0.0;
    int n = 0;
#pragma unroll
    for (int w = 0; w < HM_WARPS; ++w) {
      sum += s_sum[w][tid];
      if (COUNT) n += s_count[w][tid];
    }
    own[tid] = sum;
    if (COUNT) own[Gp + tid] = (double)n;
  }
  if (!hallme_last_of_tile(tickets)) return;

  // The tile's last block: each genome's term over the chunks in their
  // order, then the update of a running genome.
  bool runs = false;
  const int64_t gt = tile0 + tid;
  if (FIRST && tid < HM_TILE && gt >= G) {  // a pad genome: start values, never running
    state[gt] = HM_START;
    state[Gp + gt] = 1.0f;
    state[2 * Gp + gt] = 0.0f;
    state[3 * Gp + gt] = 0.0f;
  }
  if (tid < HM_TILE && gt < G) {
    double sum = 0.0, n_sum = 0.0;
#pragma unroll 4
    for (unsigned ch = 0; ch < gridDim.y; ++ch) {
      sum += __ldcg(partial + (int64_t)ch * 2 * Gp + gt);
      if (COUNT) n_sum += __ldcg(partial + ((int64_t)ch * 2 + 1) * Gp + gt);
    }
    const float n = FIRST ? (COUNT ? (float)n_sum : (float)L) : state[2 * Gp + gt];
    const float new_f = n > 0.0f ? __fdiv_rn((float)sum, n) : 0.0f;
    float f_g = FIRST ? HM_START : state[gt], prev = FIRST ? 1.0f : state[Gp + gt];
    float steps = FIRST ? 0.0f : state[3 * Gp + gt];
    if (FIRST || (fabsf(__fsub_rn(f_g, prev)) > HM_TOL && steps < HM_MAX_STEPS)) {
      prev = f_g;
      f_g = new_f;
      steps += 1.0f;
    }
    state[gt] = f_g;
    state[Gp + gt] = prev;
    state[3 * Gp + gt] = steps;
    if (FIRST) state[2 * Gp + gt] = n;
    runs = fabsf(__fsub_rn(f_g, prev)) > HM_TOL && steps < HM_MAX_STEPS;
  }
  const int tile_running = __syncthreads_count(runs);
  if (tid == 0) running[blockIdx.x] = tile_running;
}

template <int MASK, bool WIDE>
static const void* step_kernel(bool first) {
  return first ? (const void*)hallme_step_kernel<MASK, WIDE, true>
               : (const void*)hallme_step_kernel<MASK, WIDE, false>;
}

static const void* pick(int64_t mask, bool wide, bool first) {
  switch (mask * 2 + (wide ? 1 : 0)) {
    case 0: return step_kernel<0, false>(first);
    case 1: return step_kernel<0, true>(first);
    case 2: return step_kernel<1, false>(first);
    case 3: return step_kernel<1, true>(first);
    case 4: return step_kernel<2, false>(first);
    default: return step_kernel<2, true>(first);
  }
}

// One HallME step of every running genome (the first from the start
// values when `first`). codes (L, G) uint8; af (L,) float32; valid null
// (mask 0), (L,) per locus (mask 1) or (L, G) per genome (mask 2), 0 or 1
// a byte; wide: 4-byte loads of the rows (G a multiple of 4, codes and
// valid 4-byte aligned); state (4, Gp) float32 with Gp = tiles x 128, 16-byte
// aligned; partial (chunks, 2, Gp) double scratch; tickets (tiles,)
// unsigned, 0 on entry and on return; running (tiles,) int out; skipped
// (1,) int, added to. A block for each tile of 128 genomes and chunk of
// chunk_loci loci.
KGT_API int kgt_hallme_step(const void* codes, int64_t G, int64_t L, const void* af,
                            const void* valid, int64_t mask, int64_t wide, int64_t chunk_loci,
                            int64_t first, void* state, void* partial, void* tickets,
                            void* running, void* skipped, cudaStream_t stream) {
  if (G < 1 || L < 0 || chunk_loci < 1 || mask < 0 || mask > 2 || (mask > 0 && valid == nullptr))
    return (int)cudaErrorInvalidValue;
  if (wide && (G % HM_VEC || (uintptr_t)codes % 4 || (mask == 2 && (uintptr_t)valid % 4)))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (G + HM_TILE - 1) / HM_TILE;
  const int64_t chunks = L > 0 ? (L + chunk_loci - 1) / chunk_loci : 1;
  if (tiles > INT32_MAX || chunks > 65535 || (uintptr_t)state % 16)
    return (int)cudaErrorInvalidValue;
  const int64_t Gp = tiles * HM_TILE;
  const uint8_t* v = mask > 0 ? (const uint8_t*)valid : nullptr;
  void* args[] = {(void*)&codes, &G, &L, (void*)&af, (void*)&v, &chunk_loci, &state,
                  (void*)&Gp, &partial, &tickets, &running, &skipped};
  const cudaError_t rc = cudaLaunchKernel(pick(mask, wide != 0, first != 0),
                                          dim3((unsigned)tiles, (unsigned)chunks), dim3(HM_THREADS),
                                          args, 0, stream);
  if (rc != cudaSuccess) return (int)rc;
  return kgt_launch_status();
}

// Blocks an SM of the current device holds at once of a step after the
// first for this mask and load width (0 when it cannot launch); no launch.
KGT_API int kgt_hallme_blocks(int64_t mask, int64_t wide) {
  if (mask < 0 || mask > 2) return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pick(mask, wide != 0, false),
                                                    HM_THREADS, 0) != cudaSuccess)
    return 0;
  return blocks;
}
