// MICA: the all-pairs max-min over matching ancestor ids.
//
// Replaces the device tile functions of the ontology similarity path,
// _mica_tile and _mica_tile_chunked (kgl_gene_tpu/ops/similarity.py:67,77;
// XLA jit with a fori_loop over 64 x 64 chunks of the ancestor cross
// product, not Pallas), and the host loop of 128-term tiles around them
// (:116-126). For term rows of ancestor ids with their ICs:
//
//   out[i, j] = max(0, max over (p, q) with ids_i[p] == ids_j[q] of
//                      min(ic_i[p], ic_j[q]))
//
// over every ancestor of both rows (the reference's chunked form drops the
// columns past (K / 64) * 64). The result is a selection of input values,
// so it equals the plain version bit for bit.
//
// Bound on the card: issue. The least work is a merge of the two sorted
// rows, which ends with the row whose last id m is smaller: #ids_i <= m +
// #ids_j <= m - |common| steps a pair, a match moving both. Against it,
// the rows are read once and n * n * 4 bytes written once. At 8,192 terms
// of 36 ancestors that is 2.0e9 steps, ~0.36 ms at six instructions a
// step at the rate an SM dispatches instructions (128 lanes a cycle; the
// step's loads, compares, selects and float min and max go to several
// pipes), against 0.09 ms of bytes.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3f, 8,192
// terms, K = 256): 2.69 ms, 7.4x that floor, with 1.21 lane slots a merge
// step. A first design, a block per 16 x 16 tile on padded (rows, K)
// lists with shared memory sized by K, took 9.1 ms on the same sorted rows
// (PERF.md, the kernel table).
//
// Design (kgt_mica). The input is compact rows: CSR offsets and the
// entries (id, IC) of each row packed end to end in ascending id order,
// built once a call by the wrapper (ops/similarity.py), so nothing reads
// a pad. One launch covers the matrix: a block of 256 threads per T x T
// tile of output pairs (T = 64 unless a tile's rows do not fit), only the
// upper triangle of tiles with one row set, each off-diagonal tile also
// written mirrored. The block copies the T + T rows into shared memory,
// a warp a row, coalesced, each row followed by two sentinels (id -1):
// its shared memory is sized by the largest two tiles' real entries, which
// the wrapper passes, so occupancy follows the real lengths and not K.
// Then it ranks each side's T rows by length (a local order; the output
// keeps its own), and each warp runs rounds of 8 x 4 neighbouring pairs of
// that order, a pair a lane, so the lanes of a round merge rows of about
// the same length; at T = 64 a warp holds its 8 rows i for 16 rounds. The
// merge keeps both heads in registers and loads only the row that
// advanced, with no branch in the step; two steps a loop trip, the
// sentinels ending it with one test of the two heads. Results go to a T x
// (T + 1) shared tile, stored coalesced once the block is done.
#include "common.cuh"

#include <climits>

constexpr size_t SMEM_LIMIT = 227 * 1024;  // an H100 block's opt-in shared memory
constexpr int MICA_THREADS = 256;
constexpr int SUB_I = 8, SUB_J = 4;  // a warp's round: 8 rows i x 4 rows j, a pair a lane

// max(0, max-min over the common ids) of the rows at s + pa and s + pb,
// each ending in two sentinels. A trip starts with both heads real, so its
// two steps read at most the second sentinel of either row.
__device__ __forceinline__ float merge_rows(const int2* __restrict__ s, int pa, int pb) {
  const int2* a = s + pa;
  const int2* b = s + pb;
  int2 x = *a, y = *b;
  float best = 0.0f;
  while ((x.x | y.x) >= 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool le = x.x <= y.x, ge = y.x <= x.x;
      if (x.x == y.x) best = fmaxf(best, fminf(__int_as_float(x.y), __int_as_float(y.y)));
      a += le;
      b += ge;
      if (le) x = *a;
      if (ge) y = *b;
    }
  }
  return best;
}

__global__ void __launch_bounds__(MICA_THREADS)
mica_rows_kernel(const int32_t* __restrict__ ptr_i, const int32_t* __restrict__ ids_i,
                 const float* __restrict__ ic_i, int ni, const int32_t* __restrict__ ptr_j,
                 const int32_t* __restrict__ ids_j, const float* __restrict__ ic_j, int nj,
                 int T, int log_t, int entries, float* __restrict__ out, int symmetric) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (symmetric && bi > bj) return;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* s_ent = (int2*)smem;  // the empty row, then the i rows, then the j rows
  int* s_start = (int*)(s_ent + entries + 4 * T + 2);  // 2T: T rows i, then T rows j
  int* s_len = s_start + 2 * T;
  int* s_ord = s_len + 2 * T;  // each side's rows by (length, row)
  float* s_out = (float*)(s_ord + 2 * T);  // T x (T + 1)
  const int i0 = bi * T, j0 = bj * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span_i = ptr_i[min(i0 + T, ni)] - ptr_i[i0];
  const int span_j = ptr_j[min(j0 + T, nj)] - ptr_j[j0];
  if (span_i + span_j > entries) __trap();  // the wrapper sized the launch wrong

  // Where each row lands: 2 entries of the empty row, the i rows, the j
  // rows, two sentinels after each. A row past the set reads the empty row.
  for (int r = tid; r < 2 * T; r += MICA_THREADS) {
    const bool side_j = r >= T;
    const int k = side_j ? r - T : r;
    const int first = side_j ? j0 : i0;
    const int32_t* ptr = side_j ? ptr_j : ptr_i;
    int start = 0, len = 0;
    if (first + k < (side_j ? nj : ni)) {
      start = 2 + (side_j ? span_i + 2 * T : 0) + ptr[first + k] - ptr[first] + 2 * k;
      len = ptr[first + k + 1] - ptr[first + k];
    }
    s_start[r] = start;
    s_len[r] = len;
  }
  if (tid < 2) s_ent[tid] = make_int2(-1, 0);
  __syncthreads();
  for (int r = warp; r < 2 * T; r += MICA_THREADS / 32) {  // a warp a row
    const int dst = s_start[r];
    if (dst == 0) continue;
    const bool side_j = r >= T;
    const int len = s_len[r];
    const int src = (side_j ? ptr_j[j0 + r - T] : ptr_i[i0 + r]);
    const int32_t* ids = side_j ? ids_j : ids_i;
    const float* ic = side_j ? ic_j : ic_i;
    for (int e = lane; e < len + 2; e += 32)
      s_ent[dst + e] = e < len ? make_int2(__ldg(ids + src + e), __float_as_int(__ldg(ic + src + e)))
                               : make_int2(-1, 0);
  }
  for (int r = tid; r < 2 * T; r += MICA_THREADS) {
    const int side = r >= T ? T : 0, k = r - side, len = s_len[r];
    int rank = 0;
    for (int q = 0; q < T; ++q) {
      const int lq = s_len[side + q];
      rank += lq < len || (lq == len && q < k);
    }
    s_ord[side + rank] = k;
  }
  __syncthreads();

  // Rounds of SI x SJ pairs of the local order, a pair a lane; the
  // sub-blocks are dealt to the warps in contiguous runs.
  const int SI = min(SUB_I, T), SJ = min(SUB_J, T);
  const int log_nsj = log_t - (SJ == SUB_J ? 2 : log_t);  // T / SJ sub-blocks a row of them
  const int nsb = (T / SI) << log_nsj;
  const int per = (nsb + MICA_THREADS / 32 - 1) / (MICA_THREADS / 32);
  const int li = lane % SUB_I, lj = lane / SUB_I;
  const bool on = li < SI && lj < SJ;
  for (int sb = warp * per; sb < min(nsb, (warp + 1) * per); ++sb) {
    const int ri = on ? s_ord[(sb >> log_nsj) * SI + li] : 0;
    const int rj = on ? s_ord[T + (sb & ((1 << log_nsj) - 1)) * SJ + lj] : 0;
    const float best = merge_rows(s_ent, on ? s_start[ri] : 0, on ? s_start[T + rj] : 0);
    if (on) s_out[ri * (T + 1) + rj] = best;
  }
  __syncthreads();
  for (int e = tid; e < T * T; e += MICA_THREADS) {
    const int r = e >> log_t, c = e & (T - 1);
    if (i0 + r < ni && j0 + c < nj) out[(int64_t)(i0 + r) * nj + j0 + c] = s_out[r * (T + 1) + c];
    if (symmetric && bi != bj && j0 + r < nj && i0 + c < ni)
      out[(int64_t)(j0 + r) * nj + i0 + c] = s_out[c * (T + 1) + r];
  }
}

static size_t rows_smem_bytes(int T, int entries) {
  return 8 * ((size_t)entries + 4 * T + 2) + 24 * (size_t)T + 4 * (size_t)T * (T + 1);
}

// ptr_i: (ni + 1,) int32 offsets into ids_i, ic_i (each row distinct ids
// >= 0 in ascending order); the same for j; out: (ni, nj) float32. tile:
// T, a power of two up to 64; entries: at least the entries of any i tile
// and any j tile together (ops/similarity.mica_tile). symmetric != 0: the
// j set is the i set, and only the upper triangle of tiles is computed.
KGT_API int kgt_mica(const int32_t* ptr_i, const int32_t* ids_i, const float* ic_i, int64_t ni,
                     const int32_t* ptr_j, const int32_t* ids_j, const float* ic_j, int64_t nj,
                     int64_t tile, int64_t entries, float* out, int64_t symmetric,
                     cudaStream_t stream) {
  if (ni <= 0 || nj <= 0 || ni > INT_MAX || nj > INT_MAX || tile < 1 || tile > 64 ||
      (tile & (tile - 1)) || entries < 0 || entries > INT_MAX / 8)
    return (int)cudaErrorInvalidValue;
  const int T = (int)tile;
  const size_t bytes = rows_smem_bytes(T, (int)entries);
  if (bytes > SMEM_LIMIT || (ni + T - 1) / T > 65535) return (int)cudaErrorInvalidValue;
  // Raised only when a launch needs more than any before it, so that a
  // repeated launch (as in a CUDA graph capture) makes no other API call.
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        mica_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  const dim3 grid((unsigned)((nj + T - 1) / T), (unsigned)((ni + T - 1) / T));
  mica_rows_kernel<<<grid, MICA_THREADS, bytes, stream>>>(
      ptr_i, ids_i, ic_i, (int)ni, ptr_j, ids_j, ic_j, (int)nj, T, __builtin_ctz(T),
      (int)entries, out, (int)(symmetric != 0));
  return kgt_launch_status();
}

// Blocks of mica_rows_kernel an SM holds at once for a launch of kgt_mica
// with these tile and entries (0 when it cannot launch); no launch.
KGT_API int kgt_mica_occupancy(int64_t tile, int64_t entries) {
  if (tile < 1 || tile > 64 || entries < 0 || entries > INT_MAX / 8) return 0;
  const size_t bytes = rows_smem_bytes((int)tile, (int)entries);
  if (bytes > SMEM_LIMIT) return 0;
  // The most a block may take, never less than a launch set before.
  if (cudaFuncSetAttribute(mica_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_LIMIT) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mica_rows_kernel, MICA_THREADS,
                                                    bytes) != cudaSuccess)
    return 0;
  return blocks;
}
