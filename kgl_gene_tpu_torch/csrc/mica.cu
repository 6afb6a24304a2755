// MICA: the all-pairs max-min over matching ancestor ids.
//
// Replaces the device tile functions of the ontology similarity path,
// _mica_tile and _mica_tile_chunked (kgl_gene_tpu/ops/similarity.py:67,77;
// XLA jit with a fori_loop over 64 x 64 chunks of the ancestor cross
// product, not Pallas), and the host loop of 128-term tiles around them
// (:116-126). For ancestor ids (n, K) int32 (distinct ids >= 0 in
// ascending order, -1 pads last: the wrapper, ops/similarity.mica, sorts
// each row set once) and their ICs (n, K) float32:
//
//   out[i, j] = max(0, max over (p, q) with ids_i[p] == ids_j[q] of
//                      min(ic_i[p], ic_j[q]))
//
// over all K columns for any K (the reference's chunked form drops the
// columns past (K / 64) * 64). The result is a selection of input values,
// so it equals the plain version bit for bit.
//
// Bound on the card: issue. The compare of the reference is K * K a pair;
// the least work is a merge of the two real lists, which ends with the
// list whose last id m is smaller: #ids_i <= m + #ids_j <= m - |common|
// steps a pair, a match moving both. Against it, ids and ICs are read
// once and n * n * 4 bytes written once. At 8,192 terms of 20-40
// ancestors that is ~10^10 instructions, milliseconds, against 0.1 ms of
// bytes.
//
// Design. One launch covers the matrix: a block per 16 x 16 tile of
// output pairs, a thread per pair; with one row set (symmetric) only the
// upper triangle of tiles runs, and each off-diagonal tile is also written
// mirrored, through shared memory so that both stores coalesce. A block
// copies the real prefix of its 16 + 16 rows into shared memory as (id,
// IC) pairs. Then each thread merges its two sorted lists, O(len_i +
// len_j) steps with no K * K compare, one 8-byte shared load a list a
// step; the merge loop diverges within a warp as the lengths differ,
// which costs time, not results. Shared memory takes 16 * (K_i + K_j) * 8
// bytes; a wider K takes a smaller tile (8, 4, 2, 1), up to the card's
// opt-in limit.
#include "common.cuh"

#include <climits>

// Per row of the tile: the number of ids >= 0 (the pads are last).
template <int T>
__device__ __forceinline__ void count_rows(const int32_t* __restrict__ ids, int64_t n, int K,
                                           int64_t r0, int* s_len) {
  for (int e = threadIdx.x; e < T * K; e += blockDim.x) {
    const int r = e / K, p = e % K;
    if (r0 + r < n && __ldg(ids + (r0 + r) * K + p) >= 0) atomicAdd(&s_len[r], 1);
  }
}

// Each row's real prefix as (id, IC bits) pairs in shared memory.
template <int T>
__device__ __forceinline__ void stage_rows(const int32_t* __restrict__ ids,
                                           const float* __restrict__ ic, int64_t n, int K,
                                           int64_t r0, int S, const int* s_len, int2* s_row) {
  for (int e = threadIdx.x; e < T * K; e += blockDim.x) {
    const int r = e / K, p = e % K;
    const int64_t at = (r0 + r) * K + p;
    if (r0 + r < n && p < s_len[r])
      s_row[r * S + p] = make_int2(__ldg(ids + at), __float_as_int(__ldg(ic + at)));
  }
}

template <int T>
__global__ void __launch_bounds__(T * T)
mica_kernel(const int32_t* __restrict__ ids_i, const float* __restrict__ ic_i, int64_t ni,
            int ki, const int32_t* __restrict__ ids_j, const float* __restrict__ ic_j,
            int64_t nj, int kj, float* __restrict__ out, int symmetric) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (symmetric && bi > bj) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int si = ki | 1, sj = kj | 1;  // odd strides: a column of rows spans the banks
  int2* s_i = (int2*)smem;
  int2* s_j = s_i + T * si;
  int* s_len = (int*)(s_j + T * sj);       // T rows of i, then T rows of j
  float* s_out = (float*)(s_len + 2 * T);  // T x (T + 1), the mirrored tile
  const int64_t i0 = (int64_t)bi * T, j0 = (int64_t)bj * T;

  for (int r = threadIdx.x; r < 2 * T; r += blockDim.x) s_len[r] = 0;
  __syncthreads();
  count_rows<T>(ids_i, ni, ki, i0, s_len);
  count_rows<T>(ids_j, nj, kj, j0, s_len + T);
  __syncthreads();
  stage_rows<T>(ids_i, ic_i, ni, ki, i0, si, s_len, s_i);
  stage_rows<T>(ids_j, ic_j, nj, kj, j0, sj, s_len + T, s_j);
  __syncthreads();

  // The merge: advance past the smaller id, both on a match.
  const int ty = threadIdx.x / T, tx = threadIdx.x % T;
  const int2* a = s_i + ty * si;
  const int2* const a_end = a + s_len[ty];
  const int2* b = s_j + tx * sj;
  const int2* const b_end = b + s_len[T + tx];
  float best = 0.0f;
  while (a < a_end && b < b_end) {
    const int2 x = *a, y = *b;
    if (x.x == y.x) best = fmaxf(best, fminf(__int_as_float(x.y), __int_as_float(y.y)));
    a += x.x <= y.x;
    b += y.x <= x.x;
  }
  const int64_t i = i0 + ty, j = j0 + tx;
  if (i < ni && j < nj) out[i * nj + j] = best;
  if (symmetric && bi != bj) {  // uniform over the block
    s_out[ty * (T + 1) + tx] = best;
    __syncthreads();
    const int64_t mi = j0 + ty, mj = i0 + tx;
    if (mi < nj && mj < ni) out[mi * nj + mj] = s_out[tx * (T + 1) + ty];
  }
}

constexpr size_t SMEM_LIMIT = 227 * 1024;  // an H100 block's opt-in shared memory

static size_t smem_bytes(int T, int ki, int kj) {
  return (size_t)T * ((ki | 1) + (kj | 1)) * 8 + 2 * T * 4 + (size_t)T * (T + 1) * 4;
}

template <int T>
static int launch_tile(const int32_t* ids_i, const float* ic_i, int64_t ni, int ki,
                       const int32_t* ids_j, const float* ic_j, int64_t nj, int kj, float* out,
                       int symmetric, cudaStream_t stream) {
  if ((ni + T - 1) / T > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  const size_t bytes = smem_bytes(T, ki, kj);
  // Raised only when a launch needs more than any before it, so that a
  // repeated launch (as in a CUDA graph capture) makes no other API call.
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        mica_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  const dim3 grid((unsigned)((nj + T - 1) / T), (unsigned)((ni + T - 1) / T));
  mica_kernel<T><<<grid, T * T, bytes, stream>>>(ids_i, ic_i, ni, ki, ids_j, ic_j, nj, kj,
                                                 out, symmetric);
  return kgt_launch_status();
}

// ids_i, ic_i: (ni, ki); ids_j, ic_j: (nj, kj); out: (ni, nj) float32.
// Each row holds distinct ids >= 0 in ascending order, then -1 pads.
// symmetric != 0: the j set is the i set (same pointers and sizes), and
// only the upper triangle of tiles is computed and mirrored. The widest
// tile whose rows fit in shared memory is taken.
KGT_API int kgt_mica(const int32_t* ids_i, const float* ic_i, int64_t ni, int64_t ki,
                     const int32_t* ids_j, const float* ic_j, int64_t nj, int64_t kj, float* out,
                     int64_t symmetric, cudaStream_t stream) {
  if (ni <= 0 || nj <= 0 || ki <= 0 || kj <= 0 || ki > INT_MAX / 16 || kj > INT_MAX / 16)
    return (int)cudaErrorInvalidValue;
  const int a = (int)ki, b = (int)kj, s = (int)(symmetric != 0);
  if (smem_bytes(16, a, b) <= SMEM_LIMIT)
    return launch_tile<16>(ids_i, ic_i, ni, a, ids_j, ic_j, nj, b, out, s, stream);
  if (smem_bytes(8, a, b) <= SMEM_LIMIT)
    return launch_tile<8>(ids_i, ic_i, ni, a, ids_j, ic_j, nj, b, out, s, stream);
  if (smem_bytes(4, a, b) <= SMEM_LIMIT)
    return launch_tile<4>(ids_i, ic_i, ni, a, ids_j, ic_j, nj, b, out, s, stream);
  if (smem_bytes(2, a, b) <= SMEM_LIMIT)
    return launch_tile<2>(ids_i, ic_i, ni, a, ids_j, ic_j, nj, b, out, s, stream);
  if (smem_bytes(1, a, b) <= SMEM_LIMIT)
    return launch_tile<1>(ids_i, ic_i, ni, a, ids_j, ic_j, nj, b, out, s, stream);
  return (int)cudaErrorInvalidValue;  // K beyond the shared memory of a block
}
