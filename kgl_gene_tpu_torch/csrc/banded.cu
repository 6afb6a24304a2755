// Kernels B5 (banded Levenshtein distance) and B4 (banded traceback codes).
//
// Replace the TPU kernels _banded_kernel (kgl_gene_tpu/ops/pallas_banded.py:76,
// launched by _banded_call) and _banded_choices_kernel (:185, launched by
// _banded_choices_call). Both run the same row DP over a band of exactly
// 2k+1 cells, cell c = j - i + k of row i holding D[i][j]:
//
//     base[c] = min(prev[c+1] + 1, prev[c] + (a[i-1] != b[j-1]))
//     base[c] = i where j == 0;  BIG where j < 0 or j > lb
//     cur[c]  = min over c' <= c of (base[c'] + c - c')   (insertion chain)
//
// Row 0 is D[0][j] = j for 0 <= j <= min(k, lb). Rows run from 1 to the
// pair's own la and columns stop at its own lb, so no pad value of a or b
// is ever compared. B5 returns D[la][lb] (cell lb - la + k of row la); lb
// when la = 0; max(la, lb) when |la - lb| > k, which is >= the true
// distance and > k. Exactness contract: the result equals the true
// distance iff it is <= k and |la - lb| <= k. B4 writes one uint8 code per
// cell of rows 1..la into codes[(i - 1) * B + p][c]: 0 = left (I), 1 = up
// (D), 2 = diagonal substitution, 3 + r = a diagonal match ending a run of
// r matches, r = min(r_prev, 252) + 1 so that no code exceeds 255; ties go
// diagonal, then up, then left. Cells with j < 0 or j > lb, and every row
// past la up to M, are written as 0 (the walk never reads them), so the
// whole tensor is defined and comparable with the plain version in
// ops/banded.py.
//
// Bound on the card: operations. A row of a pair costs about 12 integer
// operations per cell (compare, two adds, mins, selects, the scan's share)
// over 2k+1 cells, so the least time is 12 * sum(la) * (2k+1) over the
// card's integer rate; B5 reads only the two sequences. B4 also writes
// sum-over-pairs M * (2k+1) bytes of codes, which is the larger term only
// when the rows are short.
//
// Design: one thread block per pair, one thread per band cell (2k+1 <= 1023
// threads for k <= 511), so each row is one step of the whole block. Each
// thread keeps its prev[c] and match run in registers; prev[c+1] is read
// through shared memory. The insertion chain is an inclusive prefix-min of
// base[c] - c across the block: a warp scan with __shfl_up_sync, the warp
// totals through shared memory, a scan of those by warp 0, then + c. This
// replaces the TPU's log-step lane rolls (_prefix_min_chain) and its
// sequential grid axis over 128-row groups; the 128-lane band padding, the
// lead sentinel pad of b and the 32-pair batch quantum are gone. a[i-1] is
// one broadcast read per row; b[j-1] is a coalesced read; each row of codes
// is one coalesced store of 2k+1 bytes. Three block barriers per row make
// the kernel latency-bound: making it fast is later work.
#include "common.cuh"

namespace {

constexpr int BIG = 1 << 29;
constexpr int MAX_THREADS = 1024;

// Inclusive prefix-min of g over the block's threads, in threadIdx order.
// Every thread of the block must call it (it holds block barriers).
__device__ __forceinline__ int block_prefix_min(int g, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, g, off);
    if (lane >= off) g = min(g, o);
  }
  if (lane == 31) s_warp[warp] = g;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nwarps ? s_warp[lane] : BIG;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t = min(t, o);
    }
    s_warp[lane] = t;
  }
  __syncthreads();
  if (warp > 0) g = min(g, s_warp[warp - 1]);
  return g;
}

template <bool CODES>
__global__ void __launch_bounds__(MAX_THREADS)
banded_kernel(const int32_t* __restrict__ a, int64_t a_stride, int Wa,
              const int32_t* __restrict__ b, int64_t b_stride, int Wb,
              const int32_t* __restrict__ la_arr,
              const int32_t* __restrict__ lb_arr, int32_t* __restrict__ out,
              uint8_t* __restrict__ codes, int B, int M, int k) {
  __shared__ int s_prev[MAX_THREADS + 1];
  __shared__ int s_warp[32];
  const int p = blockIdx.x;
  const int c = threadIdx.x;
  const int W = 2 * k + 1;
  const int la = min(max(la_arr[p], 0), Wa);
  const int lb = min(max(lb_arr[p], 0), Wb);
  if (!CODES) {
    if (la == 0 || abs(la - lb) > k) {  // uniform across the block
      if (c == 0) out[p] = la == 0 ? lb : max(la, lb);
      return;
    }
  }
  const int32_t* ap = a + p * a_stride;
  const int32_t* bp = b + p * b_stride;
  if (c == 0) s_prev[blockDim.x] = BIG;

  int j = c - k;
  int v = (c < W && j >= 0 && j <= lb) ? j : BIG;  // row 0
  int run = 0;
  for (int i = 1; i <= la; ++i) {
    s_prev[c] = v;
    __syncthreads();
    j = i - k + c;
    const bool valid = c < W && j >= 0 && j <= lb;
    const int up = s_prev[c + 1] + 1;
    const int ai = __ldg(ap + i - 1);
    const int cost = (valid && j >= 1) ? (int)(ai != __ldg(bp + j - 1)) : 1;
    const int diag = v + cost;
    int base = min(up, diag);
    if (j == 0) base = i;
    if (!valid) base = BIG;
    const int g = block_prefix_min(base - c, s_warp);
    const int cur = valid ? g + c : BIG;
    if (CODES) {
      const bool is_diag = cur == diag;
      const bool is_match = is_diag && cost == 0;
      run = (valid && is_match) ? min(run, 252) + 1 : 0;
      int code = is_match ? run + 2 : is_diag ? 2 : (cur == up ? 1 : 0);
      if (!valid) code = 0;
      if (c < W) codes[((size_t)(i - 1) * B + p) * W + c] = (uint8_t)code;
    }
    v = cur;
  }
  if (CODES) {
    if (c < W) {
      for (int r = la; r < M; ++r) codes[((size_t)r * B + p) * W + c] = 0;
    }
  } else if (c == lb - la + k) {
    out[p] = v;
  }
}

int block_threads(int k) { return ((2 * k + 1 + 31) / 32) * 32; }

}  // namespace

// a: (B, Wa) int32 rows a_stride apart; b: (B, Wb) int32 rows b_stride
// apart; la, lb, out: (B,) int32. 0 <= band_k <= 511.
KGT_API int kgt_banded(const void* a, int64_t a_stride, int64_t Wa,
                       const void* b, int64_t b_stride, int64_t Wb,
                       const void* la, const void* lb, void* out, int64_t B,
                       int64_t band_k, void* stream) {
  if (band_k < 0 || block_threads((int)band_k) > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  banded_kernel<false><<<(unsigned)B, block_threads((int)band_k), 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_stride, (int)Wa, (const int32_t*)b, b_stride, (int)Wb,
      (const int32_t*)la, (const int32_t*)lb, (int32_t*)out, nullptr, (int)B, 0,
      (int)band_k);
  return kgt_launch_status();
}

// As kgt_banded, but writes codes: (M, B, 2*band_k + 1) uint8, M >= every
// clamped la.
KGT_API int kgt_banded_choices(const void* a, int64_t a_stride, int64_t Wa,
                               const void* b, int64_t b_stride, int64_t Wb,
                               const void* la, const void* lb, void* codes,
                               int64_t B, int64_t M, int64_t band_k,
                               void* stream) {
  if (band_k < 0 || block_threads((int)band_k) > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  banded_kernel<true><<<(unsigned)B, block_threads((int)band_k), 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_stride, (int)Wa, (const int32_t*)b, b_stride, (int)Wb,
      (const int32_t*)la, (const int32_t*)lb, nullptr, (uint8_t*)codes, (int)B,
      (int)M, (int)band_k);
  return kgt_launch_status();
}
