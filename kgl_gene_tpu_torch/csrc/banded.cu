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
// cell of rows 1..la into codes[i - 1][p][c]: 0 = left (I), 1 = up
// (D), 2 = diagonal substitution, 3 + r = a diagonal match ending a run of
// r matches, r = min(r_prev, 252) + 1 so that no code exceeds 255; ties go
// diagonal, then up, then left. Cells with j < 0 or j > lb, and every row
// past la up to M, are written as 0 (the walk never reads them), so the
// whole tensor is defined and comparable with the plain version in
// ops/banded.py.
//
// Codes layout. The tensor is (M, B, 2k+1) to its readers, but lies in
// memory pair by pair: pair p's rows follow each other W = 2k+1 bytes apart
// from byte p * pair_pitch, pair_pitch = M * W rounded up to 16 (the
// wrapper hands out that permuted view). A pair's codes are then one
// contiguous stream that leaves the kernel in 16-byte stores.
//
// Bound on the card: operations. A row of a pair costs about 12 integer
// operations per cell (compare, two adds, mins, selects, the scan's share)
// over 2k+1 cells, so the least time is 12 * sum(la) * (2k+1) over the
// card's integer rate; B5 reads only the two sequences. B4 also writes
// sum-over-pairs M * (2k+1) bytes of codes, which is the larger term only
// when the rows are short.
//
// The warp body, k <= 255 (banded_warp_kernel<C, CODES>: B4 with CODES, B5
// without): one warp per pair, so the row loop holds no barrier and a pair
// that ends early stalls nobody. The warp is the thread block; 256 pairs
// are 256 warps on as many schedulers. Lane t holds C = 2, 4, 8 or 16
// consecutive band cells (C * 32 >= 2k+1) with their prev, match run and
// the b codes they compare against in registers; the b window slides one
// code a row, loaded a row ahead, a[i-1] is one broadcast load a row ahead.
// A row is: the `up` candidate from the lane's own next cell and one
// __shfl_down_sync for the last; the insertion chain as a serial prefix-min
// inside the lane, an exclusive warp scan of the lanes' last values in
// three rounds of independent shuffles (4, 16, 32 lanes), and one add-min a
// cell to combine. A lone warp issues in order, so the time is what its
// instructions and the scan's latency add up to: everything is
// straight-line selects, and the codes of row i - 1 are made after row i's
// scan has been issued, to fill its latency. Lanes whose cells all lie
// inside the matrix skip the edge tests (j < 0, j = 0, j > lb); only the
// lanes on an edge take the masked path. Each row's codes go to a staging
// buffer in shared memory byte by byte at their place in the pair's stream,
// and every 16 rows the warp writes the stream's whole 16-byte units out,
// coalesced, keeping the few bytes left for the next turn; rows la .. M - 1
// are zero fill at the end. B5 is the same row loop with the codes compiled
// out: no candidates kept, no run, no stage. After row la the lane that
// holds cell lb - la + k writes it. Blocks of 2 or 4 warps, a pair each,
// timed the same as one on the H100 (PERF.md): the body is bound by the
// instructions it issues, not by the cap of 32 blocks an SM.
//
// Both at 255 < k <= 511 (banded_kernel): one thread block per pair, one
// thread per band cell (2k+1 <= 1023 threads), so each row is one step of
// the whole block. Each thread keeps its prev[c] and match run in
// registers; prev[c+1] is read through shared memory. The insertion chain
// is an inclusive prefix-min of base[c] - c across the block: a warp scan
// with __shfl_up_sync, the warp totals through shared memory, a scan of
// those by warp 0, then + c. Three block barriers per row make this body
// latency-bound; at k > 255 a lane of the warp body would hold 32 cells
// with three values each.
//
// Both replace the TPU's log-step lane rolls (_prefix_min_chain) and its
// sequential grid axis over 128-row groups; the 128-lane band padding, the
// lead sentinel pad of b and the 32-pair batch quantum are gone.
#include <climits>

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
              uint8_t* __restrict__ codes, int64_t pair_pitch, int B, int M,
              int k) {
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
      if (c < W) codes[(size_t)p * pair_pitch + (size_t)(i - 1) * W + c] = (uint8_t)code;
    }
    v = cur;
  }
  if (CODES) {
    if (c < W) {
      for (int r = la; r < M; ++r) codes[(size_t)p * pair_pitch + (size_t)r * W + c] = 0;
    }
  } else if (c == lb - la + k) {
    out[p] = v;
  }
}

constexpr int STAGE_ROWS = 16;  // rows of codes staged between two write-outs
constexpr unsigned FULL = 0xffffffffu;

constexpr int SCAN_BIG = 1 << 30;  // above every value the scan carries

// What a row leaves for its codes, written a row later; B5 keeps nothing.
template <int C, bool CODES>
struct RowCandidates {
  int up[C], diag[C], ne[C];
};
template <int C>
struct RowCandidates<C, false> {};

// One row's cells of one lane, before the warp scan: candidates, base and
// the serial prefix-min inside the lane. EDGE lanes test each cell against
// the matrix's edges and, with CODES, leave up = diag = -1 in a cell that
// is not valid, which row_codes turns into code 0; the others hold only
// cells with 1 <= j <= lb. Both are straight-line code (selects, no
// branch), so that the cells' independent chains interleave in the one
// warp a scheduler has.
template <int C, bool EDGE, bool CODES>
__device__ __forceinline__ void row_candidates(
    const int (&prev)[C], const int (&bw)[C], int nb, int ai, int i, int jbase,
    int j_hi, RowCandidates<C, CODES>& rc, int (&loc)[C]) {
  int m = 0;
#pragma unroll
  for (int x = 0; x < C; ++x) {
    const int jx = jbase + x;
    const int valid = EDGE ? (int)((unsigned)jx <= (unsigned)j_hi) : 1;
    const int up = (x < C - 1 ? prev[x < C - 1 ? x + 1 : x] : nb) + 1;
    int ne = (int)(ai != bw[x]);
    if (EDGE) ne |= (valid & (int)(jx >= 1)) ^ 1;  // cost 1 on the edges
    const int diag = prev[x] + ne;
    int base = min(up, diag);
    if (EDGE) {
      base = jx == 0 ? i : base;
      base = valid ? base : BIG;
    }
    m = x == 0 ? base : min(m + 1, base);
    loc[x] = m;
    if constexpr (CODES) {
      rc.up[x] = EDGE ? (valid ? up : -1) : up;
      rc.diag[x] = EDGE ? (valid ? diag : -1) : diag;
      rc.ne[x] = ne;
    }
  }
}

// Exclusive prefix-min of g over the warp's lanes (SCAN_BIG in lane 0), in
// three rounds of independent shuffles: the 4 lanes before, then 16, then
// all. keep[r] is INT_MIN where lane - offset exists and SCAN_BIG where it
// does not, so that max(., keep) masks a lane that has no such source.
__device__ __forceinline__ int warp_exclusive_min(int g, const int (&keep)[7]) {
  const int a1 = max(__shfl_up_sync(FULL, g, 1), keep[0]);
  const int a2 = max(__shfl_up_sync(FULL, g, 2), keep[1]);
  const int a3 = max(__shfl_up_sync(FULL, g, 3), keep[2]);
  const int a4 = max(__shfl_up_sync(FULL, g, 4), keep[3]);
  const int x = min(min(a1, a2), min(a3, a4));
  const int b1 = max(__shfl_up_sync(FULL, x, 4), keep[3]);
  const int b2 = max(__shfl_up_sync(FULL, x, 8), keep[4]);
  const int b3 = max(__shfl_up_sync(FULL, x, 12), keep[5]);
  const int y = min(min(x, b1), min(b2, b3));
  const int c1 = max(__shfl_up_sync(FULL, y, 16), keep[6]);
  return min(y, c1);
}

// The codes of a row from what it left (rc) and its finished values (cur):
// (diagonal ? 2 : cur == up) + the match run, the run being 0 unless the
// cell is a diagonal match. No branch and no edge test: a cell that is not
// valid has up = diag = -1 and gets code 0.
template <int C>
__device__ __forceinline__ void row_codes(const int (&cur)[C], int (&run)[C],
                                          const RowCandidates<C, true>& rc,
                                          uint8_t* __restrict__ srow, int n_real) {
#pragma unroll
  for (int x = 0; x < C; ++x) {
    const int is_diag = (int)(cur[x] == rc.diag[x]);
    const int is_match = is_diag & (rc.ne[x] ^ 1);
    run[x] = min(run[x] + 1, 253) & -is_match;  // min(run, 252) + 1, or 0
    const int step = is_diag ? 2 : (int)(cur[x] == rc.up[x]);
    if (x < n_real) srow[x] = (uint8_t)(step + run[x]);
  }
}

// B4 with CODES, B5 without: a block is one warp and one pair.
template <int C, bool CODES>
__global__ void __launch_bounds__(32)
banded_warp_kernel(const int32_t* __restrict__ a, int64_t a_stride, int Wa,
                   const int32_t* __restrict__ b, int64_t b_stride, int Wb,
                   const int32_t* __restrict__ la_arr,
                   const int32_t* __restrict__ lb_arr,
                   uint8_t* __restrict__ codes, int64_t pair_pitch,
                   int32_t* __restrict__ out, int k) {
  extern __shared__ uint4 stage4[];  // STAGE_ROWS * W + 16 bytes, rounded up
  uint8_t* stage = (uint8_t*)stage4;
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const int W = 2 * k + 1;
  const int c0 = lane * C;
  const int la = min(max(la_arr[p], 0), Wa);
  const int lb = min(max(lb_arr[p], 0), Wb);
  if (!CODES && (la == 0 || abs(la - lb) > k)) {  // uniform across the warp
    if (lane == 0) out[p] = la == 0 ? lb : max(la, lb);
    return;
  }
  const int32_t* ap = a + p * a_stride;
  const int32_t* bp = b + p * b_stride;
  const int b_last = Wb - 1;
  // b[idx], the index clamped into the row: a clamped read is of a cell
  // that is not valid and never used. An empty b is never read.
  auto ldb = [&](int idx) {
    return Wb > 0 ? __ldg(bp + min(max(idx, 0), b_last)) : 0;
  };

  // Cells of mine past the band's 2k+1 (C * 32 may exceed it). One such
  // cell, the lane's last, the fast path handles; more make the lane EDGE.
  const int n_real = min(max(W - c0, 0), C);
  const bool last_is_pad = n_real == C - 1;
  const bool always_edge = n_real < C - 1;
  int keep[7];
  {
    const int offs[7] = {1, 2, 3, 4, 8, 12, 16};
#pragma unroll
    for (int r = 0; r < 7; ++r) keep[r] = lane >= offs[r] ? INT_MIN : SCAN_BIG;
  }

  int prev[C], run[C], bw[C];
#pragma unroll
  for (int x = 0; x < C; ++x) {
    const int j = c0 + x - k;  // row 0
    prev[x] = (c0 + x < W && j >= 0 && j <= lb) ? j : BIG;
    if constexpr (CODES) run[x] = 0;
    bw[x] = ldb(c0 + x - k);  // row 1 compares a[0] with b[j - 1], j = 1 - k + c
  }
  int b_next = ldb(c0 + C - k);
  int a_next = la > 0 ? __ldg(ap) : 0;
  int org = 0;  // stream offset of stage[0]; dst + org is 16-byte aligned

  // Row i: its candidates and the scan; with CODES, while the scan's
  // shuffles are in flight, the codes of row i - 1 (from `done`, which that
  // row left) go to the stage; then row i's values replace prev. Rows
  // alternate between two RowCandidates so that nothing is copied.
  auto row = [&](int i, RowCandidates<C, CODES>& mine, const RowCandidates<C, CODES>& done) {
    const int ai = a_next;
    a_next = i < la ? __ldg(ap + i) : 0;
    int nb = __shfl_down_sync(FULL, prev[0], 1);
    if (lane == 31) nb = BIG;
    const int jbase = i - k + c0;
    const int j_hi = min(lb, i + k);  // valid cells: 0 <= j <= j_hi
    const bool edge = always_edge || jbase < 1 || jbase + n_real - 1 > lb;
    int loc[C];
    if (edge)
      row_candidates<C, true, CODES>(prev, bw, nb, ai, i, jbase, j_hi, mine, loc);
    else
      row_candidates<C, false, CODES>(prev, bw, nb, ai, i, jbase, j_hi, mine, loc);
    // What the insertion chain carries into my first cell from every lane
    // before me: the exclusive prefix-min of (last value - C * lane).
    const int carry0 =
        warp_exclusive_min(loc[C - 1] - C * lane, keep) + C * lane - C + 1;
    if constexpr (CODES) {
      if (i > 1) row_codes<C>(prev, run, done, stage + ((i - 2) * W - org) + c0, n_real);
    }
#pragma unroll
    for (int x = 0; x < C; ++x) {
      int cur = min(carry0 + x, loc[x]);
      if constexpr (CODES) {
        if (mine.diag[x] < 0) cur = BIG;                    // not valid (EDGE lanes only)
      } else {
        if (edge && (unsigned)(jbase + x) > (unsigned)j_hi) cur = BIG;  // not valid
      }
      if (x == C - 1) cur = last_is_pad ? BIG : cur;        // the cell past the band
      prev[x] = cur;
    }
#pragma unroll
    for (int x = 0; x < C - 1; ++x) bw[x] = bw[x + 1];
    bw[C - 1] = b_next;
    b_next = ldb(i - k + c0 + C);  // row i + 2's last cell
  };

  if constexpr (!CODES) {
    RowCandidates<C, false> none;
    for (int i = 1; i <= la; ++i) row(i, none, none);
    // D[la][lb] is cell lb - la + k of row la. Its lane picks it by an
    // unrolled select: a runtime index would send prev to local memory.
    const int cs = lb - la + k;
    if (lane == cs / C) {
      int v = prev[0];
#pragma unroll
      for (int x = 1; x < C; ++x) v = cs - c0 == x ? prev[x] : v;
      out[p] = v;
    }
  } else {
    uint4* dst = (uint4*)(codes + (size_t)p * pair_pitch);  // 16-byte aligned
    // Write out the whole 16-byte units of the `rows` rows staged so far;
    // the bytes left over move to the front of the stage.
    auto flush = [&](int rows) {
      __syncwarp();
      const int filled = rows * W - org;
      const int units = filled >> 4;
      for (int t = lane; t < units; t += 32) dst[(org >> 4) + t] = stage4[t];
      const int rem = filled & 15;
      const uint8_t left = lane < rem ? stage[units * 16 + lane] : 0;
      __syncwarp();
      if (lane < 16) stage[lane] = left;  // zero behind the bytes kept
      __syncwarp();
      org += units * 16;
    };

    RowCandidates<C, true> even, odd;
    for (int i = 1; i <= la; i += 2) {
      row(i, odd, even);
      if (((i - 1) & (STAGE_ROWS - 1)) == 0 && i > 1) flush(i - 1);
      if (i + 1 <= la) row(i + 1, even, odd);
    }
    if (la > 0) {
      row_codes<C>(prev, run, (la & 1) ? odd : even, stage + ((la - 1) * W - org) + c0, n_real);
      flush(la);
    }
    // Rows la .. M - 1 are zero: the unit that holds the bytes kept, then
    // zero units to the end of the pair's pitch.
    if (la * W > org) {
      if (lane == 0) dst[org >> 4] = stage4[0];
      org += 16;
    }
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int64_t t = (org >> 4) + lane; t < (pair_pitch >> 4); t += 32) dst[t] = zero;
  }
}

// The warp body at band k, C the fewest cells a lane (2, 4, 8 or 16) with
// C * 32 >= 2k + 1.
template <bool CODES>
static int launch_warp(const void* a, int64_t a_stride, int64_t Wa, const void* b,
                       int64_t b_stride, int64_t Wb, const void* la, const void* lb,
                       void* codes, int64_t pair_pitch, void* out, int64_t B, int k,
                       size_t smem, cudaStream_t stream) {
  const int cells = (2 * k + 1 + 31) / 32;
  auto kernel = cells <= 2   ? &banded_warp_kernel<2, CODES>
                : cells <= 4 ? &banded_warp_kernel<4, CODES>
                : cells <= 8 ? &banded_warp_kernel<8, CODES>
                             : &banded_warp_kernel<16, CODES>;
  kernel<<<(unsigned)B, 32, smem, stream>>>(
      (const int32_t*)a, a_stride, (int)Wa, (const int32_t*)b, b_stride, (int)Wb,
      (const int32_t*)la, (const int32_t*)lb, (uint8_t*)codes, pair_pitch, (int32_t*)out, k);
  return kgt_launch_status();
}

// The warp body takes the bands whose cells fit 16 to a lane.
constexpr int WARP_BODY_MAX_BAND = 255;

int block_threads(int k) { return ((2 * k + 1 + 31) / 32) * 32; }

}  // namespace

// 1 when B5 takes the warp body at this band, 0 for the block body;
// launches nothing.
KGT_API int kgt_banded_body(int64_t band_k) {
  return band_k <= WARP_BODY_MAX_BAND ? 1 : 0;
}

// a: (B, Wa) int32 rows a_stride apart; b: (B, Wb) int32 rows b_stride
// apart; la, lb, out: (B,) int32. 0 <= band_k <= 511. body: 1 warp, 0
// block, -1 by the band (the warp body up to band 255).
KGT_API int kgt_banded(const void* a, int64_t a_stride, int64_t Wa,
                       const void* b, int64_t b_stride, int64_t Wb,
                       const void* la, const void* lb, void* out, int64_t B,
                       int64_t band_k, int64_t body, void* stream) {
  if (band_k < 0 || block_threads((int)band_k) > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (body == 1 && band_k > WARP_BODY_MAX_BAND) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (body < 0 ? kgt_banded_body(band_k) : body == 1)
    return launch_warp<false>(a, a_stride, Wa, b, b_stride, Wb, la, lb, nullptr, 0, out, B,
                              (int)band_k, 0, s);
  banded_kernel<false><<<(unsigned)B, block_threads((int)band_k), 0, s>>>(
      (const int32_t*)a, a_stride, (int)Wa, (const int32_t*)b, b_stride, (int)Wb,
      (const int32_t*)la, (const int32_t*)lb, (int32_t*)out, nullptr, 0, (int)B, 0,
      (int)band_k);
  return kgt_launch_status();
}

// 1 when B4 takes the warp body at this band, 0 for the block body;
// launches nothing.
KGT_API int kgt_banded_choices_body(int64_t band_k) {
  return band_k <= WARP_BODY_MAX_BAND ? 1 : 0;
}

// As kgt_banded, but writes codes: pair p's code of DP row i and cell c
// goes to codes[p * pair_pitch + (i - 1) * (2 * band_k + 1) + c], for M
// rows, M >= every clamped la. pair_pitch is a multiple of 16, at least
// M * (2 * band_k + 1), and codes is 16-byte aligned. body: 1 warp, 0
// block, -1 by the band (the warp body up to band 255).
KGT_API int kgt_banded_choices(const void* a, int64_t a_stride, int64_t Wa,
                               const void* b, int64_t b_stride, int64_t Wb,
                               const void* la, const void* lb, void* codes,
                               int64_t pair_pitch, int64_t B, int64_t M,
                               int64_t band_k, int64_t body, void* stream) {
  if (band_k < 0 || block_threads((int)band_k) > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if ((pair_pitch & 15) || pair_pitch < M * (2 * band_k + 1) || ((uintptr_t)codes & 15))
    return (int)cudaErrorInvalidValue;
  if (body == 1 && band_k > WARP_BODY_MAX_BAND) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int k = (int)band_k;
  if (body < 0 ? kgt_banded_choices_body(band_k) : body == 1) {
    const size_t smem = ((size_t)STAGE_ROWS * (2 * k + 1) + 16 + 15) / 16 * 16;
    return launch_warp<true>(a, a_stride, Wa, b, b_stride, Wb, la, lb, codes, pair_pitch,
                             nullptr, B, k, smem, s);
  }
  banded_kernel<true><<<(unsigned)B, block_threads(k), 0, s>>>(
      (const int32_t*)a, a_stride, (int)Wa, (const int32_t*)b, b_stride, (int)Wb,
      (const int32_t*)la, (const int32_t*)lb, nullptr, (uint8_t*)codes, pair_pitch,
      (int)B, (int)M, k);
  return kgt_launch_status();
}
