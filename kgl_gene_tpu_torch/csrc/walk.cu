// The traceback walk over kernel B4's codes.
//
// Replaces the lax.scan of the JAX package's _tb_walk
// (kgl_gene_tpu/ops/traceback.py:45), which a jit compiles into one
// program there; as a loop of PyTorch calls the same walk costs about
// twenty small launches a step. Per pair it follows the path from
// (la, lb) back to (0, 0) through the codes (0 left, 1 up, 2 diagonal
// substitution, >= 3 diagonal match ending a run of code - 2) and writes
// (op, count) run tapes in reverse path order, at most max_steps entries,
// OP_END with count 0 after the end. A match run moves code - 2 rows and
// columns in one step, so the steps scale with the edits. The arithmetic
// is that of ops/traceback.py::tb_walk_plain, step for step: the clamps of
// the cell and the row, the boundary row and column (i > 0 with j = 0 goes
// up, i = 0 with j > 0 goes left, whatever the code), the count of a match
// run clamped to at least 1.
//
// Bound on the card: latency. A step is one byte read from device memory
// or the L2 that the next step's address depends on, and there are only as
// many independent chains as pairs; the bytes (one 32-byte sector a step
// and the tapes) and the operations (about twenty a step) are nothing
// beside it. Design (kgt_walk): one thread per pair, 32 threads a block so
// that a few hundred pairs spread over the SMs and their loads overlap; the
// code loads go through the read-only path, so a step that stays on its
// line (a left step, a short diagonal) re-reads it from the L1. The tapes
// are step-major, (max_steps, B): a warp's store at a step covers 32
// consecutive entries, one 32-byte sector of ops and one 128-byte line of
// counts. A warp leaves its loop once all its 32 pairs are at (0, 0)
// (__all_sync), and writes the OP_END / 0 tail of the steps it did not run
// with the same coalesced stores, which issue without waiting on a load.
//
// A first design ran every pair's max_steps trips to the end and wrote
// pair-major (B, max_steps) tapes, so each warp store touched 32 lines; it
// was 1.86x slower (PERF.md, the kernel table).
#include "common.cuh"

namespace {

enum : int { OP_END = 0, OP_M = 1, OP_X = 2, OP_D = 3, OP_I = 4 };

__global__ void __launch_bounds__(32)
walk_kernel(const uint8_t* __restrict__ codes, int64_t row_stride,
            int64_t pair_stride, int M, int W,
            const int32_t* __restrict__ la_arr,
            const int32_t* __restrict__ lb_arr, uint8_t* __restrict__ ops,
            int32_t* __restrict__ counts, int B, int band_k, int max_steps) {
  // The block is one warp; lanes past B walk nothing and store nothing,
  // but stay for the warp vote.
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = p < B;
  const uint8_t* cp = codes + (int64_t)(real ? p : 0) * pair_stride;
  int i = real ? max(la_arr[p], 0) : 0;
  int j = real ? max(lb_arr[p], 0) : 0;
  int64_t at = p;  // entry (s, p) of a step-major tape
  int s = 0;
  for (; s < max_steps; ++s, at += B) {
    // The step's load goes out before the vote, so the vote and its branch
    // wait beside it; an ended lane's clamped cell lies inside its codes.
    const int c = min(max(j - i + band_k, 0), W - 1);
    const int row = min(max(i - 1, 0), M - 1);
    const int code = __ldg(cp + row * row_stride + c);
    const bool done = i <= 0 && j <= 0;
    if (__all_sync(0xffffffffu, done)) break;
    int op = OP_END, count = 0;
    if (!done) {
      const bool both = i > 0 && j > 0;
      const bool is_match = both && code >= 3;
      const bool take_diag = both && code >= 2;
      const bool take_up = (both && code == 1) || (i > 0 && j <= 0);
      const bool take_left = !take_diag && !take_up;
      count = is_match ? max(code - 2, 1) : 1;
      op = take_diag ? (is_match ? OP_M : OP_X) : take_up ? OP_D : OP_I;
      if (!take_left) i -= count;
      if (!take_up) j -= count;
    }
    if (real) {
      ops[at] = (uint8_t)op;
      counts[at] = count;
    }
  }
  if (!real) return;
  for (; s < max_steps; ++s, at += B) {
    ops[at] = OP_END;
    counts[at] = 0;
  }
}

}  // namespace

// codes: uint8, pair p's code of row r and cell c at codes[r * row_stride +
// p * pair_stride + c], M rows of W = 2 * band_k + 1 cells; la, lb: (B,)
// int32; ops: (max_steps, B) uint8 and counts: (max_steps, B) int32,
// contiguous (step-major).
KGT_API int kgt_walk(const void* codes, int64_t row_stride, int64_t pair_stride,
                     int64_t M, int64_t W, const void* la, const void* lb,
                     void* ops, void* counts, int64_t B, int64_t band_k,
                     int64_t max_steps, void* stream) {
  if (M < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || max_steps == 0) return 0;
  const int threads = 32;
  walk_kernel<<<(unsigned)((B + threads - 1) / threads), threads, 0,
                (cudaStream_t)stream>>>(
      (const uint8_t*)codes, row_stride, pair_stride, (int)M, (int)W,
      (const int32_t*)la, (const int32_t*)lb, (uint8_t*)ops, (int32_t*)counts,
      (int)B, (int)band_k, (int)max_steps);
  return kgt_launch_status();
}
