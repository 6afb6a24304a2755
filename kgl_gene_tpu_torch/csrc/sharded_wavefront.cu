// Kernel `wavefront_chunk`: one chunk of the sharded long-pair wavefront,
// H anti-diagonals of one rank's lanes in one launch.
//
// Replaces the device loop of kgl_gene_tpu/ops/sharded_wavefront.py
// (_build_kernel, :42; its fori_loop over a chunk's H diagonals at :103),
// which XLA runs outside any Pallas kernel under shard_map. The DP is the
// unit-cost Levenshtein table of each pair; lane i of diagonal d holds
// D[i][d - i]. A rank owns lanes [r Wl, (r + 1) Wl) and keeps H halo lanes
// to their left (local lane k is row i0 + k, i0 = r Wl - H); between two
// launches ops/sharded_wavefront.py refreshes the halo from the left
// neighbour rank (a ring exchange) and swaps the in and out buffers.
//
// Algorithm, and why it is exact: a cell reads rows i - 1 and i of the two
// diagonals before it, so after t steps from exact diagonals a lane is
// still exact iff it lies t or more lanes above the left edge of what was
// loaded. The halo trick is applied twice. The rank keeps H lanes of halo
// for the H steps of a chunk; and inside the launch each block owns a tile
// of T lanes and loads the H lanes left of it as well, from the chunk's
// input diagonals in global memory, so it steps its T + H lanes H times
// with no other block's help and writes back its T owned lanes, exact.
// The blocks of one pair run side by side on several SMs, and the next
// launch starts from what all of them wrote.
//
// Design: a block is T + H threads, a lane a thread (512 threads up to
// H = 256, else 1,024; fewer when the rank has fewer lanes), its own
// diagonals d - 1 and d - 2 in registers, its left neighbour's diagonal
// d - 1 from a double buffer in shared memory, one __syncthreads a step.
// The text symbols the block reads during the chunk, b[j - 1] for every
// (lane, step), are one run of T + 2 H - 1 codes, loaded into shared
// memory once at the start. The pair's capture D[la][lb] is stored by the
// thread that owns lane la, at diagonal la + lb. Per cell: a compare, two
// mins, two adds, three selects for the table's edges.
//
// Bound on the card: operations, ~6 integer operations a DP cell over the
// (la + 1)(lb + 1) cells of a pair (the halo lanes add H / T more), with
// one block barrier a diagonal; the bytes, two int32 diagonals of W lanes
// read and written a chunk, are small beside that. One block a pair would
// leave all but one SM idle; the tiles spread a pair over ceil(Wl / T)
// blocks.
#include "common.cuh"

__global__ void __launch_bounds__(1024)
wavefront_chunk_kernel(const int32_t* __restrict__ a_lane,
                       const int32_t* __restrict__ b, int64_t b_stride, int Mb,
                       const int32_t* __restrict__ la_arr,
                       const int32_t* __restrict__ lb_arr,
                       const int32_t* __restrict__ in_pp,
                       const int32_t* __restrict__ in_p,
                       int32_t* __restrict__ out_pp, int32_t* __restrict__ out_p,
                       int32_t* __restrict__ result, int W, int i0, int Ma, int d0,
                       int H, int T) {
  extern __shared__ int32_t smem[];
  const int n = blockDim.x;  // T + H lanes
  int32_t* buf = smem;       // [2][n]: diagonal d - 1 of every lane, by step parity
  int32_t* sb = smem + 2 * n;  // [n + H - 1]: b[j - 1] for the chunk's (lane, step)
  const int pair = blockIdx.y;
  const int m = threadIdx.x;
  const int k0 = blockIdx.x * T;  // local lane of the block's thread 0
  const int k = k0 + m;
  const int i = i0 + k;  // DP row
  const bool in_w = k < W;
  const int64_t row = (int64_t)pair * W;
  const int big = Ma + Mb + 1;
  const bool lane_ok = in_w && i >= 0 && i <= Ma;
  const int ac = in_w ? a_lane[row + k] : -1;
  int p = in_w ? in_p[row + k] : big;
  int left_pp = m > 0 && in_w ? in_pp[row + k - 1] : big;
  int pp = in_w ? in_pp[row + k] : big;
  // j of thread m at step t is d0 + t - i0 - k0 - m; sb[x] = b[j - 1] with
  // x = t - m + n - 1, so x runs over [0, n + H - 2].
  const int j_lo = d0 - (i0 + k0) - (n - 1);
  const int32_t* bp = b + (int64_t)pair * b_stride;
  for (int x = m; x < n + H - 1; x += n) {
    const int j = j_lo + x;
    sb[x] = j >= 1 && j <= Mb ? __ldg(bp + j - 1) : -2;
  }
  const int la = la_arr[pair];
  const int d_hit = la + lb_arr[pair];
  const bool capture = m >= H && in_w && i == la;
  buf[m] = p;
  __syncthreads();
  for (int t = 0; t < H; ++t) {
    const int d = d0 + t;
    const int left_p = m > 0 ? buf[(t & 1) * n + m - 1] : big;  // D[i - 1][j]
    const int j = d - i;
    const int bc = sb[t - m + n - 1];
    int cand = min(min(left_p, p) + 1, left_pp + (ac != bc ? 1 : 0));
    cand = j == 0 ? i : cand;
    cand = i == 0 ? j : cand;
    cand = lane_ok && j >= 0 && j <= Mb ? cand : big;
    if (capture && d == d_hit) result[pair] = cand;
    left_pp = left_p;
    pp = p;
    p = cand;
    buf[((t + 1) & 1) * n + m] = cand;
    __syncthreads();
  }
  if (m >= H && in_w) {
    out_p[row + k] = p;
    out_pp[row + k] = pp;
  }
}

// a_lane, in_pp, in_p, out_pp, out_p: (B, W) int32; b: (B, >= Mb) int32
// rows b_stride apart; la, lb, result: (B,) int32. The halo lanes (k < H)
// of out_pp and out_p are not written.
KGT_API int kgt_wavefront_chunk(const void* a_lane, const void* b, int64_t b_stride,
                                int64_t Mb, const void* la, const void* lb,
                                const void* in_pp, const void* in_p, void* out_pp,
                                void* out_p, void* result, int64_t B, int64_t W,
                                int64_t i0, int64_t Ma, int64_t d0, int64_t H,
                                void* stream) {
  if (B == 0 || W <= H) return 0;
  if (H < 1 || H > 512 || B > 65535) return (int)cudaErrorInvalidValue;
  int n = H <= 256 ? 512 : 1024;
  const int w32 = (int)((W + 31) / 32 * 32);
  if (w32 < n) n = w32;  // W > H, so T >= 1
  const int T = n - (int)H;
  const unsigned tiles = (unsigned)((W - H + T - 1) / T);
  const size_t smem = (size_t)(3 * n + H - 1) * sizeof(int32_t);
  wavefront_chunk_kernel<<<dim3(tiles, (unsigned)B), n, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a_lane, (const int32_t*)b, b_stride, (int)Mb,
      (const int32_t*)la, (const int32_t*)lb, (const int32_t*)in_pp,
      (const int32_t*)in_p, (int32_t*)out_pp, (int32_t*)out_p, (int32_t*)result,
      (int)W, (int)i0, (int)Ma, (int)d0, (int)H, T);
  return kgt_launch_status();
}
