// Kernel `wavefront_chunk`: chunks of the sharded long-pair wavefront, H
// anti-diagonals of one rank's lanes a chunk.
//
// Replaces the device loop of kgl_gene_tpu/ops/sharded_wavefront.py
// (_build_kernel, :42; its fori_loop over a chunk's H diagonals at :103 and
// its scan over the chunks at :118), which XLA runs outside any Pallas
// kernel under shard_map. The DP is the unit-cost Levenshtein table of each
// pair; lane i of diagonal d holds D[i][d - i]. A rank owns lanes
// [r Wl, (r + 1) Wl) and keeps H halo lanes to their left (local lane k is
// row i0 + k, i0 = r Wl - H); between two chunks ops/sharded_wavefront.py
// refreshes the halo from the left neighbour rank (a ring exchange) and
// swaps the in and out buffers.
//
// Why the pieces are exact: a cell reads rows i - 1 and i of the two
// diagonals before it, so after t steps from exact diagonals a lane is
// still exact iff it lies t or more lanes right of the left edge of what
// was loaded (the right edge never matters). The rule is applied three
// times. The rank keeps H lanes of halo for the H steps of a chunk. A block
// owns a tile of T lanes and loads the h lanes left of it as well, so it
// steps its h + T lanes h times with no other block's help and writes back
// its T owned lanes, exact. Inside the block each warp holds its own 32
// lanes of halo, the last 32 lanes of the warp to its left, refreshed from
// shared memory every 32 steps, so the warps meet at one block barrier
// every 32 diagonals instead of every diagonal.
//
// Design, for the card:
// - A thread holds 4 consecutive lanes in registers: their diagonals d - 1
//   and d - 2, their a-codes, and a window of 4 text codes that moves one
//   lane down a step (lane x of a thread at step t reads the code lane 0
//   read at step t - x). Lane 0's left neighbour comes from the thread to
//   the left by __shfl_up_sync; the other three are in the thread's own
//   registers. A step is four independent cells for the scheduler.
// - A cell is min(up + 1, left + 1, diag + cost): a compare, a select and
//   one DPX __vimin3_s32 over the lanes' values plus one, which each lane
//   keeps beside its values. Cells stay int32: a 49,152-base pair's values
//   reach 98,305.
// - The steps have no edge selects (tile_steps says why that is exact);
//   the stores write the sentinel off the table. A tile with no cell on
//   the table writes the sentinel and does no steps; only the tile that
//   holds a pair's capture in a launch compiles the capture in.
// - The block's run of text codes, b[j - 1] for every (lane, step) of the
//   launch, is in shared memory, laid out so that a thread reads the codes
//   of its lane 0 for four steps with one 16-byte load, conflict-free
//   across the warp, a run ahead of their use.
// - Tiles are chosen on the host (ops/sharded_wavefront.py::chunk_geometry):
//   a warp a scheduler issues its step at the integer pipe's rate, so the
//   launch lasts as long as its busiest SM; the rule gives that SM the
//   fewest lanes (4 warps, 114 tiles over the 32,768-base pair at H = 128).
// - A chunk's h may be at most kMaxHalo: a longer chunk runs as several
//   launches of at most kMaxHalo steps, each starting from the last exact
//   lane of the one before (ops/sharded_wavefront.py::chunk).
// - kgt_wavefront_chunks runs n chunks in one cooperative launch, a grid
//   barrier (cooperative_groups::this_grid().sync()) where a launch boundary
//   stood and the in and out buffers swapped inside the kernel: the route of
//   a rank with no ring exchange between its chunks (world 1). Its grid must
//   fit the blocks the card holds at once (kgt_wavefront_chunks_blocks).
//
// Bound on the card: operations, ~6 integer operations a DP cell over the
// (la + 1)(lb + 1) cells of a pair; the bytes, two int32 diagonals of W
// lanes read and written a chunk, are small beside that. The body issues
// about 5 instructions a cell (scripts/torch_kernel_bodies.py --sass counts
// them), each warp instruction two cycles of the integer pipe; the block
// halo and the warps' halos add their recomputed lanes.
//
// A first design, one lane a thread and one block barrier a diagonal, was
// 2.74x slower a chunk (PERF.md, the kernel table).
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kR = 4;                  // lanes a thread
constexpr int kWarpLanes = 32 * kR;    // lanes a warp
constexpr int kS = 32;                 // a warp's halo lanes, the steps between exchanges
constexpr int kHaloThreads = kS / kR;  // the threads that hold a warp's halo
constexpr int kMaxWarps = 16;
constexpr int kMaxHalo = 512;          // the most steps of one launch
constexpr int kXchInts = 2 * kMaxWarps * 2 * kS;  // [parity][warp][p, pp][kS]
constexpr unsigned kFull = 0xffffffffu;

struct ChunkArgs {
  const int32_t* a_lane;  // (B, W)
  const int32_t* b;       // (B, >= Mb), rows b_stride apart
  int64_t b_stride;
  const int32_t* la;      // (B,)
  const int32_t* lb;      // (B,)
  int32_t* result;        // (B,)
  int Mb, W, i0, Ma;
  int H_own;              // the rank's halo: captures on lanes k >= H_own only
  int warps;              // warps a block
};

// Lanes a block covers: the warps overlap by kS lanes.
__host__ __device__ constexpr int block_lanes(int warps) {
  return kWarpLanes + (warps - 1) * (kWarpLanes - kS);
}

// Ints of the text run, a multiple of 4: the 16-byte loads of the last
// thread's lane 0 end at int nl + h + 3.
__host__ __device__ constexpr int text_ints(int nl, int h) { return (nl + h + 8 + 3) & ~3; }

__host__ __device__ constexpr size_t chunk_smem(int warps, int h) {
  return (size_t)(text_ints(block_lanes(warps), h) + kXchInts) * sizeof(int32_t);
}

// D[i][j] = min(up + 1, left + 1, diag + cost) from q_up = D[i - 1][j] + 1,
// q_left = D[i][j - 1] + 1 and diag = D[i - 1][j - 1], q_diag = diag + 1:
// one compare, one select and one DPX three-way min (each lane keeps its
// value plus one beside the value, made once and read by two cells).
__device__ __forceinline__ int dp_cell(int q_up, int q_left, int diag, int q_diag, int ac,
                                       int bc) {
  return __vimin3_s32(q_up, q_left, ac == bc ? diag : q_diag);
}

// h steps from diagonal d0 of the block whose lane 0 is local lane k0:
// reads src, writes the block's owned lanes of dst. CAPTURE: the pair's
// capture may fall in this block, at step t_hit (the body without it has
// none of its compares and selects).
//
// The steps have no edge selects. A cell on the table reads only cells of
// rows <= its row and columns <= its column, so the cells past row Ma or
// column Mb never reach one on the table and may hold anything during the
// launch; the cells left of row 0 and above column 0 start at the sentinel
// big = Ma + Mb + 1 and stay >= big (their inputs are), which is all row 0
// and column 0 need to come out as j and i. The stores then write big to
// every lane off the table, as chunk_plain's state holds it. The same cone
// lets a warp's lane 0 take whatever the shuffle gives it (its own value):
// the lanes it reaches are halo lanes.
template <bool CAPTURE>
__device__ __forceinline__ void tile_steps(const ChunkArgs& g, const int32_t* src_pp,
                                           const int32_t* src_p, int32_t* dst_pp,
                                           int32_t* dst_p, int d0, int h, int k0, int pair,
                                           int t_hit, int32_t* sb, int32_t* xch) {
  static_assert(kS % 4 == 0 && kS % kR == 0, "a period is runs of four steps");
  const int nl = block_lanes(g.warps);
  const int warp = threadIdx.x >> 5, m = threadIdx.x & 31;
  const int lf = warp * (kWarpLanes - kS) + kR * m;  // block lane of the thread's lane 0
  const int kf = k0 + lf;                             // its local lane
  const int64_t row = (int64_t)pair * g.W;
  const int big = g.Ma + g.Mb + 1;
  int p[kR], pp[kR], ac[kR], bc[kR];
#pragma unroll
  for (int x = 0; x < kR; ++x) {
    const int k = kf + x;
    const bool in_w = k < g.W;
    ac[x] = in_w ? __ldg(g.a_lane + row + k) : -1;
    p[x] = in_w ? __ldcg(src_p + row + k) : big;
    pp[x] = in_w ? __ldcg(src_pp + row + k) : big;
  }
  // sb[y] = b[jb + y - 1] (-2 off the table); lane l reads sb[t - l + nl] at
  // step t, so the thread's lane 0 reads the 16 bytes at (t - lf + nl) / 4
  // for four steps (nl and lf are multiples of 4).
  const int jb = d0 - g.i0 - k0 - nl;
  const int32_t* bp = g.b + (int64_t)pair * g.b_stride;
  const int n_sb = text_ints(nl, h);
#pragma unroll 4
  for (int y = threadIdx.x; y < n_sb; y += blockDim.x) {  // no branch: the loads go out together
    const int j = jb + y;
    const int code = __ldg(bp + min(max(j - 1, 0), max(g.Mb - 1, 0)));
    sb[y] = j >= 1 && j <= g.Mb ? code : -2;
  }
  __syncthreads();
  const int4* sb4 = reinterpret_cast<const int4*>(sb);
  const int q = (nl - lf) >> 2;
  {
    const int4 c = sb4[q - 1];  // lane 0's codes at steps -1, -2, -3: lanes 1, 2, 3 at step 0
    bc[0] = c.w;
    bc[1] = c.z;
    bc[2] = c.y;
  }
  int cap_x = -1;  // the thread's lane that holds the capture, if it owns one
  if (CAPTURE) {
    const int k_la = g.la[pair] - g.i0, x = k_la - kf;
    if ((warp == 0 || m >= kHaloThreads) && x >= 0 && x < kR && lf + x >= h &&
        k_la >= g.H_own && k_la < g.W)
      cap_x = x;
  }
  int p1[kR], pp1[kR];  // p + 1 and pp + 1
  int up0, diag0, q_diag0;  // lane 0's up and diag, and diag + 1
  auto neighbours = [&]() {  // after a load or a refresh of the lanes
#pragma unroll
    for (int x = 0; x < kR; ++x) {
      p1[x] = p[x] + 1;
      pp1[x] = pp[x] + 1;
    }
    up0 = __shfl_up_sync(kFull, p[kR - 1], 1);
    diag0 = __shfl_up_sync(kFull, pp[kR - 1], 1);
    q_diag0 = diag0 + 1;
  };
  neighbours();
  auto step = [&](int t, int code) {
#pragma unroll
    for (int x = kR - 1; x >= 1; --x) bc[x] = bc[x - 1];
    bc[0] = code;
    int cand[kR];
    cand[kR - 1] =
        dp_cell(p1[kR - 2], p1[kR - 1], pp[kR - 2], pp1[kR - 2], ac[kR - 1], bc[kR - 1]);
    const int up_next = __shfl_up_sync(kFull, cand[kR - 1], 1);  // in flight meanwhile
#pragma unroll
    for (int x = kR - 2; x >= 1; --x)
      cand[x] = dp_cell(p1[x - 1], p1[x], pp[x - 1], pp1[x - 1], ac[x], bc[x]);
    const int q_up0 = up0 + 1;
    cand[0] = dp_cell(q_up0, p1[0], diag0, q_diag0, ac[0], bc[0]);
    if (CAPTURE && t == t_hit && cap_x >= 0) {
      int v = cand[0];
#pragma unroll
      for (int x = 1; x < kR; ++x) v = cap_x == x ? cand[x] : v;
      g.result[pair] = v;
    }
    diag0 = up0;
    q_diag0 = q_up0;
    up0 = up_next;
#pragma unroll
    for (int x = 0; x < kR; ++x) {
      pp[x] = p[x];
      pp1[x] = p1[x];
      p[x] = cand[x];
      p1[x] = cand[x] + 1;
    }
  };
  int t = 0;
  int4 cur = sb4[q];  // lane 0's codes of steps t .. t + 3, each run's loaded a run ahead
  for (; t + kS <= h; t += kS) {
#pragma unroll
    for (int r = 0; r < kS / 4; ++r) {
      const int4 nxt = sb4[q + (t >> 2) + r + 1];
      step(t + 4 * r, cur.x);
      step(t + 4 * r + 1, cur.y);
      step(t + 4 * r + 2, cur.z);
      step(t + 4 * r + 3, cur.w);
      cur = nxt;
    }
    if (t + kS < h) {  // refresh each warp's halo lanes from the warp to its left
      int32_t* xb = xch + ((t / kS) & 1) * (kMaxWarps * 2 * kS);
      if (m >= 32 - kHaloThreads) {
        int32_t* w_out = xb + warp * 2 * kS + kR * (m - (32 - kHaloThreads));
#pragma unroll
        for (int x = 0; x < kR; ++x) {
          w_out[x] = p[x];
          w_out[kS + x] = pp[x];
        }
      }
      __syncthreads();
      if (warp > 0 && m < kHaloThreads) {
        const int32_t* w_in = xb + (warp - 1) * 2 * kS + kR * m;
#pragma unroll
        for (int x = 0; x < kR; ++x) {
          p[x] = w_in[x];
          pp[x] = w_in[kS + x];
        }
      }
      neighbours();
    }
  }
  for (; t < h; ++t) step(t, sb[4 * q + t]);  // the last h % kS steps, a 4-byte load each
  if (warp == 0 || m >= kHaloThreads) {  // the thread's lanes are its warp's own
    const int d1 = d0 + h - 1;           // the diagonal of p; pp's is d1 - 1
#pragma unroll
    for (int x = 0; x < kR; ++x) {
      const int k = kf + x, i = g.i0 + k, j = d1 - i;
      if (lf + x >= h && k < g.W) {
        const bool row_ok = i >= 0 && i <= g.Ma;
        dst_p[row + k] = row_ok && j >= 0 && j <= g.Mb ? p[x] : big;
        dst_pp[row + k] = row_ok && j >= 1 && j <= g.Mb + 1 ? pp[x] : big;
      }
    }
  }
}

// One block's tile: no steps where no cell of it lies on the table.
__device__ __forceinline__ void run_tile(const ChunkArgs& g, const int32_t* src_pp,
                                         const int32_t* src_p, int32_t* dst_pp, int32_t* dst_p,
                                         int d0, int h, int k0, int32_t* sb, int32_t* xch) {
  const int pair = blockIdx.y;
  const int nl = block_lanes(g.warps);
  const int i_lo = g.i0 + k0, i_hi = i_lo + nl - 1;
  const int lo = max(i_lo, 0), hi = min(i_hi, g.Ma);
  const int d_first = min(d0, d0 + h - 2);  // the out diagonals are d0 + h - 2 and d0 + h - 1
  if (lo > hi || lo > d0 + h - 1 || hi < d_first - g.Mb) {
    const int big = g.Ma + g.Mb + 1;
    const int warp = threadIdx.x >> 5, m = threadIdx.x & 31;
    const int lf = warp * (kWarpLanes - kS) + kR * m;
    const int64_t row = (int64_t)pair * g.W;
    if (warp == 0 || m >= kHaloThreads) {
#pragma unroll
      for (int x = 0; x < kR; ++x) {
        const int k = k0 + lf + x;
        if (lf + x >= h && k < g.W) {
          dst_p[row + k] = big;
          dst_pp[row + k] = big;
        }
      }
    }
    return;
  }
  const int d_hit = g.la[pair] + g.lb[pair];
  const int k_la = g.la[pair] - g.i0;
  const bool capture = d_hit >= d0 && d_hit < d0 + h && k_la >= k0 && k_la < k0 + nl;
  if (capture)
    tile_steps<true>(g, src_pp, src_p, dst_pp, dst_p, d0, h, k0, pair, d_hit - d0, sb, xch);
  else
    tile_steps<false>(g, src_pp, src_p, dst_pp, dst_p, d0, h, k0, pair, -1, sb, xch);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
wavefront_chunk_kernel(ChunkArgs g, const int32_t* src_pp, const int32_t* src_p,
                       int32_t* dst_pp, int32_t* dst_p, int d0, int h, int k_first, int T) {
  extern __shared__ int4 chunk_smem4[];
  int32_t* sb = reinterpret_cast<int32_t*>(chunk_smem4);
  int32_t* xch = sb + text_ints(block_lanes(g.warps), h);
  run_tile(g, src_pp, src_p, dst_pp, dst_p, d0, h, k_first + (int)blockIdx.x * T, sb, xch);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
wavefront_chunks_kernel(ChunkArgs g, int32_t* pp0, int32_t* p0, int32_t* pp1, int32_t* p1,
                        int d0, int H, int n, int T) {
  extern __shared__ int4 chunk_smem4[];
  int32_t* sb = reinterpret_cast<int32_t*>(chunk_smem4);
  int32_t* xch = sb + text_ints(block_lanes(g.warps), H);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int c = 0; c < n; ++c) {
    const bool odd = c & 1;
    run_tile(g, odd ? pp1 : pp0, odd ? p1 : p0, odd ? pp0 : pp1, odd ? p0 : p1, d0 + c * H, H,
             (int)blockIdx.x * T, sb, xch);
    if (c + 1 < n) grid.sync();  // where a launch boundary stood
  }
}

// The launch geometry, or -1 if the kernel refuses it: T, the owned lanes a block.
int chunk_tile(int64_t B, int64_t h, int64_t warps) {
  if (B < 1 || B > 65535 || h < 1 || h > kMaxHalo || warps < 1 || warps > kMaxWarps) return -1;
  const int T = block_lanes((int)warps) - (int)h;
  return T >= 1 ? T : -1;
}

ChunkArgs chunk_args(const void* a_lane, const void* b, int64_t b_stride, int64_t Mb,
                     const void* la, const void* lb, void* result, int64_t W, int64_t i0,
                     int64_t Ma, int64_t H_own, int64_t warps) {
  return ChunkArgs{(const int32_t*)a_lane, (const int32_t*)b, b_stride, (const int32_t*)la,
                   (const int32_t*)lb, (int32_t*)result, (int)Mb, (int)W, (int)i0, (int)Ma,
                   (int)H_own, (int)warps};
}

}  // namespace

// a_lane, src_pp, src_p, dst_pp, dst_p: (B, W) int32; b: (B, >= Mb) int32
// rows b_stride apart; la, lb, result: (B,) int32. Steps h <= 512 diagonals
// from d0 over the tiles of `warps` warps laid from local lane k_first, and
// writes lanes [k_first + h, W) of dst_pp and dst_p (the sub-step of a
// chunk of H_own diagonals that starts at lane k_first; a whole chunk when
// k_first = 0 and h = H_own). Captures on lanes k >= H_own only.
KGT_API int kgt_wavefront_chunk(const void* a_lane, const void* b, int64_t b_stride,
                                int64_t Mb, const void* la, const void* lb,
                                const void* src_pp, const void* src_p, void* dst_pp,
                                void* dst_p, void* result, int64_t B, int64_t W, int64_t i0,
                                int64_t Ma, int64_t d0, int64_t h, int64_t k_first,
                                int64_t H_own, int64_t warps, void* stream) {
  if (B == 0 || W <= k_first + h) return 0;
  const int T = chunk_tile(B, h, warps);
  if (T < 0 || k_first < 0) return (int)cudaErrorInvalidValue;
  const unsigned tiles = (unsigned)((W - k_first - h + T - 1) / T);
  wavefront_chunk_kernel<<<dim3(tiles, (unsigned)B), 32 * (unsigned)warps,
                           chunk_smem((int)warps, (int)h), (cudaStream_t)stream>>>(
      chunk_args(a_lane, b, b_stride, Mb, la, lb, result, W, i0, Ma, H_own, warps),
      (const int32_t*)src_pp, (const int32_t*)src_p, (int32_t*)dst_pp, (int32_t*)dst_p,
      (int)d0, (int)h, (int)k_first, T);
  return kgt_launch_status();
}

// The blocks of kgt_wavefront_chunks the current device holds at once for
// `warps` warps a block and chunks of H diagonals (blocks an SM times the
// SMs; 0 on a device without cooperative launches), or -1 for a geometry
// the kernel refuses. No launch.
KGT_API int kgt_wavefront_chunks_blocks(int64_t warps, int64_t H) {
  if (chunk_tile(1, H, warps) < 0) return -1;
  int device = 0, coop = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess)
    return -1;
  if (!coop) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wavefront_chunks_kernel,
                                                    32 * (int)warps,
                                                    chunk_smem((int)warps, (int)H)) !=
          cudaSuccess)
    return -1;
  return per_sm * sms;
}

// n chunks of H <= 512 diagonals from d0 in one cooperative launch: chunk c
// reads (pp0, p0) and writes (pp1, p1) when c is even, the other way when it
// is odd, so the state ends in (pp1, p1) iff n is odd, where n one-chunk
// launches with swaps between them would leave it. The arguments as
// kgt_wavefront_chunk's with k_first = 0 and H_own = H. A grid over more
// blocks than the card holds at once is refused by the launch.
KGT_API int kgt_wavefront_chunks(const void* a_lane, const void* b, int64_t b_stride,
                                 int64_t Mb, const void* la, const void* lb, void* pp0,
                                 void* p0, void* pp1, void* p1, void* result, int64_t B,
                                 int64_t W, int64_t i0, int64_t Ma, int64_t d0, int64_t H,
                                 int64_t n, int64_t warps, void* stream) {
  if (B == 0 || n == 0 || W <= H) return 0;
  int T = chunk_tile(B, H, warps);
  if (T < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const unsigned tiles = (unsigned)((W - H + T - 1) / T);
  ChunkArgs g = chunk_args(a_lane, b, b_stride, Mb, la, lb, result, W, i0, Ma, H, warps);
  int d0_i = (int)d0, H_i = (int)H, n_i = (int)n;
  void* args[] = {&g, &pp0, &p0, &pp1, &p1, &d0_i, &H_i, &n_i, &T};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      (const void*)wavefront_chunks_kernel, dim3(tiles, (unsigned)B), dim3(32 * (unsigned)warps),
      args, chunk_smem((int)warps, (int)H), (cudaStream_t)stream);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises on the returned code
    return (int)rc;
  }
  return kgt_launch_status();
}
