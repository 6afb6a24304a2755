// Kernel B3: exact Levenshtein distance by full-width bit vectors; and, by
// the same body with a template flag, kernel `local` (kgt_local, below).
//
// Replaces the TPU kernel _levenshtein_kernel (kgl_gene_tpu/ops/
// pallas_edit_distance.py:36, launched by _pallas_call). Per pair it
// computes D[la][lb] of the unit-cost DP over a[0:la] and b[0:lb], exactly,
// for every pair: no band, no contract. Codes are compared as int32 values,
// whatever the alphabet.
//
// Algorithm. The Myers/Hyyro block recurrence of csrc/myers.cu at full
// width: the pattern a is cut into ceil(la / 64) blocks of 64 rows, each
// holding the vertical deltas of one DP column as two 64-bit words (VP,
// VN). One text column updates a block with ~17 word operations and hands
// the horizontal delta of its last row (two bits) to the block below. That
// is 64 DP cells per block step where the anti-diagonal wavefront this
// kernel replaced did one cell per operation, three shared-memory reads
// per cell and a block barrier per diagonal.
//
// Bound on the card: operations, 34 int32 operations per block step over
// Σ ceil(la / 64) * lb block steps; the bytes (the sequences, read once)
// are small beside that. At a few hundred pairs the kernel is far above
// that bound all the same: a pair's block steps form a dependent chain
// (each needs the carry of the block above and its own previous column),
// so a pair costs (lb + 63) * ceil(la / 4096) steps on one warp however
// many SMs idle. With thousands of pairs it is bound by the rate the SMs
// dispatch at: ~75 SASS operations a block step where the count above
// has 34.
//
// Design: one warp per pair, and the block is that warp, so no
// __syncthreads anywhere and a pair that ends early stalls nobody. The
// blocks of a pair are spread over the lanes: lane t holds K blocks at
// once (K = 1 up to 2,048 rows, else 2), block 32 k + t in slot k, their
// VP/VN in registers, and at step s slot k works on text column
// s - t - 32 k. The carry bits and the text symbol come from the lane
// above by a rotating __shfl_sync, lane 0's slot k taking what lane 31's
// slot k - 1 left: a systolic skew over 32 K blocks, lb + 32 K - 1 steps.
// A warp alone on its scheduler runs in program order, so a step costs
// what the latencies of its operations add up to; the K recurrences of a
// lane are independent, the loop body has no branch between them (idle
// slots are switched off by selects), and the compiler interleaves them.
// Patterns
// above 2,048 K rows go in stripes of 32 K blocks: lane 31's last slot
// leaves its carries in shared memory, one byte a column, and lane 0
// reads them in the next stripe (two buffers, one __syncwarp per stripe;
// stripe 0 reads +1 everywhere, D[0][j] - D[0][j-1]). Lane 0 takes its
// symbol from a 32-column chunk of b that the warp loads coalesced 32
// steps ahead (b is read once per warp, also when it is the one row
// shared by all pairs). Nothing follows row la column by column: after
// column lb each block's VP/VN hold that column's vertical deltas, so
// D[la][lb] = lb + sum over rows <= la of (VP - VN), two popcounts a
// block and one warp reduction at the end.
//
// Equality over all int32 codes. Match words Peq[c][block] for symbols
// 0 <= c < SIGMA (32: DNA5 and the amino codes) are built once per pair in
// shared memory, 32 rows at a time with __match_any_sync (the first lane
// of each group of equal codes stores the group's mask as half a word).
// For any other text symbol (negative, >= SIGMA) the lane builds the match
// word on the spot from its block's 64 pattern codes: slow, rare, exact.
// Rows >= la match nothing. Shared memory: SIGMA * 8 bytes per pattern
// block (padded to an odd block count against bank conflicts) plus 2
// bytes per text column; 18.2 KB at 3 kb, so 12 pairs an SM; above 48 KB
// as dynamic shared memory (ops/wavefront.py checks the 227 KB limit).
// Lengths are clamped to the array widths; la = 0 or lb = 0 returns la + lb.
#include <type_traits>

#include "common.cuh"

typedef unsigned long long u64;

// Symbols with a match word in shared memory: SIGMA in the layout of a pair
// a warp, SIGMA_GROUP (DNA5: A C G T N = 0..4) in kernel `local`'s group layout.
constexpr int SIGMA = 32;
constexpr int SIGMA_GROUP = 5;
constexpr unsigned FULL = 0xffffffffu;

// Match word of block `blk` against symbol c, from the pattern itself.
__device__ u64 match_word(const int32_t* __restrict__ ap, int la, int blk,
                          int c) {
  u64 eq = 0;
  const int base = blk * 64;
  const int end = min(64, la - base);
  for (int r = 0; r < end; ++r)
    eq |= (u64)(__ldg(ap + base + r) == c) << r;
  return eq;
}

// The same for kernel `local`, whose pattern starts with `pad` rows that
// match every symbol: bit r of block blk is padded row 64 blk + r, which is
// query row 64 blk + r - pad.
__device__ u64 match_word_padded(const int32_t* __restrict__ ap, int la, int blk,
                                 int c, int pad) {
  u64 eq = 0;
  const int base = blk * 64 - pad;
  const int end = min(64, la - base);
  for (int r = 0; r < end; ++r)
    eq |= (u64)(base + r < 0 || __ldg(ap + base + r) == c) << r;
  return eq;
}

// HW = false: kernel B3 as described above. HW = true: the local (infix,
// edlib HW mode) distance of kernel `local`, described at kgt_local below.
// G = 32 is the layout described above, a pair a warp; G < 32 is kernel
// `local`'s group layout (G lanes a pair, 32 / G pairs a warp, one stripe),
// also described at kgt_local.
template <int G, int K, bool HW>  // G: lanes a pair, K: 64-row blocks a lane holds at once
__global__ void __launch_bounds__(32)
bitvector_kernel(const int32_t* __restrict__ a, int64_t a_stride, int Wa,
                 const int32_t* __restrict__ b, int64_t b_stride, int Wb,
                 const int32_t* __restrict__ la_arr,
                 const int32_t* __restrict__ lb_arr,
                 int32_t* __restrict__ out, int nblk_pad, int hstride, int B) {
  constexpr bool GROUPED = G < 32;
  static_assert(G == 32 || (HW && G >= 2 && G * K <= 64), "the group layout is local's, one stripe");
  constexpr int P = 32 / G;                            // pairs a warp
  constexpr int ROWS = GROUPED ? SIGMA_GROUP : SIGMA;  // match words a block in shared memory
  constexpr int SPAN = G * K;                          // slots a stripe
  extern __shared__ u64 smem[];
  const int lane = threadIdx.x;
  const int grp = GROUPED ? lane / G : 0;
  const int t = GROUPED ? lane - grp * G : lane;  // my lane in the group
  const int p0 = GROUPED ? blockIdx.x * P : blockIdx.x;
  // Lanes past the warp's last group, or past the last pair, run with the
  // group's lanes on pair p0's shared memory, no column of theirs live.
  const bool has = !GROUPED || (grp < P && p0 + grp < B);
  const int p = has ? p0 + grp : p0;
  u64* peq = smem + (size_t)(has ? grp : 0) * ROWS * nblk_pad;  // [ROWS][nblk_pad]
  // G = 32: [2][hstride]; G < 32: [hstride], the carries of row lq
  uint8_t* hbytes = (uint8_t*)(smem + (size_t)P * ROWS * nblk_pad) +
                    (size_t)(has ? grp : 0) * (GROUPED ? 1 : 2) * hstride;
  const int la0 = min(max(la_arr[p], 0), Wa);
  const int lb0 = min(max(lb_arr[p], 0), Wb);
  // HW: the shorter sequence is the pattern (a keeps it on a tie).
  const bool swap = HW && la0 > lb0;
  const int la = swap ? lb0 : la0;
  const int lb = swap ? la0 : lb0;
  if constexpr (!GROUPED) {
    if (la == 0 || lb == 0) {
      if (lane == 0) out[p] = HW ? 0 : la + lb;  // HW: an empty query matches
      return;
    }
  }
  // G < 32: a group keeps running, its columns dead, for an empty query or
  // without a pair (the warp's shuffles take every lane); lb_run = 0.
  const int lb_run = GROUPED && !(has && la > 0) ? 0 : lb;
  const int32_t* ap = swap ? b + p * b_stride : a + p * a_stride;
  const int32_t* bp = swap ? a + p * a_stride : b + p * b_stride;
  const int nblk = (la + 63) >> 6;

  for (int i = lane; i < P * ROWS * nblk_pad; i += 32) smem[i] = 0ull;
  if constexpr (!GROUPED) {
    // Carries into stripe 0: D[0][j] - D[0][j-1], +1 for every column (HW: 0).
    const uint32_t top = HW ? 0u : 0x01010101u;
    for (int i = lane; i < hstride / 4; i += 32) ((uint32_t*)hbytes)[i] = top;
  }
  __syncwarp();
  // HW: pad rows ahead of the query put its last row at bit 63.
  const int pad = HW ? -la & 63 : 0;
  const u64 pad_rows = (1ull << pad) - 1;
  // HW: the match words of the query `row` (lq rows after pd pad rows) into
  // pq, 32 rows a __match_any_sync, then the pad rows' bits in every word.
  auto build = [&](u64* pq, const int32_t* row, int lq, int pd) {
    uint32_t* pq32 = (uint32_t*)pq;
    for (int q = 0; q * 32 < lq + pd; ++q) {
      const int i = q * 32 + lane - pd;
      const bool in = i >= 0 && i < lq;
      const int c = in ? __ldg(row + i) : -1;
      const unsigned m = __match_any_sync(FULL, c);
      if (in && (unsigned)c < (unsigned)ROWS && __ffs(m) - 1 == lane)
        pq32[((size_t)c * nblk_pad + (q >> 1)) * 2 + (q & 1)] = m;
    }
    __syncwarp();
    if (ROWS == 32 || lane < ROWS) pq[lane * nblk_pad] |= (1ull << pd) - 1;  // a lane a symbol
  };
  if constexpr (GROUPED) {
    // The warp builds its pairs' words one pair after the other.
    for (int g = 0; g < P && p0 + g < B; ++g) {
      const int qa = min(max(la_arr[p0 + g], 0), Wa), qb = min(max(lb_arr[p0 + g], 0), Wb);
      const int lq = min(qa, qb);
      build(smem + (size_t)g * ROWS * nblk_pad,
            qa > qb ? b + (p0 + g) * b_stride : a + (p0 + g) * a_stride, lq, -lq & 63);
    }
  } else if constexpr (HW) {
    build(peq, ap, la, pad);
  } else {
    uint32_t* peq32 = (uint32_t*)peq;
    for (int q = 0; q * 32 < la; ++q) {
      const int i = q * 32 + lane;
      const int c = i < la ? __ldg(ap + i) : -1;
      const unsigned m = __match_any_sync(FULL, c);
      if (i < la && (unsigned)c < (unsigned)SIGMA && __ffs(m) - 1 == lane)
        peq32[((size_t)c * nblk_pad + (q >> 1)) * 2 + (q & 1)] = m;
    }
  }
  __syncwarp();

  const int la_blk = (la - 1) >> 6;
  const int la_pos = (la - 1) & 63;
  const u64 la_rows = ~0ull >> (63 - la_pos);  // rows <= la of la_blk
  // The lane above: G = 32 rotates over the warp (lane 31 for lane 0), G < 32
  // within the group (its last lane for its lane 0).
  const int src = GROUPED ? (t ? lane - 1 : lane + G - 1) : (lane + 31) & 31;
  // HW: `off` idle slots ahead of block 0 (they pass on the zero top carry
  // and the symbols) put the last block in the group's last lane's last
  // slot of the last stripe, whose carries the stripe store below keeps:
  // row la's deltas. G < 32: nblk <= SPAN, and an empty query's slots all
  // lie ahead of block 0.
  const int off = HW ? (GROUPED ? SPAN - nblk : (SPAN - nblk % SPAN) % SPAN) : 0;
  const int vblk = GROUPED ? SPAN : nblk + off;  // slots the stripes cover
  int total = 0;  // sum of my blocks' vertical deltas down column lb
  for (int r = 0, blk0 = 0; blk0 < vblk; ++r, blk0 += SPAN) {
    const int nact = min(SPAN, vblk - blk0);
    // A stripe below reads my carries; HW: the scan reads the last's.
    const bool keeps = t == G - 1 && (HW || blk0 + SPAN < vblk);
    const uint8_t* hin = hbytes + (r & 1) * hstride;
    uint8_t* hout = GROUPED ? hbytes : hbytes + ((r + 1) & 1) * hstride;
    // Slot k of group lane t is block blk0 + G k + t - off, at step s on
    // column s - t - G k.
    int lb_mine[K], blk[K], carry[K], c_mine[K];
    const u64* peq_blk[K];
    u64 vp[K], vn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      blk[k] = blk0 + G * k + t - off;
      // 0 switches an idle slot off (HW: the idle slots lead, blk < 0)
      lb_mine[k] = (HW ? blk[k] >= 0 : blk[k] < nblk) ? lb_run : 0;
      peq_blk[k] = peq + (HW ? max(blk[k], 0) : min(blk[k], nblk - 1));
      vp[k] = HW && blk[k] == 0 ? ~pad_rows : ~0ull;  // pad rows: D[i][0] = 0
      vn[k] = 0ull;
      carry[k] = 0;   // bit 0: ph_out, bit 1: mh_out of the slot's last column
      c_mine[k] = 0;  // the symbol of the slot's last column
    }
    int chunk = 0;
    int ahead = t < lb_run ? __ldg(bp + t) : 0;  // the next G columns of b
    int steps = lb_run + nact - 1;
    if constexpr (GROUPED) steps = __reduce_max_sync(FULL, lb_run > 0 ? steps : 0);
    for (int s = 0; s < steps; ++s) {
      const int u = (unsigned)s % G;
      if (u == 0) {  // loaded G steps ahead of its first use
        chunk = ahead;
        ahead = s + G + t < lb_run ? __ldg(bp + s + G + t) : 0;
      }
      const int c0 = __shfl_sync(FULL, chunk, grp * G + u);
      // One address for the warp; s < hstride. G < 32: one stripe, top carry 0.
      const int h0 = GROUPED ? 0 : hin[s];
      int c_up[K], h_up[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c_up[k] = __shfl_sync(FULL, c_mine[k], src);
        h_up[k] = __shfl_sync(FULL, carry[k], src);
      }
      bool odd = false;  // a live slot met a symbol without a match word
      u64 eq[K];
      int h[K];
      bool live[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // The group's lane 0's slot k continues its last lane's slot k - 1.
        const int c = t ? c_up[k] : k ? c_up[k > 0 ? k - 1 : 0] : c0;
        h[k] = t ? h_up[k] : k ? h_up[k > 0 ? k - 1 : 0] : h0;
        c_mine[k] = c;
        live[k] = (unsigned)(s - t - G * k) < (unsigned)lb_mine[k];
        const bool known = (unsigned)c < (unsigned)ROWS;
        eq[k] = peq_blk[k][(known ? c : 0) * nblk_pad];
        odd |= live[k] && !known;
      }
      if (__any_sync(FULL, odd)) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (live[k] && (unsigned)c_mine[k] >= (unsigned)ROWS)
            eq[k] = HW ? match_word_padded(ap, la, blk[k], c_mine[k], pad)
                       : match_word(ap, la, blk[k], c_mine[k]);
      }
      // No branch below: the K recurrences are independent and interleave.
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const u64 ph_in = (u64)(h[k] & 1), mh_in = (u64)(h[k] >> 1);
        const u64 xv = eq[k] | vn[k];
        const u64 eq2 = eq[k] | mh_in;
        const u64 xh = (((eq2 & vp[k]) + vp[k]) ^ vp[k]) | eq2;
        u64 ph = vn[k] | ~(xh | vp[k]);
        u64 mh = vp[k] & xh;
        const int carry_out = (int)(ph >> 63) | ((int)(mh >> 63) << 1);
        ph = (ph << 1) | ph_in;
        mh = (mh << 1) | mh_in;
        vp[k] = live[k] ? mh | ~(xv | ph) : vp[k];
        vn[k] = live[k] ? ph & xv : vn[k];
        carry[k] = live[k] ? carry_out : carry[k];
      }
      if (keeps && live[K - 1]) hout[s - (G - 1) - G * (K - 1)] = (uint8_t)carry[K - 1];
    }
    // VP/VN now hold column lb: D[i][lb] - D[i-1][lb] for each slot's rows.
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!HW && blk[k] < nblk) {
        const u64 rows = blk[k] < la_blk ? ~0ull : la_rows;
        total += __popcll(vp[k] & rows) - __popcll(vn[k] & rows);
      }
    }
    __syncwarp();
  }
  if constexpr (GROUPED) {
    // The scan of each group's carries, G columns at a time: a prefix sum
    // over the group's lanes by shuffles from lane t - o, then the group's
    // minimum by a cyclic tree (min is idempotent, overlaps do not matter).
    int run = la, best = la;
    const int cols = __reduce_max_sync(FULL, lb_run);
    for (int c0 = 0; c0 < cols; c0 += G) {
      const int h = c0 + t < lb_run ? hbytes[c0 + t] : 0;
      int d = (h & 1) - (h >> 1);
#pragma unroll
      for (int o = 1; o < G; o <<= 1) {
        const int v = __shfl_sync(FULL, d, lane - o);
        d += t >= o ? v : 0;
      }
      best = min(best, run + d);  // past lb, d repeats column lb's sum
      run += __shfl_sync(FULL, d, grp * G + G - 1);
    }
#pragma unroll
    for (int o = 1; o < G; o <<= 1)
      best = min(best, __shfl_sync(FULL, best, grp * G + (t + o) % G));
    if (has && t == 0) out[p] = best;  // an empty query: la = best = 0
  } else if constexpr (HW) {
    // D[la][j] = la + the deltas of columns 1..j, and the answer is its
    // minimum over j = 0..lb: a warp scan of 32 columns at a time.
    const uint8_t* hl = hbytes + (vblk / SPAN & 1) * hstride;  // the last stripe's hout
    int run = la, best = la;
    for (int c0 = 0; c0 < lb; c0 += 32) {
      const int h = c0 + lane < lb ? hl[c0 + lane] : 0;
      int d = (h & 1) - (h >> 1);
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, d, off);
        d += lane >= off ? v : 0;
      }
      best = min(best, run + d);  // past lb, d repeats column lb's sum
      run += __shfl_sync(FULL, d, 31);
    }
    for (int off = 16; off > 0; off >>= 1) best = min(best, __shfl_xor_sync(FULL, best, off));
    if (lane == 0) out[p] = best;
  } else {
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(FULL, total, off);
    if (lane == 0) out[p] = lb + total;  // D[0][lb] plus the deltas down to row la
  }
}

// Shared memory of one block (one warp): G = 32, SIGMA match words for each
// pattern block (the block count padded to odd against bank conflicts) and
// two buffers of a carry byte a text column; G < 32, for each of the warp's
// 32 / G pairs SIGMA_GROUP match words a block and one buffer of lt bytes.
// Wp: the widest pattern a pair can have, Wt: the widest text.
static int bitvector_nblk_pad(int64_t Wp) {
  return (int)((Wp + 63) / 64 > 0 ? (Wp + 63) / 64 : 1) | 1;
}

static int bitvector_hstride(int G, int K, int64_t Wt) {
  return (int)((Wt + (G < 32 ? 0 : 32 * K) + 15) / 16 * 16);
}

static size_t bitvector_smem(int G, int K, int64_t Wp, int64_t Wt) {
  const size_t pairs = 32 / G, rows = G < 32 ? SIGMA_GROUP : SIGMA;
  return pairs * (rows * bitvector_nblk_pad(Wp) * sizeof(u64) +
                  (G < 32 ? 1 : 2) * (size_t)bitvector_hstride(G, K, Wt));
}

template <int G, int K, bool HW>
static int launch_bitvector(const void* a, int64_t a_stride, int64_t Wa,
                            const void* b, int64_t b_stride, int64_t Wb,
                            const void* la, const void* lb, void* out,
                            int64_t B, int64_t Wp, int64_t Wt, cudaStream_t stream) {
  constexpr int P = 32 / G;
  const size_t smem = bitvector_smem(G, K, Wp, Wt);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bitvector_kernel<G, K, HW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bitvector_kernel<G, K, HW><<<(unsigned)((B + P - 1) / P), 32, smem, stream>>>(
      (const int32_t*)a, a_stride, (int)Wa, (const int32_t*)b, b_stride,
      (int)Wb, (const int32_t*)la, (const int32_t*)lb, (int32_t*)out,
      bitvector_nblk_pad(Wp), bitvector_hstride(G, K, Wt), (int)B);
  return kgt_launch_status();
}

// a: (B, Wa) int32 rows a_stride apart; b: (B or 1, Wb) int32 rows
// b_stride apart (0 = one b shared by every pair); la, lb, out: (B,) int32.
KGT_API int kgt_wavefront(const void* a, int64_t a_stride, int64_t Wa,
                          const void* b, int64_t b_stride, int64_t Wb,
                          const void* la, const void* lb, void* out,
                          int64_t B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // Up to 2,048 rows one block a lane covers the pattern in one stripe.
  if (Wa <= 2048)
    return launch_bitvector<32, 1, false>(a, a_stride, Wa, b, b_stride, Wb, la, lb, out, B,
                                          Wa, Wb, s);
  return launch_bitvector<32, 2, false>(a, a_stride, Wa, b, b_stride, Wb, la, lb, out, B,
                                        Wa, Wb, s);
}

// Kernel `local`: the local (infix, edlib HW mode) distance.
//
// Replaces the device loop of the local metric, _batched_local_impl
// (kgl_gene_tpu/ops/edit_distance.py:89, a lax.scan at :132 that XLA runs
// outside any Pallas kernel). Per pair the shorter sequence q (a on a tie)
// is aligned against any substring of the longer t: D[0][j] = 0 for every
// column, D[i][0] = i, and the answer is min over j = 0..lt of D[lq][j];
// lq = 0 gives 0. It is the reference's symmetric Pf gene-family metric
// (kgl_sequence_distance_impl.cpp:46-76).
//
// The body is B3's (bitvector_kernel<G, K, true>; items (4) and (5) as in
// the layout of a pair a warp, G = 32), with these changes: (1)
// the kernel picks q and t per pair by swapping the two rows' pointers and
// lengths, so q's match words fill Peq; (2) stripe 0 reads a zero carry,
// D[0][j] - D[0][j-1] = 0; (3) q is preceded by pad = -lq mod 64 rows that
// match every symbol (their bits set in every match word, also the ones
// built on the spot) and whose column-0 deltas are 0 (VP and VN clear).
// Those rows repeat the zero top row, so row pad + i is row i of the HW
// table, and row lq lands on bit 63 of the last block: its horizontal
// delta in each column is the carry that block hands down anyway; (4)
// -nblk mod 32 K idle slots ahead of block 0 (they hand on the zero top
// carry and the symbols, and cost as many steps) put the last block in
// lane 31's last slot, whose carries B3 already stores a byte a column
// for the stripe below: the last stripe stores them too, into the buffer
// no stripe reads, so the scan adds no instruction to a step; (5) after
// the scan the warp takes min over j of lq + the prefix sums of those
// deltas, 32 columns a warp scan; (6) lq = 0 returns 0. The
// pads past lt never enter the minimum: a slot's column is live only
// while it is < lt. Equality over all int32 codes, the shared-memory
// layout and MAX_KERNEL_LEN are B3's, with the pattern's width min(Wa, Wb)
// and the text's max(Wa, Wb). B3's instantiations (G = 32, HW = false)
// compile to the code they were before the group layout (the same SASS).
//
// Bound on the card: operations, as B3: 34 int32 operations a block step
// over sum ceil(lq / 64) * lt block steps. Issue-bound at many pairs, a
// dependent chain of (lt + 63) * ceil(lq / 4096) steps a pair at few. The
// first design tracked row lq in every slot (a variable 64-bit shift of Ph
// and Mh, a select, an add and a min a slot and step) and took 1.25x B3's
// time over 32,640 pairs of 3 kb on an NVIDIA H100 80GB HBM3 at 700 W
// (22.4 ms against 17.9 ms, chip_smoke.py); the owner slot storing its
// carry by a predicated byte store a step also ran well above B3. The
// layout of a pair a warp then took 19.0 ms against B3's 17.9 in the same
// windows, 1.06x (the same card and script).
//
// Group layout (G < 32). At many pairs the kernel is bound by the SMs'
// integer pipe (16 lanes a scheduler), and every slot costs its issue
// whether its block is live or not: a pair a warp holds 32 K slots, so a
// 2,181-row gene (35 blocks, K = 2) issues 64 slots a step for 35 live ones,
// 53%, and the per-step work (the symbol shuffle, the carry load, the vote,
// the loop) is shared by K = 2 slots. The group layout, as B1's group body
// (csrc/myers.cu), gives a pair a group of G lanes of K slots each, 32 / G
// pairs a warp: slot k of group lane t is block G k + t, on text column
// s - t - G k at step s, the carries and symbols from group lane t - 1 by a
// shuffle with an explicit source, the group's lane 0 slot k taking what its
// last lane's slot k - 1 left. G K >= the pattern's blocks, so one stripe:
// the top carry is 0 and needs no buffer, and `off` = G K - nblk idle slots
// lead. The warp steps to its longest pair; each group scans its own
// carries, G columns at a time. The layouts are the instantiations below;
// ops/local.py (local_layout) takes the one with the largest live share
// nblk (32 / G) / (32 K) at the pattern's width, so kelch13's 35 blocks run
// at (5, 7): 6 pairs a warp, 93.8% of the slots live. Shared memory is per
// warp, 32 / G pairs of it: the match words keep SIGMA_GROUP = 5 rows a
// block, so DNA5 (A C G T N = 0..4, what every caller passes) runs at full
// speed and every other code takes the exact word built on the spot
// (match_word_padded); one carry buffer of lt bytes a pair. At 2,181 bases
// that is 21,552 bytes a warp, 10 warps an SM (128 registers). Over 32,640
// pairs of 2,181 bases on an NVIDIA H100 80GB HBM3 at 700 W: 9.07 ms on the
// device against 13.54 for the layout of a pair a warp, and 14.55 against
// 18.98 at 3,000 bases ((8, 6); scripts/torch_kernel_bodies.py). With few
// pairs the layout of a pair a warp spreads them further over the card:
// ops/local.py keeps it below GROUP_MIN_PAIRS pairs, up to 2,048 rows (no
// group layout has a larger live share) and above 4,096 rows (stripes).

// Calls f(G, K) as integral constants for a layout kernel `local` is
// instantiated at; -1 for any other.
template <class F>
static int with_local_layout(int64_t G, int64_t K, F&& f) {
  using std::integral_constant;
  switch (G * 100 + K) {
    case 3201: return f(integral_constant<int, 32>(), integral_constant<int, 1>());
    case 3202: return f(integral_constant<int, 32>(), integral_constant<int, 2>());
    case 507: return f(integral_constant<int, 5>(), integral_constant<int, 7>());
    case 606: return f(integral_constant<int, 6>(), integral_constant<int, 6>());
    case 806: return f(integral_constant<int, 8>(), integral_constant<int, 6>());
    default: return -1;
  }
}

// G, K: the layout (G lanes a pair, K blocks a lane), one of
// with_local_layout's, chosen by ops/local.py::local_layout.
KGT_API int kgt_local(const void* a, int64_t a_stride, int64_t Wa,
                      const void* b, int64_t b_stride, int64_t Wb,
                      const void* la, const void* lb, void* out,
                      int64_t B, int64_t G, int64_t K, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t Wp = Wa < Wb ? Wa : Wb, Wt = Wa < Wb ? Wb : Wa;
  if (G < 32 && G * K * 64 < Wp) return (int)cudaErrorInvalidValue;  // one stripe
  const int e = with_local_layout(G, K, [&](auto g, auto k) {
    return launch_bitvector<decltype(g)::value, decltype(k)::value, true>(
        a, a_stride, Wa, b, b_stride, Wb, la, lb, out, B, Wp, Wt, s);
  });
  return e < 0 ? (int)cudaErrorInvalidValue : e;
}

// Kernel `local` at layout (G, K) and widths (Wa, Wb) on the current
// device: out[0] blocks (a warp each) one SM holds, out[1] registers a
// thread, out[2] local-memory bytes a thread (spills); -1 for a layout it
// lacks. Launches nothing.
KGT_API int kgt_local_resources(int64_t G, int64_t K, int64_t Wa, int64_t Wb, void* out) {
  const int64_t Wp = Wa < Wb ? Wa : Wb, Wt = Wa < Wb ? Wb : Wa;
  return with_local_layout(G, K, [&](auto g, auto k) {
    auto kern = bitvector_kernel<decltype(g)::value, decltype(k)::value, true>;
    const size_t smem = bitvector_smem(g, k, Wp, Wt);
    int n = 0;
    cudaFuncAttributes attr;
    if ((smem > 48 * 1024 &&
         cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, 32, smem) ||
        cudaFuncGetAttributes(&attr, kern))
      return (int)cudaGetLastError();
    int64_t* o = (int64_t*)out;
    o[0] = n;
    o[1] = attr.numRegs;
    o[2] = (int64_t)attr.localSizeBytes;
    return 0;
  });
}
