// Kernel B1: banded Levenshtein by the Myers/Hyyro bit-vector recurrence.
//
// Replaces the TPU kernel _myers_kernel (kgl_gene_tpu/ops/pallas_myers.py:74,
// launched by _myers_call). The pattern a (rows, length la) is cut into
// 64-row blocks held as one 64-bit word per block for each of the vertical
// +1/-1 deltas (VP, VN); each text column j = 1..lb updates the blocks of a
// band window with the block recurrence of edlib's calculateBlock, and the
// value of row la is tracked across columns from the horizontal deltas.
//
// Band window. The window is NB = 2*shift + 1 blocks, shift = ceil(k/64),
// and covers blocks wb .. wb + NB - 1 with wb = max(0, g - shift) for the
// 64-column chunk g that holds column j. That keeps rows j - k .. j + k in
// the window for every column, so the standard banded-DP argument holds:
// a block entering at the bottom starts in its init state (VP = ~0, i.e.
// vertical deltas +1), the carry into the top block is +1 (the exact row-0
// boundary while wb = 0, an overestimate after), every computed cell is
// >= the true value, and cells on an optimal path that stays inside the
// band are exact. Exactness contract, as on the TPU: the result is >= the
// true distance and equal to it iff result <= k and |la - lb| <= k; pairs
// with |la - lb| > k return max(la, lb). The 64-row words make the window
// wider than the TPU's 32-row one, so values OUTSIDE the contract may
// differ from the JAX kernel's; the plain version in ops/myers.py uses this
// same layout and agrees with this kernel bit for bit everywhere. Codes are
// DNA5 (0..4); any other code matches nothing. Lengths are clamped to the
// array widths.
//
// Bound on the card: operations, about 34 int32 operations per (pair,
// column, block). What holds a launch back depends on its size, so there
// are two bodies, chosen in kgt_myers from the shapes alone (group_body_fits):
//
// Group body (myers_group_kernel), for launches that one thread a pair does
// not fill the card with: the forward step's 256 to 4,096 pairs against
// one shared text, and up to 32,768 pairs at the narrow bands. There the
// time is one pair's dependence chain, not the card's rate. A pair belongs
// to a group of NB lanes of a warp (10, 6, 3 or 1 pairs a warp for NB = 3,
// 5, 9, 17), one warp a thread block, so that a few hundred pairs spread
// over all SMs. Block beta of the pattern lives in lane beta mod NB of its
// group for as long as it is in the window. A step is eight text columns
// of one block: at step s block beta takes columns 8 (s - beta) .. + 7
// through its words one after the other, with the eight horizontal carries
// of block beta - 1, made one step earlier, from the lane before it by one
// __shfl_sync. So the chain costs a block step a column and one shuffle,
// one liveness test and one loop turn every eight, and a pair lb / 8 +
// wb_last + NB - 1 steps instead of lb * NB block steps in a row. The
// window's edges are multiples of 64 columns, so a step is wholly inside
// or outside a block's columns but for the pair's last one, which a
// rarely taken branch redoes column by column. The ownership rotates, so
// the sliding window moves no state: when block beta leaves the window at
// the top (after column 64 (beta + shift + 1)), its lane idles NB steps
// and re-enters as block beta + NB in the init state; the block at the top
// of the window takes the constant +1 carries. The Peq
// words are built once per pair, 32 rows a load and one ballot a symbol,
// into shared memory (6 words a block: DNA5 and an all-zero slot), where a
// lane fetches its words by loads off the carry chain; the text symbols are
// loaded two steps ahead. Nothing follows row la column by column: D[la][lb]
// is read down column lb at the end, as lb (the window's top gains +1 a
// column) plus the vertical deltas of every row <= la, two popcounts for
// each block where it stopped (when it left the window, or in column lb)
// and +1 for each row of a block the window never reached. That is the sum
// the plain version's horizontal deltas of row la add up to, in and out of
// the exactness contract, because the window's cells, its +1 top and its
// init-state blocks are one consistent matrix of deltas.
//
// Thread body (myers_kernel), for launches with more pairs than that: one
// thread per pair, as edlib runs one pair per core, the window a loop
// inside the thread held in registers. There the card is bound by the rate
// it issues integer operations at, every lane works in every step, and
// spreading a pair over lanes only adds the shuffle and the skew.
#include <climits>

#include "common.cuh"

typedef unsigned long long u64;

__device__ __forceinline__ void build_peq(const int32_t* __restrict__ row,
                                          int la, int blk, u64 w[5]) {
  u64 w0 = 0, w1 = 0, w2 = 0, w3 = 0, w4 = 0;
  const int base = blk * 64;
  const int end = min(64, la - base);
  for (int r = 0; r < end; ++r) {
    const int c = __ldg(row + base + r);
    const u64 bit = 1ull << r;
    w0 |= c == 0 ? bit : 0ull;
    w1 |= c == 1 ? bit : 0ull;
    w2 |= c == 2 ? bit : 0ull;
    w3 |= c == 3 ? bit : 0ull;
    w4 |= c == 4 ? bit : 0ull;
  }
  w[0] = w0; w[1] = w1; w[2] = w2; w[3] = w3; w[4] = w4;
}

template <int NB>
__global__ void myers_kernel(const int32_t* __restrict__ a, int64_t a_stride,
                             int Wa, const int32_t* __restrict__ text,
                             int64_t text_stride, int Wt,
                             const int32_t* __restrict__ la_arr,
                             const int32_t* __restrict__ lb_arr,
                             int32_t* __restrict__ out, int B, int band_k) {
  constexpr int SHIFT = (NB - 1) / 2;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int la = min(max(la_arr[p], 0), Wa);
  const int lb = min(max(lb_arr[p], 0), Wt);
  const int32_t* row = a + p * a_stride;
  const int32_t* tp = text + p * text_stride;

  u64 vp[NB], vn[NB], peq[NB][5];
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    vp[t] = ~0ull;
    vn[t] = 0ull;
    build_peq(row, la, t, peq[t]);
  }
  // Row la lives in block la_blk at bit la_bit; la = 0 is row 0, above
  // every block.
  const int la_blk = la > 0 ? (la - 1) >> 6 : -1;
  const u64 la_bit = la > 0 ? 1ull << ((la - 1) & 63) : 0ull;
  int score = la;  // D[la][0]
  int wb = 0;
  for (int j0 = 0; j0 < lb; j0 += 64) {
    if ((j0 >> 6) > SHIFT) {  // slide the window one block down
#pragma unroll
      for (int t = 0; t < NB - 1; ++t) {
        vp[t] = vp[t + 1];
        vn[t] = vn[t + 1];
#pragma unroll
        for (int s = 0; s < 5; ++s) peq[t][s] = peq[t + 1][s];
      }
      ++wb;
      vp[NB - 1] = ~0ull;
      vn[NB - 1] = 0ull;
      build_peq(row, la, wb + NB - 1, peq[NB - 1]);
    }
    const int slot = la_blk - wb;
    const int jend = min(64, lb - j0);
    for (int r = 0; r < jend; ++r) {
      const int c = __ldg(tp + j0 + r);
      u64 ph_in = 1ull, mh_in = 0ull, ph_sel = 0ull, mh_sel = 0ull;
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        const u64 eq = c == 0 ? peq[t][0] : c == 1 ? peq[t][1]
                     : c == 2 ? peq[t][2] : c == 3 ? peq[t][3]
                     : c == 4 ? peq[t][4] : 0ull;
        const u64 pv = vp[t], mv = vn[t];
        const u64 xv = eq | mv;
        const u64 eq2 = eq | mh_in;
        const u64 xh = (((eq2 & pv) + pv) ^ pv) | eq2;
        u64 ph = mv | ~(xh | pv);
        u64 mh = pv & xh;
        if (t == slot) {  // pre-shift deltas of row la's block
          ph_sel = ph;
          mh_sel = mh;
        }
        const u64 ph_out = ph >> 63, mh_out = mh >> 63;
        ph = (ph << 1) | ph_in;
        mh = (mh << 1) | mh_in;
        vp[t] = mh | ~(xv | ph);
        vn[t] = ph & xv;
        ph_in = ph_out;
        mh_in = mh_out;
      }
      int delta;
      if (slot < 0) {
        delta = 1;  // row la above the window: only la = 0 reaches here in band
      } else if (slot < NB) {
        delta = (int)((ph_sel & la_bit) != 0) - (int)((mh_sel & la_bit) != 0);
      } else {
        delta = (int)ph_in - (int)mh_in;  // below: chains from the window's bottom
      }
      score += delta;
    }
  }
  if (abs(la - lb) > band_k) score = max(la, lb);
  out[p] = score;
}

// The group body: see the note at the head of this file.
template <int NB>
__global__ void __launch_bounds__(32)
myers_group_kernel(const int32_t* __restrict__ a, int64_t a_stride, int Wa,
                   const int32_t* __restrict__ text, int64_t text_stride,
                   int Wt, const int32_t* __restrict__ la_arr,
                   const int32_t* __restrict__ lb_arr,
                   int32_t* __restrict__ out, int B, int band_k, int nblk) {
  constexpr int SHIFT = (NB - 1) / 2;
  constexpr int PPW = 32 / NB;  // pairs a warp holds
  constexpr int COLS = 8;            // text columns a step
  constexpr int TOP_CARRY = 0x5555;  // ph_in = 1, mh_in = 0 in each of COLS columns
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ u64 smem[];  // [PPW][6][nblk] Peq words, slot 5 all zero
  const int lane = threadIdx.x;
  const int grp = lane / NB;
  const int l = lane - grp * NB;
  const int p0 = blockIdx.x * PPW;

  for (int i = lane; i < PPW * 6 * nblk; i += 32) smem[i] = 0ull;
  __syncwarp();
  // Peq words: the warp reads a pair's pattern 32 rows a load, PEQ_LOADS
  // loads in flight; one ballot a symbol gives the 32 rows' match bits, and
  // lane s stores symbol s's as half a word.
  uint32_t* peq32 = (uint32_t*)smem;
  const int npairs = min(PPW, B - p0);
  constexpr int PEQ_LOADS = 16;
  for (int g = 0; g < npairs; ++g) {
    const int la_g = min(max(la_arr[p0 + g], 0), Wa);
    const int32_t* row = a + (p0 + g) * a_stride;
    uint32_t* words = peq32 + ((size_t)g * 6 + min(lane, 4)) * nblk * 2;
    for (int q0 = 0; q0 * 32 < la_g; q0 += PEQ_LOADS) {
      int c[PEQ_LOADS];
#pragma unroll
      for (int u = 0; u < PEQ_LOADS; ++u) {
        const int i = (q0 + u) * 32 + lane;
        c[u] = i < la_g ? __ldg(row + i) : -1;  // rows >= la match nothing
      }
#pragma unroll
      for (int u = 0; u < PEQ_LOADS; ++u) {
        const unsigned m0 = __ballot_sync(FULL, c[u] == 0);
        const unsigned m1 = __ballot_sync(FULL, c[u] == 1);
        const unsigned m2 = __ballot_sync(FULL, c[u] == 2);
        const unsigned m3 = __ballot_sync(FULL, c[u] == 3);
        const unsigned m4 = __ballot_sync(FULL, c[u] == 4);
        const unsigned m = lane == 0 ? m0 : lane == 1 ? m1 : lane == 2 ? m2 : lane == 3 ? m3 : m4;
        if (lane < 5 && (q0 + u) * 32 < la_g) words[q0 + u] = m;
      }
    }
  }
  __syncwarp();

  const bool has = grp < PPW && p0 + grp < B;
  const int p = has ? p0 + grp : p0;
  const int la = min(max(la_arr[p], 0), Wa);
  const int lb = min(max(lb_arr[p], 0), Wt);
  const bool outside = abs(la - lb) > band_k;  // returns max(la, lb): no columns
  const int lb_run = has && !outside ? lb : 0;
  const int32_t* tp = text + p * text_stride;
  const u64* peq = smem + (size_t)(has ? grp : 0) * 6 * nblk;
  // Row la lives in block la_blk at bit la_pos; la = 0 is row 0, above
  // every block.
  const int la_blk = la > 0 ? (la - 1) >> 6 : -1;
  const int la_pos = (la - 1) & 63;
  // A step is COLS text columns of one block; block beta works on columns
  // COLS (s - beta) .. + COLS - 1 at step s.
  const int my_steps =
      lb_run > 0 ? (lb_run + COLS - 1) / COLS + max(0, ((lb_run - 1) >> 6) - SHIFT) + NB - 1 : 0;
  const int nsteps = __reduce_max_sync(FULL, my_steps);
  // The lane that holds the block above mine.
  const int src = has ? lane - l + (l + NB - 1) % NB : lane;
  const unsigned t_last = (unsigned)max(Wt - 1, 0);

  // What a lane keeps about its block beta, set when the block changes:
  // lo..hi the columns it works on and top_from the first column where it
  // is the window's top block (all multiples of 64, or the pair's lb).
  int beta = l, lo, hi, change_at, top_from;
  const u64* pq;
  auto enter = [&]() {
    lo = beta < NB ? 0 : 64 * (beta - SHIFT);  // the first NB blocks start in the window
    const int end_j = 64 * (beta + SHIFT + 1);
    change_at = end_j / COLS + beta;  // the step at which the block has left the window
    hi = max(min(lb_run, end_j), lo);
    top_from = beta == 0 ? INT_MIN : 64 * (beta + SHIFT);
    pq = peq + min(beta, nblk - 1);
  };
  u64 vp = ~0ull, vn = 0ull;
  // D[la][lb] is read down column lb, not along row la: after its last
  // column a block's VP/VN are the vertical deltas of its rows in the
  // column where it left the window (or in column lb), the top of the
  // window gains +1 a column, and a block that never entered is still in
  // its init state, +1 a row. So D[la][lb] = lb + the deltas of every row
  // <= la, each block's taken where it stopped: the same sum that the
  // horizontal deltas of row la add up to in ops/myers.py::myers_plain.
  auto rows_total = [&]() {
    if (lo >= lb_run || beta > la_blk) return 0;  // never worked, or below row la
    const u64 rows = beta < la_blk ? ~0ull : ~0ull >> (63 - la_pos);
    return __popcll(vp & rows) - __popcll(vn & rows);
  };
  // One column through a block: h holds ph_in (bit 0) and mh_in (bit 1);
  // returns ph_out and mh_out the same way.
  auto column = [](u64 eq, int h, u64& pv, u64& mv) {
    const u64 ph_in = (u64)(h & 1), mh_in = (u64)((h >> 1) & 1);
    const u64 xv = eq | mv;
    const u64 eq2 = eq | mh_in;
    const u64 xh = (((eq2 & pv) + pv) ^ pv) | eq2;
    u64 ph = mv | ~(xh | pv);
    u64 mh = pv & xh;
    const int out = (int)(ph >> 63) | ((int)(mh >> 63) << 1);
    ph = (ph << 1) | ph_in;
    mh = (mh << 1) | mh_in;
    pv = mh | ~(xv | ph);
    mv = ph & xv;
    return out;
  };
  enter();
  int carry = 0;    // bits 2u, 2u + 1: ph_out, mh_out of column u of my last step
  int partial = 0;  // the vertical deltas of the blocks I held, rows <= la
  // The text symbols are loaded two steps ahead of their use. A column
  // outside the text reads the text's last code, which no live column uses.
  unsigned c_next[COLS], c_after[COLS];
#pragma unroll
  for (int u = 0; u < COLS; ++u) {
    c_next[u] = Wt > 0 ? __ldg(tp + min((unsigned)(COLS * (0 - beta) + u), t_last)) : 0;
    c_after[u] = Wt > 0 ? __ldg(tp + min((unsigned)(COLS * (1 - beta) + u), t_last)) : 0;
  }
  for (int s = 0; s < nsteps; ++s) {
    if (s == change_at) {  // my block left the window: take the next one
      partial += rows_total();
      beta += NB;
      vp = ~0ull;
      vn = 0ull;
      enter();
    }
    const int j0 = COLS * (s - beta);  // the first text column (0-based) of this step
    const int h = __shfl_sync(FULL, carry, src);
    const int hh = j0 >= top_from ? TOP_CARRY : h;  // the top block's carries are +1
    u64 eq[COLS];
#pragma unroll
    for (int u = 0; u < COLS; ++u) {
      eq[u] = pq[(size_t)min(c_next[u], 5u) * nblk];
      c_next[u] = c_after[u];
      c_after[u] = __ldg(tp + min((unsigned)(j0 + 2 * COLS + u), t_last));
    }
    // No branch on a live step: one that holds no column of mine computes
    // and keeps nothing. lo and the window's end are multiples of COLS, so
    // only the pair's last step can hold fewer than COLS columns.
    const bool any = (unsigned)(j0 - lo) < (unsigned)(hi - lo);
    u64 pv = vp, mv = vn;
    int out = 0;
#pragma unroll
    for (int u = 0; u < COLS; ++u) out |= column(eq[u], hh >> (2 * u), pv, mv) << (2 * u);
    if (any && j0 + COLS > hi) {  // the pair's last columns, fewer than COLS
      pv = vp;
      mv = vn;
      out = 0;
#pragma unroll
      for (int u = 0; u < COLS; ++u)
        if (j0 + u < hi) out |= column(eq[u], hh >> (2 * u), pv, mv) << (2 * u);
    }
    vp = any ? pv : vp;
    vn = any ? mv : vn;
    carry = any ? out : carry;
  }
  partial += rows_total();
  int total = partial;
  for (int t = 1; t < NB; ++t)
    total += __shfl_sync(FULL, partial, min(lane + t, 31));
  if (has && l == 0) {
    // The rows of the blocks the window never reached, +1 each.
    const int reached =
        lb_run > 0 ? 64 * (max(0, ((lb_run - 1) >> 6) - SHIFT) + NB) : 0;
    int score = lb + total + max(0, la - reached);
    if (outside) score = max(la, lb);
    out[p] = score;
  }
}

constexpr int SMEM_LIMIT = 227 * 1024;
// Pairs up to which the group body is taken, by the window's blocks. Timed
// on an H100 at S = 3,000 over 64 to 32,768 pairs (scripts/
// torch_kernel_bodies.py), the group body is the faster one up to these
// counts and the thread body beyond them: with that many pairs one thread
// a pair fills the card, and issues fewer instructions for the same block
// steps than NB lanes with their shuffles and skew. Above 32,768 pairs
// nothing was timed and the thread body stays.
static int64_t group_max_pairs(int NB) {
  return NB <= 5 ? 32768 : NB <= 9 ? 16384 : 8192;
}

static int nb_of(int k) { return 2 * ((k + 63) / 64) + 1; }

// Blocks of Peq words a pair needs in shared memory: those of the pattern,
// and every block the window reaches over Wt columns.
static int group_nblk(int NB, int64_t Wa, int64_t Wt) {
  const int shift = (NB - 1) / 2;
  const int64_t reach = (Wt > 0 ? ((Wt - 1) >> 6) - shift : 0);
  const int64_t win = (reach > 0 ? reach : 0) + NB;
  const int64_t pat = (Wa + 63) / 64;
  return (int)(pat > win ? pat : win);
}

static size_t group_smem(int NB, int64_t Wa, int64_t Wt) {
  return (size_t)(32 / NB) * 6 * group_nblk(NB, Wa, Wt) * sizeof(u64);
}

// The rule that chooses the body, from the shapes alone.
static bool group_body_fits(int64_t B, int64_t Wa, int64_t Wt, int k) {
  const int NB = nb_of(k);
  return B <= group_max_pairs(NB) && group_smem(NB, Wa, Wt) <= (size_t)SMEM_LIMIT;
}

template <int NB>
static int launch_myers(bool group, const void* a, int64_t a_stride, int64_t Wa,
                        const void* text, int64_t text_stride, int64_t Wt,
                        const void* la, const void* lb, void* out, int64_t B,
                        int band_k, cudaStream_t stream) {
  if (group) {
    const size_t smem = group_smem(NB, Wa, Wt);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          myers_group_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    constexpr int PPW = 32 / NB;
    myers_group_kernel<NB><<<(unsigned)((B + PPW - 1) / PPW), 32, smem, stream>>>(
        (const int32_t*)a, a_stride, (int)Wa, (const int32_t*)text, text_stride,
        (int)Wt, (const int32_t*)la, (const int32_t*)lb, (int32_t*)out, (int)B,
        band_k, group_nblk(NB, Wa, Wt));
    return kgt_launch_status();
  }
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  myers_kernel<NB><<<blocks, threads, 0, stream>>>(
      (const int32_t*)a, a_stride, (int)Wa, (const int32_t*)text, text_stride,
      (int)Wt, (const int32_t*)la, (const int32_t*)lb, (int32_t*)out, (int)B,
      band_k);
  return kgt_launch_status();
}

// 1 when a launch of these shapes takes the group body, 0 for the thread
// body; launches nothing.
KGT_API int kgt_myers_body(int64_t B, int64_t Wa, int64_t Wt, int64_t band_k) {
  return group_body_fits(B, Wa, Wt, (int)band_k) ? 1 : 0;
}

// As kgt_myers with the body named: 1 group, 0 thread, -1 by the rule. For
// measurements and checks that hold one body beside the other.
KGT_API int kgt_myers_with_body(const void* a, int64_t a_stride, int64_t Wa,
                                const void* text, int64_t text_stride,
                                int64_t Wt, const void* la, const void* lb,
                                void* out, int64_t B, int64_t band_k,
                                int64_t body, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int k = (int)band_k;
  if (k < 1 || k > 512) return (int)cudaErrorInvalidValue;
  if (body == 1 && group_smem(nb_of(k), Wa, Wt) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const bool g = body < 0 ? group_body_fits(B, Wa, Wt, k) : body == 1;
  switch ((k + 63) / 64) {
    case 1: return launch_myers<3>(g, a, a_stride, Wa, text, text_stride, Wt, la, lb, out, B, k, s);
    case 2: return launch_myers<5>(g, a, a_stride, Wa, text, text_stride, Wt, la, lb, out, B, k, s);
    case 4: return launch_myers<9>(g, a, a_stride, Wa, text, text_stride, Wt, la, lb, out, B, k, s);
    case 8: return launch_myers<17>(g, a, a_stride, Wa, text, text_stride, Wt, la, lb, out, B, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// a: (B, Wa) int32 pattern rows a_stride apart; text: (B or 1, Wt) int32
// rows text_stride apart (0 = one text shared by every pair); la, lb,
// out: (B,) int32. band_k is one of 31, 63, 127, 255, 511.
KGT_API int kgt_myers(const void* a, int64_t a_stride, int64_t Wa,
                      const void* text, int64_t text_stride, int64_t Wt,
                      const void* la, const void* lb, void* out, int64_t B,
                      int64_t band_k, void* stream) {
  return kgt_myers_with_body(a, a_stride, Wa, text, text_stride, Wt, la, lb,
                             out, B, band_k, -1, stream);
}
