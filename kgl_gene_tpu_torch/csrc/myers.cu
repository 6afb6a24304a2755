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
// same layout and agrees with this kernel bit for bit everywhere.
//
// Bound on the card: operations. Each (pair, column, block) costs about
// 17 64-bit word operations; the bytes are the pattern and one shared text.
// Design: one thread per pair, as edlib runs one pair per core. The window
// is a loop inside the thread held in registers (VP, VN and five Peq words
// per block); it replaces the TPU's sequential grid axis, which carried the
// window in VMEM scratch from one grid step to the next. Each thread builds
// the Peq words of a block from its own pattern row when the block enters
// the window (rows >= la match nothing), walks only its own lb columns,
// and reads the shared text through the read-only cache, where every
// thread of a warp hits the same address. Codes are DNA5 (0..4); any other
// code matches nothing. Lengths are clamped to the array widths.
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

template <int NB>
static int launch_myers(const void* a, int64_t a_stride, int64_t Wa,
                        const void* text, int64_t text_stride, int64_t Wt,
                        const void* la, const void* lb, void* out, int64_t B,
                        int band_k, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  myers_kernel<NB><<<blocks, threads, 0, stream>>>(
      (const int32_t*)a, a_stride, (int)Wa, (const int32_t*)text, text_stride,
      (int)Wt, (const int32_t*)la, (const int32_t*)lb, (int32_t*)out, (int)B,
      band_k);
  return kgt_launch_status();
}

// a: (B, Wa) int32 pattern rows a_stride apart; text: (B or 1, Wt) int32
// rows text_stride apart (0 = one text shared by every pair); la, lb,
// out: (B,) int32. band_k is one of 31, 63, 127, 255, 511.
KGT_API int kgt_myers(const void* a, int64_t a_stride, int64_t Wa,
                      const void* text, int64_t text_stride, int64_t Wt,
                      const void* la, const void* lb, void* out, int64_t B,
                      int64_t band_k, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int k = (int)band_k;
  switch ((k + 63) / 64) {
    case 1: return launch_myers<3>(a, a_stride, Wa, text, text_stride, Wt, la, lb, out, B, k, s);
    case 2: return launch_myers<5>(a, a_stride, Wa, text, text_stride, Wt, la, lb, out, B, k, s);
    case 4: return launch_myers<9>(a, a_stride, Wa, text, text_stride, Wt, la, lb, out, B, k, s);
    case 8: return launch_myers<17>(a, a_stride, Wa, text, text_stride, Wt, la, lb, out, B, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
