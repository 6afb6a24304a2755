// Kernel B3: exact Levenshtein distance by an anti-diagonal wavefront.
//
// Replaces the TPU kernel _levenshtein_kernel (kgl_gene_tpu/ops/
// pallas_edit_distance.py:36, launched by _pallas_call). Per pair it
// computes D[la][lb] of the textbook DP over a[0:la] and b[0:lb]; every
// cell of one anti-diagonal d = i + j depends only on the two diagonals
// before it, so the cells of a diagonal update together.
//
// Bound on the card: operations. Each cell costs a few integer operations
// and the inputs are read from cache, so the least time is the pair's
// (la+1)(lb+1) cells times those operations over the card's integer
// rate; the bytes (the two sequences) are small beside that.
//
// Design: one thread block per pair, its threads across the cells of a
// diagonal. The TPU kernel batched pairs across sublanes and carried three
// full-width diagonals in VMEM; here the three diagonal buffers live in
// the block's shared memory (12 * (M + 1) bytes, 36 KB at M = 3000;
// dynamic shared memory above 48 KB) and rotate by pointer. A block walks
// only the cells of its own pair that lie inside [0, la] x [0, lb] and
// stops at its own d = la + lb, so ragged pairs cost what they need; the
// TPU's lane-reversed b, 128-lane padding and batch quantum are gone.
// Lengths are clamped to the array widths; la + lb < 2 returns la + lb.
#include "common.cuh"

__global__ void wavefront_kernel(const int32_t* __restrict__ a,
                                 int64_t a_stride, int Wa,
                                 const int32_t* __restrict__ b,
                                 int64_t b_stride, int Wb,
                                 const int32_t* __restrict__ la_arr,
                                 const int32_t* __restrict__ lb_arr,
                                 int32_t* __restrict__ out, int width) {
  extern __shared__ int32_t smem[];
  const int p = blockIdx.x;
  const int la = min(max(la_arr[p], 0), Wa);
  const int lb = min(max(lb_arr[p], 0), Wb);
  const int n = la + lb;
  if (n < 2) {
    if (threadIdx.x == 0) out[p] = n;
    return;
  }
  const int32_t* ap = a + p * a_stride;
  const int32_t* bp = b + p * b_stride;
  int32_t* pp = smem;              // diagonal d - 2
  int32_t* pv = smem + width;      // diagonal d - 1
  int32_t* cur = smem + 2 * width; // diagonal d
  if (threadIdx.x == 0) {
    pp[0] = 0;  // D[0][0]
    pv[0] = 1;  // D[0][1]
    pv[1] = 1;  // D[1][0]
  }
  __syncthreads();
  for (int d = 2; d <= n; ++d) {
    const int lo = max(0, d - lb);
    const int hi = min(la, d);
    for (int i = lo + threadIdx.x; i <= hi; i += blockDim.x) {
      const int j = d - i;
      int v;
      if (i == 0) {
        v = j;
      } else if (j == 0) {
        v = i;
      } else {
        const int cost = __ldg(ap + i - 1) != __ldg(bp + j - 1);
        v = min(min(pv[i - 1], pv[i]) + 1, pp[i - 1] + cost);
      }
      cur[i] = v;
    }
    __syncthreads();
    int32_t* t = pp;
    pp = pv;
    pv = cur;
    cur = t;
  }
  if (threadIdx.x == 0) out[p] = pv[la];
}

// a: (B, Wa) int32 rows a_stride apart; b: (B or 1, Wb) int32 rows
// b_stride apart (0 = one b shared by every pair); la, lb, out: (B,) int32.
KGT_API int kgt_wavefront(const void* a, int64_t a_stride, int64_t Wa,
                          const void* b, int64_t b_stride, int64_t Wb,
                          const void* la, const void* lb, void* out,
                          int64_t B, void* stream) {
  if (B == 0) return 0;
  const int width = (int)(Wa > 1 ? Wa + 1 : 2);
  const size_t smem = 3 * (size_t)width * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((width + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  wavefront_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_stride, (int)Wa, (const int32_t*)b, b_stride,
      (int)Wb, (const int32_t*)la, (const int32_t*)lb, (int32_t*)out, width);
  return kgt_launch_status();
}
