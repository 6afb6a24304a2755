// A pointer chase: the card's dependent-load latency.
//
// One thread follows next[] for `hops` hops, each load's address the value
// the previous load returned, and writes where it ended (so the loop
// stays). Over a cycle of cache lines that fits the L1 and with loads that
// cache there, a hop reads the L1 hit latency; over a cycle of several MB
// with loads that skip the L1 (ld.global.cg), the L2 hit latency. A hop
// also carries its address arithmetic, as any dependent step must.
// chip_smoke.py times two hop counts and takes the difference, and prices
// the walk's live steps (csrc/walk.cu) with these latencies in its latency
// bound. Not on any path of the package.
#include "common.cuh"

namespace {

template <bool L2_ONLY>
__global__ void __launch_bounds__(1)
chase_kernel(const uint32_t* __restrict__ next, int64_t hops, uint32_t* __restrict__ out) {
  uint32_t at = 0;
  for (int64_t h = 0; h < hops; ++h) at = L2_ONLY ? __ldcg(next + at) : __ldca(next + at);
  *out = at;
}

}  // namespace

// next: uint32 word indices forming one cycle through word 0; out: one
// uint32. l2_only != 0: the loads skip the L1.
KGT_API int kgt_chase(const void* next, int64_t hops, int64_t l2_only, void* out,
                      void* stream) {
  if (hops < 0) return (int)cudaErrorInvalidValue;
  if (l2_only)
    chase_kernel<true><<<1, 1, 0, (cudaStream_t)stream>>>((const uint32_t*)next, hops,
                                                          (uint32_t*)out);
  else
    chase_kernel<false><<<1, 1, 0, (cudaStream_t)stream>>>((const uint32_t*)next, hops,
                                                           (uint32_t*)out);
  return kgt_launch_status();
}
