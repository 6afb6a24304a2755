// Error text for the codes the kernels' entry points return.
#include "common.cuh"

KGT_API const char* kgt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
