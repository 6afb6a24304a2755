// Shared definitions for the kernels of kgl_gene_tpu_torch.
//
// Every C entry point launches on the stream it is handed, allocates
// nothing, and returns the cudaError_t of the launch (0 on success); the
// Python wrapper raises on any other value.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define KGT_API extern "C" __attribute__((visibility("default")))

static inline int kgt_launch_status() { return (int)cudaGetLastError(); }
