// Launch interface of partition_id.cu, shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct PartitionIdParams {
  long long n;            // rows
  int n_cols;             // key columns
  const long long* bits;  // [n_cols][n] each key's raw 64-bit pattern
  const uint8_t* nulls;   // [n_cols][n] 1 where the key is null
  unsigned int n_out;     // output partitions, 1 .. 2^16
  int32_t* out;           // [n] partition id of each row
};

extern "C" cudaError_t partition_id_launch(const PartitionIdParams* params,
                                           cudaStream_t stream);
