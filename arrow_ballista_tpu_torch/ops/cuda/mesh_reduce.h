// Launch interface of mesh_reduce.cu, shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_agg.h"

constexpr int kMeshMaxShards = 64;

struct MeshReduceParams {
  const long long* states[kMeshMaxShards];  // each [n_fields, capacity]
  int n_shards;
  int n_fields;
  long long capacity;
  int8_t ops[kSegAggMaxFields];  // per field: SegAggOp merge code
  long long* out;                // [n_fields, capacity]
};

extern "C" cudaError_t mesh_reduce_launch(const MeshReduceParams* params,
                                          cudaStream_t stream);
