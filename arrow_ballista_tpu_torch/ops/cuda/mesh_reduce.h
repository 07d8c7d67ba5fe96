// Launch interface of mesh_reduce.cu, shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_agg.h"

constexpr int kMeshMaxShards = 64;

struct MeshReduceParams {
  // each [n_fields, capacity]: int64 words, or int32 words in x32
  const void* states[kMeshMaxShards];
  int n_shards;
  int n_fields;
  long long capacity;
  int8_t ops[kSegAggMaxFields];  // per field: SegAggOp, or X32Op in x32
  int x32;
  void* out;                     // [n_fields, capacity]
};

extern "C" cudaError_t mesh_reduce_launch(const MeshReduceParams* params,
                                          cudaStream_t stream);
