// Launch interface of mesh_route.cu, shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMeshRouteMaxCols = 32;   // columns one scatter launch copies
constexpr int kMeshRouteMaxDevs = 256;  // destinations (shared-memory counters)

struct MeshRouteParams {
  const int32_t* dest;  // [n] destination of each row
  const bool* valid;    // [n] rows that route at all
  long long n;          // rows
  int n_dev;            // destinations 0 .. n_dev-1
  long long capacity;   // slots per destination
  long long tile;       // rows per block
  int n_blocks;         // ceil(n / tile)
  int n_cols;           // columns of this scatter launch
  const void* cols[kMeshRouteMaxCols];  // [n] each
  void* staged[kMeshRouteMaxCols];      // [n_dev, capacity] each, zeroed
  int8_t esize[kMeshRouteMaxCols];      // element bytes: 1, 2, 4 or 8
  bool* staged_valid;   // [n_dev, capacity], zeroed; null: not written
  long long* counts;    // [n_dev, n_blocks] scratch: counts, then offsets
  unsigned long long* dropped;  // [1] rows not delivered, added to
};

// Counts and offsets (once per routing), then the scatter of the columns.
extern "C" cudaError_t mesh_route_plan(const MeshRouteParams* params,
                                       cudaStream_t stream);
extern "C" cudaError_t mesh_route_scatter(const MeshRouteParams* params,
                                          cudaStream_t stream);
