// Launch interface of segment_agg_entries.cu, shared with its PyTorch
// binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_agg.h"

// Rows [r0, r1) of one entry: one chunk of pass 1.  An entry is cut into
// chunks by the one-batch kernel's run rule for its row count, and no
// chunk straddles two entries.
struct SegAggChunk {
  long long r0;
  long long r1;
  int entry;
  int pad_;
};

// Folds chunks [first, first + p->n_chunks) of the table into p->state:
// pass 1 writes each chunk's partial into p->partial ([n_chunks, n_folds,
// capacity]), pass 2 folds the state and then the partials in table order.
// ``entries`` (device) holds one SegAggParams per entry, whose per-row
// pointers and plan are that entry's; ``chunks`` (device) is in (entry,
// chunk) order.  ``p`` carries the fields common to every entry (ops, the
// fold map, n_fields, n_folds, tile, smem, capacity) and the scratch and
// state pointers.
extern "C" cudaError_t segment_agg_entries_launch(const SegAggParams* p,
                                                  const SegAggParams* entries,
                                                  const SegAggChunk* chunks,
                                                  long long first,
                                                  cudaStream_t stream);
