"""Call sizes at which the segmented scan's tile rule is checked, shared by
the CPU test of the rule (``test_torch_scan_plan.py``) and the card test
that holds the C plan to its mirror (``test_torch_cuda_kernels.py``): the
main path's small calls, the small-call rule's edges (two tiles an SM at
each R) and every power of two to 2^26, each -1, +0, +1."""

SIZES = sorted({1, 2, 255, 256, 257, 8191, 8192, 32768, 33151, 67584, 67585, 135168,
                270336, 540672, 540673, 1 << 20, (1 << 20) + 3, 1 << 23, 1 << 26}
               | {(1 << k) + d for k in range(1, 27) for d in (-1, 0, 1)})
