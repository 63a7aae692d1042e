"""Hand-written Hopper kernels of the port.

compat_join     The paper's inner loop: compatibility join between a
                partial-match table and a candidate table, with the
                matching pairs compacted on the card (CUDA C++, sm_90a).

The reference's other Pallas kernels (the compat mask kernels,
segment_sum, embedding_bag) are still to be ported (ROADMAP.md,
Queue B).
"""
