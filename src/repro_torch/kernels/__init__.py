"""Hand-written Hopper kernels of the port (CUDA C++, sm_90a), each with
its plain torch version (``ref``) and a dispatching wrapper (``ops``):

compat_join     The paper's inner loop: compatibility join between a
                partial-match table and a candidate table, with the
                matching pairs compacted on the card; and the join
                predicate as a dense mask.
embedding_bag   Sum-mode EmbeddingBag (the Wide&Deep wide side).
segment_reduce  Segment sum of edge messages into node rows (GIN's
                message passing).

``_build`` compiles each ``csrc/*.cu`` with nvcc at first use.  Every
Pallas kernel of the reference has its port here (ROADMAP.md, Queue B).
"""
