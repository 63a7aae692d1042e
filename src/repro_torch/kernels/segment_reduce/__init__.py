"""The segment-sum kernel: plain version (``ref``), CUDA kernel
(``kernel``, ``csrc/segment_reduce.cu``) and the dispatching wrappers
(``ops``)."""
