"""The EmbeddingBag kernel: plain version (``ref``), CUDA kernel
(``kernel``, ``csrc/embedding_bag.cu``) and the dispatching wrapper
(``ops``)."""
