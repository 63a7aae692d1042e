"""The compatibility join kernel: plain version (``ref``), CUDA kernel
(``kernel``, ``csrc/compat_join.cu``) and the dispatching wrapper
(``ops``)."""
