"""repro_torch: the PyTorch/CUDA port of ``repro``.

Time Constrained Continuous Subgraph Search over Streaming Graphs (Li,
Zou, Özsu, Zhao, PVLDB 2018) on PyTorch, with the hot join as a CUDA
kernel written by hand for Hopper.  The layout mirrors ``repro``:

api        the public surface: ``StreamSession``, the Pattern DSL, typed
           Event/Match records.
core       query compilation (query, decompose, plan, canon, registry),
           device state, the join, the tick body, slot groups, the
           shared-prefix forest.
kernels    the hand-written CUDA kernels (compat_join, embedding_bag,
           segment_reduce).
runtime    the multi-tenant ``ContinuousSearchService`` and the tick
           coalescer.
checkpoint atomic npz + JSON manifest checkpoints, the async writer.
obs        metrics registry, span tracer, Prometheus text.
launch     ``StreamServer``, the one-tenant wrapper.
stream     the synthetic stream generators.
analysis   the plan invariant verifier.

Entry points run on the card (``device=None`` means CUDA) unless the
caller passes ``device="cpu"``; nothing falls back to the CPU by itself.
This package imports torch and numpy, never JAX and never ``repro``.
"""

__version__ = "0.1.0"
