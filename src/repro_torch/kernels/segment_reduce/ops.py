"""Public wrappers of the segment_sum kernel.

``segment_sum`` and ``segment_mean`` are the ports of
``repro.kernels.segment_reduce.ops``.  On CUDA tensors ``segment_sum``
launches the hand-written kernel (``kernel.segment_sum_cuda``, source
``csrc/segment_reduce.cu``) or raises; on CPU tensors it runs the plain
version (``ref``), because the tensors lie on the CPU.  No ``try`` falls
back from one to the other.

``segment_sum.launches`` counts kernel launches (``segment_mean`` makes
two); ``chip_smoke.py`` zeroes and reads it around the GIN path.
"""

from __future__ import annotations

from repro_torch.core.join import JoinBackend, resolve_backend
from repro_torch.kernels.segment_reduce import kernel as K
from repro_torch.kernels.segment_reduce import ref as R


def segment_sum(dst, msg, n_nodes: int, backend: str | None = None):
    """``out[n] = sum of msg[e] over dst[e] == n`` -> [n_nodes, D] in
    msg's dtype, accumulated in float32; dst < 0 or >= n_nodes dropped.
    ``backend`` None is the device default (the kernel on the card, the
    plain version on the CPU); "ref" is the plain version anywhere;
    "cuda" with CPU tensors raises."""
    backend = resolve_backend(backend, msg.device)
    if backend == JoinBackend.REF:
        return R.segment_sum(dst, msg, n_nodes)
    out = K.segment_sum_cuda(dst.int(), msg, int(n_nodes))
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def segment_mean(dst, msg, n_nodes: int, backend: str | None = None,
                 eps: float = 1e-9):
    s = segment_sum(dst, msg, n_nodes, backend)
    cnt = segment_sum(dst, msg.new_ones((msg.shape[0], 1)), n_nodes, backend)
    return s / cnt.clamp(min=eps)
