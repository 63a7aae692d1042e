"""Shared helpers of the port's differential tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU and the port runs with ``device="cpu"``.
"""

import numpy as np
import torch

# the port's tests run beside the JAX suite under xdist: keep torch small
torch.set_num_threads(2)

from repro_torch.core.query import QueryGraph as TQuery  # noqa: E402


def leaves(tree) -> list:
    """Leaves of a (JAX or port) state/result tree, in field order, as
    numpy arrays."""
    if isinstance(tree, tuple):
        out = []
        for v in tree:
            out += leaves(v)
        return out
    if torch.is_tensor(tree):
        return [tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


def assert_same_tree(ref_tree, port_tree, where=""):
    """Every leaf bit-identical: same shape, same values (bools as bools,
    integers compared as int64)."""
    a, b = leaves(ref_tree), leaves(port_tree)
    assert len(a) == len(b), f"{where}: {len(a)} leaves vs {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape, f"{where} leaf {i}: {x.shape} vs {y.shape}"
        assert (x.dtype == np.bool_) == (y.dtype == np.bool_), \
            f"{where} leaf {i}: dtype {x.dtype} vs {y.dtype}"
        assert np.array_equal(x.astype(np.int64), y.astype(np.int64)), \
            f"{where} leaf {i} differs"


def port_query(q) -> TQuery:
    """The port's QueryGraph for a reference QueryGraph."""
    return TQuery.from_spec(q.to_spec())


def port_edges(stream):
    """The port's DataEdge list for a reference DataEdge list."""
    from repro_torch.core.oracle import DataEdge
    return [DataEdge(e.src, e.dst, e.ts, e.src_label, e.dst_label,
                     e.edge_label) for e in stream]
