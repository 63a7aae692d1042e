"""Synthetic data of the substrate, ported from ``repro.data``: CTR
batches (``recsys``) and graphs (``graphs``).  The generators are numpy
and give the reference's arrays bit for bit; the ``*_to_device``
helpers put them on the card unless the caller asks for the CPU."""
