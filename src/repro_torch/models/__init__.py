"""Models of the substrate, ported from ``repro.models``: Wide&Deep
(``recsys``) and GIN (``gnn``)."""
