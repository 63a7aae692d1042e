"""Published configurations of the ported models (``wide_deep``,
``gin_tu``, ``gat_cora``, ``pna``, ``nequip``) and the shape sets they
are served at (``registry``)."""
