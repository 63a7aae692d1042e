"""Published configurations of the ported models (``wide_deep``,
``gin_tu``) and the shape sets they are served at (``registry``)."""
