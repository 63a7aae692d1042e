"""Recommendation models: Wide&Deep (``wide_deep``)."""
