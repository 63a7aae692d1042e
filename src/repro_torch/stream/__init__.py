"""Stream substrate: the synthetic stream generators."""
