"""Runtime layer: the multi-tenant service and straggler mitigation."""
