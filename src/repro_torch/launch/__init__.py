"""Launch entry points of the port: ``stream_serve.StreamServer``, the
one-tenant wrapper over the service."""
