"""Serving runtime of the port: page allocator and continuous-batching engine."""
