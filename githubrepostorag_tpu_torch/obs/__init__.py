"""Observability: the trace context the retrieval path stamps spans with."""
