"""Observability: span tracer and Prometheus-style metric families."""
