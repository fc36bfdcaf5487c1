"""Fault injection (failpoints) and per-request deadline budgets."""
