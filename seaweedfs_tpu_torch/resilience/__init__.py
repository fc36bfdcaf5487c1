"""Fault injection (failpoints), per-request deadline budgets and hedged
reads (``hedge.Hedger``)."""
