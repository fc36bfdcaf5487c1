"""Filer store engines (``kv_store.LogKV``)."""
