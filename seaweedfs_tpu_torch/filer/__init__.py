"""The filer's storage engines. Only ``stores.kv_store.LogKV`` is ported
so far: the kv needle map (``storage/needle_map.KvNeedleMap``) runs on it.
The filer itself is not part of the port yet."""
