"""Embedded filer store backends (reference: weed/filer/{leveldb,
abstract_sql,...}): memory, sqlite (``abstract_sql`` also carries the
mysql and postgres flavours) and weedkv (``kv_store``)."""
