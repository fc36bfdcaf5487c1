"""Filer store backends (reference: weed/filer/{leveldb, abstract_sql,
redis, etcd, mongodb, elastic, cassandra, hbase}): memory, sqlite
(``abstract_sql`` also carries the mysql and postgres flavours), weedkv
(``kv_store``) and the networked stores, which speak their servers'
wire protocols themselves (``redis_store``, ``etcd_store``,
``mongodb_store``, ``elastic_store``, ``cassandra_store``,
``hbase_store``)."""
