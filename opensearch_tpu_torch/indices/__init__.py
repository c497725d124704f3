"""The node's index registry: ``IndicesService`` and ``IndexService``
(``indices/service.py``), and the shard request cache
(``indices/request_cache.py``)."""
