"""Hot-object serving tier (two-level decoded-object cache with
single-flight fill; see hotcache.py). The former ``CacheObjectLayer``
env-configured gateway wrapper was replaced by this tier in the
erasure data plane — configure it via config-KV (``cache`` subsystem),
not ``MINIO_CACHE_DRIVES``.

The port's own copy of ``minio_tpu/cache/__init__.py``, with no change in
behaviour.
"""

from .hotcache import HOTCACHE, HotObjectCache  # noqa: F401
