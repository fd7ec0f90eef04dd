"""Host-side cores that the port keeps its own copies of. Counterpart of
``ray_tpu._private``; so far the prefix/KV-cache decision core
(``kv_cache``)."""
