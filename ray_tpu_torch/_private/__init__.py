"""Host-side cores that the port keeps its own copies of. Counterpart of
``ray_tpu._private``: the in-process runtime the core API and Serve stand
on (``worker``, ``local_backend``, the memory store, scheduling state,
config, ids, metrics, the critical-path recorder) and the prefix/KV-cache
decision core (``kv_cache``)."""
