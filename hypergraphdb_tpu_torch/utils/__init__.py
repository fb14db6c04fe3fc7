"""Host utilities: order-preserving key encodings, a sorted-container
shim, a bounded LRU cache and a msgpack subset."""
