"""MVCC transactions over a storage backend."""
