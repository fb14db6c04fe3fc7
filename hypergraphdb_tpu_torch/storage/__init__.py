"""Storage of the port: the storage contract, the in-memory backend and
the value index's device columns."""
