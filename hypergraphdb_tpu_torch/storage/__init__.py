"""Storage-side structures of the port: the value index's device columns."""
