"""User indexers kept on every mutation."""
