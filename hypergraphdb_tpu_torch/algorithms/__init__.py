"""Host graph algorithms: the traversals."""
