"""Exception hierarchy of the graph layer (the reference's ``HGException``
family)."""


class HGException(Exception):
    """Base class of every error the graph layer raises."""


class NotFoundError(HGException, KeyError):
    """No atom, link or datum for the given handle."""


class TransactionConflict(HGException):
    """Commit-time validation failed; the transaction should be retried."""


class TransactionAborted(HGException):
    """The transaction was aborted, or ended out of order."""


class StorageError(HGException):
    """Low-level storage failure."""


class TypeError_(HGException):
    """Type-system violation (a value no type takes, an unknown type)."""


class QueryError(HGException):
    """Malformed or uncompilable query condition."""
