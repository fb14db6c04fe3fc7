"""Query engine: condition vocabulary, compiler, DSL, serialization,
parameterized queries."""

from hypergraphdb_tpu_torch.query import conditions, dsl
from hypergraphdb_tpu_torch.query.compiler import CompiledQuery, compile_query
from hypergraphdb_tpu_torch.query.variables import PreparedQuery, Var, prepare, var

__all__ = [
    "CompiledQuery",
    "PreparedQuery",
    "Var",
    "compile_query",
    "conditions",
    "dsl",
    "prepare",
    "var",
]
