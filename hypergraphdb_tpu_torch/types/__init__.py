"""The type system: the top and null types and the eight predefined
primitive types."""
