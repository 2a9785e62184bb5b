"""Distributed serving primitives: deterministic fault injection for the
serving tick loop, and placement on a data-parallel mesh."""
