"""Distributed serving primitives: deterministic fault injection for the
serving tick loop."""
