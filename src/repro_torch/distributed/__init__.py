"""Distributed primitives: deterministic fault injection for the serving
tick loop, the train driver's retry supervisor and control-plane logic,
and placement on a data-parallel mesh."""
