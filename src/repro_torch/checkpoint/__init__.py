"""Checkpoints: async, atomic, in the reference's files on disk."""
