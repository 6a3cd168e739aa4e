"""Atomic, self-verifying checkpoints in the reference's format
(``checkpoint.store``)."""
