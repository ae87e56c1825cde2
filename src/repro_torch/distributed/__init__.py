"""Checkpoint/restore of the serving controller's state."""
