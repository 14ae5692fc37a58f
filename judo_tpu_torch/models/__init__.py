"""Committed model snapshots (mujoco-free planning models)."""
