"""Spot with its locomotion policy in the loop (spot_navigate so far)."""
