"""Helpers shared by the controller."""
