"""Spline, quaternion and cost operators."""
