"""Helpers of the port: the flax <-> torch weight bridge."""
