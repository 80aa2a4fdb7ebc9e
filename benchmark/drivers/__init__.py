"""Drivers: one module a kind of traffic, each with a `Session`."""
