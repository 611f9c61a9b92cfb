"""Drivers: one module a kind of traffic, named by the traffic file."""
