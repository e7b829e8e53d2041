"""Fault-tolerant training driver."""
