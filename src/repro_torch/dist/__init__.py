"""Sharding of the port's models over a DeviceMesh (``sharding``)."""
