"""Parallel layer of the port: sharding rules on a DeviceMesh, and the
flags that switch its optimisations."""
