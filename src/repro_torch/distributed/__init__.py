"""Logical-axis sharding rules, resolved onto torch DeviceMeshes."""
