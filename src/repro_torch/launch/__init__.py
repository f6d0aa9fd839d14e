"""Mesh construction for launches (``launch.mesh``)."""
