"""Neighbour structures, packs and the kernels of the slice."""
