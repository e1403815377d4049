"""Topology-aware scheduling (TAS) domain tree of the port."""
