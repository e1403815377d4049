"""Solver drain of the port: export, lean drain, TAS device placer."""
