"""Configurations the port runs: the paper's PULSE workloads."""
