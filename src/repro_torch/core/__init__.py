"""Robust aggregation, attacks, worker momentum and the flat arena."""
