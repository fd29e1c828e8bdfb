"""Distributed pieces ported so far: gradient compression."""
