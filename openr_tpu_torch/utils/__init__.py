"""Helpers of the port: synthetic topologies."""
