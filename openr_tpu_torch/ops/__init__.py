"""Device compute of the port: the split SPF solve, its epilogue and
the hand-written relax kernel."""
