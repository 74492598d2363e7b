"""Decision layer of the port: LSDB state and the route computation."""
