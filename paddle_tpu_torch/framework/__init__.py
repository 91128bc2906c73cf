"""Framework pieces of the port: the runtime flag registry (``flags``)."""
