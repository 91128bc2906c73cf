"""Checkpoint I/O of the port (so far: ``storage.write_bytes`` and
``read_bytes``, the serving journal's storage seam)."""
