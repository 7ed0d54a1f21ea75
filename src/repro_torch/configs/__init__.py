"""Architecture configs of the port (plain data; see :mod:`.base`)."""
