"""Architecture configs of the port (see ``registry``)."""
